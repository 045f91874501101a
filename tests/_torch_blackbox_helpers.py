"""Shared set-up of the port's black-box parity tests
(tests/test_torch_{square,query_attacks,robust_eval,query_curves}.py).

Both packages attack resnet_tiny with the same float64 weights and float64
logits (the uncast closures of ``_torch_port_helpers``), four 32x32 images
from a numpy seed.  The JAX package draws inside its scans from a key chain;
the functions here replay that chain outside the scan (``jax.random.split``
as the attack does it) and hand the draws to the port through its draw
functions, so both sides walk the same path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_port_helpers import flax_resnet, port_resnet, uncast_fns
from image_recognition_adversarial_example_attack_tpu.attacks import square as jax_square

TOL = 1e-9
F64 = jnp.float64


def make_setup(seed: int = 5, n: int = 4, image_seed: int = 31):
    """(jax logits fn, port logits fn, x [n,32,32,3] float64, y pseudo-labels)."""
    with jax.enable_x64():
        module, variables = flax_resnet("resnet_tiny", np.float64, num_classes=10, seed=seed)
        model = port_resnet("resnet_tiny", variables, np.float64, num_classes=10)
        fns = uncast_fns(module, variables, model)
        x = np.random.RandomState(image_seed).uniform(0.1, 0.9, size=(n, 32, 32, 3))
        y = np.asarray(jax.jit(fns["jax"][0])(jnp.asarray(x))).argmax(-1)
    return fns["jax"][0], fns["port"][0], x, y


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def run_jax(fn, *args):
    """``fn`` jitted under x64 on numpy args; numpy results (tuples kept)."""
    with jax.enable_x64():
        out = jax.jit(fn)(*[jnp.asarray(a) for a in args])
        return jax.tree_util.tree_map(np.asarray, out)


def feed(seq):
    """A draw function that ignores its arguments and returns ``seq``'s
    items in turn."""
    it = iter(seq)
    return lambda *a, **k: next(it)


def constant(value):
    return lambda *a, **k: value


# ---------------------------------------------------------------------------
# the key chains of the JAX attacks
# ---------------------------------------------------------------------------

def square_draws(key, steps: int, shape, p_init: float = 0.1):
    """square_attack's draws: (stripes, r0 [steps,B], c0, signs [steps,B,C])."""
    b, h, w, c = shape
    sides = jax_square.square_schedule(steps, h, w, p_init)
    with jax.enable_x64():
        key, k0 = jax.random.split(key)
        stripes = jax.random.rademacher(k0, (b, 1, w, c), F64)
        r0, c0, signs = [], [], []
        for side in sides:
            key, kr, kc, ks = jax.random.split(key, 4)
            r0.append(jax.random.randint(kr, (b, 1, 1, 1), 0, h - int(side) + 1).reshape(b))
            c0.append(jax.random.randint(kc, (b, 1, 1, 1), 0, w - int(side) + 1).reshape(b))
            signs.append(jax.random.rademacher(ks, (b, 1, 1, c), F64).reshape(b, c))
        return (t(stripes), t(np.stack(r0)).long(), t(np.stack(c0)).long(),
                t(np.stack(signs)))


def square_l2_draws(key, steps: int, shape, p_init: float = 0.1):
    """square_l2_attack's draws: (sign0, r1, c1, r2, c2 [steps,B], signs)."""
    b, h, w, c = shape
    s0 = max(2, h // 5)
    grid = (max(1, h // s0), max(1, w // s0))
    sides = np.maximum(jax_square.square_schedule(steps, h, w, p_init), 2)
    with jax.enable_x64():
        key, k0 = jax.random.split(key)
        sign0 = jax.random.rademacher(k0, (b, *grid, c), F64)
        corners = [[], [], [], []]
        signs = []
        for side in sides:
            key, kr1, kc1, kr2, kc2, ks = jax.random.split(key, 6)
            hi, wi = h - int(side) + 1, w - int(side) + 1
            for lst, k, top in zip(corners, (kr1, kc1, kr2, kc2), (hi, wi, hi, wi)):
                lst.append(jax.random.randint(k, (b, 1, 1, 1), 0, top).reshape(b))
            signs.append(jax.random.rademacher(ks, (b, 1, 1, c), F64).reshape(b, c))
        return (t(sign0), *(t(np.stack(v)).long() for v in corners), t(np.stack(signs)))


def simba_draws(key, steps: int, b: int, fh: int, fw: int, c: int):
    """simba_attack's (u, v, channel), each int64 [steps, B]."""
    out = [[], [], []]
    with jax.enable_x64():
        for kk in jax.random.split(key, steps):
            ku, kv, kc = jax.random.split(kk, 3)
            for lst, k, top in zip(out, (ku, kv, kc), (fh, fw, c)):
                lst.append(np.asarray(jax.random.randint(k, (b,), 0, top)))
    return tuple(t(np.stack(v)).long() for v in out)


def probe_draws(key, steps: int, n: int, shape, sampler: str) -> list:
    """nes/spsa's probes in call order: step by step, probe by probe."""
    out = []
    with jax.enable_x64():
        for k in jax.random.split(key, steps):
            for kk in jax.random.split(k, n):
                if sampler == "gaussian":
                    out.append(t(jax.random.normal(kk, shape, F64)))
                else:
                    out.append(t(jax.random.rademacher(kk, shape, F64)))
    return out


def bandits_draws(key, steps: int, latent_shape) -> list:
    with jax.enable_x64():
        return [t(jax.random.normal(k, latent_shape, F64)) for k in jax.random.split(key, steps)]


def init_draws(key, trials: int, shape) -> list:
    """hsja/boundary's uniform start trials."""
    with jax.enable_x64():
        return [t(jax.random.uniform(k, shape, F64)) for k in jax.random.split(key, trials)]


def hsja_draws(key, steps: int, n_probes: int, init_trials: int, shape):
    """(start trials, probe directions in call order)."""
    with jax.enable_x64():
        k_init, k_probe = jax.random.split(key)
        probes = [t(jax.random.normal(kk, shape, F64))
                  for k in jax.random.split(k_probe, steps)
                  for kk in jax.random.split(k, n_probes)]
    return init_draws(k_init, init_trials, shape), probes


def boundary_draws(key, steps: int, init_trials: int, shape):
    """(start trials, the walk's normals)."""
    with jax.enable_x64():
        k_init, k_walk = jax.random.split(key)
        etas = [t(jax.random.normal(k, shape, F64)) for k in jax.random.split(k_walk, steps)]
    return init_draws(k_init, init_trials, shape), etas


def apgd_draw(key, shape, eps: float, norm: str):
    """apgd's start (and fab's jitter) for ``key``."""
    with jax.enable_x64():
        if norm == "linf":
            return t(jax.random.uniform(key, shape, F64, minval=-eps, maxval=eps))
        return t(jax.random.normal(key, shape, F64))


def eot_normals(key, mix: int, n: int, shape) -> list:
    """make_eot_logits_fn's normals for one call whose input mixes to ``mix``."""
    with jax.enable_x64():
        k = jax.random.fold_in(key, jnp.int32(mix))
        return [t(jax.random.normal(kk, shape, F64)) for kk in jax.random.split(k, n)]
