"""Shared set-up of the port's training parity tests
(tests/test_torch_train*.py, test_torch_augment_pipeline.py).

Both packages train ``wrn_tiny`` (or ``ibp_tiny``) from the same float64
variables: the JAX package's Flax module is initialized, its statistics and
affine parameters perturbed from a numpy seed, and the port's state is
built from the same variables, then loaded with the JAX state's arrays
through ``train.adversarial.train_state_from_jax``.

The JAX step casts its logits (and its EMA, its accuracies, the IBP
propagators' inputs) to float32 whatever the model's dtype; the port does
the same (``train.adversarial.LOSS_DTYPE``), and the JAX CIFAR models cast
their logits to float32.  ``lifted_casts`` runs both with that float32
replaced by float64 (the JAX modules get a ``jnp`` whose ``float32`` is
float64, the port ``LOSS_DTYPE = float64``), so that a
float64 run stays float64 end to end and the two packages agree to the
last digits.  The JAX draws are replayed from its key chain here and fed
to the port through its draw functions, in the order the port's step
makes them.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_port_helpers import flax_init
from image_recognition_adversarial_example_attack_tpu.core.constants import (
    CIFAR10_MEAN, CIFAR10_STD)
from image_recognition_adversarial_example_attack_tpu.defenses import crown_ibp as jax_crown
from image_recognition_adversarial_example_attack_tpu.defenses import ibp as jax_ibp
from image_recognition_adversarial_example_attack_tpu.models import ibp as jax_ibp_models
from image_recognition_adversarial_example_attack_tpu.models import preactresnet as jax_preact
from image_recognition_adversarial_example_attack_tpu.models import wideresnet as jax_wrn
from image_recognition_adversarial_example_attack_tpu.models.zoo import (
    ModelBundle as JaxBundle)
from image_recognition_adversarial_example_attack_tpu.train import adversarial as jax_adv
from image_recognition_adversarial_example_attack_tpu_torch.attacks import eot, pgd
from image_recognition_adversarial_example_attack_tpu_torch.models import ibp as port_ibp
from image_recognition_adversarial_example_attack_tpu_torch.models import wideresnet
from image_recognition_adversarial_example_attack_tpu_torch.models.convert import (
    from_jax_variables)
from image_recognition_adversarial_example_attack_tpu_torch.models.zoo import ModelBundle
from image_recognition_adversarial_example_attack_tpu_torch.train import adversarial, augment

F64 = jnp.float64
FAMILY = {"wrn_tiny": "wideresnet", "ibp_tiny": "ibp"}
ZERO01 = (np.zeros(3, np.float32), np.ones(3, np.float32))


class JnpF64:
    """``jax.numpy`` whose ``float32`` is float64."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@contextlib.contextmanager
def lifted_casts():
    """The JAX step's, models' and propagators' float32 casts, and the
    port's, as float64 (module doc)."""
    mods = (jax_adv, jax_ibp, jax_crown, jax_wrn, jax_preact)
    saved = [m.jnp for m in mods], adversarial.LOSS_DTYPE
    for m in mods:
        m.jnp = JnpF64()
    adversarial.LOSS_DTYPE = torch.float64
    try:
        yield
    finally:
        for m, j in zip(mods, saved[0]):
            m.jnp = j
        adversarial.LOSS_DTYPE = saved[1]


def _perturb(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng)
            continue
        v = np.asarray(v, np.float64)
        if k == "var":
            v = rng.uniform(0.5, 1.5, v.shape)
        elif k == "scale":
            v = rng.uniform(0.7, 1.3, v.shape)
        elif k in ("mean", "bias"):
            v = v + rng.randn(*v.shape) * 0.1
        out[k] = v
    return out


def jax_module(name: str, dtype=F64, train_bn: bool = False):
    if name == "ibp_tiny":
        return jax_ibp_models.ibp_tiny()
    return jax_wrn.wrn_tiny(dtype=dtype)


def variables(name: str = "wrn_tiny", seed: int = 3, dtype=np.float64) -> dict:
    """Perturbed variables of ``name`` as numpy arrays of ``dtype`` (the Flax
    module's ``init``, compiled once a process)."""
    v = _perturb(flax_init(jax_module(name)), np.random.RandomState(seed))
    return jax.tree_util.tree_map(lambda a: np.array(a, dtype), v)  # copies: not the cache


def stats(name: str):
    return ZERO01 if name == "ibp_tiny" else (CIFAR10_MEAN, CIFAR10_STD)


def jax_bundle(name: str, var: dict, dtype=F64) -> JaxBundle:
    mean, std = stats(name)
    return JaxBundle(name=name, module=jax_module(name, dtype), variables=var,
                     source="random", mean=mean.copy(), std=std.copy(), input_size=32)


def port_bundle(name: str, var: dict, dtype=torch.float64) -> ModelBundle:
    model = (port_ibp.ibp_tiny() if name == "ibp_tiny" else wideresnet.wrn_tiny()).to(dtype)
    model.load_state_dict(from_jax_variables(var, FAMILY[name]), strict=True)
    mean, std = stats(name)
    return ModelBundle(name=name, model=model.requires_grad_(False).eval(), source="random",
                       dtype=dtype, device=torch.device("cpu"), mean=mean.copy(),
                       std=std.copy(), input_size=32)


def carry(template, jax_state, name: str = "wrn_tiny"):
    """The port's state loaded with a JAX TrainState's arrays."""
    adam = jax_state.opt_state[0]
    g = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    return adversarial.train_state_from_jax(
        template, FAMILY[name], params=g(jax_state.params),
        extra_variables=g(jax_state.extra_variables), mu=g(adam.mu), nu=g(adam.nu),
        count=int(adam.count), step=int(jax_state.step),
        ema_params=None if jax_state.ema_params is None else g(jax_state.ema_params))


def port_params(jax_params, name: str = "wrn_tiny") -> dict:
    """A JAX parameter tree in the port's layout (numpy)."""
    sd = from_jax_variables({"params": jax.tree_util.tree_map(np.asarray, jax_params)},
                            FAMILY[name])
    return {k: v.numpy() for k, v in sd.items()}


def max_diff(port_tree: dict, jax_tree, name: str = "wrn_tiny") -> float:
    want = port_params(jax_tree, name)
    assert set(want) == set(port_tree)
    return max(float(np.max(np.abs(port_tree[k].detach().cpu().numpy() - want[k])))
               for k in want)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# the JAX step's key chain, replayed (train/adversarial.py)
# ---------------------------------------------------------------------------

def aug_draws(key, shape, pad: int):
    """train/augment.py's draws for ``key``: (offsets, coins, cy, cx)."""
    b, h, w = shape[:3]
    k_crop, k_flip, k_cut = jax.random.split(key, 3)
    k_y, k_x = jax.random.split(k_cut)
    offsets = jax.random.randint(k_crop, (b, 2), 0, 2 * pad + 1)
    coins = jax.random.bernoulli(k_flip, 0.5, (b,))
    cy = jax.random.randint(k_y, (b,), 0, h)
    cx = jax.random.randint(k_x, (b,), 0, w)
    return tuple(t(np.asarray(a)).long() if a.dtype != bool else t(np.asarray(a))
                 for a in (offsets, coins, cy, cx))


def step_draws(objective: str, config, key, shape, dtype=F64) -> dict:
    """Every draw one JAX step of ``objective`` makes from ``key`` on a batch
    of ``shape`` in ``dtype``, by draw function, in the port's order."""
    out = defaultdict(list)
    with jax.enable_x64(dtype == F64):
        if objective == "free":
            if config.aug_pad or config.aug_flip or config.aug_cutout:
                out["augment"].append(aug_draws(key, shape, config.aug_pad))
            return out
        if config.aug_pad or config.aug_flip or config.aug_cutout:
            k_aug, key = jax.random.split(key)
            out["augment"].append(aug_draws(k_aug, shape, config.aug_pad))
        accum = int(config.grad_accum)
        keys = ([jax.random.fold_in(key, i) for i in range(accum)] if accum > 1 else [key])
        micro = (shape[0] // accum, *shape[1:])
        for k in keys:
            if objective == "trades":
                out["trades"].append(t(jax.random.normal(k, micro, dtype)))
            elif objective == "mart":
                out["start"].append(t(jax.random.uniform(k, micro, dtype, -config.eps,
                                                         config.eps)))
            elif objective == "pgd-at":
                k_attack, k_eot, k_noise = jax.random.split(k, 3)
                if config.attack_steps > 0:
                    out["start"].append(t(jax.random.uniform(k_attack, micro, dtype,
                                                             -config.eps, config.eps)))
                    if config.noise_sigma > 0:
                        out["eot"].append(k_eot)
                if config.noise_sigma > 0:
                    out["cohen"].append(t(jax.random.normal(k_noise, micro, dtype)))
    return out


class Feeder:
    """Hands queued JAX draws to the port's draw functions, in call order."""

    def __init__(self, monkeypatch, n_eot: int = 4):
        self.q = defaultdict(list)
        self.eot_keys = {}
        pop = lambda name: (lambda *a, **k: self.q[name].pop(0))  # noqa: E731
        monkeypatch.setattr(pgd, "draw_start", pop("start"))
        monkeypatch.setattr(adversarial, "draw_trades_start", pop("trades"))
        monkeypatch.setattr(adversarial, "draw_cohen_noise", pop("cohen"))
        monkeypatch.setattr(augment, "draw_augment", pop("augment"))

        def seed_draw(_g):
            key = self.q["eot"].pop(0)
            self.eot_keys[len(self.eot_keys)] = key
            return len(self.eot_keys) - 1

        def call_generator(seed, mix, device):
            with jax.enable_x64():
                k = jax.random.fold_in(self.eot_keys[seed], jnp.int32(mix))
                return iter([t(jax.random.normal(kk, self.eot_shape, F64))
                             for kk in jax.random.split(k, n_eot)])

        monkeypatch.setattr(eot, "seed_draw", seed_draw)
        monkeypatch.setattr(eot, "call_generator", call_generator)
        monkeypatch.setattr(eot, "draw_noise", lambda shape, g, device: next(g))
        self.eot_shape = None

    def add(self, draws: dict, shape=None):
        for k, v in draws.items():
            self.q[k].extend(v)
        self.eot_shape = shape

    def empty(self) -> bool:
        return not any(self.q.values())
