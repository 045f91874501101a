"""APGD-CE/DLR/T and FAB-T of the port (attacks/apgd.py, attacks/fab.py)
against the JAX package's on the CPU.

Both sides attack resnet_tiny with the same float64 weights and float64
logits (the uncast closures of ``_torch_port_helpers``), four 32x32 images,
a few steps, in both the 'linf' and the 'l2' norm.  The random starts and
jitters take the JAX package's own draws for the key (one per target for
APGD-T and FAB-T, from ``jax.random.split``) through the port's draw
functions, so the adversarial batches agree within 1e-9.  The helpers
(``apgd_checkpoints``, ``dlr_loss``, ``dlr_loss_targeted``,
``project_box_hyperplane``) are held directly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import module_time_limit, one_thread, time_limit  # noqa: F401 (autouse)
from _torch_port_helpers import flax_resnet, port_resnet, uncast_fns
from image_recognition_adversarial_example_attack_tpu.attacks import api as jax_api
from image_recognition_adversarial_example_attack_tpu.attacks import apgd as jax_apgd
from image_recognition_adversarial_example_attack_tpu.attacks import fab as jax_fab
from image_recognition_adversarial_example_attack_tpu_torch.attacks import (
    ATTACK_THREAT, AttackParams, run_attack)
from image_recognition_adversarial_example_attack_tpu_torch.attacks import apgd, fab
from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed

TOL = 1e-9
EPS = {"linf": 8 / 255, "l2": 0.5}
# APGD-DLR in the L2 ball.  Once a sample's true class ranks third and the
# top class is its strongest rival, DLR = (z1 - z3) / (z1 - z3 + 1e-12) is 1
# to within 1e-11, and its gradient is the difference of two terms of size
# |dz|/D that cancel down to |dz| * 1e-12 / D**2: in float64 it keeps only
# about five significant digits, which differ between JAX's and autograd's
# order of summation.  sign() hides that (the L∞ run holds 1e-9); the L2 step
# moves along the normalized gradient itself, so the iterates part by up to
# 2e-8 after a dozen steps.  The bound for that one case:
DLR_L2_TOL = 1e-6


@pytest.fixture(scope="module")
def setup():
    with jax.enable_x64():
        module, variables = flax_resnet("resnet_tiny", np.float64, num_classes=10, seed=5)
        model = port_resnet("resnet_tiny", variables, np.float64, num_classes=10)
        fns = uncast_fns(module, variables, model)
        x = np.random.RandomState(31).uniform(0.1, 0.9, size=(4, 32, 32, 3))
        y = np.asarray(jax.jit(fns["jax"][0])(jnp.asarray(x))).argmax(-1)
    return fns["jax"][0], fns["port"][0], x, y


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax(fn, x):
    with jax.enable_x64():
        return np.asarray(jax.jit(fn)(jnp.asarray(x)))


def _draw(key, shape, eps, norm):
    """The JAX package's start (apgd) or jitter (fab) draw for ``key``."""
    with jax.enable_x64():
        if norm == "linf":
            return _t(jax.random.uniform(key, shape, jnp.float64, minval=-eps, maxval=eps))
        return _t(jax.random.normal(key, shape, jnp.float64))


def _draws(keys, shape, eps, norm):
    draws = iter([_draw(k, shape, eps, norm) for k in keys])
    return lambda *a: next(draws)


@pytest.mark.parametrize("steps", [1, 2, 5, 10, 12, 100])
def test_apgd_checkpoints_equal_jaxs(steps):
    np.testing.assert_array_equal(apgd.apgd_checkpoints(steps), jax_apgd.apgd_checkpoints(steps))


def test_dlr_losses_and_their_gradients_equal_jaxs():
    rs = np.random.RandomState(3)
    z = rs.randn(6, 7)
    z[0, 2] = z[0, 5]  # a tie in the ranking
    y, t = rs.randint(0, 7, 6), rs.randint(0, 7, 6)
    with jax.enable_x64():
        want = [np.asarray(f(jnp.asarray(z))) for f in (
            lambda zz: jax_apgd.dlr_loss(zz, jnp.asarray(y)),
            lambda zz: jax_apgd.dlr_loss_targeted(zz, jnp.asarray(y), jnp.asarray(t)),
            jax.grad(lambda zz: jnp.sum(jax_apgd.dlr_loss(zz, jnp.asarray(y)))),
            jax.grad(lambda zz: jnp.sum(jax_apgd.dlr_loss_targeted(
                zz, jnp.asarray(y), jnp.asarray(t)))))]
    zt = _t(z).requires_grad_(True)
    got_u = apgd.dlr_loss(zt, _t(y))
    (g_u,) = torch.autograd.grad(got_u.sum(), zt)
    got_t = apgd.dlr_loss_targeted(zt, _t(y), _t(t))
    (g_t,) = torch.autograd.grad(got_t.sum(), zt)
    for got, w in zip((got_u, got_t, g_u, g_t), want):
        np.testing.assert_allclose(got.detach().numpy(), w, rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match=">= 3 classes"):
        apgd.dlr_loss(torch.zeros(2, 2), torch.zeros(2, dtype=torch.long))
    with pytest.raises(ValueError, match=">= 4 classes"):
        apgd.dlr_loss_targeted(torch.zeros(2, 3), torch.zeros(2, dtype=torch.long),
                               torch.ones(2, dtype=torch.long))


@pytest.mark.parametrize("norm", ["linf", "l2"])
@pytest.mark.parametrize("loss", ["ce", "dlr"])
def test_apgd_equals_jaxs(setup, norm, loss, monkeypatch):
    """12 steps: checkpoints at iterations 3, 5, 7, 9, 10 and 11."""
    lf_jax, lf_port, x, y = setup
    eps, key = EPS[norm], jax.random.PRNGKey(4)
    monkeypatch.setattr(apgd, "draw_start", _draws([key], x.shape, eps, norm))
    want = _jax(lambda xx: jax_apgd.apgd_attack(lf_jax, xx, jnp.asarray(y), eps=eps, steps=12,
                                                key=key, loss=loss, norm=norm), x)
    got = apgd.apgd_attack(lf_port, _t(x), _t(y), eps=eps, steps=12,
                           generator=generator_from_seed(0), loss=loss, norm=norm).numpy()
    tol = DLR_L2_TOL if (loss, norm) == ("dlr", "l2") else TOL
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    d = (got - x).reshape(4, -1)
    size = np.abs(d).max(-1) if norm == "linf" else np.sqrt((d * d).sum(-1))
    assert (size <= eps + 1e-9).all() and size.max() > eps / 2


@pytest.mark.parametrize("norm", ["linf", "l2"])
def test_apgd_targeted_equals_jaxs(setup, norm, monkeypatch):
    lf_jax, lf_port, x, y = setup
    eps, key, n_targets = EPS[norm], jax.random.PRNGKey(6), 3
    with jax.enable_x64():
        keys = jax.random.split(key, n_targets)
    monkeypatch.setattr(apgd, "draw_start", _draws(keys, x.shape, eps, norm))
    with jax.enable_x64():
        want_x, want_s = jax.jit(lambda xx: jax_apgd.apgd_targeted_attack(
            lf_jax, xx, jnp.asarray(y), eps=eps, steps=5, n_targets=n_targets, key=key,
            norm=norm))(jnp.asarray(x))
    got_x, got_s = apgd.apgd_targeted_attack(lf_port, _t(x), _t(y), eps=eps, steps=5,
                                             n_targets=n_targets,
                                             generator=generator_from_seed(0), norm=norm)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=0, atol=TOL)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def test_runner_up_targets_keep_the_lower_index_of_a_tie():
    logits = torch.tensor([[0.0, 2.0, 1.0, 2.0, 1.0]])
    np.testing.assert_array_equal(apgd.runner_up_targets(logits, 3).numpy(), [[3], [2], [4]])
    np.testing.assert_array_equal(
        np.asarray(jnp.argsort(-jnp.asarray(logits.numpy()), axis=-1))[:, 1:4].T,
        [[3], [2], [4]])


@pytest.mark.parametrize("norm", ["linf", "l2"])
def test_project_box_hyperplane_equals_jaxs(norm):
    rs = np.random.RandomState(8)
    z = rs.uniform(0, 1, (5, 4, 4, 3))
    w = rs.randn(5, 4, 4, 3)
    w[1, :2] = 0.0  # zero coordinates
    b = rs.randn(5) * 2.0
    b[2] = -np.sum(w[2] * z[2])  # z on the hyperplane: its side is 0
    b[3] = 1e3  # out of reach inside the box
    with jax.enable_x64():
        want = np.asarray(jax.jit(lambda *a: jax_fab.project_box_hyperplane(*a, norm=norm))(
            jnp.asarray(z), jnp.asarray(w), jnp.asarray(b)))
    got = fab.project_box_hyperplane(_t(z), _t(w), _t(b), norm=norm).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert 0.0 <= got.min() and got.max() <= 1.0
    # where reachable, the result lies on the hyperplane (to bisection precision)
    g = (w * got).reshape(5, -1).sum(-1) + b
    assert np.abs(g[[0, 1, 4]]).max() < 1e-6 * np.abs(w).reshape(5, -1).sum(-1).max()


@pytest.mark.parametrize("norm", ["linf", "l2"])
def test_fab_equals_jaxs(setup, norm, monkeypatch):
    lf_jax, lf_port, x, y = setup
    eps, key, n_targets = EPS[norm], jax.random.PRNGKey(7), 2
    with jax.enable_x64():
        keys = jax.random.split(key, n_targets)
    monkeypatch.setattr(fab, "draw_start", _draws(keys, x.shape, eps, norm))
    want = _jax(lambda xx: jax_fab.fab_targeted_attack(
        lf_jax, xx, jnp.asarray(y), eps=eps, steps=4, n_targets=n_targets, key=key,
        norm=norm), x)
    got = fab.fab_targeted_attack(lf_port, _t(x), _t(y), eps=eps, steps=4, n_targets=n_targets,
                                  generator=generator_from_seed(0), norm=norm).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert 0.0 <= got.min() and got.max() <= 1.0


@pytest.mark.parametrize("name", ["apgd_t", "fab"])
def test_run_attack_dispatch_equals_jaxs(setup, name, monkeypatch):
    """Through ``run_attack``: ``steps`` and ``n_target_classes`` reach the
    attacks as in JAX, and fab's out-of-ball samples return the clean
    input (a small eps puts some outside).  apgd and apgd_dlr read the
    same two fields as apgd_t's runs."""
    lf_jax, lf_port, x, y = setup
    key = jax.random.PRNGKey(1)
    kw = dict(eps=2 / 255, steps=4, n_target_classes=2)
    multi = name in ("apgd_t", "fab")
    with jax.enable_x64():
        keys = jax.random.split(key, 2) if multi else [key]
    draws = _draws(keys, x.shape, kw["eps"], "linf")
    monkeypatch.setattr(apgd, "draw_start", draws)
    monkeypatch.setattr(fab, "draw_start", draws)
    want = _jax(lambda xx: jax_api.run_attack(name, lf_jax, xx, jnp.asarray(y),
                                              jax_api.AttackParams(**kw), key), x)
    got = run_attack(name, lf_port, _t(x), _t(y), AttackParams(**kw),
                     generator_from_seed(0)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert np.abs(got - x).max() <= kw["eps"] + 1e-6
    assert ATTACK_THREAT[name] == jax_api.ATTACK_THREAT[name] == "linf"


@pytest.mark.parametrize("name", ["apgd", "apgd_dlr", "apgd_t", "fab"])
def test_untargeted_only_attacks_refuse_a_target(name):
    x = torch.zeros(1, 4, 4, 3)
    with pytest.raises(ValueError, match="untargeted|its own top-K"):
        run_attack(name, lambda z: z.sum((1, 2)), x, torch.zeros(1, dtype=torch.long),
                   AttackParams(), y_target=torch.ones(1, dtype=torch.long))
