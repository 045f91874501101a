"""PGD in the L2 and L1 balls and the worst-of-restarts PGD of the port
(attacks/pgd.py) against the JAX package's on the CPU.

Both sides attack resnet_tiny with the same float64 weights and float64
logits (the uncast closures of ``_torch_port_helpers``), four 32x32 images,
a few steps.  The random starts take the JAX package's own draws for the
key, through the port's draw functions (``draw_start``, ``draw_l2_start``,
``draw_l1_start``), so the adversarial batches agree within 1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import module_time_limit, one_thread, time_limit  # noqa: F401 (autouse)
from _torch_port_helpers import flax_resnet, port_resnet, uncast_fns
from image_recognition_adversarial_example_attack_tpu.attacks import api as jax_api
from image_recognition_adversarial_example_attack_tpu.attacks import pgd as jax_pgd
from image_recognition_adversarial_example_attack_tpu_torch.attacks import (
    ATTACK_THREAT, AttackParams, run_attack)
from image_recognition_adversarial_example_attack_tpu_torch.attacks import pgd
from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed

TOL = 1e-9
STEPS = 4


@pytest.fixture(scope="module")
def setup():
    with jax.enable_x64():
        module, variables = flax_resnet("resnet_tiny", np.float64, num_classes=10, seed=5)
        model = port_resnet("resnet_tiny", variables, np.float64, num_classes=10)
        fns = uncast_fns(module, variables, model)
        x = np.random.RandomState(21).uniform(0.1, 0.9, size=(4, 32, 32, 3))
        y = np.asarray(jax.jit(fns["jax"][0])(jnp.asarray(x))).argmax(-1)
    return fns["jax"][0], fns["port"][0], x, y


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax(fn, x, **kw):
    with jax.enable_x64():
        return np.asarray(jax.jit(lambda xx: fn(xx, **kw))(jnp.asarray(x)))


def _l2_draws(key, shape):
    with jax.enable_x64():
        normal = jax.random.normal(key, shape, jnp.float64)
        radius = jax.random.uniform(jax.random.fold_in(key, 1), (shape[0], 1, 1, 1), jnp.float64)
    return _t(normal), _t(radius)


def _l1_draws(key, shape):
    with jax.enable_x64():
        noise = jax.random.uniform(key, shape, jnp.float64, minval=-1.0, maxval=1.0)
        scale = jax.random.uniform(jax.random.fold_in(key, 1), (shape[0], 1, 1, 1), jnp.float64)
    return _t(noise), _t(scale)


@pytest.mark.parametrize("targeted,random_start", [(False, True), (True, False)])
def test_pgd_l2_equals_jaxs(setup, targeted, random_start, monkeypatch):
    lf_jax, lf_port, x, y = setup
    eps, alpha, key = 0.5, 0.2, jax.random.PRNGKey(3)
    y_t = (y + 3) % 10 if targeted else None
    monkeypatch.setattr(pgd, "draw_l2_start", lambda shape, *a: _l2_draws(key, shape))
    want = _jax(lambda xx: jax_pgd.pgd_l2_attack(
        lf_jax, xx, jnp.asarray(y), eps=eps, alpha=alpha, steps=STEPS, key=key,
        random_start=random_start, y_target=None if y_t is None else jnp.asarray(y_t)), x)
    got = pgd.pgd_l2_attack(lf_port, _t(x), _t(y), eps=eps, alpha=alpha, steps=STEPS,
                            generator=generator_from_seed(0), random_start=random_start,
                            y_target=None if y_t is None else _t(y_t)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    l2 = np.sqrt(((got - x) ** 2).reshape(4, -1).sum(-1))
    assert (l2 <= eps + 1e-9).all() and l2.max() > eps / 2
    assert 0.0 <= got.min() and got.max() <= 1.0


@pytest.mark.parametrize("targeted,sparsity", [(False, 0.01), (True, 0.2)])
def test_pgd_l1_equals_jaxs(setup, targeted, sparsity, monkeypatch):
    lf_jax, lf_port, x, y = setup
    eps, alpha, key = 4.0, 1.0, jax.random.PRNGKey(5)
    y_t = (y + 3) % 10 if targeted else None
    monkeypatch.setattr(pgd, "draw_l1_start", lambda shape, *a: _l1_draws(key, shape))
    want = _jax(lambda xx: jax_pgd.pgd_l1_attack(
        lf_jax, xx, jnp.asarray(y), eps=eps, alpha=alpha, steps=STEPS, key=key,
        sparsity=sparsity, y_target=None if y_t is None else jnp.asarray(y_t)), x)
    got = pgd.pgd_l1_attack(lf_port, _t(x), _t(y), eps=eps, alpha=alpha, steps=STEPS,
                            generator=generator_from_seed(0), sparsity=sparsity,
                            y_target=None if y_t is None else _t(y_t)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    l1 = np.abs(got - x).reshape(4, -1).sum(-1)
    assert (l1 <= eps + 1e-9).all() and l1.max() > eps / 2


def test_pgd_multi_restart_equals_jaxs(setup, monkeypatch):
    """The JAX package vmaps the restarts; the port runs them in turn from
    the same per-restart draws and keeps, per sample, the highest CE."""
    lf_jax, lf_port, x, y = setup
    eps, alpha, restarts, key = 8 / 255, 2 / 255, 3, jax.random.PRNGKey(9)
    with jax.enable_x64():
        draws = iter([_t(jax.random.uniform(k, x.shape, jnp.float64, -eps, eps))
                      for k in jax.random.split(key, restarts)])
    monkeypatch.setattr(pgd, "draw_start", lambda *a: next(draws))
    want = _jax(lambda xx: jax_pgd.pgd_multi_restart(
        lf_jax, xx, jnp.asarray(y), eps=eps, alpha=alpha, steps=STEPS, key=key,
        restarts=restarts), x)
    got = pgd.pgd_multi_restart(lf_port, _t(x), _t(y), eps=eps, alpha=alpha, steps=STEPS,
                                generator=generator_from_seed(0), restarts=restarts).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert np.abs(got - x).max() <= eps + 1e-12


def test_multi_restart_keeps_the_first_of_tied_restarts(monkeypatch):
    """Per sample the highest CE; a tie keeps the earlier restart, as
    ``jnp.argmax`` does.  Restart r returns r/10 + 0.1 everywhere; the CE of
    label 0 grows with the logit v of class 1: v = 0 for sample 0 (three
    restarts tie), v = 10 * min(r, 0.2) for sample 1 (restarts 1 and 2 tie)."""
    x = torch.zeros(2, 2, 2, 3)
    outs = iter([torch.full_like(x, 0.1), torch.full_like(x, 0.2), torch.full_like(x, 0.3)])
    monkeypatch.setattr(pgd, "pgd_linf_attack", lambda *a, **k: next(outs))

    def logits(z):
        v = torch.stack([torch.zeros(()), torch.clamp_max(z[1, 0, 0, 0], 0.2) * 10])
        return torch.stack([torch.zeros(2), v], dim=1)

    got = pgd.pgd_multi_restart(logits, x, torch.tensor([0, 0]), eps=1.0, alpha=1.0,
                                steps=1, generator=generator_from_seed(0), restarts=3)
    assert float(got[0, 0, 0, 0]) == pytest.approx(0.1)
    assert float(got[1, 0, 0, 0]) == pytest.approx(0.2)


@pytest.mark.parametrize("eps", [0.5, 3.0, 50.0])
def test_project_l1_ball_equals_jaxs(eps):
    rs = np.random.RandomState(4)
    delta = rs.randn(5, 6, 7, 3) * rs.uniform(0.01, 1.0, (5, 1, 1, 1))
    delta[0] = 0.0
    delta[1, 0, 0, 0] = 3 * eps  # one dominant coordinate
    with jax.enable_x64():
        want = np.asarray(jax.jit(jax_pgd.project_l1_ball, static_argnums=1)(
            jnp.asarray(delta), eps))
    got = pgd.project_l1_ball(_t(delta), eps).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    l1 = np.abs(got).reshape(5, -1).sum(-1)
    assert (l1 <= eps + 1e-9).all()
    inside = np.abs(delta).reshape(5, -1).sum(-1) <= eps
    np.testing.assert_array_equal(got[inside], delta[inside])


def test_registry_threat_models():
    assert ATTACK_THREAT["pgd_l2"] == jax_api.ATTACK_THREAT["pgd_l2"] == "l2"
    assert ATTACK_THREAT["pgd_l1"] == jax_api.ATTACK_THREAT["pgd_l1"] == "l1"
    assert "pgd_multi_restart" not in ATTACK_THREAT  # a library function, as in JAX


@pytest.mark.parametrize("name", ["pgd_l2", "pgd_l1"])
def test_run_attack_dispatch_equals_jaxs(setup, name, monkeypatch):
    """Through ``run_attack``: the same AttackParams fields, the same draws."""
    lf_jax, lf_port, x, y = setup
    key = jax.random.PRNGKey(2)
    kw = dict(eps=1.0, alpha=0.3, steps=3, l1_sparsity=0.05)
    monkeypatch.setattr(pgd, "draw_l2_start", lambda shape, *a: _l2_draws(key, shape))
    monkeypatch.setattr(pgd, "draw_l1_start", lambda shape, *a: _l1_draws(key, shape))
    want = _jax(lambda xx: jax_api.run_attack(name, lf_jax, xx, jnp.asarray(y),
                                              jax_api.AttackParams(**kw), key), x)
    got = run_attack(name, lf_port, _t(x), _t(y), AttackParams(**kw),
                     generator_from_seed(0)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
