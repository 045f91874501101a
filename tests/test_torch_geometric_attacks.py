"""stAdv and the spatial attack of the port (attacks/stadv.py, spatial.py)
against the JAX package's on the CPU.

The warps (``flow_warp`` with its gradient to the flow, ``affine_warp``) and
``flow_smoothness`` are held directly; the attacks run on resnet_tiny with
the same float64 weights and float64 logits (the uncast closures of
``_torch_port_helpers``), four 32x32 images, a few steps.  The spatial
attack's random candidates take the JAX package's draws for the key
through ``spatial.draw_candidates``.  Everything agrees within 1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cli_helpers import one_thread  # noqa: F401 (autouse)
from _torch_port_helpers import flax_resnet, port_resnet, uncast_fns
from image_recognition_adversarial_example_attack_tpu.attacks import api as jax_api
from image_recognition_adversarial_example_attack_tpu.attacks import spatial as jax_spatial
from image_recognition_adversarial_example_attack_tpu.attacks import stadv as jax_stadv
from image_recognition_adversarial_example_attack_tpu_torch.attacks import (
    ATTACK_THREAT, AttackParams, run_attack)
from image_recognition_adversarial_example_attack_tpu_torch.attacks import spatial, stadv
from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed

TOL = 1e-9


@pytest.fixture(scope="module")
def setup():
    with jax.enable_x64():
        module, variables = flax_resnet("resnet_tiny", np.float64, num_classes=10, seed=5)
        model = port_resnet("resnet_tiny", variables, np.float64, num_classes=10)
        fns = uncast_fns(module, variables, model)
        x = np.random.RandomState(51).uniform(0.0, 1.0, size=(4, 32, 32, 3))
        x[0, 0] = 1.0  # pixels on the [0,1] bounds: the clip's tie gradient
        x[1, -1] = 0.0
        y = np.asarray(jax.jit(fns["jax"][0])(jnp.asarray(x))).argmax(-1)
    return fns["jax"][0], fns["port"][0], x, y


def _t(a):
    return torch.from_numpy(np.array(a))


def _flows():
    rs = np.random.RandomState(3)
    return {"zero": np.zeros((2, 7, 9, 2)),
            "small": rs.randn(2, 7, 9, 2) * 0.7,
            "outside": rs.randn(2, 7, 9, 2) * 6.0,
            "integer": np.round(rs.randn(2, 7, 9, 2) * 2.0)}


@pytest.mark.parametrize("kind", ["zero", "small", "outside", "integer"])
def test_flow_warp_and_its_flow_gradient_equal_jaxs(kind):
    """Zero flow puts the first and last rows and columns exactly on the
    clip's bounds, where jnp.clip's gradient is halved; integer flows put
    every source point on a corner."""
    rs = np.random.RandomState(5)
    x, flow, w = rs.rand(2, 7, 9, 3), _flows()[kind], rs.randn(2, 7, 9, 3)
    with jax.enable_x64():
        fx = jnp.asarray(x)
        want = np.asarray(jax_stadv.flow_warp(fx, jnp.asarray(flow)))
        want_g = np.asarray(jax.grad(lambda f: jnp.sum(jnp.asarray(w) * jax_stadv.flow_warp(
            fx, f)))(jnp.asarray(flow)))
    ft = _t(flow).requires_grad_(True)
    got = stadv.flow_warp(_t(x), ft)
    (got_g,) = torch.autograd.grad((_t(w) * got).sum(), ft)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got_g.numpy(), want_g, rtol=0, atol=1e-12)
    if kind == "zero":
        np.testing.assert_array_equal(got.detach().numpy(), x)  # the identity


def test_flow_smoothness_and_its_gradient_equal_jaxs():
    flow = _flows()["small"]
    with jax.enable_x64():
        want = np.asarray(jax_stadv.flow_smoothness(jnp.asarray(flow)))
        want_g = np.asarray(jax.grad(lambda f: jnp.sum(jax_stadv.flow_smoothness(f)))(
            jnp.asarray(flow)))
    ft = _t(flow).requires_grad_(True)
    got = stadv.flow_smoothness(ft)
    (got_g,) = torch.autograd.grad(got.sum(), ft)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got_g.numpy(), want_g, rtol=0, atol=1e-12)


@pytest.mark.parametrize("targeted", [False, True])
def test_stadv_equals_jaxs(setup, targeted):
    lf_jax, lf_port, x, y = setup
    y_t = (y + 3) % 10 if targeted else None
    kw = dict(steps=5, lr=0.05, tau=0.05, kappa=0.0)
    with jax.enable_x64():
        res = jax.jit(lambda xx: jax_stadv.stadv_attack(
            lf_jax, xx, jnp.asarray(y), y_target=None if y_t is None else jnp.asarray(y_t),
            **kw))(jnp.asarray(x))
    got = stadv.stadv_attack(lf_port, _t(x), _t(y),
                             y_target=None if y_t is None else _t(y_t), **kw)
    np.testing.assert_allclose(got.flow.numpy(), np.asarray(res.flow), rtol=0, atol=TOL)
    np.testing.assert_allclose(got.x_adv.numpy(), np.asarray(res.x_adv), rtol=0, atol=TOL)
    np.testing.assert_array_equal(got.success.numpy(), np.asarray(res.success))
    assert np.abs(got.flow.numpy()).max() > 0.01


@pytest.mark.parametrize("params", [(0.0, 0.0, 0.0), (180.0, 0.0, 0.0), (30.0, 2.5, -1.25),
                                    (-17.0, -4.0, 3.0)])
def test_affine_warp_equals_jaxs(params):
    rs = np.random.RandomState(6)
    x = rs.rand(2, 8, 10, 3)
    p = np.array([params, [7.0, 0.5, 0.25]])
    with jax.enable_x64():
        want = np.asarray(jax_spatial.affine_warp(
            jnp.asarray(x), jnp.asarray(p[:, 0]), jnp.asarray(p[:, 1]), jnp.asarray(p[:, 2]),
            fill=0.25))
    got = spatial.affine_warp(_t(x), _t(p[:, 0]), _t(p[:, 1]), _t(p[:, 2]), fill=0.25).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    if params == (0.0, 0.0, 0.0):
        np.testing.assert_array_equal(got[0], x[0])  # the identity
    if params[0] == 180.0:
        assert (got[0] != 0.25).all()  # the tolerance keeps the border in


@pytest.mark.parametrize("n,bound", [(1, 30.0), (3, 3.2), (5, 30.0), (31, 30.0)])
def test_grid_axis_equals_jaxs(n, bound):
    with jax.enable_x64():
        want = np.asarray(jax_spatial._grid_axis(n, bound, jnp.float64))
    np.testing.assert_allclose(spatial._grid_axis(n, bound, torch.float64).numpy(), want,
                               rtol=0, atol=1e-13)


@pytest.mark.parametrize("candidates,grid", [(4, (0, 0)), (0, (3, 3)), (3, (3, 3))])
def test_spatial_equals_jaxs(setup, candidates, grid, monkeypatch):
    """Random draws, the grid, and both: the grid's candidates come first."""
    lf_jax, lf_port, x, y = setup
    key = jax.random.PRNGKey(8)
    with jax.enable_x64():
        u = _t(jax.random.uniform(key, (candidates, 4, 3), jnp.float64, minval=-1.0, maxval=1.0))
    monkeypatch.setattr(spatial, "draw_candidates", lambda *a: u)
    kw = dict(max_rot=30.0, max_trans=0.1, candidates=candidates, grid_rot=grid[0],
              grid_trans=grid[1])
    with jax.enable_x64():
        res = jax.jit(lambda xx: jax_spatial.spatial_attack(
            lf_jax, xx, jnp.asarray(y), key=key, **kw))(jnp.asarray(x))
    got = spatial.spatial_attack(lf_port, _t(x), _t(y), generator=generator_from_seed(0), **kw)
    np.testing.assert_allclose(got.x_adv.numpy(), np.asarray(res.x_adv), rtol=0, atol=TOL)
    np.testing.assert_allclose(got.params.numpy(), np.asarray(res.params), rtol=0, atol=TOL)
    np.testing.assert_array_equal(got.success.numpy(), np.asarray(res.success))


def test_spatial_refuses_half_a_grid_and_an_empty_search():
    lf = lambda z: z.sum((1, 2))  # noqa: E731
    x, y = torch.rand(1, 4, 4, 3), torch.zeros(1, dtype=torch.long)
    with pytest.raises(ValueError, match="needs BOTH grid_rot and grid_trans"):
        spatial.spatial_attack(lf, x, y, candidates=0, grid_rot=3, grid_trans=0)
    with pytest.raises(ValueError, match="empty spatial search"):
        spatial.spatial_attack(lf, x, y, candidates=0)
    with pytest.raises(ValueError, match="explicit generator"):
        spatial.spatial_attack(lf, x, y, candidates=2)


@pytest.mark.parametrize("name", ["stadv", "spatial"])
def test_run_attack_dispatch_equals_jaxs(setup, name, monkeypatch):
    """Through ``run_attack``: the ``stadv_*`` / ``spatial_*`` fields (and
    ``cw_kappa`` for stadv) reach the attacks as in JAX."""
    lf_jax, lf_port, x, y = setup
    key = jax.random.PRNGKey(2)
    kw = dict(stadv_steps=3, stadv_lr=0.02, cw_kappa=0.1, spatial_candidates=2,
              spatial_grid_rot=3, spatial_grid_trans=1, spatial_max_rot=20.0)
    with jax.enable_x64():
        u = _t(jax.random.uniform(key, (2, 4, 3), jnp.float64, minval=-1.0, maxval=1.0))
    monkeypatch.setattr(spatial, "draw_candidates", lambda *a: u)
    with jax.enable_x64():
        want = np.asarray(jax.jit(lambda xx: jax_api.run_attack(
            name, lf_jax, xx, jnp.asarray(y), jax_api.AttackParams(**kw), key))(jnp.asarray(x)))
    got = run_attack(name, lf_port, _t(x), _t(y), AttackParams(**kw),
                     generator_from_seed(0)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert ATTACK_THREAT[name] == jax_api.ATTACK_THREAT[name] == "none"
