"""Square Attack of the port (attacks/square.py) against the JAX package's on
the CPU: the p-schedule and the bump windows, then the L∞ and L2 searches
(20 steps, float64 resnet_tiny, JAX's draws fed through ``draw_square`` /
``draw_square_l2``): their per-step success histories equal, their results
within 1e-9 (L2: ``L2_TOL``, explained below)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_blackbox_helpers import (TOL, constant, make_setup, run_jax, square_draws,
                                     square_l2_draws, t)
from _torch_port_helpers import module_time_limit, one_thread, time_limit  # noqa: F401 (autouse)
from image_recognition_adversarial_example_attack_tpu.attacks import square as jax_square
from image_recognition_adversarial_example_attack_tpu_torch.attacks import square
from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed

STEPS = 20
# Square-L2 refills a window with ``budget = sqrt(old1 + freed + unused)``,
# ``unused = max(eps**2 - ||delta||**2, 0)``.  After the start ||delta|| = eps
# exactly in exact arithmetic, so ``unused`` is a difference of two equal
# numbers: each side's sum of 12288 squares lands a few ulps of 0.25
# (2**-54 each) from eps**2, in a different place for XLA's order of
# summation and for torch's.  Where the window held no mass the new window's
# values are then of order sqrt(1e-16) = 1e-8 on one side and 0 (or another
# 1e-8) on the other: that window's few pixels part by up to about 3e-8,
# while every decision (the history) agrees.  The bound for that one case:
L2_TOL = 1e-7


@pytest.fixture(scope="module")
def setup():
    return make_setup()


@pytest.mark.parametrize("steps,h,w,p", [(1, 32, 32, 0.1), (20, 32, 32, 0.1),
                                          (1000, 224, 224, 0.1), (5000, 224, 224, 0.05),
                                          (57, 7, 5, 0.3)])
def test_square_schedule_equals_jaxs(steps, h, w, p):
    np.testing.assert_array_equal(square.square_schedule(steps, h, w, p),
                                  jax_square.square_schedule(steps, h, w, p))


def test_bump_windows_equal_jaxs():
    rs = np.random.RandomState(2)
    b, h, w = 5, 12, 9
    r0 = rs.randint(0, 6, (b, 1, 1, 1)).astype(np.float64)
    c0 = rs.randint(0, 4, (b, 1, 1, 1)).astype(np.float64)
    rows = np.arange(h, dtype=np.float64).reshape(1, h, 1, 1)
    cols = np.arange(w, dtype=np.float64).reshape(1, 1, w, 1)
    for side in (1.0, 2.0, 5.0):
        with jax.enable_x64():
            want_w, want_m = jax_square._bump_window(*map(jnp.asarray, (rows, cols, r0, c0)),
                                                     side)
        got_w, got_m = square._bump_window(t(rows), t(cols), t(r0), t(c0), side)
        np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), rtol=0, atol=1e-15)
        np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
        # unit L2 on its window
        np.testing.assert_allclose((got_w.numpy() ** 2).sum((1, 2, 3)), 1.0, atol=1e-12)


@pytest.mark.parametrize("norm", ["linf", "l2"])
def test_square_equals_jaxs(setup, norm, monkeypatch):
    lf_jax, lf_port, x, y = setup
    key = jax.random.PRNGKey(11)
    eps = 8 / 255 if norm == "linf" else 0.5
    if norm == "linf":
        jax_fn, fn = jax_square.square_attack, square.square_attack
        monkeypatch.setattr(square, "draw_square", constant(square_draws(key, STEPS, x.shape)))
    else:
        jax_fn, fn = jax_square.square_l2_attack, square.square_l2_attack
        monkeypatch.setattr(square, "draw_square_l2",
                            constant(square_l2_draws(key, STEPS, x.shape)))
    want_x, want_h = run_jax(lambda xx: jax_fn(lf_jax, xx, jnp.asarray(y), eps=eps, steps=STEPS,
                                               key=key, return_history=True), x)
    got_x, got_h = fn(lf_port, t(x), t(y), eps=eps, steps=STEPS,
                      generator=generator_from_seed(0), return_history=True)
    np.testing.assert_allclose(got_x.numpy(), want_x, rtol=0,
                               atol=TOL if norm == "linf" else L2_TOL)
    np.testing.assert_array_equal(got_h.numpy(), want_h)
    assert got_h.shape == (STEPS, 4) and got_h.dtype == torch.bool
    # the history costs no query and changes nothing
    again = fn(lf_port, t(x), t(y), eps=eps, steps=STEPS, generator=generator_from_seed(0))
    assert torch.equal(again, got_x)
    d = (got_x.numpy() - x).reshape(4, -1)
    size = np.abs(d).max(-1) if norm == "linf" else np.sqrt((d * d).sum(-1))
    assert (size <= eps + 1e-9).all() and size.max() > eps / 2
    assert 0.0 <= got_x.min() and got_x.max() <= 1.0


def test_square_draws_are_in_range_and_seeded():
    sides = square.square_schedule(30, 16, 12)
    a = square.draw_square(30, 5, 16, 12, 3, sides, generator_from_seed(3), "cpu")
    b = square.draw_square(30, 5, 16, 12, 3, sides, generator_from_seed(3), "cpu")
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    stripes, r0, c0, signs = a
    assert set(stripes.unique().tolist()) <= {-1.0, 1.0} and stripes.shape == (5, 1, 12, 3)
    assert set(signs.unique().tolist()) == {-1.0, 1.0} and signs.shape == (30, 5, 3)
    side = torch.from_numpy(sides.astype(np.int64))[:, None]
    assert (r0 >= 0).all() and (r0 <= 16 - side).all() and (c0 <= 12 - side).all()
    # every corner of the first square's range is reachable
    many = square.draw_square(1, 4000, 16, 12, 3, sides[:1], generator_from_seed(1), "cpu")
    assert many[1].unique().numel() == 16 - int(sides[0]) + 1
