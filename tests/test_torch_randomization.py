"""The randomization defense of the port (defenses/randomization.py) against
the JAX package's on the CPU.

JAX resamples with ``jax.image.scale_and_translate(method="linear")``,
which antialiases when it shrinks; the port builds the same per-sample
weight matrices.  Tolerances, at scales 0.7-1.0 and off-integer offsets:

- float64: the image and its input gradient within 1e-12 of JAX's, jitted;
- float32: within 1e-6 of JAX's run op by op.  Jitted, XLA's CPU compiler
  rewrites the weight arithmetic (reassociation and reciprocals), which
  moves its float32 result by up to 1.4e-6 from the op-by-op one, as far
  as either is from the float64 result; the port matches the op-by-op
  function within 1e-7 (checked below against ``F64_GAP``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_blackbox_helpers import feed, run_jax, t
from _torch_port_helpers import module_time_limit, one_thread, time_limit  # noqa: F401 (autouse)
from image_recognition_adversarial_example_attack_tpu.defenses import randomization as jax_rand
from image_recognition_adversarial_example_attack_tpu_torch.attacks import eot
from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed
from image_recognition_adversarial_example_attack_tpu_torch.defenses import randomization

TOL64, TOL32 = 1e-12, 1e-6
# how far a float32 resize_pad may sit from the float64 one (either package)
F64_GAP = 5e-6


def _case(seed: int, dtype, h: int = 20, w: int = 24):
    rs = np.random.RandomState(seed)
    x = rs.rand(4, h, w, 3).astype(dtype)
    s = np.array([0.7, 0.85, 1.0, 0.931]).astype(dtype)
    oy = (rs.rand(4) * (1 - s) * h + 0.137).astype(dtype)
    ox = (rs.rand(4) * (1 - s) * w + 0.291).astype(dtype)
    wgt = rs.randn(4, h, w, 3).astype(dtype)
    return x, s, oy, ox, wgt


def _port(x, s, oy, ox, wgt):
    xt = t(x).requires_grad_(True)
    out = randomization.resize_pad(xt, t(s), t(oy), t(ox))
    (out * t(wgt)).sum().backward()
    return out.detach().numpy(), xt.grad.numpy()


def _jax(x, s, oy, ox, wgt):
    out = jax_rand.resize_pad(x, s, oy, ox)
    return out, jax.grad(lambda a: jnp.sum(jax_rand.resize_pad(a, s, oy, ox) * wgt))(x)


@pytest.mark.parametrize("seed,size", [(0, (20, 24)), (1, (32, 32)), (2, (17, 9))])
def test_resize_pad_and_its_gradient_equal_jaxs_in_float64(seed, size):
    args = _case(seed, np.float64, *size)
    want, want_grad = run_jax(_jax, *args)
    got, got_grad = _port(*args)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL64)
    np.testing.assert_allclose(got_grad, want_grad, rtol=0, atol=TOL64)


@pytest.mark.parametrize("seed,size", [(0, (20, 24)), (1, (32, 32))])
def test_resize_pad_and_its_gradient_equal_jaxs_in_float32(seed, size):
    args = _case(seed, np.float32, *size)
    want, want_grad = (np.asarray(a) for a in _jax(*map(jnp.asarray, args)))
    got, got_grad = _port(*args)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL32)
    np.testing.assert_allclose(got_grad, want_grad, rtol=0, atol=TOL32 * np.abs(want_grad).max())
    # both within the float32 gap of the float64 result (jitted JAX too)
    exact, _ = _port(*(a.astype(np.float64) for a in args))
    jitted = np.asarray(jax.jit(jax_rand.resize_pad)(*map(jnp.asarray, args[:4])))
    assert np.abs(got - exact).max() < F64_GAP and np.abs(jitted - exact).max() < F64_GAP


def test_the_weights_are_antialiased_and_normalized():
    s = torch.tensor([0.5, 1.0, 0.8], dtype=torch.float64)
    ty = torch.tensor([3.0, 0.0, 1.7], dtype=torch.float64)
    wm = randomization.weight_matrix(12, 12, s, ty)  # [B, out, in]
    sums = wm.sum(dim=2)
    # each output's weights sum to 1 inside the shrunk image, 0 outside it
    assert torch.all(((sums - 1).abs() < 1e-12) | (sums == 0))
    # scale 1, offset 0 is the identity
    assert torch.equal(wm[1], torch.eye(12, dtype=torch.float64))
    # at scale 0.5 the triangle is two pixels wide: four inputs per output
    assert int((wm[0][6] > 0).sum()) == 4
    # the padded canvas reads the pad value
    x = torch.rand(3, 12, 12, 3, dtype=torch.float64, generator=generator_from_seed(0))
    out = randomization.resize_pad(x, s, ty, torch.zeros(3, dtype=torch.float64), pad_value=0.25)
    assert torch.all(out[0, :3] == 0.25) and torch.all(out[0, 9:] == 0.25)


def test_random_resize_pad_equals_jaxs_on_its_draws(monkeypatch):
    """JAX's scale and offset draws fed through ``draw_geometry``."""
    x = np.random.RandomState(4).rand(3, 24, 24, 3)
    key = jax.random.PRNGKey(9)
    with jax.enable_x64():
        ks, ky, kx = jax.random.split(key, 3)
        scales = jax.random.uniform(ks, (3,), jnp.float64, minval=0.857, maxval=1.0)
        uy = jax.random.uniform(ky, (3,), jnp.float64)
        ux = jax.random.uniform(kx, (3,), jnp.float64)
    monkeypatch.setattr(randomization, "draw_geometry",
                        feed([(t(scales), t(uy), t(ux))]))
    want = run_jax(lambda xx: jax_rand.random_resize_pad(xx, key), x)
    got = randomization.resize_pad_transform()(generator_from_seed(0), t(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL64)


def test_draw_geometry_lands_the_image_on_the_canvas():
    scales, uy, ux = randomization.draw_geometry(5000, 0.857, generator_from_seed(3), "cpu")
    assert float(scales.min()) >= 0.857 and float(scales.max()) < 1.0
    assert float(uy.min()) >= 0.0 and float(ux.max()) < 1.0
    assert abs(float(scales.mean()) - (0.857 + 1) / 2) < 0.005


def test_eot_through_the_defense_is_differentiable():
    """The adaptive attack: the EOT wrapper over the defense, one [n*B]
    forward, a finite input gradient (no BPDA)."""
    x = torch.rand(2, 16, 16, 3, dtype=torch.float64, generator=generator_from_seed(1))
    weight = torch.randn(3, 5, dtype=torch.float64, generator=generator_from_seed(2))
    sizes = []

    def lf(z):
        sizes.append(z.shape[0])
        return z.mean(dim=(1, 2)) @ weight

    fn = eot.make_eot_logits_fn(lf, generator_from_seed(0), n_samples=8,
                                transform=randomization.resize_pad_transform())
    xg = x.clone().requires_grad_(True)
    out = fn(xg)
    out.sum().backward()
    assert out.shape == (2, 5) and sizes == [16]
    assert torch.isfinite(xg.grad).all() and float(xg.grad.abs().max()) > 0
    # the same input draws the same geometry
    np.testing.assert_array_equal(fn(x).detach().numpy(), out.detach().numpy())
