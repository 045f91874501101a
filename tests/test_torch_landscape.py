"""The loss landscape in the port (eval/landscape.py) against the JAX
package's on the CPU.

Given the normal draw ``jax.random.normal`` gives for a key, the port's
plane construction equals ``adversarial_plane``'s within 1e-6 (float32
norms summed in another order), the degenerate ``x_adv == x`` plane
included.  On the same plane and the same float64 weights (resnet_tiny,
bridged), the [grid, grid] losses agree within 1e-5 relative: both logits
closures return float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import module_time_limit, one_thread, time_limit  # noqa: F401 (autouse)
from _torch_port_helpers import flax_resnet, port_resnet
from image_recognition_adversarial_example_attack_tpu.attacks import api as jax_api
from image_recognition_adversarial_example_attack_tpu.core.constants import (
    IMAGENET_MEAN, IMAGENET_STD)
from image_recognition_adversarial_example_attack_tpu.eval import landscape as jax_landscape
from image_recognition_adversarial_example_attack_tpu_torch.attacks.api import make_logits_fn
from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed
from image_recognition_adversarial_example_attack_tpu_torch.eval import landscape

PLANE_TOL = 1e-6
LOSS_RTOL = 1e-5


def _pair(seed, same=False):
    rs = np.random.RandomState(seed)
    x = rs.uniform(0.1, 0.9, (32, 32, 3)).astype(np.float32)
    x_adv = x if same else np.clip(x + rs.uniform(-8 / 255, 8 / 255, x.shape), 0, 1)
    return x, x_adv.astype(np.float32)


@pytest.mark.parametrize("same", [False, True])
def test_plane_equals_jaxs_on_jaxs_draw(same):
    x, x_adv = _pair(3, same)
    key = jax.random.PRNGKey(5)
    want = jax_landscape.adversarial_plane(jnp.asarray(x), jnp.asarray(x_adv), key)
    r = np.asarray(jax.random.normal(key, x.shape, jnp.float32))
    got = landscape.plane_from_direction(torch.from_numpy(x), torch.from_numpy(x_adv),
                                         torch.from_numpy(r))
    for name in ("d1", "d2", "scale"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=0, atol=PLANE_TOL, err_msg=name)
    d1, d2 = got.d1.double(), got.d2.double()
    assert abs(float((d1 * d2).sum())) < 1e-6 and abs(float(d2.norm()) - 1) < 1e-6
    if same:
        assert float(d1.abs().max()) == 0.0 and float(got.scale) == 1.0
    else:
        # coordinate (1, 0) is the adversarial example
        np.testing.assert_allclose((got.d1 * got.scale).numpy(), x_adv - x, rtol=0, atol=1e-7)


def test_the_draw_comes_from_the_generator():
    x, x_adv = _pair(1)
    a = landscape.adversarial_plane(torch.from_numpy(x), torch.from_numpy(x_adv),
                                    generator_from_seed(4))
    b = landscape.adversarial_plane(torch.from_numpy(x), torch.from_numpy(x_adv),
                                    generator_from_seed(4))
    c = landscape.adversarial_plane(torch.from_numpy(x), torch.from_numpy(x_adv),
                                    generator_from_seed(5))
    assert torch.equal(a.d2, b.d2) and not torch.equal(a.d2, c.d2)
    assert torch.equal(a.d1, c.d1)


@pytest.fixture(scope="module")
def models():
    with jax.enable_x64():
        module, variables = flax_resnet("resnet_tiny", np.float64, num_classes=10, seed=6)
        lf_jax = jax_api.make_logits_fn(module, variables, IMAGENET_MEAN, IMAGENET_STD)
    model = port_resnet("resnet_tiny", variables, np.float64, num_classes=10)
    return lf_jax, make_logits_fn(model, IMAGENET_MEAN, IMAGENET_STD)


@pytest.mark.parametrize("grid,span,same", [(5, 1.5, False), (4, 2.0, False), (3, 1.5, True)])
def test_loss_landscape_equals_jaxs(models, grid, span, same):
    lf_jax, lf_port = models
    x, x_adv = _pair(2, same)
    x, x_adv = x.astype(np.float64), x_adv.astype(np.float64)
    key = jax.random.PRNGKey(1)
    y = 3
    with jax.enable_x64():
        plane = jax_landscape.adversarial_plane(jnp.asarray(x), jnp.asarray(x_adv), key)
        want = np.asarray(jax.jit(lambda xx: jax_landscape.loss_landscape(
            lf_jax, xx, jnp.asarray(y), plane, span=span, grid=grid))(jnp.asarray(x)))
    port_plane = landscape.Plane(*(torch.from_numpy(np.asarray(v)) for v in plane))
    got = landscape.loss_landscape(lf_port, torch.from_numpy(x), y, port_plane, span=span,
                                   grid=grid)
    assert got.dtype == torch.float32 and got.shape == (grid, grid)
    np.testing.assert_allclose(got.numpy(), want, rtol=LOSS_RTOL, atol=0)
    if grid % 2:  # the center is the clean input's cross-entropy
        with torch.no_grad():
            clean = -torch.log_softmax(lf_port(torch.from_numpy(x)[None]), -1)[0, y]
        np.testing.assert_allclose(float(got[grid // 2, grid // 2]), float(clean), rtol=1e-6)
