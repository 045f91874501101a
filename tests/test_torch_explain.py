"""Grad-CAM in the port (eval/explain.py) against the JAX package's on the
CPU.

Both packages compute the CAM from float32 features and float32 gradients
(their feature closures cast to float32), so on the same float64 weights
(resnet_tiny, bridged) the CAMs agree within 1e-5 (float32 sums in another
order, on maps normalized to [0, 1]); the bilinear upsampling within 1e-12
in float64; ``cam_shift_iou`` of the same maps exactly, and end to end
within 1e-3 (a pixel at a region's threshold may fall on either side).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import module_time_limit, one_thread, time_limit  # noqa: F401 (autouse)
from _torch_port_helpers import flax_resnet, port_resnet
from image_recognition_adversarial_example_attack_tpu.core.constants import (
    IMAGENET_MEAN, IMAGENET_STD)
from image_recognition_adversarial_example_attack_tpu.eval import explain as jax_explain
from image_recognition_adversarial_example_attack_tpu_torch.core.normalize import (
    normalize_batch as port_normalize)
from image_recognition_adversarial_example_attack_tpu_torch.eval import explain
from image_recognition_adversarial_example_attack_tpu_torch.models.vgg import vgg_tiny

CAM_TOL = 1e-5
RESIZE_TOL = 1e-12
SIZE = 128  # resnet_tiny's last map is 4x4 at 128x128


@pytest.fixture(scope="module")
def setup():
    with jax.enable_x64():
        module, variables = flax_resnet("resnet_tiny", np.float64, num_classes=10, seed=2)
    model = port_resnet("resnet_tiny", variables, np.float64, num_classes=10)
    x = np.random.RandomState(4).uniform(0, 1, (3, SIZE, SIZE, 3))
    # the predicted classes, as the CLI asks: their maps are not all zero
    with torch.no_grad():
        y = model(port_normalize(torch.from_numpy(x), IMAGENET_MEAN, IMAGENET_STD)
                  .permute(0, 3, 1, 2)).argmax(-1).numpy()
    return module, variables, model, x, y


def _jax_cam(module, variables, x, y):
    with jax.enable_x64():
        fn = jax_explain.make_gradcam_fn(module, variables, IMAGENET_MEAN, IMAGENET_STD)
        cam = jax.jit(fn)(jnp.asarray(x), jnp.asarray(y))
        up = jax.jit(lambda c: jax_explain.upsample_cam(c, SIZE, SIZE))(cam)
        return np.asarray(cam), np.asarray(up)


def test_cams_equal_jaxs(setup):
    module, variables, model, x, y = setup
    want, want_up = _jax_cam(module, variables, x, y)
    fn = explain.make_gradcam_fn(model, IMAGENET_MEAN, IMAGENET_STD)
    cam = fn(torch.from_numpy(x), torch.from_numpy(y))
    assert cam.dtype == torch.float32 and cam.shape == (3, 4, 4)
    np.testing.assert_allclose(cam.numpy(), want, rtol=0, atol=CAM_TOL)
    assert float(cam.min()) >= 0.0 and np.allclose(cam.amax(dim=(1, 2)).numpy(), 1.0)
    up = explain.upsample_cam(cam, SIZE, SIZE)
    np.testing.assert_allclose(up.numpy(), want_up, rtol=0, atol=CAM_TOL)
    # the IoU of a clean and a shifted map, end to end
    cam_b = fn(torch.from_numpy(x[::-1].copy()), torch.from_numpy(y))
    with jax.enable_x64():
        _, want_b = _jax_cam(module, variables, x[::-1].copy(), y)
        want_iou = np.asarray(jax_explain.cam_shift_iou(jnp.asarray(want_up), jnp.asarray(want_b)))
    got_iou = explain.cam_shift_iou(up, explain.upsample_cam(cam_b, SIZE, SIZE)).numpy()
    np.testing.assert_allclose(got_iou, want_iou, rtol=0, atol=1e-3)


def test_no_graph_reaches_the_body(setup):
    """The gradient runs through the head alone: the parameters keep no
    gradient and the features' map is detached."""
    _, _, model, x, y = setup
    explain.make_gradcam_fn(model, IMAGENET_MEAN, IMAGENET_STD)(
        torch.from_numpy(x[:1]), torch.from_numpy(y[:1]))
    assert all(p.grad is None for p in model.parameters())


@pytest.mark.parametrize("h,w,size", [(7, 7, 224), (4, 4, 128), (3, 5, 32), (2, 2, 5), (6, 6, 6)])
def test_upsample_equals_jax_resize_at_the_borders_too(h, w, size):
    """jax.image.resize drops the kernel weight that falls outside the map
    and renormalizes; F.interpolate clamps the source index to the edge.
    Both put all the weight on the edge pixel there: equal."""
    cam = np.random.RandomState(h * w).rand(2, h, w)
    with jax.enable_x64():
        want = np.asarray(jax_explain.upsample_cam(jnp.asarray(cam), size, size))
    got = explain.upsample_cam(torch.from_numpy(cam), size, size).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=RESIZE_TOL)
    if size >= 2 * h:  # the first output rows lie left of pixel 0's center
        np.testing.assert_allclose(got[:, 0, 0], cam[:, 0, 0], rtol=0, atol=RESIZE_TOL)
        np.testing.assert_allclose(got[:, -1, -1], cam[:, -1, -1], rtol=0, atol=RESIZE_TOL)


@pytest.mark.parametrize("case", ["random", "sparse", "constant", "identical"])
def test_cam_shift_iou_equals_jaxs(case):
    rs = np.random.RandomState(1)
    a, b = rs.rand(3, 16, 16).astype(np.float32), rs.rand(3, 16, 16).astype(np.float32)
    if case == "sparse":  # the quantile lands on the zero plateau: strict > keeps the spot
        a[:] = 0.0
        a[:, 3:5, 3:5] = 1.0
        b = np.roll(a, 1, axis=2)
    elif case == "constant":
        a[:], b[:] = 0.5, 0.0
    elif case == "identical":
        b = a.copy()
    want = np.asarray(jax_explain.cam_shift_iou(jnp.asarray(a), jnp.asarray(b)))
    got = explain.cam_shift_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32
    if case in ("constant", "identical"):
        np.testing.assert_array_equal(got, 1.0)


def test_a_model_without_the_split_raises():
    with pytest.raises(ValueError, match="exposes no features_last/head_from_features split"):
        explain.make_gradcam_fn(vgg_tiny(), IMAGENET_MEAN, IMAGENET_STD)
