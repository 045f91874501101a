"""The port's ResNet, zoo and weight bridge against the JAX package (CPU).

resnet_tiny runs in float64 on both sides, so agreement is to 1e-9;
ResNet-50 runs in float32 on one 64x64 image, where the two frameworks sum
convolutions in another order: relative 1e-4 of the largest logit.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import module_time_limit, one_thread, time_limit  # noqa: F401 (autouse)
from _torch_port_helpers import _perturb as port_perturb
from _torch_port_helpers import flax_resnet, port_resnet, torchvision_resnet50_keys
from _torch_scaleout_helpers import seeded_variables
from image_recognition_adversarial_example_attack_tpu.core.constants import (
    IMAGENET_MEAN, IMAGENET_STD)
from image_recognition_adversarial_example_attack_tpu.models import resnet as jax_resnet
from image_recognition_adversarial_example_attack_tpu_torch.models import (
    from_jax_variables, load_model, resnet50, resnet_tiny, zoo)
from image_recognition_adversarial_example_attack_tpu_torch.models.convert import (
    strip_prefixes, torch_module_path)


@pytest.fixture(autouse=True)
def _x64():
    with jax.enable_x64():
        yield


@pytest.fixture(scope="module")
def tiny64():
    with jax.enable_x64():
        return flax_resnet("resnet_tiny", np.float64, num_classes=10)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


# The Flax methods cast their result to float32; these are the same methods
# without that cast, so the float64 internals are compared at 1e-9.
_UNCAST = {
    "__call__": lambda m, x: m.fc(jnp.mean(m._run_stages(m.stem(x), 4), axis=(1, 2))),
    "features_stage3": lambda m, x: m._run_stages(m.stem(x), 3),
    "features_last": lambda m, x: m._run_stages(m.stem(x), 4),
}


@pytest.mark.parametrize("method", ["__call__", "features_stage3", "features_last"])
def test_resnet_tiny_through_the_bridge_float64(tiny64, method):
    module, variables = tiny64
    model = port_resnet("resnet_tiny", variables, np.float64, num_classes=10)
    x = np.random.RandomState(1).randn(3, 32, 32, 3)
    fn = model if method == "__call__" else getattr(model, method)
    got = fn(_nchw(x)).numpy()
    if got.ndim == 4:
        got = got.transpose(0, 2, 3, 1)
    want = np.asarray(module.apply(variables, jnp.asarray(x), method=_UNCAST[method]))
    assert got.shape == want.shape and want.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    # the public method rounds to float32: one float32 ulp at most
    kw = {} if method == "__call__" else {"method": getattr(type(module), method)}
    want32 = np.asarray(module.apply(variables, jnp.asarray(x), **kw))
    np.testing.assert_allclose(got.astype(np.float32), want32, rtol=1.2e-7, atol=0)


def test_head_from_features_splits_the_forward(tiny64):
    _, variables = tiny64
    model = port_resnet("resnet_tiny", variables, np.float64, num_classes=10)
    x = _nchw(np.random.RandomState(2).randn(2, 32, 32, 3))
    torch.testing.assert_close(model.head_from_features(model.features_last(x)),
                               model(x), rtol=0, atol=0)


def test_resnet50_through_the_bridge_float32():
    """On the port's seeded init through the converter (a Flax ResNet-50
    ``init`` takes 12 s to compile)."""
    module = jax_resnet.resnet50(dtype=jnp.float32)
    variables = jax.tree_util.tree_map(lambda a: a.astype(np.float32), seeded_variables(
        resnet50(), "resnet", port_perturb, seed=0))
    sd = from_jax_variables(variables, "resnet")
    assert set(sd) == torchvision_resnet50_keys() and len(sd) == 320
    model = port_resnet("resnet50", variables, np.float32)
    assert set(model.state_dict()) == torchvision_resnet50_keys()
    x = np.random.RandomState(3).rand(1, 64, 64, 3).astype(np.float32)
    xn = (x - IMAGENET_MEAN) / IMAGENET_STD
    want = np.asarray(jax.jit(module.apply)(variables, jnp.asarray(xn)))  # weights as arguments
    got = model(_nchw(xn)).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)


def test_bridge_renames_and_raises_on_unmapped_keys():
    assert torch_module_path(("layer1_0", "downsample_conv")) == "layer1.0.downsample.0"
    assert torch_module_path(("layer4_2", "downsample_bn")) == "layer4.2.downsample.1"
    assert torch_module_path(("layer3_5", "bn2")) == "layer3.5.bn2"
    with pytest.raises(ValueError, match="unmapped"):
        from_jax_variables({"params": {"fc": {"weird": np.zeros(3)}}}, "resnet")
    with pytest.raises(ValueError, match="unmapped"):
        from_jax_variables({"params": {}, "cache": {}}, "resnet")
    with pytest.raises(ValueError, match="unmapped"):
        from_jax_variables({"batch_stats": {"bn1": {"count": np.zeros(3)}}}, "resnet")


def test_bridge_layouts(tiny64):
    _, variables = tiny64
    sd = from_jax_variables(variables, "resnet")
    k = variables["params"]["layer2_0"]["downsample_conv"]["kernel"]  # HWIO
    np.testing.assert_array_equal(sd["layer2.0.downsample.0.weight"].numpy(),
                                  k.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["fc.weight"].numpy(),
                                  variables["params"]["fc"]["kernel"].T)
    np.testing.assert_array_equal(sd["bn1.running_var"].numpy(),
                                  variables["batch_stats"]["bn1"]["var"])
    np.testing.assert_array_equal(sd["layer1.0.bn3.weight"].numpy(),
                                  variables["params"]["layer1_0"]["bn3"]["scale"])


def test_zoo_loads_a_pth_with_wrapper_prefixes(tmp_path, tiny64, monkeypatch):
    _, variables = tiny64
    sd = {f"module.{k}": v.float() if v.is_floating_point() else v
          for k, v in from_jax_variables(variables, "resnet").items()}
    path = tmp_path / "tiny.pth"
    torch.save(sd, path)
    monkeypatch.setenv("ADV_TPU_WEIGHTS_DIR", str(tmp_path))  # where the cache goes
    b = load_model("resnet_tiny", weights=path, device="cpu")
    assert b.source == "converted" and b.device.type == "cpu"
    assert (tmp_path / "resnet_tiny.msgpack").is_file()
    want = strip_prefixes(sd)
    got = b.model.state_dict()
    assert set(got) == set(want)
    torch.testing.assert_close(got["layer3.0.conv2.weight"], want["layer3.0.conv2.weight"])
    assert all(not p.requires_grad for p in b.model.parameters())


def test_zoo_random_init_is_seeded_and_frozen(monkeypatch, tmp_path):
    monkeypatch.setenv("ADV_TPU_WEIGHTS_DIR", str(tmp_path))
    with pytest.warns(UserWarning, match="random init"):
        a = load_model("resnet_tiny", device="cpu")
    torch.manual_seed(123)  # the global generator does not reach the init
    with pytest.warns(UserWarning):
        b = load_model("resnet_tiny", device="cpu")
    assert a.source == "random"
    sa, sb = (m.model.state_dict() for m in (a, b))
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    # the init seed is the constant INIT_SEED, as the JAX zoo's PRNGKey(0)
    assert zoo.INIT_SEED == 0
    g = torch.Generator().manual_seed(zoo.INIT_SEED)
    want = torch.empty(8, 3, 7, 7).normal_(0.0, math.sqrt(1.0 / (3 * 7 * 7)), generator=g)
    assert torch.equal(sa["conv1.weight"], want)
    assert all(not p.requires_grad for p in a.model.parameters())
    # Flax's default init distributions: unit BN scale/var, LeCun-normal kernels
    assert torch.equal(sa["bn1.running_var"], torch.ones(8))
    std = float(sa["layer4.0.conv2.weight"].std())
    assert abs(std - (1 / (9 * 64)) ** 0.5) < 0.1 * std


def test_zoo_bfloat16_keeps_batchnorm_in_float32():
    b = load_model("resnet_tiny", dtype=torch.bfloat16, device="cpu")
    assert b.model.conv1.weight.dtype == torch.bfloat16
    assert b.model.fc.weight.dtype == torch.bfloat16
    assert b.model.bn1.running_var.dtype == torch.float32
    assert b.model.conv1.weight.is_contiguous(memory_format=torch.channels_last)


def test_zoo_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_model("resnet_tiny")
    with pytest.raises(ValueError, match="unknown model"):
        load_model("mobilenet_v3", device="cpu")  # not a registered name


def test_batchnorm_ignores_train_mode(tiny64):
    _, variables = tiny64
    model = port_resnet("resnet_tiny", variables, np.float64, num_classes=10)
    x = _nchw(np.random.RandomState(4).randn(2, 32, 32, 3))
    want = model(x)
    model.train()
    torch.testing.assert_close(model(x), want, rtol=0, atol=0)
    assert torch.equal(model.bn1.num_batches_tracked, torch.tensor(0))


@pytest.mark.parametrize("factory,n_params", [(resnet50, 25_557_032), (resnet_tiny, None)])
def test_model_structure(factory, n_params):
    model = factory()
    if n_params is not None:  # torchvision's resnet50 parameter count
        assert sum(p.numel() for p in model.parameters()) == n_params
    assert model.conv1.padding == (3, 3) and model.maxpool.padding == 1
    assert model.layer2[0].conv2.stride == (2, 2) and model.layer2[0].conv1.stride == (1, 1)
    assert model.layer1[0].conv1.padding == (0, 0) and model.layer1[0].conv2.padding == (1, 1)
