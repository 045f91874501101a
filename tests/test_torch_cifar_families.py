"""The CIFAR family (models/wideresnet.py, preactresnet.py) and the
lightweight ImageNet families (models/mobilenet.py, efficientnet.py,
convnext.py) in the port, their weight bridge (models/convert.py) and the
zoo's entries, against the JAX package on the CPU.

The tiny variants (``wrn_tiny``, a PreActResNet with one block per stage,
``mobilenet_tiny``, ``efficientnet_tiny``, ``convnext_micro``) run in
float64 with the JAX variables carried across by ``from_jax_variables``:
logits, cross-entropy input gradients and the taps agree within
``TOL = 1e-10`` (absolute; the logits are of order 1).  The JAX models cast
their outputs to float32, so the references are the uncast outputs of the
modules that produce them (``capture_intermediates``).  Flax's LayerNorm
takes the variance as E[x^2] - E[x]^2 and torch's in two passes: in float64
the two agree far inside the tolerance.

With ``int8=True`` the tiny variants equal the JAX families' int8 forward
within ``test_torch_int8_models.MODEL_TOL``, and quantize exactly the layers
the JAX families hook: the hooked kernels, traced through the JAX package's
``int8_conv_general_dilated`` / ``int8_dot_general``, have the shapes of the
port's ``QuantConv2d`` / ``QuantLinear`` weights, at full width too.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cli_helpers import one_thread  # noqa: F401 (autouse)
from image_recognition_adversarial_example_attack_tpu.core.constants import (
    CIFAR10_MEAN, CIFAR10_STD)
from image_recognition_adversarial_example_attack_tpu.core.normalize import (
    normalize_batch as jax_normalize)
from image_recognition_adversarial_example_attack_tpu.models import convert as jax_convert
from image_recognition_adversarial_example_attack_tpu.models import zoo as jax_zoo
from image_recognition_adversarial_example_attack_tpu.ops import int8 as jax_int8
from image_recognition_adversarial_example_attack_tpu_torch.core.normalize import (
    normalize_batch as port_normalize)
from image_recognition_adversarial_example_attack_tpu_torch.defenses.detector import (
    make_features_fn)
from image_recognition_adversarial_example_attack_tpu_torch.eval.explain import make_gradcam_fn
from image_recognition_adversarial_example_attack_tpu_torch.models import zoo
from image_recognition_adversarial_example_attack_tpu_torch.models.convert import (
    from_jax_variables, load_torch_checkpoint, to_jax_variables)
from image_recognition_adversarial_example_attack_tpu_torch.models.flax_msgpack import (
    save_variables)
from image_recognition_adversarial_example_attack_tpu_torch.ops import int8

TOL = 1e-10
MODEL_TOL = 1e-9  # tests/test_torch_int8_models.py's
EXACT_DIVISION = {"xla_disable_hlo_passes": "algsimp"}
# test variant -> (family, the head whose output is the uncast logits)
VARIANTS = {
    "wrn_tiny": ("wideresnet", "fc"),
    "preact_tiny": ("preactresnet", "linear"),
    "mobilenet_tiny": ("mobilenet", "classifier"),
    "efficientnet_tiny": ("efficientnet", "classifier"),
    "convnext_micro": ("convnext", "classifier"),
}
# the module whose output is features_stage3's, uncast
STAGE3 = {"wrn_tiny": "block2_0", "preact_tiny": "layer3_0", "convnext_micro": "stage2_1"}
# the registered names of this slice, their families
NEW = {"efficientnet_b0": "efficientnet", "mobilenet_v2": "mobilenet",
       "convnext_tiny": "convnext", "wrn28_10": "wideresnet", "wrn34_10": "wideresnet",
       "wrn_tiny": "wideresnet", "preact_resnet18": "preactresnet",
       "wrn28_10_robust": "wideresnet"}


def _module(package, name):
    return importlib.import_module(f"{package}.models.{VARIANTS[name][0]}")


def _jax_module(name, dtype=jnp.float64, int8_on=False):
    mod = _module("image_recognition_adversarial_example_attack_tpu", name)
    if name == "preact_tiny":
        return mod.PreActResNet(stage_sizes=(1, 1, 1, 1), dtype=dtype, int8=int8_on)
    return getattr(mod, name)(dtype=dtype, int8=int8_on)


def _port_model(name, int8_on=False):
    mod = _module("image_recognition_adversarial_example_attack_tpu_torch", name)
    if name == "preact_tiny":
        return mod.PreActResNet(stage_sizes=(1, 1, 1, 1), int8=int8_on)
    return getattr(mod, name)(int8=int8_on)


def _perturb(tree, rng):
    """Every normalization statistic, affine parameter and layer scale moved
    off its init, so that none is an identity (and ConvNeXt's residual
    branches reach the logits)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng)
            continue
        v = np.asarray(v, np.float64)
        if k == "var":
            v = rng.uniform(0.5, 1.5, v.shape)
        elif k in ("scale", "layer_scale"):
            v = rng.uniform(0.7, 1.3, v.shape)
        elif k in ("mean", "bias"):
            v = v + rng.randn(*v.shape) * 0.1
        out[k] = v
    return out


@functools.lru_cache(maxsize=None)
def _variables(name):
    """The float64 variables of a tiny variant (int8 mode has the same
    tree), perturbed."""
    with jax.enable_x64():
        module = _jax_module(name)
        variables = jax.jit(module.init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
        return _perturb(jax.tree_util.tree_map(np.asarray, variables), np.random.RandomState(3))


def _setup(name, int8_on=False):
    """(Flax module in float64, its variables, the port's float64 model
    with them, in eval mode)."""
    variables = _variables(name)
    model = _port_model(name, int8_on).double()
    model.load_state_dict(from_jax_variables(variables, VARIANTS[name][0]), strict=True)
    return _jax_module(name, int8_on=int8_on), variables, model.requires_grad_(False).eval()


@pytest.fixture(scope="module", params=list(VARIANTS))
def pair(request):
    """(name, Flax module in float64, float64 variables, port model with
    them, x [3, 32, 32, 3], labels)."""
    name = request.param
    module, variables, model = _setup(name)
    rng = np.random.RandomState(0)
    return name, module, variables, model, rng.uniform(0, 1, (3, 32, 32, 3)), np.array([1, 4, 7])


def _captured(module, variables, x01, tap, method=None):
    """The uncast output of submodule ``tap`` in ``module.apply``."""
    _, state = module.apply(variables, jax_normalize(x01, CIFAR10_MEAN, CIFAR10_STD),
                            method=method,
                            capture_intermediates=lambda mdl, _: mdl.name == tap)
    return state["intermediates"][tap]["__call__"][0]


def _nchw(x01):
    return port_normalize(x01, CIFAR10_MEAN, CIFAR10_STD).permute(0, 3, 1, 2)


def _ce(logits, y):
    return -jnp.take_along_axis(jax.nn.log_softmax(logits), y[:, None], 1).sum()


def test_logits_and_input_gradients_equal_jaxs(pair):
    name, module, variables, model, x, y = pair
    head = VARIANTS[name][1]
    with jax.enable_x64():
        xj = jnp.asarray(x)
        want = np.asarray(jax.jit(lambda v: _captured(module, variables, v, head))(xj))
        want_g = np.asarray(jax.jit(jax.grad(
            lambda v: _ce(_captured(module, variables, v, head), jnp.asarray(y))))(xj))
    assert want.dtype == np.float64 and want.shape == (3, 10)
    xt = torch.from_numpy(x).requires_grad_(True)
    logits = model(_nchw(xt))
    loss = -torch.log_softmax(logits, -1).gather(-1, torch.from_numpy(y)[:, None]).sum()
    (grad,) = torch.autograd.grad(loss, xt)
    np.testing.assert_allclose(logits.detach().numpy(), want, rtol=0, atol=TOL)
    np.testing.assert_allclose(grad.numpy(), want_g, rtol=0, atol=TOL)
    assert np.abs(want_g).max() > 1e-4  # the gradient reaches the input


@pytest.mark.parametrize("name", list(STAGE3))
def test_features_stage3_equals_jaxs(name):
    module, variables, model = _setup(name)
    x = np.random.RandomState(1).uniform(0, 1, (2, 32, 32, 3))
    with jax.enable_x64():
        want = np.asarray(jax.jit(lambda v: _captured(
            module, variables, v, STAGE3[name], method=module.features_stage3))(jnp.asarray(x)))
    with torch.no_grad():
        got = model.features_stage3(_nchw(torch.from_numpy(x))).permute(0, 2, 3, 1)
    assert got.shape == want.shape and want.dtype == np.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    # the detector's features are the same map, NHWC float32
    feats = make_features_fn(model.float(), CIFAR10_MEAN, CIFAR10_STD)(
        torch.from_numpy(x.astype(np.float32)))
    assert feats.dtype == torch.float32 and tuple(feats.shape) == want.shape


@pytest.mark.parametrize("name", ["wrn_tiny", "preact_tiny"])
def test_features_last_and_head_equal_jaxs(name):
    """``features_last`` is relu of the final BatchNorm's output;
    ``head_from_features`` of it gives the logits, as in the JAX model."""
    module, variables, model = _setup(name)
    bn, head = ("bn1", "fc") if name == "wrn_tiny" else ("bn", "linear")
    x = np.random.RandomState(2).uniform(0, 1, (2, 32, 32, 3))
    with jax.enable_x64():
        want = np.maximum(np.asarray(jax.jit(lambda v: _captured(
            module, variables, v, bn, method=module.features_last))(jnp.asarray(x))), 0.0)

        def head_fn(feats):
            _, state = module.apply(variables, feats, method=module.head_from_features,
                                    capture_intermediates=lambda mdl, _: mdl.name == head)
            return state["intermediates"][head]["__call__"][0]

        want_logits = np.asarray(jax.jit(head_fn)(jnp.asarray(want)))
    with torch.no_grad():
        got = model.features_last(_nchw(torch.from_numpy(x)))
        logits = model.head_from_features(got)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=TOL)
    np.testing.assert_allclose(logits.numpy(), want_logits, rtol=0, atol=TOL)
    # Grad-CAM takes the split; the other families refuse it, as in JAX
    cam = make_gradcam_fn(model.float(), CIFAR10_MEAN, CIFAR10_STD)(
        torch.from_numpy(x.astype(np.float32)), torch.tensor([1, 2]))
    assert tuple(cam.shape) == want.shape[:3]


@pytest.mark.parametrize("name", ["mobilenet_tiny", "efficientnet_tiny", "convnext_micro"])
def test_gradcam_refused_and_detector_on_logits_without_the_taps(name):
    from image_recognition_adversarial_example_attack_tpu.eval import explain as jax_explain

    model = zoo.random_init_(_port_model(name)).eval()
    module = _jax_module(name, jnp.float32)
    with pytest.raises(ValueError) as theirs:
        jax_explain.make_gradcam_fn(module, {}, CIFAR10_MEAN, CIFAR10_STD)
    with pytest.raises(ValueError) as ours:
        make_gradcam_fn(model, CIFAR10_MEAN, CIFAR10_STD)
    assert str(ours.value) == str(theirs.value)
    feats = make_features_fn(model, CIFAR10_MEAN, CIFAR10_STD)(torch.rand(2, 32, 32, 3))
    want = (2, 4, 4, 16) if name == "convnext_micro" else (2, 10)  # stage-3 tap or logits
    assert tuple(feats.shape) == want


def _same_tree(a, b) -> bool:
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _same_tree(a[k], b[k]) for k in a)
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.array_equal(a, b)


def test_to_jax_variables_round_trip_is_exact(pair):
    name, _, variables, model, *_ = pair
    tree = to_jax_variables(model, VARIANTS[name][0])
    assert _same_tree(tree, variables)
    back = from_jax_variables(tree, VARIANTS[name][0])
    sd = model.state_dict()
    assert back.keys() == sd.keys() and all(torch.equal(back[k], sd[k]) for k in sd)


@pytest.mark.parametrize("name", ["wrn_tiny", "preact_tiny", "convnext_micro"])
def test_state_dict_through_the_jax_converter_gives_the_same_logits(name, tmp_path):
    """The port's state dict, read by the JAX package's ``convert_state_dict``
    with the family's rename, gives back the Flax tree and its logits; a
    ``.pth`` of it (``module.`` prefixed) loads strictly.  MobileNetV2's and
    EfficientNet's renames place the head at ``features.18`` / ``.8``, the
    full-width index: their keys are held at full width below."""
    _, variables, model = _setup(name)
    family = VARIANTS[name][0]
    rename = {"wideresnet": jax_convert.wideresnet_rename,
              "preactresnet": jax_convert.preactresnet_rename,
              "convnext": jax_convert.convnext_rename}[family]
    template = jax.tree_util.tree_map(lambda a: a.astype(np.float32), variables)
    converted = jax_convert.convert_state_dict(model.state_dict(), rename)
    jax_convert.assert_tree_shapes_match(converted, template)
    assert _same_tree(converted, template)
    apply = jax.jit(_jax_module(name, jnp.float32).apply)
    x = jnp.asarray(np.random.RandomState(0).uniform(0, 1, (2, 32, 32, 3)), jnp.float32)
    np.testing.assert_array_equal(np.asarray(apply(converted, x)),
                                  np.asarray(apply(template, x)))
    torch.save({f"module.{k}": v for k, v in model.state_dict().items()}, tmp_path / "w.pth")
    fresh = _port_model(name).double()
    fresh.load_state_dict(load_torch_checkpoint(tmp_path / "w.pth"), strict=True)
    assert all(torch.equal(a, b) for a, b in zip(fresh.state_dict().values(),
                                                 model.state_dict().values()))


def test_unknown_keys_raise(pair):
    name, _, variables, *_ = pair
    bad = {**variables, "params": {**variables["params"], "extra": {"kernel": np.zeros((2, 2))}}}
    with pytest.raises(RuntimeError, match="Unexpected key"):
        sd = from_jax_variables(bad, VARIANTS[name][0])
        _port_model(name).double().load_state_dict(sd, strict=True)


@functools.lru_cache(maxsize=None)
def _full_init_shapes(name):
    size = jax_zoo.model_meta(name)["input_size"]
    module = jax_zoo._REGISTRY[name](jnp.float32)
    return jax.eval_shape(module.init, jax.random.PRNGKey(0),
                          jax.ShapeDtypeStruct((1, size, size, 3), jnp.float32))


@pytest.mark.parametrize("name", list(NEW))
def test_full_width_shapes_match_the_jax_init(name):
    """The port's full-width model (on the meta device, no weights
    allocated) has exactly the tensors, in the shapes, that the JAX init's
    abstract shapes bridge to, at the input size of ``model_meta``."""
    shapes = _full_init_shapes(name)
    meta = jax.tree_util.tree_map(lambda s: torch.empty(s.shape, device="meta"), shapes)
    bridged = from_jax_variables(meta, NEW[name])
    with torch.device("meta"):
        model = zoo.build_model(name)
    sd = model.state_dict()
    assert bridged.keys() == sd.keys()
    assert {k: tuple(v.shape) for k, v in bridged.items()} == {
        k: tuple(v.shape) for k, v in sd.items()}
    n = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    assert n == sum(p.numel() for p in model.parameters()) + sum(
        b.numel() for k, b in model.named_buffers() if "running" in k)
    if name == "wrn28_10":
        assert sum(p.numel() for p in model.parameters()) == 36_479_194


@pytest.mark.parametrize("name", list(NEW))
def test_state_dict_keys_pass_through_the_jax_rename(name):
    """The port's keys are the torchvision / RobustBench names: the JAX
    package's converter (``RENAMES[name]``) maps the full-width state dict
    onto the Flax init's tree, every leaf in its shape (zero-stride arrays:
    no weights allocated, no torchvision needed)."""
    with torch.device("meta"):
        sd = zoo.build_model(name).state_dict()
    fake = {k: np.broadcast_to(np.float32(0), tuple(v.shape)) for k, v in sd.items()}
    # the JAX converter has no entry for the test-scale wrn_tiny: its family's rename
    rename = jax_convert.RENAMES.get(name, jax_convert.wideresnet_rename)
    converted = jax_convert.convert_state_dict(fake, rename)
    jax_convert.assert_tree_shapes_match(converted, _full_init_shapes(name))


def test_zoo_names_and_meta_equal_the_jax_zoos():
    # the port's names are the JAX zoo's and its port-only ones (Swin-L)
    assert zoo.list_models() == sorted(jax_zoo.list_models() + list(zoo.PORT_ONLY))
    assert not set(zoo.PORT_ONLY) & set(jax_zoo.list_models())
    assert len(zoo.list_models()) == 19
    for name in jax_zoo.list_models():
        ours, theirs = zoo.model_meta(name), jax_zoo.model_meta(name)
        assert ours.keys() == theirs.keys()
        assert ours["input_size"] == theirs["input_size"], name
        np.testing.assert_array_equal(ours["mean"], theirs["mean"], err_msg=name)
        np.testing.assert_array_equal(ours["std"], theirs["std"], err_msg=name)
    assert {n: zoo.model_family(n) for n in NEW} == NEW


def test_random_init_sets_the_layer_scale_and_the_cifar_nets_load_at_32(tmp_path):
    with torch.device("meta"):
        model = zoo.build_model("convnext_tiny")
    model.to_empty(device="cpu")
    zoo.random_init_(model)
    scales = [m.layer_scale for m in model.modules() if hasattr(m, "layer_scale")]
    assert len(scales) == 18 and all(torch.all(s == 1e-6) for s in scales)
    bundle = zoo.load_model("wrn_tiny", device="cpu")
    assert bundle.input_size == 32 and bundle.source == "random"
    np.testing.assert_array_equal(bundle.mean, CIFAR10_MEAN)
    # a msgpack of the port's ConvNeXt (layer_scale [C] in Flax) loads strictly
    micro = zoo.random_init_(_port_model("convnext_micro"))
    for p in micro.parameters():
        p.data.uniform_(-1, 1)
    save_variables(to_jax_variables(micro, "convnext"), tmp_path / "w.msgpack")
    back = _port_model("convnext_micro")
    from image_recognition_adversarial_example_attack_tpu_torch.models.flax_msgpack import (
        read_variables)
    back.load_state_dict(from_jax_variables(read_variables(tmp_path / "w.msgpack"), "convnext"),
                         strict=True)
    assert all(torch.equal(a, b) for a, b in zip(back.state_dict().values(),
                                                 micro.state_dict().values()))


def test_bfloat16_keeps_the_norms_in_float32():
    b = zoo.load_model("wrn_tiny", dtype=torch.bfloat16, device="cpu")
    assert b.model.conv1.weight.dtype == torch.bfloat16
    assert b.model.bn1.running_var.dtype == torch.float32
    with torch.device("meta"):
        cn = zoo.set_compute_dtype(zoo.build_model("convnext_tiny"), torch.bfloat16)
    assert cn.features[1][0].block[2].weight.dtype == torch.float32   # the block's LN
    assert cn.features[0][1].weight.dtype == torch.float32            # the stem's LN2d
    assert cn.features[1][0].block[3].weight.dtype == torch.bfloat16  # the MLP


# ---------------------------------------------------------------------------
# int8: the hooked layers and the forward
# ---------------------------------------------------------------------------

def _jax_hooked_shapes(module, x_shape):
    """Kernel shapes of the layers the JAX module quantizes, sorted (the
    call order and the port's module order differ where a shortcut runs
    first): the int8 hooks traced abstractly."""
    seen = []
    conv, dense = jax_int8.int8_conv_general_dilated, jax_int8.int8_dot_general

    def rec_conv(lhs, rhs, *a, **k):
        seen.append(("conv", tuple(rhs.shape)))
        return conv(lhs, rhs, *a, **k)

    def rec_dense(lhs, rhs, *a, **k):
        seen.append(("linear", tuple(rhs.shape)))
        return dense(lhs, rhs, *a, **k)

    mp = pytest.MonkeyPatch()
    mp.setattr(jax_int8, "int8_conv_general_dilated", rec_conv)
    mp.setattr(jax_int8, "int8_dot_general", rec_dense)
    try:
        x = jax.ShapeDtypeStruct(x_shape, jnp.float32)
        variables = jax.eval_shape(module.init, jax.random.PRNGKey(0), x)
        seen.clear()
        jax.eval_shape(module.apply, variables, x)
    finally:
        mp.undo()
    return sorted(seen)


def _port_hooked_shapes(model):
    """The port's quantized layers' weights in the JAX kernel layout, sorted."""
    out = []
    for m in model.modules():
        if isinstance(m, int8.QuantConv2d):
            out.append(("conv", tuple(m.weight.permute(2, 3, 1, 0).shape)))
        elif isinstance(m, int8.QuantLinear):
            out.append(("linear", tuple(m.weight.t().shape)))
    return sorted(out)


@pytest.mark.parametrize("name", [n for n in NEW if n != "wrn28_10_robust"])
def test_int8_quantizes_exactly_the_layers_jax_hooks(name):
    size = jax_zoo.model_meta(name)["input_size"]
    want = _jax_hooked_shapes(jax_zoo._REGISTRY[name](jnp.float32, int8=True),
                              (1, size, size, 3))
    with torch.device("meta"):
        model = zoo.build_model(name, int8=True)
    assert _port_hooked_shapes(model) == want and want
    # the float layers left: the depthwise convs and the squeeze-excite convs
    for mod_name, m in model.named_modules():
        if type(m) is torch.nn.Conv2d:
            assert m.groups == m.in_channels > 1 or mod_name.endswith((".fc1", ".fc2")), mod_name
        assert type(m) is not torch.nn.Linear, mod_name


@pytest.fixture(scope="module", params=list(VARIANTS))
def int8_pair(request):
    name = request.param
    return (name, *_setup(name, int8_on=True))


def test_int8_tiny_variants_equal_jaxs(int8_pair):
    name, module, variables, model = int8_pair
    head = VARIANTS[name][1]
    x = np.random.RandomState(0).uniform(0, 1, (3, 32, 32, 3))
    y = np.array([1, 4, 7])

    def ce(v):
        logits = _captured(module, variables, v, head)
        loss = -jnp.take_along_axis(jax.nn.log_softmax(logits), jnp.asarray(y)[:, None], 1).sum()
        return loss, logits

    with jax.enable_x64():
        xj = jnp.asarray(x)
        fn = jax.jit(jax.value_and_grad(ce, has_aux=True)).lower(xj).compile(
            compiler_options=EXACT_DIVISION)
        (_, want), want_g = fn(xj)
        want, want_g = np.asarray(want), np.asarray(want_g)
    hooks = _jax_hooked_shapes(_jax_module(name, jnp.float32, int8_on=True), (1, 32, 32, 3))
    xt = torch.from_numpy(x).requires_grad_(True)
    int8.reset_calls()
    logits = model(_nchw(xt))
    assert int8.call_counts() == {k: sum(h[0] == k for h in hooks) for k in ("conv", "linear")}
    assert _port_hooked_shapes(model) == hooks
    loss = -torch.log_softmax(logits, -1).gather(-1, torch.from_numpy(y)[:, None]).sum()
    (grad,) = torch.autograd.grad(loss, xt)
    np.testing.assert_allclose(logits.detach().numpy(), want, rtol=0, atol=MODEL_TOL)
    np.testing.assert_allclose(grad.numpy(), want_g, rtol=0, atol=MODEL_TOL)
    # quantization changes the function: the float model's logits differ
    float_model = _port_model(name).double()
    float_model.load_state_dict(model.state_dict(), strict=True)
    with torch.no_grad():
        ref = float_model(_nchw(torch.from_numpy(x)))
    assert np.abs(ref.numpy() - want).max() > 1e-6
