"""The transfer study's model families in the port (models/vgg.py,
densenet.py, vit.py, swin.py, tiny.py), their weight bridge
(models/convert.py) and the zoo's entries, against the JAX package on the
CPU.  The tiny variants run in float64 with the JAX variables carried across
by ``from_jax_variables``: logits and cross-entropy input gradients agree
within 1e-10 (absolute; the logits are of order 1)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import jax_zoo_init_once, module_time_limit, one_thread, time_limit  # noqa: F401 (autouse)
from _torch_port_helpers import init_shaped
from _torch_scaleout_helpers import seeded_variables
from image_recognition_adversarial_example_attack_tpu.core.constants import (
    IMAGENET_MEAN, IMAGENET_STD)
from image_recognition_adversarial_example_attack_tpu.core.normalize import (
    normalize_batch as jax_normalize)
from image_recognition_adversarial_example_attack_tpu.models import convert as jax_convert
from image_recognition_adversarial_example_attack_tpu_torch.cli.common import n_classes_of
from image_recognition_adversarial_example_attack_tpu_torch.core.normalize import (
    normalize_batch as port_normalize)
from image_recognition_adversarial_example_attack_tpu_torch.models import convert, zoo
from image_recognition_adversarial_example_attack_tpu_torch.models.convert import (
    from_jax_variables, load_torch_checkpoint, to_jax_variables)

TOL = 1e-10
# test variant -> (module, the head whose output is the uncast logits, rename)
VARIANTS = {
    "vgg_tiny": ("vgg", "classifier_6", jax_convert.vgg_rename),
    "densenet_tiny": ("densenet", "classifier", jax_convert.densenet_rename),
    "vit_tiny": ("vit", "head", jax_convert.vit_rename),
    "swin_tiny_test": ("swin", "head", jax_convert.swin_rename),
}
FULL = {"vgg19": "vgg", "densenet121": "densenet", "vit_b_16": "vit", "swin_t": "swin"}


def _family(name):
    """The weight-layout family, which is also the models' module name."""
    return VARIANTS[name][0] if name in VARIANTS else zoo.model_family(name)


def _jax_module(name, dtype=jnp.float64):
    mod = importlib.import_module(
        f"image_recognition_adversarial_example_attack_tpu.models.{_family(name)}")
    return getattr(mod, name)(dtype=dtype)


def _port_model(name):
    mod = importlib.import_module(
        f"image_recognition_adversarial_example_attack_tpu_torch.models.{_family(name)}")
    return getattr(mod, name)()


def _perturb(tree, rng):
    """Every normalization statistic and affine parameter, and ViT's class
    token, moved off its init so that none is an identity."""
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
        elif k in ("mean", "bias", "class_token"):
            v = v + rng.randn(*v.shape) * 0.1
        out[k] = v
    return out


@pytest.fixture(scope="module", params=list(VARIANTS))
def pair(request):
    """(name, Flax module in float64, float64 variables, port model with
    them, x [3, 32, 32, 3], labels)."""
    name = request.param
    module = _jax_module(name)
    variables = seeded_variables(_port_model(name), _family(name),
                                 lambda t, rng: _perturb(init_shaped(t, module), rng), seed=3)
    model = _port_model(name).double()
    model.load_state_dict(from_jax_variables(variables, _family(name)), strict=True)
    model.requires_grad_(False).eval()
    rng = np.random.RandomState(0)
    return name, module, variables, model, rng.uniform(0, 1, (3, 32, 32, 3)), np.array([1, 4, 7])


def _jax_logits(name, module, variables, x01):
    """The model's head output before the JAX model's cast to float32."""
    head = VARIANTS[name][1]
    _, state = module.apply(variables, jax_normalize(x01, IMAGENET_MEAN, IMAGENET_STD),
                            capture_intermediates=lambda mdl, _: mdl.name == head)
    return state["intermediates"][head]["__call__"][0]


def _ce(logits, y):
    return -jnp.take_along_axis(jax.nn.log_softmax(logits), y[:, None], 1).sum()


def test_logits_and_input_gradients_equal_jaxs(pair):
    name, module, variables, model, x, y = pair
    with jax.enable_x64():
        xj = jnp.asarray(x)
        logits_fn = jax.jit(lambda v: _jax_logits(name, module, variables, v))
        want = np.asarray(logits_fn(xj))
        want_g = np.asarray(jax.jit(jax.grad(
            lambda v: _ce(_jax_logits(name, module, variables, v), jnp.asarray(y))))(xj))
    assert want.dtype == np.float64 and want.shape == (3, 10)
    xt = torch.from_numpy(x).requires_grad_(True)
    logits = model(port_normalize(xt, IMAGENET_MEAN, IMAGENET_STD).permute(0, 3, 1, 2))
    loss = -torch.log_softmax(logits, -1).gather(-1, torch.from_numpy(y)[:, None]).sum()
    (grad,) = torch.autograd.grad(loss, xt)
    np.testing.assert_allclose(logits.detach().numpy(), want, rtol=0, atol=TOL)
    np.testing.assert_allclose(grad.numpy(), want_g, rtol=0, atol=TOL)
    assert np.abs(want_g).max() > 1e-4  # the gradient reaches the input


def test_swin_tiny_shifts_in_its_first_stage():
    """At 32x32 the first stage's map is 16x16 against a window of 4: its odd
    block takes the shifted path (so the parity test above covers it)."""
    model = zoo.random_init_(_port_model("swin_tiny_test"))
    attn = model.features[1][1].attn
    assert attn.shift == 2 and not attn._masks
    model(torch.rand(1, 3, 32, 32))
    ((h, w, *_),) = attn._masks  # the 16x16 map of stage 1 took the shifted path
    assert (h, w) == (16, 16)


def _same_tree(a, b) -> bool:
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _same_tree(a[k], b[k]) for k in a)
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.array_equal(a, b)


def test_to_jax_variables_round_trip_is_exact(pair):
    name, _, variables, model, *_ = pair
    tree = to_jax_variables(model, _family(name))
    assert _same_tree(tree, variables)
    back = from_jax_variables(tree, _family(name))
    sd = model.state_dict()
    assert back.keys() == sd.keys() and all(torch.equal(back[k], sd[k]) for k in sd)


def test_torchvision_keys_through_the_jax_converter(pair, tmp_path):
    """The port's state dict, read as a torchvision ``.pth`` by the JAX
    package's converter (``convert_state_dict`` with the family's rename,
    then ``conform_qkv_layout``), gives back the Flax tree and its logits:
    the port's names are torchvision's."""
    name, module, variables, model, x, _ = pair
    rename = VARIANTS[name][2]
    template = jax.tree_util.tree_map(lambda a: a.astype(np.float32), variables)
    converted = jax_convert.convert_state_dict(model.state_dict(), rename)
    converted = jax_convert.conform_qkv_layout(converted, template)
    jax_convert.assert_tree_shapes_match(converted, template)
    assert _same_tree(converted, template)
    apply = jax.jit(_jax_module(name, jnp.float32).apply)
    xj = jnp.asarray(x, jnp.float32)
    np.testing.assert_array_equal(np.asarray(apply(converted, xj)),
                                  np.asarray(apply(template, xj)))
    # and a .pth of it loads strictly (ViT also under torchvision's older MLP names)
    sd = model.state_dict()
    if name == "vit_tiny":
        sd = {k.replace(".mlp.0.", ".mlp.linear_1.").replace(".mlp.3.", ".mlp.linear_2."): v
              for k, v in sd.items()}
        assert any(".mlp.linear_1." in k for k in sd)
    torch.save({f"module.{k}": v for k, v in sd.items()}, tmp_path / "w.pth")
    fresh = _port_model(name).double()
    fresh.load_state_dict(load_torch_checkpoint(tmp_path / "w.pth"), strict=True)
    assert all(torch.equal(a, b) for a, b in zip(fresh.state_dict().values(),
                                                 model.state_dict().values()))


def test_unknown_keys_raise(pair):
    name, _, variables, *_ = pair
    bad = {**variables, "params": {**variables["params"], "extra": {"kernel": np.zeros((2, 2))}}}
    with pytest.raises(RuntimeError, match="Unexpected key"):
        sd = from_jax_variables(bad, _family(name))
        _port_model(name).double().load_state_dict(sd, strict=True)


@pytest.mark.parametrize("name", list(FULL))
def test_full_width_shapes_match_the_jax_init(name):
    """The port's full-width model (built on the meta device, no weights
    allocated) has exactly the tensors, in the shapes, that the JAX init's
    abstract shapes bridge to."""
    shapes = jax.eval_shape(_jax_module(name, jnp.float32).init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 224, 224, 3), jnp.float32))
    meta = jax.tree_util.tree_map(lambda s: torch.empty(s.shape, device="meta"), shapes)
    bridged = from_jax_variables(meta, _family(name))
    with torch.device("meta"):
        model = zoo.build_model(name)
    sd = model.state_dict()
    assert bridged.keys() == sd.keys()
    assert {k: tuple(v.shape) for k, v in bridged.items()} == {
        k: tuple(v.shape) for k, v in sd.items()}
    n = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    assert n == sum(p.numel() for p in model.parameters()) + sum(
        b.numel() for k, b in model.named_buffers() if "running" in k)


@pytest.mark.parametrize("name", zoo.list_models())
def test_n_classes_of_every_registered_family(name):
    with torch.device("meta"):
        model = zoo.build_model(name)
    # the CIFAR family defaults to 10 classes, as the JAX constructors do
    assert n_classes_of(model) == (10 if name in ("resnet_tiny", "ibp_cnn7", "ibp_tiny",
                                                  "wrn28_10", "wrn34_10", "wrn_tiny",
                                                  "preact_resnet18", "wrn28_10_robust")
                                   else 1000)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_n_classes_of_the_test_variants(name):
    assert n_classes_of(_port_model(name)) == 10


@pytest.mark.parametrize("name", list(FULL))
def test_the_zoo_registers_the_family_as_the_jax_zoo(name):
    from image_recognition_adversarial_example_attack_tpu.models import zoo as jax_zoo

    assert name in zoo.list_models() and name in jax_zoo.list_models()
    ours, theirs = zoo.model_meta(name), jax_zoo.model_meta(name)
    assert ours["input_size"] == theirs["input_size"] == 224
    np.testing.assert_array_equal(ours["mean"], theirs["mean"])
    np.testing.assert_array_equal(ours["std"], theirs["std"])
    assert zoo.model_family(name) == FULL[name]


@pytest.mark.parametrize("direction", ["from_jax", "to_jax"])
def test_the_bridge_refuses_an_unknown_family(direction):
    """The family is named by the caller, never guessed: a name the bridge
    has no path map for raises before any tensor is mapped."""
    with pytest.raises(ValueError, match="no weight bridge for family 'vgg19'"):
        if direction == "from_jax":
            convert.from_jax_variables({"params": {}}, "vgg19")
        else:
            convert.to_jax_variables(_port_model("vgg_tiny"), "vgg19")
