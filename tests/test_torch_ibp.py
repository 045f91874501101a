"""The certified family of the port (models/ibp.py, defenses/ibp.py,
defenses/crown_ibp.py, the ``"ibp"`` weight bridge) against the JAX
package's on the CPU.

The JAX nets are initialized, their biases perturbed from a numpy seed, and
carried into the port through ``models.convert.from_jax_variables``.
Tolerances, relative to the largest |bound| (a random net's bounds reach
1e5-1e6 at eps 8/255 on ibp_cnn7):

- float64: 1e-9.  The JAX functions cast to float32 inside; the tests run
  them with a ``jnp`` whose ``float32`` is float64 (``_F64``), the port
  keeps float64 inputs in float64 (``ibp.bound_dtype``);
- float32: 1e-5 (both packages' float32 convs and products, summed in
  other orders);
- the bridged logits: 1e-5; the conv adjoint: the identity
  ``<conv(x), a> = <x, conv^T(a)>`` within 1e-12 in float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from _torch_cli_helpers import one_thread  # noqa: F401 (autouse)
from image_recognition_adversarial_example_attack_tpu.defenses import crown_ibp as jax_crown
from image_recognition_adversarial_example_attack_tpu.defenses import ibp as jax_ibp
from image_recognition_adversarial_example_attack_tpu.models import ibp as jax_models
from image_recognition_adversarial_example_attack_tpu_torch.attacks.api import make_logits_fn
from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed
from image_recognition_adversarial_example_attack_tpu_torch.defenses import crown_ibp, ibp
from image_recognition_adversarial_example_attack_tpu_torch.defenses.detector import (
    make_features_fn)
from image_recognition_adversarial_example_attack_tpu_torch.models import ibp as models
from image_recognition_adversarial_example_attack_tpu_torch.models import zoo
from image_recognition_adversarial_example_attack_tpu_torch.models.convert import (
    from_jax_variables, to_jax_variables)

TOL64, TOL32, LOGIT_TOL = 1e-9, 1e-5, 1e-5
MEAN, STD = np.zeros(3, np.float32), np.ones(3, np.float32)
NAMES = ["ibp_tiny", "ibp_cnn7"]


class _F64:
    """``jax.numpy`` whose ``float32`` is float64: the JAX propagators'
    casts then keep float64."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.fixture(scope="module", params=NAMES)
def net(request):
    name = request.param
    module = getattr(jax_models, name)()
    variables = jax.jit(module.init)(jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 3)))
    rs = np.random.RandomState(0)
    params = {layer: {k: np.asarray(v, np.float32) + (rs.randn(*v.shape).astype(np.float32)
                                                       * 0.05 if k == "bias" else 0)
                      for k, v in leaves.items()}
              for layer, leaves in jax.device_get(variables)["params"].items()}
    model = getattr(models, name)()
    model.load_state_dict(from_jax_variables({"params": params}, "ibp"), strict=True)
    model.eval().requires_grad_(False)
    x = rs.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    y = np.asarray(module.apply({"params": params}, x)).argmax(-1)
    return {"name": name, "module": module, "params": params, "model": model, "x": x, "y": y}


def _scale_close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1.0))


def _jax64(fn, *args):
    """``fn`` jitted under x64 with the propagators' float32 casts made
    float64."""
    with jax.enable_x64():
        saved = jax_ibp.jnp, jax_crown.jnp
        jax_ibp.jnp = jax_crown.jnp = _F64()
        try:
            out = jax.jit(fn)(*args)
            return jax.tree_util.tree_map(np.asarray, out)
        finally:
            jax_ibp.jnp, jax_crown.jnp = saved


def _params64(net):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), net["params"])


def test_bridged_logits_equal_jaxs(net):
    want = np.asarray(net["module"].apply({"params": net["params"]}, net["x"]))
    lf = make_logits_fn(net["model"], MEAN, STD)
    got = lf(torch.from_numpy(net["x"])).numpy()
    _scale_close(got, want, LOGIT_TOL)
    # and back: the bridge inverts
    back = to_jax_variables(net["model"], "ibp")
    assert set(back) == {"params"}
    for layer, leaves in net["params"].items():
        for k, v in leaves.items():
            np.testing.assert_array_equal(back["params"][layer][k], v)


def test_a_flax_msgpack_file_loads_through_load_model(net, tmp_path):
    path = tmp_path / f"{net['name']}.msgpack"
    path.write_bytes(serialization.to_bytes({"params": net["params"]}))
    bundle = zoo.load_model(net["name"], weights=path, device="cpu")
    assert bundle.source == "cache" and bundle.input_size == 32
    assert zoo.model_family(net["name"]) == "ibp"
    np.testing.assert_array_equal(bundle.mean, MEAN)
    np.testing.assert_array_equal(bundle.std, STD)
    for k, v in net["model"].state_dict().items():
        assert torch.equal(bundle.model.state_dict()[k], v)


@pytest.mark.parametrize("eps", [8 / 255])
def test_interval_bounds_equal_jaxs(net, eps):
    x, spec, p = net["x"], net["module"].spec, models.ibp_params(net["model"])
    assert tuple(spec) == net["model"].spec
    want_lo, want_hi = jax.device_get(jax.jit(
        lambda xx: jax_ibp.logit_bounds(net["params"], spec, xx, eps, MEAN, STD))(x))
    lo, hi = ibp.logit_bounds(p, spec, torch.from_numpy(x), eps, MEAN, STD)
    _scale_close(lo.numpy(), want_lo, TOL32)
    _scale_close(hi.numpy(), want_hi, TOL32)
    p64 = _params64(net)
    want_lo, want_hi = _jax64(lambda xx: jax_ibp.logit_bounds(
        p64, spec, xx, eps, MEAN.astype(np.float64), STD.astype(np.float64)),
        x.astype(np.float64))
    m64 = getattr(models, net["name"])().double().requires_grad_(False)
    m64.load_state_dict(net["model"].state_dict())
    lo, hi = ibp.logit_bounds(models.ibp_params(m64), spec, torch.from_numpy(x).double(), eps,
                              MEAN, STD)
    assert lo.dtype == torch.float64
    _scale_close(lo.numpy(), want_lo, TOL64)
    _scale_close(hi.numpy(), want_hi, TOL64)
    assert (lo <= hi).all()


@pytest.mark.parametrize("eps", [2 / 255])
def test_crown_ibp_margins_equal_jaxs(net, eps):
    x, y, spec = net["x"], net["y"], net["module"].spec
    p = models.ibp_params(net["model"])

    def jax_fn(xx, yy, params, mean, std):
        crown, ib = jax_crown.margin_spec_bounds(params, spec, xx, yy, eps, mean, std)
        return crown, ib, jax_crown.crown_ibp_margin(params, spec, xx, yy, eps, mean, std)

    want = jax.device_get(jax.jit(lambda xx, yy: jax_fn(xx, yy, net["params"], MEAN, STD))(x, y))
    got = crown_ibp.margin_spec_bounds(p, spec, torch.from_numpy(x), torch.from_numpy(y), eps,
                                       MEAN, STD)
    got += (crown_ibp.crown_ibp_margin(p, spec, torch.from_numpy(x), torch.from_numpy(y), eps,
                                       MEAN, STD),)
    for g, w in zip(got, want):
        _scale_close(g.numpy(), w, TOL32)

    m64 = getattr(models, net["name"])().double().requires_grad_(False)
    m64.load_state_dict(net["model"].state_dict())
    p64 = _params64(net)
    want = _jax64(lambda xx, yy: jax_fn(xx, yy, p64, MEAN.astype(np.float64),
                                        STD.astype(np.float64)), x.astype(np.float64), y)
    xd, yt = torch.from_numpy(x).double(), torch.from_numpy(y)
    crown, ib = crown_ibp.margin_spec_bounds(models.ibp_params(m64), spec, xd, yt, eps,
                                             MEAN, STD)
    margin = crown_ibp.crown_ibp_margin(models.ibp_params(m64), spec, xd, yt, eps, MEAN, STD)
    for g, w in zip((crown, ib, margin), want):
        _scale_close(g.numpy(), w, TOL64)
    # column y is exactly 0 in both bounds
    rows = np.arange(len(y))
    assert (crown.numpy()[rows, y] == 0).all() and (ib.numpy()[rows, y] == 0).all()


def test_verify_fns_equal_jaxs(net):
    x, y, spec = net["x"], net["y"], net["module"].spec
    p = models.ibp_params(net["model"])
    for jax_make, make in ((jax_ibp.make_verify_fn, ibp.make_verify_fn),
                           (jax_crown.make_crown_verify_fn, crown_ibp.make_crown_verify_fn)):
        jax_verify = jax.jit(jax_make(net["params"], spec, MEAN, STD))  # eps is traced
        for eps in (0.0, 1e-4):
            want = jax.device_get(jax_verify(x, y, jnp.float32(eps)))
            got = make(p, spec, MEAN, STD)(torch.from_numpy(x), torch.from_numpy(y), eps)
            assert set(got) == set(want) == {"verified", "correct", "margin"}
            np.testing.assert_array_equal(got["correct"].numpy(), want["correct"])
            np.testing.assert_array_equal(got["verified"].numpy(), want["verified"])
            _scale_close(got["margin"].numpy(), want["margin"], TOL32)
            # the clean labels are correct, and at eps 0 a positive margin
            assert got["correct"].all()


def test_crown_is_never_looser_than_ibp_and_is_sound():
    """On ibp_tiny: CROWN-IBP's margin >= IBP's, and a 20-step PGD on the
    margin z_y - max_{j!=y} z_j inside the eps-ball never goes below it."""
    model = zoo.load_model("ibp_tiny", device="cpu").model
    p, spec = models.ibp_params(model), model.spec
    x = torch.rand(8, 32, 32, 3, generator=generator_from_seed(3), dtype=torch.float64)
    model.double()
    lf = make_logits_fn(model, MEAN, STD)
    y = lf(x).argmax(-1)
    for eps in (2 / 255, 8 / 255):
        lo, hi = ibp.logit_bounds(p, spec, x, eps, MEAN, STD)
        ibp_m = ibp.verified_margin(lo, hi, y)
        crown_m = crown_ibp.crown_ibp_margin(p, spec, x, y, eps, MEAN, STD)
        assert (crown_m >= ibp_m - 1e-12).all()
        z = x.clone()
        onehot = torch.nn.functional.one_hot(y, 10).bool()
        for _ in range(20):
            z.requires_grad_(True)
            logits = lf(z)
            margin = (logits[onehot]
                      - logits.masked_fill(onehot, -torch.inf).max(-1).values)
            (g,) = torch.autograd.grad(margin.sum(), z)
            z = torch.clamp(torch.clamp(z.detach() - eps / 4 * g.sign(), x - eps, x + eps), 0, 1)
            assert (margin.detach() >= crown_m - 1e-9).all()


@pytest.mark.parametrize("shape,stride", [((2, 3, 8, 8), 1), ((2, 4, 8, 10), 2),
                                          ((1, 2, 7, 9), 2)])
def test_conv_adjoint_identity(shape, stride):
    rs = np.random.RandomState(5)
    x = torch.from_numpy(rs.randn(*shape))
    w = torch.from_numpy(rs.randn(6, shape[1], 3, 3))
    y = models.conv_same(x, w, None, stride)
    a = torch.from_numpy(rs.randn(*y.shape))
    lhs = float((y * a).sum())
    rhs = float((x * crown_ibp.conv_same_adjoint(a, w, stride, shape[2:])).sum())
    assert abs(lhs - rhs) <= 1e-12 * max(abs(lhs), 1.0)


@pytest.mark.parametrize("n,stride", [(32, 1), (32, 2), (31, 2), (16, 2), (9, 3)])
def test_same_padding_is_flaxs(n, stride):
    import flax.linen as nn

    conv = nn.Conv(1, (3, 3), strides=(stride, stride), padding="SAME", use_bias=False)
    x = np.random.RandomState(0).randn(1, n, n, 1).astype(np.float32)
    v = conv.init(jax.random.PRNGKey(0), x)
    want = np.asarray(conv.apply(v, x))
    w = torch.from_numpy(np.asarray(v["params"]["kernel"])).permute(3, 2, 0, 1)
    got = models.conv_same(torch.from_numpy(x).permute(0, 3, 1, 2), w, None, stride)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=1e-5)


def test_zoo_entries_and_the_features_fallback():
    assert zoo.model_meta("ibp_cnn7")["input_size"] == 32
    assert zoo.model_meta("resnet50")["input_size"] == 224
    bundle = zoo.load_model("ibp_tiny", dtype=torch.bfloat16, device="cpu")
    # float32 parameters in a bfloat16 model, as Flax's param_dtype
    assert all(v.dtype == torch.float32 for v in bundle.model.parameters())
    assert models.spec_shapes(models.CNN7_SPEC, 32)[11] == (128 * 16 * 16,)
    with pytest.raises(ValueError, match="does not support int8"):
        zoo.load_model("ibp_tiny", device="cpu", int8=True)
    # no features_stage3: the detector's features are the logits, as in JAX
    f32 = zoo.load_model("ibp_tiny", device="cpu")
    x = torch.rand(3, 32, 32, 3, generator=generator_from_seed(0))
    ff = make_features_fn(f32.model, f32.mean, f32.std)
    np.testing.assert_array_equal(ff(x).numpy(), make_logits_fn(f32.model, f32.mean,
                                                                f32.std)(x).numpy())
