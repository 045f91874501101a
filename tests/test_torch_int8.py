"""int8 quantized inference in the port (ops/int8.py, the families' ``int8``
flag, the zoo's and the CLIs' ``--int8``) against the JAX package's
``ops/int8.py`` on the CPU.

Per op, in float32: ``quantize_symmetric``, ``int8_conv2d`` and
``int8_linear`` are bit-equal to ``quantize_symmetric``,
``int8_conv_general_dilated`` and ``int8_dot_general`` run op by op.  (Under
``jax.jit`` XLA's CPU compiler turns the division of a weight scale by 127
into a multiplication by its reciprocal, one ulp off in some scales, so the
reference runs eagerly: the division is the function's definition.)  The
gradients are the float op's VJP: within 1e-12 (float64) of JAX's.

Whole models, the six tiny families with ``int8=True``, run in float64
with the same weights: the quantization casts to float32, so the two
frameworks' float64 differences (about 1e-15) do not move a rounding
decision, and logits and input gradients agree within 1e-9 (absolute; the
logits are of order 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_cli_helpers import one_thread  # noqa: F401 (autouse)
from image_recognition_adversarial_example_attack_tpu.ops import int8 as jax_int8
from image_recognition_adversarial_example_attack_tpu_torch.models import zoo
from image_recognition_adversarial_example_attack_tpu_torch.models.convert import (
    to_jax_variables)
from image_recognition_adversarial_example_attack_tpu_torch.ops import int8

NHWC = ("NHWC", "HWIO", "NHWC")
GRAD_TOL = 1e-12


def _rand(shape, seed, dtype=np.float32, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(dtype)


# ---------------------------------------------------------------------------
# the ops, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,axes", [
    ((3, 9, 9, 5), (1, 2, 3)),   # an NHWC activation, per example
    ((4, 6, 16), (1, 2)),        # a token batch, per example
    ((3, 3, 5, 7), (0, 1, 2)),   # an HWIO kernel, per output channel
    ((16, 24), (0,)),            # a Dense kernel, per output feature
    ((2, 3, 4), None),           # one scale for the tensor
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
def test_quantize_symmetric_is_bit_equal(shape, axes, dtype):
    x = _rand(shape, 0, scale=3.0)
    x[0, ...] = 0.0  # an all-zero slice takes the 1e-8 floor
    jx = jnp.asarray(x, dtype=jnp.dtype(dtype)) if dtype != "float64" else x
    with jax.enable_x64(dtype == "float64"):
        q, s = jax_int8.quantize_symmetric(jnp.asarray(jx), axes)
        q, s = np.asarray(q), np.asarray(s)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    tq, ts = int8.quantize_symmetric(tx, axes)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), q)
    np.testing.assert_array_equal(ts.numpy(), s)


# (input NHWC, kernel HWIO, stride, padding): ResNet's stem, a 3x3 stage conv
# with and without stride, the 1x1 convs, a ViT/Swin patch conv
CONVS = [((2, 32, 32, 3), (7, 7, 3, 8), 2, 3), ((2, 9, 9, 6), (3, 3, 6, 5), 1, 1),
         ((2, 9, 9, 6), (3, 3, 6, 5), 2, 1), ((2, 8, 8, 6), (1, 1, 6, 12), 1, 0),
         ((2, 8, 8, 6), (1, 1, 6, 12), 2, 0), ((2, 32, 32, 3), (8, 8, 3, 16), 8, 0)]


def _jax_conv(x, w, stride, pad):
    return jax_int8.int8_conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride), ((pad, pad), (pad, pad)),
        dimension_numbers=NHWC)


@pytest.mark.parametrize("xs,ws,stride,pad", CONVS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_conv2d_is_bit_equal(xs, ws, stride, pad, dtype):
    x, w = _rand(xs, 1), _rand(ws, 2, scale=0.2)
    want = np.asarray(_jax_conv(jnp.asarray(x, jnp.dtype(dtype)), jnp.asarray(w, jnp.dtype(dtype)),
                                stride, pad).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(tdt)
    wt = torch.from_numpy(w).permute(3, 2, 0, 1).to(tdt)
    for mf in (torch.contiguous_format, torch.channels_last):
        got = int8.int8_conv2d(xt.contiguous(memory_format=mf), wt, stride, pad)
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.float().permute(0, 2, 3, 1).numpy(), want)


# (input, Dense kernel [K, N]): a [B,K] head, ViT's [B,T,K] tokens, Swin's
# [B*nW, 49, C] windows
LINEARS = [((5, 16), (16, 24)), ((2, 5, 32), (32, 64)), ((8, 49, 16), (16, 48))]


@pytest.mark.parametrize("xs,ws", LINEARS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_linear_is_bit_equal(xs, ws, dtype):
    x, w = _rand(xs, 3), _rand(ws, 4, scale=0.2)
    dn = (((len(xs) - 1,), (0,)), ((), ()))
    want = np.asarray(jax_int8.int8_dot_general(
        jnp.asarray(x, jnp.dtype(dtype)), jnp.asarray(w, jnp.dtype(dtype)), dn).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    got = int8.int8_linear(torch.from_numpy(x).to(tdt), torch.from_numpy(w.T.copy()).to(tdt))
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_head_aligned_qkv_kernel_is_bit_equal():
    """JAX's DenseGeneral qkv kernel [D, 3, H, hd] takes one weight scale per
    (part, head, lane): per row of torch's packed [3D, D]."""
    d, h = 16, 2
    x, w = _rand((3, 5, d), 5), _rand((d, 3, h, d // h), 6, scale=0.2)
    want = np.asarray(jax_int8.int8_dot_general(jnp.asarray(x), jnp.asarray(w),
                                                (((2,), (0,)), ((), ()))))
    got = int8.int8_linear(torch.from_numpy(x), torch.from_numpy(w.reshape(d, -1).T.copy()))
    np.testing.assert_array_equal(got.numpy(), want.reshape(3, 5, 3 * d))


@pytest.mark.parametrize("case", ["conv", "linear"])
def test_gradients_are_the_float_ops_vjp(case):
    """Input and weight gradients: the float op's VJP at the same point, as
    JAX's custom VJP gives them (float64)."""
    if case == "conv":
        x, w = _rand((2, 9, 9, 6), 7, np.float64), _rand((3, 3, 6, 5), 8, np.float64, 0.2)
        g = _rand((2, 5, 5, 5), 9, np.float64)
        f = lambda a, b: jax_int8.int8_conv_general_dilated(  # noqa: E731
            a, b, (2, 2), ((1, 1), (1, 1)), dimension_numbers=NHWC)
        xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
        wt = torch.from_numpy(w).permute(3, 2, 0, 1).requires_grad_(True)
        out = int8.int8_conv2d(xt, wt, 2, 1)
        gt = torch.from_numpy(g).permute(0, 3, 1, 2)
        to_jax = (lambda t: t.permute(0, 2, 3, 1), lambda t: t.permute(2, 3, 1, 0))
        float_out = F.conv2d(xt, wt, stride=2, padding=1)
    else:
        x, w = _rand((3, 5, 16), 7, np.float64), _rand((16, 24), 8, np.float64, 0.2)
        g = _rand((3, 5, 24), 9, np.float64)
        f = lambda a, b: jax_int8.int8_dot_general(a, b, (((2,), (0,)), ((), ())))  # noqa: E731
        xt = torch.from_numpy(x).requires_grad_(True)
        wt = torch.from_numpy(w.T.copy()).requires_grad_(True)
        out = int8.int8_linear(xt, wt)
        gt = torch.from_numpy(g)
        to_jax = (lambda t: t, lambda t: t.T)
        float_out = F.linear(xt, wt)
    with jax.enable_x64():
        _, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w))
        want_x, want_w = (np.asarray(v) for v in vjp(jnp.asarray(g)))
    gx, gw = torch.autograd.grad(out, (xt, wt), gt)
    np.testing.assert_allclose(to_jax[0](gx).numpy(), want_x, rtol=0, atol=GRAD_TOL)
    np.testing.assert_allclose(to_jax[1](gw).numpy(), want_w, rtol=0, atol=GRAD_TOL)
    # and the float op's own autograd, at the same point
    fx, fw = torch.autograd.grad(float_out, (xt, wt), gt)
    np.testing.assert_allclose(gx.numpy(), fx.numpy(), rtol=0, atol=GRAD_TOL)
    np.testing.assert_allclose(gw.numpy(), fw.numpy(), rtol=0, atol=GRAD_TOL)


@pytest.mark.parametrize("m,k,n", [(1, 2048, 1000), (128, 2048, 1000), (5, 147, 64),
                                   (33, 576, 64), (7, 10, 3)])
def test_padded_int_mm_equals_the_plain_route(m, k, n):
    """``torch._int_mm`` with its zero padding (M > 16, K and N multiples of
    8) equals the int64 plain route; a CPU tensor takes the plain route."""
    g = torch.Generator().manual_seed(m * 7 + k)
    a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8)
    want = (a.long() @ w.long().t()).int()
    assert torch.equal(int8.int_matmul_padded(a, w), want)
    assert torch.equal(int8.int_matmul_plain(a, w), want)
    assert torch.equal(int8.int_matmul(a, w), want)


def test_grouped_and_dilated_convolutions_raise():
    x = torch.zeros(1, 4, 6, 6)
    with pytest.raises(ValueError, match="grouped"):
        int8.int8_conv2d(x, torch.zeros(4, 2, 3, 3), 1, 1, groups=2)
    with pytest.raises(ValueError, match="dilation"):
        int8.int8_conv2d(x, torch.zeros(4, 4, 3, 3), 1, 2, dilation=2)
    with pytest.raises(ValueError, match="explicit integer padding"):
        int8.int8_conv2d(x, torch.zeros(4, 4, 3, 3), 1, "same")


def test_quantized_layers_add_the_bias_after_the_product():
    layer = int8.QuantLinear(16, 8).double()
    torch.nn.init.normal_(layer.bias)
    x = torch.randn(3, 16, dtype=torch.float64)
    want = int8.int8_linear(x, layer.weight) + layer.bias
    assert torch.equal(layer(x), want)
    conv = int8.QuantConv2d(3, 4, 3, padding=1).double()
    torch.nn.init.normal_(conv.bias)
    xc = torch.randn(2, 3, 5, 5, dtype=torch.float64)
    assert torch.equal(conv(xc), int8.int8_conv2d(xc, conv.weight, 1, 1)
                       + conv.bias.reshape(1, -1, 1, 1))


# ---------------------------------------------------------------------------
# the zoo and the CLIs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", zoo.list_models())
def test_int8_keeps_the_parameter_tree(name):
    """The same state-dict keys and shapes, the hooked layers quantized
    (built on the meta device: no weights allocated).  The IBP nets have no
    int8 mode, as in the JAX package: they refuse it."""
    if zoo.model_family(name) == "ibp":
        with pytest.raises(ValueError, match="does not support int8"):
            zoo.build_model(name, int8=True)
        return
    with torch.device("meta"):
        plain, quant = zoo.build_model(name), zoo.build_model(name, int8=True)
    a, b = plain.state_dict(), quant.state_dict()
    assert list(a) == list(b)
    assert all(a[k].shape == b[k].shape for k in a)
    n_quant = sum(isinstance(m, (int8.QuantConv2d, int8.QuantLinear)) for m in quant.modules())
    n_float = sum(type(m) in (torch.nn.Conv2d, torch.nn.Linear) for m in quant.modules())
    assert n_quant > 0 and n_float == 0


def test_int8_weights_load_through_msgpack_and_random_init(tmp_path):
    from image_recognition_adversarial_example_attack_tpu_torch.models.flax_msgpack import (
        save_variables)

    plain = zoo.load_model("resnet_tiny", device="cpu")
    quant = zoo.load_model("resnet_tiny", device="cpu", int8=True)
    # the random init draws the same weights
    for (k, v), (k2, v2) in zip(plain.model.state_dict().items(),
                                quant.model.state_dict().items()):
        assert k == k2 and torch.equal(v, v2), k
    path = tmp_path / "resnet_tiny.msgpack"
    save_variables(to_jax_variables(quant.model, "resnet"), path)
    back = zoo.load_model("resnet_tiny", device="cpu", weights=path, int8=True)
    assert back.source == "cache"
    assert isinstance(back.model.fc, int8.QuantLinear)
    for k, v in quant.model.state_dict().items():
        assert torch.equal(back.model.state_dict()[k], v), k


def test_a_family_without_int8_is_refused(monkeypatch):
    monkeypatch.setitem(zoo._REGISTRY, "no_int8", ("resnet", lambda: zoo.resnet_tiny()))
    with pytest.raises(ValueError, match="model 'no_int8' does not support int8 inference yet"):
        zoo.build_model("no_int8", int8=True)
    with pytest.raises(ValueError, match="does not support int8"):
        zoo.load_model("no_int8", device="cpu", int8=True)
    assert zoo.build_model("no_int8") is not None


def test_int8_flag_reaches_load_bundle():
    from image_recognition_adversarial_example_attack_tpu_torch.cli import classify, common

    args = classify.build_parser().parse_args(["x.png", "--int8", "--device", "cpu",
                                               "--model", "resnet_tiny"])
    assert args.int8 is True
    bundle = common.load_bundle(args)
    assert isinstance(bundle.model.conv1, int8.QuantConv2d)
    assert isinstance(bundle.model.fc, int8.QuantLinear)
    args.int8 = False
    assert type(common.load_bundle(args).model.conv1) is torch.nn.Conv2d


def test_classify_cli_runs_int8_on_the_cpu(tmp_path, capsys):
    from PIL import Image

    from image_recognition_adversarial_example_attack_tpu_torch.cli import classify

    img = tmp_path / "img.png"
    Image.fromarray((np.random.RandomState(0).rand(40, 40, 3) * 255).astype(np.uint8)).save(img)
    int8.reset_calls()
    assert classify.main([str(img), "--int8", "--device", "cpu", "--model", "resnet_tiny",
                          "--attack", "pgd", "--steps", "2"]) == 0
    out = capsys.readouterr().out
    assert "Adversarial (pgd):" in out and out.count("Top 1:") == 2
    # the clean forward, 2 steps (forward each), the adversarial forward
    # resnet_tiny's 17 convs and its fc at each of 4 forwards
    assert int8.call_counts() == {"conv": 4 * 17, "linear": 4}
