"""int8 quantized inference (port of ``ops/int8.py``).

The JAX package's recipe, op for op:

- **weights**: symmetric int8 per output channel (scale = absmax / 127 per
  output channel), quantized from the float parameters at every call, so
  checkpoints and parameter trees do not change;
- **activations**: symmetric int8 per example: the scale reduces over every
  axis but the leading one, so an example's grid depends on that example
  alone.  The leading axis is whatever leads the tensor that reaches the
  layer: in Swin's window attention that is ``B * nW`` (one scale per
  window), as in the JAX model;
- **product**: int8 x int8 accumulated in int32, dequantized as
  ``acc.float() * (s_x * s_w)`` in float32, then cast to the output dtype
  (the promoted dtype of input and weight);
- **gradients**: the float op's VJP at the same primal point, in the output
  dtype (the straight-through treatment at op granularity), so every attack
  runs unchanged against a quantized model.

Quantization divides (``x32 / scale``, not a multiplication by ``1/scale``)
and rounds half to even, as ``jnp.round`` does.  A layer's bias is not part
of the quantized op: flax adds it after the product, so the quantized
``Conv2d`` / ``Linear`` add it after the dequantized product, in the compute
dtype.

The product's route: a convolution becomes im2col (a patch gather on the
NHWC view) and a matrix product.  On a CUDA tensor the product is
``torch._int_mm`` (int8 x int8 -> int32, exact), zero-padded to its shape
rules (more than 16 rows, K and N multiples of 8; zeros leave the int32
result unchanged); where it still refuses a shape it raises, and nothing
switches to a float product.  On a CPU tensor the product is the plain
route, the same integers multiplied in int64.  In the JAX package this is
XLA, not a Pallas kernel, so no hand-written kernel stands behind it.

The JAX package's ``int8_dot_general`` runs any contraction other than a
Dense one (the last axis of the input against the first of the kernel, no
batch axes) as the float op.  Here every quantized product is a Dense one by
construction (``int8_linear`` contracts the input's last axis with the
weight's; the attention score products are not routed here and stay float,
as in the JAX models), so that branch has nothing to reach.

Grouped and dilated convolutions raise: no family quantizes one.  The
depthwise convs of MobileNetV2, EfficientNet and ConvNeXt, and
EfficientNet's squeeze-excite convs, stay float in int8 mode, as the JAX
families leave them unhooked.  A Dense layer's input may have any rank
(ConvNeXt's MLP reads [B, H, W, C]): one activation scale per example over
every axis but the leading one.

``CALLS`` counts the quantized ops' forward calls (on any device), so a run
can show how many of a model's layers went through them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

_EPS = 1e-8
_QMAX = 127.0

CALLS: dict[str, int] = {"conv": 0, "linear": 0}


def reset_calls() -> None:
    for k in CALLS:
        CALLS[k] = 0


def call_counts() -> dict[str, int]:
    return dict(CALLS)


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    # a float32 tensor, not a Python scalar: PyTorch turns the division of a
    # CUDA tensor by a Python scalar into a multiplication by its reciprocal
    return torch.full((), value, dtype=torch.float32, device=like.device)


def quantize_symmetric(x: torch.Tensor, dims=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization with the absmax reduced over ``dims``.

    Returns ``(q int8, scale float32 with kept dims)``, ``x ~ q * scale``.
    ``dims=None`` reduces everything (one scale for the tensor).  The absmax
    is taken in float32, after casting the input to float32."""
    x32 = x.float()
    if dims is None:
        dims = tuple(range(x.ndim))
    absmax = torch.amax(torch.abs(x32), dim=dims, keepdim=True)
    scale = torch.maximum(absmax, _scalar(_EPS, x32)) / _scalar(_QMAX, x32)
    q = torch.clamp(torch.round(x32 / scale), -_QMAX, _QMAX)
    return q.to(torch.int8), scale


def _batch_dims(ndim: int) -> tuple[int, ...]:
    """Every axis but the leading one (the per-example reduction)."""
    return tuple(range(1, ndim))


# ---------------------------------------------------------------------------
# The integer product: a [M,K] int8 times w [N,K] int8 transposed -> [M,N] int32
# ---------------------------------------------------------------------------

def int_matmul_plain(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w.T`` of int8 operands, multiplied and summed in int64: exact,
    and the route of CPU tensors."""
    return (a.long() @ w.long().t()).to(torch.int32)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int_matmul_padded(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w.T`` through ``torch._int_mm``, with zero rows and columns added
    to meet its shape rules on a CUDA device (M > 16, K and N multiples of
    8).  Zero rows of ``a`` give rows the result drops, zero columns of both
    add nothing to any sum, zero rows of ``w`` give columns the result
    drops, so the int32 result is the unpadded product's.  The weight goes
    in as the transpose of a contiguous [N,K] (column-major [K,N]), the
    layout cuBLASLt's int8 product takes."""
    m, k = a.shape
    n = w.shape[0]
    mp, kp, np_ = max(m, 17), _round_up(k, 8), _round_up(n, 8)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (np_, kp) != (n, k):
        w = F.pad(w, (0, kp - k, 0, np_ - n))
    out = torch._int_mm(a.contiguous(), w.contiguous().t())
    return out[:m, :n]


def int_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The int32 product of the device: ``torch._int_mm`` on a card, the
    int64 plain route on the CPU."""
    if a.device.type == "cpu":
        return int_matmul_plain(a, w)
    return int_matmul_padded(a, w)


# ---------------------------------------------------------------------------
# The convolution: per-example activation x per-output-channel weight
# ---------------------------------------------------------------------------

def _pair(v) -> tuple[int, int]:
    if isinstance(v, str):
        raise ValueError(f"int8_conv2d takes explicit integer padding, got '{v}'")
    return (int(v), int(v)) if isinstance(v, int) else (int(v[0]), int(v[1]))


def im2col(q: torch.Tensor, kernel: tuple[int, int], stride, padding) -> torch.Tensor:
    """[B,C,H,W] (any memory format) -> [B, Ho, Wo, C*kh*kw] patches, the
    last axis in the order of a [O,C,kh,kw] weight's rows.  The gather runs
    on the NHWC view, which a channels_last tensor is without a copy; a 1x1
    stride-1 convolution takes no gather at all."""
    (kh, kw), (sh, sw), (ph, pw) = kernel, _pair(stride), _pair(padding)
    x = q.permute(0, 2, 3, 1)  # NHWC
    if ph or pw:
        x = F.pad(x, (0, 0, pw, pw, ph, ph))
    if (kh, kw, sh, sw) == (1, 1, 1, 1):
        return x
    # [B, Ho, Wo, C, kh, kw]: Tensor.unfold appends the window axis
    cols = x.unfold(1, kh, sh).unfold(2, kw, sw)
    b, ho, wo = cols.shape[:3]
    return cols.reshape(b, ho, wo, -1)


class _Int8Conv2d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, stride, padding):
        out_dtype = torch.promote_types(x.dtype, weight.dtype)
        qx, sx = quantize_symmetric(x, _batch_dims(x.ndim))   # sx [B,1,1,1]
        qw, sw = quantize_symmetric(weight, (1, 2, 3))          # sw [O,1,1,1]
        cols = im2col(qx, tuple(weight.shape[2:]), stride, padding)
        b, ho, wo, k = cols.shape
        acc = int_matmul(cols.reshape(-1, k), qw.reshape(qw.shape[0], -1))
        acc = acc.reshape(b, ho, wo, -1).permute(0, 3, 1, 2)  # NCHW, channels_last
        scale = sx * sw.reshape(1, -1, 1, 1)                    # [B,O,1,1]
        ctx.save_for_backward(x, weight)
        ctx.conv = (stride, padding)
        return (acc.float() * scale).to(out_dtype)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        stride, padding = ctx.conv
        out_dtype = torch.promote_types(x.dtype, weight.dtype)
        need_x, need_w = ctx.needs_input_grad[:2]
        gx, gw, _ = torch.ops.aten.convolution_backward(
            grad.to(out_dtype), x.to(out_dtype), weight.to(out_dtype), None,
            list(_pair(stride)), list(_pair(padding)), [1, 1], False, [0, 0], 1,
            [need_x, need_w, False])
        return (gx.to(x.dtype) if need_x else None,
                gw.to(weight.dtype) if need_w else None, None, None)


def int8_conv2d(x: torch.Tensor, weight: torch.Tensor, stride=1, padding=0,
                dilation=1, groups: int = 1) -> torch.Tensor:
    """``F.conv2d(x, weight)`` (no bias) with int8 operands and an int32 sum;
    its gradient is the float convolution's at the same point."""
    if int(groups) != 1:
        raise ValueError("int8_conv2d: grouped convolutions are not supported "
                         f"(groups={groups}); no family quantizes one")
    if _pair(dilation) != (1, 1):
        raise ValueError(f"int8_conv2d: dilation {dilation} is not supported")
    CALLS["conv"] += 1
    return _Int8Conv2d.apply(x, weight, _pair(stride), _pair(padding))


# ---------------------------------------------------------------------------
# The Dense product: the input's last axis against the weight's [N,K] rows
# ---------------------------------------------------------------------------

class _Int8Linear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight):
        out_dtype = torch.promote_types(x.dtype, weight.dtype)
        qx, sx = quantize_symmetric(x, _batch_dims(x.ndim))  # [B,1,...,1]
        qw, sw = quantize_symmetric(weight, (1,))              # [N,1]
        acc = int_matmul(qx.reshape(-1, x.shape[-1]), qw)
        acc = acc.reshape(*x.shape[:-1], -1)
        ctx.save_for_backward(x, weight)
        return (acc.float() * (sx * sw.reshape(-1))).to(out_dtype)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        out_dtype = torch.promote_types(x.dtype, weight.dtype)
        g, xd, wd = grad.to(out_dtype), x.to(out_dtype), weight.to(out_dtype)
        gx = (g @ wd).to(x.dtype) if ctx.needs_input_grad[0] else None
        gw = None
        if ctx.needs_input_grad[1]:
            gw = (g.reshape(-1, g.shape[-1]).t() @ xd.reshape(-1, x.shape[-1])).to(weight.dtype)
        return gx, gw


def int8_linear(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``F.linear(x, weight)`` (no bias) with int8 operands and an int32 sum:
    ``x`` [B, ..., K], ``weight`` [N, K]; the gradient is the float
    product's at the same point."""
    CALLS["linear"] += 1
    return _Int8Linear.apply(x, weight)


def linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
           int8: bool) -> torch.Tensor:
    """``F.linear``, or its int8 form with the bias added after the product."""
    if not int8:
        return F.linear(x, weight, bias)
    y = int8_linear(x, weight)
    return y if bias is None else y + bias.to(y.dtype)


# ---------------------------------------------------------------------------
# The layers the families build: torch's own, with the same parameter names
# ---------------------------------------------------------------------------

class QuantConv2d(nn.Conv2d):
    """``nn.Conv2d`` whose product runs in int8 (``int8_conv2d``); the same
    parameters, so state dicts and the weight bridge do not change."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.padding_mode != "zeros":
            raise ValueError("QuantConv2d: only zero padding is supported")
        y = int8_conv2d(x, self.weight, self.stride, self.padding, self.dilation, self.groups)
        return y if self.bias is None else y + self.bias.to(y.dtype).reshape(1, -1, 1, 1)


class QuantLinear(nn.Linear):
    """``nn.Linear`` whose product runs in int8 (``int8_linear``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight, self.bias, True)


def conv2d_class(int8: bool) -> type[nn.Conv2d]:
    """The conv layer a family builds: ``QuantConv2d`` in int8 mode."""
    return QuantConv2d if int8 else nn.Conv2d


def linear_class(int8: bool) -> type[nn.Linear]:
    """The Dense layer a family builds: ``QuantLinear`` in int8 mode."""
    return QuantLinear if int8 else nn.Linear
