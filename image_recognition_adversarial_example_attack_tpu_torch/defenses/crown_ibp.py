"""CROWN-IBP: tighter deterministic L∞ certificates (Zhang et al., ICLR 2020;
port of ``defenses/crown_ibp.py``).

Pure interval propagation (``defenses/ibp.py``) bounds every logit on its
own, so ``lo_y - max hi_j`` counts the shared input uncertainty twice.
CROWN-IBP keeps IBP's intermediate bounds but lower-bounds each margin
``z_y - z_j`` with ONE backward pass of linear coefficients: every ReLU is
replaced by its linear relaxation on the interval its input lives in, and
the surviving linear function is minimized exactly over the input box.

The margin specs ride a leading axis of size n_classes folded into the
batch, so each layer's backward step is one batched product: a dense
layer's transpose, or a conv's adjoint (``conv_same_adjoint``: the
transposed conv of the explicitly SAME-padded forward, cropped by the pad,
the counterpart of JAX's ``jax.vjp`` of the forward conv).  The result is
the per-spec maximum of the CROWN and the IBP bound, both sound, so it is
never worse than ``--method ibp``.  Float32 with TF32 off, as in
``defenses/ibp.py``; the bounds entering each layer (``interval_trace``)
are kept in the port's NCHW layout.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F

from ..core.normalize import normalize_batch
from ..models.ibp import same_pads
from .ibp import (_weights, bound_dtype, interval_layer, interval_trace, pixel_bounds,
                  spec_forward)


def conv_same_adjoint(a: torch.Tensor, weight: torch.Tensor, stride: int,
                      in_hw: tuple[int, int]) -> torch.Tensor:
    """The adjoint of ``models.ibp.conv_same`` (without bias) at an input of
    ``in_hw`` pixels: ``<conv_same(x), a> == <x, conv_same_adjoint(a)>``.
    The transposed conv gives the padded input's cotangent; the pad is
    cropped off."""
    h, w = in_hw
    k = weight.shape[-1]
    top, bottom = same_pads(h, k, stride)
    left, right = same_pads(w, k, stride)
    ho, wo = a.shape[-2:]
    extra = (h + top + bottom - ((ho - 1) * stride + k),
             w + left + right - ((wo - 1) * stride + k))
    full = F.conv_transpose2d(a, weight, stride=stride, output_padding=extra)
    return full[:, :, top:top + h, left:left + w]


def _relu_relaxation(l: torch.Tensor, u: torch.Tensor):
    """Per-neuron linear ReLU relaxation on the pre-activation box [l, u].

    upper: relu(x) <= up_slope * x + up_intercept (the chord);
    lower: relu(x) >= low_slope * x (identity where the box leans positive,
    zero otherwise).  Stable neurons are exact: identity for l >= 0, zero
    for u <= 0."""
    crossing = (l < 0.0) & (u > 0.0)
    one, zero = torch.ones_like(l), torch.zeros_like(l)
    denom = torch.where(crossing, u - l, one)  # read only where crossing
    up_slope = torch.where(l >= 0.0, one, torch.where(crossing, u / denom, zero))
    up_intercept = torch.where(crossing, -l * u / denom, zero)
    low_slope = torch.where(l >= 0.0, one,
                            torch.where(crossing, (u >= -l).to(l.dtype), zero))
    return up_slope, up_intercept, low_slope


def crown_backward_bound(params: Mapping, spec: tuple, pre: list, A: torch.Tensor,
                         bias: torch.Tensor) -> torch.Tensor:
    """Sound lower bounds [B, S] of the linear functionals ``A @ logits +
    bias`` (``A`` [B, S, n_out]) over the input box, by one CROWN backward
    pass over ``pre`` from ``interval_trace``."""
    b_sz, s_sz = A.shape[0], A.shape[1]
    for i in reversed(range(len(spec))):
        layer = spec[i]
        kind = layer[0]
        lo_i, hi_i = pre[i]
        if kind == "dense":
            w, b = _weights(params, f"dense_{i}", A.dtype)  # w: [out, in]
            bias = bias + torch.einsum("bso,o->bs", A, b)
            A = torch.einsum("bso,oi->bsi", A, w)
        elif kind == "relu":
            up_s, up_i, low_s = (t[:, None] for t in _relu_relaxation(lo_i, hi_i))
            reduce = tuple(range(2, A.ndim))
            bias = bias + torch.sum(torch.clamp_max(A, 0.0) * up_i, dim=reduce)
            A = torch.where(A >= 0.0, A * low_s, A * up_s)
        elif kind == "flatten":
            c, h, w_ = lo_i.shape[1:]
            # the forward flattened NHWC
            A = A.reshape(b_sz, s_sz, h, w_, c).permute(0, 1, 4, 2, 3)
        elif kind == "conv":
            w, b = _weights(params, f"conv_{i}", A.dtype)
            bias = bias + torch.einsum("bschw,c->bs", A, b)
            # one transposed conv for every spec: the spec axis folds into the batch
            a_in = conv_same_adjoint(A.reshape(b_sz * s_sz, *A.shape[2:]), w, layer[3],
                                     tuple(lo_i.shape[2:]))
            A = a_in.reshape(b_sz, s_sz, *lo_i.shape[1:])
        else:
            raise ValueError(f"unknown IBP layer kind '{kind}'")

    # the exact minimum of the surviving linear function over the input box
    lo0, hi0 = pre[0]
    mid, rad = (hi0 + lo0) / 2.0, (hi0 - lo0) / 2.0
    reduce = tuple(range(2, A.ndim))
    return (bias + torch.sum(A * mid[:, None], dim=reduce)
            - torch.sum(torch.abs(A) * rad[:, None], dim=reduce))


def margin_spec_bounds(params: Mapping, spec: tuple, x01: torch.Tensor, y: torch.Tensor,
                       eps, mean, std) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-spec sound lower bounds on ``z_y - z_j`` over the eps-ball:
    ``(crown, ibp)``, each [B, n_classes], column y exactly 0 in both."""
    lo0, hi0 = pixel_bounds(x01, eps, mean, std)
    pre = interval_trace(params, spec, lo0, hi0)
    dt = lo0.dtype
    n = spec[-1][1]  # the last layer is dense(num_classes)
    yl = y.long()
    onehot = F.one_hot(yl, n).to(dt)
    # spec rows c_j = e_y - e_j (row y is the zero functional: bound 0)
    A0 = onehot[:, None, :] - torch.eye(n, dtype=dt, device=x01.device)[None]
    bias0 = torch.zeros((x01.shape[0], n), dtype=dt, device=x01.device)
    crown = crown_backward_bound(params, spec, pre, A0, bias0)

    # plain IBP per spec: the trace's last interval through the last dense
    lo_log, hi_log = interval_layer(params, spec[-1], len(spec) - 1, *pre[-1])
    lo_y = torch.gather(lo_log, -1, yl[:, None])  # [B, 1]
    ibp = torch.where(onehot.bool(), torch.zeros_like(hi_log), lo_y - hi_log)
    return crown, ibp


def crown_ibp_margin(params: Mapping, spec: tuple, x01: torch.Tensor, y: torch.Tensor,
                     eps, mean, std) -> torch.Tensor:
    """[B] sound lower bound on ``min_{j != y} (z_y - z_j)`` over the
    eps-ball, positive iff the label is PROVABLY the argmax: per spec the
    larger of the CROWN and the IBP bound."""
    crown, ibp = margin_spec_bounds(params, spec, x01, y, eps, mean, std)
    mask = F.one_hot(y.long(), crown.shape[-1]).bool()
    margins = torch.maximum(crown, ibp)
    return torch.min(torch.where(mask, torch.full_like(margins, torch.inf), margins),
                     dim=-1).values


def make_crown_verify_fn(params: Mapping, spec: tuple, mean, std):
    """(x01, y, eps) -> {verified, correct, margin}: the CROWN-IBP
    counterpart of ``ibp.make_verify_fn``."""

    def verify(x01: torch.Tensor, y: torch.Tensor, eps) -> dict:
        with torch.no_grad():
            margin = crown_ibp_margin(params, spec, x01, y, eps, mean, std)
            clean = spec_forward(params, spec, normalize_batch(
                x01.to(bound_dtype(x01)), mean, std))
        return {"verified": margin > 0.0,
                "correct": torch.argmax(clean, dim=-1) == y,
                "margin": margin}

    return verify
