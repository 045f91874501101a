"""Interval bound propagation: deterministic L∞ certificates (Gowal et al.
2018; port of ``defenses/ibp.py``).

Closed-form bounds on every logit over the whole eps-ball of an IBP net
(``models/ibp.py``).  The propagator walks the same ``spec`` tuple that
builds the network and reads its layers by their ``conv_{i}`` /
``dense_{i}`` names (``models.ibp.ibp_params``), so the forward pass and
the certificate cannot drift apart.

An interval forward is two real forwards: the midpoint through W and the
radius through |W|.  Both run in float32 with TF32 off, where the JAX
package runs them at ``Precision.HIGHEST``: the bounds subtract nearly
equal quantities, and a TF32 product can understate a radius and void the
certificate.  ``load_model`` turns TF32 off; on CUDA tensors these
functions refuse to run while it is on (``require_full_float32``).

The arithmetic is float32, as in the JAX package, or float64 where the
input is float64 (``bound_dtype``).  The public functions take and return NHWC
tensors, as the JAX package's do; inside, the convs run NCHW and
``flatten`` reads NHWC order.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F

from ..core.device import require_full_float32
from ..core.normalize import normalize_batch
from ..models.ibp import conv_same, flatten_nhwc, spec_apply


def bound_dtype(t: torch.Tensor) -> torch.dtype:
    """The dtype of the bound arithmetic: float64 for a float64 input,
    float32 otherwise."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _weights(params: Mapping, name: str, dtype: torch.dtype
             ) -> tuple[torch.Tensor, torch.Tensor]:
    m = params[name]
    return m.weight.to(dtype), m.bias.to(dtype)


def _nchw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 3, 1, 2) if t.ndim == 4 else t


def interval_layer(params: Mapping, layer: tuple, i: int, lo: torch.Tensor,
                   hi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Bounds out of layer ``i`` of a spec from NCHW (or flat) bounds in."""
    kind = layer[0]
    if kind == "conv":
        w, b = _weights(params, f"conv_{i}", lo.dtype)
        mid, rad = (hi + lo) / 2, (hi - lo) / 2
        mid = conv_same(mid, w, b, layer[3])
        rad = conv_same(rad, torch.abs(w), None, layer[3])
        return mid - rad, mid + rad
    if kind == "relu":
        return torch.clamp_min(lo, 0.0), torch.clamp_min(hi, 0.0)
    if kind == "flatten":
        return flatten_nhwc(lo), flatten_nhwc(hi)
    if kind == "dense":
        w, b = _weights(params, f"dense_{i}", lo.dtype)
        mid, rad = (hi + lo) / 2, (hi - lo) / 2
        mid, rad = F.linear(mid, w, b), F.linear(rad, torch.abs(w))
        return mid - rad, mid + rad
    raise ValueError(f"unknown IBP layer kind '{kind}'")


def interval_trace(params: Mapping, spec: tuple, lo: torch.Tensor, hi: torch.Tensor) -> list:
    """IBP forward from NHWC model-space bounds, recording the bounds
    ENTERING each layer: ``pre[i] = (lo_i, hi_i)`` (NCHW before the
    flatten, flat after).  CROWN-IBP reads them all; ``interval_propagate``
    the last."""
    require_full_float32(lo, "interval bounds")
    dt = bound_dtype(lo)
    lo, hi = _nchw(lo.to(dt)), _nchw(hi.to(dt))
    pre = []
    for i, layer in enumerate(spec):
        pre.append((lo, hi))
        lo, hi = interval_layer(params, layer, i, lo, hi)
    return pre


def interval_propagate(params: Mapping, spec: tuple, lo: torch.Tensor, hi: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Propagate elementwise model-space bounds ``lo <= x <= hi`` (NHWC)
    through ``spec``: (lo_logits, hi_logits), sound per-class bounds over
    the whole input box.  ``params`` is ``models.ibp.ibp_params(model)``
    of an IBPNet with the same spec."""
    pre = interval_trace(params, spec, lo, hi)
    return interval_layer(params, spec[-1], len(spec) - 1, *pre[-1])


def pixel_bounds(x01: torch.Tensor, eps, mean, std) -> tuple[torch.Tensor, torch.Tensor]:
    """Model-space bounds of the L∞ eps-ball around [0,1] pixels (NHWC): the
    ball is intersected with the pixel box first, then both ends pass
    through the per-channel normalization (monotone, std > 0)."""
    dt = bound_dtype(x01)
    lo = torch.clamp(x01 - eps, 0.0, 1.0)
    hi = torch.clamp(x01 + eps, 0.0, 1.0)
    return normalize_batch(lo.to(dt), mean, std), normalize_batch(hi.to(dt), mean, std)


def logit_bounds(params: Mapping, spec: tuple, x01: torch.Tensor, eps, mean, std
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sound logit bounds for the eps-ball around a [0,1] pixel batch."""
    lo, hi = pixel_bounds(x01, eps, mean, std)
    return interval_propagate(params, spec, lo, hi)


def spec_forward(params: Mapping, spec: tuple, x_norm: torch.Tensor) -> torch.Tensor:
    """Plain float32 forward through ``spec`` of a normalized NHWC batch
    (the zero-radius interval at half the cost)."""
    require_full_float32(x_norm, "interval bounds")
    return spec_apply(params, spec, _nchw(x_norm.to(bound_dtype(x_norm))))


def worst_case_logits(lo_logits: torch.Tensor, hi_logits: torch.Tensor,
                      y: torch.Tensor) -> torch.Tensor:
    """The certification adversary's logits: the lower bound at the true
    class, the upper bound everywhere else (Gowal et al. 2018, eq. 6)."""
    true = F.one_hot(y.long(), lo_logits.shape[-1]).bool()
    return torch.where(true, lo_logits, hi_logits)


def verified_margin(lo_logits: torch.Tensor, hi_logits: torch.Tensor,
                    y: torch.Tensor) -> torch.Tensor:
    """min_{j != y} (lo_y - hi_j): positive iff the label is PROVABLY the
    argmax over the whole ball."""
    true = F.one_hot(y.long(), lo_logits.shape[-1]).bool()
    worst_other = torch.max(torch.where(true, torch.full_like(hi_logits, -torch.inf),
                                        hi_logits), dim=-1).values
    lo_true = torch.gather(lo_logits, -1, y.long()[:, None])[:, 0]
    return lo_true - worst_other


def make_verify_fn(params: Mapping, spec: tuple, mean, std):
    """(x01, y, eps) -> {verified, correct, margin}; ``verified`` implies
    ``correct`` (eps >= 0 puts the clean point inside its own ball)."""

    def verify(x01: torch.Tensor, y: torch.Tensor, eps) -> dict:
        with torch.no_grad():
            lo, hi = logit_bounds(params, spec, x01, eps, mean, std)
            clean = spec_forward(params, spec, normalize_batch(
                x01.to(bound_dtype(x01)), mean, std))
            margin = verified_margin(lo, hi, y)
        return {"verified": margin > 0.0,
                "correct": torch.argmax(clean, dim=-1) == y,
                "margin": margin}

    return verify
