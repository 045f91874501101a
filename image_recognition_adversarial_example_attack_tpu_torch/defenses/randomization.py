"""Randomization defense: random resize + pad at inference time (Xie et al.,
ICLR 2018; port of ``defenses/randomization.py``).

Each image is shrunk by a random factor and placed at a random offset on
its own fixed [H, W] canvas; the uncovered canvas reads ``pad_value``.  The
geometry is continuous, so one program serves every draw and the op is
differentiable: the adaptive attack is ``make_eot_logits_fn`` with
``resize_pad_transform`` and ``n_samples >= 8``, no BPDA needed.

The resampling is the JAX package's ``jax.image.scale_and_translate(...,
method="linear")``, which antialiases by default: where the scale is below
1 its triangle kernel widens by 1/scale, each output's weights are
normalized to sum to 1, and outputs whose sample falls outside
``[-0.5, in - 0.5]`` get no weight.  ``F.interpolate`` and ``F.grid_sample``
do neither, so the per-sample ``[B, out, in]`` weight matrices are built
here the same way (``weight_matrix``) and contracted with ``einsum``: one
matrix for the rows, one for the columns.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.rng import device_generator, uniform


def weight_matrix(in_size: int, out_size: int, scale: torch.Tensor,
                  translation: torch.Tensor) -> torch.Tensor:
    """[B, out, in] linear (triangle) resampling weights of one spatial axis
    for per-sample ``scale`` and ``translation`` [B], antialiased where the
    scale is below 1 (``jax._src.image.scale.compute_weight_mat``)."""
    dtype, dev = scale.dtype, scale.device
    inv_scale = (1.0 / scale)[:, None]
    kernel_scale = torch.clamp_min(inv_scale, 1.0)[:, :, None]
    sample_f = ((torch.arange(out_size, dtype=dtype, device=dev) + 0.5) * inv_scale
                - translation[:, None] * inv_scale - 0.5)                 # [B, out]
    src = torch.arange(in_size, dtype=dtype, device=dev)
    dist = torch.abs(sample_f[:, :, None] - src[None, None, :]) / kernel_scale  # [B,out,in]
    weights = torch.clamp_min(1.0 - torch.abs(dist), 0.0)
    total = torch.sum(weights, dim=2, keepdim=True)
    weights = torch.where(torch.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[:, :, None], weights, torch.zeros_like(weights))


def resize_pad(x: torch.Tensor, scales: torch.Tensor, off_y: torch.Tensor,
               off_x: torch.Tensor, *, pad_value: float = 0.5) -> torch.Tensor:
    """Per-sample scale + offset on the fixed canvas, ``x [B,H,W,C]``.

    Sample i is shrunk by ``scales[i]`` and its top-left corner placed at
    ``(off_y[i], off_x[i])`` in output pixels; the rest of the canvas reads
    ``pad_value``.  The resampling fills the outside with zeros and is
    linear in the image, so the pad value is folded in as
    ``st(x - pv) + pv``."""
    _, h, w, _ = x.shape
    pv = torch.as_tensor(pad_value, dtype=x.dtype, device=x.device)
    s = torch.as_tensor(scales, device=x.device).to(x.dtype)
    ty = torch.as_tensor(off_y, device=x.device).to(x.dtype)
    tx = torch.as_tensor(off_x, device=x.device).to(x.dtype)
    wy = weight_matrix(h, h, s, ty)
    wx = weight_matrix(w, w, s, tx)
    rows = torch.einsum("byh,bhwc->bywc", wy, x - pv)
    return torch.einsum("bxw,bywc->byxc", wx, rows) + pv


def draw_geometry(b: int, min_scale: float, generator: torch.Generator,
                  device: torch.device | str, dtype: torch.dtype = torch.float32):
    """One draw of the defense for ``b`` images, each [b] of ``dtype`` on
    ``device``: the scales, uniform over [min_scale, 1), and two uniforms
    in [0, 1) that place the shrunk image within the slack."""
    g = device_generator(generator, device)
    u = uniform((3, int(b)), g, device, axis=1).to(dtype)
    scales = min_scale + (1.0 - min_scale) * u[0]
    return scales, u[1], u[2]


def random_resize_pad(x: torch.Tensor, generator: torch.Generator, *,
                      min_scale: float = 0.857, pad_value: float = 0.5) -> torch.Tensor:
    """One random draw of the defense for a batch ``x [B,H,W,C]``: per
    sample, scale ~ U[min_scale, 1] and an offset uniform over the slack,
    so that the shrunk image lands fully on the canvas.  0.857 = 6/7, the
    paper's 299/331 outer pad on a 224 grid."""
    b, h, w, _ = x.shape
    scales, uy, ux = draw_geometry(b, min_scale, generator, x.device, x.dtype)
    off_y = uy * (1.0 - scales) * h
    off_x = ux * (1.0 - scales) * w
    return resize_pad(x, scales, off_y, off_x, pad_value=pad_value)


def resize_pad_transform(min_scale: float = 0.857, pad_value: float = 0.5):
    """The defense as an EOT transform ``(generator, x) -> x'`` for
    ``make_eot_logits_fn``: ``n_samples=1`` is the deployed randomized
    model, ``n_samples >= 8`` the adaptive attacker's expectation."""

    def transform(generator, x):
        return random_resize_pad(x, generator, min_scale=min_scale, pad_value=pad_value)

    return transform
