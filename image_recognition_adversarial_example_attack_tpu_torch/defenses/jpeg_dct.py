"""Device-side JPEG: the baseline DCT codec in PyTorch, differentiable (port
of ``defenses/jpeg_dct.py``).

RGB -> YCbCr, 4:2:0 chroma subsampling (2x2 mean), 8x8 blockwise orthonormal
DCT-II, Annex-K quantization tables with libjpeg's quality scaling,
quantize/dequantize with straight-through rounding (exact forward, identity
gradient), IDCT, triangular 2x chroma upsampling, YCbCr -> RGB.  Entropy
coding is lossless and left out.  Arbitrary H, W: edge-padded to a multiple
of 16 and cropped after.

The quality is an int (tables computed on the host, ``_quant_tables``) or a
0-d tensor (the same libjpeg scaling computed in float32 torch ops,
``_quant_tables_tensor``, the counterpart of the JAX package's traced
tables, which the corruption bank's jpeg_compression uses).  The block
transforms run in full float32 on the card: TF32 would cross the
rounding boundaries of the small quantization steps, so ``_blockwise``
refuses to run on a CUDA tensor while ``torch.backends.cuda.matmul.allow_tf32``
is set.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

# ITU-T T.81 Annex K base quantization tables (quality 50).
_LUMA_BASE = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99],
], np.float32)
_CHROMA_BASE = np.array([
    [17, 18, 24, 47, 99, 99, 99, 99],
    [18, 21, 26, 66, 99, 99, 99, 99],
    [24, 26, 56, 99, 99, 99, 99, 99],
    [47, 66, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
], np.float32)


@lru_cache(maxsize=None)
def _quant_tables(quality: int) -> tuple[np.ndarray, np.ndarray]:
    """libjpeg quality scaling: s=5000/q (q<50) else 200-2q; clamp 1..255."""
    q = int(np.clip(quality, 1, 100))
    s = 5000.0 / q if q < 50 else 200.0 - 2.0 * q

    def scale(base):
        return np.clip(np.floor((base * s + 50.0) / 100.0), 1.0, 255.0)

    return scale(_LUMA_BASE).astype(np.float32), scale(_CHROMA_BASE).astype(np.float32)


def _quant_tables_tensor(quality: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``_quant_tables`` for a tensor quality, in float32 on its device
    (``_quant_tables_traced`` of the JAX package).  Every division has a
    tensor divisor: PyTorch divides by a Python scalar as a multiplication
    by its reciprocal, which can move a value across a ``floor``."""
    q = torch.clamp(quality.to(torch.float32), 1.0, 100.0)

    def c(v: float) -> torch.Tensor:
        return torch.full((), v, dtype=torch.float32, device=q.device)

    s = torch.where(q < 50.0, c(5000.0) / q, 200.0 - 2.0 * q)

    def scale(base: np.ndarray) -> torch.Tensor:
        b = torch.from_numpy(base).to(q.device)
        return torch.clamp(torch.floor((b * s + 50.0) / c(100.0)), 1.0, 255.0)

    return scale(_LUMA_BASE), scale(_CHROMA_BASE)


@lru_cache(maxsize=None)
def _dct_matrix() -> np.ndarray:
    """Orthonormal 8-point DCT-II matrix D (DCT = D X D^T), float32 as in the
    JAX package, so that a float64 run uses the same rounded entries."""
    n = np.arange(8)
    k = n[:, None]
    d = np.cos((2 * n[None, :] + 1) * k * np.pi / 16.0)
    d[0, :] *= 1.0 / np.sqrt(2.0)
    return (d * np.sqrt(2.0 / 8.0)).astype(np.float32)


def _ste_round(v: torch.Tensor) -> torch.Tensor:
    """Exact rounding (half to even) forward, identity gradient backward."""
    return v + (torch.round(v) - v).detach()


def _blockwise(channel: torch.Tensor, table: np.ndarray | torch.Tensor) -> torch.Tensor:
    """[B,H,W] centered channel -> DCT -> quant/dequant -> IDCT."""
    if channel.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("jpeg_dct: the block transforms need full float32; "
                           "torch.backends.cuda.matmul.allow_tf32 is set")
    b, h, w = channel.shape
    d = torch.from_numpy(_dct_matrix()).to(device=channel.device, dtype=channel.dtype)
    x5 = channel.reshape(b, h // 8, 8, w // 8, 8)
    coef = torch.einsum("ij,bajck,lk->baicl", d, x5, d)
    t = torch.as_tensor(table).to(device=channel.device, dtype=channel.dtype)
    t = t[None, None, :, None, :]  # the block dims sit at axes 2 and 4
    coef = _ste_round(coef / t) * t
    x5 = torch.einsum("ij,baicl,lk->bajck", d, coef, d)
    return x5.reshape(b, h, w)


def _down2(c: torch.Tensor) -> torch.Tensor:
    """2x2 mean pool (4:2:0 chroma subsampling)."""
    b, h, w = c.shape
    return c.reshape(b, h // 2, 2, w // 2, 2).mean(dim=(2, 4))


def _up2(c: torch.Tensor) -> torch.Tensor:
    """Triangular 2x upsample: linear interpolation with 3/4-1/4 weights, as
    ``jax.image.resize(..., "linear")`` and libjpeg's 'fancy' upsampling."""
    b, h, w = c.shape
    return F.interpolate(c[:, None], size=(2 * h, 2 * w), mode="bilinear",
                         align_corners=False)[:, 0]


def jpeg_dct_roundtrip(x: torch.Tensor, quality: int | torch.Tensor = 75) -> torch.Tensor:
    """[B,H,W,3] in [0,1] -> baseline-JPEG-compressed batch in [0,1].

    ``quality``: an int (host tables) or a 0-d tensor (tables computed in
    torch, ``_quant_tables_tensor``)."""
    if x.ndim != 4 or x.shape[-1] != 3:
        raise ValueError(f"expected [B,H,W,3], got {tuple(x.shape)}")
    b, h, w, _ = x.shape
    ph, pw = (-h) % 16, (-w) % 16
    if ph or pw:  # edge padding: repeat the last row and column
        rows = torch.arange(h + ph, device=x.device).clamp_max(h - 1)
        cols = torch.arange(w + pw, device=x.device).clamp_max(w - 1)
        x = x[:, rows][:, :, cols]

    r, g, bl = [x[..., i] * 255.0 for i in range(3)]
    y = 0.299 * r + 0.587 * g + 0.114 * bl
    cb = 128.0 - 0.168736 * r - 0.331264 * g + 0.5 * bl
    cr = 128.0 + 0.5 * r - 0.418688 * g - 0.081312 * bl

    if isinstance(quality, torch.Tensor):
        luma_t, chroma_t = _quant_tables_tensor(quality)
    else:
        luma_t, chroma_t = _quant_tables(int(quality))
    y = _blockwise(y - 128.0, luma_t) + 128.0
    cb = _up2(_blockwise(_down2(cb) - 128.0, chroma_t) + 128.0)
    cr = _up2(_blockwise(_down2(cr) - 128.0, chroma_t) + 128.0)

    r = y + 1.402 * (cr - 128.0)
    g = y - 0.344136 * (cb - 128.0) - 0.714136 * (cr - 128.0)
    bl = y + 1.772 * (cb - 128.0)
    # a tensor divisor: PyTorch divides a CUDA tensor by a Python scalar as
    # a multiplication by its reciprocal
    out = torch.stack([r, g, bl], dim=-1) / torch.full((), 255.0, dtype=x.dtype, device=x.device)
    out = torch.clamp(out, 0.0, 1.0)
    return out[:, :h, :w, :]
