"""JPEG-compression defense through the PIL codec on the host (port of
``defenses/jpeg.py``).

JPEG encoding has no device counterpart, and the JAX package keeps the
reference's per-image PIL round trip as a host stage (``io_callback``).  The
port does the same: a CUDA batch is copied to the host, each image goes
through PIL at ``quality``, and the result is copied back.  That copy is the
JAX package's own host stage, made on purpose, not a fallback from the card;
the device-side codec is ``jpeg_dct.py`` (``DefenseConfig(jpeg_mode="dct")``).
"""

from __future__ import annotations

import io

import numpy as np
import torch
from PIL import Image

from ..core.constants import JPEG_QUALITY


def jpeg_roundtrip_host(x: np.ndarray, quality: int) -> np.ndarray:
    """[B,H,W,C] float32 in [0,1] -> same, through PIL JPEG at ``quality``:
    ``round(x*255)`` to uint8, encode, decode, /255."""
    q = int(quality)
    x = np.clip(np.asarray(x, dtype=np.float32), 0.0, 1.0)
    out = np.empty_like(x)
    for i in range(x.shape[0]):
        img = Image.fromarray(np.round(x[i] * 255.0).astype(np.uint8))
        buf = io.BytesIO()
        img.save(buf, format="JPEG", quality=q)
        buf.seek(0)
        decoded = Image.open(buf).convert("RGB")
        out[i] = np.asarray(decoded, dtype=np.float32) / 255.0
    return out


def jpeg_compress_batch(x: torch.Tensor, quality: int = JPEG_QUALITY) -> torch.Tensor:
    """The JPEG round trip of a batch on any device, in x's dtype, in [0,1]."""
    host = jpeg_roundtrip_host(x.detach().float().cpu().numpy(), quality)
    out = torch.from_numpy(host).to(device=x.device, dtype=x.dtype)
    return torch.clamp(out, 0.0, 1.0)
