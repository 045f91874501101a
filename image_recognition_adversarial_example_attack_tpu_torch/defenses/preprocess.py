"""Preprocessing defenses (port of ``defenses/preprocess.py``).

- smoothing: 3x3 mean, stride 1, zero padding 1, divisor 9 everywhere;
- quantization: ``round(x * (levels-1)) / (levels-1)`` with levels=16, through
  the quantize kernel on a CUDA device, with a straight-through gradient;
- JPEG, optional: the PIL codec on the host (``jpeg.py``, the reference's
  round trip, behind a BPDA-identity gradient) or the differentiable DCT
  codec on the device (``jpeg_dct.py``);
- TV minimization, optional (``tv.py``), first in the chain;
- composite: clip -> (TV) -> smooth -> quantize -> (JPEG) -> clip.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..core.constants import JPEG_QUALITY, QUANTIZATION_LEVELS
from ..kernels.elementwise import quantize
from .jpeg import jpeg_compress_batch
from .jpeg_dct import jpeg_dct_roundtrip
from .tv import TV_STEPS, TV_WEIGHT, tv_minimize


def defense_smoothing(x: torch.Tensor) -> torch.Tensor:
    """3x3 mean filter on [B,H,W,C]: the JAX package's nine shifted adds in
    the same order, then one division by 9 (``F.avg_pool2d`` sums in another
    order and rounds differently)."""
    h, w = x.shape[1], x.shape[2]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    summed = xp[:, 0:h, 0:w, :]
    for dy in range(3):
        for dx in range(3):
            if dy == 0 and dx == 0:
                continue
            summed = summed + xp[:, dy:dy + h, dx:dx + w, :]
    # a tensor divisor: PyTorch divides a CUDA tensor by a Python scalar as
    # a multiplication by its reciprocal
    return summed / torch.full((), 9.0, dtype=x.dtype, device=x.device)


def defense_quantization(x: torch.Tensor, levels: int = QUANTIZATION_LEVELS) -> torch.Tensor:
    """Round pixels to ``levels`` uniform values in [0,1].

    The forward is the exact rounded value; the backward is the identity
    (straight-through), written as ``x01 + (q - x01).detach()`` exactly as
    the JAX package writes it, whose bits can differ from ``q`` alone.
    """
    x01 = torch.clamp(x, 0.0, 1.0)
    q = quantize(x01.detach().contiguous(), levels)
    return x01 + (q - x01).detach()


@dataclass(frozen=True)
class DefenseConfig:
    use_jpeg: bool = False
    jpeg_quality: int = JPEG_QUALITY
    quant_levels: int = QUANTIZATION_LEVELS
    # 'host' = the reference's PIL codec, one host round trip per batch;
    # 'dct' = the differentiable DCT codec on the device (jpeg_dct.py)
    jpeg_mode: str = "host"
    use_tv: bool = False  # TV minimization (tv.py), first in the chain
    tv_weight: float = TV_WEIGHT
    tv_steps: int = TV_STEPS


def defend_input(x: torch.Tensor, config: DefenseConfig = DefenseConfig()) -> torch.Tensor:
    """Composite defense: clip -> (TV) -> smooth -> quantize -> (JPEG) -> clip."""
    x01 = torch.clamp(x, 0.0, 1.0)
    if config.use_tv:
        x01 = tv_minimize(x01, weight=config.tv_weight, steps=config.tv_steps)
    x01 = defense_smoothing(x01)
    x01 = defense_quantization(x01, levels=config.quant_levels)
    if config.use_jpeg:
        if config.jpeg_mode == "dct":
            x01 = jpeg_dct_roundtrip(x01, quality=config.jpeg_quality)
        elif config.jpeg_mode == "host":
            # BPDA-identity: the exact codec forward, the identity backward;
            # the codec sees a detached input, so no gradient reaches it
            x_sg = x01.detach()
            x01 = x01 + (jpeg_compress_batch(x_sg, quality=config.jpeg_quality) - x_sg).detach()
        else:
            raise ValueError(f"unknown jpeg_mode '{config.jpeg_mode}'")
    return torch.clamp(x01, 0.0, 1.0)
