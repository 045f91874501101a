"""Preprocessing defenses (port of ``defenses/preprocess.py``).

- smoothing: 3x3 mean, stride 1, zero padding 1, divisor 9 everywhere;
- quantization: ``round(x * (levels-1)) / (levels-1)`` with levels=16, through
  the quantize kernel on a CUDA device, with a straight-through gradient;
- composite: clip -> smooth -> quantize -> clip.

The JPEG and TV arms are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..core.constants import QUANTIZATION_LEVELS
from ..kernels.elementwise import quantize


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
    quant_levels: int = QUANTIZATION_LEVELS
    use_jpeg: bool = False  # not ported yet: defend_input refuses it
    use_tv: bool = False  # not ported yet: defend_input refuses it


def defend_input(x: torch.Tensor, config: DefenseConfig = DefenseConfig()) -> torch.Tensor:
    """Composite defense: clip -> smooth -> quantize -> clip."""
    if config.use_tv:
        raise NotImplementedError("the TV defense is not ported yet")
    if config.use_jpeg:
        raise NotImplementedError("the JPEG defense is not ported yet")
    x01 = torch.clamp(x, 0.0, 1.0)
    x01 = defense_smoothing(x01)
    x01 = defense_quantization(x01, levels=config.quant_levels)
    return torch.clamp(x01, 0.0, 1.0)
