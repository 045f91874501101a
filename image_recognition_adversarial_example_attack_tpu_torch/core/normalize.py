"""Pixel-space <-> model-space normalization (port of ``core/normalize.py``).

Images live in [0,1] pixel space everywhere; ImageNet normalization is
applied only immediately before each model forward.  The layout at every
public function is NHWC, as in the JAX package.
"""

from __future__ import annotations

import torch

from .constants import IMAGENET_MEAN, IMAGENET_STD


def normalize_batch(x: torch.Tensor, mean, std) -> torch.Tensor:
    """(x - mean) / std over the last (channel) axis, in x's dtype.

    ``mean``/``std`` are length-C sequences; they are cast to ``x``'s dtype
    first, as ``jnp.asarray(mean, dtype=x.dtype)`` does.
    """
    mean = torch.as_tensor(mean, dtype=x.dtype, device=x.device)
    std = torch.as_tensor(std, dtype=x.dtype, device=x.device)
    if mean.ndim != 1 or std.ndim != 1:
        raise ValueError("mean/std must be 1D arrays with shape [C]")
    return (x - mean) / std


def normalizer(mean=IMAGENET_MEAN, std=IMAGENET_STD):
    """A closure ``x01 -> normalized`` over ``mean``/``std``; with mean 0
    and std 1 it is the identity path of the robust models."""

    def apply(x: torch.Tensor) -> torch.Tensor:
        return normalize_batch(x, mean, std)

    return apply
