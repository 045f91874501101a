"""Feature-statistics adversarial detector + quantile calibration (port of
``defenses/detector.py``; the squeezing detector is not ported yet).

On the ResNet stage-3 (``layer3``) feature map:

  score = sqrt(sum_{H,W,C} f^2) / C  +  0.1 * mean_C( var_{H,W}(f) )
  clipped to [0, 100]

with the unbiased (ddof=1) variance.  Flag rule: ``score > threshold``.
Calibration takes the q-quantile of clean scores (linear interpolation),
halves it if above 50 and floors it at 1.0.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

FeaturesFn = Callable[[torch.Tensor], torch.Tensor]  # x01 [B,H,W,3] -> [B,h,w,C]


def make_features_fn(model: nn.Module, mean, std,
                     input_dtype: torch.dtype | None = None) -> FeaturesFn:
    """x in [0,1], NHWC -> stage-3 feature map, NHWC float32."""
    from ..attacks.api import make_logits_fn

    stage3 = make_logits_fn(model, mean, std, input_dtype=input_dtype,
                            method="features_stage3")
    return lambda x01: stage3(x01).permute(0, 2, 3, 1)


def score_from_features(feats: torch.Tensor) -> torch.Tensor:
    """Detector score per sample of an NHWC feature map [B, H, W, C]."""
    if feats.ndim != 4:
        raise ValueError(f"expected an NHWC feature map, got shape {tuple(feats.shape)}")
    channels = feats.shape[-1]
    feat_l2 = torch.sqrt(torch.sum(torch.square(feats), dim=(1, 2, 3))) / channels
    # unbiased variance over the spatial dims per channel, then the channel mean
    feat_var = torch.mean(torch.var(feats, dim=(1, 2), correction=1), dim=-1)
    return torch.clamp(feat_l2 + 0.1 * feat_var, 0.0, 100.0)


def feature_score(features_fn: FeaturesFn, x: torch.Tensor) -> torch.Tensor:
    return score_from_features(features_fn(x))


def threshold_from_scores(scores: torch.Tensor, quantile: float = 0.95) -> float:
    """Quantile (linear, as ``jnp.quantile``) + the sanity rails (halve
    above 50, floor at 1.0)."""
    thr = float(torch.quantile(scores, quantile))
    if thr > 50.0:
        return thr * 0.5
    return max(thr, 1.0)


def calibrate_feature_threshold(features_fn: FeaturesFn, x_clean: torch.Tensor,
                                n: int = 100, quantile: float = 0.95,
                                verbose: bool = True) -> float:
    """Calibrate on (up to n of) a clean batch, in one batched forward."""
    num = min(int(n), x_clean.shape[0])
    if num <= 0:
        raise ValueError("no calibration images available")
    with torch.no_grad():
        scores = feature_score(features_fn, x_clean[:num])
    if verbose:
        print(f"Calibrating detector threshold on {num} clean images...")
        print("Calibration stats:")
        print(f"  score range: {float(scores.min()):.4f} ~ {float(scores.max()):.4f}")
        print(f"  mean: {float(scores.mean()):.4f}")
        # jnp.median averages the two middle values; torch.median does not
        print(f"  median: {float(torch.quantile(scores, 0.5)):.4f}")
    thr = threshold_from_scores(scores, quantile)
    if verbose:
        print(f"  {quantile * 100:.0f}% quantile (threshold): {thr:.4f}")
    return thr
