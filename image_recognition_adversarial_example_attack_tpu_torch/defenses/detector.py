"""Feature-statistics and feature-squeezing adversarial detectors + their
quantile calibration (port of ``defenses/detector.py``).

On the ResNet stage-3 (``layer3``) feature map:

  score = sqrt(sum_{H,W,C} f^2) / C  +  0.1 * mean_C( var_{H,W}(f) )
  clipped to [0, 100]

with the unbiased (ddof=1) variance.  Flag rule: ``score > threshold``.
Calibration takes the q-quantile of clean scores (linear interpolation),
halves it if above 50 and floors it at 1.0.

The squeezing detector (Xu, Evans & Qi, NDSS 2018) scores the largest L1
distance between the softmax on the input and on each squeezed input, the
squeezers being the preprocessing defenses: 16-level quantization (the
quantize kernel on a CUDA device, with a straight-through gradient) and the
3x3 mean filter.  Its threshold is the plain linear q-quantile, no rails.

A threshold is compared as a float32 value, as the JAX package does.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

FeaturesFn = Callable[[torch.Tensor], torch.Tensor]  # x01 [B,H,W,3] -> [B,h,w,C]


def make_features_fn(model: nn.Module, mean, std,
                     input_dtype: torch.dtype | None = None) -> FeaturesFn:
    """x in [0,1], NHWC -> stage-3 feature map, NHWC float32.

    A model without ``features_stage3`` (the IBP nets) gives its plain
    forward, the logits [B,K], as the JAX package's does;
    ``score_from_features`` takes both ranks."""
    from ..attacks.api import make_logits_fn

    if not hasattr(model, "features_stage3"):
        return make_logits_fn(model, mean, std, input_dtype=input_dtype)
    stage3 = make_logits_fn(model, mean, std, input_dtype=input_dtype,
                            method="features_stage3")
    return lambda x01: stage3(x01).permute(0, 2, 3, 1)


def score_from_features(feats: torch.Tensor) -> torch.Tensor:
    """Detector score per sample of an NHWC feature map [B, H, W, C]; of
    logits [B, K] (a model without a stage-3 split), their L2 norm."""
    if feats.ndim == 4:
        channels = feats.shape[-1]
        feat_l2 = torch.sqrt(torch.sum(torch.square(feats), dim=(1, 2, 3))) / channels
        # unbiased variance over the spatial dims per channel, then the channel mean
        feat_var = torch.mean(torch.var(feats, dim=(1, 2), correction=1), dim=-1)
        score = feat_l2 + 0.1 * feat_var
    else:
        score = torch.linalg.vector_norm(feats.reshape(feats.shape[0], -1), dim=-1)
    return torch.clamp(score, 0.0, 100.0)


def feature_score(features_fn: FeaturesFn, x: torch.Tensor) -> torch.Tensor:
    return score_from_features(features_fn(x))


def _f32(threshold, like: torch.Tensor) -> torch.Tensor:
    """The threshold as a 0-d float32 tensor on ``like``'s device."""
    return torch.tensor(float(threshold), dtype=torch.float32, device=like.device)


def is_adversarial_by_feature(features_fn: FeaturesFn, x: torch.Tensor,
                              threshold) -> torch.Tensor:
    """[B] bool, True where flagged as adversarial."""
    score = feature_score(features_fn, x)
    return score > _f32(threshold, score)


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


def squeezing_score(logits_fn, x: torch.Tensor, quant_levels: int = 16) -> torch.Tensor:
    """[B] max over the two squeezers of ``sum_K |softmax(f(x)) -
    softmax(f(squeeze(x)))|``: three model forwards, one quantize launch on
    a CUDA device.  Differentiable (the quantization's gradient is the
    straight-through identity), so a detector-aware attack can ascend it."""
    from .preprocess import defense_quantization, defense_smoothing

    p_raw = torch.softmax(logits_fn(x), dim=-1)
    p_quant = torch.softmax(logits_fn(defense_quantization(x, quant_levels)), dim=-1)
    p_smooth = torch.softmax(logits_fn(defense_smoothing(x)), dim=-1)
    d_quant = torch.sum(torch.abs(p_raw - p_quant), dim=-1)
    d_smooth = torch.sum(torch.abs(p_raw - p_smooth), dim=-1)
    return torch.maximum(d_quant, d_smooth)


def is_adversarial_by_squeezing(logits_fn, x: torch.Tensor, threshold,
                                quant_levels: int = 16) -> torch.Tensor:
    """[B] bool, True where flagged as adversarial."""
    score = squeezing_score(logits_fn, x, quant_levels)
    return score > _f32(threshold, score)


def calibrate_squeezing_threshold(logits_fn, x_clean: torch.Tensor, n: int = 100,
                                  quantile: float = 0.95,
                                  quant_levels: int = 16) -> float:
    """The q-quantile (linear) of the squeezing scores of (up to n of) a
    clean batch, in one batched pass."""
    num = min(int(n), x_clean.shape[0])
    if num <= 0:
        raise ValueError("no calibration images available")
    with torch.no_grad():
        scores = squeezing_score(logits_fn, x_clean[:num], quant_levels)
    return float(torch.quantile(scores, quantile))
