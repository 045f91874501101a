"""Mahalanobis-distance adversarial detector (port of
``defenses/mahalanobis.py``; Lee et al., NeurIPS 2018).

Class-conditional Gaussians with a TIED covariance on the spatially pooled
stage-3 features; a sample's score is its Mahalanobis distance to the
NEAREST class centroid.

The fit runs in float32 (float64 inputs stay float64): the JAX package
contracts at HIGHEST precision, and TF32, which ``load_model`` turns off,
stays off.  The covariance gets a ridge of ``shrinkage * (tr/C + 1e-6)`` so
that the fit stays well-posed when the calibration set is smaller than the
feature width (100 images against 1024 channels); a class with no samples
takes the global mean.  The precision matrix is a Cholesky solve against
the identity.  The score keeps the direct form ``diff^T P diff`` over all K
centroids: the expanded ``z^T P z - 2 z^T P mu + mu^T P mu`` cancels badly
when N < C.  At B = 128, K = 1000, C = 1024 its ``[B,K,C]`` float32
intermediates take 0.5 GB each.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .detector import FeaturesFn, _f32


class MahalanobisParams(NamedTuple):
    mean: torch.Tensor       # [K, C] class centroids
    precision: torch.Tensor  # [C, C] shared inverse covariance


def pool_features(feats: torch.Tensor) -> torch.Tensor:
    """NHWC maps are spatially mean-pooled; [B,K] vectors pass through."""
    if feats.ndim == 4:
        return torch.mean(feats, dim=(1, 2))
    return feats.reshape(feats.shape[0], -1)


def fit_mahalanobis(feats: torch.Tensor, labels: torch.Tensor, num_classes: int,
                    shrinkage: float = 0.05) -> MahalanobisParams:
    """Tied-covariance class Gaussians from pooled features [N, C]."""
    dtype = torch.promote_types(feats.dtype, torch.float32)
    feats = feats.to(dtype)
    labels = labels.long()
    n, c = feats.shape
    onehot = F.one_hot(labels, num_classes).to(dtype)                # [N,K]
    counts = onehot.sum(dim=0)                                      # [K]
    mean = (onehot.T @ feats) / torch.clamp(counts, min=1.0)[:, None]
    global_mean = feats.mean(dim=0)
    mean = torch.where((counts > 0)[:, None], mean, global_mean[None, :])

    centered = feats - mean[labels]                                 # [N,C]
    cov = (centered.T @ centered) / max(float(n), 1.0)
    ridge = shrinkage * (torch.trace(cov) / c + 1e-6)
    eye = torch.eye(c, dtype=dtype, device=feats.device)
    chol = torch.linalg.cholesky(cov + ridge * eye)
    precision = torch.cholesky_solve(eye, chol)
    return MahalanobisParams(mean=mean, precision=precision)


def mahalanobis_score_from_features(feats: torch.Tensor,
                                    params: MahalanobisParams) -> torch.Tensor:
    """[B,...] features -> [B] distance to the nearest class centroid."""
    z = pool_features(feats)                                   # [B,C]
    diff = z[:, None, :] - params.mean[None, :, :]             # [B,K,C]
    d = torch.sum((diff @ params.precision) * diff, dim=-1)    # [B,K]
    return torch.clamp(d, min=0.0).min(dim=-1).values


def mahalanobis_score(features_fn: FeaturesFn, x: torch.Tensor,
                      params: MahalanobisParams) -> torch.Tensor:
    return mahalanobis_score_from_features(features_fn(x), params)


def is_adversarial_by_mahalanobis(features_fn: FeaturesFn, x: torch.Tensor,
                                  params: MahalanobisParams, threshold) -> torch.Tensor:
    """[B] bool, True where flagged as adversarial."""
    score = mahalanobis_score(features_fn, x, params)
    return score > _f32(threshold, score)


def calibrate_mahalanobis(features_fn: FeaturesFn, x_clean: torch.Tensor,
                          labels: torch.Tensor, num_classes: int, n: int = 100,
                          quantile: float = 0.95, shrinkage: float = 0.05
                          ) -> tuple[MahalanobisParams, float]:
    """Fit on (up to n of) a clean batch and its labels (the grid CLI passes
    the clean predictions), then threshold at the q-quantile (linear) of
    the clean scores."""
    num = min(int(n), x_clean.shape[0])
    if num <= 0:
        raise ValueError("no calibration images available")
    with torch.no_grad():
        z = pool_features(features_fn(x_clean[:num]))
        params = fit_mahalanobis(z, labels[:num], num_classes, shrinkage)
        scores = mahalanobis_score_from_features(z, params)
    return params, float(torch.quantile(scores, quantile))
