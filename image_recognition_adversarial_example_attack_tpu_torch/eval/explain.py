"""Grad-CAM attention maps for adversarial analysis (port of
``eval/explain.py``).

Selvaraju et al. 2017: with A the last conv activation map [B,C,h,w] and
s_y the logit of class y,

    w_c  = mean_{h,w} ( d s_y / d A_c )         (global-average-pooled grads)
    CAM  = relu( sum_c w_c * A_c )              [B,h,w]

normalized per sample to [0,1] by its max (an all-zero map stays zero).
``cam_shift_iou`` measures how far an attack moved the model's evidence.

The forward is split at the tap by the model's ``features_last`` /
``head_from_features`` (ResNet's, WideResNet's and PreActResNet's): the
features are computed once without a graph, in float32 as the JAX package's
closure returns them, then detached and marked ``requires_grad``, and the
gradient runs only through the GAP + fc head, in the model's compute dtype.
No full backward pass runs.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from ..attacks.api import make_logits_fn

GradCamFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def make_gradcam_fn(model: nn.Module, mean, std,
                    input_dtype: torch.dtype | None = None) -> GradCamFn:
    """Builds ``(x01 [B,H,W,3], y [B]) -> cam [B,h,w] float32 in [0,1]``.

    Raises ValueError for a model without the ``features_last`` /
    ``head_from_features`` split: Grad-CAM is defined on a conv feature
    map, not on a token sequence."""
    if not (callable(getattr(model, "features_last", None))
            and callable(getattr(model, "head_from_features", None))):
        raise ValueError(f"{type(model).__name__} exposes no features_last/"
                         "head_from_features split; Grad-CAM needs a conv tap "
                         "(available on the ResNet family)")
    feats_fn = make_logits_fn(model, mean, std, input_dtype=input_dtype,
                              method="features_last")

    def gradcam(x01: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            feats = feats_fn(x01)  # [B,C,h,w] float32
        a = feats.detach().requires_grad_(True)
        with torch.enable_grad():
            logits = model.head_from_features(a).float()
            # summed over the batch: each sample's gradient stays its own
            score = logits.gather(-1, y[:, None].long()).sum()
            (grads,) = torch.autograd.grad(score, a)
        weights = grads.mean(dim=(2, 3), keepdim=True)  # [B,C,1,1]
        cam = F.relu(torch.sum(weights * feats, dim=1))  # [B,h,w]
        peak = torch.amax(cam, dim=(1, 2), keepdim=True)
        return cam / torch.clamp_min(peak, 1e-12)

    return gradcam


def upsample_cam(cam: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """[B,h,w] -> [B,height,width] bilinear, for the overlay on the input.

    ``F.interpolate(align_corners=False)`` clamps a source index that falls
    outside the map to its edge; ``jax.image.resize`` drops the weight that
    falls outside and renormalizes what is left.  Both give the edge pixel
    all the weight there, so an upsampling is the same function
    (``tests/test_torch_explain.py`` holds them equal)."""
    return F.interpolate(cam[:, None], size=(int(height), int(width)), mode="bilinear",
                         align_corners=False, antialias=False)[:, 0]


def cam_shift_iou(cam_a: torch.Tensor, cam_b: torch.Tensor,
                  quantile: float = 0.8) -> torch.Tensor:
    """IoU of the top-(1 - quantile) attention regions of two CAMs, per
    sample ([B] float32 in [0,1]): 1.0 where the model looks at the same
    place, near 0 where the attack moved its evidence.

    Each map's region is its own linearly interpolated ``quantile``
    super-level set, strictly above it: a sparse map's quantile lands on its
    zero plateau, and ``>=`` would then select the whole map."""
    batch = cam_a.shape[0]
    ta = torch.quantile(cam_a.reshape(batch, -1), quantile, dim=1)
    tb = torch.quantile(cam_b.reshape(batch, -1), quantile, dim=1)
    mask_a = cam_a > ta[:, None, None]
    mask_b = cam_b > tb[:, None, None]
    inter = torch.sum(mask_a & mask_b, dim=(1, 2)).float()
    union = torch.sum(mask_a | mask_b, dim=(1, 2)).float()
    # two empty super-level sets are two constant maps: they agree
    return torch.where(union == 0, 1.0, inter / torch.clamp_min(union, 1.0))
