"""TI-FGSM: translation-invariant momentum iterative FGSM (Dong et al.,
CVPR 2019; port of ``attacks/tim.py``).

The per-step gradient is smoothed by a Gaussian kernel (the average over
translations under a linearity assumption) before the momentum takes it.
The smoothing is one depthwise SAME convolution (``groups = C``), an XLA
convolution in the JAX package and ``F.conv2d`` here.  Every step launches
the pgd_step kernel once on a CUDA device (``attacks/mifgsm.py``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .api import LogitsFn
from .mifgsm import momentum_attack, signed_grad


def gaussian_kernel(size: int = 7, sigma: float | None = None) -> np.ndarray:
    """Normalized [size, size] Gaussian, built in float64 on the host and
    stored as float32 (sigma = size / 3 by default)."""
    if size < 1 or size % 2 == 0:
        raise ValueError(f"kernel size must be odd and >= 1, got {size}")
    if sigma is None:
        sigma = size / 3.0
    ax = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(ax**2) / (2.0 * sigma**2))
    k = np.outer(g, g)
    return (k / k.sum()).astype(np.float32)


def smooth_gradient(grad: torch.Tensor, kernel) -> torch.Tensor:
    """Depthwise-convolve a [B,H,W,C] gradient with a [k,k] kernel (SAME,
    zero padded); returns a contiguous [B,H,W,C] tensor."""
    c = grad.shape[-1]
    k = torch.as_tensor(np.asarray(kernel), dtype=grad.dtype, device=grad.device)
    weights = k.reshape(1, 1, *k.shape).repeat(c, 1, 1, 1)  # [C, 1, k, k], one per channel
    out = F.conv2d(grad.permute(0, 3, 1, 2), weights, padding=k.shape[-1] // 2, groups=c)
    return out.permute(0, 2, 3, 1).contiguous()


def tim_attack(logits_fn: LogitsFn, x: torch.Tensor, y_true: torch.Tensor, *,
               eps: float, alpha: float, steps: int, mu: float = 1.0, kernel_size: int = 7,
               y_target: torch.Tensor | None = None) -> torch.Tensor:
    """[B,H,W,C] in [0,1] -> adversarial batch in [0,1]: MI-FGSM with the
    gradient smoothed before the momentum; ``mu=0`` is plain TI-FGSM."""
    kernel = gaussian_kernel(kernel_size)
    grad = signed_grad(logits_fn, y_true, y_target)
    return momentum_attack(lambda xx: smooth_gradient(grad(xx), kernel), x,
                           eps=eps, alpha=alpha, steps=steps, mu=mu)
