"""Detector-aware attack (port of ``attacks/detector_aware.py``): fool the
classifier AND stay under the detector's threshold.

Sign-gradient ascent on the joint objective of Carlini & Wagner (AISec
2017, "Adversarial Examples Are Not Easily Detected"):

    maximize   CE(f(x_adv), y)  -  lam * relu(score(x_adv) - margin * tau)

Every detector score of the port (feature statistics, feature squeezing
through the straight-through quantization, Mahalanobis) is differentiable.
The random start is the noise kernel and every update the pgd_step kernel,
the same launches as ``attacks/pgd.py``.  With ``lam == 0`` the gradient is
exactly ``input_grad``, so the result is bit-equal to ``pgd_linf_attack``
from the same generator.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..kernels import elementwise
from .api import LogitsFn, cross_entropy_sum, input_grad

# x01 [B,H,W,C] -> [B] detector score (higher = more adversarial-looking)
ScoreFn = Callable[[torch.Tensor], torch.Tensor]


def _joint_grad(logits_fn: LogitsFn, score_fn: ScoreFn, x: torch.Tensor,
                y: torch.Tensor, thr: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """d/dx of ``CE - lam * sum relu(score - thr)``."""
    xg = x.detach().requires_grad_(True)
    with torch.enable_grad():
        ce = cross_entropy_sum(logits_fn(xg), y)
        pen = torch.sum(torch.relu(score_fn(xg) - thr))
        (grad,) = torch.autograd.grad(ce - lam * pen, xg)
    return grad


def detector_aware_pgd(logits_fn: LogitsFn, score_fn: ScoreFn, x: torch.Tensor,
                       y_true: torch.Tensor, *, eps: float, alpha: float, steps: int,
                       generator: torch.Generator | None, threshold, lam: float = 1.0,
                       margin: float = 0.9, random_start: bool = True) -> torch.Tensor:
    """[B,H,W,C] in [0,1] -> adversarial batch in [0,1], in the L-inf eps-ball.

    ``threshold * margin`` and ``lam`` are float32 values, as in the JAX
    package.  ``generator`` feeds the random start only.
    """
    eps, alpha = float(eps), float(alpha)
    x_orig = x.contiguous()
    if random_start:
        noise = elementwise.uniform_noise(x.shape, eps, generator, x.device).to(x.dtype)
        x_adv = torch.clamp(x_orig + noise, 0.0, 1.0)
    else:
        x_adv = x_orig

    f32 = {"dtype": torch.float32, "device": x.device}
    thr = torch.tensor(float(threshold), **f32) * torch.tensor(float(margin), **f32)
    lam32 = torch.tensor(float(lam), **f32)
    for _ in range(int(steps)):
        if lam == 0.0:
            grad = input_grad(logits_fn, x_adv, y_true)
        else:
            grad = _joint_grad(logits_fn, score_fn, x_adv, y_true, thr, lam32)
        x_adv = elementwise.pgd_step(x_adv, grad.contiguous(), x_orig, eps, alpha)
    return x_adv


def detector_aware_fgsm(logits_fn: LogitsFn, score_fn: ScoreFn, x: torch.Tensor,
                        y_true: torch.Tensor, *, eps: float, threshold, lam: float = 1.0,
                        margin: float = 0.9) -> torch.Tensor:
    """One full-eps sign step on the joint objective: one pgd_step launch
    with ``alpha = eps`` and no random start."""
    return detector_aware_pgd(logits_fn, score_fn, x, y_true, eps=eps, alpha=eps,
                              steps=1, generator=None, threshold=threshold, lam=lam,
                              margin=margin, random_start=False)
