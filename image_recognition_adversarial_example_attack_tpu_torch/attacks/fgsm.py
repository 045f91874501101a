"""FGSM (port of ``attacks/fgsm.py``): ``clip01(x + eps * sign(dCE/dx))``.

It has no kernel: one forward+backward and one elementwise expression.
"""

from __future__ import annotations

import torch

from .api import LogitsFn, input_grad


def fgsm_attack(logits_fn: LogitsFn, x: torch.Tensor, y_true: torch.Tensor, *,
                eps: float, y_target: torch.Tensor | None = None) -> torch.Tensor:
    """[B,H,W,C] in [0,1] -> adversarial batch in [0,1]. With ``y_target``
    the step descends the target class's cross-entropy."""
    eps = float(eps)
    if y_target is not None:
        grad = input_grad(logits_fn, x, y_target)
        x_adv = x - eps * torch.sign(grad)
    else:
        grad = input_grad(logits_fn, x, y_true)
        x_adv = x + eps * torch.sign(grad)
    return torch.clamp(x_adv, 0.0, 1.0)
