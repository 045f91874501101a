"""MI-FGSM: momentum iterative FGSM (Dong et al., CVPR 2018; port of
``attacks/mifgsm.py``).

The transfer study's standard booster: per step

    g_t = mu * g_{t-1} + grad / max(||grad||_1 per sample, 1e-12)
    x_t = clip01( project_eps( x_{t-1} + alpha * sign(g_t) ) )

The update goes through the pgd_step wrapper, so on a CUDA device every step
launches the pgd_step kernel once (``kernels/elementwise.py``).  The loop is
a Python loop of one forward+backward and one launch per step; there is no
random start.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..kernels import elementwise
from .api import LogitsFn, input_grad


def momentum(g: torch.Tensor, grad: torch.Tensor, mu: float) -> torch.Tensor:
    """``mu * g + grad / ||grad||_1``, the L1 norm per sample (batch rows
    stay decoupled), floored at 1e-12."""
    l1 = torch.sum(torch.abs(grad), dim=(1, 2, 3), keepdim=True)
    return mu * g + grad / torch.clamp_min(l1, 1e-12)


def momentum_attack(grad_fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
                    *, eps: float, alpha: float, steps: int, mu: float) -> torch.Tensor:
    """The loop the transfer family shares: ``grad_fn(x_adv)`` gives the
    step's (already signed) gradient, the momentum accumulates it and the
    pgd_step wrapper takes the step."""
    x_orig = x.contiguous()
    x_adv, g = x_orig, torch.zeros_like(x_orig)
    for _ in range(int(steps)):
        g = momentum(g, grad_fn(x_adv), float(mu)).contiguous()
        x_adv = elementwise.pgd_step(x_adv, g, x_orig, float(eps), float(alpha))
    return x_adv


def signed_grad(logits_fn: LogitsFn, y_true: torch.Tensor,
                y_target: torch.Tensor | None) -> Callable[[torch.Tensor], torch.Tensor]:
    """x -> the CE input gradient, negated in the targeted mode (the descent
    direction of the target class's CE)."""
    if y_target is None:
        return lambda xx: input_grad(logits_fn, xx, y_true)
    return lambda xx: -input_grad(logits_fn, xx, y_target)


def mifgsm_attack(logits_fn: LogitsFn, x: torch.Tensor, y_true: torch.Tensor, *,
                  eps: float, alpha: float, steps: int, mu: float = 1.0,
                  y_target: torch.Tensor | None = None) -> torch.Tensor:
    """[B,H,W,C] in [0,1] -> adversarial batch in [0,1].  With ``y_target``
    the momentum accumulates the descent direction of the target's CE."""
    return momentum_attack(signed_grad(logits_fn, y_true, y_target), x, eps=eps,
                           alpha=alpha, steps=steps, mu=mu)
