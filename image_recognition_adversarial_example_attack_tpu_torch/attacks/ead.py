"""EAD: the elastic-net attack, L1-regularized C&W (Chen et al., AAAI 2018;
port of ``attacks/ead.py``).

Minimizes ``c * f(x') + ||x' - x0||_2^2 + beta * ||x' - x0||_1`` with CW's
margin loss ``f`` by FISTA: a gradient step on the smooth part, then the
elementwise shrinkage around x0 (clipped to [0,1]) that handles the L1 term
exactly, then Nesterov momentum ``y_{k+1} = x_{k+1} + k/(k+3) (x_{k+1} -
x_k)``.  Per sample, the successful iterate with the smallest elastic-net
distance is kept.  The learning rate is constant.

The JAX package's ``lax.scan`` is a Python loop here: each step one forward
at the iterate (its success check, before the update) and one
forward+backward at the momentum point; one more forward checks the final
iterate.  It has no kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .api import LogitsFn
from .cw import _margin_and_success


class EADResult(NamedTuple):
    x_adv: torch.Tensor    # [B,H,W,C] in [0,1]
    success: torch.Tensor  # [B] bool: misclassified at some checked iterate


def _shrink(z: torch.Tensor, x0: torch.Tensor, beta: float) -> torch.Tensor:
    """The soft-threshold of (z - x0) by beta, clipped to [0,1]."""
    upper = torch.clamp_max(z - beta, 1.0)
    lower = torch.clamp_min(z + beta, 0.0)
    diff = z - x0
    return torch.where(diff > beta, upper, torch.where(diff < -beta, lower, x0))


def ead_attack(logits_fn: LogitsFn, x: torch.Tensor, y_true: torch.Tensor, *,
               c: float = 1.0, kappa: float = 0.0, beta: float = 1e-3, steps: int = 100,
               lr: float = 1e-2, targeted: bool = False,
               y_target: torch.Tensor | None = None) -> EADResult:
    """[B,H,W,C] in [0,1] -> the elastic-net-minimal adversarial batch.

    A larger ``beta`` thresholds more of each step away, so ``c`` or ``lr``
    must grow with it: where lr*|grad| < beta the shrinkage returns every
    pixel to x0 and the attack stalls at zero perturbation.
    """
    if targeted and y_target is None:
        raise ValueError("y_target must be provided when targeted=True")
    y_cmp = y_target if targeted else y_true

    x0 = torch.clamp(x, 0.0, 1.0).detach()
    batch = x0.shape[0]

    def smooth_objective(z):
        """c*f + ||z-x0||_2^2 (the L1 term is the shrinkage's)."""
        f, success = _margin_and_success(logits_fn(z), y_cmp, kappa, targeted, y_true)
        l2 = torch.sum(torch.square(z - x0).reshape(batch, -1), dim=-1)
        return torch.sum(l2 + c * f), success

    def success_at(z):
        with torch.no_grad():
            return smooth_objective(z)[1]

    def grad_at(z):
        zg = z.detach().requires_grad_(True)
        with torch.enable_grad():
            (g,) = torch.autograd.grad(smooth_objective(zg)[0], zg)
        return g

    def en_dist(z):
        delta = (z - x0).reshape(batch, -1)
        return (torch.sum(torch.square(delta), dim=-1)
                + beta * torch.sum(torch.abs(delta), dim=-1))

    best_adv = x0
    best_en = torch.full((batch,), torch.inf, dtype=x0.dtype, device=x0.device)
    best_success = torch.zeros((batch,), dtype=torch.bool, device=x0.device)

    def track(z, success):
        nonlocal best_adv, best_en, best_success
        en = en_dist(z)
        improved = success & (en < best_en)
        best_en = torch.where(improved, en, best_en)
        best_success = best_success | improved
        best_adv = torch.where(improved[:, None, None, None], z, best_adv)

    ks = torch.arange(int(steps), dtype=x0.dtype)  # the momentum's k, in x's dtype
    x_k = y_k = x0
    for k in ks:
        # best tracking on the iterate x_k, before its update (the gradient
        # is taken at the momentum point y_k)
        track(x_k, success_at(x_k))
        x_next = _shrink(y_k - lr * grad_at(y_k), x0, beta)
        # a 0-d CPU tensor multiplies a tensor on the card as a scalar
        y_k = x_next + (k / (k + 3.0)) * (x_next - x_k)
        x_k = x_next

    # the loop checks only iterates before their update: one more forward
    # checks the final one
    x_fin = torch.clamp(x_k, 0.0, 1.0)
    track(x_fin, success_at(x_fin))
    x_adv = torch.where(best_success[:, None, None, None], best_adv, x_fin)
    return EADResult(x_adv=x_adv, success=best_success)
