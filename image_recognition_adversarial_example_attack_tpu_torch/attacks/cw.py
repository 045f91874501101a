"""Carlini-Wagner L2 (port of ``attacks/cw.py``): tanh-space Adam.

- change of variables ``x_adv = 0.5 * (tanh(w) + 1)`` with
  ``w0 = atanh(2 * (x0*(1-2e-6)+1e-6) - 1)``;
- margin loss ``f = max(real - other + kappa, 0)`` (untargeted; flipped when
  targeted), with ``other = max(logits - 1e4*onehot)``;
- objective ``sum_b(||x_adv - x0||_2^2 + c * f)`` minimized by Adam on w
  (``attacks/adam.py``: optax's order, b1 0.9, b2 0.999, eps 1e-8, bias
  correction);
- per-sample best-(L2, success) tracking on each iterate BEFORE its Adam
  update, and one more check of the final iterate after the loop;
- output: the best successful x_adv per sample, else the final iterate.

The JAX package runs the loop as one ``lax.scan``; here it is a Python loop
of one forward+backward per step.  Nothing in the loop reads a value back to
the host, so the steps queue on the card without a synchronisation.  It has
no kernel of its own.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .adam import adam_update
from .api import LogitsFn

TINY = 1e-6


class CWResult(NamedTuple):
    x_adv: torch.Tensor    # [B,H,W,C] in [0,1]
    success: torch.Tensor  # [B] bool: misclassified at some checked iterate


def _margin_and_success(logits, y_cmp, kappa: float, targeted: bool, y_true):
    onehot = F.one_hot(y_cmp.long(), logits.shape[-1]).to(logits.dtype)
    real = torch.sum(logits * onehot, dim=-1)
    other = torch.amax(logits - 1e4 * onehot, dim=-1)
    pred = torch.argmax(logits, dim=-1)
    if targeted:
        v, success = other - real + kappa, pred == y_cmp
    else:
        v, success = real - other + kappa, pred != y_true
    # torch.maximum splits the gradient of a tie as jnp.maximum does
    return torch.maximum(v, torch.zeros_like(v)), success


def cw_l2_attack(
    logits_fn: LogitsFn,
    x: torch.Tensor,
    y_true: torch.Tensor,
    *,
    c: float = 1.0,
    kappa: float = 0.0,
    steps: int = 1000,
    lr: float = 1e-2,
    targeted: bool = False,
    y_target: torch.Tensor | None = None,
) -> CWResult:
    if targeted and y_target is None:
        raise ValueError("y_target must be provided when targeted=True")
    y_cmp = y_target if targeted else y_true

    x0 = torch.clamp(x, 0.0, 1.0).detach()
    batch = x0.shape[0]
    w = torch.atanh((x0 * (1.0 - 2.0 * TINY) + TINY) * 2.0 - 1.0)
    m = torch.zeros_like(w)
    v = torch.zeros_like(w)

    def objective(w_):
        x_adv = 0.5 * (torch.tanh(w_) + 1.0)
        f, success = _margin_and_success(logits_fn(x_adv), y_cmp, kappa, targeted, y_true)
        l2 = torch.sum(torch.square(x_adv - x0).reshape(batch, -1), dim=-1)
        return torch.sum(l2 + c * f), x_adv, l2, success

    best_adv = x0
    best_l2 = torch.full((batch,), float("inf"), dtype=x0.dtype, device=x0.device)
    best_success = torch.zeros((batch,), dtype=torch.bool, device=x0.device)

    def track(x_adv, l2, success):
        nonlocal best_adv, best_l2, best_success
        improved = success & (l2 < best_l2)
        best_l2 = torch.where(improved, l2, best_l2)
        best_success = best_success | improved
        best_adv = torch.where(improved[:, None, None, None], x_adv, best_adv)

    for t in range(1, int(steps) + 1):
        wg = w.detach().requires_grad_(True)
        with torch.enable_grad():
            loss, x_adv, l2, success = objective(wg)
            (grad,) = torch.autograd.grad(loss, wg)
        track(x_adv.detach(), l2.detach(), success)
        w, m, v = adam_update(w, grad, m, v, t, lr)

    # the loop checks only pre-update iterates: one more forward checks the
    # final one, so a sample first fooled by the last step counts
    with torch.no_grad():
        _, x_fin, l2_fin, succ_fin = objective(w)
    track(x_fin, l2_fin, succ_fin)
    x_adv = torch.where(best_success[:, None, None, None], best_adv, x_fin)
    return CWResult(x_adv=x_adv, success=best_success)
