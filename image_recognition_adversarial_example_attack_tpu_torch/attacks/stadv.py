"""Spatially transformed adversarial examples (stAdv; Xiao et al., ICLR 2018;
port of ``attacks/stadv.py``).

A per-pixel flow field ``f [B,H,W,2]`` warps the image through bilinear
sampling, and the attack minimizes ``L_adv(warp(x, f), y) + tau * L_flow(f)``
with CW's margin loss and the flow's neighbour-difference smoothness (paper
eq. 4), by Adam on the flow (``attacks/adam.py``, optax's update).  Per
sample, the successful flow with the smallest smoothness is kept (checked
before each update, and once more at the final flow).

``flow_warp`` is the JAX package's explicit four-corner gather, not
``F.grid_sample``: the source point is clamped into the image, then the
upper-left corner is clamped to ``h-2`` / ``w-2``, so the last row and
column interpolate with weight 1.  Its clips are ``jnp.clip``'s, a maximum
then a minimum, whose gradient splits in two at a tie: zero flow puts the
first and last rows and columns exactly on their bounds, and the gradient
to the flow there is the JAX package's.  It has no kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .adam import adam_update
from .api import LogitsFn
from .cw import _margin_and_success


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: maximum then minimum, the gradient halved at a bound
    (``torch.clamp`` passes all of it)."""
    lo_t = torch.tensor(lo, dtype=x.dtype, device=x.device)
    hi_t = torch.tensor(hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo_t), hi_t)


def gather_corners(x: torch.Tensor, y0i: torch.Tensor, x0i: torch.Tensor):
    """The four corners ``x[b, y0i+dy, x0i+dx]`` for dy, dx in {0, 1}, from
    [B,H,W] integer maps: [B,H,W,C] each (v00, v01, v10, v11)."""
    b, h, w, c = x.shape
    flat = x.reshape(b, h * w, c)

    def corner(dy, dx):
        idx = ((y0i + dy) * w + (x0i + dx)).reshape(b, -1, 1).expand(-1, -1, c)
        return torch.gather(flat, 1, idx).reshape(y0i.shape + (c,))

    return corner(0, 0), corner(0, 1), corner(1, 0), corner(1, 1)


def flow_warp(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """The bilinear warp of ``x [B,H,W,C]`` by ``flow [B,H,W,2]``: output
    pixel (i, j) samples input position (i + dy, j + dx), clamped to the
    image (``flow[..., 0]`` the row, ``flow[..., 1]`` the column
    displacement, in pixels).  Zero flow is the identity; the gradient
    reaches both the image and the flow."""
    b, h, w, _ = x.shape
    ii = torch.arange(h, dtype=flow.dtype, device=flow.device)[:, None]
    jj = torch.arange(w, dtype=flow.dtype, device=flow.device)[None, :]
    sy = _clip(ii + flow[..., 0], 0.0, h - 1.0)
    sx = _clip(jj + flow[..., 1], 0.0, w - 1.0)
    y0 = torch.clamp(torch.floor(sy), 0.0, h - 2.0)
    x0 = torch.clamp(torch.floor(sx), 0.0, w - 2.0)
    wy = (sy - y0)[..., None]
    wx = (sx - x0)[..., None]
    v00, v01, v10, v11 = gather_corners(x, y0.long(), x0.long())
    top = v00 * (1.0 - wx) + v01 * wx
    bot = v10 * (1.0 - wx) + v11 * wx
    return top * (1.0 - wy) + bot * wy


def flow_smoothness(flow: torch.Tensor) -> torch.Tensor:
    """Paper eq. 4 per image, [B]: for each pixel, the root-sum-square of the
    (du, dv) difference to each in-image neighbour, summed (forward
    differences along H and W, each pair once a direction).  The 1e-12
    keeps the root's gradient defined at zero flow, the attack's start."""
    dy = flow[:, 1:] - flow[:, :-1]
    dx = flow[:, :, 1:] - flow[:, :, :-1]
    sy = torch.sum(torch.sqrt(torch.sum(dy * dy, dim=-1) + 1e-12), dim=(1, 2))
    sx = torch.sum(torch.sqrt(torch.sum(dx * dx, dim=-1) + 1e-12), dim=(1, 2))
    return sy + sx


class StAdvResult(NamedTuple):
    x_adv: torch.Tensor    # [B,H,W,C] in [0,1]
    success: torch.Tensor  # [B] bool: misclassified at some checked flow
    flow: torch.Tensor     # [B,H,W,2]: the best (or the final) flow


def stadv_attack(logits_fn: LogitsFn, x: torch.Tensor, y_true: torch.Tensor, *,
                 steps: int = 200, lr: float = 0.01, tau: float = 0.05, kappa: float = 0.0,
                 y_target: torch.Tensor | None = None) -> StAdvResult:
    """A flow field such that ``flow_warp(x, flow)`` fools the model.

    Untargeted by default (CW's margin against the true class); targeted
    with ``y_target``.  Returns the warp under the best flow: the
    successful one with the least ``flow_smoothness``, else the final one.
    ``tau`` weights the smoothness per neighbour pair (the eq.-4 sum over
    the pair count), so one default serves every resolution.
    """
    targeted = y_target is not None
    y_cmp = y_target if targeted else y_true
    x0 = torch.clamp(x, 0.0, 1.0).detach()
    b, h, w, _ = x0.shape
    n_pairs = float(h * (w - 1) + w * (h - 1))

    def objective(flow):
        x_adv = _clip(flow_warp(x0, flow), 0.0, 1.0)
        f, success = _margin_and_success(logits_fn(x_adv), y_cmp, kappa, targeted, y_true)
        smooth = flow_smoothness(flow) / n_pairs
        return torch.sum(f + tau * smooth), success, smooth

    flow = torch.zeros((b, h, w, 2), dtype=x0.dtype, device=x0.device)
    m, v = torch.zeros_like(flow), torch.zeros_like(flow)
    best_flow = flow
    best_cost = torch.full((b,), torch.inf, dtype=x0.dtype, device=x0.device)
    best_success = torch.zeros((b,), dtype=torch.bool, device=x0.device)
    for t in range(1, int(steps) + 1):
        fg = flow.detach().requires_grad_(True)
        with torch.enable_grad():
            loss, success, smooth = objective(fg)
            (g,) = torch.autograd.grad(loss, fg)
        # before the update: among successes keep the smoothest flow; a
        # first success beats any failure
        cost = smooth.detach()
        better = success & ((cost < best_cost) | ~best_success)
        best_flow = torch.where(better[:, None, None, None], flow, best_flow)
        best_cost = torch.where(better, cost, best_cost)
        best_success = best_success | success
        flow, m, v = adam_update(flow, g, m, v, t, lr)

    # the final flow joins the pool: a sample first fooled by the last
    # update counts
    with torch.no_grad():
        _, success_fin, _ = objective(flow)
    take_fin = success_fin & ~best_success
    flow_out = torch.where(take_fin[:, None, None, None], flow, best_flow)
    x_adv = _clip(flow_warp(x0, flow_out), 0.0, 1.0)
    return StAdvResult(x_adv=x_adv, success=best_success | success_fin, flow=flow_out)
