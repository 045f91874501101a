"""Square Attack in the L∞ and L2 balls: score-based black-box random search
(Andriushchenko et al., ECCV 2020; port of ``attacks/square.py``).

No gradients: one forward a step, and a random square perturbation is kept
when it lowers the margin loss ``z_y - max_{k != y} z_k``.  The square's side
follows the paper's p-schedule (``square_schedule``, numpy, as in JAX).

The JAX package runs the search as one ``lax.scan``; here it is a Python loop
of one forward a step whose every decision is a masked ``torch.where``, so
nothing in the loop waits for the card.  The small per-step draws (offsets
and per-channel signs of every step) are made in one call before the loop,
on the device, by ``draw_square`` / ``draw_square_l2`` (the tests' patch
points, fed JAX's draws there).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.rng import device_generator, rademacher, randint_below
from .api import LogitsFn, success_history


def square_schedule(steps: int, h: int, w: int, p_init: float = 0.1) -> np.ndarray:
    """Per-step square side lengths (the paper's piecewise p-schedule: p
    halves at the fractions 0.001/0.005/0.02/0.05/0.1/0.2/0.4/0.6/0.8 of the
    query budget)."""
    breaks = np.array([0.001, 0.005, 0.02, 0.05, 0.1, 0.2, 0.4, 0.6, 0.8])
    sides = np.empty((steps,), np.int32)
    for i in range(steps):
        frac = i / max(1, steps)
        n_halvings = int(np.searchsorted(breaks, frac, side="right"))
        p = p_init / (2**n_halvings)
        side = int(round(np.sqrt(p * h * w)))
        sides[i] = int(np.clip(side, 1, min(h, w)))
    return sides


def _margin_loss(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """logit_y - max_{k != y} logit_k  (negative == misclassified)."""
    k = logits.shape[-1]
    correct = torch.gather(logits, -1, y[:, None].long())[:, 0]
    masked = logits - 1e9 * F.one_hot(y.long(), k).to(logits.dtype)
    return correct - torch.amax(masked, dim=-1)


def draw_square(steps: int, b: int, h: int, w: int, c: int, sides: np.ndarray,
                generator: torch.Generator, device: torch.device | str):
    """The L∞ search's draws, float32/int64 on ``device``: the ±1 stripes
    [B,1,W,C] of the start, then per step the square's top-left corner
    ``(r0, c0)`` [steps,B] uniform over ``[0, h - side]`` and its ±1 signs
    [steps,B,C]."""
    g = device_generator(generator, device)
    stripes = rademacher((b, 1, w, c), g, device)
    hi = torch.as_tensor(np.asarray(sides, np.int64), device=device)
    r0 = randint_below(h - hi + 1, b, g)
    c0 = randint_below(w - hi + 1, b, g)
    signs = rademacher((steps, b, c), g, device, axis=1)
    return stripes, r0, c0, signs


def square_attack(logits_fn: LogitsFn, x: torch.Tensor, y_true: torch.Tensor, *,
                  eps: float, steps: int = 1000, generator: torch.Generator,
                  p_init: float = 0.1, return_history: bool = False):
    """[B,H,W,C] in [0,1] -> the best iterate found, inside the L∞ eps-ball
    (misclassified where the margin went negative).  With ``return_history``
    also the per-step success mask [steps, B] (margin < 0 after that step's
    query), at no extra forward."""
    eps = float(eps)
    b, h, w, c = x.shape
    x_orig = x

    def clip_ball(z):
        return torch.clamp(torch.clamp(z, x_orig - eps, x_orig + eps), 0.0, 1.0)

    sides = square_schedule(int(steps), h, w, p_init)
    stripes, r0s, c0s, signs = draw_square(int(steps), b, h, w, c, sides, generator,
                                           x.device)
    with torch.no_grad():
        # the start: full-height stripes of ±eps per (column, channel); the
        # clean point joins the comparison, so the result is never worse
        x_init = clip_ball(x_orig + stripes.to(x.dtype) * eps)
        loss_init = _margin_loss(logits_fn(x_init), y_true)
        loss_clean = _margin_loss(logits_fn(x_orig), y_true)
        better = loss_init < loss_clean
        x_best = torch.where(better[:, None, None, None], x_init, x_orig)
        loss_best = torch.minimum(loss_init, loss_clean)

        rows = torch.arange(h, device=x.device).view(1, h, 1, 1)
        cols = torch.arange(w, device=x.device).view(1, 1, w, 1)
        hist = []
        for i in range(int(steps)):
            side = int(sides[i])
            r0 = r0s[i].view(b, 1, 1, 1)
            c0 = c0s[i].view(b, 1, 1, 1)
            mask = (rows >= r0) & (rows < r0 + side) & (cols >= c0) & (cols < c0 + side)
            sign = signs[i].to(x.dtype).view(b, 1, 1, c) * eps
            # the candidate: the square's delta overwritten with ±eps per channel
            cand = torch.where(mask, clip_ball(x_orig + sign), x_best)
            loss_cand = _margin_loss(logits_fn(cand), y_true)
            accept = loss_cand < loss_best
            x_best = torch.where(accept[:, None, None, None], cand, x_best)
            loss_best = torch.minimum(loss_best, loss_cand)
            if return_history:
                hist.append(loss_best < 0.0)
    if return_history:
        return x_best, success_history(hist, x)
    return x_best


def _bump_window(rows, cols, r0, c0, side):
    """Unit-L2 'pseudo-Gaussian' bump on a [B,H,W,1] window: concentric
    Chebyshev shells weighted 1/(k+1)^2 around the window's centre."""
    center_r = r0 + (side - 1) / 2.0
    center_c = c0 + (side - 1) / 2.0
    cheb = torch.maximum(torch.abs(rows - center_r), torch.abs(cols - center_c))
    ring = torch.floor(cheb)
    mask = (rows >= r0) & (rows < r0 + side) & (cols >= c0) & (cols < c0 + side)
    w = torch.where(mask, 1.0 / torch.square(1.0 + ring), 0.0)
    nrm = torch.sqrt(torch.sum(torch.square(w), dim=(1, 2, 3), keepdim=True))
    return w / (nrm + 1e-12), mask


def draw_square_l2(steps: int, b: int, grid: tuple[int, int], h: int, w: int, c: int,
                   sides: np.ndarray, generator: torch.Generator,
                   device: torch.device | str):
    """The L2 search's draws on ``device``: the ±1 signs [B,n_gr,n_gc,C] of
    the start's bump grid, then per step the two windows' corners
    ``(r1, c1, r2, c2)``, each [steps,B] uniform over ``[0, h - side]``,
    and the ±1 signs [steps,B,C]."""
    g = device_generator(generator, device)
    sign0 = rademacher((b, *grid, c), g, device)
    hi = torch.as_tensor(np.asarray(sides, np.int64), device=device)
    r1 = randint_below(h - hi + 1, b, g)
    c1 = randint_below(w - hi + 1, b, g)
    r2 = randint_below(h - hi + 1, b, g)
    c2 = randint_below(w - hi + 1, b, g)
    signs = rademacher((steps, b, c), g, device, axis=1)
    return sign0, r1, c1, r2, c2, signs


def square_l2_attack(logits_fn: LogitsFn, x: torch.Tensor, y_true: torch.Tensor, *,
                     eps: float, steps: int = 1000, generator: torch.Generator,
                     p_init: float = 0.1, return_history: bool = False):
    """Square Attack in the L2 ball: per step, free a window W2's mass and
    refill a window W1 with a pseudo-Gaussian bump (mixed with W1's old
    direction, a random sign per channel) scaled to spend the freed and the
    unused budget, so ``||delta||_2 <= eps`` holds before the box clip; keep
    it when the margin loss improves.  One forward a step."""
    eps = float(eps)
    b, h, w, c = x.shape
    x_orig = x
    axes = (1, 2, 3)
    dt = x.dtype

    def clip01(z):
        return torch.clamp(z, 0.0, 1.0)

    def l2sq(v):
        return torch.sum(torch.square(v), dim=axes, keepdim=True)

    rows = torch.arange(h, device=x.device).view(1, h, 1, 1).to(dt)
    cols = torch.arange(w, device=x.device).view(1, 1, w, 1).to(dt)

    s0 = max(2, h // 5)
    n_gr = max(1, h // s0)
    n_gc = max(1, w // s0)
    sides = np.maximum(square_schedule(int(steps), h, w, p_init), 2)
    sign0, r1s, c1s, r2s, c2s, signs = draw_square_l2(
        int(steps), b, (n_gr, n_gc), h, w, c, sides, generator, x.device)
    sign0 = sign0.to(dt)

    with torch.no_grad():
        # the start: a grid of bumps with independent signs, scaled to eps
        delta0 = torch.zeros_like(x)
        for gi in range(n_gr):
            for gj in range(n_gc):
                bump, _ = _bump_window(rows, cols, float(gi * s0), float(gj * s0), float(s0))
                delta0 = delta0 + bump * sign0[:, gi, gj][:, None, None, :]
        d_nrm = torch.sqrt(l2sq(delta0))
        delta0 = delta0 * eps / (d_nrm + 1e-12)

        loss_clean = _margin_loss(logits_fn(x_orig), y_true)
        x_init = clip01(x_orig + delta0)
        loss_init = _margin_loss(logits_fn(x_init), y_true)
        better = loss_init < loss_clean
        delta = torch.where(better[:, None, None, None], delta0, torch.zeros_like(delta0))
        loss_best = torch.minimum(loss_init, loss_clean)

        hist = []
        for i in range(int(steps)):
            side_f = float(sides[i])
            r1 = r1s[i].view(b, 1, 1, 1).to(dt)
            c1 = c1s[i].view(b, 1, 1, 1).to(dt)
            r2 = r2s[i].view(b, 1, 1, 1).to(dt)
            c2 = c2s[i].view(b, 1, 1, 1).to(dt)
            bump, m1 = _bump_window(rows, cols, r1, c1, side_f)
            _, m2 = _bump_window(rows, cols, r2, c2, side_f)
            m2_only = m2 & ~m1

            old1 = torch.where(m1, delta, 0.0)
            old1_sq = l2sq(old1)
            freed_sq = l2sq(torch.where(m2_only, delta, 0.0))
            unused_sq = torch.clamp_min(eps * eps - l2sq(delta), 0.0)

            sign = signs[i].to(dt).view(b, 1, 1, c)
            direction = torch.where(m1, bump * sign + old1 / (torch.sqrt(old1_sq) + 1e-10), 0.0)
            dir_nrm = torch.sqrt(l2sq(direction))
            budget = torch.sqrt(old1_sq + freed_sq + unused_sq)
            new1 = direction / (dir_nrm + 1e-12) * budget

            cand_delta = torch.where(m1, new1, torch.where(m2_only, 0.0, delta))
            loss_cand = _margin_loss(logits_fn(clip01(x_orig + cand_delta)), y_true)
            accept = loss_cand < loss_best
            delta = torch.where(accept[:, None, None, None], cand_delta, delta)
            loss_best = torch.minimum(loss_best, loss_cand)
            if return_history:
                hist.append(loss_best < 0.0)
        x_adv = clip01(x_orig + delta)
    if return_history:
        return x_adv, success_history(hist, x)
    return x_adv

