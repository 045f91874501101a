"""The spatial attack: worst-case rotation and translation (Engstrom et al.,
ICML 2019; port of ``attacks/spatial.py``).

The budget is a transform, not a pixel norm: a rotation of up to
``max_rot`` degrees and a translation of up to ``max_trans`` of each axis;
the attack wins where any transform of the budget flips the prediction.  The
candidates are an exhaustive ``grid_rot x grid_trans x grid_trans`` grid
shared by the batch, then ``candidates`` random draws per sample
(worst-of-k), in that order, which decides ties.  Each candidate is one
bilinear warp of the batch (``affine_warp``) and one forward; per sample a
first success beats any failure, and otherwise the higher CE wins.

The random draws are Uniform(-1, 1) of shape [K, B, 3] from the generator
(``draw_candidates``): too small for a kernel launch to pay.  It has no
kernel.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core.rng import uniform
from .api import LogitsFn, per_sample_ce
from .stadv import gather_corners


def affine_warp(x: torch.Tensor, angle_deg: torch.Tensor, tx: torch.Tensor, ty: torch.Tensor,
                fill: float = 0.0) -> torch.Tensor:
    """Rotate ``x [B,H,W,C]`` by the per-sample ``angle_deg`` about the image
    centre, then translate by (``tx`` right, ``ty`` down) pixels; bilinear,
    and samples outside the image take ``fill``.  Zero parameters are the
    identity."""
    b, h, w, _ = x.shape
    dt = x.dtype
    theta = angle_deg.to(dt) * (math.pi / 180.0)
    cos = torch.cos(theta)[:, None, None]
    sin = torch.sin(theta)[:, None, None]
    cy = (h - 1) / 2.0
    cx = (w - 1) / 2.0
    ii = torch.arange(h, dtype=dt, device=x.device)[None, :, None]
    jj = torch.arange(w, dtype=dt, device=x.device)[None, None, :]
    # the inverse map: dest (i, j) samples R(-theta) @ (dest - c - t) + c
    dy = ii - cy - ty.to(dt)[:, None, None]
    dx = jj - cx - tx.to(dt)[:, None, None]
    sx = cos * dx + sin * dy + cx
    sy = -sin * dx + cos * dy + cy

    # a 1e-3 px slack: float32 trigonometry (sin(pi) ~ -8.7e-8) pushes exact
    # border samples out by ~1e-7 px, and a 180-degree rotation would fill
    # border pixels
    tol = 1e-3
    valid = (sy >= -tol) & (sy <= h - 1.0 + tol) & (sx >= -tol) & (sx <= w - 1.0 + tol)
    syc = torch.clamp(sy, 0.0, h - 1.0)
    sxc = torch.clamp(sx, 0.0, w - 1.0)
    y0 = torch.clamp(torch.floor(syc), 0.0, h - 2.0)
    x0 = torch.clamp(torch.floor(sxc), 0.0, w - 2.0)
    wy = (syc - y0)[..., None]
    wx = (sxc - x0)[..., None]
    v00, v01, v10, v11 = gather_corners(x, y0.long(), x0.long())
    top = v00 * (1.0 - wx) + v01 * wx
    bot = v10 * (1.0 - wx) + v11 * wx
    out = top * (1.0 - wy) + bot * wy
    return torch.where(valid[..., None], out, torch.tensor(fill, dtype=dt, device=x.device))


class SpatialResult(NamedTuple):
    x_adv: torch.Tensor    # [B,H,W,C] in [0,1]: the worst transform's image
    success: torch.Tensor  # [B] bool: some transform of the budget fooled it
    params: torch.Tensor   # [B,3]: the chosen (angle_deg, tx_px, ty_px)


def _grid_axis(n: int, bound: float, dtype, device=None) -> torch.Tensor:
    """``n`` grid values in [-bound, bound]; n = 1 is the identity (0), as
    the paper's odd grids always hold the untransformed image."""
    if n == 1:
        return torch.zeros((1,), dtype=dtype, device=device)
    return torch.linspace(-1.0, 1.0, int(n), dtype=dtype, device=device) * float(bound)


def draw_candidates(candidates: int, batch: int, generator: torch.Generator,
                    dtype: torch.dtype, device: torch.device | str) -> torch.Tensor:
    """[K,B,3] Uniform(-1, 1) from ``generator`` (on its device), on ``device``."""
    u = uniform((int(candidates), batch, 3), generator, generator.device, axis=1, dtype=dtype)
    return (u * 2.0 - 1.0).to(device)


def spatial_attack(logits_fn: LogitsFn, x: torch.Tensor, y_true: torch.Tensor, *,
                   max_rot: float = 30.0, max_trans: float = 0.1, candidates: int = 10,
                   grid_rot: int = 0, grid_trans: int = 0,
                   generator: torch.Generator | None = None) -> SpatialResult:
    """The worst rotation and translation inside the budget.

    The search is the union of the paper's two methods, each of which can be
    zeroed: a ``grid_rot x grid_trans x grid_trans`` grid (used when both
    counts are > 0; odd counts hold the identity) and ``candidates`` draws
    per sample.  The default is worst-of-10 random; the paper's strongest
    is ``candidates=0, grid_rot=31, grid_trans=5``.  ``max_trans`` is a
    fraction of each axis.  Untargeted: success = the prediction leaves
    ``y_true``.
    """
    x0 = torch.clamp(x, 0.0, 1.0)
    b, h, w, _ = x0.shape
    dt = x0.dtype

    if (int(grid_rot) > 0) != (int(grid_trans) > 0):
        raise ValueError(
            "grid search needs BOTH grid_rot and grid_trans > 0 (got "
            f"grid_rot={int(grid_rot)}, grid_trans={int(grid_trans)}); "
            "setting only one would silently drop the grid and run the "
            "strictly weaker random-only search")
    parts = []
    if int(grid_rot) > 0 and int(grid_trans) > 0:
        rots = _grid_axis(int(grid_rot), max_rot, dt, x.device)
        txs = _grid_axis(int(grid_trans), max_trans * w, dt, x.device)
        tys = _grid_axis(int(grid_trans), max_trans * h, dt, x.device)
        rr, xx, yy = torch.meshgrid(rots, txs, tys, indexing="ij")
        grid = torch.stack([rr.reshape(-1), xx.reshape(-1), yy.reshape(-1)], dim=-1)  # [K,3]
        parts.append(grid[:, None, :].expand(grid.shape[0], b, 3))
    if int(candidates) > 0:
        if generator is None:
            raise ValueError("random spatial search needs an explicit generator")
        u = draw_candidates(int(candidates), b, generator, dt, x.device)
        parts.append(torch.stack([u[..., 0] * float(max_rot), u[..., 1] * float(max_trans * w),
                                  u[..., 2] * float(max_trans * h)], dim=-1))
    if not parts:
        raise ValueError(
            "empty spatial search: set candidates > 0 and/or both "
            "grid_rot and grid_trans > 0")

    best_x = x0
    best_loss = torch.full((b,), -torch.inf, dtype=dt, device=x.device)
    best_succ = torch.zeros((b,), dtype=torch.bool, device=x.device)
    best_p = torch.zeros((b, 3), dtype=dt, device=x.device)
    with torch.no_grad():
        for p in torch.cat(parts, dim=0):  # p [B,3]
            xa = torch.clamp(affine_warp(x0, p[:, 0], p[:, 1], p[:, 2]), 0.0, 1.0)
            logits = logits_fn(xa)
            ce = per_sample_ce(logits, y_true).to(dt)
            succ = torch.argmax(logits, dim=-1) != y_true
            # a first success beats any failure; otherwise the higher CE wins
            better = (succ & ~best_succ) | ((succ == best_succ) & (ce > best_loss))
            best_x = torch.where(better[:, None, None, None], xa, best_x)
            best_loss = torch.where(better, ce, best_loss)
            best_p = torch.where(better[:, None], p, best_p)
            best_succ = best_succ | succ
    return SpatialResult(x_adv=best_x, success=best_succ, params=best_p)
