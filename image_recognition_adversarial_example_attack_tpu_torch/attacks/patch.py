"""Adversarial patch (Brown et al., NeurIPS-W 2017; port of
``attacks/patch.py``): a square patch of REPLACED pixels, no eps ball, that
pasted anywhere drives the classifier to a target class (or away from the
true one).

Robustness to placement comes from expectation over transformation: every
step pastes the patch at fresh per-sample positions and lattice rotations
(``sample_placements``) and takes a sign-gradient step on the expected loss,
the patch projected to [0,1].

The paste is one index-put per batch: the four rotations of the patch are
stacked, each sample takes its own, and the rows and columns it covers
are written into a copy of the batch.  Autograd of the index-put gives the
patch the gradient of exactly the pixels it replaced.  Start positions
follow ``lax.dynamic_update_slice``: a negative start counts once from the
end (plus the axis length), then every start is clamped so that the patch
fits; nothing raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.rng import device_generator, randint
from .api import LogitsFn, cross_entropy_sum


class PatchResult(NamedTuple):
    """patch: [P,P,C] in [0,1]; loss_per_step: [steps] EOT objective,
    sign-normalized so that rising means the attack is improving."""

    patch: torch.Tensor
    loss_per_step: torch.Tensor


def sample_placements(generator: torch.Generator, n: int, image_hw: tuple[int, int],
                      patch_size: int, *, rotations: bool = True,
                      device: torch.device | str = "cpu"):
    """Per-sample (rows, cols, rots), int64 [n] on ``device``, uniform over
    every position where the patch fits and over the four rotations (zeros
    without ``rotations``)."""
    h, w = image_hw
    g = device_generator(generator, device)
    rows = randint(h - patch_size + 1, (n,), g, device)
    cols = randint(w - patch_size + 1, (n,), g, device)
    if rotations:
        rots = randint(4, (n,), g, device)
    else:
        rots = torch.zeros((n,), dtype=torch.int64, device=device)
    return rows, cols, rots


def _paste(x: torch.Tensor, patch: torch.Tensor, rows, cols, rots) -> torch.Tensor:
    """Replace, in each image of ``x [B,H,W,C]``, the PxP square at its
    (clamped) row and column by the patch rotated by its ``rots`` quarter
    turns (``jnp.rot90`` over the two spatial axes)."""
    b, h, w, _ = x.shape
    p = patch.shape[0]
    dev = x.device
    rotated = torch.stack([torch.rot90(patch, k, dims=(0, 1)) for k in range(4)])
    per_sample = rotated[torch.as_tensor(rots, device=dev).long()].to(x.dtype)  # [B,P,P,C]
    r0, c0 = (torch.as_tensor(v, device=dev).long() for v in (rows, cols))
    r0 = torch.clamp(torch.where(r0 < 0, r0 + h, r0), 0, h - p)
    c0 = torch.clamp(torch.where(c0 < 0, c0 + w, c0), 0, w - p)
    ar = torch.arange(p, device=dev)
    bi = torch.arange(b, device=dev)[:, None, None]
    ri = (r0[:, None] + ar)[:, :, None]
    ci = (c0[:, None] + ar)[:, None, :]
    return x.index_put((bi, ri, ci), per_sample)


def apply_patch(x: torch.Tensor, patch: torch.Tensor, *,
                generator: torch.Generator | None = None,
                rows: torch.Tensor | None = None, cols: torch.Tensor | None = None,
                rots: torch.Tensor | None = None, rotations: bool = True) -> torch.Tensor:
    """Paste the patch into a batch ``x [B,H,W,C]``.

    Either explicit per-sample ``rows/cols`` (``rots`` may be left out only
    with ``rotations=False``) or a ``generator`` to sample every placement,
    not both."""
    b, h, w, _ = x.shape
    p = patch.shape[0]
    if rows is None or cols is None:
        if rows is not None or cols is not None:
            raise ValueError("rows/cols must be passed together")
        if generator is None:
            raise ValueError("apply_patch needs either explicit placements or a key")
        rows, cols, rots = sample_placements(generator, b, (h, w), p, rotations=rotations,
                                             device=x.device)
    else:
        if generator is not None:
            raise ValueError("pass either explicit placements or a key, not both")
        if rots is None:
            if rotations:
                raise ValueError("rots is required with explicit placements unless "
                                 "rotations=False")
            rots = torch.zeros((b,), dtype=torch.int64, device=x.device)
    return _paste(x, patch, rows, cols, rots)


def patch_attack(logits_fn: LogitsFn, xs: torch.Tensor, ys: torch.Tensor, *,
                 patch_size: int, steps: int = 250, lr: float = 1.0 / 255.0,
                 generator: torch.Generator, y_target: int | None = None,
                 rotations: bool = True) -> PatchResult:
    """Train a [patch_size, patch_size, C] patch on ``xs [B,H,W,C] / ys [B]``.

    With ``y_target`` (one class: the patch is universal) minimize the
    target's cross-entropy under random placement; untargeted, maximize
    the true labels'.  The patch starts at 0.5 and stays in [0,1]."""
    b, h, w, c = xs.shape
    p = int(patch_size)
    if not 0 < p <= min(h, w):
        raise ValueError(f"patch_size {p} must be in [1, {min(h, w)}]")
    if y_target is None:
        y_all, direction = ys, 1.0
    else:
        y_all, direction = torch.full_like(ys, int(y_target)), -1.0
    lr = float(lr)

    patch = torch.full((p, p, c), 0.5, dtype=xs.dtype, device=xs.device)
    losses = []
    for _ in range(int(steps)):
        rows, cols, rots = sample_placements(generator, b, (h, w), p, rotations=rotations,
                                             device=xs.device)
        q = patch.detach().requires_grad_(True)
        with torch.enable_grad():
            x_p = apply_patch(xs, q, rows=rows, cols=cols, rots=rots)
            loss = cross_entropy_sum(logits_fn(x_p), y_all) / b
            (g,) = torch.autograd.grad(loss, q)
        patch = torch.clamp(patch + lr * direction * torch.sign(g).to(patch.dtype), 0.0, 1.0)
        losses.append(direction * loss.detach())
    return PatchResult(patch=patch, loss_per_step=torch.stack(losses) if losses
                       else torch.zeros((0,), dtype=torch.float32, device=xs.device))


def patch_success_rate(logits_fn: LogitsFn, xs: torch.Tensor, patch: torch.Tensor, *,
                       generator: torch.Generator, y_target: int | None = None,
                       ys: torch.Tensor | None = None, rotations: bool = True) -> torch.Tensor:
    """Targeted: the fraction classified as ``y_target`` after pasting at
    fresh random placements.  Untargeted (pass ``ys``): the fraction
    misclassified."""
    x_p = apply_patch(xs, patch, generator=generator, rotations=rotations)
    with torch.no_grad():
        pred = torch.argmax(logits_fn(x_p), dim=-1)
    if y_target is not None:
        return torch.mean((pred == int(y_target)).to(torch.float32))
    if ys is None:
        raise ValueError("untargeted success needs ys")
    return torch.mean((pred != ys).to(torch.float32))
