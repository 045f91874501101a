"""Universal adversarial perturbations (port of ``attacks/uap.py``): ONE
L∞-bounded ``[H,W,C]`` delta that fools many images.

The stochastic-gradient formulation (Shafahi et al., AAAI 2020) of
Moosavi-Dezfooli et al.'s universal perturbations (CVPR 2017): epochs of
mini-batch sign-gradient ascent on the mean batch loss, the shared delta
projected to ``[-eps, eps]`` after every step (no ``[0,1]`` clip of the delta;
``apply_uap`` clips the image).  The gradient with respect to the shared
delta is the sum of the per-sample input gradients, one backward pass a
mini-batch.  The update is plain torch, not the pgd_step kernel, whose clip
to ``[0,1]`` does not apply to a delta.

Each epoch shuffles the images (``draw_permutation``) and drops the tail of
``N mod batch_size``; a full-batch run skips the permutation.  The random
start is ``draw_start``.  Nothing in the loop reads the card back.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.rng import device_generator
from ..parallel.distributed import all_reduce_sum
from ..parallel.mesh import ShardedTensor, data_sharding, on_device
from .api import LogitsFn, cross_entropy_sum


class UAPResult(NamedTuple):
    """delta: [H,W,C], |delta| <= eps; loss_per_epoch: [epochs], the mean
    loss of each epoch's LAST mini-batch before its update, sign-normalized
    so that rising means the attack is improving."""

    delta: torch.Tensor
    loss_per_epoch: torch.Tensor


def apply_uap(x: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """clip(x + delta, 0, 1); delta broadcasts over the batch axis."""
    return torch.clamp(x + delta, 0.0, 1.0)


def draw_start(shape, eps: float, generator: torch.Generator,
               device: torch.device | str) -> torch.Tensor:
    """The random start: Uniform(-eps, eps) float32 of ``shape`` on ``device``."""
    g = device_generator(generator, device)
    u = torch.rand(tuple(shape), generator=g, dtype=torch.float32, device=device)
    return u * (2.0 * float(eps)) - float(eps)


def draw_permutation(n: int, generator: torch.Generator,
                     device: torch.device | str) -> torch.Tensor:
    """One epoch's shuffle: a permutation of ``range(n)``, int64 on ``device``."""
    g = device_generator(generator, device)
    return torch.randperm(int(n), generator=g, device=device)


def uap_attack(logits_fn: LogitsFn, xs: torch.Tensor | ShardedTensor,
               ys: torch.Tensor | ShardedTensor, *, eps: float, alpha: float | None = None,
               epochs: int = 10, batch_size: int | None = None, generator: torch.Generator,
               y_target: int | None = None, random_start: bool = False) -> UAPResult:
    """Train a universal L∞ perturbation on ``xs [N,H,W,C] / ys [N]``.

    Untargeted: ascend the mean cross-entropy of the true labels.  With
    ``y_target`` (one class for every input): descend the target's.
    ``alpha`` defaults to ``eps/10``, ``batch_size`` to the full batch;
    ``random_start`` starts from Uniform(-eps, eps) instead of zeros.

    ``xs`` may be sharded over a mesh's data axis (``ys`` too, or placed
    as ``xs``; ``logits_fn`` a ``parallel.mesh.PerDevice`` or one callable
    for every shard): a plain tensor is one shard.  The delta lives on the
    first shard's device; each mini-batch's gradient is the sum of every
    shard's part (its rows of the mini-batch) in shard order, then over
    the processes.  The permutation and the start are drawn once, as for
    the unsharded set."""
    if isinstance(xs, ShardedTensor):
        ys = ys if isinstance(ys, ShardedTensor) else data_sharding(xs.sharding.mesh).place(
            torch.as_tensor(ys).cpu())
        x_shards, y_shards, ranges = xs.data_shards(), ys.data_shards(), xs.row_ranges()
    else:
        x_shards, y_shards, ranges = [xs], [ys], [(0, int(xs.shape[0]))]
    n = int(xs.shape[0])
    if batch_size is None:
        batch_size = n
    batch_size = int(batch_size)
    if not 0 < batch_size <= n:
        raise ValueError(f"batch_size {batch_size} must be in [1, {n}]")
    eps = float(eps)
    alpha = eps / 10.0 if alpha is None else float(alpha)
    n_batches = n // batch_size
    if y_target is None:
        direction = 1.0
    else:
        y_shards, direction = [torch.full_like(y, int(y_target)) for y in y_shards], -1.0
    # shuffling one full batch is a no-op on the summed gradient
    full_batch = n_batches == 1 and batch_size == n
    home, dtype = x_shards[0].device, x_shards[0].dtype

    if random_start:
        delta = draw_start(xs.shape[1:], eps, generator, home).to(dtype)
    else:
        delta = torch.zeros(xs.shape[1:], dtype=dtype, device=home)
    losses = []
    for _ in range(int(epochs)):
        if full_batch:
            idx = [None]
        else:
            perm = draw_permutation(n, generator, home)
            idx = perm[: n_batches * batch_size].reshape(n_batches, batch_size)
        for bidx in idx:
            # one mini-batch gathered at a time, as JAX's scan does; every
            # process reduces, even one holding none of the mini-batch
            g_sum = loss = None
            for x_i, y_i, (lo, hi) in zip(x_shards, y_shards, ranges):
                if bidx is None:
                    xb, yb = x_i, y_i
                else:
                    local = bidx[(bidx >= lo) & (bidx < hi)].to(x_i.device) - lo
                    if local.numel() == 0:
                        continue
                    xb, yb = x_i[local], y_i[local]
                d = delta.detach().to(x_i.device).requires_grad_(True)
                with torch.enable_grad():
                    part = cross_entropy_sum(on_device(logits_fn, x_i.device)(
                        apply_uap(xb, d)), yb) / batch_size
                    (g,) = torch.autograd.grad(part, d)
                g, part = g.to(home), part.detach().to(home)
                g_sum = g if g_sum is None else g_sum + g
                loss = part if loss is None else loss + part
            g_sum = all_reduce_sum(torch.zeros_like(delta) if g_sum is None else g_sum)
            loss = all_reduce_sum(torch.zeros((), device=home) if loss is None else loss)
            delta = torch.clamp(delta + alpha * direction * torch.sign(g_sum).to(delta.dtype),
                                -eps, eps)
        losses.append(direction * loss)
    return UAPResult(delta=delta, loss_per_epoch=torch.stack(losses) if losses
                     else torch.zeros((0,), dtype=torch.float32, device=home))


def uap_fooling_rate(logits_fn: LogitsFn, xs: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Fraction of samples whose prediction flips under x -> x + delta,
    measured against the model's own clean prediction (label-free)."""
    with torch.no_grad():
        clean = torch.argmax(logits_fn(xs), dim=-1)
        adv = torch.argmax(logits_fn(apply_uap(xs, delta)), dim=-1)
    return torch.mean((clean != adv).to(torch.float32))
