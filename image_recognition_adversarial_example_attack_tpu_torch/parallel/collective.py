"""Sums across the shards of a data-parallel step, where the shards'
computations are coupled: the port's counterpart of the reductions GSPMD
puts inside a sharded program (the batch statistics of ``train_bn``, and
the backward through them).

Shards whose work is independent (evaluation, training with frozen
BatchNorm) run one after another and need nothing here.  Under ``train_bn``
every forward normalizes by the whole batch's statistics, so the shards run
in ``lockstep``: one thread a shard, meeting at each collective.

- ``sum_over_shards(t)`` adds ``t`` over the shards (and the processes):
  one autograd node takes every shard's ``t``, so one backward reaches all
  of them.  ``models.resnet.batch_moments`` sums ``x`` and ``x²`` through
  it, then applies Flax's ``E[x²] - E[x]²``.
- ``shard_grad(outputs, inputs)`` is ``torch.autograd.grad`` over every
  shard's outputs at once (called by one thread for all), so the gradient of
  a shard's inputs takes in the other shards' losses through the shared
  statistics.  Outside lockstep it is ``torch.autograd.grad``.
- ``batch_rows()`` is the row count of the whole (micro-)batch while a
  sharded step runs: the losses divide by it, so the shards' losses add up
  to the unsharded loss and their gradients to its gradient.

Across processes the sums go through ``parallel.distributed.all_reduce_sum``
(forward and backward), as a SyncBatchNorm does.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Callable, Sequence

import torch

_local = threading.local()
BARRIER_TIMEOUT_S = 600.0


class ShardGroup:
    """``n`` threads (ranks 0..n-1) that meet at each collective; rank 0
    combines.  ``cross_process``: the sums also span the processes."""

    def __init__(self, n: int, cross_process: bool = False):
        self.n, self.cross_process = int(n), bool(cross_process)
        # a rank that never arrives (shards taking different paths) breaks
        # the barrier instead of hanging the step
        self.barrier = threading.Barrier(self.n, timeout=BARRIER_TIMEOUT_S)
        self.values: list = [None] * self.n
        self.result: list | None = None

    def exchange(self, rank: int, value, combine: Callable[[list], list]):
        """Every rank gives ``value``; rank 0 computes ``combine(values)``,
        a list with one entry a rank; each rank gets its entry."""
        self.values[rank] = value
        self.barrier.wait()
        if rank == 0:
            try:
                self.result = combine(list(self.values))
            except BaseException:
                self.barrier.abort()
                raise
        self.barrier.wait()
        out = self.result[rank]
        self.barrier.wait()  # every rank has read before the next exchange
        return out


def _context():
    return getattr(_local, "ctx", None)


@contextmanager
def shard_context(group: ShardGroup | None, rank: int, rows: int):
    """While it is open, this thread runs shard ``rank`` of a batch of
    ``rows`` rows (``group`` None: the shards are independent)."""
    prior = _context()
    _local.ctx = (group, rank, int(rows))
    try:
        yield
    finally:
        _local.ctx = prior


def batch_rows() -> int | None:
    """The whole batch's row count inside a sharded step, else None."""
    ctx = _context()
    return None if ctx is None else ctx[2]


def coupled() -> bool:
    """True while a lockstep (coupled) shard runs in this thread."""
    ctx = _context()
    return ctx is not None and ctx[0] is not None


def _process_sum(t: torch.Tensor) -> torch.Tensor:
    from .distributed import all_reduce_sum

    return all_reduce_sum(t)


class _SumOverShards(torch.autograd.Function):
    """Forward: every input summed in rank order (then over the processes),
    one copy on each input's device.  Backward: the same sum of the
    incoming gradients, to every input."""

    @staticmethod
    def forward(ctx, cross_process: bool, *ts):
        ctx.devices = [t.device for t in ts]
        ctx.cross_process = cross_process
        total = ts[0]
        for t in ts[1:]:
            total = total + t.to(ts[0].device)
        if cross_process:
            total = _process_sum(total)
        return tuple(total.to(d).clone() for d in ctx.devices)

    @staticmethod
    def backward(ctx, *gs):
        total = gs[0]
        for g in gs[1:]:
            total = total + g.to(gs[0].device)
        if ctx.cross_process:
            total = _process_sum(total)
        return (None, *(total.to(d) for d in ctx.devices))


def sum_over_shards(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the shards of the running lockstep step (and its
    processes), differentiable; ``t`` itself outside one."""
    ctx = _context()
    if ctx is None or ctx[0] is None:
        return t
    group, rank, _ = ctx
    return group.exchange(rank, t, lambda ts: list(
        _SumOverShards.apply(group.cross_process, *ts)))


def shard_grad(outputs, inputs: Sequence[torch.Tensor], **kw):
    """``torch.autograd.grad(outputs, inputs, **kw)``; in lockstep over the
    outputs of every shard at once, each shard getting its inputs'
    gradients."""
    ctx = _context()
    if ctx is None or ctx[0] is None:
        return torch.autograd.grad(outputs, inputs, **kw)
    group, rank, _ = ctx
    outs = [outputs] if isinstance(outputs, torch.Tensor) else list(outputs)

    def combine(items):
        all_out = [t for outs_i, _ in items for t in outs_i]
        all_in = [t for _, ins in items for t in ins]
        grads = torch.autograd.grad(all_out, all_in, **kw)
        res, k = [], 0
        for _, ins in items:
            res.append(tuple(grads[k:k + len(ins)]))
            k += len(ins)
        return res

    return group.exchange(rank, (outs, list(inputs)), combine)


def run_lockstep(fns: Sequence[Callable[[], object]], rows: int,
                 cross_process: bool = False) -> list:
    """Run ``fns[i]()`` as shard i of a coupled step, one thread each, and
    return their results in order; the first failure is raised."""
    group = ShardGroup(len(fns), cross_process)
    results: list = [None] * len(fns)
    errors: list = [None] * len(fns)
    grad_mode = torch.is_grad_enabled()

    def work(i: int) -> None:
        try:
            with torch.set_grad_enabled(grad_mode), shard_context(group, i, rows):
                results[i] = fns[i]()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors[i] = e
            group.barrier.abort()

    threads = [threading.Thread(target=work, args=(i,), daemon=True) for i in range(len(fns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    first = next((e for e in errors if e is not None
                  and not isinstance(e, threading.BrokenBarrierError)), None)
    first = first or next((e for e in errors if e is not None), None)
    if first is not None:
        raise first
    return results
