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
- ``exchange(value, combine)`` hands every shard's value to one combine
  (the EOT wrapper's input mix, ``attacks/eot.py``); ``whole_rows(t)`` is
  the whole batch's ``t`` in every shard (shot noise's rates,
  ``core.rng.rates_draw``).  Shards that run one after another cannot
  exchange: there they raise.
- ``checkpoint_contexts`` is ``torch.utils.checkpoint``'s ``context_fn``
  for a forward that may run in a lockstep shard (remat under
  ``train_bn``).  The checkpointed forward runs again inside the backward,
  which one thread starts for every shard (``shard_grad``) and which on a
  card runs on the autograd engine's device thread, outside every shard's
  context.  So the first forward records each ``sum_over_shards`` result
  (outputs of the one summing node, so the backward through them still
  reaches every shard), and the recompute runs under the shard's context
  and reads them back in order, making no collective.  Under
  ``grad_accum`` each micro-batch's forward records its own statistics.

Across processes the sums go through ``parallel.distributed.all_reduce_sum``
(forward and backward), as a SyncBatchNorm does.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Callable, Sequence

import torch

from ..utils.profiling import span

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


def spans_processes() -> bool:
    """True while a lockstep shard whose collectives span the processes
    runs in this thread."""
    ctx = _context()
    return ctx is not None and ctx[0] is not None and ctx[0].cross_process


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
    processes), differentiable; ``t`` itself outside one.  In the recompute
    of a checkpointed forward, the sum its first run recorded."""
    replay = getattr(_local, "replay", None)
    if replay is not None:
        out = next(replay, None)
        if out is None:
            raise RuntimeError("a checkpointed forward's recompute summed more over the "
                               "shards than its first run")
        return out
    ctx = _context()
    if ctx is None or ctx[0] is None:
        return t
    group, rank, _ = ctx
    out = group.exchange(rank, t, lambda ts: list(
        _SumOverShards.apply(group.cross_process, *ts)))
    record = getattr(_local, "record", None)
    if record is not None:
        record.append(out)
    return out


class _Recording:
    """The first forward of a checkpointed region: ``sum_over_shards``
    appends its results to ``saved``."""

    def __init__(self, saved: list):
        self.saved = saved

    def __enter__(self):
        self.prior = getattr(_local, "record", None)
        _local.record = self.saved

    def __exit__(self, *exc):
        _local.record = self.prior


class _Replaying:
    """A recompute of the region, on whichever thread runs it: the shard's
    context of the first forward, and ``sum_over_shards`` reading the
    recorded sums in order (re-entrant: every recompute starts over)."""

    def __init__(self, ctx, saved: list):
        self.ctx, self.saved = ctx, saved

    def __enter__(self):
        self.prior = (_context(), getattr(_local, "replay", None))
        coupled_shard = self.ctx is not None and self.ctx[0] is not None
        _local.ctx, _local.replay = self.ctx, iter(self.saved) if coupled_shard else None

    def __exit__(self, *exc):
        _local.ctx, _local.replay = self.prior


def checkpoint_contexts():
    """``context_fn`` of ``torch.utils.checkpoint(..., use_reentrant=False)``
    for a forward that may run in a lockstep shard (module doc): called at
    the forward, in the shard's thread."""
    saved: list = []
    return _Recording(saved), _Replaying(_context(), saved)


def exchange(value, combine: Callable[[list], list]):
    """Every shard of the running lockstep step gives ``value``; one of them
    computes ``combine(values)`` (in rank order; a list with one entry a
    shard) and each gets its entry.  Outside a sharded run
    ``combine([value])[0]``.  A shard of shards that run one after another
    raises: the others' values do not exist yet."""
    ctx = _context()
    if ctx is None:
        return combine([value])[0]
    group, rank, _ = ctx
    if group is None:
        raise RuntimeError("this draw needs every shard's rows at once: run the shards in "
                           "lockstep (parallel.collective.run_lockstep)")
    return group.exchange(rank, value, combine)


def whole_rows(t: torch.Tensor) -> torch.Tensor:
    """The whole batch's ``t`` in every shard of the running lockstep step:
    the shards' ``t`` concatenated on axis 0 in rank order, then every
    process's (``cross_process``), on the first shard's device; ``t``
    outside a sharded run."""
    cross = spans_processes()

    def combine(ts):
        whole = torch.cat([x.to(ts[0].device) for x in ts])
        return [_gather_processes(whole) if cross else whole] * len(ts)

    return exchange(t, combine)


def _gather_processes(t: torch.Tensor) -> torch.Tensor:
    """Every process's ``t`` (row counts may differ) on axis 0, in process
    order."""
    from .distributed import all_gather_rows

    counts = all_gather_rows(torch.tensor([t.shape[0]], device=t.device)).tolist()
    most = max(counts)
    padded = torch.cat([t, t.new_zeros((most - t.shape[0], *t.shape[1:]))])
    parts = all_gather_rows(padded).split(most)
    return torch.cat([p[:c] for p, c in zip(parts, counts)])


def process_row_offset(rows: int, cross_process: bool) -> int:
    """The first global row of this process's ``rows`` rows: the rows of the
    processes before it (0 within one process)."""
    if not cross_process:
        return 0
    from .distributed import all_gather_rows, process_index

    counts = all_gather_rows(torch.tensor([int(rows)])).tolist()
    return int(sum(counts[:process_index()]))


def shard_grad(outputs, inputs: Sequence[torch.Tensor], **kw):
    """``torch.autograd.grad(outputs, inputs, **kw)``; in lockstep over the
    outputs of every shard at once, each shard getting its inputs'
    gradients.  The span ``model.backward``."""
    with span("model.backward"):
        return _shard_grad(outputs, inputs, **kw)


def _shard_grad(outputs, inputs: Sequence[torch.Tensor], **kw):
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
