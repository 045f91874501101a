"""Phase timing (port of ``PhaseTimer``/``PhaseRecord`` of
``utils/profiling.py``), ``device_timer`` for one block, and the program's
spans and counters.

**Spans.** ``span(name)`` opens a layer span, ``count(name)`` wraps an
event: a call that waits on the device, or a route the program took.  Both
record only while a ``torch.profiler`` session records
(``torch.autograd._profiler_enabled()``): the benchmark's traced stretch
and every CLI's ``--profile-dir``.  Otherwise they cost that
one check, allocate nothing and return one shared no-op context.  Nothing
reaches the profiler's own event list: a span is no ``record_function``,
whose copy on the device's timeline a trace reader would count as a device
operation.

A recorded span keeps its name, id, parent id, the id of its top-level span
(the outermost span open in its thread: one ``run_attack``, one
``evaluate_defenses_batch``, one training step), host enter and exit
(``time.perf_counter_ns``), and, once CUDA is initialized, a pair of timing
events recorded on the current stream at enter and exit.  The log's first
such span on each card synchronizes that card once and records an origin
event at a known host time, so ``spans()`` gives device intervals on the
host's clock.

**Counters.** ``count(name)`` adds one, and the host seconds its block
took, to counter ``name`` of the innermost open span of its thread.
``count("syncs")`` marks where the program waits on the device itself: a
copy from host memory that is not ``non_blocking``, ``.item()``,
``.tolist()``, ``float``/``int``/``bool`` of a device tensor, an explicit
synchronize.  ``count("bn_fused")`` and ``count("bn_plain")`` mark each
ResNet BatchNorm chain (``models/resnet.py::bn_relu``) by the route it
took, around its call.  A count with no open span is dropped; every
``syncs`` call site lies inside a span of its own, and the models run inside
``model.net`` on the attack, defense and training paths.

``cli/common.py::maybe_profile`` writes the log as ``spans.json`` beside
its Chrome trace.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch

_NOOP = contextlib.nullcontext()
_recording = torch.autograd._profiler_enabled


class _Log:
    """The finished spans since the last ``reset_spans``, and the origin of
    each card's clock: card index -> (origin event, host ns at its record)."""

    def __init__(self):
        self.records: list[_Span] = []
        self.ids = itertools.count(1)
        self.origins: dict[int, tuple[torch.cuda.Event, int]] = {}
        self.local = threading.local()

    def stack(self) -> list:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack


_LOG = _Log()


def _take_origin(device: int) -> None:
    """The clock origin of card ``device``: after one synchronize its stream
    is empty, so the origin event runs as it is recorded.  Its first record
    creates it, which takes far longer than a record; the timed one is the
    second."""
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter_ns()
    event.record()
    _LOG.origins[device] = (event, (t0 + time.perf_counter_ns()) // 2)


class _Span:
    __slots__ = ("name", "id", "parent", "top", "enter_ns", "exit_ns", "device", "events",
                 "counts")

    def __init__(self, name: str):
        self.name = name
        self.counts: dict[str, list[int]] = {}
        self.events = None

    def __enter__(self):
        stack = _LOG.stack()
        self.id = next(_LOG.ids)
        self.parent = stack[-1].id if stack else None
        self.top = stack[0].id if stack else self.id
        stack.append(self)
        if torch.cuda.is_initialized():
            self.device = torch.cuda.current_device()
            if self.device not in _LOG.origins:
                _take_origin(self.device)
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.enter_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.exit_ns = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record()
        _LOG.stack().pop()
        _LOG.records.append(self)
        return False

    def as_dict(self) -> dict:
        rec = {"name": self.name, "id": self.id, "parent": self.parent, "top": self.top,
               "host_enter_ns": self.enter_ns, "host_exit_ns": self.exit_ns,
               "device_enter_ns": None, "device_exit_ns": None,
               "counts": {k: {"n": n, "blocked_s": ns / 1e9}
                          for k, (n, ns) in self.counts.items()}}
        if self.events is not None:
            event, host_ns = _LOG.origins[self.device]
            rec["device_enter_ns"], rec["device_exit_ns"] = (
                host_ns + round(event.elapsed_time(e) * 1e6) for e in self.events)
        return rec


class _Count:
    __slots__ = ("name", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        stack = _LOG.stack()
        if stack:
            c = stack[-1].counts.setdefault(self.name, [0, 0])
            c[0] += 1
            c[1] += time.perf_counter_ns() - self.t0
        return False


def span(name: str):
    """A context that records a span named ``name`` while a profiler
    session records, and the shared no-op otherwise."""
    if not _recording():
        return _NOOP
    return _Span(name)


def count(name: str, on: bool = True):
    """A context around one event (a call that waits on the device, a route
    taken): while a profiler session records and ``on`` holds, its end adds
    one and the block's host seconds to counter ``name`` of the innermost
    open span."""
    if not (on and _recording()):
        return _NOOP
    return _Count(name)


def spans() -> list[dict]:
    """The finished spans of the log, in the order they opened, as dicts:
    ``name``, ``id``, ``parent``, ``top``, ``host_enter_ns``,
    ``host_exit_ns``, ``device_enter_ns`` and ``device_exit_ns`` (on the
    host's ``perf_counter_ns`` clock; None without CUDA), and ``counts``
    (counter -> ``{"n", "blocked_s"}``).  Synchronizes the device first
    when the log holds device events."""
    for device in _LOG.origins:
        torch.cuda.synchronize(device)
    return [s.as_dict() for s in sorted(_LOG.records, key=lambda s: s.id)]


def origins_ns() -> dict[int, int]:
    """Card index -> the host ns at which the log's clock of that card
    starts (empty without CUDA)."""
    return {device: host_ns for device, (_, host_ns) in _LOG.origins.items()}


def reset_spans() -> None:
    """Empties the log; the next span on a card takes a new origin."""
    _LOG.records = []
    _LOG.origins = {}


@dataclass
class PhaseRecord:
    name: str
    seconds: float
    examples: int | None = None

    @property
    def examples_per_sec(self) -> float | None:
        if self.examples is None or self.seconds <= 0:
            return None
        return self.examples / self.seconds


@dataclass
class PhaseTimer:
    """Collects named phase timings; each phase is also a span of its name.
    CUDA work is asynchronous: the caller waits for the device (a
    ``.tolist()``, ``torch.cuda.synchronize()``) before the phase exits."""

    records: list[PhaseRecord] = field(default_factory=list)

    @contextmanager
    def phase(self, name: str, examples: int | None = None):
        t0 = time.perf_counter()
        try:
            with span(name):
                yield
        finally:
            self.records.append(PhaseRecord(name=name, seconds=time.perf_counter() - t0,
                                            examples=examples))

    def as_dict(self) -> dict:
        return {
            r.name: {
                "seconds": round(r.seconds, 4),
                **({"examples": r.examples,
                    "examples_per_sec": round(r.examples_per_sec, 2)}
                   if r.examples is not None else {}),
            }
            for r in self.records
        }


@contextmanager
def device_timer():
    """Times a block: ``with device_timer() as t: out = fn(x);
    torch.cuda.synchronize()``, then ``t()`` is the seconds elapsed since
    the block began.  The caller waits for the device inside the block
    (CUDA work is asynchronous)."""
    t0 = time.perf_counter()
    yield lambda: time.perf_counter() - t0
