"""Reduction of a torch.profiler trace of the traced stretch to the summary
that the per-layer metric readers take.

The kernel classes are data (``kernel_classes.json``): a frozen copy of the
name fragments that the program's chip smoke test uses to split a PGD
step's device time by layer, with LayerNorm added.  The first class whose
fragment occurs in a kernel's lower-cased name takes it; a kernel that
matches none is "other elementwise".  Busy time is the union of the kernel
intervals, so work of two streams at once counts once.
"""

from __future__ import annotations

import json
from pathlib import Path

CLASSES = tuple((name, tuple(frags)) for name, frags in
                json.loads((Path(__file__).parent / "kernel_classes.json").read_text()))
OTHER = "other elementwise"
NAME_CHARS = 160  # a kernel's name as the breakdown gives it


def classify(kernel_name: str) -> str:
    low = kernel_name.lower()
    return next((c for c, frags in CLASSES if any(f in low for f in frags)), OTHER)


def busy_union(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for start, stop in sorted(intervals):
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy


def idle_gaps(intervals, lo: float, hi: float):
    """(start, length) of every stretch in [lo, hi] that no interval covers."""
    gaps, end = [], lo
    for start, stop in sorted(intervals):
        if start > end:
            gaps.append((end, start - end))
        end = max(end, stop)
    if hi > end:
        gaps.append((end, hi - end))
    return gaps


def host_span_at(spans, t: float) -> str:
    """The innermost (latest-starting) host span open at time ``t``."""
    best = None
    for name, start, stop in spans:
        if start <= t < stop and (best is None or start >= best[1]):
            best = (name, start)
    return best[0] if best else "outside the benchmark's spans"


def reduce_events(kernels, spans, t_lo: float, t_hi: float) -> dict:
    """``kernels``: [(name, start_us, end_us)] of the device's operations;
    ``spans``: [(name, start_us, end_us)] of the benchmark's host spans;
    [t_lo, t_hi]: the stretch's bounds on the trace's clock, in
    microseconds."""
    per_kernel: dict[str, list] = {}
    by_class: dict[str, float] = {}
    for name, start, stop in kernels:
        dur = (stop - start) / 1e6
        k = per_kernel.setdefault(name, [0, 0.0])
        k[0] += 1
        k[1] += dur
        c = classify(name)
        by_class[c] = by_class.get(c, 0.0) + dur
    intervals = [(s, e) for _, s, e in kernels]
    gaps = sorted(idle_gaps(intervals, t_lo, t_hi), key=lambda g: -g[1])
    return {
        "window_s": (t_hi - t_lo) / 1e6,
        "busy_s": busy_union(intervals) / 1e6,
        "kernel_count": len(kernels),
        "kernel_total_s": sum(v[1] for v in per_kernel.values()),
        "by_class_s": by_class,
        "per_kernel": per_kernel,
        "idle_gaps": [[host_span_at(spans, start), length / 1e6] for start, length in gaps[:10]],
        "device_ops": [[n[:NAME_CHARS], v[1]] for n, v in
                       sorted(per_kernel.items(), key=lambda kv: -kv[1][1])[:10]],
    }


def profiled_events(prof, span_prefix: str):
    """(kernels, spans) from a finished ``torch.profiler.profile``: every
    operation that ran on a CUDA device, and the host spans whose names
    start with ``span_prefix`` (their copies on the device's timeline are
    no operations and are left out)."""
    from torch.autograd import DeviceType

    kernels, spans = [], []
    for e in prof.events():
        tr = e.time_range
        if e.name.startswith(span_prefix):
            if e.device_type != DeviceType.CUDA:
                spans.append((e.name[len(span_prefix):], float(tr.start), float(tr.end)))
        elif e.device_type == DeviceType.CUDA:
            kernels.append((e.name, float(tr.start), float(tr.end)))
    return kernels, spans
