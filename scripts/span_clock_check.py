"""The program's span log against the profiler's trace of the same stretch,
in the benchmark's cells (``BENCHMARK.json``, each unit run by the
benchmark's own ``Job`` of the cell), on a CUDA card.

For each cell it warms the cell up, then profiles ``--units`` whole units
(torch.profiler, CPU and CUDA) with the program's span log emptied first,
and reports:

- ``clock``: each ``kernel.pgd_step`` span against the i-th pgd_step kernel
  of the trace: the device operations whose midpoints the span holds (by
  the trace, once shifted by the median offset), the span's device
  duration by its events less the kernel's, and the span's device start
  less the kernel's start (the offset between the two clocks: its spread
  over the stretch); the same offset on the host, the host enter of each
  span that counted ``syncs`` against the trace's ``cudaStreamSynchronize``
  call it made first; the trace against itself, each such call's end less
  the end of the copy to the device it waited for (never below 0 on one
  clock); and how far the log's device clock has moved from the host's by
  the stretch's end (an empty span after the last synchronize, whose event
  runs as it is recorded);
- ``syncs``: the ``syncs`` total of the log against the trace's
  ``cudaStreamSynchronize`` and blocking ``cudaMemcpy*`` runtime calls
  (each runtime call that waits, by name);
- ``gaps``: the device's idle gaps in the trace, each with the innermost
  program span open on the host when it began and where it lies on the
  device (inside a leaf span, or before the leaf span the device ran
  next), summed by each, and the ten longest; a gap's time is moved onto
  the log's clock by the offset of the pgd_step kernels on either side;
- ``unprofiled``: the same units with the recorder forced on and no
  profiler: seconds per unit, the readers' syncs per step, issue ms per
  pass and starved share (``benchmark_port/spanlog.py``) without the
  profiler's cost on the host, the device ms of the ``model.normalize``
  spans and the host ms blocked in ``syncs``, per unit (as ``traced``);
- ``cost``: host seconds per unit with the recorder on and off, unit by
  unit in turns with no profiler (forced on), and stretch by stretch under
  the profiler; and the host cost of one span, on (in a profiled session)
  and off.

    python scripts/span_clock_check.py [--cells a,b] [--units 3] [--out out.json]

``--device cpu --batch 2 --image-size 32`` runs the same code at a toy size
on the CPU (no device intervals: clock and gaps are empty) to rehearse it.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")
ANNOTATION = "pb."  # the benchmark's record_function spans: no device operations


def card_name() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except OSError:
        return "no nvidia-smi"


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def profiled(job, first: int, units: int, device):
    """(profiler, spans, host seconds) of ``units`` whole units."""
    from torch.profiler import ProfilerActivity, profile

    from image_recognition_adversarial_example_attack_tpu_torch.utils import profiling

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda"
                                           else [])
    profiling.reset_spans()
    sync(device)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for i in range(units):
            job.unit(first + i)
        sync(device)
        seconds = time.perf_counter() - t0
        with profiling.span("check.clock_end"):
            pass
    return prof, profiling.spans(), seconds


def unprofiled(job, first: int, units: int, device, recorder: bool = True):
    """(spans, seconds) of ``units`` whole units with no profiler, the
    recorder forced on (or off)."""
    from image_recognition_adversarial_example_attack_tpu_torch.utils import profiling

    recording = profiling._recording
    profiling._recording = (lambda: True) if recorder else (lambda: False)
    profiling.reset_spans()
    try:
        sync(device)
        t0 = time.perf_counter()
        for i in range(units):
            job.unit(first + i)
        sync(device)
        seconds = time.perf_counter() - t0
    finally:
        profiling._recording = recording
    return profiling.spans(), seconds


def trace_events(prof):
    """(device operations [(name, start_us, end_us)], host runtime calls
    [(name, start_us, end_us)]) of a finished profile."""
    from torch.autograd import DeviceType

    ops, calls = [], []
    for e in prof.events():
        item = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type != DeviceType.CUDA:
            calls.append(item)
        elif not e.name.startswith(ANNOTATION):
            ops.append(item)
    return sorted(ops, key=lambda o: o[1]), sorted(calls, key=lambda c: c[1])


def clock_check(spans, ops, calls) -> dict:
    steps = sorted((s for s in spans if s["name"] == "kernel.pgd_step"
                    and s["device_enter_ns"] is not None), key=lambda s: s["device_enter_ns"])
    kernels = [o for o in ops if "pgd_step" in o[0]]
    if not steps or len(steps) != len(kernels):
        return {"spans": len(steps), "kernels": len(kernels)}
    offsets = [s["device_enter_ns"] / 1e3 - k[1] for s, k in zip(steps, kernels)]
    shift = statistics.median(offsets)
    marks = [(k[1], o) for k, o in zip(kernels, offsets)]
    held = [sum(1 for o in ops if s["device_enter_ns"] / 1e3 <= (o[1] + o[2]) / 2
                + local_offset(marks, o[1]) <= s["device_exit_ns"] / 1e3) for s in steps]
    dur_gap = [(s["device_exit_ns"] - s["device_enter_ns"]) / 1e3 - (k[2] - k[1])
               for s, k in zip(steps, kernels)]
    t0 = kernels[0][1]
    end = next((s for s in spans if s["name"] == "check.clock_end"), None)
    return {"spans": len(steps), "kernels": len(kernels),
            "ops_held": sorted(set(held)),
            "kernel_us_median": statistics.median(k[2] - k[1] for k in kernels),
            "duration_gap_us": [min(dur_gap), statistics.median(dur_gap), max(dur_gap)],
            "offset_us_median": shift, "offset_spread_us": max(offsets) - min(offsets),
            "offsets": [[round((k[1] - t0) / 1e3, 3), round(o - shift, 3), round(g, 3)]
                        for k, o, g in zip(kernels, offsets, dur_gap)],
            "marks": marks,
            "host": host_clock_check(spans, ops, calls, t0),
            "end_drift_us": None if end is None or end["device_enter_ns"] is None else
            (end["device_enter_ns"] - end["host_enter_ns"]) / 1e3}


def local_offset(marks, t_us: float) -> float:
    """The log's clock less the trace's at trace time ``t_us``: linear
    between the pgd_step kernels on either side (``marks``: [(kernel start,
    offset)])."""
    if t_us <= marks[0][0]:
        return marks[0][1]
    for (t1, o1), (t2, o2) in zip(marks, marks[1:]):
        if t_us <= t2:
            return o1 + (o2 - o1) * (t_us - t1) / (t2 - t1)
    return marks[-1][1]


def host_clock_check(spans, ops, calls, t0) -> dict:
    """The host clock against the trace's: each span that counted syncs,
    its host enter less the start of the first ``cudaStreamSynchronize``
    it made; and the trace against itself: each such call's end less the
    end of the copy to the device before it."""
    syncs = [c for c in calls if c[0] == "cudaStreamSynchronize"]
    holders = sorted((s for s in spans if s["counts"].get("syncs")),
                     key=lambda s: s["host_enter_ns"])
    firsts, at = [], 0
    for s in holders:
        if at < len(syncs):
            firsts.append((s, syncs[at]))
        at += s["counts"]["syncs"]["n"]
    if at != len(syncs) or not firsts:
        return {"syncs": len(syncs), "counted": at}
    host = [s["host_enter_ns"] / 1e3 - c[1] for s, c in firsts]
    copies = [o for o in ops if o[0].startswith("Memcpy HtoD")]
    out = {"syncs": len(syncs), "host_offset_us_median": statistics.median(host),
           "host_offset_spread_us": max(host) - min(host),
           "host_offsets": [[round((c[1] - t0) / 1e3, 3),
                             round(h - statistics.median(host), 3)]
                            for (_, c), h in zip(firsts, host)]}
    if len(copies) == len(syncs):
        slack = [c[2] - m[2] for c, m in zip(syncs, copies)]
        out["sync_end_less_copy_end_us"] = [[round((m[1] - t0) / 1e3, 3), round(x, 3)]
                                            for m, x in zip(copies, slack)]
    else:
        out["copies"] = len(copies)
    return out


def sync_check(spans, calls) -> dict:
    counted = sum(s["counts"].get("syncs", {}).get("n", 0) for s in spans)
    by_name: dict[str, int] = {}
    for name, _, _ in calls:
        blocking_copy = name.startswith("cudaMemcpy") and "Async" not in name
        if name in WAITS or blocking_copy:
            by_name[name] = by_name.get(name, 0) + 1
    trace = by_name.get("cudaStreamSynchronize", 0) + sum(
        n for k, n in by_name.items() if k.startswith("cudaMemcpy"))
    return {"log_syncs": counted, "trace_stream_syncs_and_blocking_copies": trace,
            "trace_waits_by_name": by_name}


def innermost(spans, t_ns, enter, leave):
    best = None
    for s in spans:
        if s[enter] is not None and s[enter] <= t_ns < s[leave]:
            if best is None or s[enter] >= best[enter]:
                best = s
    return best


def gap_check(spans, ops, marks) -> dict:
    """Idle gaps of the device in the trace, named by the program's spans."""
    if not ops or not marks:
        return {}
    by_id = {s["id"]: s for s in spans}
    parents = {s["parent"] for s in spans}
    leaves = sorted((s for s in spans if s["device_enter_ns"] is not None
                     and s["id"] not in parents), key=lambda s: s["device_enter_ns"])
    gaps, end = [], ops[0][2]
    for _, start, stop in ops:
        if start > end:
            gaps.append((end, start - end))
        end = max(end, stop)

    def label(s):
        if s is None:
            return "outside the program's spans"
        p = by_id.get(s["parent"])
        return s["name"] if p is None else f"{p['name']}>{s['name']}"

    by_host, by_device, longest = {}, {}, []
    for start, length in gaps:
        t_ns = (start + local_offset(marks, start)) * 1e3
        host = label(innermost(spans, t_ns, "host_enter_ns", "host_exit_ns"))
        dev = innermost(spans, t_ns + 1e3, "device_enter_ns", "device_exit_ns")
        if dev is not None and dev["id"] not in parents:
            where = "in " + label(dev)
        else:
            where = "before " + label(next((s for s in leaves
                                            if s["device_enter_ns"] >= t_ns - 2e3), None))
        for table, key in ((by_host, host), (by_device, where)):
            n, total = table.get(key, (0, 0.0))
            table[key] = (n + 1, total + length)
        longest.append((length, host, where))
    longest.sort(reverse=True)

    def top(table):
        return {k: {"n": n, "us": us}
                for k, (n, us) in sorted(table.items(), key=lambda kv: -kv[1][1])[:12]}

    return {"window_us": ops[-1][2] - ops[0][1], "idle_us": sum(g[1] for g in gaps),
            "gaps": len(gaps), "by_host_span": top(by_host), "on_device": top(by_device),
            "longest": [{"us": us, "host": h, "device": d} for us, h, d in longest[:10]]}


def cost_check(job, first: int, pairs: int, rounds: int, units: int, device) -> dict:
    """Host seconds per unit with the recorder on and off in turns: unit by
    unit with no profiler (the recorder forced on), and stretch by stretch
    under the profiler."""
    from image_recognition_adversarial_example_attack_tpu_torch.utils import profiling

    recording = profiling._recording
    runs = {"unprofiled_on": [], "unprofiled_off": [], "profiled_on": [], "profiled_off": []}
    at, spans_per_unit = first, None
    for r in range(pairs):
        for state in ("on", "off") if r % 2 == 0 else ("off", "on"):
            spans, seconds = unprofiled(job, at, 1, device, recorder=state == "on")
            runs[f"unprofiled_{state}"].append(seconds)
            spans_per_unit = len(spans) if state == "on" else spans_per_unit
            at += 1
    for r in range(rounds):
        for state in ("on", "off") if r % 2 == 0 else ("off", "on"):
            profiling._recording = recording if state == "on" else (lambda: False)
            try:
                _, _, seconds = profiled(job, at, units, device)
            finally:
                profiling._recording = recording
            runs[f"profiled_{state}"].append(seconds / units)
            at += units
    out = dict(runs, spans_per_unit=spans_per_unit)
    for kind in ("unprofiled", "profiled"):
        if runs[f"{kind}_on"]:
            on, off = runs[f"{kind}_on"], runs[f"{kind}_off"]
            delta = statistics.median(on) - statistics.median(off)
            out[f"{kind}_on_less_off_ms_per_unit"] = delta * 1e3
            out[f"{kind}_paired_ms"] = sorted(round((a - b) * 1e3, 3) for a, b in zip(on, off))
    return out


def span_cost(device) -> dict:
    """Host us of one empty span: off (no profiler) and on (a profiled
    session; on a card, with its two events)."""
    from torch.profiler import ProfilerActivity, profile

    from image_recognition_adversarial_example_attack_tpu_torch.utils import profiling

    n_off, n_on = 1_000_000, 20_000
    t0 = time.perf_counter()
    for _ in range(n_off):
        with profiling.span("x"):
            pass
    off = (time.perf_counter() - t0) / n_off
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda"
                                           else [])
    profiling.reset_spans()
    with profile(activities=activities):
        t0 = time.perf_counter()
        for _ in range(n_on):
            with profiling.span("x"):
                pass
        on = (time.perf_counter() - t0) / n_on
    profiling.reset_spans()
    return {"off_us": off * 1e6, "on_us": on * 1e6}


def check_cell(run, manifest, name, args, device) -> dict:
    import torch

    cell = run.Cell(manifest, name)
    if args.batch:
        cell.traffic["batch"] = args.batch
    if args.image_size:
        cell.config["image_size"] = args.image_size
    jobs = cell.piece(f"drivers/{cell.traffic['driver']}")
    t0 = time.perf_counter()
    job = jobs.Job(cell, args.seed, device)
    job.warm_up()
    for i in range(2):
        job.unit(i)
    sync(device)
    setup = time.perf_counter() - t0
    prof, spans, seconds = profiled(job, 2, args.units, device)
    ops, calls = trace_events(prof)
    clock = clock_check(spans, ops, calls)
    spanlog = run.load("spanlog")
    root = "attack" if job.kind == "eval" else "train.step"
    step = "attack.step" if job.kind == "eval" else "train.step"

    def readings(spans):
        log = spanlog.Log(spans)
        norm = [s for s in spans if s["name"] == "model.normalize"
                and s["device_enter_ns"] is not None]
        return {"syncs_per_step": spanlog.syncs_per_step(log, root, step),
                "issue_ms_per_pass": spanlog.issue_ms_per_pass(log, root),
                "starved_share": spanlog.starved_share(log, root),
                "normalize_device_ms_per_unit": sum(
                    s["device_exit_ns"] - s["device_enter_ns"] for s in norm) / 1e6 / args.units,
                "normalize_spans_per_unit": len(norm) / args.units,
                "sync_blocked_ms_per_unit": spanlog.counted(spans)[1] * 1e3 / args.units}

    quiet, quiet_s = unprofiled(job, 2 + args.units, args.units, device)
    out = {"setup_s": setup, "traced_s_per_unit": seconds / args.units, "spans": len(spans),
           "traced": readings(spans), "clock": clock, "syncs": sync_check(spans, calls),
           "gaps": gap_check(spans, ops, clock.pop("marks", None)),
           "unprofiled": dict(readings(quiet), s_per_unit=quiet_s / args.units),
           "cost": cost_check(job, 2 + 2 * args.units, args.pairs, args.rounds, args.units,
                              device)}
    job.free()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", default="resnet50.pgd10.b128,vit_b_16.pgd10.b128,"
                    "resnet50.defense.b128,resnet50.pgdat7.b128")
    ap.add_argument("--units", type=int, default=3, help="units in each profiled stretch")
    ap.add_argument("--pairs", type=int, default=12,
                    help="units with the recorder on and off, in turns, with no profiler")
    ap.add_argument("--rounds", type=int, default=2,
                    help="stretches with the recorder on and off, in turns, under the profiler")
    ap.add_argument("--seed", type=int, default=3141592653)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=0, help="a toy batch, to rehearse")
    ap.add_argument("--image-size", type=int, default=0, help="a toy size, to rehearse")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "span_check.json"))
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("span_clock_check: CUDA is not available", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("_portbench_run",
                                                  ROOT / "benchmark_port" / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    result = {"card": card_name() if device.type == "cuda" else "cpu",
              "span_cost": span_cost(device), "cells": {}}
    for name in args.cells.split(","):
        result["cells"][name] = check_cell(run, manifest, name, args, device)
        print(f"SPAN_CHECK {name} {json.dumps(result['cells'][name])}", flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(f"SPAN_CHECK card={result['card']} span_cost={json.dumps(result['span_cost'])}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
