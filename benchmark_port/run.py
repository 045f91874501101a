#!/usr/bin/env python3
"""The port's benchmark: one process runs one cell of ``BENCHMARK.json`` once.

    python3 benchmark_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It finds every piece of the cell by name: the configuration's file (from
``BENCHMARK.json``), ``traffic/<traffic>.json`` and the driver it names
(``drivers/<driver>.py``), ``flops/<family>.py``, ``reference/<reference>.py``,
``limits/<cell>.json``, every ``kernels/*.py`` and, in a traced run, the
reader ``metrics/<metric>.py`` of each per-layer metric of the cell.

A run sets up (weights made on the device from the seed, the driver's
warm-up), then measures a closed loop of whole units (batches or training
steps) for at least ``--seconds``: the window ends when the first unit that
finishes past that length finishes, so every unit in it is whole and the
rate is all the window's work over all its time.  ``--trace 1`` then
profiles a short stretch of whole units with the benchmark's spans around
each call into a layer, and prints the per-layer metrics.  Last, the program
is freed and the driver's reference check runs.  The numbers that
``limits/<cell>.json`` names are compared, each with its limit; they go to
the end of standard error and, under ``checks``, to the end of the result
line.

Exit codes: 0 with a result line; 3 with none where CUDA or the cell's cards
are missing; 4 with none where a JAX module was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SPAN = "pb."
# the JAX stack and the JAX package: none of them may be loaded in a run
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "image_recognition_adversarial_example_attack_tpu"})

_loaded: dict[Path, object] = {}


def load(relative: str, base: Path = HERE):
    """The module of ``<base>/<relative>.py``, loaded once by its path (names
    may hold dots, so they are no module names)."""
    path = (base / f"{relative}.py").resolve()
    if path not in _loaded:
        if not path.is_file():
            raise FileNotFoundError(f"no piece {relative}.py under {base}")
        spec = importlib.util.spec_from_file_location(
            "_portbench." + relative.replace("/", "_").replace(".", "_"), path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = module
        spec.loader.exec_module(module)
        _loaded[path] = module
    return _loaded[path]


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot, compared
    whole) is in ``FORBIDDEN``."""
    return sorted(n for n in list(sys.modules) if n.split(".", 1)[0] in FORBIDDEN)


class Cell:
    """Everything one cell names, read from the files."""

    def __init__(self, manifest: dict, name: str, root: Path = ROOT, base: Path = HERE):
        cells = {w["name"]: w for w in manifest["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload '{name}'; known: {sorted(cells)}")
        self.name, self.entry = name, cells[name]
        self.base = base
        conf_entry = next(c for c in manifest["configs"] if c["name"] == self.entry["config"])
        self.config = json.loads((root / conf_entry["file"]).read_text())
        self.traffic = json.loads((base / "traffic" / f"{self.entry['traffic']}.json").read_text())
        limits = base / "limits" / f"{name}.json"
        self.limits = json.loads(limits.read_text()) if limits.is_file() else {}
        self.end_to_end = [m for m in manifest["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in manifest["per_layer"]
                          if name in m.get("workloads", [name])]
        self.peaks = json.loads((base / "peaks.json").read_text())

    def piece(self, relative: str):
        return load(relative, self.base)

    def kernel_pieces(self):
        return {p.stem: self.piece(f"kernels/{p.stem}")
                for p in sorted((self.base / "kernels").glob("*.py"))}


def synchronize(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def window(job, seconds: float, first: int, device) -> tuple[int, float]:
    """Whole units from index ``first`` on, until one finishes at or past
    ``seconds``: (units, elapsed seconds)."""
    synchronize(device)
    t0 = time.perf_counter()
    n = 0
    while True:
        job.unit(first + n)
        synchronize(device)
        n += 1
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds:
            return n, elapsed


def traced(job, units: int, first: int, device) -> dict:
    """Profile ``units`` whole units; the trace's summary."""
    from torch.profiler import ProfilerActivity, profile, record_function

    trace = load("trace")
    synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(SPAN + "stretch"):
            t0 = time.perf_counter()
            for i in range(units):
                with record_function(SPAN + "unit"):
                    job.unit(first + i)
            synchronize(device)
            wall = time.perf_counter() - t0
    kernels, spans = trace.profiled_events(prof, SPAN)
    stretch = [s for s in spans if s[0] == "stretch"]
    lo, hi = (stretch[0][1], stretch[0][2]) if stretch else (0.0, wall * 1e6)
    if kernels:  # the last kernel may end after the host span closed
        hi = max(hi, max(k[2] for k in kernels))
    summary = trace.reduce_events(kernels, spans, lo, hi)
    summary["units"] = units
    return summary


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: float = T_START) -> dict:
    """Set up, measure, check; the result line's dict."""
    import torch

    driver = cell.piece(f"drivers/{cell.traffic['driver']}")
    flops = cell.piece(f"flops/{cell.config['flops']}")
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    job = driver.Job(cell, seed, torch.device(device))
    job.warm_up()
    synchronize(device)
    setup_s = time.perf_counter() - t_start

    units, elapsed = window(job, seconds, 0, device)
    examples = units * job.examples_per_unit
    out = {"correct": False, "attempted": examples, "failed": 0, "metrics": {},
           "device": {"platform": "gpu" if device == "cuda" else device,
                      "kind": (torch.cuda.get_device_name(0) if device == "cuda" else device),
                      "count": int(cell.entry["chips"]),
                      "memory_peak_bytes": 0}}
    flops_per_unit = 2.0 * flops.forward_macs(cell.config) * job.forward_equivalents_per_unit
    if not trace:
        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                out["metrics"]["setup_s"] = {"value": setup_s, "unit": "s"}
            elif m["name"] == cell.traffic["rate_metric"]:
                out["metrics"][m["name"]] = {"value": examples / elapsed, "unit": m["unit"]}
    else:
        summary = traced(job, int(cell.traffic["trace_units"]), units, device)
        summary.update(kind=job.kind, peaks=cell.peaks,
                       untraced={"seconds": elapsed, "units": units, "examples": examples,
                                 "model_flops": units * flops_per_unit},
                       steps=summary["units"] * job.steps_per_unit,
                       kernels=_kernel_work(cell, job, summary))
        for m in cell.per_layer:
            value = cell.piece(f"metrics/{m['name']}").read(summary)
            if value is not None:
                out["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        out["device"]["busy_s"] = summary["busy_s"]
        out["device"]["window_s"] = summary["window_s"]
        out["breakdown"] = {"device_ops": summary["device_ops"],
                            "idle_gaps": summary["idle_gaps"]}
        print(f"card: {power_limit()}", file=sys.stderr)
    if torch.device(device).type == "cuda":
        out["device"]["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())

    job.free()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    readings = job.check()
    checks = {k: {"value": readings.get(k), "limit": limit} for k, limit in cell.limits.items()}
    out["correct"] = bool(checks) and all(_passes(c) for c in checks.values())
    out["readings"] = {k: v for k, v in readings.items() if k not in checks}
    out["checks"] = checks  # the numbers compared, each beside its limit: the last key
    return out


def _kernel_work(cell: Cell, job, summary) -> dict:
    """Per kernel of ``kernels/``: its calls and device seconds in the trace,
    and the least seconds its calls' bytes need at the card's memory rate."""
    out = {}
    for name, k in cell.kernel_pieces().items():
        per_call = k.bytes_per_call(job.work)
        hits = [v for n, v in summary["per_kernel"].items()
                if any(t in n for t in k.TRACE_NAMES)]
        calls = sum(v[0] for v in hits)
        if per_call is None or not calls:
            continue
        out[name] = {"calls": calls, "device_s": sum(v[1] for v in hits),
                     "least_s": calls * per_call / cell.peaks["hbm_bytes_per_s"]}
    return out


def _passes(check: dict) -> bool:
    v, limit = check["value"], check["limit"]
    return v is not None and limit is not None and v == v and v <= limit


def report(out: dict) -> None:
    for name, v in out["readings"].items():
        print(f"reading {name}: {v!r} (not compared)", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"correct: {out['correct']}", file=sys.stderr)
    print(json.dumps(out))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # caches at fixed paths inside the checkout; no library may pull JAX in
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton_cache")
    os.environ["USE_FLAX"] = "0"
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = Cell(manifest, args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell.entry["chips"]):
        print(f"needs {cell.entry['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    sys.path.insert(0, str(ROOT))
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"JAX modules loaded in the run: {found}", file=sys.stderr)
        return 4
    report(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
