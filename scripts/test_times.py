"""Seconds of the tier-1 test command, per file, per phase and per worker.

Runs the tier-1 pytest command (``tests/``, ``-m 'not slow'``, ``-n 6
--dist loadfile``) with no outer time limit, so that a whole suite is
counted however long it takes, and with this file loaded as a pytest
plugin that appends each test's setup, call and teardown seconds to a JSON
lines log.  Then it prints:

- per test file: setup, call and teardown seconds, and their sum;
- every phase (setup or call) over ``PHASE_LIMIT`` seconds;
- each worker's busy seconds;
- the wall time, the counts of outcomes and pytest's exit code.

Run from the root of the tree to be timed:

    python scripts/test_times.py --log /tmp/times.jsonl
    python scripts/test_times.py --report /tmp/times.jsonl      # tables again
    python scripts/test_times.py --compare before.jsonl after.jsonl

``--compare`` prints one table of both logs' per-file seconds and the sum
over the port's files (``tests/test_torch_*.py``).
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time
from pathlib import Path

LOG_ENV = "TEST_TIMES_LOG"
PORT_PREFIX = "tests/test_torch_"
WORKERS = 6  # the tier-1 command's -n
PHASE_LIMIT = 40.0  # seconds a port test phase may take (ROADMAP, Budgets)


# --- the plugin half: loaded into pytest (and each xdist worker) by ``-p test_times`` ---

def pytest_runtest_logreport(report):
    path = os.environ.get(LOG_ENV)
    if not path:
        return
    # Under xdist the controller sees each report again; only a worker (or a
    # run without workers) writes it.
    worker = os.environ.get("PYTEST_XDIST_WORKER")
    if worker is None and os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
        return
    line = {"nodeid": report.nodeid, "when": report.when, "seconds": report.duration,
            "outcome": report.outcome, "worker": worker or "main", "stop": time.time()}
    with open(path, "a") as f:
        f.write(json.dumps(line) + "\n")


def pytest_configure(config):
    # The controller of an xdist run has no PYTEST_XDIST_WORKER; mark it so
    # that its relayed reports are not logged twice.
    if getattr(config.option, "numprocesses", None) and not hasattr(config, "workerinput"):
        os.environ["PYTEST_XDIST_WORKER_COUNT"] = str(config.option.numprocesses)


# --- the script half ---

def _records(log: Path) -> list[dict]:
    out = []
    for line in log.read_text().splitlines():
        line = line.strip()
        if line.startswith("{"):
            out.append(json.loads(line))
    return out


def _per_file(records: list[dict]) -> dict[str, dict[str, float]]:
    files: dict[str, dict[str, float]] = collections.defaultdict(
        lambda: {"setup": 0.0, "call": 0.0, "teardown": 0.0})
    for r in records:
        if "nodeid" in r:
            files[r["nodeid"].split("::")[0]][r["when"]] += r["seconds"]
    return files


def _total(d: dict[str, float]) -> float:
    return d["setup"] + d["call"] + d["teardown"]


def _port_and_rest(files: dict[str, dict[str, float]]) -> tuple[float, float]:
    port = sum(_total(d) for n, d in files.items() if n.startswith(PORT_PREFIX))
    return port, sum(_total(d) for d in files.values()) - port


def report(log: Path) -> None:
    records = _records(log)
    tests = [r for r in records if "nodeid" in r]
    files = _per_file(tests)
    print(f"{'file':58s} {'setup':>9s} {'call':>9s} {'teardown':>9s} {'total':>9s}")
    for name, d in sorted(files.items(), key=lambda kv: -_total(kv[1])):
        print(f"{name:58s} {d['setup']:9.1f} {d['call']:9.1f} {d['teardown']:9.1f} "
              f"{_total(d):9.1f}")
    port, rest = _port_and_rest(files)
    print(f"\nport files (tests/test_torch_*.py): {port:.1f} test-seconds; other files: {rest:.1f}")

    slow = [r for r in tests if r["when"] in ("setup", "call") and r["seconds"] > PHASE_LIMIT]
    print(f"\nphases over {PHASE_LIMIT:g} s: {len(slow)} "
          f"({sum(1 for r in slow if r['nodeid'].startswith(PORT_PREFIX))} in port files)")
    for r in sorted(slow, key=lambda r: -r["seconds"]):
        print(f"  {r['seconds']:8.1f}  {r['when']:8s} {r['nodeid']}")

    busy: dict[str, float] = collections.defaultdict(float)
    for r in tests:
        busy[r["worker"]] += r["seconds"]
    print("\nworker busy seconds: " + ", ".join(f"{w} {s:.1f}" for w, s in sorted(busy.items())))

    outcomes = collections.Counter(
        r["outcome"] for r in tests if r["when"] == "call" or r["outcome"] != "passed")
    print("outcomes (call phases, and failed or skipped setups): " + ", ".join(
        f"{k} {v}" for k, v in sorted(outcomes.items())))
    for r in records:
        if "wall_seconds" in r:
            print(f"wall: {r['wall_seconds']:.1f} s, pytest exit code {r['rc']}")


def compare(before: Path, after: Path) -> None:
    a, b = _per_file(_records(before)), _per_file(_records(after))
    print("| file | before (s) | after (s) |\n|---|---:|---:|")
    names = sorted((n for n in set(a) | set(b) if n.startswith(PORT_PREFIX)),
                   key=lambda n: -_total(a[n]))
    for name in names:
        print(f"| `{name[len('tests/'):]}` | {_total(a[name]):.1f} | {_total(b[name]):.1f} |")
    (pa, oa), (pb, ob) = _port_and_rest(a), _port_and_rest(b)
    print(f"| **port files** | **{pa:.1f}** | **{pb:.1f}** ({100 * pb / pa:.1f}%) |")
    print(f"| other files | {oa:.1f} | {ob:.1f} |")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log", type=Path, help="run the suite and write the JSON lines log here")
    ap.add_argument("--report", type=Path, help="print the tables of an existing log")
    ap.add_argument("--compare", type=Path, nargs=2, metavar=("BEFORE", "AFTER"))
    args = ap.parse_args(argv)
    if args.compare:
        compare(*args.compare)
        return 0
    if args.report:
        report(args.report)
        return 0
    if not args.log:
        ap.error("one of --log, --report or --compare is needed")
    args.log.unlink(missing_ok=True)
    env = dict(os.environ, JAX_PLATFORMS="cpu", ALLOW_MULTIPLE_LIBTPU_LOAD="1",
               **{LOG_ENV: str(args.log.resolve())})
    env["PYTHONPATH"] = os.pathsep.join(
        [str(Path(__file__).resolve().parent)] + [p for p in [env.get("PYTHONPATH")] if p])
    cmd = [sys.executable, "-m", "pytest", "tests/", "-q",
           "-m", "not slow", "--continue-on-collection-errors", "-p", "no:cacheprovider",
           "-p", "xdist", "-n", str(WORKERS), "--dist", "loadfile", "-p", "no:randomly",
           "-p", "test_times"]
    t0 = time.perf_counter()
    rc = subprocess.run(cmd, env=env).returncode
    with open(args.log, "a") as f:
        f.write(json.dumps({"wall_seconds": time.perf_counter() - t0, "rc": rc}) + "\n")
    print()
    report(args.log)
    return rc


if __name__ == "__main__":
    sys.exit(main())
