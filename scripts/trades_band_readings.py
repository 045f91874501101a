"""Readings of the TRADES objective's first moment on one CUDA card, for the
band of ``tests/test_torch_cuda.py::test_every_objective_on_the_card_matches_the_cpu[trades]``.

That test runs two TRADES steps of ``wrn_tiny`` in float32 on the card and
replays each on the CPU in float32 and float64 with the card's draws and
PGD iterates; it holds the card's first moment (AdamW's ``mu``) to
float64's within a band.  This script reads the card's distance from
float64 (and the CPU float32's, and the card's from the CPU float32),
relative to the first moment's scale, over repeated sound runs
(cuDNN's algorithm choices move the card's float32 from run to run), and
on runs with a fault planted in the card's configuration alone
(``trades_beta`` 6 -> 6.6 and 6.06, ``label_smoothing`` 0 -> 0.1 and
0.01), so that the band can sit between the two.  Each run is in this process, one after
another.  Run from the root of the repository on a machine with a card:

    python scripts/trades_band_readings.py --runs 8 --out trades_band.json

``--under-load`` reads the sound runs under the load the test once failed
under in chip_smoke.py's phase 23: phase 23(b)'s three ``adversarial_train``
CLI subprocesses (ResNet-50's defaults over 128 PNGs: in RAM, streaming,
one epoch) beside it, each restarted as it ends, so that every run has all
three beside it.  Every step's readings carry the card's fingerprint: its
free memory after the step and the conv and GEMM kernels ``torch.profiler``
saw in a replay of the step (cuDNN's and cuBLAS's choice of algorithm; the
checked step itself runs outside the profiler), with the replay's distance
from the step; the summary counts the distinct kernel sets.
``--no-profile`` runs no profiler in the process at all (free memory only),
as the test ran when it failed.

    python scripts/trades_band_readings.py --under-load --runs 24 --out trades_load.json
    python scripts/trades_band_readings.py --under-load --no-profile --runs 12
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

# seconds the load's three processes take to reach the card before the first run
LOAD_WARMUP_S = 20.0
FAULTS = {"trades_beta 6.6": {"trades_beta": 6.6}, "trades_beta 6.06": {"trades_beta": 6.06},
          "label_smoothing 0.1": {"label_smoothing": 0.1},
          "label_smoothing 0.01": {"label_smoothing": 0.01}}


def _fingerprints(r: dict) -> str:
    return "; ".join(
        f"step {i}: ReLU ties {s['relu_ties']}, {s['free_gib']:.1f} GiB free" + (
            "" if s["kernels"] is None else
            f", {len(s['kernels'])} conv/GEMM kernels, replay {s['replay_mu']:.3e} off")
        for i, s in enumerate(r["steps"]))


def _reading(cuda, card_cfg=None, profile=True) -> dict:
    import pytest

    import test_torch_cuda as t

    with pytest.MonkeyPatch.context() as mp:
        steps = t.objective_steps(cuda, "trades", mp, card_cfg=card_cfg,
                                  check=card_cfg is None, profile=profile)
    r = [s[3] for s in steps]
    return {"card_rel": max(x["mu_card"] / x["mu_scale"] for x in r),
            "cpu_rel": max(x["mu_cpu"] / x["mu_scale"] for x in r),
            "card_cpu_rel": max(x["mu_card_cpu"] / x["mu_scale"] for x in r),
            "steps": r}


class _Load:
    """Phase 23(b)'s three CLI subprocesses, kept running (``keep``
    restarts any that ended) until ``stop``."""

    def __init__(self, tmp: Path):
        import chip_smoke as cs

        data = tmp / "classes"
        for k in range(cs.TRAIN_CLASSES):
            cs._write_pngs(data / f"class_{k}", cs.TRAIN_PNGS // cs.TRAIN_CLASSES, seed=30 + k)
        common = [sys.executable, "-m", f"{cs.PKG}.cli.adversarial_train", "--data_dir",
                  str(data), "--eval_attack_steps", "10", "--ema_decay", "0.999"]
        self.cmds = {"in_ram": [*common, "--epochs", "2", "--out", str(tmp / "ram.msgpack")],
                     "streaming": [*common, "--epochs", "2", "--streaming", "--out",
                                   str(tmp / "stream.msgpack")],
                     "one_epoch": [*common, "--epochs", "1", "--out", str(tmp / "one.msgpack")]}
        self.procs: dict = {}
        self.started = 0

    def keep(self) -> int:
        """Restart every process that ended (a failed one raises); the
        number running."""
        for name, cmd in self.cmds.items():
            p = self.procs.get(name)
            if p is not None and p.poll() is not None:
                err = p.stderr.read()
                if p.returncode != 0:
                    raise RuntimeError(f"load {name}: exit {p.returncode}\n{err[-3000:]}")
                p = None
            if p is None:
                self.procs[name] = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.DEVNULL,
                                                    stderr=subprocess.PIPE, text=True)
                self.started += 1
        return sum(p.poll() is None for p in self.procs.values())

    def stop(self) -> None:
        for p in self.procs.values():
            p.kill()
            p.wait()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=8, help="sound runs")
    ap.add_argument("--out", type=str, default=None, help="also write the readings here")
    ap.add_argument("--under-load", action="store_true",
                    help="sound runs beside phase 23(b)'s three CLI subprocesses; no faults")
    ap.add_argument("--no-profile", action="store_true",
                    help="no profiler in the process: each step's free memory only")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("trades_band_readings: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    cuda = torch.device("cuda")
    res = {"card": smi, "under_load": bool(args.under_load), "profiled": not args.no_profile,
           "sound": [], "faults": {}}
    if args.under_load:
        import tempfile

        with tempfile.TemporaryDirectory() as tmp:
            load = _Load(Path(tmp))
            try:
                load.keep()
                time.sleep(LOAD_WARMUP_S)  # the three reach the card
                for i in range(args.runs):
                    before = load.keep()
                    r = _reading(cuda, profile=not args.no_profile)
                    r["load"] = [before, load.keep()]
                    res["sound"].append(r)
                    print(f"loaded run {i}: card {r['card_rel']:.3e}, CPU float32 "
                          f"{r['cpu_rel']:.3e} from float64, the card {r['card_cpu_rel']:.3e} "
                          f"from the CPU float32, of the first moment's scale; load "
                          f"{r['load']}; " + _fingerprints(r), flush=True)
            finally:
                load.stop()
            res["load_processes_started"] = load.started
        steps = [s for r in res["sound"] for s in r["steps"]]
        kernel_sets = {json.dumps(s["kernels"]) for s in steps if s["kernels"] is not None}
        summary = {"card": smi, "runs": len(res["sound"]), "profiled": not args.no_profile,
                   "sound_max": max(r["card_rel"] for r in res["sound"]),
                   "sound_min": min(r["card_rel"] for r in res["sound"]),
                   "cpu_max": max(r["cpu_rel"] for r in res["sound"]),
                   "steps_with_a_float64_relu_tie": sum(s["relu_ties"]["float64"][0] > 0
                                                        for s in steps),
                   "card_cpu_max": max(r["card_cpu_rel"] for r in res["sound"]),
                   "over_band": sum(r["card_rel"] > max(1e-4, 10.0 * r["cpu_rel"])
                                    for r in res["sound"]),
                   "distinct_kernel_sets": len(kernel_sets),
                   "replay_mu_max": max((s["replay_mu"] for s in steps
                                         if s["replay_mu"] is not None), default=None),
                   "free_gib_min": min(s["free_gib"] for s in steps),
                   "free_gib_max": max(s["free_gib"] for s in steps),
                   "load_processes_started": load.started}
        print(json.dumps(summary))
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps({**res, "summary": summary}, indent=1))
        return 0
    for i in range(args.runs):
        r = _reading(cuda, profile=not args.no_profile)
        res["sound"].append(r)
        print(f"sound run {i}: card {r['card_rel']:.3e}, CPU float32 {r['cpu_rel']:.3e} of "
              "the first moment's scale", flush=True)
    for name, cfg in FAULTS.items():
        r = _reading(cuda, cfg, profile=not args.no_profile)
        res["faults"][name] = r
        print(f"fault {name}: card {r['card_rel']:.3e}, CPU float32 {r['cpu_rel']:.3e}",
              flush=True)
    sound = max(r["card_rel"] for r in res["sound"])
    fault = min(r["card_rel"] for r in res["faults"].values())
    print(json.dumps({"card": smi, "sound_max": sound, "fault_min": fault}))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
