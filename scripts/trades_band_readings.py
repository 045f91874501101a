"""Readings of the TRADES objective's first moment on one CUDA card, for the
band of ``tests/test_torch_cuda.py::test_every_objective_on_the_card_matches_the_cpu[trades]``.

That test runs two TRADES steps of ``wrn_tiny`` in float32 on the card and
replays each on the CPU in float32 and float64 with the card's draws and
PGD iterates; it holds the card's first moment (AdamW's ``mu``) to
float64's within a band.  This script reads the card's distance from
float64, relative to the first moment's scale, over repeated sound runs
(cuDNN's algorithm choices move the card's float32 from run to run), and
on runs with a fault planted in the card's configuration alone
(``trades_beta`` 6 -> 6.6 and 6.06, ``label_smoothing`` 0 -> 0.1 and
0.01), so that the band can sit between the two.  Each run is in this process, one after
another.  Run from the root of the repository on a machine with a card:

    python scripts/trades_band_readings.py --runs 8 --out trades_band.json
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

FAULTS = {"trades_beta 6.6": {"trades_beta": 6.6}, "trades_beta 6.06": {"trades_beta": 6.06},
          "label_smoothing 0.1": {"label_smoothing": 0.1},
          "label_smoothing 0.01": {"label_smoothing": 0.01}}


def _reading(cuda, card_cfg=None) -> dict:
    import pytest

    import test_torch_cuda as t

    with pytest.MonkeyPatch.context() as mp:
        steps = t.objective_steps(cuda, "trades", mp, card_cfg=card_cfg,
                                  check=card_cfg is None)
    r = [s[3] for s in steps]
    return {"card_rel": max(x["mu_card"] / x["mu_scale"] for x in r),
            "cpu_rel": max(x["mu_cpu"] / x["mu_scale"] for x in r),
            "steps": r}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=8, help="sound runs")
    ap.add_argument("--out", type=str, default=None, help="also write the readings here")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("trades_band_readings: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    cuda = torch.device("cuda")
    res = {"card": smi, "sound": [], "faults": {}}
    for i in range(args.runs):
        r = _reading(cuda)
        res["sound"].append(r)
        print(f"sound run {i}: card {r['card_rel']:.3e}, CPU float32 {r['cpu_rel']:.3e} of "
              "the first moment's scale", flush=True)
    for name, cfg in FAULTS.items():
        r = _reading(cuda, cfg)
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
