"""Readings of chip_smoke.py phase 25(b)'s check, on sound runs and on planted
faults, on one CUDA card.

Phase 25(b) runs one PGD-AT step of ResNet-50 bf16 at batch 32 as two ranks
on the one card over gloo (16 rows a rank, the gradients summed over the
ranks) and holds the parameters to the one-process step on the same 32
rows: ``|two - one| / |one - init|`` (Euclidean norms over every
parameter), the summed gradient (AdamW's first moment) likewise, and each
rank's PGD start bit for bit against its rows of the one-process start.
This script reads those for sound two-rank runs and for three faults
planted at run time in both ranks, so that the limits can sit between
them:

- ``no_reduce``: the gradients are not summed over the ranks (each rank
  updates with its own half);
- ``own_start``: each rank draws its PGD start from the noise kernel at
  offset 0 (the first rows of the whole draw) instead of its own rows';
- ``same_rows``: both ranks train on the first 16 rows.

Run from the root of the repository on a machine with a CUDA card:

    python scripts/scaleout_fault_readings.py --out scaleout_faults.json
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402  (the phase's step, data and reference)

PKG = cs.PKG
PLANT = {
    "sound": "",
    "no_reduce": (f"from {PKG}.train import adversarial\n"
                  "adversarial._reduce_tree = lambda tree: tree\n"),
    "own_start": (f"from {PKG}.kernels import elementwise as ew\n"
                  "_at = ew.uniform_noise_at\n"
                  "ew.uniform_noise_at = lambda shape, eps, seed, device, offset=0: "
                  "_at(shape, eps, seed, device, 0)\n"),
    "same_rows": ("import numpy as np\n"
                  f"from {PKG}.parallel import distributed\n"
                  "_place = distributed.process_local_batch\n"
                  "distributed.process_local_batch = lambda x, mesh: "
                  "_place(np.concatenate([x[:len(x) // 2]] * 2), mesh)\n"),
}


def _two_ranks(fault: str, out_dir: Path) -> None:
    code = PLANT[fault] + f"import chip_smoke as cs\ncs.scaleout_rank_child({str(out_dir)!r})\n"
    port = cs._free_port()
    procs = [cs._start_child(code, cs.SO_RANKS, r, port) for r in range(cs.SO_RANKS)]
    for r, p in enumerate(procs):
        cs._finish_child(p, f"{fault} rank {r}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sound_runs", type=int, default=2)
    ap.add_argument("--out", type=str, default=None, help="also write the readings here")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("scaleout_fault_readings: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    res = {"card": smi, "readings": {}}
    cases = ["sound"] * args.sound_runs + [f for f in PLANT if f != "sound"]
    for i, fault in enumerate(cases):
        with tempfile.TemporaryDirectory() as tmp:
            out = Path(tmp)
            _two_ranks(fault, out)
            ranks = [json.loads((out / f"rank{r}.json").read_text())
                     for r in range(cs.SO_RANKS)]
            ref = cs._scaleout_one_process(ranks, out)
        key = f"{fault} {i}" if fault == "sound" else fault
        res["readings"][key] = {"apart": ref["apart"], "mu_rel": ref["mu_rel"],
                                "start_equal": ref["start_equal"],
                                "loss_two": ranks[0]["loss"], "loss_one": ref["loss"]}
        print(f"{key}: parameters {ref['apart']:.4e} of the one-process step's move apart, "
              f"first moment {ref['mu_rel']:.4e} of its norm, PGD starts bit-equal to the "
              f"one-process rows {ref['start_equal']}; loss {ranks[0]['loss']:.6f} / "
              f"{ref['loss']:.6f}", flush=True)
    print(json.dumps(res))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
