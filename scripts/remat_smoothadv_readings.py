"""Readings of chip_smoke.py phase 25(e)'s and 25(f)'s checks, on sound runs
and on planted faults, on one CUDA card.

25(e) runs one PGD-AT step of WRN-28-10 float32 with ``train_bn`` and remat
over two slots of the card and holds its summed gradient (AdamW's first
moment, ``|a - b| / |b|``) to the two-slot step without remat and to the
one-slot remat step whose attack returns the two-slot x_adv; it also reads
the plain one-slot step.  Each run also reads the trap planted (the
recompute in the backward normalizing by the shard's own statistics), so
that the limits can sit between the two.

25(f) runs one SmoothAdv PGD-AT step of ResNet-50 bf16 over two slots and
holds its draws bit for bit (the PGD start, Cohen's noise, each EOT call's
noise against the one-slot wrapper's draw for the whole batch's input) and
its x_adv to each shard's rows run alone on one slot with the same draws;
the ``own_mix`` fault seeds each shard's EOT calls from its own rows' mix.

Run from the root of the repository on a machine with a CUDA card:

    python scripts/remat_smoothadv_readings.py --runs 3 --out remat_smoothadv.json
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402  (the phase's steps, data and checks)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=3, help="sound runs of each")
    ap.add_argument("--out", type=str, default=None, help="also write the readings here")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("remat_smoothadv_readings: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    res = {"card": smi, "remat": [], "smoothadv": [], "smoothadv_own_mix": None}
    for i in range(args.runs):
        r = cs._remat_runs()
        res["remat"].append(r)
        print(f"25(e) run {i}: same {r['same']:.3e}, slots {r['slots']:.3e}, one slot "
              f"{r['one_slot']:.3e} (x_adv {r['adv_share']:.2e} of the pixels apart); trap "
              f"{r['trap']}; {r['remat_ms']:.1f} ms {r['remat_peak_gib']:.2f} GiB with remat, "
              f"{r['plain_ms']:.1f} ms {r['plain_peak_gib']:.2f} GiB without", flush=True)
    for i in range(args.runs):
        r = cs._smoothadv_runs()
        res["smoothadv"].append(r)
        print(f"25(f) run {i}: {r}", flush=True)
    res["smoothadv_own_mix"] = cs._smoothadv_runs(own_mix=True)
    print(f"25(f) own_mix fault: {res['smoothadv_own_mix']}", flush=True)
    summary = {"card": smi,
               "remat_same_max": max(r["same"] for r in res["remat"]),
               "remat_slots_max": max(r["slots"] for r in res["remat"]),
               "remat_one_slot_max": max(r["one_slot"] for r in res["remat"]),
               "trap_same_min": min(r["trap"]["same"] for r in res["remat"]),
               "trap_slots_min": min(r["trap"]["slots"] for r in res["remat"]),
               "smoothadv_sound_checks": all(
                   r["start_equal"] and r["cohen_equal"] and r["first_call_equal"]
                   and r["calls_equal"] and r["alone_equal"] for r in res["smoothadv"])}
    print(json.dumps(summary))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({**res, "summary": summary}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
