"""Seconds of chip_smoke.py's phase 18 (the white-box zoo) and phase 19 (the
black-box group) alone, for comparing two versions of the script on one
card.

Run from the root of the tree whose ``chip_smoke.py`` is to be timed, on a
machine with a CUDA card; the tree's own package is imported:

    cd <tree> && python <repo>/scripts/chip_phase_times.py --tag <name>

It builds the kernels, runs phase 3 (the batch and model the two phases
use), writes phase 8's PNGs, runs phases 18 and 19 in turn and prints one
line ``PHASE_TIMES {"tag": ..., "zoo_s": ..., "black_box_s": ..., "card":
...}``.  Compare two trees within one call, in turns (A, B, B, A).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tag", type=str, required=True, help="the tree's name in the output line")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke as cs
    import torch

    if not torch.cuda.is_available():
        print("chip_phase_times: CUDA is not available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    cs.phase_build()
    state = cs.phase_classify()
    out = {"tag": args.tag, "card": card}
    with tempfile.TemporaryDirectory() as d:
        pngs = cs._write_pngs(Path(d) / "png", cs.N_STREAM)
        for key, phase in (("zoo_s", cs.phase_white_box_zoo), ("black_box_s", cs.phase_black_box)):
            t0 = time.perf_counter()
            phase(state, pngs)
            out[key] = time.perf_counter() - t0
    print("PHASE_TIMES " + json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
