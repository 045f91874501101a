"""Readings of chip_smoke.py phase 23(b)'s two CLI checks, on sound runs and
on planted faults, on one CUDA card.

Phase 23(b) holds the ``adversarial_train`` CLI's ``--streaming`` run to its
in-RAM run (the loss of each epoch, relative) and a 1-epoch run resumed to
2 epochs to the straight 2-epoch run (the distance between their
parameters, as a share of the straight run's move from the initial
weights).  This script reads both numbers, on the same data and flags as
phase 23(b), for the sound runs and for three faults planted at run time,
so that each limit can sit between the two:

- ``resume_generator``: the resumed epoch replays epoch 1's per-step
  generators (``"train:0"``) instead of its own;
- ``resume_moments``: the checkpoint loses AdamW's moments (mu and nu set
  to zero) before the resume;
- ``stream_shuffle``: the stream shuffles with ``shuffle_seed(seed + 1,
  epoch)`` instead of ``shuffle_seed(seed, epoch)``.

Every run is in this process, one after another.  Run from the root of the
repository on a machine with a CUDA card:

    python scripts/train_fault_readings.py --out train_faults.json
"""

from __future__ import annotations

import argparse
import json
import math
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402  (the phase's data, flags and parsers)


def _apart(a: dict, b: dict, init: dict) -> float:
    """|a - b| / |a - init| over every parameter (Euclidean norms)."""
    moved = math.sqrt(sum(float(((a[k] - init[k]) ** 2).sum()) for k in a))
    return math.sqrt(sum(float(((a[k] - b[k]) ** 2).sum()) for k in a)) / moved


def _loss_rel(ref: list, other: list) -> float:
    """The largest relative difference of the epochs' printed losses."""
    return max(abs(a[1] - b[1]) / abs(a[1]) for a, b in zip(ref, other))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=str, default=None, help="also write the readings here")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("train_fault_readings: CUDA is not available", file=sys.stderr)
        return 1
    from image_recognition_adversarial_example_attack_tpu_torch.cli import adversarial_train
    from image_recognition_adversarial_example_attack_tpu_torch.core import rng
    from image_recognition_adversarial_example_attack_tpu_torch.models.zoo import load_model
    from image_recognition_adversarial_example_attack_tpu_torch.utils import pipeline

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    init = load_model("resnet50", dtype=torch.float32, device="cpu").model.state_dict()
    res = {"card": smi}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        data = tmp / "classes"
        for k in range(cs.TRAIN_CLASSES):
            cs._write_pngs(data / f"class_{k}", cs.TRAIN_PNGS // cs.TRAIN_CLASSES, seed=30 + k)
        common = ["--data_dir", str(data), "--eval_attack_steps", "10", "--ema_decay", "0.999"]

        def run(name: str, *flags: str) -> list:
            out, seconds, _ = cs._in_process_cli(adversarial_train.main, [*common, *flags])
            epochs = cs._epoch_lines(out)
            res[name] = {"seconds": seconds, "lines": [e[3] for e in epochs]}
            print(f"{name}: {seconds:.1f} s; " + " | ".join(res[name]["lines"]), flush=True)
            return epochs

        def ckpt(name: str) -> dict:
            return torch.load(tmp / f"{name}.msgpack.ckpt", weights_only=True)

        ram = run("in_ram", "--epochs", "2", "--out", str(tmp / "ram.msgpack"))
        run("one_epoch", "--epochs", "1", "--out", str(tmp / "one.msgpack"))
        for name in ("resumed", "resume_generator", "resume_moments"):
            shutil.copy(tmp / "one.msgpack.ckpt", tmp / f"{name}.msgpack.ckpt")
        moments = ckpt("resume_moments")
        for key in ("mu", "nu"):
            moments["opt_state"][key] = {k: torch.zeros_like(v)
                                         for k, v in moments["opt_state"][key].items()}
        torch.save(moments, tmp / "resume_moments.msgpack.ckpt")

        readings = {}
        resumed = run("resumed", "--epochs", "2", "--resume", "--out",
                      str(tmp / "resumed.msgpack"))
        readings["sound_resume"] = _apart(ckpt("ram")["params"], ckpt("resumed")["params"], init)
        readings["sound_resume_loss"] = _loss_rel(ram[1:], resumed)
        real_chunk = adversarial_train.chunk_generator
        adversarial_train.chunk_generator = (
            lambda seed, label, step: rng.chunk_generator(seed, "train:0", step))
        try:
            wrong = run("resume_generator", "--epochs", "2", "--resume", "--out",
                        str(tmp / "resume_generator.msgpack"))
        finally:
            adversarial_train.chunk_generator = real_chunk
        readings["resume_generator"] = _apart(ckpt("ram")["params"],
                                              ckpt("resume_generator")["params"], init)
        readings["resume_generator_loss"] = _loss_rel(ram[1:], wrong)
        reset = run("resume_moments", "--epochs", "2", "--resume", "--out",
                    str(tmp / "resume_moments.msgpack"))
        readings["resume_moments"] = _apart(ckpt("ram")["params"],
                                            ckpt("resume_moments")["params"], init)
        readings["resume_moments_loss"] = _loss_rel(ram[1:], reset)

        stream = run("streaming", "--epochs", "2", "--streaming", "--out",
                     str(tmp / "stream.msgpack"))
        readings["sound_stream_loss"] = _loss_rel(ram, stream)
        real_shuffle = pipeline.shuffle_seed
        pipeline.shuffle_seed = lambda seed, epoch: real_shuffle(seed + 1, epoch)
        try:
            other = run("stream_shuffle", "--epochs", "2", "--streaming", "--out",
                        str(tmp / "stream_shuffle.msgpack"))
        finally:
            pipeline.shuffle_seed = real_shuffle
        readings["stream_shuffle_loss"] = _loss_rel(ram, other)
        readings["stream_shuffle"] = _apart(ckpt("ram")["params"],
                                            ckpt("stream_shuffle")["params"], init)
    res["readings"] = readings
    print(smi)
    print(json.dumps(readings))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
