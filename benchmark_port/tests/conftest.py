"""Fixtures of the benchmark's CPU tests: the harness loaded from a folder by
its path, and a temporary copy of the benchmark's folder with a tiny cell of
each driver added as files (resnet_tiny at 32x32), run on the CPU."""

from __future__ import annotations

import importlib.util
import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
REPO = BENCH.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY_CONFIG = {"zoo_name": "resnet_tiny", "reference": "resnet", "flops": "resnet",
               "stage_blocks": [1, 1, 1, 1], "width": 8, "expansion": 4, "num_classes": 10,
               "image_size": 32, "mean": [0.485, 0.456, 0.406], "std": [0.229, 0.224, 0.225],
               "dtype": "float32", "reduced": []}
ATTACK = {"eps": 8 / 255, "alpha": 2 / 255, "random_start": True, "warmup_batches": 1,
          "sample_batches": 1, "sample_from": 1, "check_block": 4, "trace_units": 1}
TRAFFIC = {
    "pgd3.b4": dict(ATTACK, driver="eval_attack", rate_metric="eval_ex_per_s", batch=4,
                    attack="pgd", steps=3),
    "def2.b4": dict(ATTACK, driver="defense_eval", rate_metric="eval_ex_per_s", batch=4,
                    attack="pgd", steps=2, detector="feature", quant_levels=16, jpeg=False,
                    counters=["clean_correct", "attack_success", "defense_preproc_success",
                              "detector_flags_clean", "detector_flags_adv",
                              "detector_attack_success"]),
    "pgdat2.b4": {"driver": "train_step", "rate_metric": "train_ex_per_s", "batch": 4,
                  "attack_steps": 2, "eps": 8 / 255, "alpha": 2 / 255, "learning_rate": 1e-3,
                  "weight_decay": 1e-4, "checked_steps": 3, "check_block": 2,
                  "trace_units": 1},
}
# float32 on the CPU: the program and the reference agree to rounding
ATTACK_LIMITS = {"start_mismatch": 0, "step_mismatch": 0, "stalled_rows": 0, "grad_sign_miss": 1e-3,
                 "logit_gap": 1e-3, "batches_missing": 0}
LIMITS = {"tiny.pgd3": ATTACK_LIMITS,
          "tiny.def2": dict(ATTACK_LIMITS, cell_mismatch=0, counter_mismatch=0, score_gap=1e-3),
          "tiny.pgdat2": {"loss_gap": 1e-4, "grad_norm_gap": 1e-4, "update_norm_gap": 1e-4}}
CELLS = {"tiny.pgd3": "pgd3.b4", "tiny.def2": "def2.b4", "tiny.pgdat2": "pgdat2.b4"}


def load_harness(folder: Path):
    spec = importlib.util.spec_from_file_location(f"_portbench_run_{abs(hash(folder))}",
                                                  folder / "run.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def tiny_bench(tmp_path):
    """(harness, root, manifest) of a copy of the folder with the tiny cells."""
    folder = tmp_path / "benchmark_port"
    shutil.copytree(BENCH, folder, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (folder / "configs" / "tiny-resnet.json").write_text(json.dumps(TINY_CONFIG))
    for name, traffic in TRAFFIC.items():
        (folder / "traffic" / f"{name}.json").write_text(json.dumps(traffic))
    for cell in CELLS:
        (folder / "limits" / f"{cell}.json").write_text(json.dumps(LIMITS[cell]))
    manifest = json.loads((REPO / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "tiny-resnet", "source": "https://arxiv.org/abs/1512.03385",
                                "file": "benchmark_port/configs/tiny-resnet.json",
                                "reduced": [], "why": "a CPU test's cell"})
    for cell, traffic in CELLS.items():
        manifest["workloads"].append({"name": cell, "config": "tiny-resnet", "traffic": traffic,
                                      "chips": 1, "why": "a CPU test's cell"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        m.pop("workloads", None)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    return load_harness(folder), tmp_path, manifest


def run_tiny(harness, root: Path, manifest: dict, cell: str, seed: int = 123456789012,
             trace: bool = False, seconds: float = 0.2) -> dict:
    import time

    c = harness.Cell(manifest, cell, root=root, base=root / "benchmark_port")
    return harness.run_cell(c, seed, seconds, trace, device="cpu", t_start=time.perf_counter())
