"""Whole runs of the tiny cells on the CPU (the look for a card skipped), once
sound and once with the timed path broken underneath (``faults.py``) in each
way the cell can break; ``correct`` has to come out true, then false."""

from __future__ import annotations

import json

import pytest
import torch

from conftest import BENCH, load_harness, run_tiny

faults = load_harness(BENCH).load("faults")

ATTACK_FAULTS = ["step_unchanged", "half_batch_unattacked", "x_adv_altered", "logits_altered"]
CASES = ([("tiny.pgd3", f) for f in ATTACK_FAULTS]
         + [("tiny.def2", f) for f in ATTACK_FAULTS + ["defense_skipped", "detector_score_altered"]]
         + [("tiny.pgdat2", f) for f in ["train_state_unchanged", "train_half_batch",
                                         "train_loss_altered"]])


@pytest.mark.parametrize("cell", ["tiny.pgd3", "tiny.def2", "tiny.pgdat2"])
def test_sound_run_is_correct(tiny_bench, cell):
    h, root, manifest = tiny_bench
    out = run_tiny(h, root, manifest, cell, seconds=0.5)
    assert out["correct"], json.dumps(out["checks"])


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_caught(tiny_bench, monkeypatch, cell, fault):
    h, root, manifest = tiny_bench
    faults.plant(fault, monkeypatch.setattr)
    out = run_tiny(h, root, manifest, cell, seconds=0.5)
    assert not out["correct"], json.dumps(out["checks"])


def test_a_missing_sampled_batch_is_not_correct(tiny_bench):
    h, root, manifest = tiny_bench
    c = h.Cell(manifest, "tiny.pgd3", root=root, base=root / "benchmark_port")
    job = c.piece("drivers/eval_attack").Job(c, 77, torch.device("cpu"))
    job.free()
    readings = job.check()
    assert readings["batches_missing"] == 1.0
    assert not h._passes({"value": readings["batches_missing"], "limit": c.limits["batches_missing"]})
