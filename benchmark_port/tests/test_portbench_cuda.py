"""The benchmark on the card: the frozen copies of the kernels' arithmetic
against the program's kernels, and each cell's control at the cell's own
size, which has to come out not correct under the committed limits.  These
need a CUDA device and skip without one; run them on the card with

    python -m pytest benchmark_port/tests/test_portbench_cuda.py -m cuda -q
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from conftest import BENCH, REPO, load_harness

harness = load_harness(BENCH)
CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the program's kernels and the cells run only on a card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_frozen_kernel_copies_are_bit_exact(card):
    from image_recognition_adversarial_example_attack_tpu_torch.kernels import elementwise

    plain = harness.load("reference/plain_kernels")
    shape, seed, eps = (128, 224, 224, 3), 2**62 + 99, 8 / 255
    noise = elementwise.uniform_noise_at(shape, eps, seed, card)
    assert torch.equal(noise, plain.uniform_noise(shape, eps, seed, card))
    x0 = torch.rand(shape, device=card)
    x = torch.clamp(x0 + noise, 0, 1)
    g = torch.randn(shape, device=card)
    assert torch.equal(elementwise.pgd_step(x, g, x0, eps, 2 / 255),
                       plain.pgd_step(x, torch.sign(g), x0, eps, 2 / 255))
    assert torch.equal(elementwise.quantize(x * 1.2 - 0.1, 16), plain.quantize(x * 1.2 - 0.1, 16))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(card, cell, tmp_path):
    out = tmp_path / "control.jsonl"
    proc = subprocess.run([sys.executable, str(BENCH / "readings.py"), "--workload", cell,
                           "--seeds", str(2**31 + 17), "--control", "--out", str(out)],
                          cwd=REPO, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(out.read_text().splitlines()[-1])
    limits = json.loads((BENCH / "limits" / f"{cell}.json").read_text())
    failed = [k for k, v in line["readings"].items() if k in limits and not v <= limits[k]]
    assert failed, line["readings"]
