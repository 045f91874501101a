"""Shared set-up of the port's grid-CLI tests (tests/test_torch_defense_experiments*.py,
test_torch_grid_plumbing.py)."""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
from PIL import Image

# the exact six-field summary line (tests/test_cli.py:64-69)
SUMMARY = re.compile(
    r"^attack=(fgsm|pgd|cw), eps=(\d\.\d{5}), attack_success=\d\.\d{3}, "
    r"preproc_defense_acc=\d\.\d{3}, detector_clean_pass_rate=\d\.\d{3}, "
    r"detector_adv_flag_rate=\d\.\d{3}, detector_attack_success=\d\.\d{3}$")
# resnet_tiny on the CPU, two PGD steps, four CW steps
FAST = ["--device", "cpu", "--model", "resnet_tiny", "--steps", "2", "--cw_steps", "4"]


def write_images(d: Path, n: int = 3, size: int = 64) -> Path:
    rs = np.random.RandomState(0)
    for i in range(n):
        Image.fromarray((rs.rand(size, size, 3) * 255).astype(np.uint8)).save(d / f"img_{i}.jpg")
    return d


def val_tree(root: Path) -> Path:
    """An ImageNet-val tree of class subfolders: n01 (2 images), n02 (1)."""
    rs = np.random.RandomState(1)
    for cls, n in (("n01", 2), ("n02", 1)):
        (root / cls).mkdir(parents=True)
        for i in range(n):
            Image.fromarray((rs.rand(40, 40, 3) * 255).astype(np.uint8)).save(
                root / cls / f"{cls}_{i}.png")
    return root


def summary_lines(out: str) -> list[str]:
    return [line for line in out.splitlines() if line.startswith("attack=")]

