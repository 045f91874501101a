"""Test-set quality diagnostic CLI (port of ``cli/dataset_check.py``, the
reference's ``test.py`` surface).

    python -m image_recognition_adversarial_example_attack_tpu_torch.cli.dataset_check \\
        --test_dir test_set/ [--topk 5] [--threshold 0.7] [--device cpu]

Scans ``--test_dir`` recursively for ``*.jpg``, classifies them in one
batched forward, and flags the images whose top-k probability sum is below
the threshold; warns when more than 30% of the set is low-confidence.  An
image that fails to decode is reported and skipped.  Same flags, table and
diagnosis lines as the JAX CLI.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.images import load_image
from ..core.labels import load_imagenet_labels
from .common import add_model_args, load_bundle, make_fns

CATEGORY_KEYWORDS = {
    "car": ["car", "vehicle"],
    "dog": ["dog"],
    "bird": ["bird"],
    "cat": ["cat"],
    "plane": ["plane", "aircraft"],
    "ship": ["ship", "boat"],
    "food": ["food", "dish"],
    "furniture": ["furniture", "chair", "table", "bed"],
    "computer": ["computer", "pc", "laptop"],
}


def extract_display_category(filename: str) -> str:
    low = filename.lower()
    for category, keywords in CATEGORY_KEYWORDS.items():
        if any(kw in low for kw in keywords):
            return category
    return "unknown"


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Test-set image quality diagnostic")
    parser.add_argument("--test_dir", type=str, default="./test_set")
    parser.add_argument("--topk", type=int, default=5)
    parser.add_argument("--threshold", type=float, default=0.7)
    add_model_args(parser)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    print("=" * 60)
    print("Test-set image quality diagnostic (top-k sum)")
    print("=" * 60)

    test_dir = Path(args.test_dir)
    if not test_dir.exists():
        print(f"ERROR: directory {test_dir} does not exist!")
        return 1

    paths = sorted(test_dir.rglob("*.jpg"))
    if not paths:
        print("WARNING: no jpg images found!")
        return 0

    device = resolve_device(args.device)
    print(f"Using device: {device}"
          + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else "")
          + "\n")
    bundle = load_bundle(args)
    logits_fn, _ = make_fns(bundle)
    labels = load_imagenet_labels()
    top_k = int(args.topk)
    threshold = float(args.threshold)

    # decode with per-image error isolation
    arrays, good_paths = [], []
    for p in paths:
        try:
            arrays.append(load_image(p))
            good_paths.append(p)
        except Exception as e:  # noqa: BLE001 — report any decode failure, go on
            print(f"FAILED to load {p.name}: {e}")
    if not arrays:
        print("WARNING: no readable images!")
        return 0

    x = torch.from_numpy(np.concatenate(arrays, axis=0)).to(device)
    with torch.no_grad():
        probs = torch.softmax(logits_fn(x), dim=-1).cpu().numpy()

    print(f"Diagnostic: top-{top_k} sum >= {threshold}\n")
    print(f"{'image':<40s} {'top-1 pred':<18s} {'top-1 conf':<12s} "
          f"{'top-' + str(top_k) + ' sum':<12s} {'category':<10s} {'status':<10s}")
    print("=" * 110)

    low_conf = []
    order = np.argsort(-probs, axis=-1)[:, :top_k]
    for i, p in enumerate(good_paths):
        top_idx = order[i]
        top1_conf = float(probs[i, top_idx[0]])
        topk_sum = float(probs[i, top_idx].sum())
        category = extract_display_category(p.name)
        if topk_sum < threshold:
            low_conf.append((p.name, top1_conf, topk_sum, category))
            status = "LOW"
        else:
            status = "OK"
        top1_label = labels[top_idx[0]][:16] if top_idx[0] < len(labels) else str(top_idx[0])
        print(f"{p.name:<40s} {top1_label:<18s} {top1_conf:<12.4f} "
              f"{topk_sum:<12.4f} {category:<10s} {status:<10s}")

    print("\n" + "=" * 110)
    print("Diagnosis")
    print("=" * 110)
    total = len(good_paths)
    ratio = len(low_conf) / total
    print(f"Total images: {total}")
    print(f"High-confidence images (top-{top_k} >= {threshold}): {total - len(low_conf)}")
    print(f"Low-confidence images: {len(low_conf)}")
    print(f"Low-confidence ratio: {ratio:.1%}")

    if ratio > 0.3:
        print("\nWARNING: more than 30% of images are low-confidence!")
        print("  Consider re-curating the test set.")
    else:
        print("\nTest-set quality OK.")
    if low_conf:
        print("  Low-confidence images:")
        for name, top1, ksum, cat in low_conf:
            print(f"   - {name}: top-1={top1:.4f}, top-{top_k} sum={ksum:.4f} ({cat})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
