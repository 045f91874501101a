"""Common-corruption robustness CLI, an ImageNet-C-style benchmark (port of
``cli/corruption_eval.py``).

    python -m image_recognition_adversarial_example_attack_tpu_torch.cli.corruption_eval \\
        --image_dir picture/ --corruptions gaussian_noise fog jpeg_compression \\
        --severities 1 3 5 [--device cpu]

Top-1 accuracy under each corruption of the bank (``eval/corruptions.py``)
at each severity, per-corruption error (the mean over severities), the mean
corruption accuracy and error over the bank, and the accuracy retained
against clean; the JAX CLI's console lines and JSON keys (``--output``),
and with ``--plot`` the corruption x severity heatmap.

Labels are the model's clean predictions unless ``--labels_json`` (or
``--imagenet_val_dir``) gives ground truth, with -1 for an unlabeled image.
A cell draws from ``core.rng.cell_generator(seed, "<corruption>:s<severity>")``,
a function of the seed, the corruption's name and the severity alone, so a
narrowed rerun reproduces a full run's cells.  Image sets larger than
``--max_batch`` stream in chunks of that size: one clean prelude pass
resolves every image's label, then each cell streams
(``eval.streaming.stream_correctness_cell``), chunk ``step`` drawing from
``chunk_generator(seed, cell id, step)``.  Both modes decode at the model's
input size.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from ..attacks.api import predict_labels
from ..core.device import resolve_device
from ..core.images import load_image_batch_tolerant
from ..core.rng import cell_generator
from ..eval.corruptions import CORRUPTION_NAMES, make_corruption_run
from .common import (add_imagenet_val_arg, add_model_args, check_label_range, load_bundle,
                     make_fns, maybe_profile, n_classes_of, positive_int, resolve_eval_inputs,
                     resolve_labels, resolve_labels_sentinel)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Top-1 accuracy under common corruptions "
                    "(ImageNet-C-style bank, severities 1..5)")
    parser.add_argument("--image_dir", type=str, default=None)
    parser.add_argument("--image", type=str, default="example.jpg")
    parser.add_argument("--corruptions", type=str, nargs="+", default=["all"],
                        help="corruption names from the bank, or 'all' "
                             f"(choices: {', '.join(CORRUPTION_NAMES)})")
    parser.add_argument("--severities", type=int, nargs="+",
                        default=[1, 2, 3, 4, 5],
                        help="severity levels to sweep (1..5)")
    parser.add_argument("--labels_json", type=str, default=None,
                        help="JSON {path-or-basename: class id} ground-truth "
                             "labels; default = pseudo-labels (clean preds)")
    parser.add_argument("--max_batch", type=positive_int, default=256,
                        help="device batch cap: larger image sets stream "
                             "through the compiled program in fixed-shape "
                             "chunks at constant memory")
    parser.add_argument("--output", type=str, default="corruption_eval.json")
    parser.add_argument("--plot", type=str, default=None,
                        help="write the corruption x severity accuracy "
                             "heatmap here")
    add_imagenet_val_arg(parser)
    add_model_args(parser)
    return parser


def cell_id(name: str, severity: int) -> str:
    """The id a cell's generator is seeded from."""
    return f"{name}:s{int(severity)}"


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    names = (list(CORRUPTION_NAMES) if args.corruptions == ["all"]
             else list(dict.fromkeys(args.corruptions)))
    bad = [n for n in names if n not in CORRUPTION_NAMES]
    if bad:
        raise SystemExit(f"unknown corruptions {bad}; "
                         f"choices: {', '.join(CORRUPTION_NAMES)}")
    severities = sorted(dict.fromkeys(int(s) for s in args.severities))
    if any(s < 1 or s > 5 for s in severities):
        raise SystemExit("severities must be in 1..5")
    device = resolve_device(args.device)
    print(f"Using device: {device}"
          + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))

    paths = resolve_eval_inputs(args)
    bundle = load_bundle(args)
    logits_fn, _ = make_fns(bundle)
    size = bundle.input_size

    def pseudo_fn(xx):
        return predict_labels(logits_fn, xx)

    chunk = int(args.max_batch)
    streaming = len(paths) > chunk
    if streaming:
        from ..eval.streaming import make_placer
        from ..utils.pipeline import EvalBatchPipeline

        place = make_placer(device)
        labels_np = resolve_labels_sentinel(args.labels_json, paths)
        if labels_np is not None:
            check_label_range(labels_np, n_classes_of(bundle.model))
        print(f"Streaming evaluation: {len(paths)} images in fixed chunks "
              f"of {chunk} (constant memory)")
        # one clean prelude pass resolves every image's label and the clean
        # accuracy for all cells: a cell is a corruption and a forward, so
        # a pseudo pass in each would nearly double its time
        kept, label_rows, clean_rows = [], [], []
        pipe = EvalBatchPipeline(paths, chunk, labels=range(len(paths)), size=size)
        for _step, x_np, idx_np, n_valid in pipe:
            pseudo = pseudo_fn(place(x_np)).cpu().numpy()[:n_valid]
            idx = np.asarray(idx_np)[:n_valid]
            gt = (labels_np[idx] if labels_np is not None
                  else np.full(len(idx), -1, np.int64))
            y_eff = np.where(gt < 0, pseudo, gt)
            kept.extend(paths[i] for i in idx)
            label_rows.append(y_eff)
            clean_rows.append(pseudo == y_eff)
        if not kept:
            raise SystemExit("no loadable images")
        resolved_labels = np.concatenate(label_rows)
        clean_correct = np.concatenate(clean_rows)
        x = y = None
    else:
        x_np, kept = load_image_batch_tolerant(paths, size=size)
        if not kept:
            raise SystemExit("no loadable images")
        x = torch.from_numpy(x_np).to(device)
        pseudo = pseudo_fn(x).cpu().numpy()
        y_np = np.asarray(resolve_labels(args.labels_json, kept, pseudo), np.int64)
        if args.labels_json:
            check_label_range(y_np, n_classes_of(bundle.model))
        y = torch.from_numpy(y_np).to(device)
        clean_correct = pseudo == y_np

    n_imgs = len(kept)
    print(f"{n_imgs} images; {len(names)} corruptions x severities {severities} "
          f"(one generator per corruption and severity)")

    cells: dict[str, dict[str, float]] = {}
    matrix = np.zeros((len(names), len(severities)), np.float64)
    with maybe_profile(args.profile_dir):
        for ci, name in enumerate(names):
            run = make_corruption_run(logits_fn, name)
            row: dict[str, float] = {}
            t0 = time.perf_counter()
            for si, sev in enumerate(severities):
                if streaming:
                    from ..eval.streaming import stream_correctness_cell

                    got = stream_correctness_cell(
                        run, kept, seed=args.seed, cell_id=cell_id(name, sev), severity=sev,
                        chunk_size=chunk, place=place, size=size, labels=resolved_labels)
                    correct = got.get("correct", np.empty(0, bool))
                else:
                    correct = run(x, y, sev, cell_generator(args.seed, cell_id(name, sev)))
                    correct = correct.cpu().numpy()
                acc = float(np.mean(correct)) if len(correct) else 0.0
                row[f"s{sev}"] = acc
                matrix[ci, si] = acc
            dt = time.perf_counter() - t0
            cells[name] = row
            accs = " ".join(f"{row[f's{s}']:.3f}" for s in severities)
            print(f"{name:>18s}: {accs}  "
                  f"(err {1.0 - float(np.mean(list(row.values()))):.3f}, {dt:.1f}s)")

    clean_acc = float(np.mean(clean_correct)) if len(clean_correct) else 0.0
    mean_acc = float(matrix.mean()) if matrix.size else 0.0
    retained = mean_acc / clean_acc if clean_acc > 0 else 0.0
    print(f"\nclean accuracy: {clean_acc:.3f}")
    print(f"mean corruption accuracy: {mean_acc:.3f} "
          f"(mean corruption error {1.0 - mean_acc:.3f}, "
          f"retained {retained:.3f} of clean)")

    report = {
        "model": args.model,
        "n_images": int(n_imgs),
        "label_source": "ground_truth" if args.labels_json else "pseudo",
        "severities": severities,
        "clean_accuracy": clean_acc,
        "cells": cells,
        "corruption_error": {name: 1.0 - float(np.mean(list(row.values())))
                             for name, row in cells.items()},
        "mean_corruption_accuracy": mean_acc,
        "mean_corruption_error": 1.0 - mean_acc,
        "retained_accuracy": retained,
    }
    out = Path(args.output)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2))
    print(f"report written to {out}")

    if args.plot:
        from ..viz.plots import plot_corruption_heatmap

        plot_corruption_heatmap(matrix, names, severities, clean_acc, Path(args.plot))
        print(f"heatmap written to {args.plot}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
