"""Query-efficiency curves CLI: ASR against the model-query budget, per attack
(port of ``cli/query_curves.py``).

    python -m image_recognition_adversarial_example_attack_tpu_torch.cli.query_curves \\
        --image_dir picture/ --attacks square simba nes --max_queries 2000 \\
        --checkpoints 100 500 1000 2000 [--device cpu]

One attack run at the largest budget gives the whole curve (the attacks
return their per-step success; ``eval/query_curves.py``).  The table samples
the curve at ``--checkpoints``; the JSON (``--output``) carries all of it.
Each attack draws from ``core.rng.cell_generator(seed, attack)``.  Image
sets larger than ``--max_batch`` stream in chunks of that size
(``eval.streaming.stream_query_curve_hist``), chunk ``step`` drawing from
``chunk_generator(seed, attack, step)``, with one clean forward per chunk
for the pseudo-labels of every attack.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..attacks.api import predict_labels
from ..core.constants import DEFAULT_ALPHA, DEFAULT_EPS
from ..core.device import resolve_device
from ..core.images import load_image_batch_tolerant
from ..core.rng import cell_generator
from ..eval.query_curves import (CURVE_ATTACKS, _runner, assemble_curve, budget_to_steps,
                                 curve_at_checkpoints, query_curve)
from .common import (add_imagenet_val_arg, add_model_args, check_label_range, load_bundle,
                     make_fns, maybe_profile, n_classes_of, resolve_eval_inputs,
                     resolve_labels, resolve_labels_sentinel)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Black-box query-efficiency curves (ASR vs queries)")
    parser.add_argument("--image_dir", type=str, default=None)
    parser.add_argument("--image", type=str, default="example.jpg")
    parser.add_argument("--attacks", type=str, nargs="+",
                        default=["square", "simba"],
                        choices=list(CURVE_ATTACKS))
    parser.add_argument("--eps", type=float, default=DEFAULT_EPS)
    parser.add_argument("--alpha", type=float, default=DEFAULT_ALPHA,
                        help="nes/spsa step size")
    parser.add_argument("--max_queries", type=int, default=2000)
    parser.add_argument("--checkpoints", type=int, nargs="+",
                        default=[100, 500, 1000, 2000],
                        help="budgets the printed table samples")
    parser.add_argument("--est_samples", type=int, default=32,
                        help="nes/spsa probe pairs per step")
    parser.add_argument("--nes_sigma", type=float, default=1e-3)
    parser.add_argument("--spsa_delta", type=float, default=1e-2)
    parser.add_argument("--simba_eps", type=float, default=0.2)
    parser.add_argument("--simba_mode", choices=["dct", "pixel"],
                        default="dct")
    parser.add_argument("--labels_json", type=str, default=None)
    parser.add_argument("--max_batch", type=int, default=256,
                        help="image sets larger than this STREAM fixed-"
                             "shape chunks through the same history-emitting "
                             "attacks at constant memory (0 = always one "
                             "resident batch)")
    parser.add_argument("--output", type=str, default="query_curves.json")
    add_imagenet_val_arg(parser)
    add_model_args(parser)
    return parser


def table_header(checkpoints) -> str:
    return (f"{'attack':<10} " + " ".join(f"q={c:<6}" for c in checkpoints)
            + f" {'median-q':>9} {'time':>7}")


def table_row(name: str, curve: dict, checkpoints, seconds: float) -> str:
    med = curve["median_queries_to_success"]
    return (f"{name:<10} " + " ".join(f"{a:<8.3f}" for _, a in
                                      curve_at_checkpoints(curve, checkpoints))
            + f" {med if med is not None else '—':>9} {seconds:>6.1f}s")


def _curve_kwargs(args) -> dict:
    return {"eps": float(args.eps), "est_samples": int(args.est_samples),
            "nes_sigma": float(args.nes_sigma), "spsa_delta": float(args.spsa_delta),
            "alpha": float(args.alpha), "simba_eps": float(args.simba_eps),
            "simba_mode": str(args.simba_mode)}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    paths = resolve_eval_inputs(args)

    device = resolve_device(args.device)
    print(f"Using device: {device}"
          + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))
    bundle = load_bundle(args)
    logits_fn, _ = make_fns(bundle)

    max_batch = int(args.max_batch)
    if max_batch > 0 and len(paths) > max_batch:
        return _main_streamed(args, paths, bundle, logits_fn, device)

    x_np, kept = load_image_batch_tolerant(paths, size=bundle.input_size)
    if not kept:
        raise SystemExit("no loadable images")
    x = torch.from_numpy(x_np).to(device)
    pseudo = predict_labels(logits_fn, x).cpu().numpy()
    y_np = np.asarray(resolve_labels(args.labels_json, kept, pseudo), np.int64)
    if args.labels_json:
        check_label_range(y_np, n_classes_of(bundle.model))
    y = torch.from_numpy(y_np).to(device)
    n = len(kept)

    cps = sorted(int(c) for c in args.checkpoints)
    header = table_header(cps)
    print(f"\n{n} images; eps={float(args.eps):.5f}; max budget "
          f"{int(args.max_queries)} queries (ONE run per attack yields the "
          f"full curve)")
    print(header)
    print("-" * len(header))
    results = []
    with maybe_profile(args.profile_dir):
        for name in args.attacks:
            t0 = time.perf_counter()
            curve = query_curve(name, logits_fn, x, y, max_queries=int(args.max_queries),
                                generator=cell_generator(args.seed, name), **_curve_kwargs(args))
            print(table_row(name, curve, cps, time.perf_counter() - t0))
            results.append(curve)

    out = Path(args.output)
    out.write_text(json.dumps({
        "count": n,
        "eps": float(args.eps),
        "max_queries": int(args.max_queries),
        "labels": "ground-truth" if args.labels_json else "pseudo",
        "curves": results,
    }, indent=2))
    print(f"\nWrote {out}")
    return 0


def _main_streamed(args, paths, bundle, logits_fn, device) -> int:
    """The curves over any number of images: fixed-shape chunks through the
    same history-emitting attacks (``eval.streaming.stream_query_curve_hist``).
    The curve's two reductions stream exactly, so the JSON is the one-batch
    path's for the same draws (``assemble_curve`` is shared)."""
    from ..eval.streaming import make_placer, stream_query_curve_hist

    n = len(paths)
    chunk = int(args.max_batch)
    labels_sent = resolve_labels_sentinel(args.labels_json, paths)
    if labels_sent is not None:
        check_label_range(labels_sent, n_classes_of(bundle.model))
    cps = sorted(int(c) for c in args.checkpoints)
    header = table_header(cps)
    print(f"\n{n} images STREAMED in fixed chunks of {chunk} (constant "
          f"memory); eps={float(args.eps):.5f}; max budget "
          f"{int(args.max_queries)} queries (ONE run per attack per chunk "
          f"yields the full curve)")
    print(header)
    print("-" * len(header))
    results = []
    n_loaded = n
    clean_preds: dict = {}  # per-chunk pseudo-labels, shared by the attacks
    place = make_placer(device)
    with maybe_profile(args.profile_dir):
        for name in args.attacks:
            t0 = time.perf_counter()
            steps = budget_to_steps(name, int(args.max_queries), int(args.est_samples))
            fn, per_step, init_q = _runner(name, logits_fn, steps=steps, **_curve_kwargs(args))
            raw = stream_query_curve_hist(
                fn, steps, paths, seed=args.seed, cell_id=name, chunk_size=chunk,
                place=place, size=bundle.input_size,
                pseudo_label_fn=lambda xx: predict_labels(logits_fn, xx),
                labels=labels_sent, clean_cache=clean_preds)
            curve = assemble_curve(name, raw["ever_count"], raw["count"], raw["first"],
                                   per_step=per_step, init_q=init_q, steps=steps)
            n_loaded = int(raw["count"])
            print(table_row(name, curve, cps, time.perf_counter() - t0))
            results.append(curve)

    out = Path(args.output)
    out.write_text(json.dumps({
        "count": n_loaded,
        "eps": float(args.eps),
        "max_queries": int(args.max_queries),
        "labels": "ground-truth" if args.labels_json else "pseudo",
        "streamed": True,
        "max_batch": chunk,
        "curves": results,
    }, indent=2))
    print(f"\nWrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
