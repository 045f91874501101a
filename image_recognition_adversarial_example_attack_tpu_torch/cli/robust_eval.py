"""Worst-case robust accuracy CLI, the AutoAttack protocols (port of
``cli/robust_eval.py``).

    python -m image_recognition_adversarial_example_attack_tpu_torch.cli.robust_eval \\
        --image_dir picture/ --protocol standard --eps_list 0.01569 0.03137 \\
        --apgd_steps 100 --square_steps 5000 [--device cpu]

``--protocol standard`` is the full AutoAttack (APGD-CE + APGD-T + FAB-T +
Square), ``lite`` (the default, for cheap sweeps) APGD-CE + Square + in-ball
DeepFool, ``rand`` the randomized-defense protocol (EOT-APGD-CE +
EOT-APGD-DLR + Square on the expected classifier); ``--norm l2`` takes the
arms' L2 variants (``eval/robust_eval.py``).  Per eps it prints the robust
accuracy over the clean-correct samples and each arm's successes, and writes
the JAX CLI's JSON (``--output``) and, with ``--plot``, the figure.  Labels
are the model's clean predictions unless ``--labels_json`` (or
``--imagenet_val_dir``) gives ground truth.

Each eps draws from ``core.rng.cell_generator(seed, "<protocol>:<eps>")``.
Image sets larger than ``--max_batch`` stream in chunks of that size
(``eval.streaming.stream_robust_cell``), chunk ``step`` drawing from
``chunk_generator(seed, that cell id, step)``; ``--save_adv_dir`` saves the
worst-case examples in one-batch mode only.  ``--cifar10_dir`` evaluates a
standard CIFAR-10 archive (``core.datasets.load_cifar10``: ``--cifar10_split``,
the first ``--cifar10_n`` images) with its real labels, one resident batch,
on a 32x32 model (the CIFAR family); it refuses ``--imagenet_val_dir``.
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
from ..core.constants import DEFAULT_EPS_LIST
from ..core.device import resolve_device
from ..core.images import load_image_batch_tolerant
from ..core.rng import cell_generator
from ..eval.robust_eval import autoattack, autoattack_lite, autoattack_rand
from .common import (add_imagenet_val_arg, add_model_args, check_label_range, cifar10_inputs,
                     load_bundle, make_fns, maybe_profile, n_classes_of, require_cifar_model,
                     resolve_eval_inputs, resolve_labels, resolve_labels_sentinel)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Worst-case robust accuracy (APGD + Square + DeepFool)")
    parser.add_argument("--image_dir", type=str, default=None)
    parser.add_argument("--image", type=str, default="example.jpg")
    parser.add_argument("--cifar10_dir", type=str, default=None,
                        help="evaluate on a standard CIFAR-10 archive "
                             "(core/datasets.py) with REAL labels — the "
                             "RobustBench-style flow for checkpoints from "
                             "adversarial_train --cifar10_dir; overrides "
                             "--image_dir/--image")
    parser.add_argument("--cifar10_split", type=str, default="test",
                        choices=["train", "test"])
    parser.add_argument("--cifar10_n", type=int, default=1000,
                        help="cap on evaluated CIFAR images (0 = all)")
    parser.add_argument("--eps_list", type=float, nargs="+",
                        default=list(DEFAULT_EPS_LIST))
    parser.add_argument("--protocol", type=str, default="lite",
                        choices=["lite", "standard", "rand"],
                        help="standard: full AutoAttack (APGD-CE + APGD-T "
                             "+ FAB-T + Square); lite: APGD-CE + Square + "
                             "in-ball DeepFool; rand: the randomized-"
                             "defense protocol (EOT-APGD-CE + EOT-APGD-DLR "
                             "+ Square on the expected classifier)")
    parser.add_argument("--eot_samples", type=int, default=20,
                        help="(rand protocol) Monte-Carlo transform draws "
                             "per EOT gradient / expected prediction")
    parser.add_argument("--eot_sigma", type=float, default=0.25,
                        help="(rand protocol) Gaussian-noise transform "
                             "sigma — the randomized-smoothing setting")
    parser.add_argument("--norm", type=str, default="linf",
                        choices=["linf", "l2"],
                        help="threat-model ball: L-inf (reference "
                             "convention) or L2 (AutoAttack-L2: APGD-L2, "
                             "FAB-L2, Square-L2)")
    parser.add_argument("--apgd_steps", type=int, default=100)
    parser.add_argument("--square_steps", type=int, default=1000)
    parser.add_argument("--deepfool_steps", type=int, default=30,
                        help="(lite protocol)")
    parser.add_argument("--fab_steps", type=int, default=100,
                        help="(standard protocol)")
    parser.add_argument("--n_target_classes", type=int, default=9,
                        help="APGD-T / FAB-T restarts over the top-K "
                             "runner-up classes (standard protocol)")
    parser.add_argument("--labels_json", type=str, default=None,
                        help="JSON {path-or-basename: class id} ground-truth "
                             "labels; default = pseudo-labels (clean preds)")
    parser.add_argument("--max_batch", type=int, default=256,
                        help="device batch cap: image sets larger than this "
                             "stream through the protocol in fixed-shape chunks "
                             "at constant memory (0 = always one resident batch)")
    parser.add_argument("--output", type=str, default="robust_eval.json")
    parser.add_argument("--save_adv_dir", type=str, default=None,
                        help="save each image's per-sample WORST-CASE "
                             "adversarial example (first successful arm in "
                             "protocol order) as PNGs here, one subdir per "
                             "eps; one-resident-batch mode only (ignored "
                             "with a streaming-size image set)")
    parser.add_argument("--plot", type=str, default=None,
                        help="write the robust-accuracy-vs-eps figure here")
    add_imagenet_val_arg(parser)
    add_model_args(parser)
    return parser


def _protocol(args, logits_fn, save_adv: bool):
    """(arm names, arm description, run(x, y, generator, eps) -> (success,
    per-arm successes..., [x_adv]))."""
    steps, square = int(args.apgd_steps), int(args.square_steps)

    def pack(masks, res):
        return masks + (res.x_adv,) if save_adv else masks

    if args.protocol == "rand":
        def run(x, y, g, eps):
            res = autoattack_rand(logits_fn, x, y, eps=eps, generator=g,
                                  eot_samples=int(args.eot_samples), sigma=float(args.eot_sigma),
                                  apgd_steps=steps, square_steps=square, norm=args.norm)
            return pack((res.success, res.success_apgd_ce, res.success_apgd_dlr,
                         res.success_square), res)

        return (("apgd_ce_eot", "apgd_dlr_eot", "square"),
                f"eot{args.eot_samples}@sigma{args.eot_sigma} apgd-ce-{args.apgd_steps} "
                f"apgd-dlr-{args.apgd_steps} square-{args.square_steps}", run)
    if args.protocol == "standard":
        k = int(args.n_target_classes)

        def run(x, y, g, eps):
            res = autoattack(logits_fn, x, y, eps=eps, generator=g, apgd_steps=steps,
                             apgd_t_steps=steps, apgd_t_targets=k,
                             fab_steps=int(args.fab_steps), fab_targets=k,
                             square_steps=square, norm=args.norm)
            return pack((res.success, res.success_apgd_ce, res.success_apgd_t,
                         res.success_fab, res.success_square), res)

        return (("apgd_ce", "apgd_t", "fab", "square"),
                f"apgd-ce-{args.apgd_steps} apgd-t-{args.apgd_steps}x{args.n_target_classes} "
                f"fab-t-{args.fab_steps}x{args.n_target_classes} square-{args.square_steps}",
                run)

    def run(x, y, g, eps):
        res = autoattack_lite(logits_fn, x, y, eps=eps, generator=g, apgd_steps=steps,
                              square_steps=square, deepfool_steps=int(args.deepfool_steps),
                              norm=args.norm)
        return pack((res.success, res.success_apgd, res.success_square,
                     res.success_deepfool), res)

    return (("apgd", "square", "deepfool"),
            f"apgd-{args.apgd_steps} square-{args.square_steps} "
            f"deepfool-{args.deepfool_steps}", run)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cifar = args.cifar10_dir is not None
    if cifar:
        x_all, y_all, paths = cifar10_inputs(args)
    else:
        paths = resolve_eval_inputs(args)

    device = resolve_device(args.device)
    print(f"Using device: {device}"
          + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))
    bundle = load_bundle(args)
    if cifar:
        require_cifar_model(args, bundle)
    logits_fn, _ = make_fns(bundle)

    def pseudo_fn(xx):
        return predict_labels(logits_fn, xx)

    max_batch = int(args.max_batch)
    # the CIFAR-10 archive is decoded already: always one resident batch
    streaming = not cifar and max_batch > 0 and len(paths) > max_batch
    if cifar:
        kept = paths
        y_np = y_all.astype(np.int64)
        check_label_range(y_np, n_classes_of(bundle.model))
        x = torch.from_numpy(x_all).to(device)
        y = torch.from_numpy(y_np).to(device)
        clean_correct = pseudo_fn(x).cpu().numpy() == y_np
        print(f"clean accuracy vs CIFAR-10 {args.cifar10_split} labels: "
              f"{clean_correct.mean():.3f}")
    elif streaming:
        kept = list(paths)  # the chunks' decode handles failures
        x = y = clean_correct = None
        # ground truth with the UNLABELED sentinel, replaced per chunk by
        # that image's pseudo-label
        labels_np = resolve_labels_sentinel(args.labels_json, kept)
        if labels_np is not None:
            check_label_range(labels_np, n_classes_of(bundle.model))
        print(f"Streaming evaluation: {len(paths)} images in fixed chunks "
              f"of {max_batch} (constant memory)")
    else:
        x_np, kept = load_image_batch_tolerant(paths, size=bundle.input_size)
        if not kept:
            raise SystemExit("no loadable images")
        x = torch.from_numpy(x_np).to(device)
        pseudo = pseudo_fn(x).cpu().numpy()
        y_np = np.asarray(resolve_labels(args.labels_json, kept, pseudo), np.int64)
        if args.labels_json:
            check_label_range(y_np, n_classes_of(bundle.model))
        y = torch.from_numpy(y_np).to(device)
        clean_correct = pseudo == y_np
        if args.labels_json:
            print(f"clean accuracy vs ground truth: {clean_correct.mean():.3f}")

    save_adv = args.save_adv_dir is not None and not streaming
    if args.save_adv_dir is not None and streaming:
        print("(--save_adv_dir ignored: streaming mode keeps x_adv "
              "on-device per chunk; rerun with --max_batch 0 to save)")
    arm_names, arm_desc, run = _protocol(args, logits_fn, save_adv)

    rows = []
    n = len(kept)
    print(f"{n} images; protocol={args.protocol}; norm={args.norm}; "
          f"arms: {arm_desc} (one generator per eps)")
    clean_preds: dict = {}  # per-chunk pseudo-labels, shared across eps
    with maybe_profile(args.profile_dir):
        for eps in args.eps_list:
            cell_id = f"{args.protocol}:{float(eps):.6f}"
            t0 = time.perf_counter()
            if streaming:
                from ..eval.streaming import make_placer, stream_robust_cell

                got = stream_robust_cell(
                    run, kept, seed=args.seed, cell_id=cell_id, eps=float(eps),
                    chunk_size=max_batch, place=make_placer(device), size=bundle.input_size,
                    pseudo_label_fn=pseudo_fn, labels=labels_np, clean_cache=clean_preds)
                if not got:  # every chunk dropped: nothing decoded
                    raise SystemExit("no loadable images")
                succ = got["arm0"]
                arms = [got[f"arm{i + 1}"] for i in range(len(arm_names))]
                cc = got["clean_correct"]
                n = len(succ)
            else:
                outs = [o.cpu().numpy() for o in run(x, y, cell_generator(args.seed, cell_id),
                                                     float(eps))]
                if save_adv:
                    *outs, x_adv_np = outs
                    from ..core.images import save_image_01

                    adv_dir = Path(args.save_adv_dir) / f"eps_{float(eps):.5f}"
                    # the index prefix keeps distinct sources with equal
                    # stems (a.jpg, a.png) apart
                    for i, (img, p) in enumerate(zip(x_adv_np, kept)):
                        save_image_01(img, adv_dir / f"adv_{i:04d}_{Path(p).stem}.png")
                    print(f"  saved {len(kept)} worst-case examples to {adv_dir}")
                succ, arms = outs[0], list(outs[1:])
                cc = clean_correct
            dt = time.perf_counter() - t0
            # robust accuracy over the clean-correct subset (with pseudo-labels
            # every sample is clean-correct)
            n_cc = max(1, int(cc.sum()))
            robust_acc = float((cc & ~succ).sum()) / n_cc
            per_arm = " ".join(f"{nm} {int(v.sum())}/{n}" for nm, v in zip(arm_names, arms))
            print(f"eps={float(eps):.5f}: robust_acc={robust_acc:.3f} "
                  f"({per_arm})  [{dt:.1f}s]")
            row = {"eps": float(eps), "robust_accuracy": robust_acc, "count": n}
            for nm, v in zip(arm_names, arms):
                row[f"success_{nm}"] = int(v.sum())
            rows.append(row)

    out = Path(args.output)
    out.write_text(json.dumps({
        "protocol": args.protocol,
        "norm": args.norm,
        "eot_samples": int(args.eot_samples),
        "eot_sigma": float(args.eot_sigma),
        "apgd_steps": int(args.apgd_steps),
        "square_steps": int(args.square_steps),
        "deepfool_steps": int(args.deepfool_steps),
        "fab_steps": int(args.fab_steps),
        "n_target_classes": int(args.n_target_classes),
        "results": rows,
    }, indent=2))
    print(f"Wrote {out}")
    if args.plot:
        from ..viz.plots import plot_robust_accuracy

        plot_robust_accuracy(rows, Path(args.plot))
        print(f"Wrote {args.plot}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
