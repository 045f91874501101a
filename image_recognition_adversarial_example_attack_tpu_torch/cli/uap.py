"""Universal-perturbation / adversarial-patch trainer CLI (port of
``cli/uap.py``).

Trains ONE artifact on a directory of images: an image-wide L∞ delta
(``--mode uap``, ``attacks/uap.py``) or a localized square patch (``--mode
patch``, ``attacks/patch.py``); reports its fooling or success rate and
saves it as ``<stem>.npy``, a viewable ``<stem>.png`` (the delta on a
mid-grey canvas, ``0.5 + delta / (2 eps)``) and ``<stem>.json`` with the
JAX CLI's keys.

    python -m image_recognition_adversarial_example_attack_tpu_torch.cli.uap \\
        --image_dir picture --eps 0.0392 --epochs 20 [--device cpu]
    python -m image_recognition_adversarial_example_attack_tpu_torch.cli.uap \\
        --mode patch --image_dir picture --patch_size 50 --steps 250 --target 859

The training draws from ``generator_from_seed(--seed)``; patch mode
evaluates its rate and places the saved images from two generators of
their own, ``cell_generator(seed, "patch:eval")`` and ``(seed,
"patch:apply")``, the counterparts of the JAX CLI's ``fold_in(key, 1)`` and
``fold_in(key, 2)``.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from ..attacks.api import predict_labels
from ..attacks.patch import apply_patch, patch_attack, patch_success_rate
from ..attacks.uap import apply_uap, uap_attack, uap_fooling_rate
from ..core.device import resolve_device
from ..core.images import load_image_batch_tolerant, save_image_01
from ..core.rng import cell_generator, generator_from_seed
from .common import (add_imagenet_val_arg, add_model_args, check_label_range, load_bundle,
                     make_fns, maybe_profile, model_input_size, n_classes_of,
                     resolve_eval_inputs, resolve_labels)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Train a universal perturbation or adversarial patch")
    parser.add_argument("--mode", type=str, default="uap", choices=["uap", "patch"])
    parser.add_argument("--image_dir", type=str, default=None)
    parser.add_argument("--image", type=str, default="example.jpg")
    parser.add_argument("--labels_json", type=str, default=None,
                        help="JSON {path-or-basename: class id} ground truth; "
                             "default = the model's clean predictions")
    parser.add_argument("--target", type=int, default=None,
                        help="targeted mode: ONE class the universal "
                             "artifact drives every input toward")
    # uap knobs
    parser.add_argument("--eps", type=float, default=10 / 255,
                        help="[uap] L-inf budget of the shared delta")
    parser.add_argument("--alpha", type=float, default=None,
                        help="[uap] sign-step size (default eps/10)")
    parser.add_argument("--epochs", type=int, default=20,
                        help="[uap] passes over the image set")
    parser.add_argument("--batch_size", type=int, default=None,
                        help="[uap] mini-batch size (default: full batch)")
    # patch knobs
    parser.add_argument("--patch_size", type=int, default=50,
                        help="[patch] square side in pixels")
    parser.add_argument("--steps", type=int, default=250,
                        help="[patch] EOT optimization steps")
    parser.add_argument("--lr", type=float, default=1 / 255,
                        help="[patch] sign-step size")
    parser.add_argument("--no_rotations", action="store_true",
                        help="[patch] disable the 4 lattice rotations in EOT")
    parser.add_argument("--save_adv_dir", type=str, default=None,
                        help="also write each input with the artifact "
                             "applied (one random placement for patch mode)")
    parser.add_argument("--output", type=str, default="uap_artifact",
                        help="artifact stem: writes <stem>.npy, <stem>.png, "
                             "<stem>.json")
    add_imagenet_val_arg(parser)
    add_model_args(parser)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    paths = resolve_eval_inputs(args, skip_bmp=False)
    device = resolve_device(args.device)
    print(f"Using device: {device}"
          + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))

    x_np, kept = load_image_batch_tolerant(paths, size=model_input_size(args))
    if not kept:
        raise SystemExit("no loadable images")
    bundle = load_bundle(args)
    logits_fn, _ = make_fns(bundle)
    x = torch.from_numpy(x_np).to(device)

    clean_pred = predict_labels(logits_fn, x).cpu().numpy()
    y_np = np.asarray(resolve_labels(args.labels_json, kept, clean_pred), np.int64)
    n_classes = n_classes_of(bundle.model)
    if args.labels_json:
        check_label_range(y_np, n_classes)
    if args.target is not None and not 0 <= args.target < n_classes:
        raise SystemExit(f"--target {args.target} outside [0, {n_classes})")
    y = torch.from_numpy(y_np).to(device)

    stem = Path(args.output)
    summary: dict = {"mode": args.mode, "n_images": len(kept), "target": args.target,
                     "seed": args.seed, "model": args.model}
    rotations = not args.no_rotations
    generator = generator_from_seed(args.seed)

    t0 = time.perf_counter()
    with maybe_profile(args.profile_dir):
        if args.mode == "uap":
            res = uap_attack(logits_fn, x, y, eps=float(args.eps), alpha=args.alpha,
                             epochs=int(args.epochs), batch_size=args.batch_size,
                             generator=generator, y_target=args.target)
            artifact = res.delta.cpu().numpy()
            x_adv = apply_uap(x, res.delta)
            fooled = float(uap_fooling_rate(logits_fn, x, res.delta))
            summary.update({
                "eps": float(args.eps),
                "epochs": int(args.epochs),
                "fooling_rate": fooled,
                "loss_per_epoch": [float(v) for v in res.loss_per_epoch.cpu()],
                "linf": float(np.abs(artifact).max()),
            })
            print(f"UAP trained: |delta|_inf = {summary['linf']:.4f} "
                  f"(eps {args.eps:.4f}), fooling rate "
                  f"{fooled:.3f} over {len(kept)} images "
                  f"({time.perf_counter() - t0:.1f}s)")
            # the signed delta on a mid-grey canvas, full contrast
            png = 0.5 + artifact / (2 * float(args.eps))
        else:
            res = patch_attack(logits_fn, x, y, patch_size=int(args.patch_size),
                               steps=int(args.steps), lr=float(args.lr), generator=generator,
                               y_target=args.target, rotations=rotations)
            artifact = res.patch.cpu().numpy()
            eval_gen = cell_generator(args.seed, "patch:eval")
            if args.target is not None:
                rate = float(patch_success_rate(logits_fn, x, res.patch, generator=eval_gen,
                                                y_target=args.target, rotations=rotations))
                rate_name = "targeted success rate"
            else:
                rate = float(patch_success_rate(logits_fn, x, res.patch, generator=eval_gen,
                                                ys=y, rotations=rotations))
                rate_name = "fooling rate"
            x_adv = apply_patch(x, res.patch, generator=cell_generator(args.seed, "patch:apply"),
                                rotations=rotations)
            summary.update({
                "patch_size": int(args.patch_size),
                "steps": int(args.steps),
                rate_name.replace(" ", "_"): rate,
                "loss_per_step_head": [float(v) for v in res.loss_per_step[:10].cpu()],
            })
            print(f"Patch trained: {args.patch_size}x{args.patch_size}, "
                  f"{rate_name} {rate:.3f} over {len(kept)} images "
                  f"({time.perf_counter() - t0:.1f}s)")
            png = artifact

        adv_pred = predict_labels(logits_fn, x_adv).cpu().numpy()
        summary["per_image"] = [
            {"image": str(p), "clean_pred": int(c), "adv_pred": int(a)}
            for p, c, a in zip(kept, clean_pred, adv_pred)
        ]

    stem.parent.mkdir(parents=True, exist_ok=True)
    np.save(stem.with_suffix(".npy"), artifact)
    save_image_01(np.clip(png, 0.0, 1.0), stem.with_suffix(".png"))
    stem.with_suffix(".json").write_text(json.dumps(summary, indent=2))
    print(f"artifact -> {stem.with_suffix('.npy')} / "
          f"{stem.with_suffix('.png')} / {stem.with_suffix('.json')}")

    if args.save_adv_dir:
        out_dir = Path(args.save_adv_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        adv_np = x_adv.cpu().numpy()
        for i, p in enumerate(kept):
            save_image_01(adv_np[i], out_dir / f"{Path(p).stem}_adv.png")
        print(f"applied images -> {out_dir} ({len(kept)} files)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
