"""Classify-and-attack CLI (port of ``cli/classify.py``, the ``ResNet.py``
surface) for ``--attack {none,fgsm,pgd}``.

    python -m image_recognition_adversarial_example_attack_tpu_torch.cli.classify \\
        image.jpg --attack pgd --save_adv adv.png [--device cpu]

A directory input becomes one [B,224,224,3] batch; the attack runs once and
the results print per image in the reference's format.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

from ..attacks import AttackParams, run_attack
from ..core.constants import DEFAULT_ALPHA, DEFAULT_EPS, DEFAULT_STEPS
from ..core.images import list_images, load_image_batch_tolerant, save_image_01
from ..core.labels import load_imagenet_labels
from ..core.rng import generator_from_seed
from .common import add_model_args, load_bundle, make_fns, print_topk, topk_host


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Classify an image (or directory) and optionally attack it."
    )
    parser.add_argument("image", nargs="?", default="example.jpg")
    parser.add_argument("--topk", type=int, default=5)
    parser.add_argument("--attack", choices=["none", "fgsm", "pgd"], default="none")
    parser.add_argument("--label", type=int, default=None)
    parser.add_argument("--eps", type=float, default=DEFAULT_EPS)
    parser.add_argument("--alpha", type=float, default=DEFAULT_ALPHA)
    parser.add_argument("--steps", type=int, default=DEFAULT_STEPS)
    parser.add_argument("--target", type=int, default=None)
    parser.add_argument("--save_adv", type=str, default=None)
    add_model_args(parser)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    image_path = Path(args.image)
    if image_path.is_dir():
        paths = list_images(image_path)
        if not paths:
            raise SystemExit(f"No image files found in directory: {image_path}")
    elif image_path.is_file():
        paths = [image_path]
    else:
        raise SystemExit(
            f"Image file not found: {image_path}. "
            f"Place an image at '{Path('example.jpg').resolve()}' or pass a path."
        )

    bundle = load_bundle(args)
    logits_fn, _ = make_fns(bundle)
    labels = load_imagenet_labels()
    topk = max(1, int(args.topk))

    # unreadable files are skipped with a warning instead of aborting
    x_np, paths = load_image_batch_tolerant(paths, size=bundle.input_size)
    x = torch.from_numpy(x_np).to(bundle.device)

    def probs_of(xx: torch.Tensor) -> np.ndarray:
        with torch.no_grad():
            return torch.softmax(logits_fn(xx), dim=-1).cpu().numpy()

    probs_clean = probs_of(x)
    pred_clean = probs_clean.argmax(axis=-1)

    x_adv = None
    if args.attack != "none":
        n = x.shape[0]
        if args.label is not None:
            y_true = torch.full((n,), int(args.label), dtype=torch.long, device=x.device)
        else:
            y_true = torch.from_numpy(pred_clean.astype(np.int64)).to(x.device)
        y_t = (torch.full((n,), int(args.target), dtype=torch.long, device=x.device)
               if args.target is not None else None)
        params = AttackParams(eps=args.eps, alpha=args.alpha, steps=args.steps)
        x_adv = run_attack(args.attack, logits_fn, x, y_true, params,
                           generator_from_seed(args.seed), y_target=y_t)
        probs_adv = probs_of(x_adv)

    vals_c, idx_c = topk_host(probs_clean, topk)
    if x_adv is not None:
        vals_a, idx_a = topk_host(probs_adv, topk)

    for i, path in enumerate(paths):
        print(f"Image: {path}")
        print_topk("Clean", vals_c[i], idx_c[i], labels)
        if x_adv is not None:
            print_topk(f"Adversarial ({args.attack})", vals_a[i], idx_a[i], labels)

    if x_adv is not None and args.save_adv:
        out_path = Path(args.save_adv)
        adv_np = x_adv.cpu().numpy()
        if len(paths) == 1:
            save_image_01(adv_np[0], out_path)
        else:
            # directory mode: one file per image under the given stem
            out_dir = out_path if out_path.suffix == "" else out_path.parent / out_path.stem
            for i, p in enumerate(paths):
                save_image_01(adv_np[i], Path(out_dir) / f"adv_{p.stem}.png")

    return 0


if __name__ == "__main__":
    sys.exit(main())
