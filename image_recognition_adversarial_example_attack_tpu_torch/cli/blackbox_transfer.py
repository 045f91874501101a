"""Fixed-trio black-box transfer CLI (port of ``cli/blackbox_transfer.py``, the
reference's ``blackbox_transfer.py`` surface).

    python -m image_recognition_adversarial_example_attack_tpu_torch.cli.blackbox_transfer \\
        --image_dir picture/ [--attacks fgsm pgd cw] [--device cpu]

A ResNet-50 source and VGG19, ViT-B/16 and Swin-T targets by default; a
transfer succeeds when the target's label of the adversarial image differs
from the target's OWN clean label.  Prints the reference's tab-separated ASR
table and writes a clean/adversarial panel per image and attack for the
first ``--visualize_n`` images under ``<image_dir>/blackbox_vis`` (or
``./blackbox_vis`` where the image directory is read-only).

Image sets larger than ``--max_batch`` stream in chunks of that size
(``utils.pipeline.EvalBatchPipeline``); each chunk's attack draws from
``core.rng.chunk_generator(seed, attack, step)``, the resident run's from
``core.rng.cell_generator(seed, attack)``.  Every ``--attacks`` choice of
the JAX CLI runs, the black-box attacks on the source model included, with
its ``--square_steps`` and extended-attack flags.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

import numpy as np
import torch

from ..attacks.api import AttackParams, predict_labels, run_attack
from ..core.constants import (DEFAULT_ALPHA, DEFAULT_CW_C, DEFAULT_CW_KAPPA, DEFAULT_CW_LR,
                              DEFAULT_EPS, DEFAULT_STEPS)
from ..core.device import resolve_device
from ..core.images import list_images, load_image_batch
from ..core.labels import load_imagenet_labels
from ..core.rng import cell_generator, chunk_generator
from .common import (ATTACK_CHOICES, add_extended_attack_args, add_model_args,
                     extended_attack_kwargs, load_bundle, make_fns, maybe_profile)

TARGET_DISPLAY = {"vgg19": "VGG19", "vit_b_16": "ViT", "swin_t": "Swin"}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Black-box transfer sweep: ResNet-50 -> VGG19/ViT/Swin")
    parser.add_argument("--image_dir", type=str, default="picture")
    parser.add_argument("--attacks", type=str, nargs="+", default=["fgsm", "pgd", "cw"],
                        choices=ATTACK_CHOICES)
    parser.add_argument("--eps", type=float, default=DEFAULT_EPS)
    parser.add_argument("--alpha", type=float, default=DEFAULT_ALPHA)
    parser.add_argument("--steps", type=int, default=DEFAULT_STEPS)
    parser.add_argument("--cw_c", type=float, default=DEFAULT_CW_C)
    parser.add_argument("--cw_kappa", type=float, default=DEFAULT_CW_KAPPA)
    parser.add_argument("--cw_steps", type=int, default=200)
    parser.add_argument("--square_steps", type=int, default=1000,
                        help="query budget for the square attack")
    add_extended_attack_args(parser)
    parser.add_argument("--cw_lr", type=float, default=DEFAULT_CW_LR)
    parser.add_argument("--visualize_n", type=int, default=3)
    parser.add_argument("--max_batch", type=int, default=256,
                        help="device batch cap: image sets larger than this stream in "
                             "chunks of this size at constant memory (0 = always one "
                             "resident batch)")
    parser.add_argument("--source", type=str, default="resnet50",
                        help="source (white-box) model")
    parser.add_argument("--targets", type=str, nargs="+",
                        default=["vgg19", "vit_b_16", "swin_t"],
                        help="target (black-box) models")
    add_model_args(parser)
    return parser


def _vis_dir(image_dir: Path) -> Path:
    """``<image_dir>/blackbox_vis``, or ``./blackbox_vis`` where the image
    directory cannot be written."""
    out_dir = image_dir / "blackbox_vis"
    try:
        out_dir.mkdir(parents=True, exist_ok=True)
        if os.access(out_dir, os.W_OK):
            return out_dir
    except OSError:
        pass
    out_dir = Path("blackbox_vis")
    out_dir.mkdir(parents=True, exist_ok=True)
    return out_dir


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    image_dir = Path(args.image_dir)
    if not image_dir.is_dir():
        raise SystemExit(f"image_dir not found: {image_dir}")
    paths = list_images(image_dir)
    if not paths:
        raise SystemExit(f"no images found in {image_dir}")

    device = resolve_device(args.device)
    print(f"Using device: {device}"
          + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))
    src_bundle = load_bundle(args, name=args.source)
    src_fn = make_fns(src_bundle)[0]
    target_fns = {name: make_fns(load_bundle(args, name=name))[0] for name in args.targets}
    labels = load_imagenet_labels()
    params = AttackParams(eps=args.eps, alpha=args.alpha, steps=args.steps, cw_c=args.cw_c,
                          cw_kappa=args.cw_kappa, cw_steps=args.cw_steps, cw_lr=args.cw_lr,
                          square_steps=int(args.square_steps), **extended_attack_kwargs(args))

    max_batch = int(args.max_batch)
    n_viz = min(int(args.visualize_n), len(paths))
    # counts[attack][target]: images whose target label the attack flipped
    counts = {a: {nm: 0 for nm in target_fns} for a in args.attacks}
    # the first n_viz images: clean batch, labels, and each attack's x_adv, labels
    x_head = y_src_head = None
    y_clean_head: dict[str, np.ndarray] = {}
    adv_head: dict[str, np.ndarray] = {}
    y_adv_head: dict[str, dict[str, np.ndarray]] = {a: {} for a in args.attacks}
    total = 0
    if max_batch > 0 and len(paths) > max_batch:
        from ..eval.streaming import make_placer
        from ..utils.pipeline import EvalBatchPipeline

        print(f"Streaming evaluation: {len(paths)} images in fixed chunks of {max_batch} "
              "(constant memory)")
        chunks = EvalBatchPipeline(paths, max_batch)
        place = make_placer(device)
    else:
        chunks = [(0, load_image_batch(paths), None, len(paths))]
        place = None
    with maybe_profile(args.profile_dir):
        for step, x_np, _, n_valid in chunks:
            x = place(x_np) if place is not None else torch.from_numpy(x_np).to(device)
            ys = predict_labels(src_fn, x)
            yc = {nm: predict_labels(fn, x) for nm, fn in target_fns.items()}
            for attack_name in args.attacks:
                gen = (chunk_generator(args.seed, attack_name, step) if place is not None
                       else cell_generator(args.seed, attack_name))
                x_adv = run_attack(attack_name, src_fn, x, ys, params, gen)
                flips = torch.stack([predict_labels(fn, x_adv) != yc[nm]
                                     for nm, fn in target_fns.items()])[:, :n_valid]
                for nm, c in zip(target_fns, flips.sum(dim=1).tolist()):
                    counts[attack_name][nm] += int(c)
                if step == 0 and n_viz:
                    adv_head[attack_name] = x_adv[:n_viz].cpu().numpy()
                    for nm, fn in target_fns.items():
                        y_adv_head[attack_name][nm] = (
                            predict_labels(fn, x_adv[:n_viz]).cpu().numpy())
            if step == 0:
                x_head = np.asarray(x_np[:n_viz])
                y_src_head = ys[:n_viz].cpu().numpy()
                y_clean_head = {nm: v[:n_viz].cpu().numpy() for nm, v in yc.items()}
            total += int(n_valid)
    if total == 0:  # every chunk dropped: nothing decoded
        raise SystemExit("no loadable images")

    if n_viz > 0:
        from ..viz.plots import plot_blackbox_pair

        out_dir = _vis_dir(image_dir)

        def lbl(idx: int) -> str:
            return labels[idx] if 0 <= idx < len(labels) else str(idx)

        for i in range(n_viz):
            for attack_name in args.attacks:
                clean_text = f"{args.source}: {lbl(int(y_src_head[i]))}\n" + "\n".join(
                    f"{TARGET_DISPLAY.get(nm, nm)}: {lbl(int(y_clean_head[nm][i]))}"
                    for nm in target_fns)
                adv_text = "\n".join(
                    f"{TARGET_DISPLAY.get(nm, nm)}: {lbl(int(y_adv_head[attack_name][nm][i]))}"
                    for nm in target_fns)
                plot_blackbox_pair(x_head[i], adv_head[attack_name][i], clean_text, adv_text,
                                   title=f"{paths[i].name} ({attack_name})",
                                   attack_name=attack_name,
                                   out_path=out_dir / f"{paths[i].stem}_{attack_name}.png")

    # the tab-separated ASR table, the reference's layout
    print("\t".join(["Attack/Model"] + [TARGET_DISPLAY.get(nm, nm) for nm in args.targets]))
    for attack_name in args.attacks:
        row = [attack_name.upper()]
        for nm in args.targets:
            asr = 100.0 * counts[attack_name][nm] / total if total else 0.0
            row.append(f"{asr:.1f}%")
        print("\t".join(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
