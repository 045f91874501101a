"""Generalized transfer CLI (port of ``cli/transferability.py``, the
reference's ``transferability_attack.py`` surface).

    python -m image_recognition_adversarial_example_attack_tpu_torch.cli.transferability \\
        --image_dir imgs/ [--source_model resnet50 [densenet121]] \\
        [--target_models vgg19 densenet121 vit_b_16] [--device cpu]

Configurable source and target models and an eps sweep.  A transfer
succeeds, by default, when the target's adversarial label differs from the
SOURCE model's clean pseudo-label (``--convention source-label``), or from
the target's own clean label (``--convention blackbox``).  Several
``--source_model`` names attack their logit-fusion ensemble
(``attacks.api.make_ensemble_logits_fn``).  Prints the summary table, writes
``transfer_results.json`` and a heatmap per attack.

Each (attack, eps) cell draws from ``core.rng.cell_generator(seed, cell
id)``; the eps-independent attacks (cw, deepfool, ead, jsma, stadv,
spatial) are computed once per sweep and reused.  Image sets larger than
``--max_batch`` stream in chunks of that size
(``eval.streaming.stream_transfer_cell``).  Unknown models and models of
mixed input sizes are refused with exit code 2.  Every ``--attacks`` choice
of the JAX CLI runs, with its ``--square_steps`` and extended-attack flags.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch

from ..attacks.api import AttackParams, make_ensemble_logits_fn
from ..core.constants import (DEFAULT_ALPHA, DEFAULT_CW_C, DEFAULT_CW_KAPPA, DEFAULT_CW_LR,
                              DEFAULT_EPS_LIST)
from ..core.device import resolve_device
from ..core.images import load_image_batch, save_image_01
from ..core.rng import cell_generator
from ..eval.transfer import transfer_attack_batch
from .common import (ATTACK_CHOICES, EPS_INDEPENDENT_ATTACKS, add_extended_attack_args,
                     add_model_args, cell_rng_id, extended_attack_kwargs, load_bundle,
                     make_fns, maybe_profile, resolve_image_inputs)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Black-box Transferability Attack")
    parser.add_argument("--source_model", type=str, nargs="+", default=["resnet50"],
                        help="one zoo model, or several to attack their logit-fusion "
                             "ensemble; every model of a run shares one input size")
    parser.add_argument("--target_models", type=str, nargs="+",
                        default=["vgg19", "densenet121", "vit_b_16"],
                        help="zoo model names (models/zoo.py list_models)")
    parser.add_argument("--image_dir", type=str, default=None)
    parser.add_argument("--image", type=str, default="example.jpg")
    parser.add_argument("--attacks", type=str, nargs="+", default=["pgd"],
                        choices=ATTACK_CHOICES)
    parser.add_argument("--eps_list", type=float, nargs="+", default=list(DEFAULT_EPS_LIST))
    parser.add_argument("--alpha", type=float, default=DEFAULT_ALPHA)
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--cw_c", type=float, default=DEFAULT_CW_C)
    parser.add_argument("--cw_kappa", type=float, default=DEFAULT_CW_KAPPA)
    parser.add_argument("--cw_steps", type=int, default=100)
    parser.add_argument("--square_steps", type=int, default=1000,
                        help="query budget for the square attack")
    add_extended_attack_args(parser)
    parser.add_argument("--cw_lr", type=float, default=DEFAULT_CW_LR)
    parser.add_argument("--convention", type=str, default="source-label",
                        choices=["source-label", "blackbox"],
                        help="success reference: the SOURCE model's clean pseudo-label, or "
                             "each target's OWN clean label")
    parser.add_argument("--save_adv_images", action="store_true")
    parser.add_argument("--max_batch", type=int, default=256,
                        help="device batch cap: image sets larger than this stream in "
                             "chunks of this size at constant memory (0 = always one "
                             "resident batch)")
    parser.add_argument("--output_dir", type=str, default="./transfer_results")
    add_model_args(parser)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from ..models.zoo import list_models, model_meta

    names = list(args.source_model) + list(args.target_models)
    known = set(list_models())
    unknown = [nm for nm in names if nm not in known]
    if unknown:
        print(f"error: unknown model(s) {unknown}; registered: {sorted(known)}",
              file=sys.stderr)
        return 2
    # every model sees the same pixel batch, so all input sizes must agree
    sizes = {nm: int(model_meta(nm)["input_size"]) for nm in names}
    if len(set(sizes.values())) != 1:
        print(f"error: mixed input sizes {sizes}; transfer requires one common size per run",
              file=sys.stderr)
        return 2
    input_size = next(iter(sizes.values()))

    device = resolve_device(args.device)
    print(f"Using device: {device}"
          + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))

    image_paths = resolve_image_inputs(args.image_dir, args.image)
    if args.image_dir is not None:
        print(f"\n[3/4] Found {len(image_paths)} images in {args.image_dir}")
    else:
        print(f"\n[3/4] Using single image: {image_paths[0]}")

    src_names = list(args.source_model)
    print(f"\n[1/4] Loading source model(s): {src_names}")
    member_fns = [make_fns(load_bundle(args, name=nm))[0] for nm in src_names]
    if len(member_fns) > 1:
        print(f"  Attacking a logit-fusion ensemble of {len(member_fns)} sources")
        src_fn = make_ensemble_logits_fn(member_fns)
    else:
        src_fn = member_fns[0]

    print(f"\n[2/4] Loading target models: {args.target_models}")
    target_fns = {}
    for name in args.target_models:
        if name in src_names:
            print(f"  Skipping {name} (same as a source model)")
            continue
        target_fns[name] = make_fns(load_bundle(args, name=name))[0]

    output_dir = Path(args.output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)

    max_batch = int(args.max_batch)
    streaming = max_batch > 0 and len(image_paths) > max_batch
    if streaming:
        from ..eval.streaming import make_placer, stream_transfer_cell

        x = None
        n = len(image_paths)
        place = make_placer(device)
        print(f"\nStreaming evaluation: {n} images in fixed chunks of {max_batch} "
              "(constant memory)")
    else:
        x = torch.from_numpy(load_image_batch(image_paths, size=input_size)).to(device)
        n = x.shape[0]

    print("\n[4/4] Running transfer attack experiments...")
    print("=" * 80)

    base = AttackParams(alpha=float(args.alpha), steps=int(args.steps), cw_c=float(args.cw_c),
                        cw_kappa=float(args.cw_kappa), cw_steps=int(args.cw_steps),
                        cw_lr=float(args.cw_lr), square_steps=int(args.square_steps),
                        **extended_attack_kwargs(args))

    def cell_fn(xx: torch.Tensor, generator: torch.Generator, eps: float, attack_name: str):
        return transfer_attack_batch(src_fn, target_fns, xx, attack_name,
                                     dataclasses.replace(base, eps=float(eps)), generator,
                                     convention=args.convention)

    # all_results[attack][eps] = {"source_success": [..], "transfer_success": {model: [..]}}
    all_results: dict = {}
    # the attacks that read no eps: one cell per sweep, reused for every eps
    eps_independent_cache: dict = {}
    with maybe_profile(args.profile_dir):
        for attack_name in args.attacks:
            all_results[attack_name] = {}
            for eps in args.eps_list:
                print(f"  Running {attack_name.upper()} with eps={eps:.5f} on a batch of {n}...")
                if attack_name in eps_independent_cache:
                    print(f"    ({attack_name} is eps-independent: reusing the computed cell)")
                    all_results[attack_name][float(eps)] = eps_independent_cache[attack_name]
                    continue
                cell_id = cell_rng_id(attack_name, float(eps))
                adv_dir = output_dir / f"{attack_name}_eps_{eps:.5f}"
                if streaming:
                    def save_chunk(adv_np, kept_paths, _dir=adv_dir):
                        for img, p in zip(adv_np, kept_paths):
                            save_image_01(img, _dir / f"adv_{Path(p).stem}.png")

                    cell_record = stream_transfer_cell(
                        lambda xx, g, e, a=attack_name: cell_fn(xx, g, e, a), image_paths,
                        seed=args.seed, cell_id=cell_id, eps=float(eps),
                        target_names=list(target_fns), chunk_size=max_batch, place=place,
                        size=input_size, save_adv=save_chunk if args.save_adv_images else None)
                else:
                    cell = cell_fn(x, cell_generator(args.seed, cell_id), eps, attack_name)
                    cell_record = {
                        "source_success": cell.source_success.cpu().tolist(),
                        "transfer_success": {nm: v.cpu().tolist()
                                             for nm, v in cell.target_success.items()},
                    }
                    if args.save_adv_images:
                        adv_np = cell.x_adv.cpu().numpy()
                        for i, p in enumerate(image_paths):
                            save_image_01(adv_np[i], adv_dir / f"adv_{p.stem}.png")
                all_results[attack_name][float(eps)] = cell_record
                if attack_name in EPS_INDEPENDENT_ATTACKS:
                    eps_independent_cache[attack_name] = cell_record
                print(f"    Source model ASR: {np.mean(cell_record['source_success']):.3f}")
                for name, v in cell_record["transfer_success"].items():
                    print(f"    Transfer to {name}: {np.mean(v):.3f}")

    # the summary table, the reference's layout
    print("\n" + "=" * 80)
    print("TRANSFERABILITY SUMMARY")
    print("=" * 80)
    header = f"{'Attack':<10} {'Eps':<10} {'Source':<10}"
    for name in target_fns:
        header += f" {name:<15}"
    print(header)
    print("-" * len(header))
    for attack_name in args.attacks:
        for eps in args.eps_list:
            cell = all_results[attack_name][float(eps)]
            row = f"{attack_name:<10} {eps:<10.5f} {float(np.mean(cell['source_success'])):<10.3f}"
            for name in target_fns:
                row += f" {float(np.mean(cell['transfer_success'][name])):<15.3f}"
            print(row)

    results_file = output_dir / "transfer_results.json"
    results_file.write_text(json.dumps(all_results, indent=2))
    print(f"\nDetailed results saved to: {results_file}")

    # a heatmap per attack: eps rows x target columns
    from ..viz.plots import plot_transfer_heatmap

    model_names = list(target_fns)
    if model_names:
        for attack_name in args.attacks:
            matrix = np.asarray([[float(np.mean(all_results[attack_name][float(e)]
                                                ["transfer_success"][nm]))
                                  for nm in model_names] for e in args.eps_list])
            plot_path = output_dir / f"transfer_heatmap_{attack_name}.png"
            plot_transfer_heatmap(matrix, args.eps_list, model_names, "+".join(src_names),
                                  attack_name, plot_path)
            print(f"Transferability heatmap saved: {plot_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
