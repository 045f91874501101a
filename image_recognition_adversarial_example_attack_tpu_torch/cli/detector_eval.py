"""Detector-comparison CLI: ROC analysis across the detector families (port
of ``cli/detector_eval.py``).

    python -m image_recognition_adversarial_example_attack_tpu_torch.cli.detector_eval \\
        --image_dir picture/ --attacks fgsm pgd cw --eps 0.03137 \\
        --detectors feature squeezing mahalanobis [--device cpu]

Each attack crafts its adversarial batch once, from
``core.rng.cell_generator(seed, cell_rng_id(attack, eps))``; every selected
detector scores clean and adversarial in one stacked [2B] call
(``eval.detector_eval.evaluate_detector_cell``).  Each detector is
calibrated once on the clean batch: the feature detector through
``threshold_from_scores`` (its rails included), squeezing by the plain
linear quantile, Mahalanobis through ``calibrate_mahalanobis``.  Prints the
threshold-free AUC and two operating points per cell, the ``DETECTOR
COMPARISON`` table, and with ``--output_json`` the rows as JSON.

Image sets larger than ``--max_batch`` stream in chunks of that size: the
clean scores of the whole set set the thresholds, the Mahalanobis Gaussians
are fitted on the first decodable chunk, and chunk ``step`` of an attack
draws from ``chunk_generator(seed, that cell id, step)``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch

from ..attacks.api import AttackParams, predict_labels, run_attack
from ..core.device import resolve_device
from ..core.images import load_image_batch_tolerant
from ..core.rng import cell_generator
from ..defenses.detector import feature_score, squeezing_score, threshold_from_scores
from ..defenses.mahalanobis import calibrate_mahalanobis, mahalanobis_score
from ..eval.detector_eval import cell_from_scores, evaluate_detector_cell, summary_table
from .common import (add_extended_attack_args, add_model_args, cell_rng_id,
                     extended_attack_kwargs, load_bundle, make_fns, maybe_profile, n_classes_of,
                     resolve_image_inputs)

DETECTOR_CHOICES = ["feature", "squeezing", "mahalanobis"]
# the JAX CLI's --attacks choices, in its order
ATTACK_CHOICES = ["fgsm", "pgd", "pgd_l2", "cw", "mifgsm", "dim", "tim", "apgd", "square",
                  "deepfool", "nes", "spsa", "hsja", "ead", "apgd_dlr", "apgd_t", "fab", "stadv",
                  "boundary", "simba", "jsma", "pgd_l1", "spatial"]


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="ROC comparison of adversarial detectors")
    parser.add_argument("--image_dir", type=str, default=None)
    parser.add_argument("--image", type=str, default="example.jpg")
    parser.add_argument("--attacks", type=str, nargs="+",
                        default=["fgsm", "pgd", "cw"], choices=ATTACK_CHOICES)
    parser.add_argument("--eps", type=float, default=0.03137)
    parser.add_argument("--alpha", type=float, default=0.00784)
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--cw_c", type=float, default=1.0)
    parser.add_argument("--cw_kappa", type=float, default=0.0)
    parser.add_argument("--cw_steps", type=int, default=100)
    parser.add_argument("--cw_lr", type=float, default=0.01)
    parser.add_argument("--square_steps", type=int, default=1000)
    add_extended_attack_args(parser)
    parser.add_argument("--detectors", type=str, nargs="+",
                        default=list(DETECTOR_CHOICES), choices=DETECTOR_CHOICES)
    parser.add_argument("--quantile", type=float, default=0.95,
                        help="clean-score quantile for the calibrated "
                             "operating point")
    parser.add_argument("--max_batch", type=int, default=256,
                        help="image sets larger than this STREAM fixed-"
                             "shape chunks through the same compiled "
                             "attack/score programs at constant memory "
                             "(0 = always one resident batch)")
    parser.add_argument("--output_json", type=str, default=None)
    add_model_args(parser)
    return parser


def _attack_params(args) -> AttackParams:
    return AttackParams(
        eps=float(args.eps), alpha=float(args.alpha), steps=int(args.steps),
        cw_c=float(args.cw_c), cw_kappa=float(args.cw_kappa),
        cw_steps=int(args.cw_steps), cw_lr=float(args.cw_lr),
        square_steps=int(args.square_steps), **extended_attack_kwargs(args))


def _score_fns(args, bundle, logits_fn, features_fn, x_cal, y_cal):
    """The selected detectors' score functions, and the Mahalanobis
    detector's clean threshold (None without it).  Its Gaussians are fitted
    on the calibration batch ``(x_cal, y_cal)``; the other scores have no
    parameters."""
    score_fns: dict = {}
    maha_thr = None
    for det in args.detectors:
        if det == "feature":
            score_fns[det] = lambda xx: feature_score(features_fn, xx)
        elif det == "squeezing":
            score_fns[det] = lambda xx: squeezing_score(logits_fn, xx)
        else:
            params, maha_thr = calibrate_mahalanobis(
                features_fn, x_cal, y_cal, n_classes_of(bundle.model),
                n=x_cal.shape[0], quantile=args.quantile)
            score_fns[det] = lambda xx, _p=params: mahalanobis_score(features_fn, xx, _p)
    return score_fns, maha_thr


def _report(args, results) -> None:
    print("\n" + "=" * 62)
    print("DETECTOR COMPARISON")
    print("=" * 62)
    print(summary_table(results))
    if args.output_json:
        out = Path(args.output_json)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps([dataclasses.asdict(r) for r in results], indent=2))
        print(f"\nWrote {out}")


def _print_cell(r) -> None:
    print(f"  {r.detector}: AUC={r.auc:.3f} "
          f"TPR@thr={r.tpr_at_threshold:.3f} "
          f"TPR@5%FPR={r.tpr_at_fpr05:.3f}")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    image_paths = resolve_image_inputs(args.image_dir, args.image)
    print(f"Evaluating detectors on {len(image_paths)} images")
    device = resolve_device(args.device)
    print(f"Using device: {device}"
          + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))

    bundle = load_bundle(args)
    logits_fn, features_fn = make_fns(bundle)

    max_batch = int(args.max_batch)
    if max_batch > 0 and len(image_paths) > max_batch:
        return _main_streamed(args, image_paths, bundle, logits_fn, features_fn, device)

    x_np, image_paths = load_image_batch_tolerant(image_paths, size=bundle.input_size)
    x = torch.from_numpy(x_np).to(device)
    y = predict_labels(logits_fn, x)

    # --- calibrate every detector ONCE on the clean batch ---
    score_fns, maha_thr = _score_fns(args, bundle, logits_fn, features_fn, x, y)
    thresholds: dict = {}
    for det in args.detectors:
        if det == "mahalanobis":
            thresholds[det] = maha_thr
        else:
            with torch.no_grad():
                scores = score_fns[det](x)
            thresholds[det] = (threshold_from_scores(scores, args.quantile) if det == "feature"
                               else float(torch.quantile(scores, args.quantile)))
        print(f"  {det}: threshold={thresholds[det]:.4f} (q={args.quantile})")

    base_params = _attack_params(args)
    results = []
    with maybe_profile(args.profile_dir):
        for attack_name in args.attacks:
            print(f"\nCrafting {attack_name.upper()} (eps={args.eps:.5f})...")
            g = cell_generator(args.seed, cell_rng_id(attack_name, float(args.eps)))
            x_adv = run_attack(attack_name, logits_fn, x, y, base_params, generator=g)
            asr = float((predict_labels(logits_fn, x_adv) != y).float().mean())
            print(f"  attack success rate: {asr:.3f}")
            for det in args.detectors:
                r = evaluate_detector_cell(score_fns[det], x, x_adv, thresholds[det],
                                           detector=det, attack=attack_name)
                results.append(r)
                _print_cell(r)
    _report(args, results)
    return 0


def _main_streamed(args, image_paths, bundle, logits_fn, features_fn, device) -> int:
    """The detector comparison over more images than ``--max_batch``, at
    constant memory.

    A clean pass scores every image for every detector (the thresholds are
    quantiles over the whole set, as in the one-batch path); then each
    attack crafts and scores chunk by chunk
    (``eval.streaming.stream_detector_scores``), and the ROC arithmetic runs
    on the concatenated vectors.  The Mahalanobis Gaussians are fitted on
    the first decodable chunk, its calibration set; that chunk is decoded
    once, scored padded to the chunk shape, and the clean pass covers only
    the paths after it."""
    from ..eval.streaming import make_placer, stream_clean_scores, stream_detector_scores

    chunk = int(args.max_batch)
    print(f"({len(image_paths)} images exceed --max_batch {chunk}: "
          f"STREAMING fixed chunks at constant memory)")
    place = make_placer(device)

    def pseudo_fn(xx):
        return predict_labels(logits_fn, xx)

    # the calibration set: the first chunk with a decodable image
    # (load_image_batch_tolerant raises ValueError on an all-unreadable one)
    x_cal_np, cal_end = None, 0
    for off in range(0, len(image_paths), chunk):
        try:
            x_cal_np, _ = load_image_batch_tolerant(image_paths[off:off + chunk],
                                                    size=bundle.input_size)
            cal_end = off + chunk
            break
        except ValueError:
            continue
    if x_cal_np is None:
        raise SystemExit("no loadable images")
    n0 = x_cal_np.shape[0]
    x_cal = torch.from_numpy(x_cal_np).to(device)
    score_fns, _ = _score_fns(args, bundle, logits_fn, features_fn, x_cal, pseudo_fn(x_cal))

    pad = chunk - n0
    x0 = torch.cat([x_cal, x_cal.new_zeros((pad, *x_cal.shape[1:]))]) if pad else x_cal
    with torch.no_grad():
        host = torch.stack([fn(x0).to(torch.float64) for fn in score_fns.values()])
    host = host.cpu().numpy()[:, :n0]
    clean0 = {det: host[i] for i, det in enumerate(score_fns)}
    empty = {det: np.empty(0, np.float64) for det in score_fns}
    rest_paths = image_paths[cal_end:]
    if rest_paths:
        try:
            rest = stream_clean_scores(score_fns, rest_paths, chunk_size=chunk, place=place,
                                       size=bundle.input_size)
        except SystemExit:
            rest = empty  # every remaining file unreadable
    else:
        rest = empty  # the calibration chunk was the last chunk
    clean = {det: np.concatenate([clean0[det], rest[det]]) for det in score_fns}
    thresholds: dict = {}
    for det in args.detectors:
        if det == "feature":
            # float32, as the JAX CLI's jnp.asarray of the scores
            thresholds[det] = threshold_from_scores(
                torch.from_numpy(clean[det]).to(torch.float32), args.quantile)
        else:
            thresholds[det] = float(np.quantile(clean[det], args.quantile))
        print(f"  {det}: threshold={thresholds[det]:.4f} "
              f"(q={args.quantile}, calibrated on all "
              f"{clean[det].shape[0]} clean scores)")

    base_params = _attack_params(args)
    results = []
    clean_preds: dict = {}  # per-chunk clean predictions, shared by attacks
    with maybe_profile(args.profile_dir):
        for attack_name in args.attacks:
            print(f"\nCrafting {attack_name.upper()} (eps={args.eps:.5f}, streamed)...")

            def atk(xx, yy, g, a=attack_name):
                return run_attack(a, logits_fn, xx, yy, base_params, generator=g)

            got = stream_detector_scores(
                atk, score_fns, pseudo_fn, image_paths, seed=args.seed,
                cell_id=cell_rng_id(attack_name, float(args.eps)), chunk_size=chunk,
                place=place, size=bundle.input_size, clean_cache=clean_preds)
            asr = float(np.mean(got["succ"]))
            print(f"  attack success rate: {asr:.3f} ({got['count']} images)")
            for det in args.detectors:
                r = cell_from_scores(clean[det], got["adv"][det], thresholds[det],
                                     detector=det, attack=attack_name)
                results.append(r)
                _print_cell(r)
    _report(args, results)
    return 0


if __name__ == "__main__":
    sys.exit(main())
