"""Zoo-wide attack comparison (port of ``cli/attack_suite.py``): many attacks
on one batch, one table.

    python -m image_recognition_adversarial_example_attack_tpu_torch.cli.attack_suite \\
        --image_dir picture/ --attacks fgsm pgd cw deepfool jsma --eps 0.03137 [--device cpu]

Per attack: the success rate, the two wall times and the distortion profile
(L∞, mean L2, the share of changed features, SSIM, PSNR) and the ECE of the
adversarial predictions, as the JAX CLI's table and JSON (``--output``).
Each attack runs twice on the batch, its generator seeded from the same cell
id (``core.rng.cell_generator(seed, attack)``) before each call:
``compile_run_s`` is the first call, ``steady_s`` the second (host clock,
ending in a synchronisation of the card), and the two outputs must be
bit-equal.  So the run asks cuDNN for deterministic algorithms: on the card
a float32 input gradient otherwise differs between two calls in its last
bits, and FGSM's sign of a near-zero component flips.  Image sets larger
than ``--max_batch`` stream in chunks of that size
(``eval.streaming.stream_suite_attack``): the first chunk's time, then the
mean of the others.

``--attacks all`` expands to the JAX CLI's whole zoo (``ALL_ATTACKS``), the
25 names of ``run_attack``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..attacks.api import AttackParams, predict_labels, run_attack
from ..core.constants import DEFAULT_ALPHA, DEFAULT_EPS, DEFAULT_STEPS
from ..core.device import resolve_device, synchronize
from ..core.images import load_image_batch_tolerant
from ..core.rng import cell_generator
from ..eval.metrics import (ece_from_conf_correct, expected_calibration_error, psnr, ssim,
                            ssim_per_sample)
from .common import (add_extended_attack_args, add_imagenet_val_arg, add_model_args,
                     check_label_range, extended_attack_kwargs, load_bundle, make_fns,
                     maybe_profile, n_classes_of, resolve_eval_inputs,
                     resolve_labels, resolve_labels_sentinel)

ALL_ATTACKS = ("fgsm", "pgd", "pgd_l2", "mifgsm", "dim", "tim", "apgd",
               "apgd_dlr", "apgd_t", "fab", "square", "square_l2",
               "deepfool", "cw", "ead", "nes", "spsa", "bandits", "hsja", "boundary",
               "simba", "stadv", "jsma", "pgd_l1", "spatial")

HEADER = (f"{'attack':<10} {'ASR':>6} {'L∞':>8} {'L2(mean)':>9} "
          f"{'chg%':>6} {'SSIM':>6} {'PSNR':>6} {'ECE':>6} "
          f"{'compile+run':>12} {'steady':>8}")
PSEUDO_NOTE = ("NOTE: labels are the model's own pseudo-labels, so 'ECE' "
               "degenerates to a confidence-deficit (clean accuracy is 1.0 "
               "by construction) — pass --labels_json for true calibration")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Run many attacks on one batch; compare ASR + distortion")
    parser.add_argument("--image_dir", type=str, default=None)
    parser.add_argument("--image", type=str, default="example.jpg")
    parser.add_argument("--attacks", type=str, nargs="+",
                        default=["fgsm", "pgd", "cw"],
                        choices=list(ALL_ATTACKS) + ["all"],
                        help="'all' expands to the full zoo")
    parser.add_argument("--eps", type=float, default=DEFAULT_EPS)
    parser.add_argument("--alpha", type=float, default=DEFAULT_ALPHA)
    parser.add_argument("--steps", type=int, default=DEFAULT_STEPS)
    parser.add_argument("--cw_c", type=float, default=1.0)
    parser.add_argument("--cw_kappa", type=float, default=0.0)
    parser.add_argument("--cw_steps", type=int, default=100)
    parser.add_argument("--cw_lr", type=float, default=0.01)
    parser.add_argument("--square_steps", type=int, default=1000)
    parser.add_argument("--n_target_classes", type=int, default=9)
    add_extended_attack_args(parser)
    parser.add_argument("--labels_json", type=str, default=None,
                        help="ground-truth labels (default: pseudo-labels)")
    parser.add_argument("--max_batch", type=int, default=256,
                        help="image sets larger than this STREAM fixed-"
                             "shape chunks through the same attacks at "
                             "constant memory (0 = always one resident batch)")
    parser.add_argument("--output", type=str, default="attack_suite.json")
    add_imagenet_val_arg(parser)
    add_model_args(parser)
    return parser


def _suite_params(args) -> AttackParams:
    return AttackParams(
        eps=float(args.eps), alpha=float(args.alpha), steps=int(args.steps),
        cw_c=float(args.cw_c), cw_kappa=float(args.cw_kappa),
        cw_steps=int(args.cw_steps), cw_lr=float(args.cw_lr),
        square_steps=int(args.square_steps),
        n_target_classes=int(args.n_target_classes),
        **extended_attack_kwargs(args),
    )


def _row_line(name: str, m: dict, compile_run_s: float, steady_txt: str) -> str:
    return (f"{name:<10} {m['asr']:>6.3f} {m['linf']:>8.4f} "
            f"{m['l2_mean']:>9.3f} {m['changed_pct']:>6.2f} "
            f"{m['ssim']:>6.3f} {m['psnr']:>6.1f} {m['ece']:>6.3f} "
            f"{compile_run_s:>10.1f}s {steady_txt}")


@contextlib.contextmanager
def _deterministic_cudnn():
    """cuDNN's deterministic algorithms for the block, the setting restored
    after it."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    attacks = list(ALL_ATTACKS) if "all" in args.attacks else args.attacks

    paths = resolve_eval_inputs(args)
    with _deterministic_cudnn():
        return _suite(args, attacks, paths)


def _suite(args, attacks, paths) -> int:
    device = resolve_device(args.device)
    print(f"Using device: {device}"
          + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))
    bundle = load_bundle(args)
    logits_fn, _ = make_fns(bundle)

    max_batch = int(args.max_batch)
    if max_batch > 0 and len(paths) > max_batch:
        return _main_streamed(args, attacks, paths, bundle, logits_fn, device)

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
    params = _suite_params(args)

    @torch.no_grad()
    def distortion(x_adv):
        diff = x_adv - x
        flat = diff.reshape(n, -1)
        logits_adv = logits_fn(x_adv)
        succ = torch.argmax(logits_adv, dim=-1) != y
        return {
            "asr": torch.mean(succ.to(torch.float32)),
            "linf": torch.amax(torch.abs(diff)),
            "l2_mean": torch.mean(torch.sqrt(torch.sum(torch.square(flat), dim=-1))),
            "changed_pct": torch.mean((torch.abs(flat) > 1.0 / 255.0).to(torch.float32))
            * 100.0,
            "ssim": ssim(x, x_adv),
            "psnr": psnr(x, x_adv),
            # adversarial examples also make the survivors over-confident:
            # ECE against the labels of the ASR (the clean one in the preamble)
            "ece": expected_calibration_error(torch.softmax(logits_adv, dim=-1), y),
        }

    with torch.no_grad():
        ece_clean = float(expected_calibration_error(torch.softmax(logits_fn(x), dim=-1), y))

    print(f"\n{n} images; eps={float(args.eps):.5f}; per attack: one run timed twice "
          f"from the same generator (first call, then steady); clean ECE {ece_clean:.3f}")
    if not args.labels_json:
        print(PSEUDO_NOTE)
    print(HEADER)
    print("-" * len(HEADER))
    rows = []
    with maybe_profile(args.profile_dir):
        for name in attacks:
            times, outs = [], []
            for _ in range(2):
                synchronize(device)
                t0 = time.perf_counter()
                outs.append(run_attack(name, logits_fn, x, y, params,
                                       cell_generator(args.seed, name)))
                synchronize(device)
                times.append(time.perf_counter() - t0)
            if not torch.equal(outs[0], outs[1]):
                raise RuntimeError(
                    f"{name}: two runs from the same generator differ (max |diff| "
                    f"{float((outs[0] - outs[1]).abs().max()):.3e})")
            m = {k: float(v) for k, v in distortion(outs[1]).items()}
            row = {"attack": name, **m, "compile_run_s": round(times[0], 2),
                   "steady_s": round(times[1], 4)}
            rows.append(row)
            print(_row_line(name, m, row["compile_run_s"], f"{row['steady_s']:>7.3f}s"))

    out = Path(args.output)
    out.write_text(json.dumps({
        "count": n,
        "eps": float(args.eps),
        "model": args.model,
        "labels": "ground-truth" if args.labels_json else "pseudo",
        "ece_clean": ece_clean,
        "results": rows,
    }, indent=2))
    print(f"\nWrote {out}")
    return 0


def _main_streamed(args, attacks, paths, bundle, logits_fn, device) -> int:
    """The table over any number of images: fixed-shape chunks through the
    same attacks (``eval.streaming.stream_suite_attack``).  Every column is a
    per-sample vector or a sum, so the streamed values are the one-batch
    path's up to the order of float sums (the counters exactly)."""
    from ..eval.streaming import make_placer, stream_suite_attack

    n = len(paths)
    size = bundle.input_size
    chunk = int(args.max_batch)
    labels_sent = resolve_labels_sentinel(args.labels_json, paths)
    if labels_sent is not None:
        check_label_range(labels_sent, n_classes_of(bundle.model))
    params = _suite_params(args)

    def clean_fn(xx):
        probs = torch.softmax(logits_fn(xx), dim=-1)
        return torch.argmax(probs, dim=-1), torch.amax(probs, dim=-1)

    def metrics_fn(xc, xa, yy):
        flat = (xa - xc).reshape(xa.shape[0], -1)
        probs = torch.softmax(logits_fn(xa), dim=-1)
        return {
            "succ": torch.argmax(probs, dim=-1) != yy,
            "linf": torch.amax(torch.abs(flat), dim=-1),
            "l2": torch.sqrt(torch.sum(torch.square(flat), dim=-1)),
            "changed": torch.mean((torch.abs(flat) > 1.0 / 255.0).to(torch.float32), dim=-1),
            "ssim": ssim_per_sample(xc, xa),
            "sq_sum": torch.sum(torch.square(flat), dim=-1),
            "conf": torch.amax(probs, dim=-1),
        }

    print(f"\n{n} images STREAMED in fixed chunks of {chunk} (constant "
          f"memory); eps={float(args.eps):.5f}; per attack: compile+run = the "
          f"first chunk; steady = the mean of the later chunks")
    if not args.labels_json:
        print(PSEUDO_NOTE)
    print(HEADER)
    print("-" * len(HEADER))
    rows = []
    ece_clean = None
    clean_cache: dict = {}
    place = make_placer(device)
    with maybe_profile(args.profile_dir):
        for name in attacks:
            res = stream_suite_attack(
                lambda xx, yy, g, _name=name: run_attack(_name, logits_fn, xx, yy, params, g),
                metrics_fn, clean_fn, paths, seed=args.seed, cell_id=name, chunk_size=chunk,
                place=place, size=size, labels=labels_sent, clean_cache=clean_cache)
            if ece_clean is None:
                ece_clean = float(ece_from_conf_correct(torch.from_numpy(res["clean_conf"]),
                                                        torch.from_numpy(res["clean_correct"])))
            mse = float(np.sum(res["sq_sum"], dtype=np.float64)) / (res["count"] * size * size * 3)
            m = {
                "asr": float(np.mean(res["succ"])),
                "linf": float(np.max(res["linf"])),
                "l2_mean": float(np.mean(res["l2"])),
                "changed_pct": float(np.mean(res["changed"])) * 100.0,
                "ssim": float(np.mean(res["ssim"])),
                "psnr": 100.0 if mse <= 1e-10 else -10.0 * math.log10(mse),
                "ece": float(ece_from_conf_correct(
                    torch.from_numpy(res["conf"]),
                    torch.from_numpy((~res["succ"]).astype(np.float32)))),
            }
            steady = res["steady_s"]  # None when only one chunk was read
            row = {"attack": name, **m,
                   "compile_run_s": round(res["compile_run_s"], 2),
                   "steady_s": None if steady is None else round(steady, 4)}
            rows.append(row)
            print(_row_line(name, m, row["compile_run_s"],
                            "      —" if steady is None else f"{steady:>7.3f}s"))
    print(f"clean ECE {ece_clean:.3f}")

    out = Path(args.output)
    out.write_text(json.dumps({
        # the evaluated count (unreadable files are dropped), as the
        # one-batch path's
        "count": int(res["count"]),
        "requested": n,
        "eps": float(args.eps),
        "model": args.model,
        "labels": "ground-truth" if args.labels_json else "pseudo",
        "ece_clean": ece_clean,
        "streamed": True,
        "max_batch": chunk,
        "results": rows,
    }, indent=2))
    print(f"\nWrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
