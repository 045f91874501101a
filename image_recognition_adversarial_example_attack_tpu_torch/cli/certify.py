"""Certification CLI (port of ``cli/certify.py``): randomized-smoothing L2
certificates (Cohen et al., ICML 2019) or deterministic L∞ certificates by
interval bound propagation or CROWN-IBP.

    python -m image_recognition_adversarial_example_attack_tpu_torch.cli.certify \\
        --image_dir picture --sigma 0.25 --n 1000 [--device cpu]
    python -m image_recognition_adversarial_example_attack_tpu_torch.cli.certify \\
        --image_dir picture --method crown-ibp --model ibp_cnn7

``--method smoothing`` prints per sigma and image the smoothed prediction
(or ABSTAIN) and the certified radius; one voting function serves the whole
``--sigmas`` sweep, each sigma drawing from its own generator
(``split_generators`` of the seed's).  ``--method ibp|crown-ibp`` needs a
spec-driven model (``ibp_cnn7``, ``ibp_tiny``) and prints per eps the
verified and clean accuracy and each image's margin.  Both write the JAX
CLI's JSON (``--output``); ``--plot`` draws certified accuracy against the
radius.  The bounds need full float32: ``load_model`` turns TF32 off.
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
from ..core.device import resolve_device
from ..core.images import load_image_batch_tolerant
from ..core.labels import load_imagenet_labels
from ..core.rng import generator_from_seed, split_generators
from ..defenses.smoothing import ABSTAIN, SmoothedClassifier, SmoothingConfig, make_counts_fn
from .common import (add_imagenet_val_arg, add_model_args, check_label_range, load_bundle,
                     make_fns, maybe_profile, model_input_size, n_classes_of,
                     resolve_eval_inputs, resolve_labels)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Certified robustness: randomized smoothing (L2) or "
                    "interval bound propagation (L-inf)")
    parser.add_argument("--image_dir", type=str, default=None)
    parser.add_argument("--image", type=str, default="example.jpg")
    parser.add_argument("--method", type=str, default="smoothing",
                        choices=["smoothing", "ibp", "crown-ibp"],
                        help="smoothing: Monte-Carlo L2 certificates "
                             "(Cohen et al.); ibp: deterministic L-inf "
                             "certificates from closed-form interval "
                             "bounds (Gowal et al.; ibp_* models only); "
                             "crown-ibp: tighter L-inf certificates via a "
                             "backward linear bound over IBP intermediates "
                             "(Zhang et al. 2020; never worse than ibp)")
    parser.add_argument("--eps_list", type=float, nargs="+", default=[2 / 255, 8 / 255],
                        help="ibp method: L-inf radii to certify")
    parser.add_argument("--sigma", type=float, default=0.25,
                        help="Gaussian noise scale in [0,1] pixel units")
    parser.add_argument("--n0", type=int, default=32, help="selection samples (class guess)")
    parser.add_argument("--n", type=int, default=512,
                        help="estimation samples (certified bound)")
    parser.add_argument("--chunk", type=int, default=32, help="noisy copies per forward")
    parser.add_argument("--alpha", type=float, default=0.001,
                        help="certificate failure probability")
    parser.add_argument("--max_batch", type=int, default=4,
                        help="images per counts call (the device batch is "
                             "chunk * max_batch)")
    parser.add_argument("--sigmas", type=float, nargs="+", default=None,
                        help="sweep several noise scales (overrides --sigma); "
                             "one voting function serves the whole sweep")
    parser.add_argument("--plot", type=str, default=None,
                        help="write the certified-accuracy-vs-radius figure "
                             "here (accuracy vs the base model's clean "
                             "pseudo-labels, the harness convention)")
    parser.add_argument("--labels_json", type=str, default=None,
                        help="JSON {path-or-basename: class id} ground-truth "
                             "labels for certified ACCURACY; default = the "
                             "base model's clean predictions")
    parser.add_argument("--output", type=str, default="certify_results.json")
    add_imagenet_val_arg(parser)
    add_model_args(parser)
    return parser


def _inputs(args):
    """(x on the device, kept paths, bundle, logits_fn, base predictions,
    evaluation labels)."""
    paths = resolve_eval_inputs(args, skip_bmp=False)
    device = resolve_device(args.device)
    print(f"Using device: {device}"
          + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))
    x_np, kept = load_image_batch_tolerant(paths, size=model_input_size(args))
    if not kept:
        raise SystemExit("no loadable images")
    bundle = load_bundle(args)
    return torch.from_numpy(x_np).to(device), kept, bundle


def _labels(args, bundle, logits_fn, x, kept):
    base_pred = predict_labels(logits_fn, x).cpu().numpy()
    y_eval = resolve_labels(args.labels_json, kept, base_pred)
    if args.labels_json:
        check_label_range(np.asarray(y_eval), n_classes_of(bundle.model))
    return base_pred, y_eval


def _main_ibp(args) -> int:
    """Deterministic L∞ certification: one interval forward per eps, no
    sampling, no abstention."""
    x, kept, bundle = _inputs(args)
    if not hasattr(bundle.model, "spec"):
        raise SystemExit(
            f"--method {args.method} needs a spec-driven model (ibp_cnn7 / "
            f"ibp_tiny, models/ibp.py); --model {args.model} has no "
            f"interval propagator")
    from ..defenses.crown_ibp import make_crown_verify_fn
    from ..defenses.ibp import make_verify_fn
    from ..models.ibp import ibp_params

    make = make_crown_verify_fn if args.method == "crown-ibp" else make_verify_fn
    verify = make(ibp_params(bundle.model), bundle.model.spec, bundle.mean, bundle.std)
    logits_fn, _ = make_fns(bundle)
    with maybe_profile(args.profile_dir):
        base_pred, y_eval = _labels(args, bundle, logits_fn, x, kept)
        y = torch.from_numpy(np.asarray(y_eval, np.int64)).to(x.device)
        sweeps = []
        for eps in [float(e) for e in args.eps_list]:
            t0 = time.perf_counter()
            out = {k: v.cpu().numpy() for k, v in verify(x, y, eps).items()}
            dt = time.perf_counter() - t0
            verified, correct, margin = out["verified"], out["correct"], out["margin"]
            print(f"eps={eps:.6g}: verified_acc={verified.mean():.3f} "
                  f"clean_acc={correct.mean():.3f} "
                  f"({len(kept)} images, {dt:.1f}s)")
            results = []
            for i, p in enumerate(kept):
                print(f"  {Path(p).name}: pred={int(base_pred[i])} "
                      f"{'VERIFIED' if verified[i] else 'not verified'} "
                      f"(margin={margin[i]:.4f})")
                results.append({
                    "image": str(p),
                    "base_prediction": int(base_pred[i]),
                    "label": int(y_eval[i]),
                    "verified": bool(verified[i]),
                    "margin": float(margin[i]),
                })
            sweeps.append({"eps": eps,
                           "verified_accuracy": float(verified.mean()),
                           "clean_accuracy": float(correct.mean()),
                           "results": results})
    out_path = Path(args.output)
    out_path.write_text(json.dumps(
        {"method": args.method, "model": args.model, "sweeps": sweeps}, indent=2))
    print(f"Wrote {out_path}")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.method in ("ibp", "crown-ibp"):
        return _main_ibp(args)

    x, kept, bundle = _inputs(args)
    logits_fn, _ = make_fns(bundle)
    labels = load_imagenet_labels()
    sigmas = [float(s) for s in args.sigmas] if args.sigmas else [float(args.sigma)]
    # one voting function serves every sigma
    counts_fn = make_counts_fn(logits_fn, int(args.chunk))
    generators = split_generators(generator_from_seed(args.seed), len(sigmas))

    per_sigma, curves = [], []
    with maybe_profile(args.profile_dir):
        base_pred, y_eval = _labels(args, bundle, logits_fn, x, kept)
        for sigma, gen in zip(sigmas, generators):
            config = SmoothingConfig(sigma=sigma, n0=int(args.n0), n=int(args.n),
                                     chunk=int(args.chunk), alpha=float(args.alpha),
                                     max_batch=int(args.max_batch))
            smoothed = SmoothedClassifier(logits_fn, config, counts_fn=counts_fn)
            t0 = time.perf_counter()
            classes, radii = smoothed.certify(x, gen)
            dt = time.perf_counter() - t0

            results = []
            print(f"sigma={sigma} n0={config.n0} n={config.n} "
                  f"alpha={config.alpha}  ({dt:.1f}s total)")
            for i, p in enumerate(kept):
                cls = int(classes[i])
                name = ("ABSTAIN" if cls == ABSTAIN else
                        (labels[cls] if labels and cls < len(labels) else str(cls)))
                print(f"{Path(p).name}: prediction={name} "
                      f"certified_radius={radii[i]:.4f} "
                      f"(base pred {int(base_pred[i])})")
                results.append({
                    "image": str(p),
                    "base_prediction": int(base_pred[i]),
                    "smoothed_prediction": cls,
                    "certified_radius": float(radii[i]),
                })
            per_sigma.append({"sigma": sigma, "results": results})
            # ground truth with --labels_json, else the base model's clean
            # predictions (the harness convention)
            curves.append({"sigma": sigma, "radii": np.asarray(radii),
                           "correct": np.asarray(classes) == np.asarray(y_eval)})

    out = Path(args.output)
    out.write_text(json.dumps({"n0": int(args.n0), "n": int(args.n),
                               "alpha": float(args.alpha), "sweeps": per_sigma}, indent=2))
    print(f"Wrote {out}")

    if args.plot:
        from ..viz.plots import plot_certified_accuracy

        plot_certified_accuracy(curves, Path(args.plot))
        print(f"Wrote {args.plot}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
