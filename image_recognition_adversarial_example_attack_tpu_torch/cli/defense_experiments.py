"""Defense experiment CLI (port of ``cli/defense_experiments.py``, the
``defense_experiments.py`` surface) for the attacks fgsm, pgd, cw, the
transfer family mifgsm, dim and tim, and the white-box zoo apgd, apgd_dlr,
apgd_t, fab, deepfool, ead, jsma, stadv, spatial and pgd_l1, with the JAX
CLI's ``--square_steps`` and extended-attack flags.

    python -m image_recognition_adversarial_example_attack_tpu_torch.cli.defense_experiments \\
        --image_dir imgs/ [--attacks fgsm pgd cw] [--eps_list ...] [--device cpu]

Up to ``--max_batch`` images are one resident batch on the device, and
each (attack, eps) grid cell is one call of ``evaluate_defenses_batch``, run
eagerly, with its own generator (``core.rng.cell_generator``): a cell's
randomness depends only on the seed and the cell id, never on its place in
the grid.  Larger image sets stream in fixed chunks of ``--max_batch``
(``eval/streaming.py``): one cell call per chunk, the decode of the next
chunk overlapping the card's work, each chunk's randomness from
``core.rng.chunk_generator``, per-chunk pseudo-labels computed once for the
whole grid.  Finished cells are written to
``<output_dir>/results_partial.json`` after each cell, and ``--resume``
reuses those computed under the same configuration.  Before the grid the
detector is calibrated (or given) on at most the first 100 images; after it
come the summary lines, the sample figure (PGD at ``eps_list[1]``, alpha
eps/4, 10 steps), the heatmaps and ``timings.json``.

The eps-independent attacks (cw, deepfool, ead, stadv, boundary, simba,
jsma, spatial) compute one cell and reuse it for every eps.  Every
``--attacks`` choice of the JAX CLI runs.

``--certified ibp|crown-ibp`` (spec-driven models only: ``ibp_cnn7``,
``ibp_tiny``; refused before the grid otherwise) appends one verified
accuracy row per eps after the summary, on the same images and labels as
the grid, and writes ``certified_accuracy.json``; streamed image sets take
the same chunks.  It is left out of the resume fingerprint.

``--cifar10_dir`` runs the grid on a standard CIFAR-10 archive
(``core.datasets.load_cifar10``: ``--cifar10_split``, the first
``--cifar10_n`` images) with its real labels instead of an image directory,
one resident batch whatever ``--max_batch`` says, the images named
``cifar10_<split>_<i:05d>``; it takes a 32x32 model (the CIFAR family:
``wrn28_10``, ``wrn34_10``, ``preact_resnet18``) and refuses
``--labels_json`` and ``--imagenet_val_dir``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from ..core.constants import (DEFAULT_ALPHA, DEFAULT_CW_C, DEFAULT_CW_KAPPA, DEFAULT_CW_LR,
                              DEFAULT_EPS_LIST, DEFAULT_STEPS)
from ..core.device import resolve_device, to_device
from ..core.images import list_images, load_image_batch_tolerant, pad_batch
from ..core.rng import cell_generator, generator_from_seed
from ..defenses.detector import calibrate_feature_threshold, calibrate_squeezing_threshold
from ..defenses.preprocess import DefenseConfig, defend_input
from ..eval.defense_eval import (DefenseEvalConfig, aggregate_stats, evaluate_defenses_batch,
                                 summary_line)
from ..eval.engine import Engine
from ..eval.streaming import make_placer, merge_labels, round_up, stream_defense_cell
from ..parallel.data_parallel import (evaluate_defenses_sharded, replicate_fns, sharded_counts,
                                      sharded_predict)
from ..parallel.distributed import all_reduce_sum
from ..parallel.mesh import ShardedTensor, data_sharding
from .common import (ATTACK_CHOICES, EPS_INDEPENDENT_ATTACKS, add_extended_attack_args,
                     add_imagenet_val_arg, add_model_args, apply_imagenet_val, cell_rng_id,
                     check_label_range, cifar10_inputs, config_fingerprint,
                     extended_attack_kwargs,
                     labels_digest, load_bundle, make_fns, maybe_profile, n_classes_of,
                     require_cifar_model, resolve_image_inputs, resolve_labels,
                     resolve_labels_sentinel)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Adversarial attack & defense experiment harness",
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("--model_type", type=str, choices=["standard", "robust"],
                        default="standard")
    parser.add_argument("--image_dir", type=str, default=None)
    parser.add_argument("--image", type=str, default="example.jpg")

    parser.add_argument("--attacks", type=str, nargs="+", default=["fgsm", "pgd", "cw"],
                        choices=list(ATTACK_CHOICES))
    parser.add_argument("--eps_list", type=float, nargs="+", default=list(DEFAULT_EPS_LIST))
    parser.add_argument("--certified", type=str, default="off",
                        choices=["off", "ibp", "crown-ibp"],
                        help="append per-eps CERTIFIED (verified) accuracy rows to "
                             "the experiment summary: deterministic L-inf interval "
                             "bounds (defenses/ibp.py / crown_ibp.py) on the SAME "
                             "images and labels as the empirical grid; spec-driven "
                             "models only (ibp_cnn7/ibp_tiny)")
    parser.add_argument("--cifar10_dir", type=str, default=None,
                        help="run the grid on a standard CIFAR-10 archive "
                             "(core/datasets.py) with REAL labels instead "
                             "of an image directory; use with the CIFAR "
                             "family (wrn28_10/wrn34_10/preact_resnet18)")
    parser.add_argument("--cifar10_split", type=str, default="test",
                        choices=["train", "test"])
    parser.add_argument("--cifar10_n", type=int, default=200,
                        help="cap on evaluated CIFAR images (0 = all)")
    parser.add_argument("--alpha", type=float, default=DEFAULT_ALPHA)
    parser.add_argument("--steps", type=int, default=DEFAULT_STEPS)
    parser.add_argument("--cw_c", type=float, default=DEFAULT_CW_C)
    parser.add_argument("--cw_kappa", type=float, default=DEFAULT_CW_KAPPA)
    parser.add_argument("--cw_steps", type=int, default=100)
    parser.add_argument("--square_steps", type=int, default=1000,
                        help="query budget for the square attack")
    add_extended_attack_args(parser)
    parser.add_argument("--cw_lr", type=float, default=DEFAULT_CW_LR)

    parser.add_argument("--detector", type=str, default="feature",
                        choices=["feature", "squeezing", "mahalanobis"],
                        help="feature: reference stage-3 statistics detector; "
                             "squeezing: prediction-inconsistency over the "
                             "quantize/smooth squeezers; mahalanobis: min "
                             "class-conditional Mahalanobis distance, fitted "
                             "on the calibration images")
    parser.add_argument("--detector_threshold", type=float, default=None)
    parser.add_argument("--calibrate_dir", type=str, default=None)
    parser.add_argument("--calibrate_n", type=int, default=100)
    parser.add_argument("--calibrate_quantile", type=float, default=0.95)

    parser.add_argument("--use_jpeg", action="store_true")
    parser.add_argument("--jpeg_quality", type=int, default=75)
    parser.add_argument("--jpeg_mode", type=str, default="host", choices=["host", "dct"],
                        help="host: reference-parity PIL codec (one host "
                             "round trip per defended batch); dct: the "
                             "differentiable DCT codec on the device")
    parser.add_argument("--use_tv", action="store_true",
                        help="prepend TV minimization (Guo et al. 2018) to "
                             "the defense chain, differentiable under --adaptive")
    parser.add_argument("--tv_weight", type=float, default=0.03,
                        help="TV regularization weight (paper lambda_TV)")
    parser.add_argument("--tv_steps", type=int, default=30,
                        help="Chambolle-Pock iterations")

    parser.add_argument("--labels_json", type=str, default=None,
                        help="JSON {path-or-basename: class id} ground-truth "
                             "labels; default = pseudo-labels (the model's "
                             "clean predictions); partial files fall back per image")
    parser.add_argument("--adaptive", action="store_true",
                        help="generate attacks against the DEFENDED pipeline "
                             "(gradients through the differentiable defense "
                             "chain) instead of the raw model, the Athalye et "
                             "al. adaptive-evaluation standard; counters keep "
                             "their definitions")
    parser.add_argument("--detector_aware", action="store_true",
                        help="the attacker also knows the DETECTOR: fgsm/pgd "
                             "cells ascend CE - lam*relu(score - margin*tau) "
                             "(Carlini & Wagner 2017); gradient attacks only; "
                             "composes with --adaptive")
    parser.add_argument("--detector_lam", type=float, default=1.0,
                        help="detector-penalty weight (with --detector_aware)")
    parser.add_argument("--detector_margin", type=float, default=0.9,
                        help="attack targets score < margin*threshold "
                             "(with --detector_aware)")
    parser.add_argument("--max_batch", type=int, default=256,
                        help="device batch cap: image sets larger than this "
                             "stream through the same cell in fixed-shape chunks "
                             "at constant host+device memory (0 = always one "
                             "resident batch)")
    parser.add_argument("--output_dir", type=str, default="./defense_results")
    parser.add_argument("--viz_samples", type=int, default=5,
                        help="number of attack samples to visualize (0 disables)")
    parser.add_argument("--resume", action="store_true",
                        help="skip (attack, eps) cells already in results_partial.json")
    add_imagenet_val_arg(parser)
    add_model_args(parser)
    return parser


def _partial_path(output_dir: Path) -> Path:
    return output_dir / "results_partial.json"


def _load_partial(output_dir: Path) -> dict:
    path = _partial_path(output_dir)
    if path.is_file():
        try:
            return json.loads(path.read_text())
        except json.JSONDecodeError:
            return {}
    return {}


def _save_partial(output_dir: Path, partial: dict) -> None:
    output_dir.mkdir(parents=True, exist_ok=True)
    _partial_path(output_dir).write_text(json.dumps(partial, indent=2))


def _calibrate(args, logits_fn, features_fn, x_clean, n, pseudo_fn, n_classes):
    """Calibration of the selected detector: ``(threshold, detector_params)``,
    the params being the fitted Gaussians for 'mahalanobis', else None."""
    if args.detector == "squeezing":
        print(f"Calibrating squeezing detector on {min(n, x_clean.shape[0])} clean images...")
        return calibrate_squeezing_threshold(
            logits_fn, x_clean, n=n, quantile=args.calibrate_quantile), None
    if args.detector == "mahalanobis":
        from ..defenses.mahalanobis import calibrate_mahalanobis

        num = min(int(n), x_clean.shape[0])
        print(f"Fitting Mahalanobis detector on {num} clean images...")
        # the clean predictions are the labels, the grid's convention
        params, thr = calibrate_mahalanobis(
            features_fn, x_clean, pseudo_fn(x_clean[:num]), n_classes,
            n=n, quantile=args.calibrate_quantile)
        return thr, params
    return calibrate_feature_threshold(
        features_fn, x_clean, n=n, quantile=args.calibrate_quantile), None


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.detector_aware:
        bad = [a for a in args.attacks if a not in ("fgsm", "pgd")]
        if bad:
            raise SystemExit(
                "--detector_aware needs gradient attacks with a CE "
                f"objective (fgsm|pgd); drop {bad} from --attacks")

    # --- image list first: fail fast before any device work ---
    cifar = args.cifar10_dir is not None
    if cifar:
        if args.labels_json:
            raise SystemExit("--cifar10_dir carries its own ground-truth "
                             "labels; drop --labels_json")
        x_cifar, y_cifar, image_paths = cifar10_inputs(args)
        print(f"Loaded CIFAR-10 {args.cifar10_split} split: {len(image_paths)} images")
    elif (val_paths := apply_imagenet_val(args)) is not None:
        image_paths = val_paths
    else:
        image_paths = resolve_image_inputs(args.image_dir, args.image)
        if args.image_dir is not None:
            print(f"Loaded image directory: {args.image_dir} ({len(image_paths)} images)")
        else:
            print(f"Loaded single image: {image_paths[0]}")
    device = resolve_device(args.device)
    print(f"Using device: {device}"
          + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))

    # --- model + normalization (robust arm: identity normalize) ---
    if args.model_type == "robust":
        args.model = "resnet50_robust"  # so an explicit --weights applies
        bundle = load_bundle(args)
        bundle.mean = np.zeros(3, np.float32)
        bundle.std = np.ones(3, np.float32)
    else:
        bundle = load_bundle(args)
    if cifar:
        require_cifar_model(args, bundle)
    logits_fn, features_fn = make_fns(bundle)
    n_classes = n_classes_of(bundle.model)
    # fail fast before the grid runs (the certified rows come after it)
    if args.certified != "off" and not hasattr(bundle.model, "spec"):
        raise SystemExit(
            f"--certified {args.certified} needs a spec-driven model "
            f"(ibp_cnn7 / ibp_tiny, models/ibp.py); --model {args.model} "
            "has no interval propagator")

    def pseudo_fn(xx: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return torch.argmax(logits_fn(xx), dim=-1)

    # one padded batch on the device, or sharded over the mesh's 'data' axis
    # when more than one card is visible (one model replica a card; the
    # counters are summed over the shards and trimmed to the valid rows)
    engine = Engine(use_mesh=True, device=device)
    mesh = engine.mesh
    # the host codec cannot sit inside a sharded adaptive attack loop (the
    # JAX CLI refuses it too); single-device adaptive+host works (BPDA)
    if args.adaptive and args.use_jpeg and args.jpeg_mode == "host" and mesh is not None:
        raise SystemExit(
            "--adaptive with the host JPEG codec cannot run on a mesh "
            "(the codec must sit inside the sharded attack loop); "
            "use --jpeg_mode dct")
    if mesh is None:
        cell_fns = (logits_fn, features_fn)
    else:
        cell_fns = replicate_fns(bundle, make_fns)

    def pseudo_any(xx):
        if isinstance(xx, ShardedTensor):
            return sharded_predict(cell_fns[0], xx)
        return pseudo_fn(xx)

    max_batch = int(args.max_batch)
    # the CIFAR-10 archive is decoded already: always one resident batch
    streaming = not cifar and max_batch > 0 and len(image_paths) > max_batch
    if streaming:
        chunk = round_up(max_batch, mesh.shape["data"] if mesh is not None else 1)
        place = make_placer(mesh if mesh is not None else device)
        n = len(image_paths)
        print(f"Streaming evaluation: {n} images in fixed chunks of {chunk} "
              "(constant memory; decode overlaps the device step)")
        if mesh is not None:
            print(f"Mesh: {dict(mesh.shape)} (chunks of {chunk} sharded over 'data')")
    else:
        if cifar:
            x_np = x_cifar
        else:
            x_np, image_paths = load_image_batch_tolerant(image_paths, size=bundle.input_size)
        batch = engine.batch_from_array(x_np, paths=list(image_paths))
        x, n = batch.x, batch.n_valid
        if mesh is not None:
            print(f"Mesh: {dict(mesh.shape)} (batch {batch.padded_size} sharded over 'data')")

    def leading(k: int) -> torch.Tensor:
        """The first k resident images on one device (the calibration and
        the sample figure run there)."""
        if not isinstance(x, ShardedTensor):
            return x[:k]
        return to_device(torch.from_numpy(np.ascontiguousarray(x_np[:k])), device)

    def place_labels(labels: np.ndarray):
        """Per-image labels placed as the resident batch is."""
        if mesh is None:
            return torch.from_numpy(labels.astype(np.int64)).to(device)
        padded, _ = pad_batch(labels.astype(np.int64), mesh.shape["data"])
        return data_sharding(mesh).place(padded)

    # --- detector threshold ---
    if args.detector_threshold is not None and args.detector != "mahalanobis":
        # explicit threshold: no calibration pass (mahalanobis still fits
        # its Gaussians below)
        detector_threshold, detector_params = float(args.detector_threshold), None
        print(f"Using specified threshold: {detector_threshold:.4f}")
    elif args.calibrate_dir is not None:
        calib_dir = Path(args.calibrate_dir)
        if not calib_dir.is_dir():
            raise SystemExit(f"calibrate_dir not found: {calib_dir}")
        calib_paths = [p for p in list_images(calib_dir) if p.suffix.lower() != ".bmp"]
        if not calib_paths:
            raise SystemExit(f"no images found in calibrate_dir: {calib_dir}")
        x_calib_np, _ = load_image_batch_tolerant(calib_paths[: args.calibrate_n],
                                                  size=bundle.input_size)
        detector_threshold, detector_params = _calibrate(
            args, logits_fn, features_fn, torch.from_numpy(x_calib_np).to(device),
            args.calibrate_n, pseudo_fn, n_classes)
        if args.detector_threshold is not None:
            detector_threshold = float(args.detector_threshold)
            print(f"Using specified threshold: {detector_threshold:.4f}")
        else:
            print(f"Using calibrated threshold: {detector_threshold:.4f}")
    else:
        if streaming:
            # the leading <= 100 images: the only slice the streamed path
            # holds resident
            head_np, _ = load_image_batch_tolerant(image_paths[:min(100, n)],
                                                   size=bundle.input_size)
            x_cal, n_cal = torch.from_numpy(head_np).to(device), head_np.shape[0]
        else:
            x_cal, n_cal = leading(min(100, n)), min(100, n)
        detector_threshold, detector_params = _calibrate(
            args, logits_fn, features_fn, x_cal, n_cal, pseudo_fn, n_classes)
        if args.detector_threshold is not None:
            detector_threshold = float(args.detector_threshold)
            print(f"Using specified threshold: {detector_threshold:.4f}")
        else:
            print(f"Auto-calibrated threshold: {detector_threshold:.4f}")

    defense_cfg = DefenseConfig(use_jpeg=bool(args.use_jpeg),
                                jpeg_quality=int(args.jpeg_quality),
                                jpeg_mode=str(args.jpeg_mode),
                                use_tv=bool(args.use_tv),
                                tv_weight=float(args.tv_weight),
                                tv_steps=int(args.tv_steps))

    # one fingerprint per attack, scoped to the knobs that attack reads
    labels_fp = labels_digest(args.labels_json)
    config_fps = {a: config_fingerprint(args, attack_name=a, labels_content=labels_fp)
                  for a in args.attacks}
    # the clean predictions are the labels (the reference's convention)
    # unless --labels_json gives ground truth; the figure always shows the
    # clean predictions.  Streamed, both are resolved per chunk: images the
    # labels file leaves out carry the UNLABELED sentinel until then.
    labels_np = y_true = y_pseudo = None
    if streaming:
        labels_np = resolve_labels_sentinel(args.labels_json, image_paths)
        if labels_np is not None:
            check_label_range(labels_np, n_classes)
    elif cifar:
        # the archive's labels
        y_pseudo = pseudo_any(x)
        pseudo = _host(y_pseudo)[:n]
        labels = y_cifar.astype(np.int64)
        check_label_range(labels, n_classes)
        print(f"clean accuracy vs CIFAR-10 {args.cifar10_split} labels: "
              f"{float(np.mean(labels == pseudo)):.3f}")
        y_true = place_labels(labels)
    elif args.labels_json:
        y_pseudo = pseudo_any(x)
        pseudo = _host(y_pseudo)[:n]
        labels = resolve_labels(args.labels_json, list(image_paths), pseudo)
        check_label_range(labels, n_classes)
        print(f"clean accuracy vs ground truth: {float(np.mean(labels == pseudo)):.3f}")
        y_true = place_labels(labels)
    else:
        y_true = y_pseudo = pseudo_any(x)

    output_dir = Path(args.output_dir)
    partial = _load_partial(output_dir) if args.resume else {}

    results: dict[tuple[str, float], dict] = {}
    print("\n" + "=" * 60)
    print("Running attack & defense experiments...")
    print("=" * 60)

    from ..utils.profiling import PhaseTimer

    timer = PhaseTimer()
    # eps-independent attacks (cw) give the same cell at every eps: computed
    # once and reused
    eps_independent_cache: dict[str, dict] = {}
    # per-chunk pseudo-labels last the whole attack x eps grid: the clean
    # forward for the labels runs once per chunk in all
    stream_clean_cache: dict = {}
    with maybe_profile(args.profile_dir):
        for attack_name in args.attacks:
            cfg = DefenseEvalConfig(
                attack_name=attack_name, eps=float(args.eps_list[0]),  # eps is set per cell
                alpha=float(args.alpha), steps=int(args.steps),
                cw_c=float(args.cw_c), cw_kappa=float(args.cw_kappa),
                cw_steps=int(args.cw_steps), cw_lr=float(args.cw_lr),
                square_steps=int(args.square_steps), **extended_attack_kwargs(args),
                detector=str(args.detector), detector_params=detector_params,
                defense=defense_cfg, adaptive=bool(args.adaptive),
                detector_aware=bool(args.detector_aware),
                detector_lam=float(args.detector_lam),
                detector_margin=float(args.detector_margin),
            )
            for eps in args.eps_list:
                cell_id = f"{attack_name}:{float(eps):.6f}"
                tag = " | ADAPTIVE (through the defense)" if args.adaptive else ""
                if args.detector_aware:
                    tag += " | DETECTOR-AWARE"
                print(f"\n[{attack_name.upper()} Attack | eps={eps:.5f}{tag}]")
                # resume only cells computed under the same configuration
                if (cell_id in partial
                        and partial[cell_id].get("count") == n
                        and partial[cell_id].get("config_fp") == config_fps[attack_name]):
                    print("  (resumed from partial results)")
                    results[(attack_name, float(eps))] = partial[cell_id]
                    if attack_name in EPS_INDEPENDENT_ATTACKS:
                        eps_independent_cache.setdefault(attack_name, partial[cell_id])
                    continue
                if attack_name in eps_independent_cache:
                    print(f"  ({attack_name} is eps-independent: reusing the computed cell)")
                    cached = eps_independent_cache[attack_name]
                    results[(attack_name, float(eps))] = dict(cached)
                    partial[cell_id] = dict(cached)
                    _save_partial(output_dir, partial)
                    continue

                rng_id = cell_rng_id(attack_name, float(eps))
                with timer.phase(cell_id):
                    if streaming:
                        stats = stream_defense_cell(
                            *cell_fns, cfg, image_paths, detector_threshold,
                            seed=args.seed, cell_id=rng_id, eps=float(eps), chunk_size=chunk,
                            place=place, size=bundle.input_size, pseudo_label_fn=pseudo_any,
                            labels=labels_np, clean_cache=stream_clean_cache)
                    elif mesh is not None:
                        out = evaluate_defenses_sharded(
                            *cell_fns, x, y_true, detector_threshold, cfg,
                            cell_generator(args.seed, rng_id), eps_override=float(eps))
                        stats = sharded_counts(out, n_valid=n)  # waits for the devices
                    else:
                        out = evaluate_defenses_batch(
                            logits_fn, features_fn, x, y_true, detector_threshold, cfg,
                            cell_generator(args.seed, rng_id), eps_override=float(eps))
                        stats = aggregate_stats(out)  # waits for the device
                record = timer.records[-1]
                record.examples = stats["count"]
                dt = record.seconds
                how = (f"streamed chunks of {chunk}, one cell call each" if streaming
                       else "one resident batch")
                print(f"  {stats['count']} images in {dt:.2f}s "
                      f"({stats['count'] / dt:.1f} img/s, {how})")
                results[(attack_name, float(eps))] = stats
                if attack_name in EPS_INDEPENDENT_ATTACKS:
                    eps_independent_cache[attack_name] = stats
                stats["config_fp"] = config_fps[attack_name]  # resume gate
                partial[cell_id] = stats
                _save_partial(output_dir, partial)

    # --- summary (exact reference format) ---
    print("\n" + "=" * 60)
    print("Experiment summary")
    print("=" * 60)
    for (attack_name, eps), stats in sorted(results.items()):
        print(summary_line(attack_name, eps, stats))

    output_dir.mkdir(parents=True, exist_ok=True)

    # --- certified rows beside the empirical ones: same images, same labels ---
    if args.certified != "off":
        _certified_summary(args, bundle, pseudo_any, image_paths=image_paths,
                           streaming=streaming, x=None if streaming else x, n=n,
                           y_true=y_true, labels_np=labels_np,
                           chunk=chunk if streaming else 0,
                           place=place if streaming else None, output_dir=output_dir)

    # --- sample visualization (PGD at eps_list[1] or 8/255, alpha=eps/4) ---
    if args.viz_samples > 0:
        print("\n" + "=" * 60)
        print("Generating attack-sample visualization...")
        print("=" * 60)
        viz_eps = float(args.eps_list[1]) if len(args.eps_list) > 1 else 8 / 255
        n_viz = min(int(args.viz_samples), n)
        if streaming:
            # a resident slice of just the drawn samples
            viz_np, _ = load_image_batch_tolerant(image_paths[:n_viz], size=bundle.input_size)
            x_viz = torch.from_numpy(viz_np).to(device)
            y_viz = pseudo_fn(x_viz)
        elif mesh is not None:
            x_viz = leading(n_viz)
            y_viz = pseudo_fn(x_viz)
        else:
            x_viz, y_viz = x[:n_viz], y_pseudo[:n_viz]
        _visualize_samples(logits_fn, x_viz, y_viz, viz_eps, defense_cfg,
                           output_dir, generator_from_seed(args.seed + 1))

    print("\n" + "=" * 60)
    print("Generating defense heatmaps...")
    print("=" * 60)
    from ..viz.plots import plot_defense_heatmaps

    plot_defense_heatmaps(results, output_dir, save_prefix="defense_results")
    print(f"Saved visualizations to: {output_dir}")

    timings_path = output_dir / "timings.json"
    timings_path.write_text(json.dumps(timer.as_dict(), indent=2))
    print(f"Phase timings: {timings_path}")

    print("\nAll experiments complete. Results saved to:", output_dir)
    return 0


def _certified_summary(args, bundle, pseudo_fn, *, image_paths, streaming, x, n, y_true,
                       labels_np, chunk, place, output_dir) -> None:
    """Per-eps verified accuracy after the experiment summary: one interval
    forward per eps (``defenses/ibp.py``, or the tighter CROWN-IBP backward
    bound) over the grid's images with the grid's labels (ground truth where
    given, pseudo-labels otherwise).  A streamed set takes the grid's
    chunks; only per-chunk counts reach the host."""
    from ..defenses.crown_ibp import make_crown_verify_fn
    from ..defenses.ibp import make_verify_fn
    from ..models.ibp import ibp_params
    from ..utils.pipeline import EvalBatchPipeline

    make = make_crown_verify_fn if args.certified == "crown-ibp" else make_verify_fn
    verify = make(ibp_params(bundle.model), bundle.model.spec, bundle.mean, bundle.std)
    home = next(iter(bundle.model.parameters())).device
    eps_list = [float(e) for e in args.eps_list]
    print("-" * 60)
    counts = {eps: [0, 0, 0] for eps in eps_list}  # verified, correct, images
    if streaming:
        pipe = EvalBatchPipeline(image_paths, chunk, labels=labels_np,
                                 size=bundle.input_size)
        batches = ((place(x_np), y_np, n_valid) for _, x_np, y_np, n_valid in pipe)
    else:
        batches = [(x, None, n)]
    for xc, y_np, n_valid in batches:
        yc = y_true if not streaming else merge_labels(y_np, pseudo_fn(xc))
        for eps in eps_list:
            # a sharded batch: each shard's rows below n_valid, moved to the
            # bounds' device
            for xs, ys, take in _valid_shards(xc, yc, n_valid, home):
                out = verify(xs, ys, eps)
                counts[eps][0] += int(out["verified"][:take].sum())
                counts[eps][1] += int(out["correct"][:take].sum())
            counts[eps][2] += int(n_valid)
    # on a mesh of several processes each counted its own rows
    for eps in eps_list:
        counts[eps][:2] = all_reduce_sum(torch.tensor(counts[eps][:2])).tolist()
    rows = []
    for eps in eps_list:
        nv, nc, tot = counts[eps]
        v, c = nv / max(tot, 1), nc / max(tot, 1)
        print(f"certified({args.certified}), eps={eps:.5f}: "
              f"verified_acc={v:.4f}, clean_acc={c:.4f} ({tot} images)")
        rows.append({"eps": eps, "verified_accuracy": v, "clean_accuracy": c, "count": tot})
    path = output_dir / "certified_accuracy.json"
    path.write_text(json.dumps({"method": args.certified, "model": args.model, "rows": rows},
                               indent=2))
    print(f"Certified rows: {path}")


def _host(t) -> np.ndarray:
    """A (sharded) tensor's rows on the host, in order."""
    return (t.gather() if isinstance(t, ShardedTensor) else t.cpu()).numpy()


def _valid_shards(x, y, n_valid: int, device: torch.device):
    """(x rows, y rows, how many of them are below ``n_valid``) a shard of a
    sharded batch, each on ``device``, or the one batch itself."""
    if not isinstance(x, ShardedTensor):
        return [(x, y, n_valid)]
    return [(xs.to(device), ys.to(device), max(0, min(hi, n_valid) - lo))
            for xs, ys, (lo, hi) in zip(x.data_shards(), y.data_shards(), x.row_ranges())]


def _visualize_samples(logits_fn, x, y_pred, eps, defense_cfg, output_dir, generator):
    """Clean/adv/defended/perturbation grid: PGD with alpha=eps/4, 10 steps,
    then the composite defense."""
    from ..attacks.pgd import pgd_linf_attack
    from ..viz.plots import plot_attack_samples

    x_adv = pgd_linf_attack(logits_fn, x, y_pred, eps=eps, alpha=eps / 4, steps=10,
                            generator=generator)
    with torch.no_grad():
        x_def = defend_input(x_adv, defense_cfg)
        probs_clean = torch.softmax(logits_fn(x), dim=-1).cpu().numpy()
        pred_adv = torch.argmax(logits_fn(x_adv), dim=-1).cpu().numpy()
        pred_def = torch.argmax(logits_fn(x_def), dim=-1).cpu().numpy()
    x_np, x_adv_np, x_def_np = (t.cpu().numpy() for t in (x, x_adv, x_def))
    y_np = y_pred.cpu().numpy()
    samples = [
        {
            "x": x_np[i],
            "x_adv": x_adv_np[i],
            "x_def": x_def_np[i],
            "pred_clean": int(y_np[i]),
            "conf_clean": float(probs_clean[i, y_np[i]]),
            "pred_adv": int(pred_adv[i]),
            "pred_def": int(pred_def[i]),
        }
        for i in range(x.shape[0])
    ]
    out = plot_attack_samples(samples, output_dir, eps)
    print(f"Saved sample visualization: {out}")


if __name__ == "__main__":
    sys.exit(main())
