"""Adversarial training CLI (port of ``cli/adversarial_train.py``): PGD-AT,
TRADES, MART, free-AT, IBP and CROWN-IBP, producing a Flax msgpack file
that the port and the JAX package both load.

    python -m image_recognition_adversarial_example_attack_tpu_torch.cli.adversarial_train \\
        --data_dir data/ --model resnet50 --epochs 3 --out weights/resnet50_robust.msgpack

``--data_dir`` holds one subdirectory per class (labels by sorted name);
``--cifar10_dir`` a CIFAR-10 archive (``core/datasets.py``), the WRN
family's input.  It runs on the card unless ``--device cpu`` is given.

The parameters train in float32 and each forward runs in ``--model-dtype``
(bfloat16 on the card by default); the step is ``train/adversarial.py``'s.
Each step draws from a generator seeded by ``(seed, epoch, step)`` alone and
each epoch shuffles with ``RandomState(shuffle_seed(seed, epoch))``, so a
``--resume``d run replays the schedule of an uninterrupted one.  The
``.ckpt`` beside the export is the port's own layout (torch tensors); the
export is the JAX package's Flax msgpack, with the EMA when one is kept.
"""

from __future__ import annotations

import argparse
import sys
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

from ..core.device import resolve_device, synchronize
from ..core.images import list_images, load_image_batch_tolerant
from ..core.rng import cell_generator, chunk_generator
from ..train.adversarial import (AdvTrainConfig, calibrate_batch_stats, deploy_params,
                                 ibp_layers, load_train_checkpoint, make_eval_step,
                                 make_free_step, make_ibp_step, make_mart_step,
                                 make_robust_eval_step, make_train_step, make_trades_step,
                                 save_train_checkpoint, train_state_from_bundle)
from ..utils.pipeline import BatchPipeline, shuffle_seed
from .common import (add_model_args, maybe_profile, model_input_size, n_classes_of,
                     positive_int, resolve_dtype)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Adversarial fine-tuning: PGD-AT (Madry et al.), "
                    "TRADES or MART")
    parser.add_argument("--data_dir", type=str, default=None,
                        help="root with one subdirectory per class")
    parser.add_argument("--cifar10_dir", type=str, default=None,
                        help="root containing a standard CIFAR-10 archive "
                             "(cifar-10-batches-py or -bin; core/datasets.py) "
                             "— the natural input for the WRN family; mutually "
                             "exclusive with --data_dir/--streaming")
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--eps", type=float, default=8 / 255)
    parser.add_argument("--alpha", type=float, default=2 / 255)
    parser.add_argument("--attack_steps", type=int, default=7)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--lr_schedule", type=str, default="constant",
                        choices=["constant", "cosine"],
                        help="cosine: linear warmup to --lr then cosine decay to 0 "
                             "over the whole run; the schedule rides the optimizer's "
                             "update count, so --resume continues it exactly")
    parser.add_argument("--warmup_steps", type=int, default=0,
                        help="linear LR warmup steps (both schedules)")
    parser.add_argument("--eval_attack_steps", type=int, default=0,
                        help=">0: also report per-epoch ROBUST accuracy "
                             "(PGD-k at --eps/--alpha) on the held slice")
    parser.add_argument("--weight_decay", type=float, default=1e-4)
    parser.add_argument("--label_smoothing", type=float, default=0.0)
    parser.add_argument("--clean_weight", type=float, default=0.0,
                        help=">0 mixes clean CE into the objective")
    parser.add_argument("--objective", type=str, default="pgd-at",
                        choices=["pgd-at", "trades", "mart", "free", "ibp", "crown-ibp"],
                        help="pgd-at: CE on PGD examples; trades: CE(clean) + "
                             "beta*KL(clean||adv); mart: boosted CE(adv) + "
                             "beta*(1-p_y(clean))*KL(clean||adv); free: Shafahi et "
                             "al. replay training (a parameter update and an FGSM "
                             "perturbation update per replay; train ~epochs/replays "
                             "passes); ibp: certified training on interval bounds "
                             "(Gowal et al. 2018; ibp_* models only); crown-ibp: "
                             "backward linear bounds mixed with IBP by a ramped beta "
                             "(Zhang et al. 2020)")
    parser.add_argument("--free_replays", type=positive_int, default=4,
                        help="free objective: replays per batch (m)")
    parser.add_argument("--trades_beta", type=float, default=6.0,
                        help="TRADES robustness/accuracy trade-off beta")
    parser.add_argument("--mart_beta", type=float, default=5.0,
                        help="MART misclassification-aware KL weight")
    parser.add_argument("--ibp_ramp_steps", type=int, default=-1,
                        help="ibp objective: optimizer steps over which eps ramps "
                             "0->--eps and kappa 1->--ibp_kappa (-1 = half the run's "
                             "total steps; 0 = full eps from step 0)")
    parser.add_argument("--ibp_kappa", type=float, default=0.5,
                        help="ibp objective: final weight of the clean CE term after "
                             "the ramp")
    parser.add_argument("--ibp_final_beta", type=float, default=0.0,
                        help="crown-ibp objective: final CROWN weight in the "
                             "beta_t*CROWN + (1-beta_t)*IBP margin mix (beta ramps "
                             "1 -> this over --ibp_ramp_steps; 0 ends on pure IBP)")
    parser.add_argument("--augment", type=str, default="none", choices=["none", "crop-flip"],
                        help="crop-flip: 4-pixel-pad random crop + horizontal flip "
                             "inside the step (the from-scratch CIFAR AT recipe; "
                             "Madry et al. 2018) — augment, THEN attack")
    parser.add_argument("--cutout", type=int, default=0,
                        help=">0: additionally zero one NxN square per image "
                             "(DeVries & Taylor 2017; composes with --augment)")
    parser.add_argument("--noise_sigma", type=float, default=0.0,
                        help=">0: Gaussian-noise training for randomized smoothing "
                             "(SmoothAdv inner attack + noisy CE; with "
                             "--attack_steps 0, plain Cohen augmentation). pgd-at "
                             "objective only.")
    parser.add_argument("--noise_samples", type=int, default=4,
                        help="EOT noise draws for the SmoothAdv inner attack")
    parser.add_argument("--grad_accum", type=positive_int, default=1,
                        help="micro-batches per optimizer step, one after another: "
                             "activation memory of batch/N (effective batch and "
                             "update count unchanged)")
    parser.add_argument("--ema_decay", type=float, default=0.0,
                        help=">0 (e.g. 0.999): keep an EMA of the parameters and "
                             "EXPORT the EMA weights (raw weights stay in the .ckpt "
                             "for resuming)")
    parser.add_argument("--train_bn", action="store_true",
                        help="batch-statistics BatchNorm — the from-scratch mode for "
                             "the CIFAR family (wrn*/preact_resnet18): forwards "
                             "normalize by the batch's own statistics, and running "
                             "stats are recalibrated once at export (precise-BN)")
    parser.add_argument("--remat", action="store_true",
                        help="checkpoint the model forward: the backward recomputes "
                             "activations instead of holding them (one extra "
                             "forward per backward)")
    parser.add_argument("--out", type=str, default=None,
                        help="output .msgpack (default: weights/<model>_robust.msgpack)")
    parser.add_argument("--checkpoint_path", type=str, default=None,
                        help="full-state checkpoint file (default: <out>.ckpt)")
    parser.add_argument("--save_every", type=int, default=1,
                        help="checkpoint every N epochs (0 disables)")
    parser.add_argument("--resume", action="store_true",
                        help="restore params+optimizer+epoch from --checkpoint_path "
                             "and continue")
    parser.add_argument("--streaming", action="store_true",
                        help="decode batches in a background thread instead of "
                             "loading the whole dataset into RAM (utils/pipeline.py; "
                             "same shuffle/generator schedule as the in-RAM path)")
    add_model_args(parser)
    return parser


def _list_dataset(data_dir: Path):
    """(paths, labels, classes) without decoding anything."""
    classes = sorted(d.name for d in data_dir.iterdir() if d.is_dir())
    if not classes:
        raise SystemExit(f"no class subdirectories under {data_dir}")
    paths, labels = [], []
    for label, cname in enumerate(classes):
        for p in list_images(data_dir / cname):
            paths.append(p)
            labels.append(label)
    if not paths:
        raise SystemExit(f"no images under {data_dir}/<class>/")
    return paths, labels, classes


def _load_dataset(data_dir: Path, size: int):
    paths, labels, classes = _list_dataset(data_dir)
    x, kept = load_image_batch_tolerant(paths, size=size)
    kept_set = {str(p) for p in kept}
    y = np.asarray([lab for p, lab in zip(paths, labels) if str(p) in kept_set], np.int32)
    return x, y, classes


def _verified_eval(args, ibp_spec, bundle):
    """Per-epoch certified accuracy at the full --eps (the crown-ibp
    objective certifies with its own bound)."""
    from ..defenses.crown_ibp import crown_ibp_margin
    from ..defenses.ibp import logit_bounds, verified_margin

    def verified_eval(state, x, y):
        layers = ibp_layers(state.params, ibp_spec)
        eps = torch.tensor(float(args.eps), dtype=torch.float32, device=x.device)
        with torch.no_grad():
            if args.objective == "crown-ibp":
                m = crown_ibp_margin(layers, ibp_spec, x, y, eps, bundle.mean, bundle.std)
            else:
                m = verified_margin(*logit_bounds(layers, ibp_spec, x, eps,
                                                  bundle.mean, bundle.std), y)
        return torch.mean((m > 0.0).to(torch.float32))

    return verified_eval


def _export(args, state, out: Path) -> None:
    """The deployed weights as a Flax msgpack file (float32)."""
    from ..models.convert import to_jax_variables
    from ..models.flax_msgpack import save_variables
    from ..models.zoo import build_model, model_family

    model = build_model(args.model, int8=bool(args.int8))
    deployed = {**deploy_params(state), **state.extra_variables}
    model.load_state_dict({k: v.detach().cpu().to(torch.float32) if v.is_floating_point()
                           else v.detach().cpu() for k, v in deployed.items()}, strict=True)
    out.parent.mkdir(parents=True, exist_ok=True)
    save_variables(to_jax_variables(model, model_family(args.model)), out)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if (args.data_dir is None) == (args.cifar10_dir is None):
        raise SystemExit("pass exactly one of --data_dir / --cifar10_dir")
    if args.cifar10_dir is not None and args.streaming:
        raise SystemExit("--streaming applies to --data_dir image trees "
                         "(the CIFAR archives are already one dense array)")
    device = resolve_device(args.device)
    print(f"Using device: {device}"
          + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))

    size = model_input_size(args)
    if args.cifar10_dir is not None:
        from ..core.datasets import CIFAR10_CLASSES, load_cifar10

        if size != 32:
            raise SystemExit(f"--cifar10_dir is 32x32 data but --model {args.model} "
                             f"expects {size}x{size}; use the WRN family "
                             "(wrn28_10/wrn34_10)")
        x_np, y_np = load_cifar10(args.cifar10_dir, split="train")
        classes = list(CIFAR10_CLASSES)
        n = len(y_np)
        eval_x, eval_y = x_np[: min(256, n)], y_np[: min(256, n)]
    elif args.streaming:
        ds_paths, ds_labels, classes = _list_dataset(Path(args.data_dir))
        x_np = y_np = None
        n = len(ds_paths)
        # a fixed held slice for the epoch metric (decoded once), so the
        # streamed run's lines compare with the in-RAM run's
        eval_x, eval_kept = load_image_batch_tolerant(ds_paths[: min(256, n)], size=size)
        kept_set = {str(Path(p)) for p in eval_kept}
        eval_y = np.asarray([lab for p, lab in zip(ds_paths[: min(256, n)],
                                                    ds_labels[: min(256, n)])
                             if str(Path(p)) in kept_set], np.int32)
    else:
        x_np, y_np, classes = _load_dataset(Path(args.data_dir), size)
        n = len(y_np)
        eval_x, eval_y = x_np[: min(256, n)], y_np[: min(256, n)]
    print(f"Dataset: {n} images, {len(classes)} classes {classes[:8]}"
          f"{'...' if len(classes) > 8 else ''}"
          f"{' [streaming]' if args.streaming else ''}")

    from ..models.zoo import load_model

    # float32 master weights; the forward runs in --model-dtype
    bundle = load_model(args.model, dtype=torch.float32, weights=args.weights, device=device,
                        int8=bool(args.int8))
    compute_dtype = resolve_dtype(args.model_dtype, device)
    n_out = n_classes_of(bundle.model)
    if len(classes) > n_out:
        raise SystemExit(f"dataset has {len(classes)} classes but --model {args.model} "
                         f"outputs {n_out}")
    # the optimizer's schedule needs the run's step count before the loop:
    # the batch and grad_accum arithmetic of the loop below
    batch_plan = min(int(args.batch_size), n)
    accum_plan = max(1, min(int(args.grad_accum), batch_plan))
    if batch_plan % accum_plan:
        batch_plan = (batch_plan // accum_plan) * accum_plan
    total_steps = max(1, n // batch_plan) * int(args.epochs)
    config = AdvTrainConfig(
        eps=float(args.eps), alpha=float(args.alpha), attack_steps=int(args.attack_steps),
        learning_rate=float(args.lr), lr_schedule=str(args.lr_schedule),
        warmup_steps=int(args.warmup_steps), total_steps=int(total_steps),
        weight_decay=float(args.weight_decay), label_smoothing=float(args.label_smoothing),
        clean_weight=float(args.clean_weight), trades_beta=float(args.trades_beta),
        mart_beta=float(args.mart_beta), noise_sigma=float(args.noise_sigma),
        noise_samples=int(args.noise_samples),
        ibp_ramp_steps=(total_steps // 2 if int(args.ibp_ramp_steps) < 0
                        else int(args.ibp_ramp_steps)),
        ibp_kappa=float(args.ibp_kappa),
        ibp_bound="crown" if args.objective == "crown-ibp" else "ibp",
        ibp_final_beta=float(args.ibp_final_beta),
        aug_pad=4 if args.augment == "crop-flip" else 0,
        aug_flip=args.augment == "crop-flip", aug_cutout=int(args.cutout),
        grad_accum=int(args.grad_accum), remat=bool(args.remat),
        ema_decay=float(args.ema_decay), train_bn=bool(args.train_bn),
        free_replays=int(args.free_replays))
    try:
        state = train_state_from_bundle(bundle, config, compute_dtype)
    except ValueError as e:
        raise SystemExit(str(e))
    if args.objective == "free" and int(args.grad_accum) > 1:
        raise SystemExit("--objective free updates parameters every replay; drop --grad_accum")
    if args.objective == "free" and args.streaming:
        # the carried perturbation is batch-shaped; the streaming pipeline's
        # refilled rows would mix per-image perturbations
        raise SystemExit("--objective free uses a batch-shaped carried "
                         "perturbation; use the in-RAM data path")
    if args.objective != "pgd-at" and float(args.noise_sigma) > 0.0:
        print("WARNING: --noise_sigma applies to the pgd-at objective only "
              f"({args.objective} ignores it).")
    if args.objective != "pgd-at" and float(args.clean_weight) > 0.0:
        print("WARNING: --clean_weight is a PGD-AT flag; "
              f"{args.objective} already contains its own clean term and ignores it.")
    ibp_spec = None
    if args.objective in ("ibp", "crown-ibp"):
        if not hasattr(bundle.model, "spec"):
            raise SystemExit(
                f"--objective {args.objective} needs a spec-driven model "
                f"(ibp_cnn7 / ibp_tiny, models/ibp.py); --model "
                f"{args.model} has no interval propagator")
        if args.train_bn:
            raise SystemExit("IBP nets are BN-free by construction "
                             "(models/ibp.py); drop --train_bn")
        ibp_spec = bundle.model.spec

        def make_step(config, mean, std):
            return make_ibp_step(config, ibp_spec, mean, std)
    else:
        make_step = {"trades": make_trades_step,
                     "mart": make_mart_step}.get(args.objective, make_train_step)
    if args.objective == "free":
        # the free step carries the shared perturbation across batches;
        # adapt it to the (state, x, y, generator) loop
        free_step = make_free_step(config, bundle.mean, bundle.std)
        carried = {"delta": None}

        def train_step(state, xb, yb, gen):
            if carried["delta"] is None or carried["delta"].shape != xb.shape:
                carried["delta"] = torch.zeros_like(xb)
            state, metrics, carried["delta"] = free_step(state, xb, yb, gen, carried["delta"])
            return state, metrics
    else:
        train_step = make_step(config, bundle.mean, bundle.std)
    eval_step = make_eval_step(bundle.mean, bundle.std)
    eval_step_ema = (make_eval_step(bundle.mean, bundle.std, use_ema=True)
                     if float(args.ema_decay) > 0.0 else None)
    robust_eval = (make_robust_eval_step(int(args.eval_attack_steps), float(args.eps),
                                         float(args.alpha), bundle.mean, bundle.std,
                                         use_ema=float(args.ema_decay) > 0.0)
                   if int(args.eval_attack_steps) > 0 else None)
    verified_eval = _verified_eval(args, ibp_spec, bundle) if ibp_spec is not None else None

    out = Path(args.out) if args.out else Path("weights") / f"{args.model}_robust.msgpack"
    ckpt_path = (Path(args.checkpoint_path) if args.checkpoint_path
                 else out.with_suffix(out.suffix + ".ckpt"))

    start_epoch = 0
    if args.resume:
        if ckpt_path.is_file():
            state, start_epoch = load_train_checkpoint(state, ckpt_path)
            print(f"Resumed from {ckpt_path}: step={int(state.step)}, "
                  f"continuing at epoch {start_epoch + 1}")
        else:
            print(f"--resume: no checkpoint at {ckpt_path}; starting fresh")

    batch = min(int(args.batch_size), n)
    accum = min(int(args.grad_accum), batch)
    if accum != int(args.grad_accum):
        print(f"grad_accum clamped to {accum} (batch is only {batch})")
        config = replace(config, grad_accum=accum)
        train_step = make_step(config, bundle.mean, bundle.std)
    if batch % accum:
        # equal micro-batches: round down so grad_accum divides
        batch = (batch // accum) * accum
        print(f"batch_size rounded to {batch} (must divide by grad_accum={accum})")
    steps_per_epoch = max(1, n // batch)
    ex = torch.from_numpy(np.ascontiguousarray(eval_x)).to(device)
    ey = torch.from_numpy(np.asarray(eval_y, np.int64)).to(device)

    def end_epoch(epoch, metrics, dt):
        """The epoch's metric line (on the same held slice on both data
        paths) and the checkpoint."""
        ev = eval_step(state, ex, ey)
        ema_note = ""
        if eval_step_ema is not None:
            ema_note = f" ema_clean_acc={float(eval_step_ema(state, ex, ey)['clean_accuracy']):.3f}"
        robust_note = ""
        if robust_eval is not None:
            # a generator of (seed, epoch): comparable across epochs and
            # across interrupted and resumed runs
            rv = robust_eval(state, ex, ey, cell_generator(int(args.seed),
                                                           f"robust_eval:{epoch}"))
            robust_note = (f" robust_acc@pgd{int(args.eval_attack_steps)}="
                           f"{float(rv['robust_accuracy']):.3f}")
        if verified_eval is not None:
            robust_note += (f" verified_acc@{float(args.eps):.4g}="
                            f"{float(verified_eval(state, ex, ey)):.3f}")
        print(f"epoch {epoch + 1}/{args.epochs}: "
              f"loss={float(metrics['loss']):.4f} "
              f"adv_acc={float(metrics['adv_accuracy']):.3f} "
              f"clean_acc={float(ev['clean_accuracy']):.3f}{ema_note}"
              f"{robust_note} "
              f"({steps_per_epoch * batch / dt:.1f} ex/s)", flush=True)
        if args.save_every and (epoch + 1) % int(args.save_every) == 0:
            save_train_checkpoint(state, ckpt_path, epoch)

    def put(xb, yb):
        return (torch.from_numpy(np.ascontiguousarray(xb)).to(device),
                torch.from_numpy(np.asarray(yb, np.int64)).to(device))

    with maybe_profile(args.profile_dir):
        if args.streaming:
            # one pipeline across the remaining epochs: the decode of epoch
            # e+1's first batch overlaps epoch e's last step
            pipe = BatchPipeline(ds_paths, ds_labels, batch, epochs=int(args.epochs),
                                 start_epoch=start_epoch, seed=int(args.seed), size=size)
            cur_epoch, metrics = None, {}
            t0 = time.perf_counter()
            for epoch, s, xb, yb in pipe:
                if epoch != cur_epoch:
                    if cur_epoch is not None:
                        synchronize(device)
                        end_epoch(cur_epoch, metrics, time.perf_counter() - t0)
                        t0 = time.perf_counter()
                    cur_epoch = epoch
                state, metrics = train_step(state, *put(xb, yb),
                                            chunk_generator(int(args.seed), f"train:{epoch}", s))
            if cur_epoch is not None:
                synchronize(device)
                end_epoch(cur_epoch, metrics, time.perf_counter() - t0)
        else:
            for epoch in range(start_epoch, int(args.epochs)):
                t0 = time.perf_counter()
                metrics = {}
                order = np.random.RandomState(shuffle_seed(int(args.seed), epoch)).permutation(n)
                for s in range(steps_per_epoch):
                    idx = order[s * batch:(s + 1) * batch]
                    if len(idx) < batch:  # one batch shape
                        idx = np.concatenate([idx, order[: batch - len(idx)]])
                    state, metrics = train_step(state, *put(x_np[idx], y_np[idx]),
                                                chunk_generator(int(args.seed),
                                                                f"train:{epoch}", s))
                synchronize(device)
                end_epoch(epoch, metrics, time.perf_counter() - t0)

    if args.train_bn:
        # precise-BN: the export gets running statistics of its own
        calib_x = x_np if x_np is not None else eval_x
        print(f"Calibrating BatchNorm running statistics "
              f"({calib_x.shape[0]} images, precise-BN sweep)...")
        state = state.replace(extra_variables=calibrate_batch_stats(
            state, torch.from_numpy(np.ascontiguousarray(calib_x)), bundle.mean, bundle.std,
            batch_size=min(256, batch)))

    _export(args, state, out)
    which = "EMA" if state.ema_params is not None else "raw"
    print(f"Saved adversarially fine-tuned checkpoint ({which} weights): {out}")
    # fine-tuning keeps the base model's normalization: the standard arm
    print(f"Use it via: defense_experiments --model {args.model} --weights {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
