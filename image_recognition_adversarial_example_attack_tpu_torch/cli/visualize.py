"""Deep-dive visualization CLI (port of ``cli/visualize.py``, the
``visualized_attacks.py`` surface).

    python -m image_recognition_adversarial_example_attack_tpu_torch.cli.visualize \\
        --image img.png [--eps ...] [--steps 20] [--cw_steps 100] [--device cpu]

Runs fgsm, pgd and cw on one image, then the PGD trajectory, and writes
``attack_comparison.png``, ``attack_trajectory.png``,
``perturbation_analysis.png``, the printed metric block and
``attack_report.json``.  As in the JAX CLI, the reference's ``pred_adj``
typo (a KeyError while writing the report) is fixed.

``--landscape`` adds ``loss_landscape.png``: per attack, the cross-entropy
on the plane through the image spanned by the attack's direction and a
random orthogonal one (``eval/landscape.py``), ``--landscape_grid`` squared
points in one batched forward.  ``--gradcam`` adds ``gradcam_attack.png``:
the Grad-CAM maps of the clean prediction on the clean image and of the
adversarial prediction on each adversarial image (``eval/explain.py``), and
the report's ``gradcam_iou`` per attack; a model without the conv tap
(every family but ResNet) prints ``gradcam skipped: ...`` and goes on.

The randomness is drawn in the JAX CLI's order from one generator seeded
with ``--seed``: pgd's random start, the trajectory's, then one plane per
attack.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from ..attacks.api import AttackParams, run_attack
from ..core.constants import DEFAULT_ALPHA, DEFAULT_CW_C, DEFAULT_EPS
from ..core.device import resolve_device
from ..core.images import load_image, save_image_01
from ..core.labels import load_imagenet_labels
from ..core.rng import generator_from_seed
from ..eval.metrics import attack_metrics, metrics_to_python
from ..eval.trajectory import pgd_trajectory
from .common import add_model_args, input_dtype_of, load_bundle, make_fns, maybe_profile

ATTACKS = ("fgsm", "pgd", "cw")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Adversarial attack visual deep-dive")
    parser.add_argument("--image", type=str, required=True)
    parser.add_argument("--eps", type=float, default=DEFAULT_EPS)
    parser.add_argument("--alpha", type=float, default=DEFAULT_ALPHA)
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--cw_steps", type=int, default=100)
    parser.add_argument("--cw_c", type=float, default=DEFAULT_CW_C)
    parser.add_argument("--output_dir", type=str, default="./attack_visualization")
    parser.add_argument("--save_images", action="store_true")
    parser.add_argument("--gradcam", action="store_true",
                        help="also emit gradcam_attack.png: Grad-CAM attention maps "
                             "of the clean vs adversarial prediction per attack, with "
                             "the attention-shift IoU (conv models; eval/explain.py)")
    parser.add_argument("--landscape", action="store_true",
                        help="also emit loss_landscape.png: the CE surface on the "
                             "plane spanned by each attack's direction and a random "
                             "orthogonal direction (eval/landscape.py)")
    parser.add_argument("--landscape_grid", type=int, default=21,
                        help="landscape resolution (one [grid^2] batched forward per "
                             "attack)")
    add_model_args(parser)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    image_path = Path(args.image)
    if not image_path.exists():
        raise FileNotFoundError(f"image not found: {image_path}")

    device = resolve_device(args.device)
    print(f"Using device: {device}"
          + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))
    bundle = load_bundle(args)
    logits_fn, _ = make_fns(bundle)
    labels = load_imagenet_labels()

    x = torch.from_numpy(load_image(image_path)).to(device)
    generator = generator_from_seed(args.seed)

    def predict(xx: torch.Tensor) -> tuple[int, str, float]:
        with torch.no_grad():
            p = torch.softmax(logits_fn(xx), dim=-1)[0].cpu().numpy()
        idx = int(p.argmax())
        return idx, labels[idx] if idx < len(labels) else str(idx), float(p[idx])

    clean_id, clean_name, clean_prob = predict(x)
    print("\n" + "=" * 60)
    print(f"Input image: {image_path.name}")
    print(f"Predicted label: {clean_name} (class {clean_id})")
    print(f"Confidence: {clean_prob:.4f}")
    print("=" * 60)

    print("\nRunning attacks...")
    results: dict[str, dict] = {}
    y = torch.tensor([clean_id], dtype=torch.int64, device=device)
    params = AttackParams(eps=args.eps, alpha=args.alpha, steps=args.steps, cw_c=args.cw_c,
                          cw_steps=args.cw_steps)
    with maybe_profile(args.profile_dir):
        for attack_name in ATTACKS:
            print(f"  running {attack_name.upper()}...")
            x_adv = run_attack(attack_name, logits_fn, x, y, params, generator)
            results[attack_name] = {
                "x_adv": x_adv.cpu().numpy(),
                "pred_clean": (clean_id, clean_name, clean_prob),
                "pred_adv": predict(x_adv),
            }
        traj = pgd_trajectory(logits_fn, x, y, eps=args.eps, alpha=args.alpha,
                              steps=args.steps, generator=generator)
        traj_probs = traj.probs.cpu().numpy()
        traj_l2 = traj.l2.cpu().numpy()

    output_dir = Path(args.output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)

    print("\nGenerating visualizations...")
    from ..viz.plots import plot_attack_grid, plot_attack_trajectory, plot_perturbation_analysis

    x_np = x.cpu().numpy()[0]
    grid_results = {
        name: {"x_adv": r["x_adv"][0], "pred_clean": r["pred_clean"], "pred_adv": r["pred_adv"]}
        for name, r in results.items()
    }
    plot_attack_grid(x_np, grid_results, output_dir / "attack_comparison.png")
    print(f"  saved: {output_dir / 'attack_comparison.png'}")
    plot_attack_trajectory(traj_probs, traj_l2, "pgd", args.eps,
                           output_dir / "attack_trajectory.png")
    print(f"  saved: {output_dir / 'attack_trajectory.png'}")
    plot_perturbation_analysis(x_np, grid_results, output_dir / "perturbation_analysis.png")
    print(f"  saved: {output_dir / 'perturbation_analysis.png'}")

    if args.landscape:
        from ..eval.landscape import adversarial_plane, loss_landscape
        from ..viz.plots import plot_loss_landscape

        span = 1.5
        landscapes = {}
        for attack_name, r in results.items():
            x_adv = torch.from_numpy(r["x_adv"][0]).to(device)
            plane = adversarial_plane(x[0], x_adv, generator)
            landscapes[attack_name] = loss_landscape(
                logits_fn, x[0], clean_id, plane, span=span,
                grid=int(args.landscape_grid)).cpu().numpy()
        plot_loss_landscape(landscapes, span, output_dir / "loss_landscape.png")
        print(f"  saved: {output_dir / 'loss_landscape.png'}")

    cam_report: dict[str, float] = {}
    if args.gradcam:
        from ..eval.explain import cam_shift_iou, make_gradcam_fn, upsample_cam

        try:
            gradcam_fn = make_gradcam_fn(bundle.model, bundle.mean, bundle.std,
                                         input_dtype=input_dtype_of(bundle))
        except ValueError as exc:
            print(f"  gradcam skipped: {exc}")
        else:
            height, width = x.shape[1], x.shape[2]
            cam_clean = upsample_cam(gradcam_fn(x, y), height, width)
            cam_results = {}
            for attack_name, r in results.items():
                x_adv = torch.from_numpy(r["x_adv"]).to(device)
                y_adv = torch.tensor([r["pred_adv"][0]], dtype=torch.int64, device=device)
                cam_adv = upsample_cam(gradcam_fn(x_adv, y_adv), height, width)
                iou = float(cam_shift_iou(cam_clean, cam_adv)[0])
                cam_report[attack_name] = iou
                cam_results[attack_name] = {
                    "x_adv": r["x_adv"][0],
                    "cam_clean": cam_clean[0].cpu().numpy(),
                    "cam_adv": cam_adv[0].cpu().numpy(),
                    "pred_clean": r["pred_clean"],
                    "pred_adv": r["pred_adv"],
                    "cam_iou": iou,
                }
            from ..viz.plots import plot_gradcam_panel

            plot_gradcam_panel(x_np, cam_results, output_dir / "gradcam_attack.png")
            print(f"  saved: {output_dir / 'gradcam_attack.png'}")

    # the metric block (the reference's print layout)
    print("\nQuantitative metrics:")
    print("-" * 80)
    metrics_cache: dict[str, dict] = {}
    for attack_name, r in results.items():
        adv_info = r["pred_adv"]
        success = "SUCCESS" if clean_id != adv_info[0] else "FAILED"
        print(f"\n{attack_name.upper()} attack [{success}]:")
        print(f"  prediction change: {clean_name} ({clean_prob:.4f}) -> "
              f"{adv_info[1]} ({adv_info[2]:.4f})")
        m = metrics_to_python(attack_metrics(x, torch.from_numpy(r["x_adv"]).to(device)))
        metrics_cache[attack_name] = m
        for metric, value in m.items():
            if "SSIM" in metric or "PSNR" in metric:
                print(f"  {metric:.<25} {value:.4f}")
            else:
                print(f"  {metric:.<25} {value:.6f}")

    if args.save_images:
        print("\nSaving adversarial images...")
        img_dir = output_dir / "adversarial_images"
        for attack_name, r in results.items():
            out = img_dir / f"adv_{attack_name}.png"
            save_image_01(r["x_adv"][0], out)
            print(f"    {out}")

    report = {
        "image": str(image_path.absolute()),
        "model": args.model,
        "clean_prediction": {
            "class_id": clean_id,
            "class_name": clean_name,
            "confidence": clean_prob,
        },
        "params": {
            "eps": float(args.eps),
            "alpha": float(args.alpha),
            "steps": int(args.steps),
            "cw_c": float(args.cw_c),
            "cw_steps": int(args.cw_steps),
        },
        "attacks": {
            name: {
                # the reference read result["pred_adj"] here, a typo that
                # crashed the report (visualized_attacks.py:609)
                "predicted_class": int(r["pred_adv"][0]),
                "predicted_name": r["pred_adv"][1],
                "confidence": float(r["pred_adv"][2]),
                "success": bool(clean_id != r["pred_adv"][0]),
                "metrics": metrics_cache[name],
                **({"gradcam_iou": cam_report[name]} if name in cam_report else {}),
            }
            for name, r in results.items()
        },
    }
    report_path = output_dir / "attack_report.json"
    report_path.write_text(json.dumps(report, indent=2, ensure_ascii=False))

    print(f"\nAll results saved to: {output_dir}")
    print(f"JSON report: {report_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
