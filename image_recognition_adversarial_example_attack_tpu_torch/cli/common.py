"""Shared CLI plumbing (port of ``cli/common.py``, the parts the ported
CLIs use): model/dtype/seed/device/profile flags, the extended attack
flags, bundle loading, top-k printing, image and label inputs, ImageNet-val
ground truth, and the grid's resume fingerprint and per-cell randomness.

``--device`` defaults to ``cuda``; where CUDA is absent the run fails unless
``--device cpu`` is given.  Importing this module joins a multi-process run
from the environment (``parallel.distributed.maybe_initialize_distributed``).
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import tempfile
from pathlib import Path

import numpy as np
import torch
from torch import nn

from ..core.device import resolve_device
from ..parallel.distributed import maybe_initialize_distributed

# Join a multi-process run when the launcher provides the coordinates
# (ADV_TPU_COORDINATOR, ADV_TPU_NUM_PROCESSES, ADV_TPU_PROCESS_ID).
maybe_initialize_distributed()


def add_model_args(parser: argparse.ArgumentParser, default_model: str = "resnet50") -> None:
    parser.add_argument("--model", type=str, default=default_model,
                        help="model name from the zoo (default: %(default)s)")
    parser.add_argument("--weights", type=str, default=None,
                        help="weights file (.msgpack cache or torchvision .pth)")
    parser.add_argument("--model-dtype", type=str, default=None,
                        choices=["float32", "bfloat16"],
                        help="compute dtype (default: bfloat16 on CUDA, float32 on CPU)")
    parser.add_argument("--int8", action="store_true",
                        help="quantized inference (every registered family): int8 "
                             "weights per output channel and activations per example, "
                             "int32 sums through torch._int_mm on the card (an int64 "
                             "product on the CPU), gradients of the float op; a "
                             "robustness-evaluation mode (ops/int8.py)")
    parser.add_argument("--seed", type=int, default=0, help="random seed")
    parser.add_argument("--profile-dir", type=str, default=None,
                        help="write a torch.profiler Chrome trace here")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="device to run on (default: %(default)s; the CPU "
                             "only when asked for)")


def add_extended_attack_args(parser: argparse.ArgumentParser) -> None:
    """The JAX CLIs' flags of the extended attack families, with their
    defaults (AttackParams') and help texts."""
    parser.add_argument("--deepfool_steps", type=int, default=50,
                        help="deepfool max iterations")
    parser.add_argument("--deepfool_classes", type=int, default=10,
                        help="deepfool candidate classes (top-k by clean logits)")
    parser.add_argument("--deepfool_overshoot", type=float, default=0.02,
                        help="deepfool boundary overshoot factor")
    parser.add_argument("--est_samples", type=int, default=32,
                        help="nes/spsa antithetic probe pairs per step")
    parser.add_argument("--nes_sigma", type=float, default=1e-3,
                        help="nes Gaussian smoothing radius")
    parser.add_argument("--spsa_delta", type=float, default=1e-2,
                        help="spsa finite-difference perturbation size")
    parser.add_argument("--bandits_steps", type=int, default=500,
                        help="bandits-TD iterations (2 queries each)")
    parser.add_argument("--bandits_prior_factor", type=int, default=8,
                        help="bandits data-prior downsampling factor "
                             "(latent lattice H/f x W/f)")
    parser.add_argument("--bandits_fd_eta", type=float, default=0.1,
                        help="bandits image-space exploration radius")
    parser.add_argument("--bandits_delta", type=float, default=0.1,
                        help="bandits latent exploration radius")
    parser.add_argument("--bandits_prior_lr", type=float, default=1.0,
                        help="bandits exponentiated-gradients rate")
    parser.add_argument("--hsja_steps", type=int, default=10,
                        help="hsja outer boundary-walk iterations")
    parser.add_argument("--hsja_probes", type=int, default=32,
                        help="hsja decision queries per normal estimate")
    parser.add_argument("--ead_beta", type=float, default=1e-3,
                        help="ead elastic-net L1 weight")
    parser.add_argument("--ead_c", type=float, default=50.0,
                        help="ead margin-loss weight (FISTA needs larger "
                             "c than CW's Adam — see attacks/ead.py)")
    parser.add_argument("--ead_lr", type=float, default=0.05,
                        help="ead FISTA step size")
    parser.add_argument("--stadv_steps", type=int, default=200,
                        help="stadv Adam iterations on the flow field")
    parser.add_argument("--stadv_lr", type=float, default=0.01,
                        help="stadv Adam learning rate")
    parser.add_argument("--stadv_tau", type=float, default=0.05,
                        help="stadv flow-smoothness weight (non-Lp: this, "
                             "not eps, bounds the distortion)")
    parser.add_argument("--boundary_steps", type=int, default=500,
                        help="boundary-walk iterations (2 hard-label "
                             "queries each)")
    parser.add_argument("--boundary_spherical_step", type=float, default=0.01,
                        help="boundary initial along-boundary step "
                             "(self-adapts per sample)")
    parser.add_argument("--boundary_source_step", type=float, default=0.01,
                        help="boundary initial contraction step "
                             "(self-adapts per sample)")
    parser.add_argument("--simba_steps", type=int, default=1000,
                        help="simba coordinate trials (<=2 queries each)")
    parser.add_argument("--simba_eps", type=float, default=0.2,
                        help="simba per-direction step size (paper 0.2)")
    parser.add_argument("--simba_mode", choices=["dct", "pixel"],
                        default="dct",
                        help="simba basis: low-frequency DCT (paper "
                             "default) or single pixels")
    parser.add_argument("--jsma_steps", type=int, default=100,
                        help="jsma L0 budget: max features changed "
                             "(greedy, one per step)")
    parser.add_argument("--jsma_theta", type=float, default=1.0,
                        help="jsma per-feature move (1.0 saturates to "
                             "the [0,1] bound)")
    parser.add_argument("--l1_sparsity", type=float, default=0.01,
                        help="pgd_l1 (SLIDE) top-|grad| coordinate "
                             "fraction per step")
    parser.add_argument("--spatial_max_rot", type=float, default=30.0,
                        help="spatial rotation budget in degrees "
                             "(non-Lp: this + --spatial_max_trans, not "
                             "eps, define the threat model)")
    parser.add_argument("--spatial_max_trans", type=float, default=0.1,
                        help="spatial translation budget as a fraction "
                             "of each image axis")
    parser.add_argument("--spatial_candidates", type=int, default=10,
                        help="spatial worst-of-k random draws (0 disables "
                             "the random part)")
    parser.add_argument("--spatial_grid_rot", type=int, default=0,
                        help="spatial exhaustive-grid rotation steps "
                             "(grid used when this AND --spatial_grid_trans "
                             "are > 0; paper's strongest: 31)")
    parser.add_argument("--spatial_grid_trans", type=int, default=0,
                        help="spatial exhaustive-grid translation steps "
                             "per axis (paper's strongest: 5)")


def extended_attack_kwargs(args: argparse.Namespace) -> dict:
    """kwargs for AttackParams/DefenseEvalConfig from the extended flags."""
    return {
        "deepfool_steps": int(args.deepfool_steps),
        "deepfool_classes": int(args.deepfool_classes),
        "deepfool_overshoot": float(args.deepfool_overshoot),
        "est_samples": int(args.est_samples),
        "nes_sigma": float(args.nes_sigma),
        "spsa_delta": float(args.spsa_delta),
        "bandits_steps": int(args.bandits_steps),
        "bandits_prior_factor": int(args.bandits_prior_factor),
        "bandits_fd_eta": float(args.bandits_fd_eta),
        "bandits_delta": float(args.bandits_delta),
        "bandits_prior_lr": float(args.bandits_prior_lr),
        "hsja_steps": int(args.hsja_steps),
        "hsja_probes": int(args.hsja_probes),
        "ead_beta": float(args.ead_beta),
        "ead_c": float(args.ead_c),
        "ead_lr": float(args.ead_lr),
        "stadv_steps": int(args.stadv_steps),
        "stadv_lr": float(args.stadv_lr),
        "stadv_tau": float(args.stadv_tau),
        "boundary_steps": int(args.boundary_steps),
        "boundary_spherical_step": float(args.boundary_spherical_step),
        "boundary_source_step": float(args.boundary_source_step),
        "simba_steps": int(args.simba_steps),
        "simba_eps": float(args.simba_eps),
        "simba_mode": str(args.simba_mode),
        "jsma_steps": int(args.jsma_steps),
        "jsma_theta": float(args.jsma_theta),
        "l1_sparsity": float(args.l1_sparsity),
        "spatial_max_rot": float(args.spatial_max_rot),
        "spatial_max_trans": float(args.spatial_max_trans),
        "spatial_candidates": int(args.spatial_candidates),
        "spatial_grid_rot": int(args.spatial_grid_rot),
        "spatial_grid_trans": int(args.spatial_grid_trans),
    }


def resolve_dtype(name: str | None, device: torch.device) -> torch.dtype:
    if name == "float32":
        return torch.float32
    if name == "bfloat16":
        return torch.bfloat16
    # default: bf16 on the card, f32 on the CPU
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def load_bundle(args: argparse.Namespace, name: str | None = None):
    """Load ``name`` (default ``args.model``) honoring the CLI's
    device/dtype/weights/int8 flags (``--seed`` drives the attack's randomness,
    not the weights).

    An explicit ``--weights`` file applies only to the model it was given
    for, ``args.model``: in the multi-model CLIs every other model resolves
    through the weights directory, as in the JAX package."""
    from ..models.zoo import load_model

    device = resolve_device(args.device)
    target = name or args.model
    weights = args.weights if target == args.model else None
    return load_model(target, dtype=resolve_dtype(args.model_dtype, device),
                      weights=weights, device=device, int8=bool(getattr(args, "int8", False)))


def model_input_size(args: argparse.Namespace) -> int:
    """The ``--model``'s native input size (224, or 32 for the IBP nets)
    without building the model: for the CLIs that decode images before the
    bundle exists."""
    from ..models.zoo import model_meta

    return int(model_meta(getattr(args, "model", "resnet50"))["input_size"])


def input_dtype_of(bundle):
    """The input-cast dtype of a bundle's closures: its compute dtype, or
    None for float32 (the one place of the policy, so the logits, feature
    and Grad-CAM closures agree)."""
    return bundle.dtype if bundle.dtype != torch.float32 else None


def make_fns(bundle):
    """(logits_fn, features_fn) for a bundle, casting the input to the
    model's compute dtype when it is not float32."""
    from ..attacks.api import make_logits_fn
    from ..defenses.detector import make_features_fn

    input_dtype = input_dtype_of(bundle)
    lf = make_logits_fn(bundle.model, bundle.mean, bundle.std, input_dtype=input_dtype)
    ff = make_features_fn(bundle.model, bundle.mean, bundle.std, input_dtype=input_dtype)
    return lf, ff


def topk_host(probs: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """[B,K] probs -> (values [B,k], indices [B,k]) sorted descending."""
    idx = np.argsort(-probs, axis=-1)[:, :k]
    vals = np.take_along_axis(probs, idx, axis=-1)
    return vals, idx


def print_topk(title: str, prob_row: np.ndarray, idx_row: np.ndarray, labels) -> None:
    """The reference's exact per-rank print format (ResNet.py:76-78)."""
    print(f"{title}:")
    for rank, (p, idx) in enumerate(zip(prob_row, idx_row), start=1):
        label = labels[idx] if labels and idx < len(labels) else str(idx)
        print(f"Top {rank}: {label} (class {idx}), prob = {p:.4f}")


def resolve_image_inputs(image_dir: str | None, image: str, skip_bmp: bool = True) -> list:
    """--image_dir / --image: a directory gives its sorted image list (BMP
    files left out, as the reference does, unless ``skip_bmp`` is False),
    else the single file; missing inputs fail before any device work."""
    from ..core.images import list_images

    if image_dir is not None:
        d = Path(image_dir)
        if not d.is_dir():
            raise SystemExit(f"image_dir not found: {d}")
        paths = [p for p in list_images(d)
                 if not (skip_bmp and p.suffix.lower() == ".bmp")]
        if not paths:
            raise SystemExit(f"no images found in {d}")
        return paths
    p = Path(image)
    if not p.is_file():
        raise SystemExit(f"image not found: {p}")
    return [p]


# "unlabeled: substitute the model's pseudo-label at use time"
UNLABELED = -1


def check_label_range(labels, n_classes: int):
    """Out-of-range class ids would silently corrupt every counter: fail
    loud instead.  The UNLABELED sentinel is always legal."""
    arr = np.asarray(labels)
    bad = arr[(arr >= int(n_classes)) | (arr < UNLABELED)]
    if bad.size:
        ids = sorted(set(int(v) for v in bad))[:5]
        raise SystemExit(
            f"labels_json contains out-of-range class ids {ids} for a "
            f"{int(n_classes)}-class model")


def positive_int(value: str) -> int:
    """argparse type: a strictly positive integer."""
    n = int(value)
    if n < 1:
        raise argparse.ArgumentTypeError(
            f"expected a positive integer, got {value}")
    return n


def n_classes_of(model: nn.Module) -> int:
    """The class count: the width of the model's classifier, its last
    ``nn.Linear`` in every registered family (``fc``, ``classifier.6``,
    ``classifier``, ``heads.head``, ``head``, ``Dense_0``); no forward pass."""
    linears = [m for m in model.modules() if isinstance(m, nn.Linear)]
    return int(linears[-1].out_features)


# The --attacks choices of the JAX grid and transfer CLIs
# (cli/defense_experiments.py, cli/blackbox_transfer.py, cli/transferability.py)
# and the --attack choices of its classify CLI (the same, with pgd_l2, after
# "none").
ATTACK_CHOICES = (
    "fgsm", "pgd", "cw", "mifgsm", "dim", "tim", "apgd", "square", "deepfool", "nes", "spsa",
    "bandits", "hsja", "ead", "apgd_dlr", "apgd_t", "fab", "stadv", "boundary", "simba",
    "jsma", "pgd_l1", "spatial")
CLASSIFY_ATTACK_CHOICES = ("none", "fgsm", "pgd", "pgd_l2", *ATTACK_CHOICES[2:])


# The CLI args each attack reads (the run_attack dispatch, attacks/api.py).
# They scope the resume fingerprint per grid cell: changing --cw_steps must
# not invalidate an fgsm cell.
ATTACK_KNOB_ARGS: dict[str, frozenset] = {
    "fgsm": frozenset(),
    "pgd": frozenset({"steps", "alpha"}),
    "pgd_l2": frozenset({"steps", "alpha"}),
    "mifgsm": frozenset({"steps", "alpha", "mu"}),
    "dim": frozenset({"steps", "alpha", "mu"}),
    "tim": frozenset({"steps", "alpha", "mu"}),
    "apgd": frozenset({"steps"}),
    "apgd_dlr": frozenset({"steps"}),
    "apgd_t": frozenset({"steps", "n_target_classes"}),
    "fab": frozenset({"steps", "n_target_classes"}),
    "square": frozenset({"square_steps"}),
    "square_l2": frozenset({"square_steps"}),
    "deepfool": frozenset({"deepfool_steps", "deepfool_classes", "deepfool_overshoot"}),
    "nes": frozenset({"steps", "alpha", "est_samples", "nes_sigma"}),
    "spsa": frozenset({"steps", "alpha", "est_samples", "spsa_delta"}),
    "bandits": frozenset({"alpha", "bandits_steps", "bandits_prior_factor", "bandits_fd_eta",
                          "bandits_delta", "bandits_prior_lr"}),
    "hsja": frozenset({"hsja_steps", "hsja_probes"}),
    "ead": frozenset({"cw_steps", "cw_kappa", "ead_beta", "ead_c", "ead_lr"}),
    "cw": frozenset({"cw_c", "cw_kappa", "cw_steps", "cw_lr"}),
    "stadv": frozenset({"stadv_steps", "stadv_lr", "stadv_tau", "cw_kappa"}),
    "boundary": frozenset({"boundary_steps", "boundary_spherical_step",
                           "boundary_source_step"}),
    "simba": frozenset({"simba_steps", "simba_eps", "simba_mode"}),
    "jsma": frozenset({"jsma_steps", "jsma_theta"}),
    "pgd_l1": frozenset({"steps", "alpha", "l1_sparsity"}),
    "spatial": frozenset({"spatial_max_rot", "spatial_max_trans", "spatial_candidates",
                         "spatial_grid_rot", "spatial_grid_trans"}),
}
_ALL_KNOB_ARGS: frozenset = frozenset().union(*ATTACK_KNOB_ARGS.values())

# Attacks that never read eps: their grid cells are identical across the eps
# sweep, so the grid computes one and reuses it, and their randomness comes
# from an eps-free cell id.  hsja does not read eps either, but as in the
# JAX package its cell id (with eps) seeds its generator and keys --resume.
EPS_INDEPENDENT_ATTACKS = ("cw", "deepfool", "ead", "stadv", "boundary", "simba", "jsma",
                           "spatial")


def cell_rng_id(attack_name: str, eps: float) -> str:
    """The cell id a cell's generator is seeded from
    (``core.rng.cell_generator``): eps-free for eps-independent attacks."""
    if attack_name in EPS_INDEPENDENT_ATTACKS:
        return f"{attack_name}:epsfree"
    return f"{attack_name}:{float(eps):.6f}"


def labels_digest(labels_json: str | None) -> str | None:
    """SHA-256 of the labels file's content, or None."""
    if not labels_json:
        return None
    return hashlib.sha256(Path(labels_json).read_bytes()).hexdigest()


# CLI args that change no grid cell (--certified adds rows after the grid)
_NOT_FINGERPRINTED = frozenset({"output_dir", "resume", "viz_samples", "profile_dir",
                                "certified"})


def config_fingerprint(args, attack_name: str | None = None,
                       labels_content: str | None = None) -> str:
    """Short hash of every CLI argument that defines a result, plus the
    CONTENT of the labels file: --resume reuses a cell only under the same
    fingerprint.

    With ``attack_name`` the hash is scoped to one grid cell: the grid
    (``attacks``/``eps_list``, already in the cell id) and the knobs the
    named attack never reads are left out.  An unknown attack keeps every
    knob."""
    exclude = set(_NOT_FINGERPRINTED)
    if attack_name is not None:
        exclude |= {"attacks", "eps_list"}
        exclude |= _ALL_KNOB_ARGS - ATTACK_KNOB_ARGS.get(attack_name, _ALL_KNOB_ARGS)
    payload = {k: v for k, v in sorted(vars(args).items()) if k not in exclude}
    if getattr(args, "labels_json", None):
        payload["__labels_content__"] = (
            labels_content if labels_content is not None
            else labels_digest(args.labels_json))
        payload.pop("labels_json", None)
    blob = json.dumps(payload, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def imagenet_val_inputs(val_dir: str) -> tuple[list, str]:
    """ImageNet-val ground truth: ``(paths, labels_json_path)``.

    The labels are written once as a content-addressed JSON file in the
    temporary directory, so every consumer (``resolve_labels``, the resume
    fingerprint, which hashes the file's content) runs the one labels path.
    """
    from ..core.datasets import list_imagenet_val

    paths, labels, classes = list_imagenet_val(val_dir)
    table = {str(p): int(l) for p, l in zip(paths, labels)}
    blob = json.dumps(table, sort_keys=True)
    digest = hashlib.sha256(blob.encode()).hexdigest()[:16]
    out = Path(tempfile.gettempdir()) / f"imagenet_val_labels_{digest}.json"
    # atomic and content-checked: a concurrent run never reads half a file,
    # and an existing file is trusted only if it hashes to its name
    if (not out.is_file()
            or hashlib.sha256(out.read_bytes()).hexdigest()[:16] != digest):
        fd, tmp = tempfile.mkstemp(dir=out.parent, suffix=".json")
        try:
            os.write(fd, blob.encode())
            os.close(fd)
            os.replace(tmp, out)
        except BaseException:
            Path(tmp).unlink(missing_ok=True)
            raise
    layout = f"{len(classes)} named classes" if classes else "flat + val_map"
    print(f"ImageNet-val ground truth: {len(paths)} images ({layout}, "
          f"{len(set(table.values()))} distinct labels) -> {out}")
    return paths, str(out)


def add_imagenet_val_arg(parser) -> None:
    parser.add_argument(
        "--imagenet_val_dir", type=str, default=None,
        help="ImageNet validation directory with GROUND-TRUTH labels: "
             "either torchvision-style class subfolders (sorted folder "
             "names -> class indices) or flat images + val_map.txt "
             "'<filename> <class_index>' lines; replaces --image_dir "
             "and implies the labels (mutually exclusive with "
             "--labels_json)")


def apply_imagenet_val(args) -> list | None:
    """--imagenet_val_dir: returns the path list and points
    ``args.labels_json`` at the ground truth, or None without the flag."""
    if not getattr(args, "imagenet_val_dir", None):
        return None
    if getattr(args, "labels_json", None):
        raise SystemExit("--imagenet_val_dir carries its own ground-truth "
                         "labels; drop --labels_json")
    if getattr(args, "image_dir", None):
        raise SystemExit("--imagenet_val_dir replaces --image_dir; "
                         "pass only one")
    paths, labels_json = imagenet_val_inputs(args.imagenet_val_dir)
    args.labels_json = labels_json
    return paths


def resolve_eval_inputs(args, *, skip_bmp: bool = True) -> list:
    """The input plane of the eval CLIs: --imagenet_val_dir (its ground
    truth written into ``args.labels_json``) wins, else --image_dir /
    --image (BMP files kept with ``skip_bmp=False``, as the uap and certify
    CLIs keep them).  Conflicting flags fail before any device work."""
    val_paths = apply_imagenet_val(args)
    if val_paths is not None:
        return val_paths
    return resolve_image_inputs(args.image_dir, args.image, skip_bmp=skip_bmp)


def cifar10_inputs(args) -> tuple[np.ndarray, np.ndarray, list[str]]:
    """--cifar10_dir: ``(x [N,32,32,3] float32, y [N] int32, names)`` of the
    first ``--cifar10_n`` images of ``--cifar10_split`` (all with 0), named
    ``cifar10_<split>_<i:05d>``; beside --imagenet_val_dir it is refused
    before any device work."""
    from ..core.datasets import load_cifar10

    if getattr(args, "imagenet_val_dir", None):
        # two data planes: refuse rather than run CIFAR-10 silently
        raise SystemExit("pass at most one of --imagenet_val_dir / --cifar10_dir")
    x, y = load_cifar10(args.cifar10_dir, split=args.cifar10_split)
    if int(args.cifar10_n) > 0:
        x, y = x[: int(args.cifar10_n)], y[: int(args.cifar10_n)]
    return x, y, [f"cifar10_{args.cifar10_split}_{i:05d}" for i in range(len(y))]


def require_cifar_model(args, bundle) -> None:
    """--cifar10_dir is 32x32 data: a model of another input size exits."""
    if bundle.input_size != 32:
        raise SystemExit(f"--cifar10_dir is 32x32 data but --model "
                         f"{args.model} expects {bundle.input_size}x"
                         f"{bundle.input_size}; use the CIFAR family "
                         "(wrn28_10/wrn34_10/preact_resnet18)")


def resolve_labels_sentinel(labels_json: str | None, paths):
    """Ground truth with ``UNLABELED`` where the file has no entry, or None
    without a labels file."""
    if not labels_json:
        return None
    return np.asarray(resolve_labels(
        labels_json, paths, np.full(len(paths), UNLABELED, np.int64)))


def resolve_labels(labels_json: str | None, paths, pseudo) -> np.ndarray:
    """Evaluation labels: ground truth from a JSON mapping of image path OR
    basename -> class id when given, else the model's clean predictions.
    Images the file does not name keep their pseudo-label, with a warning."""
    pseudo = np.asarray(pseudo)
    if not labels_json:
        return pseudo
    table = json.loads(Path(labels_json).read_text())
    out = pseudo.copy()
    missing = []
    for i, p in enumerate(paths):
        key, base = str(p), Path(p).name
        if key in table:
            out[i] = int(table[key])
        elif base in table:
            out[i] = int(table[base])
        else:
            missing.append(base)
    if missing:
        print(f"WARNING: no label for {len(missing)} image(s) "
              f"({missing[:3]}{'...' if len(missing) > 3 else ''}); "
              "using pseudo-labels for those")
    return out


@contextlib.contextmanager
def maybe_profile(profile_dir: str | None):
    """With a directory: a torch.profiler trace of the block (CPU, and CUDA
    where a card is present), written there as ``trace.json`` (Chrome trace
    format).  Without one: nothing."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    out = Path(profile_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "trace.json"))
    print(f"Profiler trace: {out / 'trace.json'}")
