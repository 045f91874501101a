"""Shared CLI plumbing (port of ``cli/common.py``, the parts the ported
CLIs use): model/dtype/seed/device/profile flags, bundle loading, top-k
printing, image and label inputs, ImageNet-val ground truth, and the grid's
resume fingerprint and per-cell randomness.

``--device`` defaults to ``cuda``; where CUDA is absent the run fails unless
``--device cpu`` is given.
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


def add_model_args(parser: argparse.ArgumentParser, default_model: str = "resnet50") -> None:
    parser.add_argument("--model", type=str, default=default_model,
                        help="model name from the zoo (default: %(default)s)")
    parser.add_argument("--weights", type=str, default=None,
                        help="weights file (.msgpack cache or torchvision .pth)")
    parser.add_argument("--model-dtype", type=str, default=None,
                        choices=["float32", "bfloat16"],
                        help="compute dtype (default: bfloat16 on CUDA, float32 on CPU)")
    parser.add_argument("--seed", type=int, default=0, help="random seed")
    parser.add_argument("--profile-dir", type=str, default=None,
                        help="write a torch.profiler Chrome trace here")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="device to run on (default: %(default)s; the CPU "
                             "only when asked for)")


def resolve_dtype(name: str | None, device: torch.device) -> torch.dtype:
    if name == "float32":
        return torch.float32
    if name == "bfloat16":
        return torch.bfloat16
    # default: bf16 on the card, f32 on the CPU
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def load_bundle(args: argparse.Namespace):
    """Load ``args.model`` honoring the CLI's device/dtype/weights flags
    (``--seed`` drives the attack's randomness, not the weights)."""
    from ..models.zoo import load_model

    device = resolve_device(args.device)
    return load_model(args.model, dtype=resolve_dtype(args.model_dtype, device),
                      weights=args.weights, device=device)


def make_fns(bundle):
    """(logits_fn, features_fn) for a bundle, casting the input to the
    model's compute dtype when it is not float32."""
    from ..attacks.api import make_logits_fn
    from ..defenses.detector import make_features_fn

    input_dtype = bundle.dtype if bundle.dtype != torch.float32 else None
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


def resolve_image_inputs(image_dir: str | None, image: str) -> list:
    """--image_dir / --image: a directory gives its sorted image list (BMP
    files left out, as the reference does), else the single file; missing
    inputs fail before any device work."""
    from ..core.images import list_images

    if image_dir is not None:
        d = Path(image_dir)
        if not d.is_dir():
            raise SystemExit(f"image_dir not found: {d}")
        paths = [p for p in list_images(d) if p.suffix.lower() != ".bmp"]
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
    """The class count: the width of the model's classifier ``fc`` (no
    forward pass)."""
    return int(model.fc.out_features)


# The CLI args each ported attack reads (the run_attack dispatch,
# attacks/api.py).  They scope the resume fingerprint per grid cell:
# changing --cw_steps must not invalidate an fgsm cell.
ATTACK_KNOB_ARGS: dict[str, frozenset] = {
    "fgsm": frozenset(),
    "pgd": frozenset({"steps", "alpha"}),
    "cw": frozenset({"cw_c", "cw_kappa", "cw_steps", "cw_lr"}),
}
_ALL_KNOB_ARGS: frozenset = frozenset().union(*ATTACK_KNOB_ARGS.values())

# Attacks that never read eps: their grid cells are identical across the eps
# sweep, so the grid computes one and reuses it, and their randomness comes
# from an eps-free cell id.
EPS_INDEPENDENT_ATTACKS = ("cw",)


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


# CLI args that change no result
_NOT_FINGERPRINTED = frozenset({"output_dir", "resume", "viz_samples", "profile_dir"})


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
