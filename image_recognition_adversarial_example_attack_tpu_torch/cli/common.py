"""Shared CLI plumbing (port of the main-path part of ``cli/common.py``):
model/dtype/seed/device flags, bundle loading, top-k printing.

``--device`` defaults to ``cuda``; where CUDA is absent the run fails unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..core.device import resolve_device


def add_model_args(parser: argparse.ArgumentParser, default_model: str = "resnet50") -> None:
    parser.add_argument("--model", type=str, default=default_model,
                        help="model name from the zoo (default: %(default)s)")
    parser.add_argument("--weights", type=str, default=None,
                        help="weights file (torchvision .pth)")
    parser.add_argument("--model-dtype", type=str, default=None,
                        choices=["float32", "bfloat16"],
                        help="compute dtype (default: bfloat16 on CUDA, float32 on CPU)")
    parser.add_argument("--seed", type=int, default=0, help="random seed")
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
