"""Dataset-scale streaming evaluation: a grid cell over more images than fit
one resident batch (port of ``round_up``, ``make_placer``,
``stream_defense_cell`` and their helpers of ``eval/streaming.py``).

- Fixed-shape chunks come from ``utils.pipeline.EvalBatchPipeline``
  (background decode, a bounded queue: constant host memory).
- Each chunk goes through ``evaluate_defenses_batch``, the cell the
  one-batch path runs, on the chunk's device tensor: chunking changes the
  memory, never the arithmetic of a sample.
- Only the six per-sample counter vectors come back to the host, in one
  copy per chunk (``x_adv`` stays on the card); they are masked to the
  chunk's ``n_valid`` prefix and summed.  Nothing else in the loop waits for
  the card, so the decode of chunk t+1 runs while the card works on chunk t.

Deterministic attacks (fgsm, cw) give the one-batch counters.  A random
attack (pgd's random start) draws each chunk's noise from
``core.rng.chunk_generator(seed, cell id, step)``: the same distribution
as a whole-batch draw, other numbers.

The other ``stream_*`` functions of the JAX module come with the CLIs that
call them.
"""

from __future__ import annotations

import os
from typing import Callable, Sequence

import numpy as np
import torch

from ..core.constants import IMAGE_SIZE
from ..core.rng import chunk_generator
from ..utils.pipeline import EvalBatchPipeline
from .defense_eval import STAT_KEYS, DefenseEvalConfig, evaluate_defenses_batch

Placer = Callable[[np.ndarray], torch.Tensor]


def round_up(n: int, multiple: int) -> int:
    """Smallest multiple of ``multiple`` that is >= n."""
    multiple = max(1, int(multiple))
    return -(-int(n) // multiple) * multiple


def _check_cache_sig(clean_cache: dict | None, paths, chunk_size: int, size: int) -> None:
    """A ``clean_cache`` holds per-chunk pseudo-labels keyed by step, valid
    for one chunking of one path list only.  It records that chunking under
    ``"__sig__"`` on first use and raises on a reuse under another."""
    if clean_cache is None:
        return
    sig = (len(paths), int(chunk_size), int(size), hash(tuple(str(p) for p in paths)))
    prior = clean_cache.setdefault("__sig__", sig)
    if prior != sig:
        raise ValueError(
            f"clean_cache was built for (n_paths, chunk_size, size, paths_hash)={prior} "
            f"but this call streams {sig} — pass a fresh dict")


def _merge_labels(y_np: np.ndarray | None, pseudo: torch.Tensor) -> torch.Tensor:
    """Per-chunk labels: ``None`` -> the pseudo-labels; entries of ``-1``
    (unlabeled) -> that image's pseudo-label."""
    if y_np is None:
        return pseudo
    y = torch.from_numpy(np.asarray(y_np, np.int64)).to(pseudo.device)
    return torch.where(y < 0, pseudo, y)


def make_placer(device: torch.device | str, transfer_uint8: bool | None = None) -> Placer:
    """host chunk (numpy float32 NHWC) -> float32 tensor on ``device``.

    On a card each chunk is copied into a fresh pinned buffer and sent with
    ``non_blocking=True``.  The buffer comes from PyTorch's pinned-memory
    cache, which hands it out again only once the copy reading it has
    finished, so a later chunk never overwrites a copy in flight.

    ``transfer_uint8`` (default: the ``ADV_TPU_TRANSFER_UINT8`` environment
    variable, on only for ``1``/``on``/``true``) ships ``round(x*255)`` as
    uint8, a quarter of the bytes, and divides by 255 on the device.  Pixels
    come back on the 1/255 grid, which a PNG or JPEG decode already is.
    """
    device = torch.device(device)
    if transfer_uint8 is None:
        transfer_uint8 = os.environ.get("ADV_TPU_TRANSFER_UINT8", "").lower() in (
            "1", "on", "true")

    def put(a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == "cpu":
            return t
        return t.pin_memory().to(device, non_blocking=True)

    if not transfer_uint8:
        return put

    # a 0-d tensor on the device: PyTorch divides by a Python scalar (or a
    # CPU scalar) as a product with its reciprocal, which can differ in the
    # last bit from a division
    scale = torch.tensor(255.0, dtype=torch.float32, device=device)

    def place(x_np: np.ndarray) -> torch.Tensor:
        u8 = np.clip(np.round(np.asarray(x_np, np.float32) * 255.0), 0, 255).astype(np.uint8)
        return put(u8).to(torch.float32) / scale

    return place


def stream_defense_cell(
    logits_fn,
    features_fn,
    config: DefenseEvalConfig,
    paths: Sequence,
    threshold: float,
    *,
    seed: int,
    cell_id: str,
    eps: float,
    chunk_size: int,
    place: Placer,
    size: int = IMAGE_SIZE,
    pseudo_label_fn: Callable[[torch.Tensor], torch.Tensor] | None = None,
    labels: Sequence[int] | None = None,
    clean_cache: dict | None = None,
) -> dict[str, int]:
    """One (attack, eps) defense grid cell over any number of images.

    Labels default to per-chunk pseudo-labels from ``pseudo_label_fn`` (the
    model's clean predictions); ``labels`` entries of ``-1`` take the
    image's pseudo-label.  ``clean_cache`` carries the per-chunk
    pseudo-labels (device tensors) across the CLI's attack x eps grid, so
    the clean forward for the labels runs once per chunk in all; it is
    guarded by ``_check_cache_sig``.  Chunk ``step`` draws its randomness
    from ``chunk_generator(seed, cell_id, step)``.  Returns the six summed
    counters plus ``count``.
    """
    if labels is None and pseudo_label_fn is None:
        raise ValueError("need labels or pseudo_label_fn")
    _check_cache_sig(clean_cache, paths, chunk_size, size)
    if pseudo_label_fn is None and labels is not None and np.any(np.asarray(labels) < 0):
        raise ValueError("labels contain the UNLABELED (-1) sentinel but no "
                         "pseudo_label_fn was given to substitute for them")
    totals = np.zeros(len(STAT_KEYS), np.int64)
    count = 0
    pipe = EvalBatchPipeline(paths, chunk_size, labels=labels, size=size)
    for step, x_np, y_np, n_valid in pipe:
        x = place(x_np)
        if y_np is not None and not (pseudo_label_fn is not None and np.any(y_np < 0)):
            y = torch.from_numpy(np.asarray(y_np, np.int64)).to(x.device)
        else:
            if clean_cache is not None and step in clean_cache:
                pseudo = clean_cache[step]
            else:
                with torch.no_grad():
                    pseudo = pseudo_label_fn(x)
                if clean_cache is not None:
                    clean_cache[step] = pseudo
            y = _merge_labels(y_np, pseudo)
        out = evaluate_defenses_batch(logits_fn, features_fn, x, y, threshold, config,
                                      chunk_generator(seed, cell_id, step), eps_override=eps)
        # the chunk's one read from the card: the counter vectors
        vecs = torch.stack([out[k] for k in STAT_KEYS]).cpu().numpy()
        totals += vecs[:, :n_valid].sum(axis=1)
        count += int(n_valid)
    stats = {k: int(v) for k, v in zip(STAT_KEYS, totals)}
    stats["count"] = count
    return stats
