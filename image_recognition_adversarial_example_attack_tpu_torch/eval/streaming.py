"""Dataset-scale streaming evaluation: a grid cell over more images than fit
one resident batch (port of ``round_up``, ``make_placer``,
``stream_defense_cell``, ``stream_transfer_cell``, ``stream_suite_attack``,
``stream_query_curve_hist``, ``stream_robust_cell``,
``stream_correctness_cell``, ``stream_detector_scores``,
``stream_clean_scores`` and their helpers of ``eval/streaming.py``).

- Fixed-shape chunks come from ``utils.pipeline.EvalBatchPipeline``
  (background decode, a bounded queue: constant host memory).
- Each chunk goes through the cell the one-batch path runs
  (``evaluate_defenses_batch``, or a transfer cell), on the chunk's device
  tensor: chunking changes the memory, never the arithmetic of a sample.
- Only the per-sample vectors come back to the host, in one copy per chunk
  (``x_adv`` stays on the card unless a transfer cell saves it); they are
  masked to the chunk's ``n_valid`` prefix.  Nothing else in the loop waits
  for the card, so the decode of chunk t+1 runs while the card works on
  chunk t.

Deterministic attacks (fgsm, cw, deepfool, ...) give the one-batch counters.  A random
attack (pgd's random start) draws each chunk's noise from
``core.rng.chunk_generator(seed, cell id, step)``: the same distribution
as a whole-batch draw, other numbers.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Sequence

import numpy as np
import torch

from ..core.constants import IMAGE_SIZE
from ..core.device import synchronize, to_device
from ..core.rng import chunk_generator
from ..utils.pipeline import EvalBatchPipeline
from .defense_eval import STAT_KEYS, DefenseEvalConfig, evaluate_defenses_batch
from .transfer import TransferCell

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

    On a card each chunk goes through ``core.device.to_device``: a fresh
    pinned buffer sent with ``non_blocking=True``, so a later chunk never
    overwrites a copy in flight.

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
        return to_device(torch.from_numpy(np.ascontiguousarray(a)), device)

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


def stream_transfer_cell(
    cell_fn: Callable[[torch.Tensor, torch.Generator, float], TransferCell],
    paths: Sequence,
    *,
    seed: int,
    cell_id: str,
    eps: float,
    target_names: Sequence[str],
    chunk_size: int,
    place: Placer,
    size: int = IMAGE_SIZE,
    save_adv: Callable[[np.ndarray, list], None] | None = None,
) -> dict:
    """One (attack, eps) transfer cell over any number of images.

    ``cell_fn(x, generator, eps) -> TransferCell`` is the one-batch cell
    (the source attack and every target's forward); chunk ``step`` draws
    from ``chunk_generator(seed, cell_id, step)``.  Returns the one-batch
    record, ``{"source_success": [..], "transfer_success": {name: [..]}}``,
    per-sample ints over the readable images in order.
    ``save_adv(x_adv_chunk, kept_paths)`` runs on each chunk's valid rows
    when given (the only case in which ``x_adv`` leaves the card).
    """
    paths = list(paths)
    src_parts: list[np.ndarray] = []
    tgt_parts: dict[str, list[np.ndarray]] = {n: [] for n in target_names}
    pipe = EvalBatchPipeline(paths, chunk_size, labels=range(len(paths)), size=size)
    for step, x_np, idx_np, n_valid in pipe:
        cell = cell_fn(place(x_np), chunk_generator(seed, cell_id, step), eps)
        # the chunk's one read of the results: source and targets stacked
        vecs = torch.stack([cell.source_success,
                            *(cell.target_success[n] for n in target_names)]).cpu().numpy()
        src_parts.append(vecs[0, :n_valid])
        for row, name in enumerate(target_names, start=1):
            tgt_parts[name].append(vecs[row, :n_valid])
        if save_adv is not None:
            save_adv(cell.x_adv[:n_valid].cpu().numpy(), [paths[i] for i in idx_np[:n_valid]])
    return {
        "source_success": np.concatenate(src_parts).tolist(),
        "transfer_success": {n: np.concatenate(p).tolist() for n, p in tgt_parts.items()},
    }


def stream_suite_attack(
    attack_fn: Callable[[torch.Tensor, torch.Tensor, torch.Generator], torch.Tensor],
    metrics_fn: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], dict],
    clean_fn: Callable[[torch.Tensor], tuple[torch.Tensor, torch.Tensor]],
    paths: Sequence,
    *,
    seed: int,
    cell_id: str,
    chunk_size: int,
    place: Placer,
    size: int = IMAGE_SIZE,
    labels: Sequence[int] | None = None,
    clean_cache: dict | None = None,
) -> dict:
    """One attack row of the zoo-comparison table (cli/attack_suite.py) over
    any number of images.

    ``attack_fn(x, y, generator) -> x_adv`` is the attack; ``metrics_fn(x,
    x_adv, y)`` returns per-sample vectors (``succ``, ``linf``, ``l2``,
    ``changed``, ``ssim``, ``sq_sum``, ``conf``) whose means, maxima and sums
    on the host give the one-batch row (PSNR from the summed squared error,
    ECE from the confidence and correctness vectors); ``clean_fn(x) ->
    (pred, conf)`` is the clean forward, for the pseudo-labels and the clean
    calibration.  ``clean_cache`` carries the per-chunk clean results over
    the CLI's attacks, so the clean forward runs once per chunk for the
    whole table.  Chunk ``step`` draws from ``chunk_generator(seed,
    cell_id, step)``.

    ``compile_run_s`` is the first chunk's attack call and ``steady_s`` the
    mean of the later chunks' (None with one chunk): host clock around the
    call, ending in a synchronisation of the card.
    """
    _check_cache_sig(clean_cache, paths, chunk_size, size)
    acc: dict[str, list[np.ndarray]] = {
        k: [] for k in ("succ", "linf", "l2", "changed", "ssim", "sq_sum", "conf",
                        "clean_conf", "clean_correct")}
    chunk_times: list[float] = []
    count = 0
    pipe = EvalBatchPipeline(paths, chunk_size, labels=labels, size=size)
    for step, x_np, y_np, n_valid in pipe:
        x = place(x_np)
        if clean_cache is not None and step in clean_cache:
            pred, conf_clean = clean_cache[step]
        else:
            with torch.no_grad():
                pred, conf_clean = clean_fn(x)
            if clean_cache is not None:
                clean_cache[step] = (pred, conf_clean)
        y = _merge_labels(y_np, pred)
        synchronize(x.device)
        t0 = time.perf_counter()
        x_adv = attack_fn(x, y, chunk_generator(seed, cell_id, step))
        synchronize(x.device)
        chunk_times.append(time.perf_counter() - t0)
        with torch.no_grad():
            m = metrics_fn(x, x_adv, y)
        # the chunk's one read from the card: the per-sample vectors
        host = {k: v.cpu().numpy() for k, v in {**m, "clean_conf": conf_clean,
                                                   "clean_correct": pred == y}.items()}
        for k, v in host.items():
            acc[k].append(v[:n_valid])
        count += int(n_valid)
    if count == 0:
        raise SystemExit("no loadable images")
    out: dict = {k: np.concatenate(v) for k, v in acc.items()}
    out["clean_correct"] = out["clean_correct"].astype(np.float32)
    out["count"] = count
    out["compile_run_s"] = chunk_times[0]
    out["steady_s"] = float(np.mean(chunk_times[1:])) if len(chunk_times) > 1 else None
    out["chunk_times_s"] = [float(t) for t in chunk_times]
    return out


def _chunk_labels(x: torch.Tensor, step: int, y_np, pseudo_label_fn,
                  clean_cache: dict | None) -> tuple[torch.Tensor, torch.Tensor]:
    """(pseudo-labels, labels) of one chunk: the clean forward's labels, kept
    in ``clean_cache`` under the chunk's step, and the ground truth with its
    ``-1`` entries replaced by them."""
    if clean_cache is not None and step in clean_cache:
        pseudo = clean_cache[step]
    else:
        with torch.no_grad():
            pseudo = pseudo_label_fn(x)
        if clean_cache is not None:
            clean_cache[step] = pseudo
    return pseudo, _merge_labels(y_np, pseudo)


def stream_query_curve_hist(
    run_fn: Callable[[torch.Tensor, torch.Tensor, torch.Generator], tuple],
    n_steps: int,
    paths: Sequence,
    *,
    seed: int,
    cell_id: str,
    chunk_size: int,
    place: Placer,
    pseudo_label_fn: Callable[[torch.Tensor], torch.Tensor],
    size: int = IMAGE_SIZE,
    labels: Sequence[int] | None = None,
    clean_cache: dict | None = None,
) -> dict:
    """One attack's ASR-vs-queries statistics over any number of images.

    ``run_fn(x, y, generator) -> (x_adv, succ_hist [steps, B])`` is the
    history-emitting attack (``eval.query_curves._runner``).  The curve needs
    two reductions over samples, both streamable
    (``eval.query_curves.history_stats``): the per-step count of samples that
    ever succeeded and each sample's first-success step.  One chunk's history
    is read, reduced and dropped.  ``clean_cache`` carries the per-chunk
    pseudo-labels over the CLI's attacks, so the clean forward runs once per
    chunk for the whole table.  Chunk ``step`` draws from
    ``chunk_generator(seed, cell_id, step)``.
    """
    from .query_curves import history_stats

    _check_cache_sig(clean_cache, paths, chunk_size, size)
    ever_count = np.zeros((int(n_steps),), np.int64)
    firsts: list[np.ndarray] = []
    count = 0
    pipe = EvalBatchPipeline(paths, chunk_size, labels=labels, size=size)
    for step, x_np, y_np, n_valid in pipe:
        x = place(x_np)
        _, y = _chunk_labels(x, step, y_np, pseudo_label_fn, clean_cache)
        _, hist = run_fn(x, y, chunk_generator(seed, cell_id, step))
        # the chunk's one read from the card: its [steps, B] history
        chunk_ever, first = history_stats(hist.cpu().numpy()[:, :n_valid])
        ever_count += chunk_ever
        firsts.append(first)
        count += int(n_valid)
    if count == 0:
        raise SystemExit("no loadable images")
    return {"ever_count": ever_count, "first": np.concatenate(firsts), "count": count}


def stream_robust_cell(
    run_fn: Callable[[torch.Tensor, torch.Tensor, torch.Generator, float], tuple],
    paths: Sequence,
    *,
    seed: int,
    cell_id: str,
    eps: float,
    chunk_size: int,
    place: Placer,
    pseudo_label_fn: Callable[[torch.Tensor], torch.Tensor],
    size: int = IMAGE_SIZE,
    labels: Sequence[int] | None = None,
    clean_cache: dict | None = None,
) -> dict[str, np.ndarray]:
    """One eps of an AutoAttack protocol over any number of images.

    ``run_fn(x, y, generator, eps) -> (success, per-arm successes...)`` is
    the protocol (``cli/robust_eval.py``); ``labels`` are ground-truth ids
    with ``-1`` for "use the pseudo-label".  Returns the concatenated
    vectors ``arm0..armK`` (the protocol's outputs, in order) and
    ``clean_correct``.  ``clean_cache`` carries the per-chunk pseudo-labels
    over the CLI's eps loop.  Chunk ``step`` draws from
    ``chunk_generator(seed, cell_id, step)``.
    """
    _check_cache_sig(clean_cache, paths, chunk_size, size)
    parts: list[np.ndarray] = []
    pipe = EvalBatchPipeline(paths, chunk_size, labels=labels, size=size)
    for step, x_np, y_np, n_valid in pipe:
        x = place(x_np)
        pseudo, y = _chunk_labels(x, step, y_np, pseudo_label_fn, clean_cache)
        outs = run_fn(x, y, chunk_generator(seed, cell_id, step), float(eps))
        # the chunk's one read from the card: the arms and clean_correct
        parts.append(torch.stack([*outs, pseudo == y]).cpu().numpy()[:, :n_valid])
    if not parts:
        return {}
    vecs = np.concatenate(parts, axis=1)
    out = {f"arm{i}": vecs[i] for i in range(vecs.shape[0] - 1)}
    out["clean_correct"] = vecs[-1]
    return out


def stream_correctness_cell(
    run_fn: Callable[[torch.Tensor, torch.Tensor, int, torch.Generator], torch.Tensor],
    paths: Sequence,
    *,
    seed: int,
    cell_id: str,
    severity: int,
    chunk_size: int,
    place: Placer,
    size: int = IMAGE_SIZE,
    pseudo_label_fn: Callable[[torch.Tensor], torch.Tensor] | None = None,
    labels: Sequence[int] | None = None,
) -> dict[str, np.ndarray]:
    """One (corruption, severity) cell of the corruption benchmark over any
    number of images.

    ``run_fn(x, y, severity, generator) -> bool[B]`` is the correctness cell
    (``eval.corruptions.make_corruption_run``).  ``labels`` are ground truth
    with ``-1`` for "use this image's pseudo-label".  Where ``labels`` has
    no ``-1`` (the CLI resolves them in a prelude pass) the per-chunk clean
    forward is skipped: a corruption cell is itself only a corruption and a
    forward, so a pseudo pass would nearly double its time.  Chunk ``step``
    draws from ``chunk_generator(seed, cell_id, step)``.  Returns the
    concatenated ``correct`` vector, and ``clean_correct`` where the pseudo
    pass ran; ``{}`` where no chunk decoded.
    """
    if labels is None and pseudo_label_fn is None:
        raise ValueError("need labels or pseudo_label_fn")
    need_pseudo = labels is None or bool(np.any(np.asarray(labels) < 0))
    if need_pseudo and pseudo_label_fn is None:
        raise ValueError("labels contain the UNLABELED (-1) sentinel but no "
                         "pseudo_label_fn was given to substitute for them")
    parts: list[np.ndarray] = []
    pipe = EvalBatchPipeline(paths, chunk_size, labels=labels, size=size)
    for step, x_np, y_np, n_valid in pipe:
        x = place(x_np)
        if need_pseudo:
            pseudo, y = _chunk_labels(x, step, y_np, pseudo_label_fn, None)
        else:
            y = torch.from_numpy(np.asarray(y_np, np.int64)).to(x.device)
        vecs = [run_fn(x, y, severity, chunk_generator(seed, cell_id, step))]
        if need_pseudo:
            vecs.append(pseudo == y)
        # the chunk's one read from the card: correct (and clean_correct)
        parts.append(torch.stack(vecs).cpu().numpy()[:, :n_valid])
    if not parts:
        return {}
    vecs = np.concatenate(parts, axis=1)
    out = {"correct": vecs[0]}
    if need_pseudo:
        out["clean_correct"] = vecs[1]
    return out


def stream_detector_scores(
    attack_fn: Callable[[torch.Tensor, torch.Tensor, torch.Generator], torch.Tensor],
    score_fns: dict,
    pred_fn: Callable[[torch.Tensor], torch.Tensor],
    paths: Sequence,
    *,
    seed: int,
    cell_id: str,
    chunk_size: int,
    place: Placer,
    size: int = IMAGE_SIZE,
    clean_cache: dict | None = None,
) -> dict:
    """The adversarial side of one attack's detector comparison
    (``cli/detector_eval.py``) over any number of images.

    ``attack_fn(x, y, generator) -> x_adv``; ``score_fns`` maps a detector's
    name to its score function; ``pred_fn(x)`` gives the top-1 labels (the
    chunk's pseudo-labels and the success check).  Only the [B] vectors
    leave the card, in one read per chunk; the ROC arithmetic runs on the
    concatenated vectors (``eval.detector_eval.cell_from_scores``).
    ``clean_cache`` carries the per-chunk pseudo-labels over the CLI's
    attacks.  Chunk ``step`` draws from ``chunk_generator(seed, cell_id,
    step)``.  Returns ``{"adv": {detector: float64 scores}, "succ": bool
    vector, "count": n}``.
    """
    _check_cache_sig(clean_cache, paths, chunk_size, size)
    adv: dict[str, list[np.ndarray]] = {d: [] for d in score_fns}
    succ: list[np.ndarray] = []
    count = 0
    pipe = EvalBatchPipeline(paths, chunk_size, size=size)
    for step, x_np, _y, n_valid in pipe:
        x = place(x_np)
        _, y = _chunk_labels(x, step, None, pred_fn, clean_cache)
        x_adv = attack_fn(x, y, chunk_generator(seed, cell_id, step))
        with torch.no_grad():
            vecs = [(pred_fn(x_adv) != y).to(torch.float64),
                    *(fn(x_adv).to(torch.float64) for fn in score_fns.values())]
        # the chunk's one read from the card: success and every score
        host = torch.stack(vecs).cpu().numpy()[:, :n_valid]
        succ.append(host[0] > 0.5)
        for row, det in enumerate(score_fns, start=1):
            adv[det].append(host[row])
        count += int(n_valid)
    if count == 0:
        raise SystemExit("no loadable images")
    return {"adv": {d: np.concatenate(v) for d, v in adv.items()},
            "succ": np.concatenate(succ), "count": count}


def stream_clean_scores(
    score_fns: dict,
    paths: Sequence,
    *,
    chunk_size: int,
    place: Placer,
    size: int = IMAGE_SIZE,
) -> dict[str, np.ndarray]:
    """Clean detector scores over any number of images (the calibration pass
    of the streamed detector comparison: the thresholds come from quantiles
    over the whole set, as in the one-batch path).  One read per chunk."""
    clean: dict[str, list[np.ndarray]] = {d: [] for d in score_fns}
    pipe = EvalBatchPipeline(paths, chunk_size, size=size)
    for _step, x_np, _y, n_valid in pipe:
        x = place(x_np)
        with torch.no_grad():
            host = torch.stack([fn(x).to(torch.float64) for fn in score_fns.values()])
        host = host.cpu().numpy()[:, :n_valid]
        for row, det in enumerate(score_fns):
            clean[det].append(host[row])
    if not any(clean.values()):
        raise SystemExit("no loadable images")
    return {d: np.concatenate(v) for d, v in clean.items()}
