"""Detector comparison: ROC analysis of the adversarial detectors (port of
``eval/detector_eval.py``).

Per (attack, detector) cell:

  x_adv = attack(x)                          crafted once per attack
  s_clean, s_adv = score(cat[x, x_adv])      one stacked [2B] call
  AUC, TPR@calibrated threshold, TPR@5%FPR   host numpy on the [B] vectors

Only the [2B] score vector leaves the card, in one read; the ROC arithmetic
(``roc_auc``, ``tpr_at_fpr``) is the JAX module's host numpy, copied as it
is: mergesort ranks, ties counted half, the ceil-index threshold.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def roc_auc(scores_clean: np.ndarray, scores_adv: np.ndarray) -> float:
    """Exact rank-based AUC (probability a random adversarial outscores a
    random clean; ties count half) — the Mann-Whitney U statistic."""
    neg = np.asarray(scores_clean, np.float64)
    pos = np.asarray(scores_adv, np.float64)
    if neg.size == 0 or pos.size == 0:
        raise ValueError("need at least one clean and one adversarial score")
    all_scores = np.concatenate([neg, pos])
    order = np.argsort(all_scores, kind="mergesort")
    ranks = np.empty_like(order, np.float64)
    # average ranks over ties (1-indexed)
    sorted_scores = all_scores[order]
    ranks[order] = np.arange(1, all_scores.size + 1)
    i = 0
    while i < sorted_scores.size:
        j = i
        while (j + 1 < sorted_scores.size
               and sorted_scores[j + 1] == sorted_scores[i]):
            j += 1
        if j > i:
            ranks[order[i:j + 1]] = 0.5 * (i + 1 + j + 1)
        i = j + 1
    r_pos = ranks[neg.size:].sum()
    u = r_pos - pos.size * (pos.size + 1) / 2.0
    return float(u / (neg.size * pos.size))


def tpr_at_fpr(scores_clean: np.ndarray, scores_adv: np.ndarray,
               fpr: float = 0.05) -> float:
    """True-positive rate at the threshold giving (at most) the target
    false-positive rate on the clean scores."""
    neg = np.sort(np.asarray(scores_clean, np.float64))
    pos = np.asarray(scores_adv, np.float64)
    # smallest threshold with FPR <= target: the (1-fpr) clean quantile,
    # taken conservatively (ceil index) so the constraint actually holds
    k = int(np.ceil((1.0 - fpr) * neg.size)) - 1
    k = min(max(k, 0), neg.size - 1)
    thr = neg[k]
    return float(np.mean(pos > thr))


@dataclass
class DetectorCellResult:
    detector: str
    attack: str
    auc: float
    tpr_at_threshold: float   # flag rate on adversarials at the
    fpr_at_threshold: float   # calibrated threshold (+ its clean cost)
    tpr_at_fpr05: float       # threshold-free comparison point


def cell_from_scores(s_clean: np.ndarray, s_adv: np.ndarray, threshold: float, *,
                     detector: str, attack: str) -> DetectorCellResult:
    """The ROC cell of raw (clean, adv) score vectors: the host half of
    ``evaluate_detector_cell``, shared with the streamed path
    (``eval.streaming.stream_detector_scores``)."""
    s_clean = np.asarray(s_clean, np.float64)
    s_adv = np.asarray(s_adv, np.float64)
    return DetectorCellResult(
        detector=detector,
        attack=attack,
        auc=roc_auc(s_clean, s_adv),
        tpr_at_threshold=float(np.mean(s_adv > threshold)),
        fpr_at_threshold=float(np.mean(s_clean > threshold)),
        tpr_at_fpr05=tpr_at_fpr(s_clean, s_adv, 0.05),
    )


def evaluate_detector_cell(score_fn, x: torch.Tensor, x_adv: torch.Tensor, threshold: float, *,
                           detector: str, attack: str) -> DetectorCellResult:
    """Scores clean and adversarial in ONE stacked [2B] call (one read from
    the card), then the host ROC."""
    b = x.shape[0]
    with torch.no_grad():
        scores = score_fn(torch.cat([x, x_adv], dim=0))
    scores = scores.cpu().numpy().astype(np.float64)
    return cell_from_scores(scores[:b], scores[b:], threshold, detector=detector, attack=attack)


def summary_table(results: list[DetectorCellResult]) -> str:
    """Fixed-width table, attacks x detectors, one line per cell."""
    lines = [f"{'Attack':<10} {'Detector':<12} {'AUC':>7} "
             f"{'TPR@thr':>8} {'FPR@thr':>8} {'TPR@5%FPR':>10}"]
    for r in results:
        lines.append(
            f"{r.attack:<10} {r.detector:<12} {r.auc:>7.3f} "
            f"{r.tpr_at_threshold:>8.3f} {r.fpr_at_threshold:>8.3f} "
            f"{r.tpr_at_fpr05:>10.3f}")
    return "\n".join(lines)
