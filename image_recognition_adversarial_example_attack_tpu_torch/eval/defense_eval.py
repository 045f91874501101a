"""The attack -> defend -> detect evaluation cell (port of
``eval/defense_eval.py``).

Per sample: clean prediction -> attack -> adversarial prediction
(attack_success = pred_adv != y_true) -> preprocessing defense -> defended
prediction (recovery = pred_def == y_true) -> detector on the adversarial and
the clean batch -> bypass = attack_success AND not flagged.  The whole batch
goes through each stage at once.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any

import torch

from ..attacks.api import AttackParams, LogitsFn, run_attack
from ..defenses.detector import FeaturesFn, score_from_features
from ..defenses.preprocess import DefenseConfig, defend_input

STAT_KEYS = (
    "clean_correct",
    "attack_success",
    "defense_preproc_success",
    "detector_flags_clean",
    "detector_flags_adv",
    "detector_attack_success",
)


@dataclass(frozen=True)
class DefenseEvalConfig:
    """Configuration of one grid cell: the fields the ported path reads."""

    attack_name: str
    eps: float
    alpha: float
    steps: int
    detector: str = "feature"
    defense: DefenseConfig = DefenseConfig()
    adaptive: bool = False
    detector_aware: bool = False

    def attack_params(self) -> AttackParams:
        return AttackParams(eps=self.eps, alpha=self.alpha, steps=self.steps)


def make_detector_score_fn(logits_fn: LogitsFn, features_fn: FeaturesFn,
                           config: DefenseEvalConfig):
    """x -> [B] detector score. Only the 'feature' detector is ported."""
    if config.detector != "feature":
        raise NotImplementedError(f"detector '{config.detector}' is not ported yet")
    return lambda xx: score_from_features(features_fn(xx))


def _argmax(logits_fn: LogitsFn, x: torch.Tensor) -> torch.Tensor:
    with torch.no_grad():
        return torch.argmax(logits_fn(x), dim=-1)


def evaluate_defenses_batch(
    logits_fn: LogitsFn,
    features_fn: FeaturesFn,
    x: torch.Tensor,
    y_true: torch.Tensor,
    detector_threshold: float,
    config: DefenseEvalConfig,
    generator: torch.Generator | None = None,
    eps_override: float | None = None,
) -> dict[str, torch.Tensor]:
    """Per-sample int32 vectors of the six counters, plus ``"x_adv"``.

    ``eps_override`` replaces ``config.eps`` at run time: eps is a kernel
    argument, so an eps sweep reuses the same kernels.
    """
    if config.adaptive:
        raise NotImplementedError("adaptive evaluation is not ported yet")
    if config.detector_aware:
        raise NotImplementedError("detector-aware evaluation is not ported yet")
    threshold = float(detector_threshold)
    params = config.attack_params()
    if eps_override is not None:
        params = replace(params, eps=float(eps_override))

    pred_clean = _argmax(logits_fn, x)
    clean_correct = (pred_clean == y_true).int()

    x_adv = run_attack(config.attack_name, logits_fn, x, y_true, params, generator)
    pred_adv = _argmax(logits_fn, x_adv)
    attack_success = (pred_adv != y_true).int()

    x_def = defend_input(x_adv, config.defense)
    pred_def = _argmax(logits_fn, x_def)
    defense_preproc_success = (pred_def == y_true).int()

    score_fn = make_detector_score_fn(logits_fn, features_fn, config)
    with torch.no_grad():
        score_adv = score_fn(x_adv)
        score_clean = score_fn(x)
    detector_flags_adv = (score_adv > threshold).int()
    detector_flags_clean = (score_clean > threshold).int()

    detector_attack_success = attack_success * (1 - detector_flags_adv)

    return {
        "clean_correct": clean_correct,
        "attack_success": attack_success,
        "defense_preproc_success": defense_preproc_success,
        "detector_flags_clean": detector_flags_clean,
        "detector_flags_adv": detector_flags_adv,
        "detector_attack_success": detector_attack_success,
        "x_adv": x_adv,
    }


def aggregate_stats(per_sample: dict[str, Any]) -> dict[str, int]:
    """Per-sample vectors -> summed counters (+ count), host ints."""
    vecs = [torch.as_tensor(per_sample[k]) for k in STAT_KEYS]
    count = int(vecs[0].shape[0])
    sums = torch.stack([v.sum() for v in vecs]).tolist()  # one transfer
    out = {k: int(v) for k, v in zip(STAT_KEYS, sums)}
    out["count"] = count
    return out


def summary_line(attack_name: str, eps: float, stats: dict[str, int]) -> str:
    """The reference's exact console format, byte for byte."""
    count = max(1, stats["count"])
    return (
        f"attack={attack_name}, eps={eps:.5f}, "
        f"attack_success={stats['attack_success'] / count:.3f}, "
        f"preproc_defense_acc={stats['defense_preproc_success'] / count:.3f}, "
        f"detector_clean_pass_rate={1.0 - stats['detector_flags_clean'] / count:.3f}, "
        f"detector_adv_flag_rate={stats['detector_flags_adv'] / count:.3f}, "
        f"detector_attack_success={stats['detector_attack_success'] / count:.3f}"
    )
