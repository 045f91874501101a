"""The attack -> defend -> detect evaluation cell (port of
``eval/defense_eval.py``).

Per sample: clean prediction -> attack -> adversarial prediction
(attack_success = pred_adv != y_true) -> preprocessing defense -> defended
prediction (recovery = pred_def == y_true) -> detector on the adversarial and
the clean batch -> bypass = attack_success AND not flagged.  The whole batch
goes through each stage at once.

Two options change the attacker, not the counters: ``adaptive`` attacks
``logits_fn(defend_input(x))``, so the gradient crosses the defense chain
(the straight-through quantization, the differentiable DCT codec, TV, or
BPDA around the host codec); ``detector_aware`` (fgsm and pgd) ascends
``CE - lam * relu(score - margin * threshold)`` against the cell's detector.

The JAX package's ``make_defense_eval_fn_split_jpeg`` keeps a multi-chip
mesh around the host codec; on one card the cell below runs the codec in
place, so it has no counterpart.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields, replace
from typing import Any

import torch

from ..attacks.api import AttackParams, LogitsFn, predict_labels, run_attack
from ..core.constants import DEFAULT_CW_KAPPA
from ..core.rng import generator_from_seed
from ..defenses.detector import FeaturesFn, score_from_features, squeezing_score
from ..defenses.mahalanobis import mahalanobis_score
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
    """Configuration of one grid cell, with the JAX config's attack fields
    (``cw_*``, ``square_steps`` and the extended attacks' budgets)."""

    attack_name: str
    eps: float
    alpha: float
    steps: int
    cw_c: float = 1.0
    cw_kappa: float = DEFAULT_CW_KAPPA
    cw_steps: int = 100
    cw_lr: float = 0.01
    square_steps: int = 1000
    deepfool_steps: int = 50
    deepfool_classes: int = 10
    deepfool_overshoot: float = 0.02
    est_samples: int = 32
    nes_sigma: float = 1e-3
    spsa_delta: float = 1e-2
    bandits_steps: int = 500
    bandits_prior_factor: int = 8
    bandits_fd_eta: float = 0.1
    bandits_delta: float = 0.1
    bandits_prior_lr: float = 1.0
    hsja_steps: int = 10
    hsja_probes: int = 32
    ead_beta: float = 1e-3
    ead_c: float = 50.0
    ead_lr: float = 0.05
    stadv_steps: int = 200
    stadv_lr: float = 0.01
    stadv_tau: float = 0.05
    boundary_steps: int = 500
    boundary_spherical_step: float = 0.01
    boundary_source_step: float = 0.01
    simba_steps: int = 1000
    simba_eps: float = 0.2
    simba_mode: str = "dct"
    jsma_steps: int = 100
    jsma_theta: float = 1.0
    l1_sparsity: float = 0.01
    spatial_max_rot: float = 30.0
    spatial_max_trans: float = 0.1
    spatial_candidates: int = 10
    spatial_grid_rot: int = 0
    spatial_grid_trans: int = 0
    # 'feature' (stage-3 statistics) | 'squeezing' | 'mahalanobis'
    detector: str = "feature"
    # fitted state of a parametric detector (MahalanobisParams): tensors,
    # so left out of the comparison
    detector_params: Any = field(default=None, compare=False)
    defense: DefenseConfig = DefenseConfig()
    # attack logits_fn(defend_input(x)) instead of the raw model
    adaptive: bool = False
    # the attacker also knows the detector (fgsm/pgd only)
    detector_aware: bool = False
    detector_lam: float = 1.0
    detector_margin: float = 0.9

    def attack_params(self) -> AttackParams:
        """The cell's AttackParams: every attack field of the config (as the
        JAX config's, ``n_target_classes`` and ``mu`` keep their defaults)."""
        return AttackParams(eps=self.eps, alpha=self.alpha, steps=self.steps,
                            **{f: getattr(self, f) for f in _ATTACK_FIELDS})


# the config's fields that AttackParams takes as they are
_ATTACK_FIELDS = tuple(f.name for f in fields(DefenseEvalConfig)
                       if f.name in AttackParams.__dataclass_fields__
                       and f.name not in ("eps", "alpha", "steps"))


def make_detector_score_fn(logits_fn: LogitsFn, features_fn: FeaturesFn,
                           config: DefenseEvalConfig):
    """x -> [B] detector score, per ``config.detector``."""
    if config.detector == "squeezing":
        return lambda xx: squeezing_score(logits_fn, xx, config.defense.quant_levels)
    if config.detector == "mahalanobis":
        if config.detector_params is None:
            raise ValueError(
                "detector='mahalanobis' needs fitted detector_params "
                "(defenses.mahalanobis.calibrate_mahalanobis)")
        return lambda xx: mahalanobis_score(features_fn, xx, config.detector_params)
    if config.detector != "feature":
        raise ValueError(f"unknown detector '{config.detector}'")
    return lambda xx: score_from_features(features_fn(xx))


def _attack(attack_target_fn: LogitsFn, logits_fn: LogitsFn, features_fn: FeaturesFn,
            x: torch.Tensor, y_true: torch.Tensor, threshold: float,
            config: DefenseEvalConfig, params: AttackParams,
            generator: torch.Generator | None) -> torch.Tensor:
    if not config.detector_aware:
        return run_attack(config.attack_name, attack_target_fn, x, y_true, params, generator)
    if config.attack_name not in ("fgsm", "pgd"):
        raise ValueError(
            "detector_aware evaluation needs a gradient attack with a CE "
            f"objective (fgsm|pgd), got '{config.attack_name}'")
    from ..attacks.detector_aware import detector_aware_fgsm, detector_aware_pgd

    score_fn = make_detector_score_fn(logits_fn, features_fn, config)
    aware = {"threshold": threshold, "lam": config.detector_lam,
             "margin": config.detector_margin}
    if config.attack_name == "fgsm":
        return detector_aware_fgsm(attack_target_fn, score_fn, x, y_true,
                                   eps=params.eps, **aware)
    if generator is None:
        generator = generator_from_seed(0)
    return detector_aware_pgd(attack_target_fn, score_fn, x, y_true, eps=params.eps,
                              alpha=params.alpha, steps=params.steps,
                              generator=generator, **aware)


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
    argument, so an eps sweep reuses the same kernels.  The threshold is
    compared as a float32 value, as in the JAX package.
    """
    thr = float(detector_threshold)
    threshold = torch.tensor(thr, dtype=torch.float32, device=x.device)
    params = config.attack_params()
    if eps_override is not None:
        params = replace(params, eps=float(eps_override))

    pred_clean = predict_labels(logits_fn, x)
    clean_correct = (pred_clean == y_true).int()

    if config.adaptive:
        def attack_target_fn(xx):
            return logits_fn(defend_input(xx, config.defense))
    else:
        attack_target_fn = logits_fn
    x_adv = _attack(attack_target_fn, logits_fn, features_fn, x, y_true, thr,
                    config, params, generator)
    pred_adv = predict_labels(logits_fn, x_adv)
    attack_success = (pred_adv != y_true).int()

    x_def = defend_input(x_adv, config.defense)
    pred_def = predict_labels(logits_fn, x_def)
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
