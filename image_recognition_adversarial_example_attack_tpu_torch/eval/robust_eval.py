"""AutoAttack: worst-case robust accuracy over complementary attacks (Croce &
Hein, ICML 2020; port of ``eval/robust_eval.py``).

- ``autoattack``: the standard composition, APGD-CE, APGD-T (targeted DLR
  over the top-K runner-up classes), FAB-T (minimal-norm, counted only
  inside the eps ball) and Square (gradient-free, past gradient masking);
- ``autoattack_lite``: APGD-CE, Square and in-ball DeepFool, for cheap
  sweeps;
- ``autoattack_rand``: the protocol for randomized defenses, APGD-CE and
  APGD-DLR on EOT gradients and Square, each judged on the expected
  classifier.

Every arm runs on the full batch (as in the JAX package, whose programs
need static shapes); the worst case is picked per sample in protocol
order: the first arm that succeeds.  Each arm's generator is derived from
the caller's in a fixed order (``core.rng.split_generators``), standing in
for JAX's ``split(key, 4)`` / ``split(key, 5)``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..attacks.apgd import apgd_ce_attack, apgd_dlr_attack, apgd_targeted_attack
from ..attacks.api import LogitsFn
from ..attacks.square import square_attack, square_l2_attack
from ..core.rng import split_generators


class RobustEvalResult(NamedTuple):
    x_adv: torch.Tensor        # per-sample worst-case adversarial example
    success: torch.Tensor      # [B] bool: misclassified by any attack
    success_apgd: torch.Tensor
    success_square: torch.Tensor
    success_deepfool: torch.Tensor  # fooled AND the iterate is in the eps ball


def _ball_dist(a: torch.Tensor, b: torch.Tensor, norm: str) -> torch.Tensor:
    if norm == "linf":
        return torch.amax(torch.abs(a - b), dim=(1, 2, 3))
    return torch.sqrt(torch.sum(torch.square(a - b), dim=(1, 2, 3)))


def _fooled(logits_fn: LogitsFn, x_adv: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    with torch.no_grad():
        return torch.argmax(logits_fn(x_adv), dim=-1) != y


def _square(norm: str):
    return square_attack if norm == "linf" else square_l2_attack


def _worst_case(x_first: torch.Tensor, s_first: torch.Tensor, arms):
    """The first successful arm's iterate per sample, in order, else the
    first arm's; and the union of the successes."""
    x_adv, taken = x_first, s_first
    for x_arm, s_arm in arms:
        pick = (~taken) & s_arm
        x_adv = torch.where(pick[:, None, None, None], x_arm, x_adv)
        taken = taken | s_arm
    return x_adv, taken


def autoattack_lite(logits_fn: LogitsFn, x: torch.Tensor, y_true: torch.Tensor, *,
                    eps: float, generator: torch.Generator, apgd_steps: int = 100,
                    square_steps: int = 1000, deepfool_steps: int = 30,
                    norm: str = "linf") -> RobustEvalResult:
    """[B,H,W,C] in [0,1] -> worst-case adversarial batch and success masks.

    Per sample the first successful arm's iterate (APGD, then Square, then
    in-ball DeepFool), else APGD's best-loss iterate.  DeepFool is
    unconstrained minimal-norm, so it counts only inside the eps ball of
    ``norm``.  ``norm='l2'`` takes APGD-L2 and Square-L2."""
    from ..attacks.deepfool import deepfool_attack

    g_apgd, g_square = split_generators(generator, 2)
    x_apgd = apgd_ce_attack(logits_fn, x, y_true, eps=eps, steps=apgd_steps,
                            generator=g_apgd, norm=norm)
    succ_apgd = _fooled(logits_fn, x_apgd, y_true)
    x_square = _square(norm)(logits_fn, x, y_true, eps=eps, steps=square_steps,
                             generator=g_square)
    succ_square = _fooled(logits_fn, x_square, y_true)
    x_df = deepfool_attack(logits_fn, x, steps=deepfool_steps)
    in_ball = _ball_dist(x_df, x, norm) <= eps + 1e-6
    succ_df = _fooled(logits_fn, x_df, y_true) & in_ball

    x_adv, success = _worst_case(x_apgd, succ_apgd, ((x_square, succ_square), (x_df, succ_df)))
    return RobustEvalResult(x_adv=x_adv, success=success, success_apgd=succ_apgd,
                            success_square=succ_square, success_deepfool=succ_df)


class AutoAttackResult(NamedTuple):
    x_adv: torch.Tensor         # per-sample worst-case adversarial example
    success: torch.Tensor       # [B] bool: misclassified by any arm
    success_apgd_ce: torch.Tensor
    success_apgd_t: torch.Tensor
    success_fab: torch.Tensor   # fooled AND the iterate is in the eps ball
    success_square: torch.Tensor


def autoattack(logits_fn: LogitsFn, x: torch.Tensor, y_true: torch.Tensor, *, eps: float,
               generator: torch.Generator, apgd_steps: int = 100, apgd_t_steps: int = 100,
               apgd_t_targets: int = 9, fab_steps: int = 100, fab_targets: int = 9,
               square_steps: int = 5000, norm: str = "linf") -> AutoAttackResult:
    """The standard AutoAttack (APGD-CE -> APGD-T -> FAB-T -> Square), worst
    case per sample, in ``norm`` ('linf' | 'l2').  Success is ``argmax f(x_adv)
    != y_true``; FAB-T's counts only inside the eps ball.  The defaults are
    AutoAttack's (100-step APGD/FAB, 9 targets, 5000 Square queries)."""
    from ..attacks.fab import fab_targeted_attack

    g_ce, g_t, g_fab, g_sq = split_generators(generator, 4)
    x_ce = apgd_ce_attack(logits_fn, x, y_true, eps=eps, steps=apgd_steps, generator=g_ce,
                          norm=norm)
    succ_ce = _fooled(logits_fn, x_ce, y_true)
    x_t, succ_t = apgd_targeted_attack(logits_fn, x, y_true, eps=eps, steps=apgd_t_steps,
                                       n_targets=apgd_t_targets, generator=g_t, norm=norm)
    x_fab = fab_targeted_attack(logits_fn, x, y_true, eps=eps, steps=fab_steps,
                                n_targets=fab_targets, generator=g_fab, norm=norm)
    in_ball = _ball_dist(x_fab, x, norm) <= eps + 1e-6
    succ_fab = _fooled(logits_fn, x_fab, y_true) & in_ball
    x_sq = _square(norm)(logits_fn, x, y_true, eps=eps, steps=square_steps, generator=g_sq)
    succ_sq = _fooled(logits_fn, x_sq, y_true)

    x_adv, success = _worst_case(x_ce, succ_ce, ((x_t, succ_t), (x_fab, succ_fab),
                                                 (x_sq, succ_sq)))
    return AutoAttackResult(x_adv=x_adv, success=success, success_apgd_ce=succ_ce,
                            success_apgd_t=succ_t, success_fab=succ_fab,
                            success_square=succ_sq)


class AutoAttackRandResult(NamedTuple):
    x_adv: torch.Tensor        # per-sample worst-case adversarial example
    success: torch.Tensor      # [B] bool: expected prediction != y_true
    success_apgd_ce: torch.Tensor
    success_apgd_dlr: torch.Tensor
    success_square: torch.Tensor


def autoattack_rand(logits_fn: LogitsFn, x: torch.Tensor, y_true: torch.Tensor, *,
                    eps: float, generator: torch.Generator, eot_samples: int = 20,
                    sigma: float = 0.25, transform=None, eval_samples: int | None = None,
                    apgd_steps: int = 100, square_steps: int = 1000,
                    norm: str = "linf") -> AutoAttackRandResult:
    """AutoAttack's ``rand`` protocol for randomized defenses: APGD-CE and
    APGD-DLR with EOT gradients (``eot_samples`` transform draws a call)
    and Square on the expected prediction.  ``transform`` is the defense's
    randomization (``(generator, x) -> x'``; default: Gaussian noise at
    ``sigma``).  Success is judged on the expected classifier, the argmax
    of the mean softmax over ``eval_samples`` (default ``eot_samples``)
    draws under one fixed wrapper, so every arm is judged alike."""
    from ..attacks.eot import make_eot_logits_fn

    g_wrap, g_ce, g_dlr, g_sq, g_eval = split_generators(generator, 5)
    eot_fn = make_eot_logits_fn(logits_fn, g_wrap, n_samples=int(eot_samples),
                                transform=transform, sigma=sigma)
    eval_fn = make_eot_logits_fn(logits_fn, g_eval, n_samples=int(eval_samples or eot_samples),
                                 transform=transform, sigma=sigma)

    x_ce = apgd_ce_attack(eot_fn, x, y_true, eps=eps, steps=apgd_steps, generator=g_ce,
                          norm=norm)
    succ_ce = _fooled(eval_fn, x_ce, y_true)
    x_dlr = apgd_dlr_attack(eot_fn, x, y_true, eps=eps, steps=apgd_steps, generator=g_dlr,
                            norm=norm)
    succ_dlr = _fooled(eval_fn, x_dlr, y_true)
    # Square queries the expected classifier directly
    x_sq = _square(norm)(eot_fn, x, y_true, eps=eps, steps=square_steps, generator=g_sq)
    succ_sq = _fooled(eval_fn, x_sq, y_true)

    x_adv, success = _worst_case(x_ce, succ_ce, ((x_dlr, succ_dlr), (x_sq, succ_sq)))
    return AutoAttackRandResult(x_adv=x_adv, success=success, success_apgd_ce=succ_ce,
                                success_apgd_dlr=succ_dlr, success_square=succ_sq)


def robust_accuracy(result, clean_correct) -> float:
    """The fraction of clean-correct samples that resist every attack; NaN
    when no sample is clean-correct (0/0: a 0 would read as 'every
    clean-correct sample broke')."""
    cc = torch.as_tensor(clean_correct, dtype=torch.bool).to(result.success.device)
    n = int(cc.sum())
    if n == 0:
        return float("nan")
    return float((cc & ~result.success).sum()) / n
