"""The ported attacks: FGSM, PGD-Linf and CW-L2, behind ``run_attack``, and the
detector-aware FGSM/PGD."""

from .api import (ATTACK_NAMES, AttackParams, LogitsFn, cross_entropy_sum,
                  input_grad, make_ensemble_logits_fn, make_logits_fn, predict_labels,
                  run_attack)
from .cw import CWResult, cw_l2_attack
from .detector_aware import detector_aware_fgsm, detector_aware_pgd
from .fgsm import fgsm_attack
from .pgd import pgd_linf_attack, pgd_step

__all__ = ["ATTACK_NAMES", "AttackParams", "CWResult", "LogitsFn", "cross_entropy_sum",
           "cw_l2_attack", "detector_aware_fgsm", "detector_aware_pgd", "fgsm_attack",
           "input_grad", "make_ensemble_logits_fn", "make_logits_fn", "pgd_linf_attack", "pgd_step",
           "predict_labels", "run_attack"]
