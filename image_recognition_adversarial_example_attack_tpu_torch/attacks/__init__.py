"""The ported attacks behind ``run_attack``: FGSM, PGD-Linf, CW-L2 and the
transfer family MI-FGSM, DI-FGSM and TI-FGSM, with their threat models in
``ATTACK_THREAT``; and the detector-aware FGSM/PGD."""

from .api import (ATTACK_NAMES, ATTACK_THREAT, AttackParams, LogitsFn, cross_entropy_sum,
                  input_grad, make_ensemble_logits_fn, make_logits_fn, predict_labels,
                  run_attack)
from .cw import CWResult, cw_l2_attack
from .detector_aware import detector_aware_fgsm, detector_aware_pgd
from .dim import dim_attack, diverse_input
from .fgsm import fgsm_attack
from .mifgsm import mifgsm_attack
from .pgd import pgd_linf_attack, pgd_step
from .tim import tim_attack

__all__ = ["ATTACK_NAMES", "ATTACK_THREAT", "AttackParams", "CWResult", "LogitsFn",
           "cross_entropy_sum", "cw_l2_attack", "detector_aware_fgsm", "detector_aware_pgd",
           "dim_attack", "diverse_input", "fgsm_attack", "input_grad", "make_ensemble_logits_fn",
           "make_logits_fn", "mifgsm_attack", "pgd_linf_attack", "pgd_step", "predict_labels",
           "run_attack", "tim_attack"]
