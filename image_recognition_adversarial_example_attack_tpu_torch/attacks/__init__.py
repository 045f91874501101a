"""The ported attacks: FGSM and PGD-Linf, behind ``run_attack``."""

from .api import (ATTACK_NAMES, AttackParams, LogitsFn, cross_entropy_sum,
                  input_grad, make_logits_fn, run_attack)
from .fgsm import fgsm_attack
from .pgd import pgd_linf_attack, pgd_step

__all__ = ["ATTACK_NAMES", "AttackParams", "LogitsFn", "cross_entropy_sum",
           "fgsm_attack", "input_grad", "make_logits_fn", "pgd_linf_attack",
           "pgd_step", "run_attack"]
