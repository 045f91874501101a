"""Attack dispatch and the model-adapter closure (port of ``attacks/api.py``).

Every attack is a function of ``(logits_fn, x01, y, params)`` where
``logits_fn(x01) -> [B, K] float32`` hides the model, its compute dtype and
the ImageNet normalization; ``x01`` is an NHWC float32 batch in [0,1].
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from ..core.constants import DEFAULT_ALPHA, DEFAULT_EPS, DEFAULT_STEPS
from ..core.normalize import normalize_batch
from ..core.rng import generator_from_seed

LogitsFn = Callable[[torch.Tensor], torch.Tensor]


def make_logits_fn(model: nn.Module, mean, std,
                   input_dtype: torch.dtype | None = None,
                   method: str | None = None) -> LogitsFn:
    """Builds ``x01 [B,H,W,C] in [0,1] -> logits [B,K] float32``.

    The input is cast to ``input_dtype`` before it is normalized, as the JAX
    package does, so the normalize and the model compute in bfloat16 while
    the attack state stays float32.  The NHWC batch reaches the model as
    ``permute(0, 3, 1, 2)``: on a contiguous NHWC tensor that is a
    channels_last NCHW view, cuDNN's preferred layout.  ``method`` names
    another method of the model (e.g. ``"features_stage3"``) to run instead
    of ``forward``.
    """
    fn = model if method is None else getattr(model, method)

    def logits_fn(x01: torch.Tensor) -> torch.Tensor:
        x = x01 if input_dtype is None else x01.to(input_dtype)
        x = normalize_batch(x, mean, std)
        return fn(x.permute(0, 3, 1, 2)).float()

    return logits_fn


def cross_entropy_sum(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Softmax cross-entropy SUMMED over the batch (not averaged): the 1/B
    factor is invariant under sign() and keeps per-sample gradients apart."""
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(-1, y[:, None].long())[:, 0].sum()


def input_grad(logits_fn: LogitsFn, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """d(CE)/dx only. With the model's parameters frozen, autograd records
    only the input-gradient chain."""
    xg = x.detach().requires_grad_(True)
    with torch.enable_grad():
        loss = cross_entropy_sum(logits_fn(xg), y)
        (grad,) = torch.autograd.grad(loss, xg)
    return grad


@dataclass(frozen=True)
class AttackParams:
    """The parameters that the ported attacks (fgsm, pgd) read."""

    eps: float = DEFAULT_EPS
    alpha: float = DEFAULT_ALPHA
    steps: int = DEFAULT_STEPS
    random_start: bool = True


def _run_fgsm(logits_fn, x, y_true, params, generator, y_target):
    from .fgsm import fgsm_attack

    return fgsm_attack(logits_fn, x, y_true, eps=params.eps, y_target=y_target)


def _run_pgd(logits_fn, x, y_true, params, generator, y_target):
    from .pgd import pgd_linf_attack

    return pgd_linf_attack(
        logits_fn, x, y_true, eps=params.eps, alpha=params.alpha,
        steps=params.steps, generator=generator,
        random_start=params.random_start, y_target=y_target)


_DISPATCH = {"fgsm": _run_fgsm, "pgd": _run_pgd}
ATTACK_NAMES: tuple[str, ...] = tuple(_DISPATCH)


def run_attack(attack_name: str, logits_fn: LogitsFn, x: torch.Tensor,
               y_true: torch.Tensor, params: AttackParams,
               generator: torch.Generator | None = None,
               y_target: torch.Tensor | None = None) -> torch.Tensor:
    """'fgsm' | 'pgd' -> x_adv in [0,1]. ``y_target`` selects the targeted
    mode. ``generator`` feeds the random start (default: seed 0)."""
    handler = _DISPATCH.get(attack_name)
    if handler is None:
        raise ValueError(f"attack '{attack_name}' is not ported yet "
                         f"(ported: {', '.join(ATTACK_NAMES)})")
    if generator is None:
        generator = generator_from_seed(0)
    return handler(logits_fn, x, y_true, params, generator, y_target)
