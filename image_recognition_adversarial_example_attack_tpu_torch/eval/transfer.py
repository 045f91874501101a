"""Black-box transferability, batched (port of ``eval/transfer.py``).

Two success conventions, as in the reference and the JAX package:

- ``"blackbox"`` (blackbox_transfer.py): a transfer succeeds when the
  target's label of the adversarial image differs from the target's OWN
  clean label;
- ``"source-label"`` (transferability_attack.py): when it differs from the
  SOURCE model's clean pseudo-label.

The adversarial batch is made once per cell on the source model (one
attack, one generator), then each target takes one batched forward.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple

import torch

from ..attacks.api import AttackParams, LogitsFn, predict_labels, run_attack

CONVENTIONS = ("source-label", "blackbox")


class TransferCell(NamedTuple):
    """One (attack, eps) cell of a transfer sweep; tensors on the device."""

    source_success: torch.Tensor  # [B] int32: the source's adversarial label != its clean one
    target_success: dict[str, torch.Tensor]  # name -> [B] int32
    x_adv: torch.Tensor


def transfer_attack_batch(
    source_logits_fn: LogitsFn,
    target_logits_fns: Mapping[str, LogitsFn],
    x: torch.Tensor,
    attack_name: str,
    params: AttackParams,
    generator: torch.Generator | None = None,
    convention: str = "source-label",
) -> TransferCell:
    """One grid cell: attack the source at its clean labels, then evaluate
    every target on the adversarial batch (see the module docstring for
    ``convention``).  ``generator`` feeds the attack's randomness."""
    if convention not in CONVENTIONS:
        raise ValueError(f"unknown transfer convention '{convention}'")
    y_source = predict_labels(source_logits_fn, x)
    x_adv = run_attack(attack_name, source_logits_fn, x, y_source, params, generator)
    source_success = (predict_labels(source_logits_fn, x_adv) != y_source).int()
    target_success = {}
    for name, tfn in target_logits_fns.items():
        ref = predict_labels(tfn, x) if convention == "blackbox" else y_source
        target_success[name] = (predict_labels(tfn, x_adv) != ref).int()
    return TransferCell(source_success, target_success, x_adv)


def asr(success_vec, n_valid: int | None = None) -> float:
    """Attack-success rate in [0,1] of an int success vector (a tensor, an
    array or a list), over its first ``n_valid`` entries when given."""
    v = torch.as_tensor(success_vec)
    if n_valid is not None:
        v = v[:n_valid]
    return float(v.sum()) / max(1, v.shape[0])
