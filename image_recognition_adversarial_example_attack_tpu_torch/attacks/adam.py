"""optax's Adam, written out for the port's optimizing attacks (CW-L2 on
``w``, stAdv on the flow field).

One step of ``optax.adam(lr, b1=0.9, b2=0.999, eps=1e-8)`` in optax's order:
the first and second moments, their bias corrections at step ``t``, then
``param + (-lr) * mu_hat / (sqrt(nu_hat) + eps)``.
"""

from __future__ import annotations

import torch

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def adam_update(param: torch.Tensor, grad: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                t: int, lr: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Step ``t`` (1-based) of Adam: ``(param, m, v)`` after the update."""
    m = ADAM_B1 * m + (1.0 - ADAM_B1) * grad
    v = ADAM_B2 * v + (1.0 - ADAM_B2) * grad * grad
    m_hat = m / (1.0 - ADAM_B1 ** t)
    v_hat = v / (1.0 - ADAM_B2 ** t)
    return param + (-lr) * (m_hat / (torch.sqrt(v_hat) + ADAM_EPS)), m, v
