"""The learning-rate schedules and the AdamW of the training steps, in place
of optax (``train/adversarial.py::make_lr_schedule`` and ``optax.adamw`` of
the JAX package), held to optax's arithmetic:

- a schedule is evaluated at the update count *before* the update, so the
  first update of a warmup has lr 0, in float32 arithmetic as optax's; a
  plain constant stays a float;
- AdamW is ``scale_by_adam`` (b1 0.9, b2 0.999, eps 1e-8 outside the square
  root, bias corrections ``1 - b**count``), then ``+ wd * p`` on every
  parameter (BatchNorm's scale and bias included), then ``* -lr``;
- ``global_norm`` is ``optax.global_norm``.

The state is functional, as optax's: ``AdamW.update`` returns new tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

_F32 = np.float32  # optax evaluates its schedules in float32
Schedule = Callable[[int], float]


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    """optax.linear_schedule: from ``init_value`` to ``end_value`` over
    ``transition_steps`` updates, then flat; a constant ``init_value`` for
    ``transition_steps <= 0``."""
    if transition_steps <= 0:
        return lambda count: init_value

    def schedule(count: int) -> float:
        c = _F32(min(max(int(count), 0), transition_steps))
        frac = _F32(1) - c / _F32(transition_steps)
        return float(_F32(init_value - end_value) * frac + _F32(end_value))

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int) -> Schedule:
    """optax.cosine_decay_schedule with alpha 0 and exponent 1."""
    if not decay_steps > 0:
        raise ValueError("The cosine_decay_schedule requires positive decay_steps, got"
                         f" decay_steps={decay_steps}.")

    def schedule(count: int) -> float:
        c = _F32(min(float(count), float(decay_steps)))
        cosine = _F32(0.5) * (_F32(1) + np.cos(_F32(np.pi) * c / _F32(decay_steps)))
        return float(_F32(init_value) * cosine)

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int) -> Schedule:
    """optax.warmup_cosine_decay_schedule with end value 0: a linear warmup
    to ``peak_value``, then a cosine decay over ``decay_steps -
    warmup_steps`` updates."""
    warmup = linear_schedule(init_value, peak_value, warmup_steps)
    decay = cosine_decay_schedule(peak_value, decay_steps - warmup_steps)
    return lambda count: warmup(count) if count < warmup_steps else decay(count - warmup_steps)


def make_lr_schedule(config) -> float | Schedule:
    """The scalar or schedule of an ``AdvTrainConfig``, as the JAX package's
    ``make_lr_schedule``: ``constant`` is a float, or a linear warmup from 0
    when ``warmup_steps > 0``; ``cosine`` is the warmup-cosine schedule over
    ``total_steps``."""
    if config.lr_schedule == "constant":
        if config.warmup_steps > 0:
            return linear_schedule(0.0, config.learning_rate, config.warmup_steps)
        return config.learning_rate
    if config.lr_schedule == "cosine":
        if config.total_steps <= 0:
            raise ValueError("lr_schedule='cosine' needs total_steps > 0")
        return warmup_cosine_decay_schedule(0.0, config.learning_rate,
                                            max(0, int(config.warmup_steps)),
                                            int(config.total_steps))
    raise ValueError(f"unknown lr_schedule '{config.lr_schedule}'")


@dataclass
class AdamState:
    """optax's ``ScaleByAdamState``: the update count and the two moments,
    keyed like the parameters."""

    count: int
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]


@dataclass(frozen=True)
class AdamW:
    """``optax.adamw(learning_rate, weight_decay=weight_decay)`` on dicts of
    tensors."""

    learning_rate: float | Schedule
    weight_decay: float = 1e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: dict[str, torch.Tensor]) -> AdamState:
        zeros = {k: torch.zeros_like(v) for k, v in params.items()}
        return AdamState(0, zeros, {k: torch.zeros_like(v) for k, v in params.items()})

    def lr(self, count: int) -> float:
        """The learning rate of the update made at ``count`` previous updates."""
        return self.learning_rate(count) if callable(self.learning_rate) else self.learning_rate

    def update(self, grads: dict[str, torch.Tensor], state: AdamState,
               params: dict[str, torch.Tensor]) -> tuple[dict[str, torch.Tensor], AdamState]:
        """(new params, new state) after one update with ``grads``."""
        keys = list(params)
        g = [grads[k] for k in keys]
        p = [params[k] for k in keys]
        b1, b2 = self.b1, self.b2
        mu = torch._foreach_add(torch._foreach_mul(g, 1 - b1),
                                torch._foreach_mul([state.mu[k] for k in keys], b1))
        nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2),
                                torch._foreach_mul([state.nu[k] for k in keys], b2))
        count = state.count + 1
        mu_hat = torch._foreach_div(mu, 1 - b1 ** count)
        nu_hat = torch._foreach_div(nu, 1 - b2 ** count)
        u = torch._foreach_div(mu_hat, torch._foreach_add(torch._foreach_sqrt(nu_hat), self.eps))
        u = torch._foreach_add(u, torch._foreach_mul(p, self.weight_decay))
        u = torch._foreach_mul(u, -self.lr(state.count))
        new_p = torch._foreach_add(p, u)
        return (dict(zip(keys, new_p)),
                AdamState(count, dict(zip(keys, mu)), dict(zip(keys, nu))))


def global_norm(tree: dict[str, torch.Tensor]) -> torch.Tensor:
    """optax.global_norm: the L2 norm of all the leaves together."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tree.values()))
