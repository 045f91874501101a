"""Attack trajectories (port of ``eval/trajectory.py``): the probabilities of
a few tracked classes of image 0, and the L2 norm of the perturbation, at
every iterate of an attack.

The reference replays PGD step by step and logs the probability of the
original class and of class 805 (visualized_attacks.py:323-382).  Its loop
records the random start twice and never the final iterate; here, as in the
JAX package, the rows are ``x_start, x_1, ..., x_steps``, one per iterate.
The PGD loop goes through the pgd_step and noise wrappers, so on a card
each step launches the pgd_step kernel and the random start the noise
kernel.  The observations stay on the device until the caller reads them.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from ..attacks.api import LogitsFn, input_grad
from ..kernels import elementwise

# the reference's second tracked class (ImageNet 805, "soccer ball")
REFERENCE_TARGET_CLASS = 805


class Trajectory(NamedTuple):
    probs: torch.Tensor  # [steps+1, n_tracked] probabilities of the tracked classes
    l2: torch.Tensor     # [steps+1] L2 norm of (x_adv - x_orig)
    x_adv: torch.Tensor  # the final adversarial batch


def _tracked(y_true: torch.Tensor, track_classes: Sequence[int], n_classes: int) -> torch.Tensor:
    """The tracked class ids on the labels' device: ``track_classes``, or
    ``(y_true[0], 805)``.  Indexed as JAX indexes ``probs[tracked]``: a
    negative id counts from the end, and an id out of range is clamped to
    the nearest class rather than raising.  So on a model with fewer than
    806 classes (``resnet_tiny`` has 10) class 805 reads the last class, as
    the JAX CLI does."""
    if track_classes:
        ids = torch.tensor(list(track_classes), dtype=torch.int64, device=y_true.device)
    else:
        ids = torch.stack([y_true[0].to(torch.int64),
                           torch.tensor(REFERENCE_TARGET_CLASS, device=y_true.device)])
    ids = torch.where(ids < 0, ids + n_classes, ids)
    return torch.clamp(ids, 0, n_classes - 1)


def _observer(logits_fn: LogitsFn, x_orig: torch.Tensor, y_true: torch.Tensor,
              track_classes: Sequence[int]):
    def observe(x_adv: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        with torch.no_grad():
            probs = torch.softmax(logits_fn(x_adv), dim=-1)[0]
        tracked = _tracked(y_true, track_classes, probs.shape[-1])
        l2 = torch.sqrt(torch.sum(torch.square(x_adv - x_orig)))
        return probs[tracked], l2
    return observe


def _stack(rows) -> tuple[torch.Tensor, torch.Tensor]:
    return torch.stack([p for p, _ in rows]), torch.stack([l2 for _, l2 in rows])


def pgd_trajectory(logits_fn: LogitsFn, x: torch.Tensor, y_true: torch.Tensor, *,
                   eps: float, alpha: float, steps: int, generator: torch.Generator,
                   track_classes: Sequence[int] = (), random_start: bool = True) -> Trajectory:
    """The tracked probabilities of image 0 along a PGD-Linf run (the
    attack of ``attacks.pgd.pgd_linf_attack``, observed after each step)."""
    eps, alpha = float(eps), float(alpha)
    x_orig = x.contiguous()
    if random_start:
        noise = elementwise.uniform_noise(x.shape, eps, generator, x.device).to(x.dtype)
        x_adv = torch.clamp(x_orig + noise, 0.0, 1.0)
    else:
        x_adv = x_orig
    observe = _observer(logits_fn, x_orig, y_true, track_classes)
    rows = [observe(x_adv)]
    for _ in range(int(steps)):
        grad = input_grad(logits_fn, x_adv, y_true).contiguous()
        x_adv = elementwise.pgd_step(x_adv, grad, x_orig, eps, alpha)
        rows.append(observe(x_adv))
    probs, l2 = _stack(rows)
    return Trajectory(probs=probs, l2=l2, x_adv=x_adv)


def fgsm_trajectory(logits_fn: LogitsFn, x: torch.Tensor, y_true: torch.Tensor, *,
                    eps: float, track_classes: Sequence[int] = ()) -> Trajectory:
    """Two rows, the clean image and the FGSM point, in the same layout."""
    from ..attacks.fgsm import fgsm_attack

    observe = _observer(logits_fn, x, y_true, track_classes)
    x_adv = fgsm_attack(logits_fn, x, y_true, eps=eps)
    probs, l2 = _stack([observe(x), observe(x_adv)])
    return Trajectory(probs=probs, l2=l2, x_adv=x_adv)
