"""PGD-Linf (port of ``attacks/pgd.py::pgd_linf_attack``).

An optional uniform random start in the eps-ball, then ``steps`` iterations
of ``alpha * sign(grad)`` with projection to ``[x0-eps, x0+eps]`` and a clip
to [0,1].  On a CUDA device the random start is the Philox noise kernel and
each update the pgd_step kernel (``kernels/elementwise.py``); on the CPU
their plain versions run.  The loop is a Python loop of one forward+backward
and one kernel launch per step.
"""

from __future__ import annotations

import torch

from ..kernels import elementwise
from .api import LogitsFn, input_grad

# The plain update (attacks/pgd.py::pgd_step of the JAX package).
pgd_step = elementwise.pgd_step_plain


def pgd_linf_attack(logits_fn: LogitsFn, x: torch.Tensor, y_true: torch.Tensor,
                    *, eps: float, alpha: float, steps: int,
                    generator: torch.Generator, random_start: bool = True,
                    y_target: torch.Tensor | None = None) -> torch.Tensor:
    """[B,H,W,C] in [0,1] -> adversarial batch in [0,1].

    With ``y_target`` each step descends the target class's cross-entropy:
    the kernel gets ``-alpha``, which gives the bits of ``alpha*sign(-g)``
    without a pass that negates the gradient.
    """
    eps, alpha = float(eps), float(alpha)
    x_orig = x.contiguous()
    if random_start:
        noise = elementwise.uniform_noise(x.shape, eps, generator, x.device).to(x.dtype)
        x_adv = torch.clamp(x_orig + noise, 0.0, 1.0)
    else:
        x_adv = x_orig

    y_grad = y_true if y_target is None else y_target
    step = alpha if y_target is None else -alpha
    for _ in range(int(steps)):
        grad = input_grad(logits_fn, x_adv, y_grad).contiguous()
        x_adv = elementwise.pgd_step(x_adv, grad, x_orig, eps, step)
    return x_adv
