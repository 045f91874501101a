"""DI-FGSM: diverse-input momentum iterative FGSM (Xie et al., CVPR 2019;
port of ``attacks/dim.py``).

At every step the gradient is taken at a randomly shrunken copy of the
iterate, placed at a random offset on a zero canvas of the original size
(with probability ``p``; otherwise at the iterate itself), then MI-FGSM's
momentum update follows.  Every step launches the pgd_step kernel once on a
CUDA device (``attacks/mifgsm.py``).

The transform is the JAX package's ``jax.image.scale_and_translate(...,
method="linear")``, whose ``antialias`` is on by default: when the copy
shrinks (s < 1) the triangle kernel widens by 1/s.  ``resample_matrix``
builds its weight matrix as JAX does (sample positions ``(i + 0.5)/s - t/s
- 0.5``, kernel scale ``max(1/s, 1)``, columns normalized, samples outside
``[-0.5, n - 0.5]`` zeroed), in float32, one ``[H,H]`` and one ``[W,W]``
matrix per step, applied as two products: the transform stays linear and
differentiable in the iterate.

The step's randomness (``apply``, ``s``, ``tx``, ``ty``) comes from the
caller's generator through ``draw_diversity``, four uniforms per step; its
bits are not JAX's (``core/rng.py``), and a test feeds JAX's draws for a key
through that one function.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.rng import uniform
from .api import LogitsFn
from .mifgsm import momentum_attack, signed_grad


class Diversity(NamedTuple):
    """One step's transform: applied or not, the scale ``s`` and the
    offsets ``tx``, ``ty`` in pixels (float32 values)."""

    apply: bool
    scale: float
    tx: float
    ty: float


def draw_diversity(generator: torch.Generator, height: int, width: int, *,
                   p: float = 0.5, min_scale: float = 0.875) -> Diversity:
    """Four float32 uniforms from ``generator`` (on its device; the port's
    generators live on the CPU, so no card is waited for): ``apply = u0 <
    p``, ``s ~ U[min_scale, 1)``, ``tx = u2 * W(1 - s)``, ``ty = u3 * H(1 - s)``,
    in the JAX package's float32 arithmetic."""
    u = uniform((4,), generator, generator.device, axis=None).cpu()  # one draw for the batch
    s = min_scale + (1.0 - min_scale) * u[1]
    tx = u[2] * (width * (1.0 - s))
    ty = u[3] * (height * (1.0 - s))
    return Diversity(bool(u[0] < p), float(s), float(tx), float(ty))


def _f32(value: float, device) -> torch.Tensor:
    return torch.full((), value, dtype=torch.float32, device=device)


def resample_matrix(n: int, scale: float, translation: float,
                    device: torch.device | str = "cpu") -> torch.Tensor:
    """[n_in, n_out] float32 weights of ``scale_and_translate``'s linear
    (triangle) kernel with antialiasing, input and output both ``n`` long
    (``jax/_src/image/scale.py::compute_weight_mat``, op for op; every
    division is tensor by tensor, so the card divides as IEEE does)."""
    one = _f32(1.0, device)
    inv_scale = one / _f32(scale, device)
    kernel_scale = torch.maximum(inv_scale, one)
    pos = torch.arange(n, dtype=torch.float32, device=device)
    sample_f = (pos + 0.5) * inv_scale - _f32(translation, device) * inv_scale - 0.5
    x = torch.abs(sample_f[None, :] - pos[:, None]) / kernel_scale
    weights = torch.clamp_min(1.0 - torch.abs(x), 0.0)
    total = torch.sum(weights, dim=0, keepdim=True)
    eps32 = float(torch.finfo(torch.float32).eps)
    weights = torch.where(torch.abs(total) > 1000.0 * eps32,
                          weights / torch.where(total != 0, total, one), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= n - 0.5)
    return torch.where(inside[None, :], weights, 0.0)


def diverse_input(x: torch.Tensor, d: Diversity) -> torch.Tensor:
    """[B,H,W,C] -> the step's transform of the batch (the same for every
    image), or ``x`` itself where ``d.apply`` is false."""
    if not d.apply:
        return x
    _, h, w, _ = x.shape
    wh = resample_matrix(h, d.scale, d.ty, x.device).to(x.dtype)
    ww = resample_matrix(w, d.scale, d.tx, x.device).to(x.dtype)
    y = torch.einsum("bhwc,hk->bkwc", x, wh)
    return torch.einsum("bkwc,wl->bklc", y, ww)


def dim_attack(logits_fn: LogitsFn, x: torch.Tensor, y_true: torch.Tensor, *,
               eps: float, alpha: float, steps: int, generator: torch.Generator,
               mu: float = 1.0, diversity_prob: float = 0.5,
               y_target: torch.Tensor | None = None) -> torch.Tensor:
    """[B,H,W,C] in [0,1] -> adversarial batch in [0,1]: the MI-FGSM update
    with the gradient taken through ``diverse_input`` of the iterate each
    step.  ``mu=0`` is plain DI-FGSM; ``diversity_prob=0`` is MI-FGSM."""
    _, h, w, _ = x.shape

    def step_grad(x_adv: torch.Tensor) -> torch.Tensor:
        d = draw_diversity(generator, h, w, p=diversity_prob)
        return signed_grad(lambda z: logits_fn(diverse_input(z, d)), y_true, y_target)(x_adv)

    return momentum_attack(step_grad, x, eps=eps, alpha=alpha, steps=steps, mu=mu)
