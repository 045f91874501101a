"""Bandits-TD: black-box attack with time and data priors (Ilyas, Engstrom &
Madry, ICLR 2019; port of ``attacks/bandits.py``).

- time prior: a latent gradient estimate ``v`` is carried across steps and
  nudged by each step's two queries;
- data prior: ``v`` lives on an [B, H/f, W/f, C] lattice, bilinearly
  upsampled into pixel space (f = ``prior_factor``).

Per step: a spherical exploration direction ``u`` in latent space, the CE
loss at the two probes ``x + fd_eta * up(v ± delta*u)`` in one [2B] forward,
an exponentiated-gradients step on ``v`` (kept in (-1, 1)), then the signed
image step ``x += alpha * sign(up(v))`` with the L∞ projection: the pgd_step
wrapper (``kernels/elementwise.py``), one kernel launch a step on a CUDA
device.  2 queries a step.

The latent normals are drawn each step on the device from a generator
seeded once from the caller's (``draw_latent``, the tests' patch point): at
500 steps x 128 x 28x28x3 a draw of them all up front would be 0.6 GB.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core.rng import device_generator, standard_normal
from ..kernels import elementwise
from .api import LogitsFn, per_sample_ce, success_history


def _upsample(v: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Latent [B,h',w',C] -> pixel [B,H,W,C] bilinear (the data prior).

    ``F.interpolate(align_corners=False)`` is ``jax.image.resize(...,
    'bilinear')`` for an upsampling: both give the edge pixel all the
    weight where a source index falls outside (``eval/explain.py::
    upsample_cam``)."""
    out = F.interpolate(v.permute(0, 3, 1, 2), size=(int(height), int(width)),
                        mode="bilinear", align_corners=False, antialias=False)
    return out.permute(0, 2, 3, 1).contiguous()


def _eg_step(v: torch.Tensor, grad: torch.Tensor, lr: float) -> torch.Tensor:
    """Exponentiated-gradients ascent keeping v in (-1, 1): the
    multiplicative-weights update of p = (v+1)/2 as a logit shift of
    ``2*lr*g``, clipped off exactly 0 and 1 (where it would pin)."""
    pos = torch.clamp((v + 1.0) * 0.5, 1e-6, 1.0 - 1e-6)
    z = torch.log(pos) - torch.log1p(-pos) + 2.0 * lr * grad
    pos = torch.clamp(torch.sigmoid(z), 1e-6, 1.0 - 1e-6)
    return 2.0 * pos - 1.0


def draw_latent(shape, generator: torch.Generator, device: torch.device | str) -> torch.Tensor:
    """One step's latent exploration normals, float32 of ``shape``."""
    return standard_normal(shape, generator, device)


def bandits_attack(logits_fn: LogitsFn, x: torch.Tensor, y_true: torch.Tensor, *,
                   eps: float, alpha: float, steps: int, generator: torch.Generator,
                   prior_factor: int = 8, fd_eta: float = 0.1, delta: float = 0.1,
                   prior_lr: float = 1.0, y_target: torch.Tensor | None = None,
                   return_history: bool = False):
    """Bandits-TD in the L∞ ball: [B,H,W,C] in [0,1] -> adversarial batch.

    ``prior_factor`` sets the latent lattice (H/f x W/f); ``fd_eta`` and
    ``delta`` the image and latent exploration radii; ``prior_lr`` the
    exponentiated-gradients rate.  With ``return_history`` also the
    per-step success mask [steps, B] (one more forward a step)."""
    if int(prior_factor) < 1:
        raise ValueError(f"bandits_prior_factor must be >= 1, got {prior_factor}")
    if not (fd_eta > 0.0 and delta > 0.0):
        # est divides by fd_eta*delta: zero would NaN the prior
        raise ValueError(f"bandits_fd_eta and bandits_delta must be > 0, got {fd_eta}/{delta}")
    b, height, width, chans = x.shape
    hp = max(1, height // int(prior_factor))
    wp = max(1, width // int(prior_factor))
    latent_dim = hp * wp * chans
    x_orig = x.contiguous()
    y_grad = y_true if y_target is None else y_target
    y2 = torch.cat([y_grad, y_grad], dim=0)
    # the targeted mode folds its sign into the prior: v tracks the descent
    # direction of the target's CE, so the image step is always +alpha
    direction = 1.0 if y_target is None else -1.0
    g_dev = device_generator(generator, x.device)

    x_adv = x_orig
    v = torch.zeros((b, hp, wp, chans), dtype=x.dtype, device=x.device)
    hist = []
    with torch.no_grad():
        for _ in range(int(steps)):
            u = draw_latent((b, hp, wp, chans), g_dev, x.device).to(x.dtype)
            u = u / math.sqrt(latent_dim)  # spherical scale
            g_plus = _upsample(v + delta * u, height, width)
            g_minus = _upsample(v - delta * u, height, width)
            both = torch.cat([torch.clamp(x_adv + fd_eta * g_plus, 0.0, 1.0),
                              torch.clamp(x_adv + fd_eta * g_minus, 0.0, 1.0)], dim=0)
            losses = per_sample_ce(logits_fn(both), y2)
            # the loss's directional derivative along u, in latent space
            est = (losses[:b] - losses[b:]) / (fd_eta * delta)
            v = _eg_step(v, direction * (est[:, None, None, None] * u), prior_lr)
            x_adv = elementwise.pgd_step(x_adv, _upsample(v, height, width), x_orig,
                                         float(eps), float(alpha))
            if return_history:
                hist.append(torch.argmax(logits_fn(x_adv), dim=-1) != y_true)
    if return_history:
        return x_adv, success_history(hist, x)
    return x_adv
