"""Total-variation minimization defense (Guo et al., ICLR 2018; port of
``defenses/tv.py``).

Each input is reconstructed as the solution of the (optionally pixel-masked)
ROF problem

    min_z  0.5 * || M (z - x) ||_2^2  +  w * TV(z)

by Chambolle-Pock primal-dual iterations, a static number of them: forward
differences and their negative adjoint (the divergence), and pointwise
proxes.  The JAX package scans the steps; here they are a Python loop.  The
solve runs in float32 and is differentiable end to end: the clamp inside the
dual projection keeps the gradient finite on flat (saturated) regions.

``tv_transform`` is the randomized pixel-dropout variant as a transform of
the EOT wrapper (``attacks/eot.py``): a Bernoulli(keep_prob) mask per pixel,
shared across channels, gates the data term.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.rng import device_generator, uniform

TV_WEIGHT = 0.03   # the paper's lambda_TV
TV_STEPS = 30      # Chambolle-Pock iterations (static; O(1/k) gap)


def _forward_diff(z: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward differences with Neumann boundary on [B,H,W,C]."""
    dy = F.pad(z[:, 1:] - z[:, :-1], (0, 0, 0, 0, 0, 1))
    dx = F.pad(z[:, :, 1:] - z[:, :, :-1], (0, 0, 0, 1))
    return dy, dx


def _divergence(py: torch.Tensor, px: torch.Tensor) -> torch.Tensor:
    """Negative adjoint of ``_forward_diff``: <D z, p> = -<z, div p>."""
    dy = F.pad(py[:, :-1], (0, 0, 0, 0, 0, 1)) - F.pad(py[:, :-1], (0, 0, 0, 0, 1, 0))
    dx = F.pad(px[:, :, :-1], (0, 0, 0, 1)) - F.pad(px[:, :, :-1], (0, 0, 1, 0))
    return dy + dx


def total_variation(x: torch.Tensor) -> torch.Tensor:
    """Isotropic per-image TV value, summed over channels -> [B]."""
    dy, dx = _forward_diff(x)
    return torch.sum(torch.sqrt(dy * dy + dx * dx + 1e-12), dim=(1, 2, 3))


def tv_minimize(x: torch.Tensor, *, weight: float = TV_WEIGHT, steps: int = TV_STEPS,
                mask: torch.Tensor | None = None) -> torch.Tensor:
    """Solve the (masked) ROF problem for a batch ``x [B,H,W,C]``.

    ``mask`` (broadcastable to x, values in {0,1}) selects the pixels the
    data term sees; dropped pixels are inpainted by the TV prior alone.
    ``None`` is the deterministic full-data ROF.  Returns the reconstruction,
    clipped to [0,1], in x's dtype (solved in float32).
    """
    dtype = x.dtype
    if weight <= 0.0:
        # the dual prox divides by w; w <= 0 means no prior, and the data
        # term alone is minimized by x itself
        return torch.clamp(x, 0.0, 1.0)
    x32 = x.to(torch.float32)
    m = (torch.ones_like(x32) if mask is None
         else torch.broadcast_to(mask, x32.shape).to(torch.float32))
    w = torch.tensor(weight, dtype=torch.float32, device=x.device)
    one = torch.ones((), dtype=torch.float32, device=x.device)
    # ||D||^2 <= 8 for the forward-difference stencil; sigma*tau*L^2 = 1
    tau = one / torch.sqrt(torch.tensor(8.0, dtype=torch.float32, device=x.device))
    sigma = tau

    z, zbar = x32, x32
    py = px = torch.zeros_like(x32)
    for _ in range(int(steps)):
        gy, gx = _forward_diff(zbar)
        py, px = py + sigma * gy, px + sigma * gx
        # project each (py, px) onto the radius-w ball.  The clamp keeps the
        # sqrt's gradient finite where py = px = 0 (a flat region): the
        # maximum's gradient goes to the constant there
        nrm = torch.sqrt(torch.maximum(py * py + px * px, torch.full_like(py, 1e-24)))
        scale = one / torch.maximum(one, nrm / w)
        py, px = py * scale, px * scale
        v = z + tau * _divergence(py, px)
        z_new = (v + tau * m * x32) / (one + tau * m)
        z, zbar = z_new, 2.0 * z_new - z
    return torch.clamp(z, 0.0, 1.0).to(dtype)


def rof_energy(z: torch.Tensor, x: torch.Tensor, *, weight: float = TV_WEIGHT,
               mask: torch.Tensor | None = None) -> torch.Tensor:
    """The objective ``tv_minimize`` minimizes, per image -> [B]."""
    m = torch.ones_like(x) if mask is None else torch.broadcast_to(mask, x.shape)
    data = 0.5 * torch.sum(m * (z - x) ** 2, dim=(1, 2, 3))
    return data + weight * total_variation(z)


def draw_keep_mask(shape, keep_prob: float, generator: torch.Generator,
                   device: torch.device | str) -> torch.Tensor:
    """Bernoulli(keep_prob) float32 of ``shape`` on ``device`` (1 = kept)."""
    g = device_generator(generator, device)
    u = uniform(shape, g, device)
    return (u < float(keep_prob)).to(torch.float32)


def tv_transform(weight: float = TV_WEIGHT, steps: int = TV_STEPS, keep_prob: float = 0.5):
    """The randomized (pixel-dropout) TV defense as an EOT transform
    ``(generator, x) -> x'``: per draw a Bernoulli(keep_prob) mask per
    pixel, shared across channels, gates the data term; dropped pixels are
    TV-inpainted.  ``n_samples=1`` in ``make_eot_logits_fn`` is the deployed
    defense; ``n_samples >= 8`` the adaptive expectation attack."""

    def transform(generator, x):
        keep = draw_keep_mask((x.shape[0], x.shape[1], x.shape[2], 1), keep_prob,
                              generator, x.device)
        return tv_minimize(x, weight=weight, steps=steps, mask=keep.to(x.dtype))

    return transform
