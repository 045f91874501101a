"""Loss-landscape slices around an input: the adversarial plane (port of
``eval/landscape.py``).

The per-sample cross-entropy sampled on a 2-D plane through pixel space,
spanned by the ATTACK direction and a random orthogonal direction (Li et
al. 2018): how sharply the loss rises inside the eps-ball.  The whole
grid x grid slice is ONE batched forward of ``grid**2`` points.

The plane is split into a random draw (``draw_direction``, a standard
normal from the caller's generator, whose bits are not JAX's;
``core/rng.py``) and a deterministic construction from that draw
(``plane_from_direction``: Gram-Schmidt, the norms, the degenerate
``x_adv == x`` case), so a test can feed the construction JAX's draw.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..attacks.api import LogitsFn
from ..core.rng import standard_normal


class Plane(NamedTuple):
    """An origin-centered 2-D slice of pixel space."""

    d1: torch.Tensor     # [H,W,C] float32, unit L2 (zero when x_adv == x)
    d2: torch.Tensor     # [H,W,C] float32, unit L2, orthogonal to d1
    scale: torch.Tensor  # float32 scalar: the pixel-space L2 length of one unit


def draw_direction(shape, generator: torch.Generator) -> torch.Tensor:
    """A float32 standard normal of ``shape`` on the generator's device,
    its batch axis 0 (``core.rng.standard_normal``): for a batch of planes
    ``shape`` is ``[B,H,W,C]``, and a shard's ``ShardGenerator`` takes its
    rows of the whole batch's draw."""
    return standard_normal(shape, generator, generator.device)


def plane_from_direction(x: torch.Tensor, x_adv: torch.Tensor, r: torch.Tensor) -> Plane:
    """The plane through ``x`` spanned by the attack direction and ``r``
    made orthogonal to it; coordinate (1, 0) lands exactly on ``x_adv``.

    Where there is no perturbation (a minimal-norm attack that returned the
    clean input) d1 is zero and the scale falls back to 1, so the slice is
    the random line along d2 at unit pixel scale."""
    delta = (x_adv - x).float()
    norm = torch.linalg.vector_norm(delta)
    d1 = delta / torch.clamp_min(norm, 1e-12)
    scale = torch.where(norm > 0.0, norm, torch.ones_like(norm))
    r = r.to(device=x.device, dtype=torch.float32)
    r = r - torch.sum(r * d1) * d1  # Gram-Schmidt against d1
    d2 = r / torch.clamp_min(torch.linalg.vector_norm(r), 1e-12)
    return Plane(d1=d1, d2=d2, scale=scale)


def adversarial_plane(x: torch.Tensor, x_adv: torch.Tensor,
                      generator: torch.Generator) -> Plane:
    """``plane_from_direction`` of a fresh draw: ``x``, ``x_adv`` are single
    images [H,W,C]."""
    return plane_from_direction(x, x_adv, draw_direction(x.shape, generator))


def adversarial_planes(x: torch.Tensor, x_adv: torch.Tensor,
                       generator: torch.Generator) -> list[Plane]:
    """``adversarial_plane`` of each image of a [B,H,W,C] batch, from one
    [B,H,W,C] draw (``draw_direction``): on a sharded batch each shard's
    planes are its rows of the one-device run's."""
    r = draw_direction(x.shape, generator)
    return [plane_from_direction(x[i], x_adv[i], r[i]) for i in range(x.shape[0])]


def loss_landscape(logits_fn: LogitsFn, x: torch.Tensor, y: torch.Tensor | int,
                   plane: Plane, *, span: float = 1.5, grid: int = 21) -> torch.Tensor:
    """Per-sample CE on the plane: [grid, grid] float32.

    Entry [i, j] is the loss at ``x + a_i*scale*d1 + b_j*scale*d2`` with
    ``a, b`` in linspace(-span, span, grid), clipped to the [0,1] image box:
    the clean input sits at the center, the adversarial endpoint at
    (a = 1, b = 0).  ``x`` is one image [H,W,C], ``y`` its label; the grid
    is one batched forward of ``grid**2`` points, with no autograd graph."""
    coords = torch.linspace(-span, span, int(grid), dtype=x.dtype, device=x.device)
    aa, bb = torch.meshgrid(coords, coords, indexing="ij")
    offs = (aa[..., None, None, None] * plane.d1
            + bb[..., None, None, None] * plane.d2) * plane.scale
    pts = torch.clamp(x[None, None] + offs, 0.0, 1.0)  # [G,G,H,W,C]
    with torch.no_grad():
        logp = F.log_softmax(logits_fn(pts.reshape(-1, *x.shape)), dim=-1)
    return (-logp[:, int(y)]).reshape(int(grid), int(grid)).float()
