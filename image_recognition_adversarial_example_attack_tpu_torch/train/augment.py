"""Seeded batch augmentation for (adversarial) training (port of
``train/augment.py``): the CIFAR recipe's 4-pixel-pad random crop and
horizontal flip (Madry et al. 2018), and Cutout (DeVries & Taylor 2017).

The draws are one function, ``draw_augment``: per-sample crop offsets
``[B,2]``, flip coins ``[B]`` and cutout centres ``[B]``, ``[B]``, drawn on
the CPU from a generator and moved to the batch's device.  The transforms
are index arithmetic on the device (a gather for the crop, a select for the
flip, a mask for the cutout), so on the same draws they equal the JAX
package's bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.rng import ShardGenerator, whole_batch_draw


@dataclass(frozen=True)
class AugmentConfig:
    """The augmentation policy.

    pad:    >0 zero-pads H and W by ``pad``, then crops back to the original
            size at a per-sample offset in [0, 2*pad] (torchvision's
            ``RandomCrop(size, padding=pad)``).
    flip:   per-sample horizontal flip with probability 0.5.
    cutout: >0 zeroes one ``cutout`` x ``cutout`` square per image, its
            centre uniform over the image, clipped at the borders.
    """

    pad: int = 0
    flip: bool = False
    cutout: int = 0

    @property
    def enabled(self) -> bool:
        return self.pad > 0 or self.flip or self.cutout > 0


def draw_augment(shape, pad: int, generator: torch.Generator, device: torch.device | str):
    """One batch's draws for a ``[B,H,W,C]`` batch: ``(offsets [B,2] in
    [0, 2*pad], coins [B] bool, cy [B] in [0,H), cx [B] in [0,W))``, int64
    on ``device``."""
    if isinstance(generator, ShardGenerator):  # this shard's rows of the whole batch's draws
        whole = whole_batch_draw(generator, lambda p: draw_augment(
            (generator.shared.rows, *tuple(shape)[1:]), pad, p, "cpu"))
        return tuple(t[generator.lo:generator.hi].to(device) for t in whole)
    b, h, w = int(shape[0]), int(shape[1]), int(shape[2])
    offsets = torch.randint(0, 2 * int(pad) + 1, (b, 2), generator=generator)
    coins = torch.rand((b,), generator=generator) < 0.5
    cy = torch.randint(0, h, (b,), generator=generator)
    cx = torch.randint(0, w, (b,), generator=generator)
    return tuple(t.to(device) for t in (offsets, coins, cy, cx))


def random_crop(x01: torch.Tensor, pad: int, offsets: torch.Tensor) -> torch.Tensor:
    """[B,H,W,C] -> [B,H,W,C]: zero-pad by ``pad``, crop at ``offsets``."""
    b, h, w, _ = x01.shape
    xp = torch.nn.functional.pad(x01, (0, 0, pad, pad, pad, pad))
    rows = offsets[:, 0:1] + torch.arange(h, device=x01.device)   # [B,H]
    cols = offsets[:, 1:2] + torch.arange(w, device=x01.device)   # [B,W]
    bi = torch.arange(b, device=x01.device)[:, None, None]
    return xp[bi, rows[:, :, None], cols[:, None, :]]


def random_flip(x01: torch.Tensor, coins: torch.Tensor) -> torch.Tensor:
    """Flip the images whose coin is set, left to right."""
    return torch.where(coins[:, None, None, None], x01.flip(2), x01)


def random_cutout(x01: torch.Tensor, length: int, cy: torch.Tensor,
                  cx: torch.Tensor) -> torch.Tensor:
    """Zero the ``length`` x ``length`` square centred at (cy, cx) of each
    image (border-clipped): rows ``cy - length//2 .. cy - length//2 + length``."""
    _, h, w, _ = x01.shape
    half = int(length) // 2
    rows = torch.arange(h, device=x01.device)[None, :]
    cols = torch.arange(w, device=x01.device)[None, :]
    in_rows = (rows >= cy[:, None] - half) & (rows < cy[:, None] - half + length)
    in_cols = (cols >= cx[:, None] - half) & (cols < cx[:, None] - half + length)
    mask = in_rows[:, :, None] & in_cols[:, None, :]
    return torch.where(mask[..., None], torch.zeros((), dtype=x01.dtype, device=x01.device),
                       x01)


def make_augment_fn(config: AugmentConfig):
    """``(generator, x01) -> x01_aug``: crop, then flip, then cutout; or
    ``None`` for an empty policy, which draws nothing."""
    if not config.enabled:
        return None

    def augment(generator: torch.Generator, x01: torch.Tensor) -> torch.Tensor:
        offsets, coins, cy, cx = draw_augment(x01.shape, config.pad, generator, x01.device)
        if config.pad > 0:
            x01 = random_crop(x01, int(config.pad), offsets)
        if config.flip:
            x01 = random_flip(x01, coins)
        if config.cutout > 0:
            x01 = random_cutout(x01, int(config.cutout), cy, cx)
        return x01

    return augment
