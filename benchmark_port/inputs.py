"""The benchmark's inputs, made from ``--seed`` alone and handed to both the
program and the reference: the weights (from a configuration's parameter
spec, in one draw on the device) and the batches (from the seed and the
batch's index, on the device).
"""

from __future__ import annotations

import hashlib

import torch


def mix(seed: int, *parts) -> int:
    """A 63-bit generator seed from the run's seed and a tuple of labels."""
    text = "|".join(str(p) for p in (int(seed), *parts))
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8], "big") >> 1


def device_generator(seed: int, device, *parts) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(mix(seed, *parts))
    return g


def host_generator(seed: int, *parts) -> torch.Generator:
    return torch.Generator().manual_seed(mix(seed, *parts))


@torch.no_grad()
def make_weights(spec, positive, seed: int, device) -> dict[str, torch.Tensor]:
    """A float32 state dict from ``spec`` ([(name, shape, mean, std)]): one
    ``randn`` of every leaf's elements on ``device``, cut into leaves, each
    ``mean + std * n``; names ending in one of ``positive`` take the absolute
    value; a 0-d leaf is an int64 zero (BatchNorm's batch counter)."""
    sizes = []
    for _, shape, _, _ in spec:
        n = 1
        for s in shape:
            n *= s
        sizes.append(n if shape else 0)
    flat = torch.randn(sum(sizes), generator=device_generator(seed, device, "weights"),
                       device=device, dtype=torch.float32)
    out, at = {}, 0
    for (name, shape, mean, std), n in zip(spec, sizes):
        if not shape:
            out[name] = torch.zeros((), dtype=torch.int64, device=device)
            continue
        leaf = flat[at:at + n].view(shape) * std + mean
        at += n
        if name.endswith(tuple(positive)):
            leaf = leaf.abs()
        out[name] = leaf
    return out


@torch.no_grad()
def make_batch(seed: int, index: int, batch: int, size: int, classes: int, device):
    """Batch ``index``: ``batch`` NHWC float32 images in [0, 1], smooth
    random fields (uniform at 1/8 of the size, upsampled bilinearly), and
    their labels, uniform over ``classes``."""
    g = device_generator(seed, device, "batch", index)
    low = torch.rand((batch, 3, max(1, size // 8), max(1, size // 8)), generator=g,
                     device=device, dtype=torch.float32)
    x = torch.nn.functional.interpolate(low, size=(size, size), mode="bilinear",
                                        align_corners=False)
    x = x.clamp(0.0, 1.0).permute(0, 2, 3, 1).contiguous()
    y = torch.randint(0, classes, (batch,), generator=g, device=device)
    return x, y
