"""Frozen plain copies of the arithmetic of the program's three elementwise
kernels, for the reference: the Philox-4x32-10 uniform noise that draws the
PGD start, the PGD-L-inf update and the 16-level quantization, with the
smoothing and the straight-through quantization of the defense chain.

Each follows the kernel's float32 arithmetic operation for operation, so
that the reference reproduces the program's bits where the program is sound.
Philox runs on int64 tensors holding 32-bit words; a 32x32-bit product is
formed from two 16-bit halves of the constant so that nothing overflows.
"""

from __future__ import annotations

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK = 0xFFFFFFFF


def _mul_hi_lo(a: torch.Tensor, m: int):
    """(high, low) 32-bit words of a * m, a holding 32-bit words in int64."""
    lo_part = a * (m & 0xFFFF)
    hi_part = a * (m >> 16)
    low_sum = lo_part + ((hi_part & 0xFFFF) << 16)
    return (hi_part >> 16) + (low_sum >> 32), low_sum & _MASK


def philox4x32_10(counter_lo: torch.Tensor, counter_hi: torch.Tensor, seed: int):
    """The four 32-bit outputs of Philox-4x32-10 for counters (lo, hi, 0, 0)
    under the 64-bit key ``seed``."""
    c0, c1 = counter_lo, counter_hi
    c2 = torch.zeros_like(c0)
    c3 = torch.zeros_like(c0)
    k0, k1 = seed & _MASK, (seed >> 32) & _MASK
    for _ in range(10):
        hi0, lo0 = _mul_hi_lo(c0, _M0)
        hi1, lo1 = _mul_hi_lo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
    return c0, c1, c2, c3


def uniform_noise(shape, eps: float, seed: int, device) -> torch.Tensor:
    """Uniform(-eps, eps) float32 of ``shape``: element 4G+j is word j of
    Philox(counter G, key seed), its high 24 bits scaled to [0, 1), then
    ``(2u - 1) * eps`` in float32."""
    n = 1
    for s in shape:
        n *= int(s)
    groups = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
    words = philox4x32_10(groups & _MASK, groups >> 32, int(seed))
    bits = torch.stack(words, dim=1).reshape(-1)[:n]
    u = (bits >> 8).to(torch.float32) * (1.0 / 16777216.0)
    eps32 = torch.tensor(eps, dtype=torch.float32, device=device)
    return ((u * 2.0 - 1.0) * eps32).reshape(tuple(shape))


def seed_of(generator: torch.Generator) -> int:
    """The 63-bit seed the program draws from a host generator for the noise
    kernel: one ``randint(0, 2**63 - 1)``."""
    return int(torch.randint(0, 2**63 - 1, (1,), generator=generator).item())


def split(generator: torch.Generator, n: int) -> list[torch.Generator]:
    """``n`` host generators, each seeded with one such draw in turn."""
    return [torch.Generator().manual_seed(seed_of(generator)) for _ in range(n)]


def pgd_step(x, sign, x0, eps: float, alpha: float):
    """clip(clip(x + alpha * sign, x0 - eps, x0 + eps), 0, 1) in float32."""
    alpha32 = torch.tensor(alpha, dtype=torch.float32, device=x.device)
    eps32 = torch.tensor(eps, dtype=torch.float32, device=x.device)
    v = x + alpha32 * sign
    v = torch.minimum(torch.maximum(v, x0 - eps32), x0 + eps32)
    return torch.clamp(v, 0.0, 1.0)


def quantize(x, levels: int):
    """round(clip01(x) * (L-1)) / (L-1), half to even, IEEE division."""
    scale = torch.full((), levels - 1, dtype=x.dtype, device=x.device)
    return torch.round(torch.clamp(x, 0.0, 1.0) * scale) / scale


def smoothing(x):
    """3x3 mean with zero padding on NHWC: the nine shifted adds in row-major
    order from the top-left tap, then one division by 9."""
    h, w = x.shape[1], x.shape[2]
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    total = xp[:, 0:h, 0:w, :]
    for dy in range(3):
        for dx in range(3):
            if dy or dx:
                total = total + xp[:, dy:dy + h, dx:dx + w, :]
    return total / torch.full((), 9.0, dtype=x.dtype, device=x.device)


def defend(x, levels: int):
    """clip -> smooth -> quantize (as ``x01 + (q - x01)``, the straight-through
    form) -> clip."""
    x01 = smoothing(torch.clamp(x, 0.0, 1.0))
    x01 = torch.clamp(x01, 0.0, 1.0)
    q = quantize(x01, levels)
    return torch.clamp(x01 + (q - x01), 0.0, 1.0)


def start_noise(shape, eps: float, generator: torch.Generator, device) -> torch.Tensor:
    """The PGD start as the program draws it from ``generator``: on a card,
    the Philox kernel under one 63-bit seed drawn from the generator; on the
    CPU, ``(2 * rand - 1) * eps`` from the generator itself."""
    device = torch.device(device)
    if device.type == "cuda":
        return uniform_noise(shape, eps, seed_of(generator), device)
    u = torch.rand(tuple(shape), generator=generator, dtype=torch.float32)
    return (u * 2.0 - 1.0) * eps
