"""Seeded random generators (port of ``core/rng.py``).

Every source of randomness takes an explicit ``torch.Generator`` seeded from
``--seed``, in place of the JAX package's PRNG keys.  The two frameworks draw
different numbers from the same seed, so parity tests feed both the same
numpy inputs instead.
"""

from __future__ import annotations

import hashlib

import torch


def generator_from_seed(seed: int | None, device: torch.device | str = "cpu"
                        ) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (None picks 0)."""
    g = torch.Generator(device=device)
    g.manual_seed(0 if seed is None else int(seed))
    return g


def cell_hash(cell_id: str) -> int:
    """The first four bytes of SHA-256(cell_id), big-endian, top bit cleared:
    the 31-bit value the JAX package's ``cli/common.py::cell_key`` folds in."""
    digest = hashlib.sha256(cell_id.encode()).digest()
    return int.from_bytes(digest[:4], "big") & 0x7FFFFFFF


def cell_generator(seed: int, cell_id: str) -> torch.Generator:
    """The generator of one grid cell (on the CPU; the noise kernel draws
    its own seed from it): seeded with ``seed * 2**31 + cell_hash(cell_id)``,
    a function of ``(seed, cell id)`` alone.

    It is the counterpart of ``cell_key`` (``jax.random.fold_in`` of the
    same hash into the seed's key).  The bits differ from JAX's, but the
    property is the same: a cell's randomness never depends on which other
    cells of the grid ran before it, so a resumed cell equals a fresh run
    of a narrower grid.  Distinct ``(seed, cell id)`` pairs give distinct
    seeds, since the hash is below 2**31.
    """
    return generator_from_seed(int(seed) * 2**31 + cell_hash(cell_id))


def chunk_generator(seed: int, cell_id: str, step: int) -> torch.Generator:
    """The generator of chunk ``step`` of a streamed grid cell: seeded with
    the first 63 bits of SHA-256 of ``"<seed>|<cell id>|<step>"``.

    It is the counterpart of the JAX package's ``fold_in(cell_key, step)``
    (``eval/streaming.py``).  Its bits differ from JAX's, but, being a
    function of the seed, the cell id and the step alone, a resumed or
    narrowed grid replays each chunk's draw.
    """
    digest = hashlib.sha256(f"{int(seed)}|{cell_id}|{int(step)}".encode()).digest()
    return generator_from_seed(int.from_bytes(digest[:8], "big") >> 1)


def seed_draw(generator: torch.Generator) -> int:
    """A 63-bit seed drawn from ``generator`` (one host read where the
    generator lives on a card)."""
    return int(torch.randint(0, 2**63 - 1, (1,), generator=generator,
                             device=generator.device).item())


def device_generator(generator: torch.Generator,
                     device: torch.device | str) -> torch.Generator:
    """A generator on ``device`` for full-size draws made there: the
    generator itself where it already lives on that device type, else a new
    one on ``device`` seeded with a draw of ``generator``, so the draw is
    made on the card instead of being copied there."""
    device = torch.device(device)
    if device.type == generator.device.type:
        return generator
    g = torch.Generator(device=device)
    g.manual_seed(seed_draw(generator))
    return g


def split_generators(generator: torch.Generator, n: int) -> list[torch.Generator]:
    """``n`` generators on ``generator``'s device, each seeded with one draw
    of ``generator`` in turn: the counterpart of ``jax.random.split(key, n)``
    (other bits, the same property: the i-th child depends only on the
    parent's state and i)."""
    out = []
    for _ in range(int(n)):
        g = torch.Generator(device=generator.device)
        g.manual_seed(seed_draw(generator))
        out.append(g)
    return out


def standard_normal(shape, generator: torch.Generator,
                    device: torch.device | str) -> torch.Tensor:
    """float32 N(0, 1) of ``shape`` on ``device``, from ``generator``.

    Where the generator lives on another device (the port's generators
    live on the CPU), a generator on ``device`` is seeded with a 63-bit draw
    of ``generator`` (``device_generator``), so a full-size draw is made on
    the card instead of being copied there.
    """
    g = device_generator(generator, device)
    return torch.randn(tuple(shape), generator=g, dtype=torch.float32, device=device)


def rademacher(shape, generator: torch.Generator, device: torch.device | str) -> torch.Tensor:
    """float32 ±1 of ``shape`` on ``device`` (a fair coin each), drawn there
    from ``device_generator(generator, device)``'s bits."""
    g = device_generator(generator, device)
    bits = torch.randint(0, 2, tuple(shape), generator=g, device=device, dtype=torch.int32)
    return (bits * 2 - 1).to(torch.float32)


def randint_below(high: torch.Tensor, n: int, generator: torch.Generator) -> torch.Tensor:
    """int64 [len(high), n]: row i uniform over ``[0, high[i])`` (every
    ``high[i] >= 1``), on ``high``'s device from ``generator`` (which lives
    there).  Per-row bounds in one draw: ``floor(u * high)`` of a float64
    uniform, kept below ``high``."""
    u = torch.rand((high.shape[0], int(n)), generator=generator, dtype=torch.float64,
                   device=high.device)
    hi = high.to(torch.int64)[:, None]
    return torch.minimum((u * hi).to(torch.int64), hi - 1)
