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
