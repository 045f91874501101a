"""Seeded random generators (port of ``core/rng.py``).

Every source of randomness takes an explicit ``torch.Generator`` seeded from
``--seed``, in place of the JAX package's PRNG keys.  The two frameworks draw
different numbers from the same seed, so parity tests feed both the same
numpy inputs instead.
"""

from __future__ import annotations

import torch


def generator_from_seed(seed: int | None, device: torch.device | str = "cpu"
                        ) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (None picks 0)."""
    g = torch.Generator(device=device)
    g.manual_seed(0 if seed is None else int(seed))
    return g
