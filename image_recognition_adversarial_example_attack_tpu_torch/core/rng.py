"""Seeded random generators (port of ``core/rng.py``).

Every source of randomness takes an explicit ``torch.Generator`` seeded from
``--seed``, in place of the JAX package's PRNG keys.  The two frameworks draw
different numbers from the same seed, so parity tests feed both the same
numpy inputs instead.
"""

from __future__ import annotations

import hashlib
import threading

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
    generator lives on a card).  A ``ShardGenerator`` is refused: a seed
    has no rows to take (the noise kernel offsets its counter instead)."""
    _refuse_shard(generator, "seed_draw")
    return int(torch.randint(0, 2**63 - 1, (1,), generator=generator,
                             device=generator.device).item())


def device_generator(generator: torch.Generator,
                     device: torch.device | str) -> torch.Generator:
    """A generator on ``device`` for full-size draws made there: the
    generator itself where it already lives on that device type, else a new
    one on ``device`` seeded with a draw of ``generator``, so the draw is
    made on the card instead of being copied there."""
    device = torch.device(device)
    if isinstance(generator, ShardGenerator):  # its rows of the parent's child
        return _shard_child(generator, lambda p: device_generator(p, device))
    if device.type == generator.device.type:
        return generator
    g = torch.Generator(device=device)
    g.manual_seed(seed_draw(generator))
    return g


def split_generators(generator: torch.Generator, n: int) -> list[torch.Generator]:
    """``n`` generators on ``generator``'s device, each seeded with one draw
    of ``generator`` in turn: the counterpart of ``jax.random.split(key, n)``
    (other bits, the same property: the i-th child depends only on the
    parent's state and i).  A ``ShardGenerator``'s children are the same
    rows of the unsharded run's children."""
    if isinstance(generator, ShardGenerator):
        children = whole_batch_draw(generator, lambda p: [
            _WholeBatchDraws(c, generator.shared.rows) for c in split_generators(p, n)])
        return [ShardGenerator(c, generator.lo, generator.hi, generator.index) for c in children]
    out = []
    for _ in range(int(n)):
        g = torch.Generator(device=generator.device)
        g.manual_seed(seed_draw(generator))
        out.append(g)
    return out


def standard_normal(shape, generator: torch.Generator, device: torch.device | str,
                    axis: int | None = 0) -> torch.Tensor:
    """float32 N(0, 1) of ``shape`` on ``device``, from ``generator``.

    Where the generator lives on another device (the port's generators
    live on the CPU), a generator on ``device`` is seeded with a 63-bit draw
    of ``generator`` (``device_generator``), so a full-size draw is made on
    the card instead of being copied there.  ``axis`` is the batch axis
    (``batch_draw``).
    """
    return batch_draw(generator, shape, lambda s, p: torch.randn(
        s, generator=device_generator(p, device), dtype=torch.float32, device=device), axis)


def uniform(shape, generator: torch.Generator, device: torch.device | str,
            axis: int | None = 0, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Uniform [0, 1) of ``shape`` on ``device`` from ``generator``, which
    lives there; ``axis`` is the batch axis (``batch_draw``)."""
    return batch_draw(generator, shape, lambda s, p: torch.rand(
        s, generator=p, dtype=dtype, device=device), axis)


def randint(high: int, shape, generator: torch.Generator, device: torch.device | str,
            axis: int | None = 0) -> torch.Tensor:
    """int64 uniform over ``[0, high)`` of ``shape`` on ``device`` from
    ``generator``, which lives there; ``axis`` is the batch axis."""
    return batch_draw(generator, shape, lambda s, p: torch.randint(
        0, int(high), s, generator=p, device=device), axis)


def rademacher(shape, generator: torch.Generator, device: torch.device | str,
               axis: int | None = 0) -> torch.Tensor:
    """float32 ±1 of ``shape`` on ``device`` (a fair coin each), drawn there
    from ``device_generator(generator, device)``'s bits; ``axis`` is the
    batch axis."""
    def draw(s, p):
        bits = torch.randint(0, 2, s, generator=device_generator(p, device), device=device,
                             dtype=torch.int32)
        return (bits * 2 - 1).to(torch.float32)

    return batch_draw(generator, shape, draw, axis)


def randint_below(high: torch.Tensor, n: int, generator: torch.Generator,
                  axis: int | None = 1) -> torch.Tensor:
    """int64 [len(high), n]: row i uniform over ``[0, high[i])`` (every
    ``high[i] >= 1``), on ``high``'s device from ``generator`` (which lives
    there).  Per-row bounds in one draw: ``floor(u * high)`` of a float64
    uniform, kept below ``high``.  ``axis`` is the batch axis (the ``n``
    columns by default)."""
    u = uniform((high.shape[0], int(n)), generator, high.device, axis, torch.float64)
    hi = high.to(torch.int64)[:, None]
    return torch.minimum((u * hi).to(torch.int64), hi - 1)


class _WholeBatchDraws:
    """The draws of one generator over a sharded batch, shared by the
    shards' views: draw k is made from the parent once, the first time a
    shard asks for it, exactly as the unsharded run makes it."""

    def __init__(self, parent: torch.Generator, rows: int):
        self.parent, self.rows = parent, int(rows)
        self.made: list = []
        self.lock = threading.Lock()  # shards in lockstep threads draw at once

    def get(self, k: int, make):
        with self.lock:
            if k == len(self.made):
                self.made.append(make(self.parent))
            return self.made[k]


class ShardGenerator:
    """Rows ``[lo, hi)`` of a batch of ``shared.rows`` rows drawn from a
    parent generator, in place of a ``torch.Generator``.

    Every draw function of the port routes it (``batch_draw`` under
    ``uniform``, ``randint``, ``standard_normal``, ``rademacher`` and
    ``randint_below``; ``device_generator`` and ``split_generators`` give
    child views; the noise kernel's ``kernels.elementwise.uniform_noise``;
    ``train.augment.draw_augment``; ``rates_draw``): draw k of every shard is the parent's
    k-th draw, made once for the whole batch (``whole_batch_draw``), and
    the shard takes its rows along the draw's batch axis.  On a card the
    noise kernel starts its Philox counter at the shard's first element
    under the seed the unsharded run draws, so no whole-batch noise is
    made.  So a sharded run draws the unsharded run's numbers.  It is no
    ``torch.Generator``: a draw that does not route it (torch's own
    functions, ``seed_draw``) raises instead of drawing other numbers."""

    def __init__(self, shared: _WholeBatchDraws, lo: int, hi: int, index: int):
        self.shared, self.lo, self.hi, self.index = shared, int(lo), int(hi), int(index)
        self.draws = 0

    @property
    def device(self) -> torch.device:
        return self.shared.parent.device


def _refuse_shard(generator, what: str) -> None:
    if isinstance(generator, ShardGenerator):
        raise TypeError(f"{what} does not take a ShardGenerator: its draw has no rows to "
                        "take for a shard (route it through core.rng.batch_draw)")


def _shard_child(generator: ShardGenerator, make) -> ShardGenerator:
    """The shard's view of ``make(parent)``, a generator made once for the
    whole batch from the parent (as the unsharded run makes it)."""
    child = whole_batch_draw(generator, lambda p: _WholeBatchDraws(make(p),
                                                                   generator.shared.rows))
    return ShardGenerator(child, generator.lo, generator.hi, generator.index)


def batch_draw(generator, shape, draw, axis: int | None = 0):
    """``draw(shape, g)``, a draw made from the ``torch.Generator`` ``g``.
    For a ``ShardGenerator``: its rows along the batch axis ``axis`` of the
    draw the unsharded run makes from the parent (``shape`` with the whole
    batch's rows there), or, where the draw has no batch axis (``axis``
    None), that whole draw."""
    shape = tuple(int(d) for d in shape)
    if not isinstance(generator, ShardGenerator):
        return draw(shape, generator)
    if axis is None:
        return whole_batch_draw(generator, lambda p: draw(shape, p))
    rows = generator.hi - generator.lo
    if shape[axis] != rows:
        raise ValueError(f"a draw of shape {shape} for a shard of {rows} rows: its batch "
                         f"axis {axis} is not the shard's rows")
    whole = (*shape[:axis], generator.shared.rows, *shape[axis + 1:])
    return whole_batch_draw(generator, lambda p: draw(whole, p)).narrow(axis, generator.lo, rows)


def rates_draw(generator, rates: torch.Tensor, draw) -> torch.Tensor:
    """``draw(rates, g)``, a draw whose distribution varies with
    ``rates`` along every axis (``torch.poisson``), from the
    ``torch.Generator`` ``g``.  Such a draw cannot be cut by rows: for a
    ``ShardGenerator`` the one-device draw is made once from the whole
    batch's rates, which the lockstep shards exchange
    (``parallel.collective.whole_rows``), and the shard takes its rows."""
    if not isinstance(generator, ShardGenerator):
        return draw(rates, generator)
    from ..parallel.collective import whole_rows

    whole = whole_rows(rates)
    if whole.shape[0] != generator.shared.rows:
        raise ValueError(f"the whole batch's rates have {whole.shape[0]} rows, the sharded "
                         f"batch {generator.shared.rows}: run the shards in lockstep")
    rows = generator.hi - generator.lo
    return whole_batch_draw(generator, lambda p: draw(whole, p)).narrow(
        0, generator.lo, rows).to(rates.device)


def whole_batch_draw(generator: ShardGenerator, make):
    """The shard's next draw, whole: ``make(parent)`` as the unsharded run
    calls it (made by the first shard that asks); the caller takes rows
    ``[generator.lo, generator.hi)`` of it."""
    k, generator.draws = generator.draws, generator.draws + 1
    return generator.shared.get(k, make)


def shard_generators(parent: torch.Generator, rows: list[tuple[int, int]],
                     total_rows: int) -> list[ShardGenerator]:
    """One ``ShardGenerator`` per ``(lo, hi)`` row range of a batch of
    ``total_rows`` rows, all reading ``parent``'s whole-batch draws."""
    shared = _WholeBatchDraws(parent, total_rows)
    return [ShardGenerator(shared, lo, hi, i) for i, (lo, hi) in enumerate(rows)]
