"""The mesh's data axis (port of ``parallel/mesh.py``'s ``make_mesh``,
``data_sharding``, ``replicated_sharding`` and ``shard_batch``).

A ``Mesh`` is a grid of torch devices with the JAX package's axes
``("data", "model")``, built by JAX's shape rules.  A ``Sharding`` says
where the rows of a ``[B, ...]`` tensor live: split into contiguous chunks
over the data axis (each chunk on every device of its data row), or whole on
every device.  ``Sharding.place`` returns a ``ShardedTensor``, one shard per
device of the mesh in row-major order, and ``ShardedTensor.gather`` puts the
rows back together on the host in order.  There is no global array: work on
a sharded batch runs shard by shard, each on its own device, where XLA
partitions one program in the JAX package.

The tensor-parallel rule (``tensor_parallel_spec``,
``shard_model_variables``) is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.device import resolve_device, to_device

AXES = ("data", "model")


@dataclass(frozen=True)
class Mesh:
    """``devices[i][j]`` is the device at data index i, model index j."""

    devices: tuple[tuple[torch.device, ...], ...]
    axis_names = AXES

    @property
    def shape(self) -> dict[str, int]:
        return {"data": len(self.devices), "model": len(self.devices[0])}

    @property
    def flat_devices(self) -> list[torch.device]:
        return [d for row in self.devices for d in row]


def visible_devices(device: torch.device | str | None = "cuda") -> list[torch.device]:
    """Every CUDA device (raising where CUDA is absent), or the CPU alone."""
    device = resolve_device(device)
    if device.type == "cpu":
        return [device]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_data: int | None = None, n_model: int = 1,
              devices: list[torch.device] | None = None) -> Mesh:
    """('data', 'model') mesh over ``devices`` (default: every CUDA device);
    with more devices than ``n_data * n_model`` the first ones are used."""
    devices = list(devices) if devices is not None else visible_devices()
    n_total = len(devices)
    if n_data is None:
        if n_total % n_model != 0:
            raise ValueError(f"{n_total} devices not divisible by model={n_model}")
        n_data = n_total // n_model
    if n_data * n_model > n_total:
        raise ValueError(f"mesh {n_data}x{n_model} needs more than {n_total} devices")
    grid = tuple(tuple(devices[i * n_model:(i + 1) * n_model]) for i in range(n_data))
    return Mesh(grid)


@dataclass(frozen=True)
class Sharding:
    """``spec`` is ``("data",)`` (rows split over the data axis) or ``()``
    (replicated)."""

    mesh: Mesh
    spec: tuple[str, ...]

    def place(self, x: torch.Tensor | np.ndarray) -> ShardedTensor:
        """A host ``[B, ...]`` array -> its shards on the mesh's devices
        (pinned, non-blocking copies on a card)."""
        t = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x
        n_data, n_model = self.mesh.shape["data"], self.mesh.shape["model"]
        if self.spec == ("data",):
            if t.shape[0] % n_data:
                raise ValueError(f"a batch of {t.shape[0]} rows does not split evenly "
                                 f"over the {n_data} devices of the data axis")
            chunks = [c for c in torch.tensor_split(t, n_data) for _ in range(n_model)]
        else:
            chunks = [t] * (n_data * n_model)
        shards = tuple(to_device(c.contiguous(), d)
                       for c, d in zip(chunks, self.mesh.flat_devices))
        return ShardedTensor(shards, self)


@dataclass(frozen=True)
class ShardedTensor:
    """``shards[i]`` lives on ``sharding.mesh.flat_devices[i]``."""

    shards: tuple[torch.Tensor, ...]
    sharding: Sharding

    @property
    def shape(self) -> torch.Size:
        first = self.shards[0].shape
        if self.sharding.spec == ("data",):
            return torch.Size((first[0] * self.sharding.mesh.shape["data"], *first[1:]))
        return first

    def gather(self) -> torch.Tensor:
        """The whole tensor on the CPU, rows in order."""
        if self.sharding.spec != ("data",):
            return self.shards[0].cpu()
        n_model = self.sharding.mesh.shape["model"]
        return torch.cat([s.cpu() for s in self.shards[::n_model]])


def data_sharding(mesh: Mesh) -> Sharding:
    """Batch-dim sharding for [B, ...] arrays."""
    return Sharding(mesh, ("data",))


def replicated_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def shard_batch(x: torch.Tensor | np.ndarray, mesh: Mesh) -> ShardedTensor:
    """Place a [B, ...] array with B sharded over the data axis."""
    return data_sharding(mesh).place(x)
