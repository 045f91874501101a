"""Mesh construction and sharding rules (port of ``parallel/mesh.py``).

A ``Mesh`` is a grid of torch devices with the JAX package's axes
``("data", "model")``, built by JAX's shape rules.  A ``Sharding`` says
where the rows of a ``[B, ...]`` tensor live: split into contiguous chunks
over the data axis (each chunk on every device of its data row), or whole on
every device.  ``Sharding.place`` returns a ``ShardedTensor``, one shard per
device of the mesh in row-major order, and ``ShardedTensor.gather`` puts the
rows back together on the host in order.  There is no global array: work on
a sharded batch runs shard by shard, each on its own device
(``parallel/data_parallel.py``), where XLA partitions one program in the
JAX package.  A mesh that spans several processes
(``parallel/distributed.py::make_dcn_mesh``) holds this process's rows of
the grid; its ``shape`` is the global one.

The tensor-parallel rule is JAX's, line for line: ``tensor_parallel_spec``
reads a parameter's Flax path and Flax shape (``models/convert.py::
flax_layout``) and returns the Flax ``PartitionSpec`` or None.
``shard_model_variables`` cuts each partitioned parameter along the mapped
torch axis (a conv kernel's output channels are torch dim 0, a
column-parallel Dense's outputs dim 0 and a row-parallel Dense's inputs
dim 1, the head-aligned qkv's heads a block of rows in each of q, k and v)
and gives every model-axis slot its shard; ``parallel/tensor_parallel.py``
runs a model on them.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from ..core.device import resolve_device, to_device

AXES = ("data", "model")


@dataclass(frozen=True)
class Mesh:
    """``devices[i][j]`` is this process's device at data index i, model
    index j; ``process_count`` processes hold ``len(devices)`` data rows
    each, process ``process_index`` rows ``[index * len(devices), ...)``."""

    devices: tuple[tuple[torch.device, ...], ...]
    process_count: int = 1
    process_index: int = 0
    axis_names = AXES

    @property
    def shape(self) -> dict[str, int]:
        return {"data": len(self.devices) * self.process_count,
                "model": len(self.devices[0])}

    @property
    def flat_devices(self) -> list[torch.device]:
        return [d for row in self.devices for d in row]

    @property
    def first_data_row(self) -> int:
        """The global data index of this process's first row."""
        return self.process_index * len(self.devices)


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
        """A host ``[B, ...]`` array -> its shards on this process's devices
        (pinned, non-blocking copies on a card).  Over a mesh of several
        processes ``x`` is the global batch and only this process's rows are
        placed."""
        t = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x
        mesh = self.mesh
        n_data, n_model = mesh.shape["data"], mesh.shape["model"]
        if self.spec == ("data",):
            if t.shape[0] % n_data:
                raise ValueError(f"a batch of {t.shape[0]} rows does not split evenly "
                                 f"over the {n_data} devices of the data axis")
            rows = torch.tensor_split(t, n_data)
            mine = rows[mesh.first_data_row:mesh.first_data_row + len(mesh.devices)]
            chunks = [c for c in mine for _ in range(n_model)]
        else:
            chunks = [t] * len(mesh.flat_devices)
        shards = tuple(to_device(c.contiguous(), d)
                       for c, d in zip(chunks, mesh.flat_devices))
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

    def data_shards(self) -> list[torch.Tensor]:
        """One shard a data row (the first device of each row), in row order."""
        return list(self.shards[::self.sharding.mesh.shape["model"]])

    def row_ranges(self) -> list[tuple[int, int]]:
        """The global ``[lo, hi)`` rows of each of ``data_shards()``."""
        mesh = self.sharding.mesh
        if self.sharding.spec != ("data",):
            return [(0, int(self.shards[0].shape[0]))] * len(mesh.devices)
        n = int(self.shards[0].shape[0])
        first = mesh.first_data_row
        return [((first + i) * n, (first + i + 1) * n) for i in range(len(mesh.devices))]

    def gather(self) -> torch.Tensor:
        """The whole tensor on the CPU, rows in order.  Over a mesh of
        several processes every process calls it (its rows are gathered from
        all of them, ``parallel.distributed.all_gather_rows``)."""
        if self.sharding.spec != ("data",):
            return self.shards[0].cpu()
        local = torch.cat([s.cpu() for s in self.data_shards()])
        if self.sharding.mesh.process_count == 1:
            return local
        from .distributed import all_gather_rows

        return all_gather_rows(local)


def data_sharding(mesh: Mesh) -> Sharding:
    """Batch-dim sharding for [B, ...] arrays."""
    return Sharding(mesh, ("data",))


def replicated_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def shard_batch(x: torch.Tensor | np.ndarray, mesh: Mesh) -> ShardedTensor:
    """Place a [B, ...] array with B sharded over the data axis."""
    return data_sharding(mesh).place(x)


# ---------------------------------------------------------------------------
# The tensor-parallel rule
# ---------------------------------------------------------------------------

class PerDevice:
    """``factory(device)``'s value, built once per distinct device: a
    model's replica (or its functions) for the shards on each device."""

    def __init__(self, factory: Callable[[torch.device], object]):
        self.factory = factory
        self.cache: dict[str, object] = {}
        self.lock = threading.RLock()  # lockstep shards ask at once

    def __call__(self, device: torch.device):
        key = str(torch.device(device))
        with self.lock:
            if key not in self.cache:
                self.cache[key] = self.factory(torch.device(device))
            return self.cache[key]


def on_device(fn, device: torch.device):
    """``fn`` for a shard on ``device``: its replica there, or ``fn`` itself."""
    return fn(device) if isinstance(fn, PerDevice) else fn


class PartitionSpec(tuple):
    """A tuple of mesh-axis names (or None), one per array axis: JAX's
    ``PartitionSpec``, which is a tuple as well."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


def _path_names(path: tuple) -> list[str]:
    return [getattr(p, "key", getattr(p, "name", str(p))) for p in path]


def _is_head_kernel(path: tuple, leaf) -> bool:
    """True for the classifier head's dense kernel ([in, out], out = classes)."""
    names = _path_names(path)
    return (
        len(names) >= 2
        and names[-1] == "kernel"
        # fc: resnet; head: vit/swin; classifier: densenet/efficientnet;
        # classifier_6: vgg
        and names[-2] in ("fc", "head", "classifier", "classifier_6")
        and getattr(leaf, "ndim", 0) == 2
    )


def tensor_parallel_spec(path: tuple, leaf) -> P | None:
    """PartitionSpec for a parameter under tensor parallelism, or None
    (replicate).  ``path`` is the parameter's Flax path (collection first,
    as ``jax.tree_util`` gives it) and ``leaf`` anything with the Flax
    array's ``ndim``.

    Megatron-style column/row pairing over the 'model' axis:

    - ViT/Swin attention: qkv kernel HEAD-ALIGNED [D, 3, H, hd], sharded on
      the head axis P(None, None, 'model', None), bias [3, H, hd] to match;
      output projection row-parallel [D->shard, D].  Legacy ndim-2/1 qkv
      leaves keep the contiguous column rule.
    - ViT MLP: linear_1 column-parallel, linear_2 row-parallel.
    - ResNet stage convs (layer1..4 bottlenecks): out-channel sharding
      [kh, kw, in, out->shard] on every conv kernel; BatchNorm stays
      replicated.
    - Classifier head: output-dim sharding.
    """
    names = _path_names(path)
    if not names:
        return None
    last = names[-1]
    parent = names[-2] if len(names) >= 2 else ""
    ndim = getattr(leaf, "ndim", 0)

    if _is_head_kernel(path, leaf):
        return P(None, "model")
    # attention qkv/proj pairs: ViT ('self_attention'/qkv + out) and Swin
    # ('attn'/qkv + proj) — column-parallel packed qkv, row-parallel
    # output projection
    in_attention = any(n in ("self_attention", "attn") for n in names)
    if in_attention and parent == "qkv":
        if last == "kernel" and ndim == 4:   # head-aligned [D, 3, H, hd]
            return P(None, None, "model", None)
        if last == "bias" and ndim == 3:     # [3, H, hd]
            return P(None, "model", None)
        if last == "kernel" and ndim == 2:   # legacy packed [D, 3D]
            return P(None, "model")
        if last == "bias" and ndim == 1:
            return P("model")
    if (in_attention and parent in ("out", "proj")
            and last == "kernel" and ndim == 2):
        return P("model", None)  # row-parallel; bias replicated
    # MLP column/row pairs: ViT mlp_linear_1/2, Swin mlp_0/mlp_3, VGG's
    # giant classifier_0/classifier_3 pair
    if parent in ("mlp_linear_1", "mlp_0", "classifier_0"):
        if last == "kernel" and ndim == 2:
            return P(None, "model")
        if last == "bias" and ndim == 1:
            return P("model")
    if (parent in ("mlp_linear_2", "mlp_3", "classifier_3")
            and last == "kernel" and ndim == 2):
        return P("model", None)
    # stage/block convs, out-channel sharded: ResNet layerN_i bottlenecks,
    # DenseNet denseblockB_denselayerL, EfficientNet stageS_blockB,
    # MobileNetV2 blockN inverted residuals
    if (last == "kernel" and ndim == 4
            and any(n.startswith(("layer", "denseblock", "stage", "block"))
                    for n in names)):
        return P(None, None, None, "model")
    return None


@dataclass(frozen=True)
class PlacedVariable:
    """One state-dict entry on the mesh: ``shards[i]`` on
    ``mesh.flat_devices[i]``.  ``spec`` is the Flax PartitionSpec (None:
    replicated, every shard the whole tensor); ``dim`` the torch axis cut
    over 'model' (None when replicated); ``heads`` is set for a head-aligned
    qkv entry, whose slot rows are its heads' rows in each of q, k and v."""

    shards: tuple[torch.Tensor, ...]
    spec: P | None
    dim: int | None
    heads: int | None = None


def _model_family(model: torch.nn.Module, family: str | None) -> str:
    if family is not None:
        return family
    name = getattr(model, "family", None)
    if name is None:
        raise ValueError("shard_model_variables needs the model's weight-layout family "
                         "(family=...; the zoo records it, zoo.model_family)")
    return name


def parameter_specs(model: torch.nn.Module, family: str | None = None,
                    n_model: int = 1) -> dict[str, tuple[P | None, Any]]:
    """State-dict key -> (the spec after the divisibility fallback for a
    model axis of ``n_model``, the FlaxLeaf).  A partitioned Flax axis that
    ``n_model`` does not divide is replicated instead (JAX's rule)."""
    from ..models.convert import flax_layout

    out = {}
    state = model.state_dict()
    for key, leaf in flax_layout(model, _model_family(model, family)).items():
        flax_t = leaf.to_flax(torch.empty_like(state[key], device="meta"))
        spec = tensor_parallel_spec((leaf.collection, *leaf.path), flax_t)
        if spec is not None:
            # replicate instead of shard when the partitioned dim does not
            # divide the model axis (e.g. EfficientNet's tiny SE squeeze
            # channels)
            for dim, axis in enumerate(spec):
                if axis == "model" and flax_t.shape[dim] % n_model:
                    spec = None
                    break
        out[key] = (spec, leaf)
    return out


def _torch_shards(t: torch.Tensor, spec: P, leaf, n_model: int) -> tuple[list, int, int | None]:
    """The ``n_model`` torch shards of ``t`` under the Flax ``spec``: cut in
    the Flax layout, carried back to torch's; the torch axis they differ on;
    the head count of a head-aligned qkv entry."""
    flax_t = leaf.to_flax(t)
    axis = list(spec).index("model")
    parts = [leaf.from_flax(c).contiguous() for c in torch.tensor_split(flax_t, n_model, axis)]
    dims = [d for d in range(t.ndim) if parts[0].shape[d] != t.shape[d]]
    if len(dims) != 1:
        raise AssertionError(f"a shard of {tuple(t.shape)} differs on axes {dims}")
    heads = int(flax_t.shape[2]) if flax_t.ndim == 4 and axis == 2 else (
        int(flax_t.shape[1]) if flax_t.ndim == 3 and axis == 1 else None)
    return parts, dims[0], heads


def shard_model_variables(model: torch.nn.Module, mesh: Mesh,
                          tensor_parallel: bool = False,
                          family: str | None = None) -> dict[str, PlacedVariable]:
    """Place the model's state dict on the mesh.

    Default: fully replicated, every device the whole tensor.  With
    ``tensor_parallel=True`` and a model axis > 1, entries matching
    ``tensor_parallel_spec`` (ViT/Swin qkv and MLP, ResNet stage convs,
    classifier heads, VGG's classifier pair) are cut over 'model': the
    device at model index j holds slot j's shard.  ``family`` is the
    model's weight-layout family (``zoo.model_family``)."""
    n_model = mesh.shape["model"]
    state = model.state_dict()
    devices = mesh.flat_devices
    placed: dict[str, PlacedVariable] = {}
    if tensor_parallel and n_model > 1:
        specs = parameter_specs(model, family, n_model)
    else:
        specs = {}
    for key, t in state.items():
        spec, leaf = specs.get(key, (None, None))
        if spec is None:
            placed[key] = PlacedVariable(tuple(t.to(d) for d in devices), None, None)
            continue
        parts, dim, heads = _torch_shards(t.detach(), spec, leaf, n_model)
        shards = tuple(parts[i % n_model].to(d) for i, d in enumerate(devices))
        placed[key] = PlacedVariable(shards, spec, dim, heads)
    return placed
