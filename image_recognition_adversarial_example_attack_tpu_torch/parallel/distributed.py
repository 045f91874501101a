"""Several processes over torch.distributed, and the mesh that spans them
(port of ``parallel/distributed.py``).

Env-driven, as in the JAX package (the launcher contract):

  ADV_TPU_COORDINATOR   host:port of process 0
  ADV_TPU_NUM_PROCESSES total process count
  ADV_TPU_PROCESS_ID    this process's index

``maybe_initialize_distributed`` joins the process group from those
variables (``init_method="tcp://<coordinator>"``): NCCL where CUDA is
available, gloo on the CPU.  It is a no-op returning False when the
variables are unset, and returns True once joined; a second call is a
no-op too.  As in the JAX package one process owns all of its host's
devices: inside a process the mesh is a list of per-device shards
(``parallel/mesh.py``), across processes ``all_reduce_sum`` adds what the
JAX package's sharded program reduces over the data axis (the evaluation
counters, the gradients, the batch statistics of ``train_bn``).

``make_dcn_mesh`` lays the data axis out process-major, so each process's
devices hold contiguous rows of the global batch and only the data-axis
sums cross processes; ``process_local_batch`` places this process's rows.

Checked without a second card by ``tests/test_torch_distributed.py``: two
CPU processes over gloo reproduce the one-process counters and training
step.  NCCL runs here only at world size 1 (one card).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh, ShardedTensor, data_sharding, make_mesh, visible_devices

ENV_COORDINATOR = "ADV_TPU_COORDINATOR"
ENV_NUM_PROCESSES = "ADV_TPU_NUM_PROCESSES"
ENV_PROCESS_ID = "ADV_TPU_PROCESS_ID"


def maybe_initialize_distributed(backend: str | None = None) -> bool:
    """Join the process group from the env contract; True if active.

    ``backend`` defaults to ``"nccl"`` where CUDA is available and
    ``"gloo"`` otherwise.  Asking for NCCL without a card raises instead of
    falling back to gloo."""
    if dist.is_available() and dist.is_initialized():
        return True
    coordinator = os.environ.get(ENV_COORDINATOR)
    if not coordinator:
        return False
    if not dist.is_available():
        raise RuntimeError("torch.distributed is not available in this build of PyTorch")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("the NCCL backend needs a CUDA device; none is available "
                           "(use backend='gloo' on the CPU)")
    num = int(os.environ.get(ENV_NUM_PROCESSES, "1"))
    pid = int(os.environ.get(ENV_PROCESS_ID, "0"))
    dist.init_process_group(backend=backend, init_method=f"tcp://{coordinator}",
                            world_size=num, rank=pid)
    return True


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over every process: ``t`` itself at world size 1, else a
    summed copy (``dist.all_reduce``; NCCL takes CUDA tensors, gloo CPU and
    CUDA ones)."""
    if process_count() == 1:
        return t
    out = _for_backend(t.detach()).clone().contiguous()
    dist.all_reduce(out, op=dist.ReduceOp.SUM)
    return out.to(t.device)


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every process's ``t`` (the same shape on each), concatenated on axis
    0 in process order, on ``t``'s device; ``t`` itself at world size 1."""
    n = process_count()
    if n == 1:
        return t
    src = _for_backend(t.detach()).contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src)
    return torch.cat(parts).to(t.device)


def _for_backend(t: torch.Tensor) -> torch.Tensor:
    """NCCL reduces CUDA tensors: a CPU tensor goes to the current card."""
    if dist.get_backend() == "nccl" and not t.is_cuda:
        return t.to(torch.device("cuda", torch.cuda.current_device()))
    return t


def make_dcn_mesh(n_model: int = 1, devices: list[torch.device] | None = None) -> Mesh:
    """('data', 'model') mesh spanning every process, process-major.

    One process: ``make_mesh(n_model=n_model)``.  Several: this process's
    ``devices`` (default: every CUDA device it sees) form its rows of the
    grid, rows ``[index * local_rows, (index + 1) * local_rows)`` of the
    global data axis, so its devices hold contiguous data shards."""
    devices = list(devices) if devices is not None else visible_devices()
    n_proc = process_count()
    if n_proc == 1:
        return make_mesh(n_model=n_model, devices=devices)
    if len(devices) % n_model:
        raise ValueError(f"{len(devices)} local devices not divisible by model={n_model}")
    local = make_mesh(n_model=n_model, devices=devices)
    return Mesh(local.devices, process_count=n_proc, process_index=process_index())


def process_local_batch(x_global: np.ndarray | torch.Tensor, mesh: Mesh) -> ShardedTensor:
    """This process's contiguous rows of the global batch, placed over its
    devices (sharded over 'data').  ``x_global`` is the full ``[B, ...]``
    array, the same on every process (a seeded decode order)."""
    return data_sharding(mesh).place(x_global)
