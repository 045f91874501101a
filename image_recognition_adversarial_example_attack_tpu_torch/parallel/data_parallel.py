"""Data parallelism over the mesh: the evaluation paths on a batch sharded
over the 'data' axis (port of what the JAX package gets by jitting the same
functions with ``in_shardings=data_sharding(mesh)``).

Each data row's shard runs the one-device function on its own device, one
shard after another (nothing in a shard's work waits for the host, so the
cards of a node overlap); the per-sample outputs stay sharded, and the
counters are summed over the shards, then over the processes
(``parallel.distributed.all_reduce_sum``).  The result is the one-device
run's:

- random draws go through ``core.rng.shard_generators``: a shard's PGD
  start is its rows of the unsharded start (on a card the noise kernel's
  Philox counter is offset by the shard's first element; on the CPU the
  whole batch's uniforms are drawn once), never a draw per shard;
- UAP takes a sharded set itself (``attacks.uap.uap_attack``: each
  shard adds its rows' part of the shared delta's gradient, in row order);
- on a card each shard launches the ``pgd_step``, noise and ``quantize``
  kernels on its own device.

A model is a ``parallel.mesh.PerDevice`` (one replica a device, built on first use) or a
plain callable used for every shard; on ``[cpu] * k`` (the tests) and on
one card holding several slots, one replica serves every shard.
"""

from __future__ import annotations

import copy
from dataclasses import replace

import numpy as np
import torch

from ..attacks.api import predict_labels
from ..attacks.pgd import pgd_linf_attack
from ..core.rng import shard_generators
from ..eval.defense_eval import STAT_KEYS, DefenseEvalConfig, evaluate_defenses_batch
from .distributed import all_reduce_sum
from .mesh import Mesh, PerDevice, ShardedTensor, data_sharding, on_device


def replicate_module(model: torch.nn.Module) -> PerDevice:
    """One copy of ``model`` a device (``model`` itself on its own device)."""
    home = next(iter(model.parameters())).device

    def build(device: torch.device) -> torch.nn.Module:
        if device == home or (device.type == "cpu" and home.type == "cpu"):
            return model
        return copy.deepcopy(model).to(device)

    return PerDevice(build)


def replicate_fns(bundle, make_fns):
    """``make_fns(bundle)``'s functions (logits, features, ...) as one
    ``PerDevice`` each, over one replica of the bundle's model a device."""
    replicas = replicate_module(bundle.model)
    fns = PerDevice(lambda d: make_fns(replace(bundle, model=replicas(d), device=d)))
    n = len(fns(bundle.device))
    return tuple(PerDevice(lambda d, i=i: fns(d)[i]) for i in range(n))


def like(x: ShardedTensor, per_row: list[torch.Tensor]) -> ShardedTensor:
    """One ``[rows, ...]`` tensor a data row of ``x`` -> a ShardedTensor
    with ``x``'s sharding (each row's tensor on each of its devices)."""
    mesh = x.sharding.mesh
    shards = tuple(t.to(d) for t, row in zip(per_row, mesh.devices) for d in row)
    return ShardedTensor(shards, data_sharding(mesh))


def shard_labels(y: torch.Tensor | np.ndarray | ShardedTensor, mesh: Mesh) -> ShardedTensor:
    return y if isinstance(y, ShardedTensor) else data_sharding(mesh).place(
        torch.as_tensor(np.asarray(y) if not isinstance(y, torch.Tensor) else y.cpu()))


def generators_for(generator: torch.Generator, x: ShardedTensor):
    """One ``ShardGenerator`` a data shard of ``x``, over the global rows."""
    return shard_generators(generator, x.row_ranges(), int(x.shape[0]))


def sharded_predict(logits_fn, x: ShardedTensor) -> ShardedTensor:
    """[B] top-1 labels, sharded as ``x``."""
    return like(x, [predict_labels(on_device(logits_fn, s.device), s) for s in x.data_shards()])


def sharded_pgd_linf_attack(logits_fn, x: ShardedTensor, y: ShardedTensor, *, eps: float,
                            alpha: float, steps: int, generator: torch.Generator,
                            random_start: bool = True) -> ShardedTensor:
    """``attacks.pgd.pgd_linf_attack`` over a data-sharded batch: each shard
    on its own device, its random start its rows of the unsharded start."""
    outs = [pgd_linf_attack(on_device(logits_fn, xs.device), xs, ys, eps=eps, alpha=alpha,
                            steps=steps, generator=g, random_start=random_start)
            for xs, ys, g in zip(x.data_shards(), y.data_shards(), generators_for(generator, x))]
    return like(x, outs)


def _config_on(config: DefenseEvalConfig, device: torch.device) -> DefenseEvalConfig:
    """The config with the Mahalanobis detector's tensors on ``device``."""
    p = config.detector_params
    if p is None or not hasattr(p, "_fields"):
        return config
    moved = type(p)(*(t.to(device) if isinstance(t, torch.Tensor) else t for t in p))
    return replace(config, detector_params=moved)


def evaluate_defenses_sharded(logits_fn, features_fn, x: ShardedTensor, y: ShardedTensor,
                              detector_threshold: float, config: DefenseEvalConfig,
                              generator: torch.Generator,
                              eps_override: float | None = None) -> dict[str, ShardedTensor]:
    """``eval.defense_eval.evaluate_defenses_batch`` over a data-sharded
    batch: the six per-sample counter vectors and ``x_adv``, sharded as
    ``x``.  ``sharded_counts`` sums them."""
    per_row = []
    for xs, ys, g in zip(x.data_shards(), y.data_shards(), generators_for(generator, x)):
        dev = xs.device
        per_row.append(evaluate_defenses_batch(
            on_device(logits_fn, dev), on_device(features_fn, dev), xs, ys, detector_threshold,
            _config_on(config, dev), g, eps_override=eps_override))
    return {k: like(x, [o[k] for o in per_row]) for k in per_row[0]}


def sharded_counts(per_sample: dict[str, ShardedTensor], n_valid: int | None = None,
                   keys=STAT_KEYS) -> dict[str, int]:
    """The counters summed over the global rows below ``n_valid`` (every
    row when None), over this process's shards and then every process;
    ``count`` is the number of rows summed."""
    first = per_sample[keys[0]]
    total_rows = int(first.shape[0])
    n_valid = total_rows if n_valid is None else min(int(n_valid), total_rows)
    sums = None
    for i, (lo, hi) in enumerate(first.row_ranges()):
        take = max(0, min(hi, n_valid) - lo)
        part = torch.stack([per_sample[k].data_shards()[i][:take].sum().to(torch.int64)
                            for k in keys]).cpu()
        sums = part if sums is None else sums + part
    sums = all_reduce_sum(sums)
    out = {k: int(v) for k, v in zip(keys, sums.tolist())}
    out["count"] = n_valid
    return out
