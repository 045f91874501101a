"""Weights across the two frameworks (port of ``models/convert.py``).

``from_jax_variables`` is the bridge that carries the JAX package's Flax
variables into this package's ResNet: it inverts that package's
``convert_state_dict`` and ``resnet_rename`` (conv kernel HWIO -> OIHW, Dense
IO -> OI, ``scale`` -> ``weight``, ``mean``/``var`` -> ``running_mean``/
``running_var``, ``layer1_0/downsample_conv`` -> ``layer1.0.downsample.0``);
``to_jax_variables`` goes the other way, so that a port model can be written
as a Flax msgpack file (``models.flax_msgpack``).  ``load_torch_checkpoint``
reads a torchvision-style ``.pth``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

_PREFIXES = ("module.", "model.")


def _flatten(tree: Mapping, prefix: tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def torch_module_path(flax_path: tuple[str, ...]) -> str:
    """("layer1_0", "downsample_conv") -> "layer1.0.downsample.0"."""
    out: list[str] = []
    for p in flax_path:
        stage, sep, idx = p.partition("_")
        if p.startswith("layer") and sep and idx.isdigit():
            out += [stage, idx]
        elif p == "downsample_conv":
            out += ["downsample", "0"]
        elif p == "downsample_bn":
            out += ["downsample", "1"]
        else:
            out.append(p)
    return ".".join(out)


def flax_module_path(torch_path: str) -> tuple[str, ...]:
    """"layer1.0.downsample.0" -> ("layer1_0", "downsample_conv"): the
    inverse of ``torch_module_path``."""
    parts = torch_path.split(".")
    out: list[str] = []
    i = 0
    while i < len(parts):
        p = parts[i]
        nxt = parts[i + 1] if i + 1 < len(parts) else ""
        if p.startswith("layer") and nxt.isdigit():
            out.append(f"{p}_{nxt}")
            i += 2
        elif p == "downsample" and nxt in ("0", "1"):
            out.append("downsample_conv" if nxt == "0" else "downsample_bn")
            i += 2
        else:
            out.append(p)
            i += 1
    return tuple(out)


def _tensor(arr) -> torch.Tensor:
    """A Flax leaf (numpy array, or a torch tensor where numpy has no dtype,
    as for bfloat16) as a torch tensor."""
    if isinstance(arr, torch.Tensor):
        return arr
    return torch.from_numpy(np.ascontiguousarray(np.asarray(arr)))


def from_jax_variables(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """``{"params", "batch_stats"}`` Flax tree of numpy arrays (or torch
    tensors) -> a torch state dict for ``models.resnet.ResNet``. Array dtypes
    are kept. Raises on any key it cannot map."""
    sd: dict[str, torch.Tensor] = {}
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise ValueError(f"unmapped variable collections: {sorted(unknown)}")

    def put(key: str, t: torch.Tensor) -> None:
        sd[key] = t.contiguous()

    for path, arr in _flatten(variables.get("params", {})):
        module, leaf = torch_module_path(path[:-1]), path[-1]
        t = _tensor(arr)
        if leaf == "kernel" and t.ndim == 4:     # conv HWIO -> OIHW
            put(f"{module}.weight", t.permute(3, 2, 0, 1))
        elif leaf == "kernel" and t.ndim == 2:   # Dense IO -> OI
            put(f"{module}.weight", t.T)
        elif leaf == "scale" and t.ndim == 1:    # BatchNorm gamma
            put(f"{module}.weight", t)
        elif leaf == "bias" and t.ndim == 1:
            put(f"{module}.bias", t)
        else:
            raise ValueError(f"unmapped Flax parameter: {'/'.join(path)} "
                             f"with shape {tuple(t.shape)}")
    for path, arr in _flatten(variables.get("batch_stats", {})):
        module, leaf = torch_module_path(path[:-1]), path[-1]
        if leaf == "mean":
            put(f"{module}.running_mean", _tensor(arr))
            sd[f"{module}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
        elif leaf == "var":
            put(f"{module}.running_var", _tensor(arr))
        else:
            raise ValueError(f"unmapped Flax batch statistic: {'/'.join(path)}")
    return sd


def to_jax_variables(model: torch.nn.Module) -> dict[str, dict]:
    """The port's ResNet -> ``{"params", "batch_stats"}`` Flax tree of numpy
    arrays, the inverse of ``from_jax_variables``: conv OIHW -> HWIO, Linear
    OI -> IO, BatchNorm ``weight`` -> ``scale``.  bfloat16 tensors are
    written as float32 (exactly), the dtype of Flax's parameters."""
    tree: dict[str, dict] = {"params": {}, "batch_stats": {}}

    def put(collection: str, path: tuple[str, ...], t: torch.Tensor) -> None:
        node = tree[collection]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        if t.dtype == torch.bfloat16:
            t = t.float()
        node[path[-1]] = np.ascontiguousarray(t.detach().cpu().numpy())

    for key, t in model.state_dict().items():
        module, _, leaf = key.rpartition(".")
        path = flax_module_path(module)
        if leaf == "num_batches_tracked":
            continue
        if leaf == "weight" and t.ndim == 4:
            put("params", path + ("kernel",), t.permute(2, 3, 1, 0))
        elif leaf == "weight" and t.ndim == 2:
            put("params", path + ("kernel",), t.T)
        elif leaf == "weight" and t.ndim == 1:
            put("params", path + ("scale",), t)
        elif leaf == "bias":
            put("params", path + ("bias",), t)
        elif leaf == "running_mean":
            put("batch_stats", path + ("mean",), t)
        elif leaf == "running_var":
            put("batch_stats", path + ("var",), t)
        else:
            raise ValueError(f"unmapped state-dict entry: {key} with shape {tuple(t.shape)}")
    return tree


def strip_prefixes(state_dict: Mapping[str, Any]) -> dict[str, Any]:
    """Drop leading ``module.``/``model.`` wrappers (DataParallel and
    RobustBench checkpoints), as the JAX package's ``resnet_rename`` does."""
    out = {}
    for key, value in state_dict.items():
        while key.startswith(_PREFIXES):
            key = key.split(".", 1)[1]
        out[key] = value
    return out


def load_torch_checkpoint(path: str | Path) -> dict[str, torch.Tensor]:
    """A ``.pth``/``.pt`` state dict on the CPU, prefixes stripped."""
    obj = torch.load(str(path), map_location="cpu", weights_only=True)
    if isinstance(obj, Mapping) and "state_dict" in obj:
        obj = obj["state_dict"]
    return strip_prefixes(obj)
