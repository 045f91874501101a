"""Weights across the two frameworks (port of ``models/convert.py``).

``from_jax_variables`` is the bridge that carries the JAX package's Flax
variables into this package's ResNet: it inverts that package's
``convert_state_dict`` and ``resnet_rename`` (conv kernel HWIO -> OIHW, Dense
IO -> OI, ``scale`` -> ``weight``, ``mean``/``var`` -> ``running_mean``/
``running_var``, ``layer1_0/downsample_conv`` -> ``layer1.0.downsample.0``).
``load_torch_checkpoint`` reads a torchvision-style ``.pth``.
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


def from_jax_variables(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """``{"params", "batch_stats"}`` Flax tree of numpy arrays -> a torch
    state dict for ``models.resnet.ResNet``. Array dtypes are kept. Raises on
    any key it cannot map."""
    sd: dict[str, torch.Tensor] = {}
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise ValueError(f"unmapped variable collections: {sorted(unknown)}")

    def put(key: str, arr) -> None:
        sd[key] = torch.from_numpy(np.ascontiguousarray(np.asarray(arr)))

    for path, arr in _flatten(variables.get("params", {})):
        module, leaf = torch_module_path(path[:-1]), path[-1]
        arr = np.asarray(arr)
        if leaf == "kernel" and arr.ndim == 4:     # conv HWIO -> OIHW
            put(f"{module}.weight", arr.transpose(3, 2, 0, 1))
        elif leaf == "kernel" and arr.ndim == 2:   # Dense IO -> OI
            put(f"{module}.weight", arr.T)
        elif leaf == "scale" and arr.ndim == 1:    # BatchNorm gamma
            put(f"{module}.weight", arr)
        elif leaf == "bias" and arr.ndim == 1:
            put(f"{module}.bias", arr)
        else:
            raise ValueError(f"unmapped Flax parameter: {'/'.join(path)} "
                             f"with shape {arr.shape}")
    for path, arr in _flatten(variables.get("batch_stats", {})):
        module, leaf = torch_module_path(path[:-1]), path[-1]
        if leaf == "mean":
            put(f"{module}.running_mean", arr)
            sd[f"{module}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
        elif leaf == "var":
            put(f"{module}.running_var", arr)
        else:
            raise ValueError(f"unmapped Flax batch statistic: {'/'.join(path)}")
    return sd


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
