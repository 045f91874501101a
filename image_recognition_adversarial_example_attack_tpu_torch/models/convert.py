"""Weights across the two frameworks (port of ``models/convert.py``).

``from_jax_variables(variables, family)`` carries the JAX package's Flax
variables into the port's model of a weight-layout family (one of
``FAMILIES``; the zoo records each registered model's, ``zoo.model_family``):
it inverts that package's ``convert_state_dict``, the family's rename (``resnet_rename``,
``vgg_rename``, ``densenet_rename``, ``vit_rename``, ``swin_rename``) and,
for the attention families, ``conform_qkv_layout``.  Leaves: conv kernel
HWIO -> OIHW, Dense IO -> OI, ``scale`` -> ``weight``, ``mean``/``var`` ->
``running_mean``/``running_var``, the head-aligned qkv kernel ``[D, 3, H,
hd]`` / bias ``[3, H, hd]`` -> torch's packed ``[3D, D]`` / ``[3D]`` (a
row-major reshape and a transpose), and the bare parameters
(``class_token``, ``pos_embedding``, ``relative_position_bias_table``) as
they are; Swin's static ``relative_position_index`` buffer is computed.
``to_jax_variables(model, family)`` goes the other way, so that a port model
can be written as a Flax msgpack file (``models.flax_msgpack``).
``load_torch_checkpoint`` reads a torchvision-style ``.pth``.  A key the
bridge cannot map raises.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any, Callable, Mapping

import numpy as np
import torch

_PREFIXES = ("module.", "model.")


def _flatten(tree: Mapping, prefix: tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


# ---------------------------------------------------------------------------
# Module paths, family by family: Flax path (a tuple) <-> torch path (dots)
# ---------------------------------------------------------------------------

def torch_module_path(flax_path: tuple[str, ...]) -> str:
    """ResNet: ("layer1_0", "downsample_conv") -> "layer1.0.downsample.0"."""
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
    """ResNet: "layer1.0.downsample.0" -> ("layer1_0", "downsample_conv"),
    the inverse of ``torch_module_path``."""
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


def _vgg_torch(path: tuple[str, ...]) -> str:
    """("features_0",) -> "features.0"; ("classifier_6",) -> "classifier.6"."""
    return ".".join(re.sub(r"^(features|classifier)_(\d+)$", r"\1.\2", p) for p in path)


def _vgg_flax(path: str) -> tuple[str, ...]:
    return tuple(re.sub(r"(features|classifier)\.(\d+)", r"\1_\2", path).split("."))


def _densenet_torch(path: tuple[str, ...]) -> str:
    """features_conv0 -> features.conv0; denseblock1_denselayer2 ->
    features.denseblock1.denselayer2; transition1 -> features.transition1."""
    head, rest = path[0], list(path[1:])
    if head.startswith("features_"):
        head = "features." + head[len("features_"):]
    elif head.startswith("denseblock"):
        head = "features." + head.replace("_", ".")
    elif head.startswith("transition"):
        head = "features." + head
    return ".".join([head, *rest])


def _densenet_flax(path: str) -> tuple[str, ...]:
    parts = path.split(".")
    if parts[0] != "features":
        return tuple(parts)
    if parts[1].startswith("denseblock"):
        return (f"{parts[1]}_{parts[2]}", *parts[3:])
    if parts[1].startswith("transition"):
        return tuple(parts[1:])
    return (f"features_{parts[1]}", *parts[2:])


_VIT_TORCH = {"out": "out_proj", "mlp_linear_1": "mlp.0", "mlp_linear_2": "mlp.3"}
_VIT_FLAX = {v: k for k, v in _VIT_TORCH.items()}


def _vit_torch(path: tuple[str, ...]) -> str:
    """encoder_layer_3/self_attention/out -> encoder.layers.encoder_layer_3.
    self_attention.out_proj; ln -> encoder.ln; head -> heads.head."""
    if path == ("ln",):
        return "encoder.ln"
    if path == ("head",):
        return "heads.head"
    out = [_VIT_TORCH.get(p, p) for p in path]
    if out[0].startswith("encoder_layer_"):
        out = ["encoder", "layers", *out]
    return ".".join(out)


def _vit_flax(path: str) -> tuple[str, ...]:
    if path in ("encoder.ln", "heads.head"):
        return (path.split(".")[1],)
    path = path.removeprefix("encoder.layers.")
    for torch_name, flax_name in _VIT_FLAX.items():
        path = re.sub(rf"(^|\.){re.escape(torch_name)}($|\.)", rf"\1{flax_name}\2", path)
    return tuple(path.split("."))


def _swin_torch(path: tuple[str, ...]) -> str:
    """patch_conv -> features.0.0; patch_norm -> features.0.2;
    stage{S}_block{B}/.. -> features.{2S-1}.{B}..; merge{M} -> features.{2M};
    mlp_0/mlp_3 -> mlp.0/mlp.3."""
    head, rest = path[0], [re.sub(r"^mlp_(\d+)$", r"mlp.\1", p) for p in path[1:]]
    if head in ("patch_conv", "patch_norm"):
        head = "features.0." + ("0" if head == "patch_conv" else "2")
    elif m := re.fullmatch(r"stage(\d+)_block(\d+)", head):
        head = f"features.{2 * int(m[1]) - 1}.{m[2]}"
    elif m := re.fullmatch(r"merge(\d+)", head):
        head = f"features.{2 * int(m[1])}"
    return ".".join([head, *rest])


def _swin_flax(path: str) -> tuple[str, ...]:
    parts = path.split(".")
    if parts[0] != "features":
        return tuple(parts)
    idx = int(parts[1])
    if idx == 0:
        head, rest = ("patch_conv" if parts[2] == "0" else "patch_norm"), parts[3:]
    elif idx % 2:
        head, rest = f"stage{(idx + 1) // 2}_block{parts[2]}", parts[3:]
    else:
        head, rest = f"merge{idx // 2}", parts[2:]
    joined = re.sub(r"(^|\.)mlp\.(\d+)", r"\1mlp_\2", ".".join(rest))
    return (head, *[p for p in joined.split(".") if p])


_FAMILIES: dict[str, tuple[Callable, Callable]] = {
    "resnet": (torch_module_path, flax_module_path),
    "tiny": (".".join, lambda path: tuple(path.split("."))),
    "vgg": (_vgg_torch, _vgg_flax),
    "densenet": (_densenet_torch, _densenet_flax),
    "vit": (_vit_torch, _vit_flax),
    "swin": (_swin_torch, _swin_flax),
    # IBPNet's conv_{i} / dense_{i} carry the Flax names
    "ibp": (".".join, lambda path: tuple(path.split("."))),
}


FAMILIES = tuple(_FAMILIES)


def _paths(family: str, direction: int) -> Callable:
    if family not in _FAMILIES:
        raise ValueError(f"no weight bridge for family '{family}'; known: {FAMILIES}")
    return _FAMILIES[family][direction]


# ---------------------------------------------------------------------------
# The bridge
# ---------------------------------------------------------------------------

def _tensor(arr) -> torch.Tensor:
    """A Flax leaf (numpy array, or a torch tensor where numpy has no dtype,
    as for bfloat16) as a torch tensor."""
    if isinstance(arr, torch.Tensor):
        return arr
    return torch.from_numpy(np.ascontiguousarray(np.asarray(arr)))


def _relative_position_index(table_rows: int) -> torch.Tensor:
    from .swin import relative_position_index

    window = (int(round(table_rows ** 0.5)) + 1) // 2  # rows = (2 ws - 1)^2
    return torch.from_numpy(relative_position_index(window).reshape(-1))


def from_jax_variables(variables: Mapping[str, Any], family: str) -> dict[str, torch.Tensor]:
    """``{"params", "batch_stats"}`` Flax tree of numpy arrays (or torch
    tensors) -> a torch state dict for the port's model of ``family``.
    Array dtypes are kept.  Raises on any key it cannot map."""
    to_torch = _paths(family, 0)
    sd: dict[str, torch.Tensor] = {}
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise ValueError(f"unmapped variable collections: {sorted(unknown)}")

    def put(key: str, t: torch.Tensor) -> None:
        sd[key] = t.contiguous()

    for path, arr in _flatten(variables.get("params", {})):
        module, leaf = path[:-1], path[-1]
        t = _tensor(arr)
        if family in ("vit", "swin") and module[-1:] == ("qkv",) and leaf in ("kernel", "bias"):
            # head-aligned [D, 3, H, hd] / [3, H, hd] -> packed [3D, D] / [3D]
            t = t.reshape(t.shape[0], -1).T if leaf == "kernel" else t.reshape(-1)
            if family == "vit":
                put(f"{to_torch(module[:-1])}.in_proj_{'weight' if leaf == 'kernel' else 'bias'}", t)
            else:
                put(f"{to_torch(module)}.{'weight' if leaf == 'kernel' else 'bias'}", t)
        elif family == "vit" and not module and leaf in ("class_token", "pos_embedding"):
            put(leaf if leaf == "class_token" else "encoder.pos_embedding", t)
        elif family == "swin" and leaf == "relative_position_bias_table" and t.ndim == 2:
            put(f"{to_torch(module)}.{leaf}", t)
            sd[f"{to_torch(module)}.relative_position_index"] = _relative_position_index(
                t.shape[0])
        elif leaf == "kernel" and t.ndim == 4:   # conv HWIO -> OIHW
            put(f"{to_torch(module)}.weight", t.permute(3, 2, 0, 1))
        elif leaf == "kernel" and t.ndim == 2:   # Dense IO -> OI
            put(f"{to_torch(module)}.weight", t.T)
        elif leaf == "scale" and t.ndim == 1:    # BatchNorm / LayerNorm gamma
            put(f"{to_torch(module)}.weight", t)
        elif leaf == "bias" and t.ndim == 1:
            put(f"{to_torch(module)}.bias", t)
        else:
            raise ValueError(f"unmapped Flax parameter: {'/'.join(path)} "
                             f"with shape {tuple(t.shape)}")
    for path, arr in _flatten(variables.get("batch_stats", {})):
        module, leaf = to_torch(path[:-1]), path[-1]
        if leaf == "mean":
            put(f"{module}.running_mean", _tensor(arr))
            sd[f"{module}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
        elif leaf == "var":
            put(f"{module}.running_var", _tensor(arr))
        else:
            raise ValueError(f"unmapped Flax batch statistic: {'/'.join(path)}")
    return sd


def to_jax_variables(model: torch.nn.Module, family: str) -> dict[str, dict]:
    """The port's model of ``family`` -> ``{"params", ["batch_stats"]}``
    Flax tree of numpy arrays, the inverse of ``from_jax_variables``.
    bfloat16 tensors are written as float32 (exactly), the dtype of Flax's
    parameters; a family without BatchNorm has no ``batch_stats``, as its
    Flax module has none."""
    to_flax = _paths(family, 1)
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
        if leaf in ("num_batches_tracked", "relative_position_index"):
            continue
        if family == "vit" and key in ("class_token", "encoder.pos_embedding"):
            put("params", (leaf,), t)
            continue
        if leaf.startswith("in_proj_") or (family == "swin" and module.endswith(".qkv")):
            # packed [3D, D] / [3D] -> head-aligned [D, 3, H, hd] / [3, H, hd]
            attn = module if leaf.startswith("in_proj_") else module.rpartition(".")[0]
            heads = model.get_submodule(attn).num_heads
            path = to_flax(attn) + ("qkv",) if leaf.startswith("in_proj_") else to_flax(module)
            if leaf.endswith("weight"):
                put("params", path + ("kernel",), t.T.reshape(t.shape[1], 3, heads, -1))
            else:
                put("params", path + ("bias",), t.reshape(3, heads, -1))
            continue
        path = to_flax(module)
        if leaf == "relative_position_bias_table":
            put("params", path + (leaf,), t)
        elif leaf == "weight" and t.ndim == 4:
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
    if not tree["batch_stats"]:
        del tree["batch_stats"]
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
    """A ``.pth``/``.pt`` state dict on the CPU, prefixes stripped, and
    torchvision's other spelling of ViT's MLP (``mlp.linear_1``/``linear_2``,
    older releases) written as ``mlp.0``/``mlp.3``, as ``vit_rename`` reads
    both."""
    obj = torch.load(str(path), map_location="cpu", weights_only=True)
    if isinstance(obj, Mapping) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {re.sub(r"\.mlp\.linear_([12])\.",
                   lambda m: ".mlp.0." if m[1] == "1" else ".mlp.3.", k): v
            for k, v in strip_prefixes(obj).items()}
