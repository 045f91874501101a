"""Model registry and weight resolution (port of ``models/zoo.py``, the
``resnet50``, ``resnet50_robust`` and ``resnet_tiny`` entries).

Weight resolution for ``load_model(name)``:

1. an explicit ``weights=`` ``.pth`` (leading ``module.``/``model.`` stripped),
2. ``$ADV_TPU_WEIGHTS_DIR/<name>.pth`` (default directory ``weights``),
3. a deterministic random init from a ``torch.Generator`` seeded with the
   constant ``INIT_SEED`` (0, as the JAX zoo's ``PRNGKey(0)``), with a loud
   warning and ``source="random"``.  The CLI's ``--seed`` drives only the
   attack's randomness, never the weights.

The random init draws Flax's default distributions (LeCun-normal kernels,
unit BatchNorm scale and variance, zero biases and means), but not Flax's
bits: ``PRNGKey(0)`` cannot be reproduced without JAX.  To run the JAX
package's exact weights, carry them across with
``models.convert.from_jax_variables``.

Every parameter has ``requires_grad`` off, so ``torch.autograd.grad`` with
respect to the input builds only the input-gradient chain.
"""

from __future__ import annotations

import math
import os
import warnings
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable

import numpy as np
import torch
from torch import nn

from ..core.constants import IMAGE_SIZE, IMAGENET_MEAN, IMAGENET_STD
from ..core.device import resolve_device
from .convert import load_torch_checkpoint
from .resnet import FrozenBatchNorm2d, resnet50, resnet_tiny


@dataclass
class ModelBundle:
    """A loaded model: module (in eval mode, on its device) + metadata."""

    name: str
    model: nn.Module
    source: str  # "converted" | "random"
    dtype: torch.dtype
    device: torch.device
    mean: np.ndarray = field(default_factory=lambda: IMAGENET_MEAN.copy())
    std: np.ndarray = field(default_factory=lambda: IMAGENET_STD.copy())
    input_size: int = IMAGE_SIZE


_REGISTRY: dict[str, Callable[[], nn.Module]] = {
    "resnet50": resnet50,
    # the adversarially trained arm (--model_type robust): resnet50's
    # architecture with its own weights file; the caller sets the identity
    # normalization
    "resnet50_robust": resnet50,
    "resnet_tiny": resnet_tiny,
}


def model_meta(name: str) -> dict:
    """Default input_size/mean/std for a registered model name."""
    return {"input_size": IMAGE_SIZE, "mean": IMAGENET_MEAN, "std": IMAGENET_STD}


def list_models() -> list[str]:
    return sorted(_REGISTRY)


def weights_dir() -> Path:
    return Path(os.environ.get("ADV_TPU_WEIGHTS_DIR", "weights"))


INIT_SEED = 0


@torch.no_grad()
def random_init_(model: nn.Module) -> nn.Module:
    """Flax's default init distributions from a generator seeded with
    ``INIT_SEED``."""
    g = torch.Generator().manual_seed(INIT_SEED)
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            m.weight.normal_(0.0, math.sqrt(1.0 / fan_in), generator=g)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, FrozenBatchNorm2d):
            m.reset_parameters()  # scale 1, bias 0, mean 0, var 1
    return model


def set_compute_dtype(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Convs and the classifier compute in ``dtype``; BatchNorm keeps its
    float32 statistics and normalizes in float32, as Flax's BatchNorm does
    for a bfloat16 model."""
    model.to(dtype=dtype)
    for m in model.modules():
        if isinstance(m, FrozenBatchNorm2d):
            m.float()
    return model


def load_model(name: str, dtype: torch.dtype = torch.float32,
               weights: str | Path | None = None,
               device: torch.device | str | None = "cuda") -> ModelBundle:
    """Resolve a model by name; see the module docstring for the order.

    float32 means float32 on the card too: TF32 is turned off for cuDNN
    convolutions and cuBLAS matmuls, which PyTorch otherwise allows for
    convolutions by default.
    """
    if name not in _REGISTRY:
        raise ValueError(f"unknown model '{name}'; known: {list_models()}")
    device = resolve_device(device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    meta = model_meta(name)
    model = _REGISTRY[name]()

    candidates: list[Path] = []
    if weights is not None:
        candidates.append(Path(weights))
    candidates.append(weights_dir() / f"{name}.pth")
    source = "random"
    for path in candidates:
        if path.is_file() and path.suffix in (".pth", ".pt"):
            model.load_state_dict(load_torch_checkpoint(path), strict=True)
            source = "converted"
            break
    else:
        warnings.warn(
            f"no weights found for '{name}' (searched {[str(c) for c in candidates]}); "
            "using deterministic random init — predictions are NOT ImageNet-accurate. "
            "Drop a torchvision state dict at "
            f"{weights_dir() / (name + '.pth')} to enable pretrained behavior.",
            stacklevel=2,
        )
        random_init_(model)

    model.requires_grad_(False)
    model.eval()
    set_compute_dtype(model, dtype)
    model.to(device=device, memory_format=torch.channels_last)
    return ModelBundle(name=name, model=model, source=source, dtype=dtype,
                       device=device, mean=meta["mean"].copy(),
                       std=meta["std"].copy(),
                       input_size=int(meta["input_size"]))
