"""Model registry and weight resolution (port of ``models/zoo.py``: all 18
of its names, the ``resnet50``, ``resnet50_robust``, ``resnet_tiny`` and
``tiny`` entries, the transfer study's ``vgg19``, ``densenet121``,
``vit_b_16``, ``swin_t``, ``efficientnet_b0``, ``mobilenet_v2`` and
``convnext_tiny``, the CIFAR family's ``wrn28_10``, ``wrn34_10``,
``wrn_tiny``, ``preact_resnet18`` and ``wrn28_10_robust``, and the certified
family's ``ibp_cnn7`` and ``ibp_tiny``).  ``model_meta`` gives each name the
JAX zoo's input size and normalization: 32x32 and the CIFAR-10 statistics
for the CIFAR family (mean 0 / std 1 for ``wrn28_10_robust`` and the IBP
nets), 224x224 and the ImageNet statistics otherwise.

Weight resolution for ``load_model(name)``, the JAX zoo's order:

1. an explicit ``weights=`` file: a Flax ``.msgpack`` (``source="cache"``) or
   a torchvision ``.pth``/``.pt`` (leading ``module.``/``model.`` stripped,
   ``source="converted"``),
2. ``$ADV_TPU_WEIGHTS_DIR/<name>.msgpack`` (default directory ``weights``),
3. ``$ADV_TPU_WEIGHTS_DIR/<name>.pth``,
4. a deterministic random init from a ``torch.Generator`` seeded with the
   constant ``INIT_SEED`` (0, as the JAX zoo's ``PRNGKey(0)``), with a loud
   warning and ``source="random"``.  The CLI's ``--seed`` drives only the
   attack's randomness, never the weights.

Both file kinds load with ``strict=True``: a file with missing or extra
entries raises instead of loading part of a model.  As in the JAX zoo, a
``.pth`` load (``cache_converted=True``, the default) then writes the
converted weights as a Flax msgpack file to
``$ADV_TPU_WEIGHTS_DIR/<name>.msgpack``, so the next load finds the cache
(``source="cache"``) in either package; ``cli/import_weights.py`` loads with
``cache_converted=False`` and writes the file itself.  A ``.pth`` is
refused (ValueError) for a name that the JAX package has no converter for
(``CONVERTIBLE``: not ``tiny``, ``wrn_tiny`` or the IBP nets).

The random init draws Flax's default distributions (LeCun-normal kernels,
the packed qkv projection's with fan-in D; unit BatchNorm and LayerNorm
scale, unit BatchNorm variance; zero biases and means; ViT's class token
zero; ViT's position embedding and Swin's relative position bias table
normal with standard deviation 0.02; ConvNeXt's layer scale the constant
1e-6), but not Flax's bits: ``PRNGKey(0)``
cannot be reproduced without JAX.  To run the JAX package's exact weights,
carry them across with ``models.convert.from_jax_variables``.

In a bfloat16 model, BatchNorm and LayerNorm keep float32 parameters and
normalize in float32, as Flax's do, and an ``IBPNet`` keeps float32
parameters (cast to the input's dtype in its forward), so that its interval
bounds read the float32 weights as the JAX package's do.

Every parameter has ``requires_grad`` off, so ``torch.autograd.grad`` with
respect to the input builds only the input-gradient chain.

``int8=True`` builds the model in quantized-inference mode (``ops/int8.py``:
the JAX families' hooked convs and Dense layers as ``QuantConv2d`` /
``QuantLinear``): the same parameter tree, so every weight-resolution path
above works unchanged, and the random init draws the same weights.
"""

from __future__ import annotations

import inspect
import math
import os
import warnings
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable

import numpy as np
import torch
from torch import nn

from ..core.constants import (CIFAR10_MEAN, CIFAR10_STD, IMAGE_SIZE, IMAGENET_MEAN,
                              IMAGENET_STD)
from ..core.device import resolve_device
from .convert import from_jax_variables, load_torch_checkpoint, to_jax_variables
from .convnext import CNBlock, convnext_tiny
from .densenet import densenet121
from .efficientnet import efficientnet_b0
from .flax_msgpack import read_variables, save_variables
from .ibp import IBPNet, ibp_cnn7, ibp_tiny
from .mobilenet import mobilenet_v2
from .preactresnet import preact_resnet18
from .resnet import FrozenBatchNorm2d, resnet50, resnet_tiny
from .swin import WindowAttention, swin_t
from .tiny import TinyCNN
from .vgg import vgg19
from .vit import Encoder, LayerNorm, SelfAttention, ViT, vit_b_16
from .wideresnet import wrn28_10, wrn34_10, wrn_tiny


@dataclass
class ModelBundle:
    """A loaded model: module (in eval mode, on its device) + metadata."""

    name: str
    model: nn.Module
    source: str  # "cache" | "converted" | "random"
    dtype: torch.dtype
    device: torch.device
    mean: np.ndarray = field(default_factory=lambda: IMAGENET_MEAN.copy())
    std: np.ndarray = field(default_factory=lambda: IMAGENET_STD.copy())
    input_size: int = IMAGE_SIZE


# name -> (weight-layout family for models.convert, constructor taking int8=)
_REGISTRY: dict[str, tuple[str, Callable[..., nn.Module]]] = {
    "resnet50": ("resnet", resnet50),
    # the adversarially trained arm (--model_type robust): resnet50's
    # architecture with its own weights file; the caller sets the identity
    # normalization
    "resnet50_robust": ("resnet", resnet50),
    "resnet_tiny": ("resnet", resnet_tiny),
    "tiny": ("tiny", lambda int8=False: TinyCNN(num_classes=1000, int8=int8)),
    # the transfer study's families
    "vgg19": ("vgg", vgg19),
    "densenet121": ("densenet", densenet121),
    "vit_b_16": ("vit", vit_b_16),
    "swin_t": ("swin", swin_t),
    "efficientnet_b0": ("efficientnet", efficientnet_b0),
    "mobilenet_v2": ("mobilenet", mobilenet_v2),
    "convnext_tiny": ("convnext", convnext_tiny),
    # the small-image (CIFAR) family, 10 classes by default
    "wrn28_10": ("wideresnet", wrn28_10),
    "wrn34_10": ("wideresnet", wrn34_10),
    "wrn_tiny": ("wideresnet", wrn_tiny),
    "preact_resnet18": ("preactresnet", preact_resnet18),
    # the RobustBench-style robust arm: wrn28_10's architecture with its own
    # weights file, reading raw [0,1] pixels (identity normalization, _META)
    "wrn28_10_robust": ("wideresnet", wrn28_10),
    # the certified family: plain conv/relu/dense stacks whose worst-case
    # logits under an L-inf ball are bounded in closed form (defenses/ibp.py)
    "ibp_cnn7": ("ibp", ibp_cnn7),
    "ibp_tiny": ("ibp", ibp_tiny),
}

# Per-model defaults beyond the ImageNet-224 convention (input_size, mean,
# std).  The CIFAR family reads 32x32 with the CIFAR-10 statistics; the
# robust WRN arm and the IBP nets read raw [0,1] pixels at 32x32 (identity
# normalization keeps an eps in pixel units).
_META: dict[str, dict] = {
    "wrn28_10": {"input_size": 32, "mean": CIFAR10_MEAN, "std": CIFAR10_STD},
    "wrn34_10": {"input_size": 32, "mean": CIFAR10_MEAN, "std": CIFAR10_STD},
    "wrn_tiny": {"input_size": 32, "mean": CIFAR10_MEAN, "std": CIFAR10_STD},
    "preact_resnet18": {"input_size": 32, "mean": CIFAR10_MEAN, "std": CIFAR10_STD},
    "wrn28_10_robust": {"input_size": 32, "mean": np.zeros(3, np.float32),
                        "std": np.ones(3, np.float32)},
    "ibp_cnn7": {"input_size": 32, "mean": np.zeros(3, np.float32),
                 "std": np.ones(3, np.float32)},
    "ibp_tiny": {"input_size": 32, "mean": np.zeros(3, np.float32),
                 "std": np.ones(3, np.float32)},
}


# the names a torchvision ``.pth`` converts for: the keys of the JAX
# package's ``models/convert.py::RENAMES``
CONVERTIBLE = frozenset({
    "resnet50", "resnet50_robust", "resnet_tiny", "vgg19", "vit_b_16", "swin_t",
    "densenet121", "efficientnet_b0", "mobilenet_v2", "convnext_tiny", "wrn28_10",
    "wrn34_10", "wrn28_10_robust", "preact_resnet18",
})


def model_meta(name: str) -> dict:
    """Default input_size/mean/std for a registered model name: 224 and the
    ImageNet statistics unless ``_META`` says otherwise."""
    meta = {"input_size": IMAGE_SIZE, "mean": IMAGENET_MEAN, "std": IMAGENET_STD}
    meta.update(_META.get(name, {}))
    return meta


def list_models() -> list[str]:
    return sorted(_REGISTRY)


def model_family(name: str) -> str:
    """The weight-layout family of a registered model, as
    ``models.convert.from_jax_variables`` and ``to_jax_variables`` take it."""
    return _REGISTRY[name][0]


def build_model(name: str, int8: bool = False) -> nn.Module:
    """A registered model's module, its weights uninitialized; ``int8=True``
    in quantized-inference mode, which a constructor without an ``int8``
    parameter refuses with ValueError."""
    ctor = _REGISTRY[name][1]
    if not int8:
        return ctor()
    if "int8" not in inspect.signature(ctor).parameters:
        raise ValueError(f"model '{name}' does not support int8 inference yet")
    return ctor(int8=True)


def weights_dir() -> Path:
    return Path(os.environ.get("ADV_TPU_WEIGHTS_DIR", "weights"))


INIT_SEED = 0


@torch.no_grad()
def random_init_(model: nn.Module) -> nn.Module:
    """Flax's default init distributions, drawn in module order from a
    generator seeded with ``INIT_SEED``."""
    g = torch.Generator().manual_seed(INIT_SEED)

    def lecun_(w: torch.Tensor, fan_in: int) -> None:
        w.normal_(0.0, math.sqrt(1.0 / fan_in), generator=g)

    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            lecun_(m.weight, m.weight[0].numel())
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, SelfAttention):  # packed qkv, fan-in D
            lecun_(m.in_proj_weight, m.in_proj_weight.shape[1])
            m.in_proj_bias.zero_()
        elif isinstance(m, (FrozenBatchNorm2d, LayerNorm)):
            m.reset_parameters()  # scale 1, bias 0 (BatchNorm: mean 0, var 1)
        elif isinstance(m, ViT):
            m.class_token.zero_()
        elif isinstance(m, Encoder):
            m.pos_embedding.normal_(0.0, 0.02, generator=g)
        elif isinstance(m, WindowAttention):
            m.relative_position_bias_table.normal_(0.0, 0.02, generator=g)
        elif isinstance(m, CNBlock):
            m.layer_scale.fill_(1e-6)
    return model


def set_compute_dtype(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Convs, GEMMs and attention compute in ``dtype``; BatchNorm and
    LayerNorm keep float32 parameters and normalize in float32, as Flax's
    do for a bfloat16 model, and an IBPNet keeps float32 parameters."""
    model.to(dtype=dtype)
    for m in model.modules():
        if isinstance(m, (FrozenBatchNorm2d, LayerNorm, IBPNet)):
            m.float()
    return model


def load_model(name: str, dtype: torch.dtype = torch.float32,
               weights: str | Path | None = None,
               device: torch.device | str | None = "cuda",
               int8: bool = False, cache_converted: bool = True) -> ModelBundle:
    """Resolve a model by name; see the module docstring for the order
    (and for ``int8`` and ``cache_converted``).

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
    model = build_model(name, int8=int8)

    candidates: list[Path] = []
    if weights is not None:
        candidates.append(Path(weights))
    candidates.append(weights_dir() / f"{name}.msgpack")
    candidates.append(weights_dir() / f"{name}.pth")
    source = "random"
    for path in candidates:
        if not path.is_file():
            continue
        if path.suffix == ".msgpack":
            state, source = from_jax_variables(read_variables(path), model_family(name)), "cache"
        elif path.suffix in (".pth", ".pt"):
            if name not in CONVERTIBLE:
                raise ValueError(f"no torch->flax converter registered for '{name}'")
            state, source = load_torch_checkpoint(path), "converted"
        else:
            continue
        model.load_state_dict(state, strict=True)
        if source == "converted" and cache_converted:
            # still float32 here: the cache holds the checkpoint's values
            save_variables(to_jax_variables(model, model_family(name)),
                           weights_dir() / f"{name}.msgpack")
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
