"""Spec-driven convnets for interval-bound-propagation certification (port of
``models/ibp.py``): ``ibp_cnn7``, the CROWN-IBP "CNN7" benchmark net, and
``ibp_tiny``.

The architecture is data: a ``spec`` tuple of layer descriptors that both
``IBPNet.forward`` and the interval propagators (``defenses/ibp.py``,
``defenses/crown_ibp.py``) walk, so the certificate and the forward pass
cannot drift apart.  Layers are named ``conv_{i}`` / ``dense_{i}`` after
their spec index, as the Flax module's are, so the weight bridge
(``models/convert.py``, family ``"ibp"``) is a pure re-layout.

Two details of the Flax module are kept:

- ``SAME`` padding is Flax's: for a k x k conv at stride s on n pixels,
  ``ceil(n/s)`` outputs and a total pad of ``(ceil(n/s)-1)*s + k - n``,
  the smaller half first.  At stride 2 on an even input that is (0, 1),
  which neither ``padding="same"`` (refused at stride > 1) nor
  ``padding=1`` gives, so the pad is explicit (``conv_same``).
- ``flatten`` flattens in NHWC order, so the first dense layer reads its
  inputs in the JAX package's order.

Parameters stay float32 in a bfloat16 model (Flax's ``param_dtype``); the
forward casts them to the input's dtype.  Plain conv/relu/dense only: no
BatchNorm, whose batch statistics interval arithmetic cannot bound.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

# Layer descriptors (one source of truth for the model and the bounds):
#   ("conv", features, kernel, stride)   SAME conv with bias
#   ("relu",)
#   ("flatten",)
#   ("dense", features)

CNN7_SPEC = (
    ("conv", 64, 3, 1), ("relu",),
    ("conv", 64, 3, 1), ("relu",),
    ("conv", 128, 3, 2), ("relu",),
    ("conv", 128, 3, 1), ("relu",),
    ("conv", 128, 3, 1), ("relu",),
    ("flatten",),
    ("dense", 512), ("relu",),
    ("dense", 10),
)

TINY_SPEC = (
    ("conv", 8, 3, 2), ("relu",),
    ("conv", 16, 3, 2), ("relu",),
    ("flatten",),
    ("dense", 32), ("relu",),
    ("dense", 10),
)


def same_pads(n: int, kernel: int, stride: int) -> tuple[int, int]:
    """Flax's SAME padding (before, after) of one spatial axis of ``n``."""
    out = -(-int(n) // int(stride))
    total = max((out - 1) * stride + kernel - n, 0)
    return total // 2, total - total // 2


def conv_same(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
              stride: int) -> torch.Tensor:
    """SAME conv of an NCHW batch with an OIHW kernel, padded explicitly."""
    k = weight.shape[-1]
    top, bottom = same_pads(x.shape[2], k, stride)
    left, right = same_pads(x.shape[3], k, stride)
    return F.conv2d(F.pad(x, (left, right, top, bottom)), weight, bias, stride=stride)


def flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    """[B,C,H,W] -> [B, H*W*C] in NHWC order (JAX's reshape)."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def spec_shapes(spec: tuple, input_size: int, channels: int = 3) -> list[tuple]:
    """The (C, H, W) or (features,) shape entering each layer of ``spec``."""
    shape: tuple = (channels, input_size, input_size)
    out = []
    for layer in spec:
        out.append(shape)
        if layer[0] == "conv":
            _, features, _, stride = layer
            shape = (features, -(-shape[1] // stride), -(-shape[2] // stride))
        elif layer[0] == "flatten":
            shape = (shape[0] * shape[1] * shape[2],)
        elif layer[0] == "dense":
            shape = (layer[1],)
    return out


class IBPNet(nn.Module):
    """A conv/relu/dense stack built from ``spec``, on a normalized NCHW
    batch of ``input_size`` pixels (32 for the registered nets)."""

    def __init__(self, spec: tuple = CNN7_SPEC, input_size: int = 32, channels: int = 3):
        super().__init__()
        self.spec = tuple(spec)
        for i, (layer, shape) in enumerate(zip(self.spec, spec_shapes(spec, input_size,
                                                                      channels))):
            if layer[0] == "conv":
                _, features, kernel, _ = layer
                setattr(self, f"conv_{i}", nn.Conv2d(shape[0], features, kernel, padding=0))
            elif layer[0] == "dense":
                setattr(self, f"dense_{i}", nn.Linear(shape[0], layer[1]))
            elif layer[0] not in ("relu", "flatten"):
                raise ValueError(f"unknown IBP layer kind '{layer[0]}'")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return spec_apply(ibp_params(self), self.spec, x)


def spec_apply(params: dict, spec: tuple, x: torch.Tensor) -> torch.Tensor:
    """The plain forward through ``spec`` of a normalized NCHW batch, with
    each layer's weights cast to the input's dtype; ``params`` maps layer
    names to their modules (``ibp_params``)."""
    for i, layer in enumerate(spec):
        kind = layer[0]
        if kind == "conv":
            m = params[f"conv_{i}"]
            x = conv_same(x, m.weight.to(x.dtype), m.bias.to(x.dtype), layer[3])
        elif kind == "relu":
            x = F.relu(x)
        elif kind == "flatten":
            x = flatten_nhwc(x)
        elif kind == "dense":
            m = params[f"dense_{i}"]
            x = F.linear(x, m.weight.to(x.dtype), m.bias.to(x.dtype))
        else:
            raise ValueError(f"unknown IBP layer kind '{kind}'")
    return x


def ibp_params(model: IBPNet) -> dict[str, nn.Module]:
    """The parameter tree the interval propagators read: layer name ->
    its ``nn.Conv2d`` / ``nn.Linear`` (OIHW / [out, in] weights)."""
    return dict(model.named_children())


def ibp_cnn7(num_classes: int = 10) -> IBPNet:
    """The CROWN-IBP 'CNN7' CIFAR benchmark net (about 17M parameters)."""
    return IBPNet(spec=CNN7_SPEC[:-1] + (("dense", num_classes),))


def ibp_tiny(num_classes: int = 10) -> IBPNet:
    """The miniature IBP net of the tests."""
    return IBPNet(spec=TINY_SPEC[:-1] + (("dense", num_classes),))
