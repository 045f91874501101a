"""ConvNeXt in PyTorch (port of ``models/convnext.py``): ``convnext_tiny`` and
``convnext_micro``.

Submodules carry torchvision's names: ``features.0.{0,1}`` the 4x4/4 stem
conv and its LayerNorm, ``features.{1,3,5,7}.J`` the blocks of stages 1-4
(``block.0`` the 7x7 depthwise conv, ``block.2`` the LayerNorm,
``block.3`` / ``block.5`` the MLP's Linears, and the block's own
``layer_scale`` parameter, ``[C,1,1]``), ``features.{2,4,6}.{0,1}`` the
downsamples (LayerNorm, 2x2/2 conv), ``classifier.{0,2}`` the head's
LayerNorm and Linear, so a torchvision ``.pth`` loads with ``strict=True``.

As the JAX model computes it: dwconv 7x7, LayerNorm (eps 1e-6) over the
channels, Linear 4x, the exact (erf) GELU, Linear, ``layer_scale`` times
that, plus the block's input; downsamples LayerNorm then conv; the head
averages, normalizes and classifies.  Feature maps are NCHW between
blocks; each LayerNorm and the MLP read the NHWC view (a permute, as
torchvision does), and every LayerNorm is the port's float32
``vit.LayerNorm``, kept float32 in a bfloat16 model.  ``int8=True``
quantizes the layers the JAX model hooks: the stem and downsample convs,
the MLP Linears (one activation scale per example over [H, W, C]) and the
classifier.  The depthwise convs stay float.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops.int8 import conv2d_class, linear_class
from .vit import LayerNorm


class Permute(nn.Module):
    def __init__(self, *dims: int):
        super().__init__()
        self.dims = dims

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.permute(*self.dims)


class LayerNorm2d(LayerNorm):
    """LayerNorm over the channels of an NCHW map, on its NHWC view."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class CNBlock(nn.Module):
    def __init__(self, dim: int, int8: bool = False, layer_scale: float = 1e-6):
        super().__init__()
        dense = linear_class(int8)
        self.block = nn.Sequential(
            nn.Conv2d(dim, dim, 7, padding=3, groups=dim),
            Permute(0, 2, 3, 1),
            LayerNorm(dim, eps=1e-6),
            dense(dim, 4 * dim),
            nn.GELU(),
            dense(4 * dim, dim),
            Permute(0, 3, 1, 2))
        self.layer_scale = nn.Parameter(torch.full((dim, 1, 1), layer_scale))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.block(x)
        return x + self.layer_scale.to(y.dtype) * y


class ConvNeXt(nn.Module):
    """Takes a normalized NCHW batch."""

    def __init__(self, depths: Sequence[int] = (3, 3, 9, 3),
                 dims: Sequence[int] = (96, 192, 384, 768), num_classes: int = 1000,
                 int8: bool = False):
        super().__init__()
        quant = conv2d_class(int8)
        layers: list[nn.Module] = [nn.Sequential(quant(3, dims[0], 4, stride=4),
                                                 LayerNorm2d(dims[0], eps=1e-6))]
        for k, (depth, dim) in enumerate(zip(depths, dims)):
            layers.append(nn.Sequential(*(CNBlock(dim, int8) for _ in range(depth))))
            if k + 1 < len(depths):
                layers.append(nn.Sequential(LayerNorm2d(dim, eps=1e-6),
                                            quant(dim, dims[k + 1], 2, stride=2)))
        self.features = nn.Sequential(*layers)
        # after the features, so that the classifier is the model's last Linear
        self.classifier = nn.Sequential(LayerNorm2d(dims[-1], eps=1e-6), nn.Flatten(1),
                                        linear_class(int8)(dims[-1], num_classes))
        self.n_stages = len(depths)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B,3,H,W] normalized input -> [B,num_classes] logits."""
        return self.classifier(self.features(x).mean(dim=(2, 3), keepdim=True))

    def features_stage3(self, x: torch.Tensor) -> torch.Tensor:
        """The activation after stage 3 (torchvision's ``features.5``), NCHW:
        the detector's input.  A configuration with fewer stages taps its
        last stage."""
        return self.features[:2 * min(3, self.n_stages)](x)


def convnext_tiny(num_classes: int = 1000, int8: bool = False) -> ConvNeXt:
    return ConvNeXt(num_classes=num_classes, int8=int8)


def convnext_micro(num_classes: int = 10, int8: bool = False) -> ConvNeXt:
    """The JAX package's test-scale ConvNeXt: two stages, dims 8 and 16."""
    return ConvNeXt(depths=(1, 2), dims=(8, 16), num_classes=num_classes, int8=int8)

