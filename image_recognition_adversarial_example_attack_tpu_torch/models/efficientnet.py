"""EfficientNet-B0 in PyTorch (port of ``models/efficientnet.py``):
``efficientnet_b0`` and ``efficientnet_tiny``.

Submodules carry torchvision's names: ``features.0.{0,1}`` the stem conv
and BatchNorm, ``features.S.B.block.I[.J]`` block B of stage S (S = 1..
len(plan)), ``features.{len(plan)+1}.{0,1}`` the head conv and BatchNorm,
``classifier.1`` the Linear, so a torchvision ``.pth`` loads with
``strict=True``.  Inside a block, ``block.I`` runs the expansion (where the
expand ratio is not 1), the depthwise conv, the squeeze-excite
(``fc1``, ``fc2``: 1x1 convs with bias) and the projection, each but the
squeeze-excite a conv (``.0``) and a BatchNorm (``.1``).  BatchNorm is the
port's always-eval ``FrozenBatchNorm2d`` (eps 1e-5, as in the JAX model).

As the JAX model computes it: SiLU after the stem, the expansion, the
depthwise conv and the head; the squeeze-excite squeezes to
``max(1, in_ch // 4)`` channels of the block's input; no activation after
the projection; the residual where stride is 1 and the widths match.
Stochastic depth is the identity at inference and is left out, as in the
JAX model.  ``int8=True`` quantizes the layers the JAX model hooks: the
stem, the expand and project 1x1 convs, the head conv and the classifier.
The depthwise and squeeze-excite convs stay float.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.int8 import conv2d_class, linear_class
from .resnet import FrozenBatchNorm2d


class MBConvSpec(NamedTuple):
    expand_ratio: int
    kernel: int
    stride: int
    in_ch: int
    out_ch: int
    repeats: int


# EfficientNet-B0's stage plan (torchvision's defaults)
_B0_PLAN: Sequence[MBConvSpec] = (
    MBConvSpec(1, 3, 1, 32, 16, 1),
    MBConvSpec(6, 3, 2, 16, 24, 2),
    MBConvSpec(6, 5, 2, 24, 40, 2),
    MBConvSpec(6, 3, 2, 40, 80, 3),
    MBConvSpec(6, 5, 1, 80, 112, 3),
    MBConvSpec(6, 5, 2, 112, 192, 4),
    MBConvSpec(6, 3, 1, 192, 320, 1),
)


def conv_bn(conv: type[nn.Conv2d], cin: int, cout: int, k: int, stride: int = 1,
            groups: int = 1, act: bool = True) -> nn.Sequential:
    """torchvision's Conv2dNormActivation: ``.0`` conv, ``.1`` BatchNorm,
    then SiLU where ``act``."""
    layers = [conv(cin, cout, k, stride=stride, padding=(k - 1) // 2, groups=groups,
                   bias=False), FrozenBatchNorm2d(cout)]
    return nn.Sequential(*layers, *([nn.SiLU()] if act else []))


class SqueezeExcite(nn.Module):
    """``x * sigmoid(fc2(silu(fc1(mean(x)))))`` with 1x1 convs (bias)."""

    def __init__(self, channels: int, squeeze_channels: int):
        super().__init__()
        self.fc1 = nn.Conv2d(channels, squeeze_channels, 1)
        self.fc2 = nn.Conv2d(squeeze_channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = F.silu(self.fc1(x.mean(dim=(2, 3), keepdim=True)))
        return x * torch.sigmoid(self.fc2(s))


class MBConv(nn.Module):
    def __init__(self, spec: MBConvSpec, stride: int, in_ch: int, int8: bool = False):
        super().__init__()
        quant = conv2d_class(int8)
        mid = in_ch * spec.expand_ratio
        layers: list[nn.Module] = []
        if spec.expand_ratio != 1:
            layers.append(conv_bn(quant, in_ch, mid, 1))
        layers += [conv_bn(nn.Conv2d, mid, mid, spec.kernel, stride, groups=mid),
                   SqueezeExcite(mid, max(1, in_ch // 4)),
                   conv_bn(quant, mid, spec.out_ch, 1, act=False)]
        self.block = nn.Sequential(*layers)
        self.use_res_connect = stride == 1 and in_ch == spec.out_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.block(x)
        return x + y if self.use_res_connect else y


class EfficientNet(nn.Module):
    """Takes a normalized NCHW batch."""

    def __init__(self, plan: Sequence[MBConvSpec] = _B0_PLAN, stem_ch: int = 32,
                 head_ch: int = 1280, num_classes: int = 1000, int8: bool = False):
        super().__init__()
        quant = conv2d_class(int8)
        stages: list[nn.Module] = [conv_bn(quant, 3, stem_ch, 3, 2)]
        for spec in plan:
            in_ch, blocks = spec.in_ch, []
            for b in range(spec.repeats):
                blocks.append(MBConv(spec, spec.stride if b == 0 else 1, in_ch, int8))
                in_ch = spec.out_ch
            stages.append(nn.Sequential(*blocks))
        stages.append(conv_bn(quant, plan[-1].out_ch, head_ch, 1))
        self.features = nn.Sequential(*stages)
        # torchvision's classifier: Dropout (the identity in eval), Linear
        self.classifier = nn.Sequential(nn.Identity(), linear_class(int8)(head_ch, num_classes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B,3,H,W] normalized input -> [B,num_classes] logits."""
        return self.classifier(self.features(x).mean(dim=(2, 3)))


def efficientnet_b0(num_classes: int = 1000, int8: bool = False) -> EfficientNet:
    return EfficientNet(num_classes=num_classes, int8=int8)


def efficientnet_tiny(num_classes: int = 10, int8: bool = False) -> EfficientNet:
    """The JAX package's miniature EfficientNet (same code path)."""
    plan = (MBConvSpec(1, 3, 1, 8, 8, 1), MBConvSpec(6, 3, 2, 8, 16, 1))
    return EfficientNet(plan=plan, stem_ch=8, head_ch=32, num_classes=num_classes, int8=int8)
