"""MobileNetV2 in PyTorch (port of ``models/mobilenet.py``): ``mobilenet_v2``
and ``mobilenet_tiny``, the lightweight transfer target.

Submodules carry torchvision's names: ``features.0.{0,1}`` the stem conv
and BatchNorm, ``features.N.conv.I[.J]`` the inverted residual blocks
(N = 1..len(plan)), ``features.{len(plan)+1}.{0,1}`` the head conv and
BatchNorm, ``classifier.1`` the Linear, so a torchvision ``.pth`` loads with
``strict=True``.  BatchNorm is the port's always-eval ``FrozenBatchNorm2d``
(eps 1e-5, as in the JAX model).

As the JAX model computes it: ReLU6 after the stem, the expansion, the
depthwise conv and the head; no activation after the projection (the
linear bottleneck); the residual where stride is 1 and the widths match.
``int8=True`` quantizes the layers the JAX model hooks: the stem, the
expand and project 1x1 convs, the head conv and the classifier.  The
depthwise convs stay float.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
from torch import nn

from ..ops.int8 import conv2d_class, linear_class
from .resnet import FrozenBatchNorm2d


class IRSpec(NamedTuple):
    expand_ratio: int
    stride: int
    in_ch: int
    out_ch: int


def _v2_plan() -> tuple[IRSpec, ...]:
    """The paper's (t, c, n, s) table flattened into one spec per block
    (torchvision's features indices 1..17)."""
    cfg = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
           (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))
    plan: list[IRSpec] = []
    in_ch = 32
    for t, c, n, s in cfg:
        for b in range(n):
            plan.append(IRSpec(t, s if b == 0 else 1, in_ch, c))
            in_ch = c
    return tuple(plan)


_V2_PLAN = _v2_plan()


def conv_bn_act(conv: type[nn.Conv2d], cin: int, cout: int, k: int, stride: int = 1,
                groups: int = 1) -> nn.Sequential:
    """torchvision's Conv2dNormActivation with ReLU6: ``.0`` conv, ``.1``
    BatchNorm, ``.2`` the activation."""
    return nn.Sequential(conv(cin, cout, k, stride=stride, padding=(k - 1) // 2,
                              groups=groups, bias=False),
                         FrozenBatchNorm2d(cout), nn.ReLU6())


class InvertedResidual(nn.Module):
    def __init__(self, spec: IRSpec, int8: bool = False):
        super().__init__()
        quant = conv2d_class(int8)
        mid = spec.in_ch * spec.expand_ratio
        layers: list[nn.Module] = []
        if spec.expand_ratio != 1:
            layers.append(conv_bn_act(quant, spec.in_ch, mid, 1))
        layers += [conv_bn_act(nn.Conv2d, mid, mid, 3, spec.stride, groups=mid),
                   quant(mid, spec.out_ch, 1, bias=False), FrozenBatchNorm2d(spec.out_ch)]
        self.conv = nn.Sequential(*layers)
        self.use_res_connect = spec.stride == 1 and spec.in_ch == spec.out_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        return x + y if self.use_res_connect else y


class MobileNetV2(nn.Module):
    """Takes a normalized NCHW batch."""

    def __init__(self, plan: Sequence[IRSpec] = _V2_PLAN, stem_ch: int = 32,
                 head_ch: int = 1280, num_classes: int = 1000, int8: bool = False):
        super().__init__()
        quant = conv2d_class(int8)
        self.features = nn.Sequential(
            conv_bn_act(quant, 3, stem_ch, 3, 2),
            *(InvertedResidual(spec, int8) for spec in plan),
            conv_bn_act(quant, plan[-1].out_ch, head_ch, 1))
        # torchvision's classifier: Dropout (the identity in eval), Linear
        self.classifier = nn.Sequential(nn.Identity(), linear_class(int8)(head_ch, num_classes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B,3,H,W] normalized input -> [B,num_classes] logits."""
        return self.classifier(self.features(x).mean(dim=(2, 3)))


def mobilenet_v2(num_classes: int = 1000, int8: bool = False) -> MobileNetV2:
    return MobileNetV2(num_classes=num_classes, int8=int8)


def mobilenet_tiny(num_classes: int = 10, int8: bool = False) -> MobileNetV2:
    """The JAX package's miniature MobileNetV2 (same code path)."""
    plan = (IRSpec(1, 1, 8, 8), IRSpec(6, 2, 8, 16))
    return MobileNetV2(plan=plan, stem_ch=8, head_ch=32, num_classes=num_classes, int8=int8)

