"""DenseNet in PyTorch (port of ``models/densenet.py``): ``densenet121`` and
``densenet_tiny``.

Submodules carry torchvision's names (``features.conv0``,
``features.denseblockB.denselayerL.{norm1,conv1,norm2,conv2}``,
``features.transitionT.{norm,conv}``, ``features.norm5``, ``classifier``),
so a torchvision ``.pth`` loads with ``strict=True``.  BatchNorm is the
port's always-eval ``FrozenBatchNorm2d`` (eps 1e-5).

Dense connectivity is a channel concatenation after every layer, as the JAX
model's.  On channels_last tensors ``torch.cat`` along dim 1 writes a
channels_last result (all inputs share the format), so the concatenation is
one copy per layer, without a layout change.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.int8 import conv2d_class, linear_class
from .resnet import FrozenBatchNorm2d


class DenseLayer(nn.Module):
    """BN-ReLU-conv1x1 (bn_size * k channels) -> BN-ReLU-conv3x3 (k new
    channels), concatenated to its input."""

    def __init__(self, cin: int, growth_rate: int, bn_size: int = 4, int8: bool = False):
        super().__init__()
        conv = conv2d_class(int8)
        self.norm1 = FrozenBatchNorm2d(cin)
        self.conv1 = conv(cin, bn_size * growth_rate, 1, bias=False)
        self.norm2 = FrozenBatchNorm2d(bn_size * growth_rate)
        self.conv2 = conv(bn_size * growth_rate, growth_rate, 3, padding=1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1(F.relu(self.norm1(x)))
        y = self.conv2(F.relu(self.norm2(y)))
        return torch.cat([x, y], dim=1)


class Transition(nn.Module):
    def __init__(self, cin: int, cout: int, int8: bool = False):
        super().__init__()
        self.norm = FrozenBatchNorm2d(cin)
        self.conv = conv2d_class(int8)(cin, cout, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.avg_pool2d(self.conv(F.relu(self.norm(x))), 2, 2)


class DenseNet(nn.Module):
    """``int8=True``: every conv and the classifier run in int8
    (``ops/int8.py``); a conv on the concatenated input takes one
    activation scale over the whole concatenation, as in the JAX model."""

    def __init__(self, block_config: Sequence[int] = (6, 12, 24, 16), growth_rate: int = 32,
                 init_features: int = 64, num_classes: int = 1000, int8: bool = False):
        super().__init__()
        self.features = nn.Sequential()
        self.features.add_module("conv0", conv2d_class(int8)(3, init_features, 7, stride=2,
                                                             padding=3, bias=False))
        self.features.add_module("norm0", FrozenBatchNorm2d(init_features))
        self.features.add_module("relu0", nn.ReLU())
        self.features.add_module("pool0", nn.MaxPool2d(3, stride=2, padding=1))
        c = init_features
        for b, n_layers in enumerate(block_config, start=1):
            block = nn.Sequential()
            for i in range(1, n_layers + 1):
                block.add_module(f"denselayer{i}", DenseLayer(c, growth_rate, int8=int8))
                c += growth_rate
            self.features.add_module(f"denseblock{b}", block)
            if b != len(block_config):
                self.features.add_module(f"transition{b}", Transition(c, c // 2, int8))
                c //= 2
        self.features.add_module("norm5", FrozenBatchNorm2d(c))
        self.classifier = linear_class(int8)(c, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B,3,H,W] normalized input -> [B,num_classes] logits."""
        x = F.relu(self.features(x))
        return self.classifier(x.mean(dim=(2, 3)))


def densenet121(num_classes: int = 1000, int8: bool = False) -> DenseNet:
    return DenseNet(num_classes=num_classes, int8=int8)


def densenet_tiny(num_classes: int = 10, int8: bool = False) -> DenseNet:
    """The JAX package's miniature DenseNet (same code path) for CPU tests."""
    return DenseNet(block_config=(2, 2), growth_rate=8, init_features=16,
                    num_classes=num_classes, int8=int8)
