"""WideResNet in PyTorch (port of ``models/wideresnet.py``): ``wrn28_10``,
``wrn34_10`` and ``wrn_tiny``, the CIFAR family at 32x32.

Pre-activation WRN-d-k (depth 6n+4; three groups of n blocks at widths
16k/32k/64k, strides 1/2/2).  Submodules carry the Madry/RobustBench names
(``conv1``, ``block1.layer.0.{bn1,conv1,bn2,conv2,convShortcut}``, the final
``bn1``, ``fc``), so a RobustBench-style ``.pth`` loads with
``strict=True``.  BatchNorm is the port's ``TrainableBatchNorm2d`` (eps
1e-5): running statistics, or with ``train_bn=True`` (from-scratch
training) the batch's own.

As the JAX model computes it: when a block's widths differ, its first
bn-relu is shared by the residual branch and the 1x1 ``convShortcut``
(both read ``relu(bn1(x))``); when they match, the shortcut is the raw
input.  The stem is a 3x3 stride-1 conv with no pool (spatial plan
32-32-16-8).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.int8 import conv2d_class, linear_class
from .resnet import TrainableBatchNorm2d, set_train_bn


class WideBasicBlock(nn.Module):
    """bn-relu-3x3(stride) - bn-relu-3x3 + shortcut."""

    def __init__(self, cin: int, features: int, stride: int = 1, int8: bool = False):
        super().__init__()
        conv = conv2d_class(int8)
        self.bn1 = TrainableBatchNorm2d(cin)
        self.conv1 = conv(cin, features, 3, stride=stride, padding=1, bias=False)
        self.bn2 = TrainableBatchNorm2d(features)
        self.conv2 = conv(features, features, 3, padding=1, bias=False)
        self.equal_in_out = cin == features and stride == 1
        self.convShortcut = (None if self.equal_in_out
                             else conv(cin, features, 1, stride=stride, bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pre = F.relu(self.bn1(x))
        out = self.conv2(F.relu(self.bn2(self.conv1(pre))))
        return out + (x if self.convShortcut is None else self.convShortcut(pre))


class NetworkBlock(nn.Module):
    """One group of blocks, held as ``layer`` (the RobustBench name)."""

    def __init__(self, cin: int, features: int, n: int, stride: int, int8: bool = False):
        super().__init__()
        self.layer = nn.Sequential(*(
            WideBasicBlock(cin if i == 0 else features, features, stride if i == 0 else 1, int8)
            for i in range(n)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layer(x)


class WideResNet(nn.Module):
    """WRN-depth-widen.  Takes a normalized NCHW batch.  ``int8=True``:
    every conv and the classifier run in int8 (``ops/int8.py``).
    ``train_bn=True``: every BatchNorm normalizes by batch statistics."""

    def __init__(self, depth: int = 28, widen: int = 10, num_classes: int = 10,
                 int8: bool = False, train_bn: bool = False):
        super().__init__()
        if (depth - 4) % 6:
            raise ValueError("WideResNet depth must be 6n+4")
        n = (depth - 4) // 6
        widths = (16 * widen, 32 * widen, 64 * widen)
        self.conv1 = conv2d_class(int8)(3, 16, 3, padding=1, bias=False)
        cin = 16
        for g, feats in enumerate(widths, start=1):
            setattr(self, f"block{g}", NetworkBlock(cin, feats, n, 1 if g == 1 else 2, int8))
            cin = feats
        self.bn1 = TrainableBatchNorm2d(cin)
        self.fc = linear_class(int8)(cin, num_classes)
        set_train_bn(self, train_bn)

    def _groups(self, x: torch.Tensor, upto: int) -> torch.Tensor:
        x = self.conv1(x)
        for g in range(1, upto + 1):
            x = getattr(self, f"block{g}")(x)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B,3,H,W] normalized input -> [B,num_classes] logits."""
        return self.head_from_features(self.features_last(x))

    def features_stage3(self, x: torch.Tensor) -> torch.Tensor:
        """The penultimate group's activation map (groups 1-2), NCHW: the
        detector's input, the WRN counterpart of ResNet's stage-3 tap."""
        return self._groups(x, 2)

    def features_last(self, x: torch.Tensor) -> torch.Tensor:
        """The last conv activation (after the final bn1 + relu, before the
        pool), NCHW: the Grad-CAM tap."""
        return F.relu(self.bn1(self._groups(x, 3)))

    def head_from_features(self, feats: torch.Tensor) -> torch.Tensor:
        """[B,C,h,w] -> logits: the pool and fc, in the model's compute
        dtype whatever the map's."""
        return self.fc(feats.to(self.fc.weight.dtype).mean(dim=(2, 3)))


def wrn28_10(num_classes: int = 10, int8: bool = False) -> WideResNet:
    """WRN-28-10 (36.5M parameters), the RobustBench CIFAR-10 standard."""
    return WideResNet(depth=28, widen=10, num_classes=num_classes, int8=int8)


def wrn34_10(num_classes: int = 10, int8: bool = False) -> WideResNet:
    """WRN-34-10, the Madry et al. / TRADES architecture."""
    return WideResNet(depth=34, widen=10, num_classes=num_classes, int8=int8)


def wrn_tiny(num_classes: int = 10, int8: bool = False) -> WideResNet:
    """WRN-10-1: one block per group, the same code path at test scale."""
    return WideResNet(depth=10, widen=1, num_classes=num_classes, int8=int8)
