"""PreActResNet in PyTorch (port of ``models/preactresnet.py``):
``preact_resnet18``, the second CIFAR robustness backbone.

Submodules carry the names of the torch implementation the robustness
literature shares (kuangliu/pytorch-cifar, as RobustBench vendors it):
``conv1``, ``layer{1..4}.{i}.{bn1,conv1,bn2,conv2,shortcut.0}``, the final
``bn`` and ``linear``, so such a ``.pth`` loads with ``strict=True``.
BatchNorm is the port's ``TrainableBatchNorm2d`` (eps 1e-5): running
statistics, or with ``train_bn=True`` (from-scratch training) the batch's
own.

As the JAX model computes it: the 1x1 shortcut, present only where the
shape changes, reads the pre-activated input ``relu(bn1(x))``; elsewhere
the shortcut is the raw input.  The stem is a 3x3 stride-1 conv with no
pool (spatial plan 32-32-16-8-4).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.int8 import conv2d_class, linear_class
from .resnet import TrainableBatchNorm2d, set_train_bn


class PreActBlock(nn.Module):
    """bn-relu-3x3(stride) - bn-relu-3x3 + shortcut."""

    def __init__(self, cin: int, features: int, stride: int = 1, int8: bool = False):
        super().__init__()
        conv = conv2d_class(int8)
        self.bn1 = TrainableBatchNorm2d(cin)
        self.conv1 = conv(cin, features, 3, stride=stride, padding=1, bias=False)
        self.bn2 = TrainableBatchNorm2d(features)
        self.conv2 = conv(features, features, 3, padding=1, bias=False)
        self.shortcut = (nn.Sequential(conv(cin, features, 1, stride=stride, bias=False))
                         if cin != features or stride != 1 else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pre = F.relu(self.bn1(x))
        shortcut = x if self.shortcut is None else self.shortcut(pre)
        out = self.conv2(F.relu(self.bn2(self.conv1(pre))))
        return out + shortcut


class PreActResNet(nn.Module):
    """PreActResNet with basic blocks.  Takes a normalized NCHW batch.
    ``int8=True``: every conv and the classifier run in int8;
    ``train_bn=True``: every BatchNorm normalizes by batch statistics."""

    def __init__(self, stage_sizes: Sequence[int] = (2, 2, 2, 2), num_classes: int = 10,
                 int8: bool = False, train_bn: bool = False):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.conv1 = conv2d_class(int8)(3, 64, 3, padding=1, bias=False)
        cin = 64
        for stage, n_blocks in enumerate(self.stage_sizes):
            feats = 64 * 2 ** stage
            blocks = []
            for i in range(n_blocks):
                blocks.append(PreActBlock(cin, feats, 2 if (stage > 0 and i == 0) else 1, int8))
                cin = feats
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
        self.bn = TrainableBatchNorm2d(cin)
        self.linear = linear_class(int8)(cin, num_classes)
        set_train_bn(self, train_bn)

    def _stages(self, x: torch.Tensor, upto: int) -> torch.Tensor:
        x = self.conv1(x)
        for s in range(1, upto + 1):
            x = getattr(self, f"layer{s}")(x)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B,3,H,W] normalized input -> [B,num_classes] logits."""
        return self.head_from_features(self.features_last(x))

    def features_stage3(self, x: torch.Tensor) -> torch.Tensor:
        """The activation after stage 3, NCHW: the detector's input."""
        return self._stages(x, 3)

    def features_last(self, x: torch.Tensor) -> torch.Tensor:
        """The last conv activation (after the final bn + relu, before the
        pool), NCHW: the Grad-CAM tap."""
        return F.relu(self.bn(self._stages(x, len(self.stage_sizes))))

    def head_from_features(self, feats: torch.Tensor) -> torch.Tensor:
        """[B,C,h,w] -> logits: the pool and linear, in the model's compute
        dtype whatever the map's."""
        return self.linear(feats.to(self.linear.weight.dtype).mean(dim=(2, 3)))


def preact_resnet18(num_classes: int = 10, int8: bool = False) -> PreActResNet:
    """PreActResNet-18 (11.2M parameters at 10 classes)."""
    return PreActResNet(stage_sizes=(2, 2, 2, 2), num_classes=num_classes, int8=int8)
