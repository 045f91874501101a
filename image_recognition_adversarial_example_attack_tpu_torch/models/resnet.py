"""ResNet v1.5 in PyTorch (port of ``models/resnet.py``).

Submodules carry torchvision's names (``conv1``, ``layer1.0.downsample.0``,
``fc`` ...), so a torchvision ``.pth`` state dict loads with
``load_state_dict(strict=True)``.  Inside, the model computes in NCHW; build
it with ``memory_format=torch.channels_last`` and feed it
``x_nhwc.permute(0, 3, 1, 2)``, which is then a free view.

Matching the Flax model: the stride is on the 3x3 conv (v1.5); paddings are
explicit (3 on the stem 7x7, 1 on each 3x3, 0 on the 1x1 convs, which Flax's
``SAME`` leaves unpadded); max pool 3/2/1 pads with -inf; BatchNorm uses
eps=1e-5 and always its running statistics, whatever ``train()`` says.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


class FrozenBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d that always normalizes with its running statistics (the
    JAX package's ``use_running_average=True``). Its parameter and buffer
    names are torchvision's, num_batches_tracked included."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)


class Bottleneck(nn.Module):
    """1x1 -> 3x3(stride) -> 1x1(x4) + identity, stride on the 3x3."""

    expansion = 4

    def __init__(self, cin: int, features: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        cout = features * self.expansion
        self.conv1 = _conv(cin, features, 1)
        self.bn1 = FrozenBatchNorm2d(features)
        self.conv2 = _conv(features, features, 3, stride)
        self.bn2 = FrozenBatchNorm2d(features)
        self.conv3 = _conv(features, cout, 1)
        self.bn3 = FrozenBatchNorm2d(cout)
        self.relu = nn.ReLU()
        self.downsample = (nn.Sequential(_conv(cin, cout, 1, stride),
                                         FrozenBatchNorm2d(cout))
                           if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return self.relu(out + identity)


class ResNet(nn.Module):
    """ResNet-v1.5 with Bottleneck blocks. Takes a normalized NCHW batch."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 num_classes: int = 1000, width: int = 64):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.conv1 = _conv(3, width, 7, 2)
        self.bn1 = FrozenBatchNorm2d(width)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        cin = width
        for stage, n_blocks in enumerate(self.stage_sizes):
            feats = width * 2 ** stage
            blocks = []
            for i in range(n_blocks):
                stride = 2 if (stage > 0 and i == 0) else 1
                # block 0 of every stage projects, stage 0 included
                blocks.append(Bottleneck(cin, feats, stride, downsample=(i == 0)))
                cin = feats * Bottleneck.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
        self.fc = nn.Linear(cin, num_classes)

    def _stages(self):
        return [getattr(self, f"layer{s + 1}") for s in range(len(self.stage_sizes))]

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        return self.maxpool(self.relu(self.bn1(self.conv1(x))))

    def _features(self, x: torch.Tensor, upto: int) -> torch.Tensor:
        x = self.stem(x)
        for layer in self._stages()[:upto]:
            x = layer(x)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B,3,H,W] normalized input -> [B,num_classes] logits."""
        return self.head_from_features(self.features_last(x))

    def features_stage3(self, x: torch.Tensor) -> torch.Tensor:
        """Activation after stage 3 (torchvision ``layer3``), NCHW: the
        detector's input. Stage 4 and the head do not run."""
        return self._features(x, 3)

    def features_last(self, x: torch.Tensor) -> torch.Tensor:
        """Last convolutional activation map (after stage 4), NCHW."""
        return self._features(x, len(self.stage_sizes))

    def head_from_features(self, feats: torch.Tensor) -> torch.Tensor:
        """[B,C,h,w] last-conv map -> [B,num_classes] logits (GAP + fc)."""
        return self.fc(feats.mean(dim=(2, 3)))


def resnet50(num_classes: int = 1000) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), num_classes=num_classes, width=64)


def resnet_tiny(num_classes: int = 10) -> ResNet:
    """The JAX package's miniature ResNet: the same Bottleneck topology at
    1/8 width and one block per stage; works on inputs as small as 32x32."""
    return ResNet(stage_sizes=(1, 1, 1, 1), num_classes=num_classes, width=8)
