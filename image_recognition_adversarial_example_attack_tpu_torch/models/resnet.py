"""ResNet v1.5 in PyTorch (port of ``models/resnet.py``).

Submodules carry torchvision's names (``conv1``, ``layer1.0.downsample.0``,
``fc`` ...), so a torchvision ``.pth`` state dict loads with
``load_state_dict(strict=True)``.  Inside, the model computes in NCHW; build
it with ``memory_format=torch.channels_last`` and feed it
``x_nhwc.permute(0, 3, 1, 2)``, which is then a free view.

Matching the Flax model: the stride is on the 3x3 conv (v1.5); paddings are
explicit (3 on the stem 7x7, 1 on each 3x3, 0 on the 1x1 convs, which Flax's
``SAME`` leaves unpadded); max pool 3/2/1 pads with -inf; BatchNorm uses
eps=1e-5 and always its running statistics, whatever ``train()`` says
(the CIFAR families' ``TrainableBatchNorm2d`` can use the batch's own).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.int8 import conv2d_class, linear_class
from ..parallel.collective import coupled, sum_over_shards


class FrozenBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d that always normalizes with its running statistics (the
    JAX package's ``use_running_average=True``). Its parameter and buffer
    names are torchvision's, num_batches_tracked included."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


def batch_moments(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (mean, variance) of an NCHW batch as Flax's BatchNorm
    computes them (``use_fast_variance``): ``E[x²] - E[x]²`` clamped at 0,
    the biased variance, reduced in float32 (float64 stays float64).  In a
    shard of a sharded ``train_bn`` step (``parallel/collective.py``) the
    moments are the whole batch's."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    if coupled():
        # a shard of a sharded train_bn step: the whole batch's moments, from
        # the sums of x, x² and the element count over every shard (the count
        # too: an EOT forward stacks n draws of the shard's rows)
        count = xf.new_full((xf.shape[1],), float(xf.shape[0] * xf.shape[2] * xf.shape[3]))
        sums = sum_over_shards(torch.stack([xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3)),
                                            count]))
        mean, mean2 = sums[0] / sums[2], sums[1] / sums[2]
    else:
        mean = xf.mean(dim=(0, 2, 3))
        mean2 = (xf * xf).mean(dim=(0, 2, 3))
    return mean, torch.clamp_min(mean2 - mean * mean, 0.0)


class TrainableBatchNorm2d(FrozenBatchNorm2d):
    """The CIFAR families' BatchNorm.  With ``train_bn`` off it is
    ``FrozenBatchNorm2d``; with it on (from-scratch training, the JAX
    package's ``train_bn=True``) every forward normalizes by the batch's own
    statistics (``batch_moments``) in float32 and casts back to the input's
    dtype, as Flax does; the running statistics are not updated (training
    recalibrates them once, ``train.adversarial.calibrate_batch_stats``)."""

    def __init__(self, num_features: int):
        super().__init__(num_features)
        self.train_bn = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.train_bn:
            return super().forward(x)
        mean, var = batch_moments(x)
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)


def set_train_bn(model: nn.Module, train_bn: bool) -> nn.Module:
    """Set ``train_bn`` on ``model`` and on each of its
    ``TrainableBatchNorm2d`` layers."""
    for m in model.modules():
        if isinstance(m, TrainableBatchNorm2d):
            m.train_bn = bool(train_bn)
    model.train_bn = bool(train_bn)
    return model


def _conv(cin: int, cout: int, k: int, stride: int = 1, int8: bool = False) -> nn.Conv2d:
    return conv2d_class(int8)(cin, cout, k, stride=stride, padding=k // 2, bias=False)


class Bottleneck(nn.Module):
    """1x1 -> 3x3(stride) -> 1x1(x4) + identity, stride on the 3x3."""

    expansion = 4

    def __init__(self, cin: int, features: int, stride: int = 1,
                 downsample: bool = False, int8: bool = False):
        super().__init__()
        cout = features * self.expansion
        self.conv1 = _conv(cin, features, 1, int8=int8)
        self.bn1 = FrozenBatchNorm2d(features)
        self.conv2 = _conv(features, features, 3, stride, int8)
        self.bn2 = FrozenBatchNorm2d(features)
        self.conv3 = _conv(features, cout, 1, int8=int8)
        self.bn3 = FrozenBatchNorm2d(cout)
        self.relu = nn.ReLU()
        self.downsample = (nn.Sequential(_conv(cin, cout, 1, stride, int8),
                                         FrozenBatchNorm2d(cout))
                           if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return self.relu(out + identity)


class ResNet(nn.Module):
    """ResNet-v1.5 with Bottleneck blocks. Takes a normalized NCHW batch.

    ``int8=True``: every conv and the classifier run in int8
    (``ops/int8.py``), with the same parameters."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 num_classes: int = 1000, width: int = 64, int8: bool = False):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.conv1 = _conv(3, width, 7, 2, int8)
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
                blocks.append(Bottleneck(cin, feats, stride, downsample=(i == 0), int8=int8))
                cin = feats * Bottleneck.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
        self.fc = linear_class(int8)(cin, num_classes)

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
        """[B,C,h,w] last-conv map -> [B,num_classes] logits (GAP + fc), in
        the model's compute dtype whatever the map's (Grad-CAM hands it the
        float32 map, as the JAX head casts it)."""
        return self.fc(feats.to(self.fc.weight.dtype).mean(dim=(2, 3)))


def resnet50(num_classes: int = 1000, int8: bool = False) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), num_classes=num_classes, width=64, int8=int8)


def resnet_tiny(num_classes: int = 10, int8: bool = False) -> ResNet:
    """The JAX package's miniature ResNet: the same Bottleneck topology at
    1/8 width and one block per stage; works on inputs as small as 32x32."""
    return ResNet(stage_sizes=(1, 1, 1, 1), num_classes=num_classes, width=8, int8=int8)
