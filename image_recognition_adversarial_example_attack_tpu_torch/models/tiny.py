"""The tiny CNN of the tests (port of ``models/tiny.py``), registered in the
zoo as ``tiny`` with 1000 classes: the transfer CLIs' target in the CPU tests.

Its submodules carry the Flax module's auto-generated names (``Conv_0``,
``Conv_1``, ``Dense_0``), so the weight bridge is a pure re-layout.  Flax's
``SAME`` padding of a 3x3 stride-1 conv is one pixel on every side.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.int8 import conv2d_class, linear_class


class TinyCNN(nn.Module):
    """conv3x3-relu-avgpool2 -> conv3x3-relu -> global mean -> dense, on a
    normalized NCHW batch of any small size; ``int8=True`` quantizes both
    convs and the dense layer (``ops/int8.py``)."""

    def __init__(self, num_classes: int = 8, features: int = 8, int8: bool = False):
        super().__init__()
        conv, dense = conv2d_class(int8), linear_class(int8)
        self.Conv_0 = conv(3, features, 3, padding=1)
        self.Conv_1 = conv(features, features * 2, 3, padding=1)
        self.Dense_0 = dense(features * 2, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.avg_pool2d(F.relu(self.Conv_0(x)), 2, 2)
        x = F.relu(self.Conv_1(x))
        return self.Dense_0(x.mean(dim=(2, 3)))
