"""VGG in PyTorch (port of ``models/vgg.py``): ``vgg19`` and ``vgg_tiny``.

Submodules carry torchvision's names (``features.N``, ``classifier.N``, a
conv at N and its ReLU at N+1, a 2x2 max pool at its own index; the
classifier's dropouts are identities, the model being always in eval mode),
so a torchvision ``.pth`` loads with ``strict=True``.  The model computes in
NCHW and flattens NCHW directly, the order torch's classifier weights expect;
the JAX model transposes its NHWC map to NCHW before it flattens, so the
bridge re-lays the classifier's kernel IO -> OI and nothing else.  No
adaptive average pool: at 224 the map is already 7x7, and the JAX model has
none.  The classifier's input width therefore follows ``image_size``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops.int8 import conv2d_class, linear_class

# Config "E" (VGG19): the conv channel plan, "M" a 2x2 max pool.
VGG19_PLAN: tuple = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
                     512, 512, 512, 512, "M", 512, 512, 512, 512, "M")


class VGG(nn.Module):
    def __init__(self, plan: Sequence = VGG19_PLAN, num_classes: int = 1000,
                 classifier_width: int = 4096, image_size: int = 224, int8: bool = False):
        super().__init__()
        conv, dense = conv2d_class(int8), linear_class(int8)
        layers: list[nn.Module] = []
        cin, side = 3, image_size
        for item in plan:
            if item == "M":
                layers.append(nn.MaxPool2d(2, 2))
                side //= 2
            else:
                layers += [conv(cin, int(item), 3, padding=1), nn.ReLU()]
                cin = int(item)
        self.features = nn.Sequential(*layers)
        self.classifier = nn.Sequential(
            dense(cin * side * side, classifier_width), nn.ReLU(), nn.Identity(),
            dense(classifier_width, classifier_width), nn.ReLU(), nn.Identity(),
            dense(classifier_width, num_classes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B,3,H,W] normalized input -> [B,num_classes] logits."""
        return self.classifier(self.features(x).flatten(1))


def vgg19(num_classes: int = 1000, int8: bool = False) -> VGG:
    return VGG(VGG19_PLAN, num_classes=num_classes, int8=int8)


def vgg_tiny(num_classes: int = 10, image_size: int = 32, int8: bool = False) -> VGG:
    """The JAX package's miniature VGG (same code path) for CPU tests."""
    return VGG((8, "M", 16, "M"), num_classes=num_classes, classifier_width=32,
               image_size=image_size, int8=int8)
