"""Shared constants (frozen spec values from the reference).

A copy of the JAX package's ``core/constants.py``: the port imports nothing
of that package, because importing any of its modules imports JAX.

ImageNet normalization constants and attack defaults match the reference
(defense_experiments.py:667-668, ResNet.py:38-44) so that epsilon/alpha are
directly comparable to the 8/255 literature convention.
"""

from __future__ import annotations

import numpy as np

# ImageNet channel statistics, [C] with C=3 (RGB).
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)

# CIFAR-10 channel statistics (the WRN small-image family, models/wideresnet.py).
CIFAR10_MEAN = np.array([0.4914, 0.4822, 0.4465], dtype=np.float32)
CIFAR10_STD = np.array([0.2470, 0.2435, 0.2616], dtype=np.float32)

# Preprocessing geometry: shorter side -> 256, center crop 224.
RESIZE_SIZE = 256
IMAGE_SIZE = 224

# Attack defaults (reference ResNet.py:38-44).
DEFAULT_EPS = 8.0 / 255.0
DEFAULT_ALPHA = 2.0 / 255.0
DEFAULT_STEPS = 10
DEFAULT_CW_C = 1.0
DEFAULT_CW_KAPPA = 0.0
DEFAULT_CW_STEPS = 1000
DEFAULT_CW_LR = 0.01
DEFAULT_EPS_LIST = (4.0 / 255.0, 8.0 / 255.0, 16.0 / 255.0)

# Defense defaults (defense_experiments.py:173-185).
QUANTIZATION_LEVELS = 16
JPEG_QUALITY = 75

# Number of ImageNet classes.
NUM_CLASSES = 1000

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp")
