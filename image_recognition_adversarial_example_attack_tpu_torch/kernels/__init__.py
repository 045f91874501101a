"""Hand-written CUDA kernels (``csrc/``), their wrappers and plain versions:
``elementwise`` (pgd_step, quantize, uniform noise), ``bn_act`` (ResNet's
fused BatchNorm -> add -> ReLU chain, forward and input gradient),
``window_attn`` (Swin's shifted-window attention, forward and input
gradient) and ``conv3x3`` (the conv probe's 3x3 conv); the last three are
imported from their modules."""

from .elementwise import (LAUNCHES, launch_counts, pgd_step, pgd_step_plain,
                          quantize, quantize_plain, reset_launches,
                          uniform_noise, uniform_noise_plain)

__all__ = ["LAUNCHES", "launch_counts", "pgd_step", "pgd_step_plain",
           "quantize", "quantize_plain", "reset_launches", "uniform_noise",
           "uniform_noise_plain"]
