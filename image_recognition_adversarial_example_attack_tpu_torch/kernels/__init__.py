"""Hand-written CUDA kernels (``csrc/``), their wrappers and plain versions."""

from .elementwise import (LAUNCHES, launch_counts, pgd_step, pgd_step_plain,
                          quantize, quantize_plain, reset_launches,
                          uniform_noise, uniform_noise_plain)

__all__ = ["LAUNCHES", "launch_counts", "pgd_step", "pgd_step_plain",
           "quantize", "quantize_plain", "reset_launches", "uniform_noise",
           "uniform_noise_plain"]
