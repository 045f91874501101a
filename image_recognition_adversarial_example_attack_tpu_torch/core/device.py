"""The device rule of the port's entry points.

Entry points run on the card unless the caller asks for the CPU: the default
device is ``cuda``, and asking for it where CUDA is absent raises instead of
carrying on quietly on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device '{dev}' (cuda or cpu)")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (--device cpu on the "
            "command line) to run on the CPU")
    return dev
