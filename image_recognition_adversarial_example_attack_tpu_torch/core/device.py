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


def to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A CPU tensor on ``device``: itself on the CPU; on a card copied into
    a fresh pinned buffer and sent with ``non_blocking=True``, so the copy
    overlaps the card's work.  The buffer comes from PyTorch's pinned-memory
    cache, which hands it out again only once the copy reading it has
    finished."""
    if device.type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def synchronize(device: torch.device) -> None:
    """Wait for the work queued on ``device`` (a no-op on the CPU): a host
    clock that ends here measures the work, not its enqueueing."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def require_full_float32(t: torch.Tensor, what: str) -> None:
    """Refuse ``what`` on a CUDA tensor while TF32 is allowed for cuDNN
    convolutions or cuBLAS matmuls (``load_model`` turns both off)."""
    if t.is_cuda and (torch.backends.cudnn.allow_tf32
                      or torch.backends.cuda.matmul.allow_tf32):
        raise RuntimeError(
            f"{what} need full float32 on the card: set "
            "torch.backends.cudnn.allow_tf32 = False and "
            "torch.backends.cuda.matmul.allow_tf32 = False (load_model does)")
