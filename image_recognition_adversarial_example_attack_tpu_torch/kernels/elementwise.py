"""Wrappers of the elementwise CUDA kernels, with their plain versions.

Each function here replaces one Pallas TPU kernel of the JAX package's
``ops/pallas_ops.py``; the kernels are in ``csrc/elementwise.cu``.  A tensor
on the CPU takes the plain PyTorch version; a tensor on a CUDA device
launches the kernel or raises.  There is no fallback from the card to the
plain version.

All three kernels are memory-bound: the least time is the bytes they must
move over the card's memory rate (3.35 TB/s on an H100 SXM).  At the main
path's ``[128, 224, 224, 3]`` float32 (77.1 MB a tensor) that is 92 us for
pgd_step (3 reads + 1 write), 46 us for quantize (1 + 1) and 23 us for the
noise (1 write).

``LAUNCHES`` counts the kernel launches of each wrapper (plain-version calls
are not counted), so a run can show that its main path went through them.
Each wrapper is a span, on either route: ``kernel.pgd_step``,
``kernel.quantize``, ``kernel.noise``.
"""

from __future__ import annotations

import torch

from ..core.rng import ShardGenerator, batch_draw, seed_draw, whole_batch_draw
from ..utils.profiling import span
from .build import load_library

LAUNCHES: dict[str, int] = {"pgd_step": 0, "quantize": 0, "uniform_noise": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)


def _check_cuda_f32(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the CUDA kernel takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the CUDA kernel takes contiguous tensors")


def _check_shapes(name: str, *tensors: torch.Tensor) -> None:
    shapes = {tuple(t.shape) for t in tensors}
    if len(shapes) != 1:
        raise ValueError(f"{name}: shapes differ: {sorted(shapes)}")
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices: {devices}")


def _raise_on_error(name: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {code}")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ---------------------------------------------------------------------------
# pgd_step: replaces ops/pallas_ops.py::pgd_step_pallas (:105, body :94)
# ---------------------------------------------------------------------------

def pgd_step_plain(x_adv, grad, x_orig, eps: float, alpha: float):
    """clip(clip(x + alpha*sign(g), x0-eps, x0+eps), 0, 1), sign(0) = 0
    (attacks/pgd.py:24-28 of the JAX package, op for op)."""
    x_new = x_adv + alpha * torch.sign(grad)
    x_new = torch.clamp(x_new, x_orig - eps, x_orig + eps)
    return torch.clamp(x_new, 0.0, 1.0)


def pgd_step(x_adv: torch.Tensor, grad: torch.Tensor, x_orig: torch.Tensor,
             eps: float, alpha: float) -> torch.Tensor:
    """One PGD-Linf update. A negative ``alpha`` steps down the gradient
    (the targeted mode), bit-identical to stepping along ``sign(-grad)``."""
    _check_shapes("pgd_step", x_adv, grad, x_orig)
    with span("kernel.pgd_step"):
        if x_adv.device.type == "cpu":
            return pgd_step_plain(x_adv, grad, x_orig, eps, alpha)
        _check_cuda_f32("pgd_step", x_adv, grad, x_orig)
        out = torch.empty_like(x_adv)
        code = load_library().pgd_step_launch(
            x_adv.data_ptr(), grad.data_ptr(), x_orig.data_ptr(), out.data_ptr(),
            x_adv.numel(), float(alpha), float(eps), _stream(x_adv.device))
    _raise_on_error("pgd_step", code)
    LAUNCHES["pgd_step"] += 1
    return out


# ---------------------------------------------------------------------------
# quantize: replaces ops/pallas_ops.py::quantize_pallas (:132, body :126)
# ---------------------------------------------------------------------------

def quantize_plain(x, levels: int):
    """round(clip01(x) * (L-1)) / (L-1), round half to even. The scale is a
    tensor on x's device: PyTorch divides a CUDA tensor by a Python scalar
    as a multiplication by its reciprocal, which differs in the last bit."""
    scale = torch.full((), levels - 1, dtype=x.dtype, device=x.device)
    return torch.round(torch.clamp(x, 0.0, 1.0) * scale) / scale


def quantize(x: torch.Tensor, levels: int) -> torch.Tensor:
    with span("kernel.quantize"):
        if x.device.type == "cpu":
            return quantize_plain(x, levels)
        _check_cuda_f32("quantize", x)
        out = torch.empty_like(x)
        code = load_library().quantize_launch(
            x.data_ptr(), out.data_ptr(), x.numel(), float(levels - 1),
            _stream(x.device))
    _raise_on_error("quantize", code)
    LAUNCHES["quantize"] += 1
    return out


# ---------------------------------------------------------------------------
# uniform_noise: replaces ops/pallas_ops.py::uniform_noise_pallas (:169,
# body _make_uniform_kernel :148).  The kernel's Philox bits are not the
# TPU's, so it is held to the distribution, not to bits.
# ---------------------------------------------------------------------------

def uniform_noise_plain(shape, eps: float, generator: torch.Generator):
    """Uniform(-eps, eps) float32 from ``torch.rand`` on the generator's device."""
    u = torch.rand(tuple(shape), generator=generator, dtype=torch.float32,
                   device=generator.device)
    return (u * 2.0 - 1.0) * eps


def uniform_noise(shape, eps: float, generator: torch.Generator,
                  device: torch.device | str) -> torch.Tensor:
    """Uniform(-eps, eps) float32 noise of ``shape`` on ``device``.

    On a CUDA device the Philox kernel draws it, keyed on a 64-bit seed taken
    from ``generator``; on the CPU ``torch.rand`` draws it from ``generator``.
    A ``core.rng.ShardGenerator`` (one shard of a sharded batch) gives its
    rows of the whole batch's draw: the kernel starts at the shard's first
    element (``offset``) under the whole batch's seed, and the CPU slices
    the whole batch's uniforms.
    """
    device = torch.device(device)
    with span("kernel.noise"):
        if isinstance(generator, ShardGenerator):
            return _shard_noise(shape, eps, generator, device)
        if device.type == "cpu":
            return uniform_noise_plain(shape, eps, generator)
        return uniform_noise_at(shape, eps, seed_draw(generator), device)


def uniform_noise_at(shape, eps: float, seed: int, device: torch.device | str,
                     offset: int = 0) -> torch.Tensor:
    """The kernel's draw under ``seed``, its element 0 being element
    ``offset`` of the draw that starts at 0 (CUDA only: the plain version
    has no counter to offset)."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("uniform_noise_at launches the CUDA kernel; the CPU draws "
                         "through uniform_noise")
    out = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    code = load_library().uniform_noise_launch(
        out.data_ptr(), out.numel(), seed, float(eps), int(offset), _stream(device))
    _raise_on_error("uniform_noise", code)
    LAUNCHES["uniform_noise"] += 1
    return out


def _shard_noise(shape, eps: float, g: ShardGenerator, device: torch.device) -> torch.Tensor:
    if device.type == "cpu":
        return batch_draw(g, shape, lambda s, p: uniform_noise_plain(s, eps, p)).to(device)
    shape = tuple(int(s) for s in shape)
    if shape[0] != g.hi - g.lo:
        raise ValueError(f"a shard of rows [{g.lo}, {g.hi}) draws {shape[0]} rows")
    row = 1
    for s in shape[1:]:
        row *= s
    return uniform_noise_at(shape, eps, whole_batch_draw(g, seed_draw), device,
                            offset=g.lo * row)
