"""The fused frozen-BatchNorm -> (residual add) -> ReLU kernels
(``csrc/bn_act.cu``), forward and input gradient, with their plain version.

``relu(bn(x))``, ``relu(bn(x) + z)`` and ``relu(bn(x) + bn_z(z))``, where
``bn`` is a ``models.resnet.FrozenBatchNorm2d`` (running statistics, float32
parameters) and ``x``, ``z`` are bfloat16 channels_last activations: the
chain of every ResNet block.  They replace no TPU kernel (XLA fuses the
chain there); unfused, PyTorch runs a BatchNorm, a ReLU and an add kernel
for it, and in a backward pass a generic broadcast kernel for the
BatchNorm's input gradient.

``plan(x, bn, z, z_bn)`` says from what it can observe whether the fused
kernels take a call: a CUDA tensor, bfloat16, channels_last, C a multiple of
8 up to 2048 matching the BatchNorm's, and no BatchNorm tensor that requires
grad while grad is enabled (the kernels compute no parameter gradient).
``bn_act`` launches the kernels (under autograd, through a
``torch.autograd.Function`` whose backward is the backward kernel) and raises
on anything they do not take; ``bn_act_plain`` is the unfused composition,
which every other call takes (the CPU, float32 models, a training forward
whose BatchNorm parameters are leaves).

Bound: bytes at 3.35 TB/s (an H100 SXM); per element, 4 B forward (6 with
``z``) and 6 B backward (8 with ``z``'s gradient).  ``LAUNCHES`` counts the
launches of each kernel, by variant and direction (plain calls are not
counted).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from .build import load_library

# the launchers' modes (csrc/bn_act.cu), and each mode's kernel
RELU, ADD_RELU, BN_ADD_RELU = 0, 1, 2
VARIANTS = ("bn_relu", "bn_add_relu", "bn_bn_add_relu")
LAUNCHES: dict[str, int] = {f"{v}{d}": 0 for d in ("", "_backward") for v in VARIANTS}
MAX_CHANNELS = 2048
# bytes moved per element of x: (forward, backward), by mode
BYTES_PER_ELEMENT = {RELU: (4, 6), ADD_RELU: (6, 8), BN_ADD_RELU: (6, 8)}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)


def bn_act_plain(x: torch.Tensor, bn, z: torch.Tensor | None = None, z_bn=None) -> torch.Tensor:
    """relu(bn(x) [+ z or + z_bn(z)]): the BatchNorm module, the add and the
    ReLU as separate operations."""
    y = bn(x)
    if z is not None:
        y = y + (z if z_bn is None else z_bn(z))
    return F.relu(y)


def _bn_tensors(bn) -> tuple[torch.Tensor, ...]:
    return bn.running_mean, bn.running_var, bn.weight, bn.bias


def _act_refusal(t: torch.Tensor) -> str | None:
    """Why the kernels do not take activation ``t`` (dtype, layout,
    alignment), or None."""
    if t.dtype != torch.bfloat16:
        return f"not bfloat16 ({t.dtype})"
    if t.dim() != 4 or not t.is_contiguous(memory_format=torch.channels_last):
        return "not a channels_last NCHW tensor"
    if t.data_ptr() % 16:
        return "not 16-byte aligned"
    return None


def _bn_refusal(bn, stats, channels: int, device: int) -> str | None:
    """Why the kernels do not take BatchNorm ``bn`` (its tensors ``stats``)
    on ``channels`` channels of card ``device``, or None."""
    if channels != bn.num_features or channels % 8 or channels > MAX_CHANNELS:
        return f"{channels} channels (the BatchNorm has {bn.num_features}; the kernels " \
               f"take multiples of 8 up to {MAX_CHANNELS})"
    for t in stats:
        if t is None or t.dtype != torch.float32 or not t.is_contiguous() \
                or t.get_device() != device:
            return "BatchNorm tensors not float32 and contiguous on the input's device"
    return None


def plan(x: torch.Tensor, bn, z: torch.Tensor | None = None, z_bn=None):
    """The launch plan of ``relu(bn(x) [+ z or + z_bn(z)])`` where the fused
    kernels take it, else a string that says why not.  The device is
    checked last, so that on the CPU every other observable still reports
    its own reason.  A plan holds the mode, eps, the BatchNorm tensors and
    their pointers, read once a call: nothing outlives the call but through
    autograd."""
    stats = _bn_tensors(bn)
    why = _act_refusal(x) or _bn_refusal(bn, stats, x.size(1), x.get_device())
    z_stats = None
    if why is None and z is not None:
        if z.shape != x.shape:
            return f"residual of shape {tuple(z.shape)} against {tuple(x.shape)}"
        why = _act_refusal(z)
        if why is None and z_bn is not None:
            z_stats = _bn_tensors(z_bn)
            why = _bn_refusal(z_bn, z_stats, x.size(1), x.get_device())
            if why is None and z_bn.eps != bn.eps:
                why = "the two BatchNorms' eps differ"
    if why is not None:
        return why
    if torch.is_grad_enabled():
        for t in stats if z_stats is None else stats + z_stats:
            if t.requires_grad:
                return "a BatchNorm tensor requires grad"
    if not x.is_cuda:
        return f"not a CUDA tensor ({x.device.type})"
    ptrs = [t.data_ptr() for t in stats]
    z_ptrs = [None] * 4 if z_stats is None else [t.data_ptr() for t in z_stats]
    mode = RELU if z is None else ADD_RELU if z_bn is None else BN_ADD_RELU
    return mode, float(bn.eps), ptrs, z_ptrs, (stats, z_stats)


def _stream(x: torch.Tensor) -> int:
    # the raw handle of the current stream: a plain integer, without the
    # Stream object that torch.cuda.current_stream builds on every call
    return torch._C._cuda_getCurrentRawStream(x.get_device())


def _raise_on_error(name: str, code: int) -> None:
    if code == -1:
        raise ValueError(f"{name}: the kernel does not take this channel count")
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {code}")


def _forward(x, z, p) -> torch.Tensor:
    mode, eps, ptrs, z_ptrs, _ = p
    y = torch.empty_like(x)  # x is channels_last-contiguous, and so is y
    n, c, h, w = x.shape
    code = load_library("bn_act").bn_act_forward_launch(
        mode, x.data_ptr(), None if z is None else z.data_ptr(), *ptrs, *z_ptrs, y.data_ptr(),
        n * h * w, c, eps, _stream(x))
    _raise_on_error("bn_act", code)
    LAUNCHES[VARIANTS[mode]] += 1
    return y


def _grad_operand(grad: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``grad`` as the backward kernel reads it: y's shape and dtype (else
    ValueError), channels_last and 16-byte aligned, copied into a fresh
    buffer where it is not."""
    if grad.shape != y.shape or grad.dtype != y.dtype:
        raise ValueError(f"bn_act_backward: a gradient of {tuple(grad.shape)} {grad.dtype} "
                         f"for an output of {tuple(y.shape)} {y.dtype}")
    if _act_refusal(grad) is None:
        return grad
    return torch.empty_like(y).copy_(grad)  # y is channels_last and aligned


def _backward(grad, y, p, with_z: bool = True):
    """(gx, gz) of the plan's chain from ``grad`` and the forward's output;
    gz is None for bn_relu or where ``with_z`` is False."""
    mode, eps, ptrs, z_ptrs, _ = p
    if not with_z:
        mode = RELU
    grad = _grad_operand(grad, y)
    gx = torch.empty_like(y)  # channels_last, as y
    gz = None if mode == RELU else torch.empty_like(y)
    n, c, h, w = y.shape
    # the backward reads each BatchNorm's var and weight
    code = load_library("bn_act").bn_act_backward_launch(
        mode, grad.data_ptr(), y.data_ptr(), ptrs[1], ptrs[2], z_ptrs[1], z_ptrs[2],
        gx.data_ptr(), None if gz is None else gz.data_ptr(), n * h * w, c, eps, _stream(y))
    _raise_on_error("bn_act_backward", code)
    LAUNCHES[VARIANTS[mode] + "_backward"] += 1
    return gx, gz


class _BnAct(torch.autograd.Function):
    """The forward kernel, and the backward kernel as its gradient: the
    gradients of ``x`` and of ``z`` from ``grad`` and the saved output
    alone.  The BatchNorm tensors get none: ``plan`` sends a call whose
    BatchNorm needs one to the plain version, and the plan keeps them
    alive until the backward has run."""

    @staticmethod
    def forward(ctx, x, z, p):
        y = _forward(x, z, p)
        ctx.plan = p
        ctx.save_for_backward(y)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        (y,) = ctx.saved_tensors
        # z's gradient only where z needs one
        gx, gz = _backward(grad, y, ctx.plan, with_z=ctx.needs_input_grad[1])
        return gx, gz, None


def launch(x: torch.Tensor, z: torch.Tensor | None, p) -> torch.Tensor:
    """The fused chain for plan ``p`` of ``plan(x, bn, z, z_bn)``: under
    autograd through ``_BnAct``, else the forward kernel alone."""
    if torch.is_grad_enabled() and (x.requires_grad or (z is not None and z.requires_grad)):
        return _BnAct.apply(x, z, p)
    return _forward(x, z, p)


def bn_act(x: torch.Tensor, bn, z: torch.Tensor | None = None, z_bn=None) -> torch.Tensor:
    """relu(bn(x) [+ z or + z_bn(z)]) through the fused kernels; raises
    ValueError on what they do not take (``plan``)."""
    p = plan(x, bn, z, z_bn)
    if isinstance(p, str):
        raise ValueError(f"bn_act: the fused kernels do not take this call: {p}")
    return launch(x, z, p)
