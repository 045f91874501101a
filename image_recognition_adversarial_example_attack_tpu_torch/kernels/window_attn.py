"""The shifted-window attention kernel pair of Swin's blocks
(``csrc/window_attn.cu``), forward and input gradient, with its plain version.

Both take ``qkv``, the qkv linear's output on the unpartitioned ``[B, H, W,
C]`` map (``[B, H, W, 3C]``, channels packed (part, head, 32) as
``models/vit.py::split_heads`` reads them), and the relative-position bias
table ``[(2ws-1)^2, heads]``, and return the attention's output ``[B, H, W,
C]`` before the proj linear, heads packed as ``merge_heads`` packs them.
The shift's roll, the window partition, the head split, their reverses and
the bias gather are index arithmetic: window (wy, wx)'s token (i, j) sits at
``((wy*ws + i + s) mod H, (wx*ws + j + s) mod W)``, its bias row is
``(di + ws-1)(2ws-1) + (dj + ws-1)``, and the -100 seam mask falls between
tokens whose rolled coordinates lie in different regions
(``models/swin.py::shift_attn_mask``).  The qkv and proj linears act per
token, so they commute with the roll and the partition.

``plan(x, attn, shift)`` says from what it can observe whether the kernels
take a ``WindowAttention`` call on ``x`` (the block's normed map): a CUDA
bfloat16 contiguous map, plain float linears (not ``ops/int8.py``'s, which
quantize one scale per window of the partitioned layout), head dim 32,
window 7 (every Swin variant's; the one window the kernels are built and
checked for), H and W multiples of the window, and a bias table that
does not require grad while grad is enabled (the kernels compute no table
gradient).  ``launch`` runs the kernels (under autograd through a
``torch.autograd.Function`` whose backward is the backward kernel);
``window_attn`` raises on what they do not take.  ``window_attn_plain``
computes the same function in PyTorch with the same addressing, scores and
softmax in float32 and P rounded to the input's dtype as the kernel rounds
it: the kernels' oracle in the tests and in ``chip_smoke.py``, within
``FORWARD_REL_TOL`` and ``BACKWARD_REL_TOL`` by ``rel_l2``.  Every call the
plan refuses runs ``WindowAttention._attend`` unchanged.

Bound: bytes at 3.35 TB/s (an H100 SXM); per token, forward 8C bytes (3C
read, C written, bf16), backward 14C (3C + C read, 3C written).
``LAUNCHES`` counts the launches of each direction (plain calls are not
counted).
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.autograd.function import once_differentiable

from .build import load_library

HEAD_DIM = 32
WINDOW = 7  # the one window size csrc/window_attn.cu instantiates
LAUNCHES: dict[str, int] = {"window_attn": 0, "window_attn_backward": 0}
# bytes moved per token and channel: (forward, backward)
BYTES_PER_TOKEN_CHANNEL = (8, 14)
MASK = -100.0
# bf16 tolerances of the kernels against ``window_attn_plain``, as relative
# L2 norms over the tensor: the forward rounds P and O to bf16 as the plain
# version does and differs only in float32 summation order and exp2f (about
# 2^-9 of the output); the backward also rounds dS to bf16 before dQ and dK,
# where the plain version keeps float32
FORWARD_REL_TOL = 4e-3
BACKWARD_REL_TOL = 1.5e-2


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    """|a - b| / |b| in float32, over the whole tensor."""
    return float((a.float() - b.float()).norm() / b.float().norm())


def unrolled_positions(h: int, w: int, window: int, shift: int) -> tuple[torch.Tensor, ...]:
    """(rows [h/ws, ws], cols [w/ws, ws]): where window (wy, wx)'s token
    (i, j) of the map rolled by (-shift, -shift) sits in the unrolled map."""
    rows = (torch.arange(h // window)[:, None] * window + torch.arange(window) + shift) % h
    cols = (torch.arange(w // window)[:, None] * window + torch.arange(window) + shift) % w
    return rows, cols


def relative_index(window: int) -> torch.Tensor:
    """[ws*ws, ws*ws] rows of the bias table, from the tokens' coordinates:
    (di + ws-1)(2ws-1) + (dj + ws-1)."""
    t = torch.arange(window * window)
    i, j = t // window, t % window
    return ((i[:, None] - i[None, :] + window - 1) * (2 * window - 1)
            + j[:, None] - j[None, :] + window - 1)


def seam_mask(h: int, w: int, window: int, shift: int) -> torch.Tensor:
    """[nW, ws*ws, ws*ws] float32: -100 between tokens whose rolled
    coordinates lie in different seam regions (rows and columns below
    ``H - ws``, below ``H - shift``, or past it), 0 elsewhere; all 0 where
    ``shift`` is 0."""
    n_windows, t = (h // window) * (w // window), window * window
    if not shift:
        return torch.zeros(n_windows, t, t)

    def region(n):
        r = torch.arange(n)
        return (r >= n - window).long() + (r >= n - shift).long()

    ry = region(h).reshape(h // window, window)
    rx = region(w).reshape(w // window, window)
    label = (ry[:, None, :, None] * 3 + rx[None, :, None, :]).reshape(n_windows, t)
    return torch.where(label[:, :, None] != label[:, None, :], MASK, 0.0)


def window_attn_plain(qkv: torch.Tensor, table: torch.Tensor, num_heads: int, window: int,
                      shift: int) -> torch.Tensor:
    """The kernels' function in PyTorch, differentiable: scores, bias, mask
    and softmax in float32, P rounded to ``qkv``'s dtype before ``P v``, the
    output rounded to it; float32 throughout for a float32 ``qkv``."""
    b, h, w, c3 = qkv.shape
    c, t = c3 // 3, window * window
    rows, cols = unrolled_positions(h, w, window, shift)
    rows, cols = rows.to(qkv.device), cols.to(qkv.device)
    # [B, h/ws, w/ws, ws, ws, 3C] -> q, k, v as [B, nW, heads, T, hd]
    win = qkv[:, rows[:, None, :, None], cols[None, :, None, :]]
    parts = win.reshape(b, -1, t, 3, num_heads, c // num_heads).permute(3, 0, 1, 4, 2, 5)
    q, k, v = (p.float() for p in parts)
    bias = table.float()[relative_index(window).to(qkv.device)].permute(2, 0, 1)
    bias = bias + seam_mask(h, w, window, shift).to(qkv.device)[:, None]
    scores = q @ k.transpose(-2, -1) / math.sqrt(c // num_heads) + bias
    p = scores.softmax(dim=-1).to(qkv.dtype).float()
    out = (p @ v).to(qkv.dtype)  # [B, nW, heads, T, hd]
    out = out.permute(0, 1, 3, 2, 4).reshape(b, h // window, w // window, window, window, c)
    full = qkv.new_empty((b, h, w, c))
    full[:, rows[:, None, :, None], cols[None, :, None, :]] = out
    return full


def _refusal(t: torch.Tensor, parts: int, table: torch.Tensor, num_heads: int, window: int,
             shift: int) -> str | None:
    """Why the kernels do not take map ``t`` ([B, H, W, parts * C]) with
    ``table``, or None; the device is not checked here."""
    if t.dtype != torch.bfloat16:
        return f"not bfloat16 ({t.dtype})"
    if t.dim() != 4 or t.shape[-1] != parts * num_heads * HEAD_DIM:
        return f"not a [B, H, W, {parts} x heads x {HEAD_DIM}] map ({tuple(t.shape)}, " \
               f"{num_heads} heads): head dim {HEAD_DIM} only"
    if window != WINDOW:
        return f"window {window}: the kernels take window {WINDOW} only"
    if t.shape[1] % window or t.shape[2] % window:
        return f"a {t.shape[1]}x{t.shape[2]} map is not a multiple of the window {window}"
    if not 0 <= shift < window:
        return f"shift {shift} outside [0, {window})"
    if not t.is_contiguous() or t.data_ptr() % 16:
        return "not contiguous and 16-byte aligned"
    if table.dtype != t.dtype or tuple(table.shape) != ((2 * window - 1) ** 2, num_heads) \
            or not table.is_contiguous():
        return "the bias table is not a contiguous bfloat16 [(2ws-1)^2, heads] tensor"
    return None


def plan(x: torch.Tensor, attn: nn.Module, shift: int):
    """The launch plan of ``attn`` (a ``models.swin.WindowAttention``) on its
    normed input ``x`` ([B, H, W, C]) rolled by ``shift``, where the kernels
    take it, else a string that says why not.  The device is checked last,
    so that on the CPU every other observable still reports its own reason.
    A plan is the call's integers (H, W, C, heads, window, shift): nothing
    in it outlives the call as a pointer."""
    table = attn.relative_position_bias_table
    why = _refusal(x, 1, table, attn.num_heads, attn.window, shift)
    if why is not None:
        return why
    if type(attn.qkv) is not nn.Linear or type(attn.proj) is not nn.Linear:
        return "qkv or proj is not a plain float linear (int8)"
    if attn.qkv.weight.dtype != torch.bfloat16:
        return f"the qkv linear is not bfloat16 ({attn.qkv.weight.dtype})"
    if torch.is_grad_enabled() and table.requires_grad:
        return "the bias table requires grad"
    if not x.is_cuda:
        return f"not a CUDA tensor ({x.device.type})"
    if table.device != x.device or attn.qkv.weight.device != x.device:
        return "the module's tensors are not on the input's device"
    _, h, w, c = x.shape
    return h, w, c, attn.num_heads, attn.window, shift


def _stream(x: torch.Tensor) -> int:
    # the raw handle of the current stream, as kernels/bn_act.py takes it
    return torch._C._cuda_getCurrentRawStream(x.get_device())


def _raise_on_error(name: str, code: int) -> None:
    if code == -1:
        raise ValueError(f"{name}: the kernel does not take this shape")
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {code}")


def _forward(qkv: torch.Tensor, table: torch.Tensor, p) -> torch.Tensor:
    h, w, c, heads, window, shift = p
    if qkv.shape[1:] != (h, w, 3 * c) or qkv.dtype != torch.bfloat16 or not qkv.is_contiguous():
        raise ValueError(f"window_attn: qkv of {tuple(qkv.shape)} {qkv.dtype} for a plan of a "
                         f"{h}x{w}x{c} map (contiguous bfloat16 [B, H, W, 3C] only)")
    out = qkv.new_empty(qkv.shape[:-1] + (c,))
    code = load_library("window_attn").window_attn_forward_launch(
        qkv.data_ptr(), table.data_ptr(), out.data_ptr(), qkv.shape[0], h, w, c, heads, window,
        shift, _stream(qkv))
    _raise_on_error("window_attn", code)
    LAUNCHES["window_attn"] += 1
    return out


def _backward(qkv: torch.Tensor, table: torch.Tensor, grad: torch.Tensor, p) -> torch.Tensor:
    """dqkv from the saved ``qkv``, the table and the gradient of the
    output; a gradient that is not contiguous and aligned is copied first."""
    h, w, c, heads, window, shift = p
    if grad.shape != qkv.shape[:-1] + (c,) or grad.dtype != qkv.dtype:
        raise ValueError(f"window_attn_backward: a gradient of {tuple(grad.shape)} "
                         f"{grad.dtype} for qkv of {tuple(qkv.shape)} {qkv.dtype}")
    if not grad.is_contiguous() or grad.data_ptr() % 16:
        grad = torch.empty(grad.shape, dtype=grad.dtype, device=grad.device).copy_(grad)
    dqkv = torch.empty_like(qkv)  # every element is written
    code = load_library("window_attn").window_attn_backward_launch(
        qkv.data_ptr(), table.data_ptr(), grad.data_ptr(), dqkv.data_ptr(), qkv.shape[0], h, w,
        c, heads, window, shift, _stream(qkv))
    _raise_on_error("window_attn_backward", code)
    LAUNCHES["window_attn_backward"] += 1
    return dqkv


class _WindowAttn(torch.autograd.Function):
    """The forward kernel, and the backward kernel as its gradient of qkv.
    ``qkv`` and the table are saved through ``save_for_backward``, so
    autograd's version check covers them; the table gets no gradient
    (``plan`` sends a call whose table needs one to the written-out path)."""

    @staticmethod
    def forward(ctx, qkv, table, p):
        ctx.plan = p
        ctx.save_for_backward(qkv, table)
        return _forward(qkv, table, p)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        qkv, table = ctx.saved_tensors
        return _backward(qkv, table, grad, ctx.plan), None, None


def launch(qkv: torch.Tensor, table: torch.Tensor, p) -> torch.Tensor:
    """The kernels for plan ``p`` of ``plan(x, attn, shift)`` on ``qkv =
    attn.qkv(x)``: under autograd through ``_WindowAttn``, else the forward
    kernel alone."""
    if torch.is_grad_enabled() and qkv.requires_grad:
        return _WindowAttn.apply(qkv, table, p)
    return _forward(qkv, table, p)


def window_attn(qkv: torch.Tensor, table: torch.Tensor, num_heads: int, window: int,
                shift: int) -> torch.Tensor:
    """The attention of ``qkv`` ([B, H, W, 3C]) through the kernels; raises
    ValueError on what they do not take, a CPU tensor included."""
    why = _refusal(qkv, 3, table, num_heads, window, shift)
    if why is None and torch.is_grad_enabled() and table.requires_grad:
        why = "the bias table requires grad"
    if why is None and not (qkv.is_cuda and table.device == qkv.device):
        why = f"not a CUDA tensor with its table on its device ({qkv.device.type})"
    if why is not None:
        raise ValueError(f"window_attn: the kernels do not take this call: {why}")
    _, h, w, c3 = qkv.shape
    return launch(qkv, table, (h, w, c3 // 3, num_heads, window, shift))
