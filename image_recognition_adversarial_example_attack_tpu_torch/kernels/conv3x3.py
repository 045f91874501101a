"""Wrapper of the 3x3 conv CUDA kernel, with its plain version and tile plan.

``conv3x3`` replaces the Pallas TPU kernel
``benchmarks/pallas_conv_probe.py::pallas_conv3x3`` (body ``_conv_kernel``):
a 3x3, stride-1, same-padded convolution of an NHWC batch ``[B,H,W,64]``
with an HWIO weight ``[3,3,64,64]``, summed in float32 and cast to the
input's dtype (bfloat16 or float32).  The kernel is ``csrc/conv3x3.cu``: one
TMA-loaded input halo per band of output rows, shared by the nine taps,
feeding ``wgmma`` on the tensor cores (bf16) or a register-tiled exact
float32 FMA loop.  ``tile_plan`` sizes the band; the wrapper passes the plan
to the launcher.  A tensor on the CPU takes the plain version; a tensor on a
CUDA device launches the kernel or raises.  There is no fallback.

At the probe's ``[128,56,56,64]`` bf16 the least time on an H100 SXM is the
bytes' 0.0307 ms (102.8 MB at 3.35 TB/s), with the flops' 0.0299 ms (29.60
GFLOP at 989 TFLOP/s) close behind; in float32, 0.44 ms of FP32 FMA.

``LAUNCHES`` counts the kernel launches (plain-version calls are not counted);
``LAST_LAUNCH`` holds the grid of the last one.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .build import load_library

C = 64  # input and output channels, the probe's constants the kernel is written for
K = 3

LAUNCHES: dict[str, int] = {"conv3x3": 0}
LAST_LAUNCH: dict[str, int] = {}
_LAUNCHERS = {torch.bfloat16: "conv3x3_bf16_launch", torch.float32: "conv3x3_f32_launch"}


def reset_launches() -> None:
    LAUNCHES["conv3x3"] = 0


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)


BAND = 256  # positions a band computes, M: one wgmma N (bf16), 256 threads x 8 (f32)
_PLAN_REFUSED = -1  # the launchers' code for a plan whose buffers do not fit


class TilePlan(NamedTuple):
    rows: int             # R, output rows per band (one tile)
    tiles_per_image: int  # ceil(H / R); the last band may be ragged
    halo_rows: int        # (R+2)*(W+2): the input rows one TMA box loads
    buf_rows: int         # rows of a halo buffer: every row any of BAND positions reads


def tile_plan(h: int, w: int) -> TilePlan:
    """The band of output rows one tile of the kernel computes.

    Position q = yy*(W+2) + xx of a band reads halo row q + dy*(W+2) + dx
    for tap (dy, dx); positions with xx >= W or yy >= R are computed and
    never stored.  A band holds at most 256 positions, R = min(H, 256 //
    (W+2)).  Raises ValueError for an image that no band holds (W > 254).
    The launcher owns the shared-memory layout and refuses a plan whose
    buffers do not fit (bf16 takes W <= 73, float32 W <= 61).
    """
    wp = w + 2
    rows = min(h, BAND // wp)
    if h < 1 or w < 1 or rows < 1:
        raise ValueError(f"conv3x3: the kernel's band does not take an image of {h}x{w}")
    buf_rows = -(-(BAND + 2 * wp + 2) // 8) * 8
    return TilePlan(rows, -(-h // rows), (rows + 2) * wp, buf_rows)


def _im2col_product(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    b, h, wd, c = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    patches = torch.cat([xp[:, dy:dy + h, dx:dx + wd, :]
                         for dy in range(K) for dx in range(K)], dim=-1)
    acc = patches.reshape(b * h * wd, K * K * c).to(dtype) @ w.reshape(K * K * c, -1).to(dtype)
    return acc.reshape(b, h, wd, -1)


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``_conv_kernel`` op for op: zero padding, the nine shifted slices
    concatenated on the channel axis (tap-major im2col, ``[B*H*W, 576]``),
    one float32 product with ``w.reshape(576, C_out)``, cast to x's dtype."""
    return _im2col_product(x, w, torch.float32).to(x.dtype)


def bf16_rounding_interval(x: torch.Tensor, w: torch.Tensor):
    """(lo, hi): the bfloat16 values that rounding a float32 sum of the conv's
    576 products per output can give, in any summation order.

    bf16 products are exact in float32, and n-term float32 summation in any
    order lies within n*u*sum|products| of the exact sum (u = 2^-24); twice
    that covers an accumulator that truncates, as tensor cores may.  So any
    such result, rounded to nearest, lies in [rn(s - r), rn(s + r)], s the
    float64 sum, r = 2*576*2^-24*sum|products|.  Where |s| is large against
    r that is the one or two bf16 values next to s; near zero, where the
    products cancel, it spans more than one bf16 ulp.
    """
    s = _im2col_product(x, w, torch.float64)
    r = 2 * K * K * C * 2.0 ** -24 * _im2col_product(x.abs(), w.abs(), torch.float64)
    return (s - r).to(torch.bfloat16), (s + r).to(torch.bfloat16)


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """One bfloat16 ulp at |v| (8 significant bits), in float32."""
    _, e = torch.frexp(v.float().abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(v, dtype=torch.float32), e - 8)


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.ndim != 4 or x.shape[-1] != C:
        raise ValueError(f"conv3x3: x must be NHWC [B,H,W,{C}], got {tuple(x.shape)}")
    if tuple(w.shape) != (K, K, C, C):
        raise ValueError(f"conv3x3: w must be HWIO [3,3,{C},{C}], got {tuple(w.shape)}")
    if x.dtype != w.dtype or x.dtype not in _LAUNCHERS:
        raise TypeError(f"conv3x3: x and w must both be bfloat16 or both float32, "
                        f"got {x.dtype} and {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"conv3x3: x on {x.device}, w on {w.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("conv3x3: x and w must be contiguous")


def conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """NHWC 3x3 stride-1 same-pad conv, ``[B,H,W,64] x [3,3,64,64] -> [B,H,W,64]``."""
    _check(x, w)
    if x.device.type == "cpu":
        return conv3x3_plain(x, w)
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("conv3x3: the kernel reads 16-byte-aligned tensors")
    out = torch.empty_like(x)
    b, h, wd, _ = x.shape
    if x.numel() == 0:
        return out
    plan = tile_plan(h, wd)
    config = (ctypes.c_int * 4)()
    with torch.cuda.device(x.device):  # the launcher sizes its grid for this card
        code = getattr(load_library("conv3x3"), _LAUNCHERS[x.dtype])(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), b, h, wd,
            plan.rows, plan.buf_rows, config,
            torch.cuda.current_stream(x.device).cuda_stream)
    if code == _PLAN_REFUSED:
        raise ValueError(f"conv3x3: the kernel's band does not take an image of {h}x{wd} "
                         f"in {x.dtype}: its buffers exceed a block's shared memory")
    if code != 0:
        raise RuntimeError(f"conv3x3: CUDA launch failed with cudaError {code}")
    LAUNCHES["conv3x3"] += 1
    LAST_LAUNCH.update(zip(("blocks", "threads", "smem_bytes", "rows"), config))
    return out
