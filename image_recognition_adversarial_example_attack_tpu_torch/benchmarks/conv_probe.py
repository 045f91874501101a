"""Conv probe: the hand-written 3x3 conv kernel against cuDNN's conv.

The counterpart of ``benchmarks/pallas_conv_probe.py``: one ResNet-50
stage-1 bottleneck 3x3 conv, ``[B,56,56,64] x [3,3,64,64] -> [B,56,56,64]``
(NHWC x HWIO), at batch 128 in bfloat16, computed by ``kernels/conv3x3.py``
(``csrc/conv3x3.cu``) and timed against ``F.conv2d`` on the channels_last
view (cuDNN), the yardstick that stands where the JAX probe's
``xla_conv3x3`` stands.  The port never computes with ``F.conv2d``.

    python -m image_recognition_adversarial_example_attack_tpu_torch.benchmarks.conv_probe
    python -m image_recognition_adversarial_example_attack_tpu_torch.benchmarks.conv_probe \\
        --device cpu --batch 2 --iters 1     # the plain version, on the CPU

Same inputs as the JAX probe (``np.random.RandomState(0)``: ``randn`` for x,
``randn * 0.05`` for w) and the same gate: relative error against the
library conv below 3e-2.  On the card the times are CUDA-event means over
``--iters`` calls after a warm-up, and the peaks are an H100 SXM's (989
TFLOP/s bf16 dense, 67 TFLOP/s float32).  On the CPU the times are host
clock, and the rates and percentages of peak are null: no device was
measured.
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..core.device import resolve_device
from ..kernels.conv3x3 import C, K, conv3x3

H = W = 56
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # H100 SXM data sheet
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
GATE = 3e-2


def make_inputs(batch: int, dtype: torch.dtype, device: torch.device):
    rng = np.random.RandomState(0)
    x = torch.tensor(rng.randn(batch, H, W, C), dtype=dtype, device=device)
    w = torch.tensor(rng.randn(K, K, C, C) * 0.05, dtype=dtype, device=device)
    return x, w


def cudnn_conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The library conv on the same NHWC/HWIO tensors: NCHW views, which are
    channels_last for a contiguous NHWC x; NHWC out."""
    out = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1)
    return out.permute(0, 2, 3, 1)


def time_ms(fn, iters: int, device: torch.device) -> float:
    """Mean milliseconds per call after one warm-up call: CUDA events on
    the card, the host clock on the CPU."""
    fn()
    if device.type == "cpu":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def run(batch: int = 128, iters: int = 30, dtype: str = "bfloat16",
        device: str = "cuda") -> dict:
    dev = resolve_device(device)
    prev_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # the float32 yardstick is exact float32
    try:
        x, w = make_inputs(batch, DTYPES[dtype], dev)
        ours = conv3x3(x, w)
        ref = cudnn_conv3x3(x, w)
        err = float((ours.float() - ref.float()).abs().max())
        scale = float(ref.float().abs().max()) or 1.0
        rel = err / scale
        if not rel < GATE:
            raise AssertionError(f"numerics mismatch: rel={rel}")
        t_kernel = time_ms(lambda: conv3x3(x, w), iters, dev)
        t_cudnn = time_ms(lambda: cudnn_conv3x3(x, w), iters, dev)
    finally:
        torch.backends.cudnn.allow_tf32 = prev_tf32
    flops = 2 * batch * H * W * K * K * C * C
    on_card = dev.type == "cuda"
    peak = PEAK_FLOPS[dtype]
    return {
        "probe": "conv3x3_stage1",
        "batch": batch,
        "dtype": dtype,
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "rel_err_vs_cudnn": rel,
        "kernel_ms": t_kernel,
        "cudnn_ms": t_cudnn,
        "kernel_tflops": flops / t_kernel / 1e9 if on_card else None,
        "cudnn_tflops": flops / t_cudnn / 1e9 if on_card else None,
        "kernel_pct_of_peak": 100 * flops / t_kernel / 1e-3 / peak if on_card else None,
        "cudnn_pct_of_peak": 100 * flops / t_cudnn / 1e-3 / peak if on_card else None,
        "speedup_vs_cudnn": t_cudnn / t_kernel,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--dtype", type=str, default="bfloat16", choices=list(DTYPES))
    ap.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                    help="device to run on (default: %(default)s; the CPU runs "
                         "the plain version and measures no device)")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.batch, args.iters, args.dtype, args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
