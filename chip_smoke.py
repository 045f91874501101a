#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port on one CUDA card, end to end.

    python3 chip_smoke.py [--out record.json]

Phases, in order; any failure is an uncaught exception and a non-zero exit:

1. build   -- nvcc builds each source of ``csrc/`` (sm_90a), one process per
   source, all started together; prints seconds.
2. kernels -- each elementwise kernel against its plain PyTorch version at
   the main path's [128,224,224,3] float32: pgd_step and quantize
   bit-exact, the Philox noise held to its distribution; kernel, plain,
   bound and (where one exists) library times.
2b. conv   -- the 3x3 conv kernel against its plain version at the probe's
   [128,56,56,64] x [3,3,64,64] bfloat16: every element in the bf16
   rounding interval of a float32 sum (one bf16 ulp but where the products
   cancel), fewer than 0.1% more than one ulp apart; the float32
   instantiation at batch 8 and 128 within 1e-5 of the largest output (and
   the fraction of its elements bit-equal to the plain version's), and
   its times at batch 128 beside cuDNN's (TF32 off), each also replayed
   from a CUDA graph (graph_ms, which leaves out the host's time per call)
   outside the counted run, and the wrapper's host time per call on a
   one-pixel image; cuDNN's
   F.conv2d within the probe's 3e-2; each launch's grid (blocks, threads,
   dynamic shared memory, band rows R); then the probe's entry point, in this
   process (its launches count) and as a subprocess at its defaults.
3. classify -- ResNet-50 at full width, 224x224, bfloat16, random weights
   from a seed, on a batch of 128; float32 logits of the card held against
   the CPU on two images within 1e-5 relative, a limit that the same logits
   with TF32 allowed must exceed.
4. pgd     -- PGD-10 (eps 8/255, alpha 2/255, random start) through
   ``run_attack("pgd", ...)``: 10 pgd_step and 1 noise launch, inside the
   eps-ball and [0,1]; examples per second after a warm-up; one attack
   under torch.profiler, its device time by layer and the card's busy share.
5. cell    -- one pgd attack -> defend -> detect cell through
   ``evaluate_defenses_batch`` with the threshold from
   ``calibrate_feature_threshold``; quantize launched; its summary line.
5b. cw    -- CW-L2 (100 Adam steps, c = 10) on the same batch: x_adv in
   [0,1], some samples successful, and every one of them misclassified at
   the returned image.
5c. cells  -- pgd cells with the JPEG arm (DCT codec on the card, PIL codec
   on the host) and with the TV arm; quantize launched in each.
6. cli     -- the classify CLI in a subprocess on a PNG, ``--attack pgd
   --save_adv``, and ``--attack cw --cw_steps 100 --save_adv``; the saved
   pgd image within eps of the clean one.
7. detectors -- four pgd cells on the phase-3 batch through
   ``evaluate_defenses_batch``, each inside the eps-ball with its counters
   in range and its launches counted exactly: (a) ``adaptive`` with the
   feature detector (10 pgd_step, 1 noise, 11 quantize: one per step
   inside the attack, one for the defended prediction); (b)
   ``detector_aware`` (lam 1, margin 0.9) against the feature threshold
   (10, 1, 1), its mean feature score beside the oblivious cell's; (c) the
   squeezing detector, calibrated by ``calibrate_squeezing_threshold``
   (10, 1, 3: one for the defense, two for the two scores); (d) the
   Mahalanobis detector fitted by ``calibrate_mahalanobis`` on the 128
   clean images (K = 1000, C = 1024; 10, 1, 1), with the fit's and the
   score's times and finite params.
8. experiments -- the defense_experiments CLI in a subprocess on 128
   generated PNGs (256x300): the default grid (fgsm, pgd, cw x eps {4, 8,
   16}/255, cw_steps 100, auto-calibrated feature detector, 5 samples
   drawn): nine summary lines in the exact format, cw computed once and
   reused twice, nine cells in ``results_partial.json``, the three PNGs
   and ``timings.json``, the wall time and each cell's seconds; the same
   command with ``--resume`` (nine cells resumed); pgd ``--adaptive
   --detector mahalanobis``; fgsm and pgd ``--detector_aware --detector
   squeezing``.
9. stream -- 600 generated PNGs (256x300): (a) the defense_experiments CLI
   in a subprocess with ``--max_batch 128 --attacks fgsm pgd`` (5 chunks, the
   last with 88 valid): the "Streaming evaluation" line, six summary lines,
   ``count == 600`` in every cell, each cell's seconds and img/s beside
   phase 8's resident img/s; (b) on the first 300, fgsm in float32 at
   ``--max_batch 128`` and at ``--max_batch 0``: the six counters of the
   streamed and the resident cell, every difference printed (at most 3, an
   image whose top-1 tie flips between the batch shapes); (c) the uint8
   placer on one chunk, bit-equal to the host's ``round(x*255) /
   float32(255)``; in process, a pgd cell through ``stream_defense_cell`` on
   300 images in chunks of 128 with exactly 30 pgd_step, 3 noise and 3
   quantize launches, and an fgsm cell run twice with equal counters.
10. visualize -- the visualize CLI in a subprocess on one PNG at its
   defaults (PGD-20, CW-100): the three PNGs and ``attack_report.json``
   with the JAX CLI's keys, L-inf within eps for fgsm and pgd, SSIM in
   [0, 1], PSNR finite; in process, PGD-20 and its trajectory at batch 1
   (40 pgd_step, 2 noise launches, 21 trajectory rows), both kernels held
   against their plain versions at [1,224,224,3], and ``attack_metrics`` on
   the card against float64 on the CPU (SSIM within 1e-5, norms within 1e-5
   relative).
11. weights -- the random float32 ResNet-50 written as a Flax msgpack file
   (``to_jax_variables``, ``save_variables``) and loaded back through
   ``load_model(weights=...)`` with ``source == "cache"``: bf16 and float32
   logits on the phase-3 batch bit-equal to the random-init models'.

Then the kernels line (JSON), the card's name and power limit, and last the
line ``{"ok": true, "device": {...}}``.  Without CUDA, or without the port's
package beside it, it exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
PKG = "image_recognition_adversarial_example_attack_tpu_torch"
JAX_OPS = "image_recognition_adversarial_example_attack_tpu/ops/pallas_ops.py"
JAX_PROBE = "benchmarks/pallas_conv_probe.py"
SHAPE = (128, 224, 224, 3)
EPS, ALPHA, STEPS, LEVELS = 8 / 255, 2 / 255, 10, 16
# float32 logits, card vs CPU, relative to the largest logit: above a sound
# float32 reading (~1e-6) and below what TF32 convolutions give (~1e-3)
F32_REL_TOL = 1e-5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
BF16_FLOPS = 989e12        # H100 SXM dense bf16 tensor-core rate
F32_FLOPS = 67e12          # H100 SXM float32 rate outside the tensor cores
CW_STEPS = 100
# The random-weight ResNet-50 puts a top-1 margin of about 1.3 logits on
# every image; at CW's default c = 1 no sample flips in 100 steps, at c = 10
# a few do.  So the cw phase takes c = 10: the check of the successful
# samples has samples to check, and the output takes both branches (best
# successful iterate, final iterate).
CW_C = 10.0
N_STREAM, STREAM_CHUNK, N_F32 = 600, 128, 300
# the key layout of the JAX visualize CLI's attack_report.json (without
# --gradcam); the metric keys are the reference's, in its order
REPORT_KEYS = {"image", "model", "clean_prediction", "params", "attacks"}
CLEAN_KEYS = {"class_id", "class_name", "confidence"}
PARAM_KEYS = {"eps", "alpha", "steps", "cw_c", "cw_steps"}
ATTACK_KEYS = {"predicted_class", "predicted_name", "confidence", "success", "metrics"}
METRIC_KEYS = ["L∞ (pixel)", "L2", "L1", "SSIM", "PSNR", "Perturbed Pixels %",
               "High Freq Ratio %"]
# name -> (TPU kernel it replaces, bytes moved per element: reads + writes)
KERNELS = {
    "pgd_step": (f"{JAX_OPS}:105", 4 * 4),
    "quantize": (f"{JAX_OPS}:132", 2 * 4),
    "uniform_noise": (f"{JAX_OPS}:169", 1 * 4),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds per call of ``fn``, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20) -> float:
    """Mean device milliseconds per call of ``fn``: ``iters`` calls captured
    in one CUDA graph, timed by CUDA events around a replay, so that host
    time between launches (Python, ctypes) does not count."""
    import torch

    fn()  # build, load and allocate outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def bound_ms(name: str, numel: int) -> float:
    return KERNELS[name][1] * numel / HBM_BYTES_PER_S * 1e3


def phase_build() -> dict:
    from image_recognition_adversarial_example_attack_tpu_torch.kernels import build

    t0 = time.perf_counter()
    built = build.build_all()
    for name in built:
        build.load_library(name)
    seconds = time.perf_counter() - t0
    log(f"[build] {', '.join(p.name for p, _ in built.values())} in {seconds:.2f} s")
    for _, nvcc_log in built.values():
        for line in nvcc_log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"[build] ptxas: {line.strip()}")
    return {"seconds": seconds, "libraries": [str(p) for p, _ in built.values()]}


def _sorted_quantiles(t, n_q: int = 101):
    import torch

    flat = torch.sort(t.reshape(-1)).values
    idx = torch.linspace(0, flat.numel() - 1, n_q, dtype=torch.float64,
                         device=t.device).round().long()
    return flat[idx]


def phase_kernels() -> dict:
    """Each kernel against its plain version on the card."""
    import torch

    from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed
    from image_recognition_adversarial_example_attack_tpu_torch.kernels import build
    from image_recognition_adversarial_example_attack_tpu_torch.kernels import elementwise as ew

    dev, shape = torch.device("cuda"), SHAPE
    lib = build.load_library()
    stream = torch.cuda.current_stream().cuda_stream
    g = generator_from_seed(0, dev)
    x = torch.rand(shape, generator=g, device=dev)
    x0 = torch.rand(shape, generator=g, device=dev)
    grad = torch.randn(shape, generator=g, device=dev)
    grad.view(-1)[::7] = 0.0  # sign(0) = 0 must hold
    numel = x.numel()
    out = torch.empty_like(x)
    res = {}

    # pgd_step: bit-exact, untargeted and targeted (-alpha == sign(-g))
    k = ew.pgd_step(x, grad, x0, EPS, ALPHA)
    p = ew.pgd_step_plain(x, grad, x0, EPS, ALPHA)
    kt = ew.pgd_step(x, grad, x0, EPS, -ALPHA)
    pt = ew.pgd_step_plain(x, -grad, x0, EPS, ALPHA)
    torch.cuda.synchronize()
    err = max(float((k - p).abs().max()), float((kt - pt).abs().max()))
    if not (torch.equal(k, p) and torch.equal(kt, pt)):
        raise AssertionError(f"pgd_step kernel differs from its plain version: {err}")
    res["pgd_step"] = {
        "max_abs_err": err, "tolerance": "bit-exact",
        "ms": time_ms(lambda: lib.pgd_step_launch(
            x.data_ptr(), grad.data_ptr(), x0.data_ptr(), out.data_ptr(),
            numel, ALPHA, EPS, stream)),
        "plain_ms": time_ms(lambda: ew.pgd_step_plain(x, grad, x0, EPS, ALPHA)),
        "library_ms": None,
    }

    # quantize: bit-exact, with values outside [0,1] and exact .5 ties
    xq = x * 1.2 - 0.1
    ties = (torch.arange(numel // 11, device=dev) % (LEVELS - 1)).float()
    xq.view(-1)[::11][:ties.numel()] = (ties + 0.5) / (LEVELS - 1)
    n_ties = int(((xq.clamp(0, 1) * (LEVELS - 1)) % 1 == 0.5).sum())
    k = ew.quantize(xq, LEVELS)
    p = ew.quantize_plain(xq, LEVELS)
    torch.cuda.synchronize()
    err = float((k - p).abs().max())
    if not torch.equal(k, p) or n_ties == 0:
        raise AssertionError(f"quantize kernel differs from its plain version: "
                             f"{err} ({n_ties} ties)")
    lib_q = torch.fake_quantize_per_tensor_affine(xq, 1.0 / (LEVELS - 1), 0, 0, LEVELS - 1)
    res["quantize"] = {
        "max_abs_err": err, "tolerance": "bit-exact", "ties": n_ties,
        "ms": time_ms(lambda: lib.quantize_launch(
            xq.data_ptr(), out.data_ptr(), numel, float(LEVELS - 1), stream)),
        "plain_ms": time_ms(lambda: ew.quantize_plain(xq, LEVELS)),
        # no PyTorch call gives these bits: fake-quantize multiplies by a
        # rounded 1/scale and breaks some ties the other way; timed as a
        # yardstick only
        "library_ms": None,
        "fake_quantize_ms": time_ms(lambda: torch.fake_quantize_per_tensor_affine(
            xq, 1.0 / (LEVELS - 1), 0, 0, LEVELS - 1)),
        "fake_quantize_max_abs_diff": float((lib_q - k).abs().max()),
    }

    # uniform noise: the distribution, and the quantiles of the plain version
    n1 = ew.uniform_noise(shape, EPS, generator_from_seed(1), dev)
    n2 = ew.uniform_noise(shape, EPS, generator_from_seed(2), dev)
    plain = ew.uniform_noise_plain(shape, EPS, generator_from_seed(3, dev))
    eps32 = torch.tensor(EPS, dtype=torch.float32, device=dev)  # the kernel's eps
    d = n1.double()
    mean, var = float(d.mean()), float(d.var())
    corr = float(torch.corrcoef(torch.stack([d.reshape(-1), n2.double().reshape(-1)]))[0, 1])
    err = float((_sorted_quantiles(n1) - _sorted_quantiles(plain)).abs().max())
    checks = {
        "in_range": bool(n1.min() >= -eps32 and n1.max() <= eps32),
        "mean": abs(mean) < 1e-3 * EPS,
        "var": abs(var / (EPS ** 2 / 3) - 1) < 2e-3,
        "corr": abs(corr) < 1e-3,
        "quantiles": err < 5e-3 * EPS,
    }
    if not all(checks.values()):
        raise AssertionError(f"noise kernel fails its distribution checks: {checks} "
                             f"mean={mean} var={var} corr={corr} qerr={err}")
    g3 = generator_from_seed(4, dev)
    res["uniform_noise"] = {
        "max_abs_err": err,
        "tolerance": "distribution: range, |mean| < 1e-3 eps, var within 0.2% "
                     "of eps^2/3, |corr| < 1e-3, 101 quantiles within 5e-3 eps",
        "mean": mean, "var": var, "corr": corr,
        "ms": time_ms(lambda: lib.uniform_noise_launch(
            out.data_ptr(), numel, 12345, EPS, stream)),
        "plain_ms": time_ms(lambda: ew.uniform_noise_plain(shape, EPS, g3)),
        "library_ms": time_ms(lambda: torch.empty(shape, device=dev).uniform_(-EPS, EPS)),
        "library_call": "torch.Tensor.uniform_",
    }
    for name, r in res.items():
        r["bound_ms"] = bound_ms(name, numel)
        line = {"kernel": name, "shape": list(shape), "kernel_ms": r["ms"],
                **{k: v for k, v in r.items() if k != "ms"}}
        log(f"[kernels] {json.dumps(line)}")
    return res


def conv_bound_ms(x, w, out) -> tuple[float, str, float, float]:
    """(bound, what bounds it, bytes ms, flops ms) of one 3x3 conv: each
    input read once and the output written once, against the card's memory
    rate; 2*B*H*W*9*Cin*Cout operations against its peak for the dtype."""
    import torch

    b, h, wd, c = x.shape
    nbytes = sum(t.numel() * t.element_size() for t in (x, w, out))
    flops = 2 * b * h * wd * 9 * c * out.shape[-1]
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / (BF16_FLOPS if x.dtype == torch.bfloat16 else F32_FLOPS) * 1e3
    return max(bytes_ms, flops_ms), ("bytes" if bytes_ms >= flops_ms else "operations"), \
        bytes_ms, flops_ms


def phase_conv() -> dict:
    """The 3x3 conv kernel against its plain version and cuDNN, then the
    probe's entry point (the conv's main path) with its launches counted."""
    import torch

    from image_recognition_adversarial_example_attack_tpu_torch.benchmarks import conv_probe
    from image_recognition_adversarial_example_attack_tpu_torch.kernels import conv3x3 as cv

    dev = torch.device("cuda")
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are allowed: the float32 plain version "
                             "would not be float32")
    x, w = conv_probe.make_inputs(128, torch.bfloat16, dev)
    k = cv.conv3x3(x, w)
    launch_bf16 = dict(cv.LAST_LAUNCH)
    p = cv.conv3x3_plain(x, w)
    lo, hi = cv.bf16_rounding_interval(x, w)
    torch.cuda.synchronize()
    diff = (k.float() - p.float()).abs()
    ulp = torch.maximum(cv.bf16_ulp(k), cv.bf16_ulp(p))
    beyond = diff > ulp
    inside = bool(((lo <= k) & (k <= hi)).all())
    frac_beyond = float(beyond.float().mean())
    worst = float(p.float().abs()[beyond].max()) if bool(beyond.any()) else 0.0
    if not inside or frac_beyond >= 1e-3:
        raise AssertionError(f"conv3x3 bf16 kernel vs plain: in the rounding interval "
                             f"{inside}, {frac_beyond:.2e} of elements beyond one ulp")
    ref = conv_probe.cudnn_conv3x3(x, w)
    rel_cudnn = float((k.float() - ref.float()).abs().max()) / float(ref.float().abs().max())
    if not rel_cudnn < conv_probe.GATE:
        raise AssertionError(f"conv3x3 vs F.conv2d: rel {rel_cudnn}")

    f32 = {}
    for batch in (8, 128):
        x32, w32 = conv_probe.make_inputs(batch, torch.float32, dev)
        k32, p32 = cv.conv3x3(x32, w32), cv.conv3x3_plain(x32, w32)
        torch.cuda.synchronize()
        rel32 = float((k32 - p32).abs().max()) / float(p32.abs().max())
        if not rel32 <= 1e-5:
            raise AssertionError(f"conv3x3 float32 kernel vs plain at batch {batch}: "
                                 f"{rel32} of max |out|")
        f32[f"rel_err_b{batch}"] = rel32
        f32[f"frac_bit_equal_b{batch}"] = float((k32 == p32).float().mean())
    f32["launch"] = dict(cv.LAST_LAUNCH)
    # the float32 instantiation's times at the probe's batch; cuDNN with TF32
    # off, so that it computes the same float32 function
    prev_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        f32["ms"] = time_ms(lambda: cv.conv3x3(x32, w32))
        f32["graph_ms"] = graph_ms(lambda: cv.conv3x3(x32, w32))
        f32["plain_ms"] = time_ms(lambda: cv.conv3x3_plain(x32, w32), iters=5, warmup=1)
        f32["library_ms"] = time_ms(lambda: conv_probe.cudnn_conv3x3(x32, w32))
        f32["library_graph_ms"] = graph_ms(lambda: conv_probe.cudnn_conv3x3(x32, w32))
    finally:
        torch.backends.cudnn.allow_tf32 = prev_tf32
    f32["bound_ms"], f32["bound_by"], _, _ = conv_bound_ms(x32, w32, k32)
    del k32, p32

    out = torch.empty_like(x)
    bound, bound_by, bytes_ms, flops_ms = conv_bound_ms(x, w, out)
    res = {
        "max_abs_err": float(diff.max()), "tolerance": (
            "every element in the bf16 rounding interval of a float32 sum of its "
            "576 exact products; fewer than 0.1% more than one bf16 ulp apart"),
        "frac_equal": float((diff == 0).float().mean()), "frac_beyond_one_ulp": frac_beyond,
        "largest_value_beyond_one_ulp": worst, "rel_err_vs_cudnn": rel_cudnn,
        "float32": f32, "launch": launch_bf16,
        # ms: calls issued from Python one by one, as every kernel's ms;
        # graph_ms: the same calls replayed from a CUDA graph, without the
        # host's time per call (checks, ctypes, tensor-map encoding)
        "ms": time_ms(lambda: cv.conv3x3(x, w)),
        "graph_ms": graph_ms(lambda: cv.conv3x3(x, w)),
        "plain_ms": time_ms(lambda: cv.conv3x3_plain(x, w), iters=5, warmup=1),
        "library_ms": time_ms(lambda: conv_probe.cudnn_conv3x3(x, w)),
        "library_graph_ms": graph_ms(lambda: conv_probe.cudnn_conv3x3(x, w)),
        "library_call": "F.conv2d, channels_last bf16 (cuDNN)",
        "bound_ms": bound, "bound_by": bound_by, "bytes_ms": bytes_ms, "flops_ms": flops_ms,
    }
    del p, lo, hi, diff, ulp, beyond
    # the wrapper's host time per call where the device's is negligible: a
    # one-pixel image, host clock around 200 calls issued back to back
    x1 = x[:1, :1, :1].contiguous()
    cv.conv3x3(x1, w)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        cv.conv3x3(x1, w)
    res["wrapper_host_ms"] = (time.perf_counter() - t0) / 200 * 1e3
    torch.cuda.synchronize()
    log(f"[conv] {json.dumps({'kernel': 'conv3x3', 'shape': list(x.shape), **res})}")

    # the probe's entry point: its launches are the conv's main path
    cv.reset_launches()
    probe = conv_probe.run()
    torch.cuda.synchronize()
    res["launches"] = cv.launch_counts()["conv3x3"]
    res["probe"] = probe
    log(f"[conv] probe (in process): {json.dumps(probe)}; launches {res['launches']}")
    if res["launches"] < 1:
        raise AssertionError("the conv probe launched no conv3x3 kernel")

    proc = subprocess.run([sys.executable, "-m", f"{PKG}.benchmarks.conv_probe"], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"conv probe exit {proc.returncode}:\n{proc.stderr[-4000:]}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    if line["device"] != torch.cuda.get_device_name(0) or not line["rel_err_vs_cudnn"] < 3e-2:
        raise AssertionError(f"conv probe printed {line}")
    res["probe_subprocess"] = line
    log(f"[conv] probe (subprocess): {json.dumps(line)}")
    return res


def phase_classify() -> dict:
    import torch

    from image_recognition_adversarial_example_attack_tpu_torch.attacks import make_logits_fn
    from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed
    from image_recognition_adversarial_example_attack_tpu_torch.models import load_model

    dev, batch = torch.device("cuda"), SHAPE[0]
    # float32 on the card (TF32 off) against the CPU, same seeded weights;
    # the same logits with TF32 allowed show that the limit would catch a leak
    ref = {}
    x_small = torch.rand((2, 224, 224, 3), generator=generator_from_seed(5))
    for d in ("cpu", "cuda"):
        b = load_model("resnet50", dtype=torch.float32, device=d)
        lf = make_logits_fn(b.model, b.mean, b.std)
        with torch.no_grad():
            ref[d] = lf(x_small.to(b.device)).cpu()
            if d == "cuda":
                torch.backends.cudnn.allow_tf32 = True
                torch.backends.cuda.matmul.allow_tf32 = True
                try:
                    ref["tf32"] = lf(x_small.to(b.device)).cpu()
                finally:
                    torch.backends.cudnn.allow_tf32 = False
                    torch.backends.cuda.matmul.allow_tf32 = False
        del b
    scale = float(ref["cpu"].abs().max())
    f32_err = float((ref["cuda"] - ref["cpu"]).abs().max()) / scale
    tf32_err = float((ref["tf32"] - ref["cpu"]).abs().max()) / scale
    if not f32_err <= F32_REL_TOL < tf32_err:
        raise AssertionError(f"float32 logits on the card vs the CPU: {f32_err:.3e} "
                             f"relative, with TF32 {tf32_err:.3e}; the limit "
                             f"{F32_REL_TOL:.0e} must lie between them")
    log(f"[classify] float32 card vs CPU, 2 images: max|diff| {f32_err:.3e} of "
        f"max |logit| {scale:.3e} (limit {F32_REL_TOL:.0e}); with TF32 allowed "
        f"{tf32_err:.3e}")

    bundle = load_model("resnet50", dtype=torch.bfloat16, device=dev)
    lf = make_logits_fn(bundle.model, bundle.mean, bundle.std, input_dtype=torch.bfloat16)
    x = torch.rand((batch, 224, 224, 3), generator=generator_from_seed(6, dev), device=dev)
    with torch.no_grad():
        logits = lf(x)
        ms = time_ms(lambda: lf(x), iters=5, warmup=1)
    if logits.shape != (batch, 1000) or logits.dtype != torch.float32:
        raise AssertionError(f"logits {tuple(logits.shape)} {logits.dtype}")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("non-finite logits")
    y = logits.argmax(-1)
    with torch.no_grad():
        small = lf(x_small.to(dev)).cpu()
    bf16_vs_f32 = float((small - ref["cuda"]).abs().max())
    log(f"[classify] bf16 vs float32 logits, same 2 images: max|diff| {bf16_vs_f32:.3e}, "
        f"top-1 {'agrees' if torch.equal(small.argmax(-1), ref['cuda'].argmax(-1)) else 'differs'}")
    log(f"[classify] resnet50 bf16 batch {batch}: logits {tuple(logits.shape)} finite, "
        f"{len(set(y.tolist()))} distinct top-1 classes, forward {ms:.2f} ms "
        f"({batch / ms * 1e3:.1f} img/s)")
    return {"bundle": bundle, "x": x, "y": y, "forward_ms": ms,
            "f32_card_vs_cpu_rel": f32_err, "tf32_card_vs_cpu_rel": tf32_err,
            "bf16_vs_f32": bf16_vs_f32}


def _check_ball(x_adv, x, eps: float, where: str) -> float:
    linf = float((x_adv - x).abs().max())
    if not linf <= eps + 1e-6:
        raise AssertionError(f"{where}: |x_adv - x|_inf = {linf} > eps {eps}")
    if not (float(x_adv.min()) >= 0.0 and float(x_adv.max()) <= 1.0):
        raise AssertionError(f"{where}: x_adv leaves [0,1]")
    return linf


# kernel-name fragments -> the layer of a PGD step each kernel belongs to;
# the first match wins (a BatchNorm kernel may say "transform", a cuDNN
# conv "implicit_gemm")
_LAYERS = (
    ("port kernels", ("pgd_step_kernel", "quantize_kernel", "uniform_noise_kernel")),
    ("batchnorm", ("batch_norm", "bn_")),
    ("conv input-gradient", ("dgrad",)),
    ("conv forward", ("fprop", "implicit_gemm", "xmma", "conv")),
    ("cuBLAS GEMMs", ("nvjet", "gemm", "cublas", "cutlass")),
    ("copies and layout transforms", ("copy", "memset", "memcpy", "transform", "padding")),
)

def profile_breakdown(fn) -> dict:
    """Device time of one call of ``fn`` by layer, from torch.profiler's
    kernel events, and the share of the wall time the card was busy."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_layer: dict[str, float] = {}
    by_kernel: dict[str, list] = {}
    spans = []
    for e in events:
        us = e.time_range.elapsed_us()
        spans.append((e.time_range.start, e.time_range.end))
        name = e.name.lower()
        layer = next((lay for lay, keys in _LAYERS if any(k in name for k in keys)),
                     "other elementwise")
        by_layer[layer] = by_layer.get(layer, 0.0) + us / 1e3
        k = by_kernel.setdefault(e.name, [0, 0.0])
        k[0] += 1
        k[1] += us / 1e3
    busy_us, end = 0.0, float("-inf")
    for start, stop in sorted(spans):  # union of the kernel intervals
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:30]
    return {"wall_ms": wall_us / 1e3, "busy_ms": busy_us / 1e3,
            "busy_share": busy_us / wall_us, "kernels": len(events),
            "by_layer_ms": dict(sorted(by_layer.items(), key=lambda kv: -kv[1])),
            "top_kernels": [{"name": n[:400], "count": c, "ms": ms} for n, (c, ms) in top]}


def phase_pgd(state: dict) -> dict:
    import torch

    from image_recognition_adversarial_example_attack_tpu_torch.attacks import (
        AttackParams, make_logits_fn, run_attack)
    from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed
    from image_recognition_adversarial_example_attack_tpu_torch.kernels import elementwise as ew

    b, x, y = state["bundle"], state["x"], state["y"]
    lf = make_logits_fn(b.model, b.mean, b.std, input_dtype=torch.bfloat16)
    params = AttackParams(eps=EPS, alpha=ALPHA, steps=STEPS, random_start=True)

    torch.cuda.reset_peak_memory_stats()
    ew.reset_launches()
    x_adv = run_attack("pgd", lf, x, y, params, generator_from_seed(0))
    torch.cuda.synchronize()
    counts = ew.launch_counts()
    want = {"pgd_step": STEPS, "quantize": 0, "uniform_noise": 1}
    if counts != want:
        raise AssertionError(f"PGD-10 launches {counts}, want {want}")
    linf = _check_ball(x_adv, x, EPS, "pgd")
    with torch.no_grad():
        success = float((lf(x_adv).argmax(-1) != y).float().mean())

    runs = 3
    t0 = time.perf_counter()
    for i in range(runs):
        run_attack("pgd", lf, x, y, params, generator_from_seed(10 + i))
    torch.cuda.synchronize()
    seconds = (time.perf_counter() - t0) / runs
    ex_s = x.shape[0] / seconds
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"[pgd] launches {counts}; |x_adv - x|_inf {linf:.6f} <= eps {EPS:.6f}; "
        f"attack success {success:.3f}")
    log(f"[pgd] PGD-10 resnet50@224 batch {x.shape[0]} bf16: {seconds * 1e3:.1f} ms "
        f"per attack, {ex_s:.1f} ex/s (mean of {runs} after a warm-up); "
        f"peak memory {peak_gib:.2f} GiB")
    prof = profile_breakdown(
        lambda: run_attack("pgd", lf, x, y, params, generator_from_seed(20)))
    log(f"[pgd] profile of one attack: wall {prof['wall_ms']:.1f} ms, card busy "
        f"{prof['busy_ms']:.1f} ms ({prof['busy_share']:.3f}), {prof['kernels']} kernels; "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in prof["by_layer_ms"].items()))
    for k in prof["top_kernels"][:10]:
        log(f"[pgd]   {k['ms']:8.2f} ms  x{k['count']:<4d} {k['name'][:220]}")
    return {"launches": counts, "linf": linf, "attack_success": success,
            "seconds_per_attack": seconds, "ex_per_s": ex_s, "peak_gib": peak_gib,
            "profile": prof}


def phase_cell(state: dict) -> dict:
    import torch

    from image_recognition_adversarial_example_attack_tpu_torch.cli.common import make_fns
    from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed
    from image_recognition_adversarial_example_attack_tpu_torch.defenses import (
        calibrate_feature_threshold)
    from image_recognition_adversarial_example_attack_tpu_torch.eval.defense_eval import (
        DefenseEvalConfig, aggregate_stats, evaluate_defenses_batch, summary_line)
    from image_recognition_adversarial_example_attack_tpu_torch.kernels import elementwise as ew

    b, x, y = state["bundle"], state["x"], state["y"]
    lf, ff = make_fns(b)
    thr = calibrate_feature_threshold(ff, x, n=x.shape[0])
    cfg = DefenseEvalConfig(attack_name="pgd", eps=EPS, alpha=ALPHA, steps=STEPS)

    ew.reset_launches()
    t0 = time.perf_counter()
    out = evaluate_defenses_batch(lf, ff, x, y, thr, cfg, generator_from_seed(1))
    stats = aggregate_stats(out)
    seconds = time.perf_counter() - t0
    counts = ew.launch_counts()
    if counts["quantize"] < 1 or counts["pgd_step"] != STEPS or counts["uniform_noise"] != 1:
        raise AssertionError(f"defense cell launches {counts}")
    _check_ball(out["x_adv"], x, EPS, "cell")
    if stats["count"] != x.shape[0] or any(
            not 0 <= stats[k] <= stats["count"] for k in stats):
        raise AssertionError(f"counters out of range: {stats}")
    line = summary_line("pgd", EPS, stats)
    log(f"[cell] launches {counts}; threshold {thr:.4f}; {seconds:.2f} s")
    log(line)
    return {"launches": counts, "threshold": thr, "stats": stats,
            "summary_line": line, "seconds": seconds}


def phase_cw(state: dict) -> dict:
    """CW-L2 through the function ``run_attack("cw", ...)`` dispatches to,
    which also returns the per-sample success the check needs."""
    import torch

    from image_recognition_adversarial_example_attack_tpu_torch.attacks import (
        AttackParams, cw_l2_attack, make_logits_fn)

    b, x, y = state["bundle"], state["x"], state["y"]
    lf = make_logits_fn(b.model, b.mean, b.std, input_dtype=torch.bfloat16)
    p = AttackParams(cw_steps=CW_STEPS, cw_c=CW_C)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = cw_l2_attack(lf, x, y, c=p.cw_c, kappa=p.cw_kappa, steps=p.cw_steps, lr=p.cw_lr)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    x_adv, success = res.x_adv, res.success
    if not (float(x_adv.min()) >= 0.0 and float(x_adv.max()) <= 1.0):
        raise AssertionError("cw: x_adv leaves [0,1]")
    with torch.no_grad():
        pred = lf(x_adv).argmax(-1)
    fooled = pred != y
    if not bool(success.any()):
        raise AssertionError("cw: no sample succeeded; the check below would be empty")
    if not bool(fooled[success].all()):
        raise AssertionError(f"cw: {int((success & ~fooled).sum())} samples marked "
                             f"successful are classified correctly at the returned image")
    l2 = (x_adv - x).reshape(x.shape[0], -1).norm(dim=-1)
    n_succ = int(success.sum())
    mean_l2 = float(l2[success].mean()) if n_succ else float("nan")
    log(f"[cw] CW-L2 {CW_STEPS} steps c={CW_C} resnet50@224 batch {x.shape[0]} bf16: "
        f"{seconds * 1e3:.1f} ms per attack, {x.shape[0] / seconds:.2f} ex/s; "
        f"success {n_succ}/{x.shape[0]}, all misclassified at the returned image; "
        f"mean L2 of the successful {mean_l2:.4f}")
    return {"seconds_per_attack": seconds, "ex_per_s": x.shape[0] / seconds,
            "success": n_succ, "mean_l2_success": mean_l2}


def phase_cells(state: dict) -> dict:
    """pgd cells with the JPEG arm (DCT codec, host codec) and the TV arm."""
    import torch

    from image_recognition_adversarial_example_attack_tpu_torch.cli.common import make_fns
    from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed
    from image_recognition_adversarial_example_attack_tpu_torch.defenses import DefenseConfig
    from image_recognition_adversarial_example_attack_tpu_torch.eval.defense_eval import (
        DefenseEvalConfig, aggregate_stats, evaluate_defenses_batch, summary_line)
    from image_recognition_adversarial_example_attack_tpu_torch.kernels import elementwise as ew

    b, x, y = state["bundle"], state["x"], state["y"]
    lf, ff = make_fns(b)
    thr = state["threshold"]
    arms = {"jpeg_dct": DefenseConfig(use_jpeg=True, jpeg_mode="dct"),
            "jpeg_host": DefenseConfig(use_jpeg=True, jpeg_mode="host"),
            "tv": DefenseConfig(use_tv=True)}
    out = {}
    for name, defense in arms.items():
        cfg = DefenseEvalConfig(attack_name="pgd", eps=EPS, alpha=ALPHA, steps=STEPS,
                                defense=defense)
        ew.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = evaluate_defenses_batch(lf, ff, x, y, thr, cfg, generator_from_seed(2))
        stats = aggregate_stats(res)
        seconds = time.perf_counter() - t0
        counts = ew.launch_counts()
        if counts != {"pgd_step": STEPS, "quantize": 1, "uniform_noise": 1}:
            raise AssertionError(f"{name} cell launches {counts}")
        _check_ball(res["x_adv"], x, EPS, name)
        if stats["count"] != x.shape[0] or any(
                not 0 <= stats[k] <= stats["count"] for k in stats):
            raise AssertionError(f"{name}: counters out of range: {stats}")
        line = summary_line("pgd", EPS, stats)
        log(f"[cells] {name}: launches {counts}; {seconds:.3f} s")
        log(f"[cells] {name}: {line}")
        out[name] = {"launches": counts, "stats": stats, "summary_line": line,
                     "seconds": seconds}
    return out


def _check_cell(name: str, out: dict, x, stats: dict, counts: dict, want: dict) -> None:
    if counts != want:
        raise AssertionError(f"{name}: launches {counts}, want {want}")
    _check_ball(out["x_adv"], x, EPS, name)
    if stats["count"] != x.shape[0] or any(
            not 0 <= stats[k] <= stats["count"] for k in stats):
        raise AssertionError(f"{name}: counters out of range: {stats}")


def phase_detectors(state: dict) -> dict:
    """pgd cells under --adaptive, --detector_aware, and with the squeezing
    and Mahalanobis detectors, each with its launches counted."""
    import torch

    from image_recognition_adversarial_example_attack_tpu_torch.cli.common import make_fns
    from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed
    from image_recognition_adversarial_example_attack_tpu_torch.defenses import (
        calibrate_mahalanobis, calibrate_squeezing_threshold, feature_score, fit_mahalanobis,
        mahalanobis_score_from_features, pool_features)
    from image_recognition_adversarial_example_attack_tpu_torch.eval.defense_eval import (
        DefenseEvalConfig, aggregate_stats, evaluate_defenses_batch, summary_line)
    from image_recognition_adversarial_example_attack_tpu_torch.kernels import elementwise as ew

    b, x, y = state["bundle"], state["x"], state["y"]
    lf, ff = make_fns(b)
    res: dict = {}

    t0 = time.perf_counter()
    sq_thr = calibrate_squeezing_threshold(lf, x, n=x.shape[0])
    res["squeezing_threshold"] = sq_thr
    res["squeezing_calibration_s"] = time.perf_counter() - t0

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, mh_thr = calibrate_mahalanobis(ff, x, y, 1000, n=x.shape[0])
    torch.cuda.synchronize()
    res["mahalanobis_calibration_s"] = time.perf_counter() - t0
    if tuple(params.mean.shape) != (1000, 1024) or tuple(params.precision.shape) != (1024, 1024):
        raise AssertionError(f"mahalanobis params {params.mean.shape} {params.precision.shape}")
    finite = bool(torch.isfinite(params.mean).all() and torch.isfinite(params.precision).all())
    if not finite or not mh_thr == mh_thr:
        raise AssertionError("mahalanobis: non-finite params or threshold")
    with torch.no_grad():
        z = pool_features(ff(x))
    fit = res["mahalanobis_fit"] = {
        "threshold": mh_thr, "params_finite": finite,
        "fit_ms": time_ms(lambda: fit_mahalanobis(z, y, 1000), iters=3, warmup=1),
        "score_ms": time_ms(lambda: mahalanobis_score_from_features(z, params),
                            iters=5, warmup=1),
    }
    log(f"[detectors] mahalanobis fit on {x.shape[0]} clean images (K=1000, C=1024): "
        f"{fit['fit_ms']:.2f} ms, score of {x.shape[0]} images "
        f"{fit['score_ms']:.2f} ms, params finite {finite}, threshold "
        f"{mh_thr:.4f}; calibration (features + fit + scores) "
        f"{res['mahalanobis_calibration_s']:.3f} s")
    log(f"[detectors] squeezing threshold {sq_thr:.6f} "
        f"({res['squeezing_calibration_s']:.3f} s, 1 quantize launch)")

    base = {"attack_name": "pgd", "eps": EPS, "alpha": ALPHA, "steps": STEPS}
    cells = {
        "adaptive": (DefenseEvalConfig(**base, adaptive=True), state["threshold"],
                     {"pgd_step": STEPS, "quantize": STEPS + 1, "uniform_noise": 1}),
        "detector_aware": (DefenseEvalConfig(**base, detector_aware=True, detector_lam=1.0,
                                             detector_margin=0.9), state["threshold"],
                           {"pgd_step": STEPS, "quantize": 1, "uniform_noise": 1}),
        "squeezing": (DefenseEvalConfig(**base, detector="squeezing"), sq_thr,
                      {"pgd_step": STEPS, "quantize": 3, "uniform_noise": 1}),
        "mahalanobis": (DefenseEvalConfig(**base, detector="mahalanobis",
                                          detector_params=params), mh_thr,
                        {"pgd_step": STEPS, "quantize": 1, "uniform_noise": 1}),
    }
    x_adv = {}
    for name, (cfg, thr, want) in cells.items():
        ew.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = evaluate_defenses_batch(lf, ff, x, y, thr, cfg, generator_from_seed(1))
        stats = aggregate_stats(out)
        seconds = time.perf_counter() - t0
        counts = ew.launch_counts()
        _check_cell(name, out, x, stats, counts, want)
        x_adv[name] = out["x_adv"]
        line = summary_line("pgd", EPS, stats)
        log(f"[detectors] {name}: launches {counts}; {seconds:.3f} s")
        log(f"[detectors] {name}: {line}")
        res[name] = {"launches": counts, "stats": stats, "summary_line": line,
                     "seconds": seconds, "threshold": thr}
    # the oblivious cells (c, d) ran plain PGD from the same generator
    with torch.no_grad():
        aware = float(feature_score(ff, x_adv["detector_aware"]).mean())
        oblivious = float(feature_score(ff, x_adv["squeezing"]).mean())
    res["detector_aware"]["mean_feature_score"] = aware
    res["detector_aware"]["oblivious_mean_feature_score"] = oblivious
    log(f"[detectors] mean feature score of x_adv: detector-aware {aware:.4f}, oblivious "
        f"{oblivious:.4f} (threshold {state['threshold']:.4f}, margin 0.9)")
    return res


SUMMARY_RE = (r"^attack=(fgsm|pgd|cw), eps=(\d\.\d{5}), attack_success=\d\.\d{3}, "
              r"preproc_defense_acc=\d\.\d{3}, detector_clean_pass_rate=\d\.\d{3}, "
              r"detector_adv_flag_rate=\d\.\d{3}, detector_attack_success=\d\.\d{3}$")


def _run_experiments(image_dir: Path, out_dir: Path, *args: str) -> tuple[str, float]:
    import re

    cmd = [sys.executable, "-m", f"{PKG}.cli.defense_experiments", "--image_dir",
           str(image_dir), "--output_dir", str(out_dir), *args]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"defense_experiments {' '.join(args)} exit {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-4000:]}")
    if "Using device: cuda" not in proc.stdout:
        raise AssertionError("defense_experiments did not run on the card")
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("attack=")]
    if not lines or not all(re.match(SUMMARY_RE, ln) for ln in lines):
        raise AssertionError(f"defense_experiments summary lines malformed: {lines}")
    return proc.stdout, seconds


def _write_pngs(image_dir: Path, n: int, seed: int = 0) -> list[Path]:
    """``n`` random 256x300 PNGs (a 224 crop after the resize)."""
    import numpy as np
    from PIL import Image

    image_dir.mkdir(parents=True)
    rng = np.random.RandomState(seed)
    paths = [image_dir / f"img_{i:03d}.png" for i in range(n)]
    for p in paths:
        Image.fromarray((rng.rand(256, 300, 3) * 255).astype(np.uint8)).save(p)
    return paths


def phase_experiments() -> dict:
    res: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        image_dir = Path(tmp) / "images"
        _write_pngs(image_dir, SHAPE[0])
        grid_dir = Path(tmp) / "grid"
        grid = ["--cw_steps", str(CW_STEPS)]

        out, seconds = _run_experiments(image_dir, grid_dir, *grid)
        lines = [ln for ln in out.splitlines() if ln.startswith("attack=")]
        if len(lines) != 9:
            raise AssertionError(f"default grid printed {len(lines)} summary lines")
        reused = out.count("(cw is eps-independent: reusing the computed cell)")
        if reused != 2:
            raise AssertionError(f"cw reused {reused} times, want 2")
        partial = json.loads((grid_dir / "results_partial.json").read_text())
        if len(partial) != 9 or any(c["count"] != SHAPE[0] for c in partial.values()):
            raise AssertionError(f"results_partial.json holds {sorted(partial)}")
        for name in ("defense_results_attack_trend.png", "defense_results_defense_matrix.png",
                     "attack_samples.png", "timings.json"):
            if not (grid_dir / name).is_file():
                raise AssertionError(f"the default grid wrote no {name}")
        timings = json.loads((grid_dir / "timings.json").read_text())
        cells = {k: v["seconds"] for k, v in timings.items()}
        res["grid"] = {"wall_s": seconds, "cell_s": cells, "cells_s_total": sum(cells.values()),
                       "summary": lines}
        log(f"[experiments] default grid, {SHAPE[0]} images, cw_steps {CW_STEPS}: exit 0 in "
            f"{seconds:.1f} s; cells {sum(cells.values()):.2f} s: "
            + ", ".join(f"{k} {v:.3f}" for k, v in cells.items()))
        for ln in lines:
            log(f"[experiments] {ln}")

        out, seconds = _run_experiments(image_dir, grid_dir, *grid, "--resume")
        resumed = out.count("(resumed from partial results)")
        if resumed != 9:
            raise AssertionError(f"--resume resumed {resumed} cells, want 9")
        res["resume"] = {"wall_s": seconds, "resumed": resumed}
        log(f"[experiments] --resume: {resumed} cells resumed, exit 0 in {seconds:.1f} s")

        runs = {
            "adaptive_mahalanobis": ["--attacks", "pgd", "--eps_list", "0.03137", "--adaptive",
                                     "--detector", "mahalanobis", "--viz_samples", "0"],
            "aware_squeezing": ["--attacks", "fgsm", "pgd", "--eps_list", "0.03137",
                                "--detector_aware", "--detector", "squeezing",
                                "--viz_samples", "0"],
        }
        for name, args in runs.items():
            out_dir = Path(tmp) / name
            out, seconds = _run_experiments(image_dir, out_dir, *args)
            lines = [ln for ln in out.splitlines() if ln.startswith("attack=")]
            timings = json.loads((out_dir / "timings.json").read_text())
            if len(lines) != len(args[args.index("--attacks") + 1:args.index("--eps_list")]):
                raise AssertionError(f"{name}: {len(lines)} summary lines")
            res[name] = {"wall_s": seconds, "summary": lines,
                         "cell_s": {k: v["seconds"] for k, v in timings.items()}}
            log(f"[experiments] {' '.join(args)}: exit 0 in {seconds:.1f} s; cells "
                + ", ".join(f"{k} {v['seconds']:.3f} s" for k, v in timings.items()))
            for ln in lines:
                log(f"[experiments] {ln}")
    return res


def _run_cli(img: Path, adv: Path, *attack_args: str):
    cmd = [sys.executable, "-m", f"{PKG}.cli.classify", str(img), *attack_args,
           "--save_adv", str(adv)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"classify CLI exit {proc.returncode}:\n{proc.stderr[-4000:]}")
    title = f"Adversarial ({attack_args[1]}):"
    for want in ("Clean:", title, "Top 5: "):
        if want not in proc.stdout:
            raise AssertionError(f"classify CLI printed no '{want}':\n{proc.stdout}")
    if not adv.is_file():
        raise AssertionError(f"classify CLI saved no {adv.name}")
    return proc, seconds


def phase_cli() -> dict:
    import numpy as np
    from PIL import Image

    from image_recognition_adversarial_example_attack_tpu_torch.core.images import load_image

    with tempfile.TemporaryDirectory() as tmp:
        img = Path(tmp) / "input.png"
        adv = Path(tmp) / "adv.png"
        rng = np.random.RandomState(0)
        Image.fromarray((rng.rand(256, 300, 3) * 255).astype(np.uint8)).save(img)
        proc, seconds = _run_cli(img, adv, "--attack", "pgd")
        saved = np.asarray(Image.open(adv), np.float32) / 255.0
        linf = float(np.abs(saved - load_image(img)[0]).max())
        if not linf <= EPS + 0.5 / 255 + 1e-6:
            raise AssertionError(f"saved adversarial image is {linf} from the clean one")
        log(f"[cli] classify --attack pgd --save_adv: exit 0 in {seconds:.1f} s; "
            f"saved image within {linf:.5f} of the clean one (eps + 0.5/255 allowed)")
        log("[cli] " + " | ".join(proc.stdout.strip().splitlines()[:4]))
        adv_cw = Path(tmp) / "adv_cw.png"
        proc_cw, seconds_cw = _run_cli(img, adv_cw, "--attack", "cw",
                                       "--cw_steps", str(CW_STEPS))
        saved = np.asarray(Image.open(adv_cw), np.float32) / 255.0
        l2_cw = float(np.linalg.norm(saved - load_image(img)[0]))
        log(f"[cli] classify --attack cw --cw_steps {CW_STEPS} --save_adv: exit 0 in "
            f"{seconds_cw:.1f} s; saved image at L2 {l2_cw:.4f} from the clean one")
        log("[cli] " + " | ".join(proc_cw.stdout.strip().splitlines()[7:10]))
    return {"seconds": seconds, "linf_png": linf, "cw_seconds": seconds_cw, "cw_l2_png": l2_cw}


def _cells_s(out_dir: Path) -> dict[str, float]:
    timings = json.loads((out_dir / "timings.json").read_text())
    return {k: v["seconds"] for k, v in timings.items()}


def phase_stream(state: dict, resident_cell_s: dict) -> dict:
    """The grid streamed past --max_batch: the CLI, float32 streamed against
    resident, the uint8 placer, and streamed cells in this process."""
    import numpy as np
    import torch

    from image_recognition_adversarial_example_attack_tpu_torch.cli.common import make_fns
    from image_recognition_adversarial_example_attack_tpu_torch.core.images import (
        load_image_batch_tolerant)
    from image_recognition_adversarial_example_attack_tpu_torch.eval.defense_eval import (
        STAT_KEYS, DefenseEvalConfig)
    from image_recognition_adversarial_example_attack_tpu_torch.eval.streaming import (
        make_placer, stream_defense_cell)
    from image_recognition_adversarial_example_attack_tpu_torch.kernels import elementwise as ew

    torch.cuda.empty_cache()  # room for the subprocesses' batches
    res: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        paths = _write_pngs(Path(tmp) / "images", N_STREAM)
        res["png_write_s"] = time.perf_counter() - t0

        # (a) the CLI streams 600 images in chunks of 128
        out_dir = Path(tmp) / "a"
        out, seconds = _run_experiments(paths[0].parent, out_dir, "--attacks", "fgsm", "pgd",
                                        "--max_batch", str(STREAM_CHUNK))
        want_line = (f"Streaming evaluation: {N_STREAM} images in fixed chunks of "
                     f"{STREAM_CHUNK} (constant memory; decode overlaps the device step)")
        lines = [ln for ln in out.splitlines() if ln.startswith("attack=")]
        partial = json.loads((out_dir / "results_partial.json").read_text())
        if want_line not in out or len(lines) != 6 or len(partial) != 6 or any(
                c["count"] != N_STREAM for c in partial.values()):
            raise AssertionError(f"streamed grid: {len(lines)} summary lines, cells "
                                 f"{ {k: c['count'] for k, c in partial.items()} }\n{out[-3000:]}")
        cells = {}
        for cell_id, sec in _cells_s(out_dir).items():
            resident = resident_cell_s.get(cell_id)
            cells[cell_id] = {"seconds": sec, "img_s": N_STREAM / sec,
                              "resident_img_s": SHAPE[0] / resident if resident else None}
        res["cli"] = {"wall_s": seconds, "cells": cells, "summary": lines}
        log(f"[stream] CLI, {N_STREAM} PNGs in chunks of {STREAM_CHUNK}, fgsm + pgd x 3 eps: "
            f"exit 0 in {seconds:.1f} s")
        for cell_id, c in cells.items():
            resident = c["resident_img_s"]
            log(f"[stream]   {cell_id}: {c['seconds']:.3f} s, {c['img_s']:.1f} img/s streamed; "
                f"resident (phase 8, {SHAPE[0]} images) "
                + (f"{resident:.1f} img/s" if resident else "no such cell"))
        for ln in lines:
            log(f"[stream] {ln}")

        # (b) float32 fgsm on 300 images: streamed in 3 chunks against one
        # resident batch
        sub = Path(tmp) / "f32"
        sub.mkdir()
        for p in paths[:N_F32]:
            (sub / p.name).symlink_to(p)
        counters, f32 = {}, {}
        for max_batch in (str(STREAM_CHUNK), "0"):
            o_dir = Path(tmp) / f"f32_{max_batch}"
            _, seconds = _run_experiments(sub, o_dir, "--model-dtype", "float32", "--attacks",
                                          "fgsm", "--eps_list", "0.0313725490",
                                          "--viz_samples", "0", "--max_batch", max_batch)
            (cell,) = json.loads((o_dir / "results_partial.json").read_text()).values()
            counters[max_batch] = {k: cell[k] for k in (*STAT_KEYS, "count")}
            f32[max_batch] = {"wall_s": seconds, "cell_s": _cells_s(o_dir),
                              "counters": counters[max_batch]}
        diff = {k: counters[str(STREAM_CHUNK)][k] - counters["0"][k] for k in counters["0"]}
        res["float32"] = {"runs": f32, "difference": diff}
        log(f"[stream] float32 fgsm on {N_F32} PNGs: streamed {f32[str(STREAM_CHUNK)]['cell_s']} "
            f"s, resident {f32['0']['cell_s']} s; counters streamed "
            f"{counters[str(STREAM_CHUNK)]}, resident {counters['0']}")
        if any(diff.values()):
            log(f"[stream] float32 streamed - resident counters: {diff} (a top-1 tie that "
                "flips between the batch shapes' convolution algorithms)")
        if diff["count"] != 0 or any(abs(v) > 3 for v in diff.values()):
            raise AssertionError(f"float32 streamed and resident counters differ: {diff}")

        # (c) the uint8 placer on one chunk, decoded on one host thread as
        # the pipeline decodes it
        t0 = time.perf_counter()
        x_np, _ = load_image_batch_tolerant(paths[:STREAM_CHUNK])
        res["decode_chunk_s"] = time.perf_counter() - t0
        log(f"[stream] host decode of one chunk of {STREAM_CHUNK} PNGs: "
            f"{res['decode_chunk_s']:.3f} s ({STREAM_CHUNK / res['decode_chunk_s']:.1f} img/s)")
        got = make_placer("cuda", transfer_uint8=True)(x_np).cpu().numpy()
        host = np.round(x_np * 255).astype(np.uint8).astype(np.float32) / np.float32(255)
        if not (np.array_equal(got, host) and np.array_equal(got, x_np)):
            raise AssertionError("the uint8 placer differs from the host's quotient")
        res["uint8_placer"] = {"bit_equal_to_host": True, "equal_to_decoded_chunk": True}
        log(f"[stream] uint8 placer on [{STREAM_CHUNK},224,224,3]: bit-equal to the host's "
            "round(x*255)/float32(255), and to the decoded chunk")

        # in process: streamed cells on 300 images in chunks of 128
        b = state["bundle"]
        lf, ff = make_fns(b)

        def pseudo(xx):
            return torch.argmax(lf(xx), dim=-1)

        place = make_placer("cuda")

        def cell(attack: str) -> dict:
            cfg = DefenseEvalConfig(attack_name=attack, eps=EPS, alpha=ALPHA, steps=STEPS)
            return stream_defense_cell(lf, ff, cfg, paths[:N_F32], state["threshold"], seed=0,
                                       cell_id=f"{attack}:{EPS:.6f}", eps=EPS,
                                       chunk_size=STREAM_CHUNK, place=place,
                                       pseudo_label_fn=pseudo)

        chunks = -(-N_F32 // STREAM_CHUNK)
        ew.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = cell("pgd")
        seconds = time.perf_counter() - t0
        counts = ew.launch_counts()
        want = {"pgd_step": chunks * STEPS, "quantize": chunks, "uniform_noise": chunks}
        if counts != want:
            raise AssertionError(f"streamed pgd cell launches {counts}, want {want}")
        if stats["count"] != N_F32 or any(not 0 <= v <= N_F32 for v in stats.values()):
            raise AssertionError(f"streamed pgd cell counters out of range: {stats}")
        res["pgd_cell"] = {"launches": counts, "stats": stats, "seconds": seconds}
        log(f"[stream] in process, pgd on {N_F32} images in {chunks} chunks: launches {counts}; "
            f"{seconds:.3f} s ({N_F32 / seconds:.1f} img/s); {stats}")
        runs = []
        for _ in range(2):
            t0 = time.perf_counter()
            runs.append(cell("fgsm"))
            runs[-1]["seconds"] = time.perf_counter() - t0
        if {k: v for k, v in runs[0].items() if k != "seconds"} != {
                k: v for k, v in runs[1].items() if k != "seconds"}:
            raise AssertionError(f"the same fgsm cell streamed twice gave {runs}")
        res["fgsm_twice"] = runs
        log(f"[stream] in process, fgsm streamed twice: equal counters, "
            f"{runs[0]['seconds']:.3f} / {runs[1]['seconds']:.3f} s")
    return res


def phase_visualize(state: dict) -> dict:
    """The visualize CLI in a subprocess, then PGD-20 and its trajectory at
    batch 1 in this process, and the metrics on the card against float64."""
    import numpy as np
    import torch

    from image_recognition_adversarial_example_attack_tpu_torch.attacks import (
        AttackParams, run_attack)
    from image_recognition_adversarial_example_attack_tpu_torch.cli.common import make_fns
    from image_recognition_adversarial_example_attack_tpu_torch.core.images import load_image
    from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed
    from image_recognition_adversarial_example_attack_tpu_torch.eval.metrics import (
        attack_metrics, metrics_to_python)
    from image_recognition_adversarial_example_attack_tpu_torch.eval.trajectory import (
        pgd_trajectory)
    from image_recognition_adversarial_example_attack_tpu_torch.kernels import elementwise as ew

    res: dict = {}
    viz_steps = 20
    with tempfile.TemporaryDirectory() as tmp:
        (img,) = _write_pngs(Path(tmp) / "img", 1, seed=3)
        out_dir = Path(tmp) / "viz"
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", f"{PKG}.cli.visualize", "--image", str(img),
                               "--output_dir", str(out_dir)], cwd=REPO, capture_output=True,
                              text=True, timeout=600)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0 or "Using device: cuda" not in proc.stdout:
            raise AssertionError(f"visualize CLI exit {proc.returncode}:\n{proc.stdout[-3000:]}"
                                 f"\n{proc.stderr[-4000:]}")
        for name in ("attack_comparison.png", "attack_trajectory.png",
                     "perturbation_analysis.png", "attack_report.json"):
            if not (out_dir / name).is_file():
                raise AssertionError(f"the visualize CLI wrote no {name}")
        report = json.loads((out_dir / "attack_report.json").read_text())
        attacks = report["attacks"]
        layout_ok = (set(report) == REPORT_KEYS and set(report["clean_prediction"]) == CLEAN_KEYS
                     and set(report["params"]) == PARAM_KEYS
                     and list(attacks) == ["fgsm", "pgd", "cw"]
                     and all(set(a) == ATTACK_KEYS and list(a["metrics"]) == METRIC_KEYS
                             for a in attacks.values()))
        if not layout_ok:
            raise AssertionError(f"attack_report.json has another layout: {report}")
        eps = report["params"]["eps"]
        for name, a in attacks.items():
            m = a["metrics"]
            if name in ("fgsm", "pgd") and not m["L∞ (pixel)"] <= eps + 1e-6:
                raise AssertionError(f"visualize {name}: L-inf {m['L∞ (pixel)']} > eps {eps}")
            if not (0.0 <= m["SSIM"] <= 1.0 and np.isfinite(m["PSNR"])):
                raise AssertionError(f"visualize {name}: SSIM {m['SSIM']}, PSNR {m['PSNR']}")
        res["cli"] = {"wall_s": seconds, "report": report}
        log(f"[visualize] CLI at its defaults (PGD-{report['params']['steps']}, "
            f"CW-{report['params']['cw_steps']}): exit 0 in {seconds:.1f} s; "
            + "; ".join(f"{n} class {a['predicted_class']} "
                        f"({'success' if a['success'] else 'failed'}), "
                        f"L-inf {a['metrics']['L∞ (pixel)']:.5f}, SSIM {a['metrics']['SSIM']:.4f},"
                        f" PSNR {a['metrics']['PSNR']:.2f}" for n, a in attacks.items()))

        # in process: PGD-20 and its trajectory at batch 1
        lf, _ = make_fns(state["bundle"])
        x = torch.from_numpy(load_image(img)).to("cuda")
    with torch.no_grad():
        y = lf(x).argmax(-1)
    g = generator_from_seed(0)
    ew.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x_adv = run_attack("pgd", lf, x, y, AttackParams(eps=EPS, alpha=ALPHA, steps=viz_steps), g)
    traj = pgd_trajectory(lf, x, y, eps=EPS, alpha=ALPHA, steps=viz_steps, generator=g)
    probs, l2 = traj.probs.cpu(), traj.l2.cpu()
    seconds = time.perf_counter() - t0
    counts = ew.launch_counts()
    want = {"pgd_step": 2 * viz_steps, "quantize": 0, "uniform_noise": 2}
    if counts != want:
        raise AssertionError(f"PGD-{viz_steps} + trajectory launches {counts}, want {want}")
    if tuple(probs.shape) != (viz_steps + 1, 2) or tuple(l2.shape) != (viz_steps + 1,) or not (
            bool(torch.isfinite(probs).all()) and bool(torch.isfinite(l2).all())):
        raise AssertionError(f"trajectory {tuple(probs.shape)} {tuple(l2.shape)}")
    linf = _check_ball(x_adv, x, EPS, "visualize pgd")
    _check_ball(traj.x_adv, x, EPS, "trajectory")
    res["in_process"] = {"launches": counts, "seconds": seconds, "linf": linf,
                         "trajectory_rows": int(probs.shape[0]),
                         "l2_first_last": [float(l2[0]), float(l2[-1])]}
    log(f"[visualize] in process, PGD-{viz_steps} + trajectory at batch 1: launches {counts}; "
        f"{seconds:.3f} s; {probs.shape[0]} trajectory rows, L2 {float(l2[0]):.3f} -> "
        f"{float(l2[-1]):.3f}")

    # both kernels against their plain versions at the batch-1 shape
    shape = tuple(x.shape)
    gen = generator_from_seed(7, "cuda")
    xs, x0 = torch.rand(shape, generator=gen, device="cuda"), torch.rand(shape, generator=gen,
                                                                         device="cuda")
    grad = torch.randn(shape, generator=gen, device="cuda")
    grad.view(-1)[::7] = 0.0
    k, p = ew.pgd_step(xs, grad, x0, EPS, ALPHA), ew.pgd_step_plain(xs, grad, x0, EPS, ALPHA)
    noise = ew.uniform_noise(shape, EPS, generator_from_seed(8), "cuda").double()
    eps32 = float(np.float32(EPS))
    noise_ok = (float(noise.min()) >= -eps32 and float(noise.max()) <= eps32
                and abs(float(noise.mean())) < 1e-2 * EPS
                and abs(float(noise.var()) / (EPS ** 2 / 3) - 1) < 2e-2)
    if not torch.equal(k, p) or not noise_ok:
        raise AssertionError(f"batch-1 kernels: pgd_step equal {torch.equal(k, p)}, noise "
                             f"mean {float(noise.mean())} var {float(noise.var())}")
    numel = xs.numel()
    noise_gen = generator_from_seed(9)  # on the host, as the attacks' generators are
    res["batch1_kernels"] = {
        "pgd_step_max_abs_err": float((k - p).abs().max()),
        "noise_mean": float(noise.mean()), "noise_var": float(noise.var()),
        # calls issued one by one, as phase 2 times them (outside the counted run)
        "pgd_step_ms": time_ms(lambda: ew.pgd_step(xs, grad, x0, EPS, ALPHA)),
        "pgd_step_bound_ms": bound_ms("pgd_step", numel),
        "uniform_noise_ms": time_ms(lambda: ew.uniform_noise(shape, EPS, noise_gen, "cuda")),
        "uniform_noise_bound_ms": bound_ms("uniform_noise", numel)}
    b1 = res["batch1_kernels"]
    log(f"[visualize] kernels at {list(shape)}: pgd_step bit-exact, {b1['pgd_step_ms']:.4f} ms "
        f"(bound {b1['pgd_step_bound_ms']:.5f}); noise in range, mean {float(noise.mean()):.2e}, "
        f"var/(eps^2/3) {float(noise.var()) / (EPS ** 2 / 3):.4f}, {b1['uniform_noise_ms']:.4f} "
        f"ms (bound {b1['uniform_noise_bound_ms']:.5f})")

    # the metrics on the card against float64 on the CPU, the same pair
    card = metrics_to_python(attack_metrics(x, x_adv))
    cpu = metrics_to_python(attack_metrics(x.cpu().double(), x_adv.cpu().double()))
    ssim_err = abs(card["SSIM"] - cpu["SSIM"])
    norm_err = max(abs(card[k] - cpu[k]) / abs(cpu[k]) for k in METRIC_KEYS[:3])
    if not (ssim_err <= 1e-5 and norm_err <= 1e-5):
        raise AssertionError(f"metrics on the card vs float64: SSIM {ssim_err}, norms {norm_err}")
    res["metrics"] = {"card": card, "cpu_float64": cpu, "ssim_abs_err": ssim_err,
                      "norm_rel_err": norm_err}
    log(f"[visualize] attack_metrics on the card vs float64 CPU: SSIM {card['SSIM']:.6f} "
        f"(|diff| {ssim_err:.2e}), norms max rel diff {norm_err:.2e}, PSNR {card['PSNR']:.3f} "
        f"vs {cpu['PSNR']:.3f}")
    return res


def phase_weights(state: dict) -> dict:
    """The random ResNet-50 through a Flax msgpack file and back."""
    import torch

    from image_recognition_adversarial_example_attack_tpu_torch.attacks import make_logits_fn
    from image_recognition_adversarial_example_attack_tpu_torch.models import load_model
    from image_recognition_adversarial_example_attack_tpu_torch.models.convert import (
        to_jax_variables)
    from image_recognition_adversarial_example_attack_tpu_torch.models.flax_msgpack import (
        save_variables)

    x, res = state["x"], {}
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "resnet50.msgpack"
        ref32 = load_model("resnet50", dtype=torch.float32, device="cuda")
        t0 = time.perf_counter()
        save_variables(to_jax_variables(ref32.model), path)
        res["write_s"], res["bytes"] = time.perf_counter() - t0, path.stat().st_size
        for name, dtype, ref in (("bfloat16", torch.bfloat16, state["bundle"]),
                                 ("float32", torch.float32, ref32)):
            t0 = time.perf_counter()
            loaded = load_model("resnet50", dtype=dtype, weights=path, device="cuda")
            load_s = time.perf_counter() - t0
            if loaded.source != "cache":
                raise AssertionError(f"{path.name} loaded with source {loaded.source}")
            in_dtype = dtype if dtype != torch.float32 else None
            with torch.no_grad():
                want = make_logits_fn(ref.model, ref.mean, ref.std, input_dtype=in_dtype)(x)
                got = make_logits_fn(loaded.model, loaded.mean, loaded.std,
                                     input_dtype=in_dtype)(x)
            if not torch.equal(got, want):
                raise AssertionError(f"{name} logits through the msgpack file differ: "
                                     f"{float((got - want).abs().max())}")
            res[name] = {"load_s": load_s, "bit_equal": True}
            del loaded
        del ref32
    log(f"[weights] resnet50 written as msgpack ({res['bytes'] / 1e6:.1f} MB) in "
        f"{res['write_s']:.2f} s; loaded back with source 'cache' in "
        f"{res['bfloat16']['load_s']:.2f} s (bf16) and {res['float32']['load_s']:.2f} s "
        f"(float32); logits on the batch of {x.shape[0]} bit-equal in both dtypes")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=str, default=None,
                    help="also write every number of the run to this JSON file")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if not (REPO / PKG).is_dir():
        print(f"chip_smoke: the port's package {PKG}/ is not beside this script",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; {smi}")

    from image_recognition_adversarial_example_attack_tpu_torch.kernels import elementwise as ew

    record = {"card": smi, "torch": torch.__version__}
    record["build"] = phase_build()
    record["kernels"] = phase_kernels()
    record["conv"] = phase_conv()
    state = phase_classify()
    record["classify"] = {k: v for k, v in state.items() if k not in ("bundle", "x", "y")}
    record["pgd"] = phase_pgd(state)
    record["cell"] = phase_cell(state)
    state["threshold"] = record["cell"]["threshold"]
    record["cw"] = phase_cw(state)
    record["cells"] = phase_cells(state)
    record["cli"] = phase_cli()
    record["detectors"] = phase_detectors(state)
    record["experiments"] = phase_experiments()
    record["stream"] = phase_stream(state, record["experiments"]["grid"]["cell_s"])
    record["visualize"] = phase_visualize(state)
    record["weights"] = phase_weights(state)

    # the elementwise kernels' main path: PGD-10, the eight cells, the
    # streamed pgd cell and the visualize path's PGD-20 and trajectory; the
    # conv's: the probe's entry point
    detector_cells = ("adaptive", "detector_aware", "squeezing", "mahalanobis")
    runs = [record["pgd"], record["cell"], *record["cells"].values(),
            *(record["detectors"][c] for c in detector_cells),
            record["stream"]["pgd_cell"], record["visualize"]["in_process"]]
    main_path = {k: sum(r["launches"][k] for r in runs) for k in ew.LAUNCHES}
    kernels = []
    for name, (replaces, _) in KERNELS.items():
        r = record["kernels"][name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"{PKG}/csrc/elementwise.cu", "replaces": replaces,
            "launches": main_path[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": "bytes", "library_ms": r["library_ms"],
        })
    c = record["conv"]
    kernels.append({
        "name": "conv3x3", "route": "cuda", "source": f"{PKG}/csrc/conv3x3.cu",
        "replaces": f"{JAX_PROBE}:78", "launches": c["launches"],
        "max_abs_err": c["max_abs_err"], "ms": c["ms"], "plain_ms": c["plain_ms"],
        "bound_ms": c["bound_ms"], "bound_by": c["bound_by"], "library_ms": c["library_ms"],
    })
    for k in kernels:
        if k["launches"] < 1:
            raise AssertionError(f"kernel {k['name']} was not launched on the main path")
    record["kernels_line"] = kernels
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(record, indent=1, default=str))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
