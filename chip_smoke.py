#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port on one CUDA card, end to end.

    python3 chip_smoke.py [--out record.json]

Phases, in order; any failure is an uncaught exception and a non-zero exit:

1. build   -- nvcc builds the kernels of ``csrc/`` (sm_90a); prints seconds.
2. kernels -- each kernel against its plain PyTorch version at the main
   path's [128,224,224,3] float32: pgd_step and quantize bit-exact, the
   Philox noise held to its distribution; kernel, plain, bound and (where
   one exists) library times.
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
6. cli     -- the classify CLI in a subprocess on a PNG, ``--attack pgd
   --save_adv``; the saved image within eps of the clean one.

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
SHAPE = (128, 224, 224, 3)
EPS, ALPHA, STEPS, LEVELS = 8 / 255, 2 / 255, 10, 16
# float32 logits, card vs CPU, relative to the largest logit: above a sound
# float32 reading (~1e-6) and below what TF32 convolutions give (~1e-3)
F32_REL_TOL = 1e-5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
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


def bound_ms(name: str, numel: int) -> float:
    return KERNELS[name][1] * numel / HBM_BYTES_PER_S * 1e3


def phase_build() -> dict:
    from image_recognition_adversarial_example_attack_tpu_torch.kernels import build

    t0 = time.perf_counter()
    path, nvcc_log = build.build(build.CSRC_DIR / "elementwise.cu")
    build.load_library()
    seconds = time.perf_counter() - t0
    log(f"[build] {path.name} in {seconds:.2f} s")
    for line in nvcc_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] ptxas: {line.strip()}")
    return {"seconds": seconds, "library": str(path)}


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


def phase_cli() -> dict:
    import numpy as np
    from PIL import Image

    from image_recognition_adversarial_example_attack_tpu_torch.core.images import load_image

    with tempfile.TemporaryDirectory() as tmp:
        img = Path(tmp) / "input.png"
        adv = Path(tmp) / "adv.png"
        rng = np.random.RandomState(0)
        Image.fromarray((rng.rand(256, 300, 3) * 255).astype(np.uint8)).save(img)
        cmd = [sys.executable, "-m", f"{PKG}.cli.classify", str(img),
               "--attack", "pgd", "--save_adv", str(adv)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                              timeout=600)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"classify CLI exit {proc.returncode}:\n{proc.stderr[-4000:]}")
        for want in ("Clean:", "Adversarial (pgd):", "Top 5: "):
            if want not in proc.stdout:
                raise AssertionError(f"classify CLI printed no '{want}':\n{proc.stdout}")
        saved = np.asarray(Image.open(adv), np.float32) / 255.0
        linf = float(np.abs(saved - load_image(img)[0]).max())
        if not linf <= EPS + 0.5 / 255 + 1e-6:
            raise AssertionError(f"saved adversarial image is {linf} from the clean one")
    log(f"[cli] classify --attack pgd --save_adv: exit 0 in {seconds:.1f} s; "
        f"saved image within {linf:.5f} of the clean one (eps + 0.5/255 allowed)")
    log("[cli] " + " | ".join(proc.stdout.strip().splitlines()[:4]))
    return {"seconds": seconds, "linf_png": linf}


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
    state = phase_classify()
    record["classify"] = {k: v for k, v in state.items() if k not in ("bundle", "x", "y")}
    record["pgd"] = phase_pgd(state)
    record["cell"] = phase_cell(state)
    record["cli"] = phase_cli()

    main_path = {k: record["pgd"]["launches"][k] + record["cell"]["launches"][k]
                 for k in ew.LAUNCHES}
    kernels = []
    for name, (replaces, _) in KERNELS.items():
        r = record["kernels"][name]
        if main_path[name] < 1:
            raise AssertionError(f"kernel {name} was not launched on the main path")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"{PKG}/csrc/elementwise.cu", "replaces": replaces,
            "launches": main_path[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": "bytes", "library_ms": r["library_ms"],
        })
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
