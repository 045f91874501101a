"""The port's 3x3 conv (kernels/conv3x3.py, its plain version on the CPU) and
its probe against the JAX package's conv probe (benchmarks/pallas_conv_probe.py).

float32: the Pallas kernel in interpret mode and ``xla_conv3x3`` against the
plain version at the JAX test's own bar, 1e-4.  bfloat16: every sum rounds
to bf16 after a float32 accumulation in some order, so the versions agree
to within the bf16 rounding interval of that sum (``bf16_rounding_interval``)
and, but for a few elements whose products cancel, within one bf16 ulp; the
JAX probe's own two versions differ by one ulp in places, so bit equality
is not the bar.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import module_time_limit, one_thread, time_limit  # noqa: F401 (autouse)
from image_recognition_adversarial_example_attack_tpu_torch.kernels import conv3x3 as cv

REPO = Path(__file__).resolve().parent.parent
PKG = "image_recognition_adversarial_example_attack_tpu_torch"


@pytest.fixture(scope="module")
def probe():
    sys.path.insert(0, str(REPO / "benchmarks"))
    try:
        import pallas_conv_probe
    finally:
        sys.path.pop(0)
    return pallas_conv_probe


def _inputs(batch=2, h=56, w=56, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randn(batch, h, w, 64), rng.randn(3, 3, 64, 64) * 0.05


def test_plain_matches_jax_probe_float32(probe):
    x, w = (a.astype(np.float32) for a in _inputs())
    got = cv.conv3x3(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    assert got.dtype == np.float32 and got.shape == (2, 56, 56, 64)
    for want in (probe.pallas_conv3x3(jnp.asarray(x), jnp.asarray(w), interpret=True),
                 probe.xla_conv3x3(jnp.asarray(x), jnp.asarray(w))):
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("batch,h,w", [(2, 56, 56), (3, 7, 7)])
def test_plain_matches_jax_probe_bfloat16(probe, batch, h, w):
    x, wt = _inputs(batch, h, w, seed=batch)
    xb, wb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(wt, jnp.bfloat16)
    xt, wtt = torch.tensor(x, dtype=torch.bfloat16), torch.tensor(wt, dtype=torch.bfloat16)
    got = cv.conv3x3(xt, wtt)
    assert got.dtype == torch.bfloat16
    lo, hi = (v.float().numpy() for v in cv.bf16_rounding_interval(xt, wtt))
    got = got.float().numpy()
    ulp = cv.bf16_ulp(torch.from_numpy(got)).numpy()
    if (h, w) == (56, 56):  # the probe's kernel takes only its own 56x56
        wants = [probe.pallas_conv3x3(xb, wb, interpret=True), probe.xla_conv3x3(xb, wb)]
    else:
        wants = [probe.xla_conv3x3(xb, wb)]
    for want in wants:
        want = np.asarray(want.astype(jnp.float32))
        assert ((lo <= want) & (want <= hi)).all()
        assert ((lo <= got) & (got <= hi)).all()
        assert (np.abs(got - want) > ulp).mean() < 1e-4


def test_rounding_interval_is_one_or_two_values_away_from_cancellation():
    x, w = (torch.tensor(a, dtype=torch.bfloat16) for a in _inputs(1, 12, 12))
    lo, hi = cv.bf16_rounding_interval(x, w)
    s = cv._im2col_product(x, w, torch.float64)
    width = (hi.float() - lo.float()) / cv.bf16_ulp(s)
    big = s.abs() > 1.0
    assert bool(big.any()) and float(width[big].max()) <= 1.0
    rn = s.to(torch.bfloat16)  # the correctly rounded sum lies inside
    assert bool(((lo <= rn) & (rn <= hi)).all())
    assert torch.equal(cv.bf16_ulp(torch.tensor([1.0, 0.75, -5.4])),
                       torch.tensor([2.0 ** -7, 2.0 ** -8, 2.0 ** -5]))


def test_wrapper_refusals():
    x, w = (torch.tensor(a, dtype=torch.float32) for a in _inputs(1, 5, 5))
    cv.reset_launches()
    with pytest.raises(ValueError, match="NHWC"):
        cv.conv3x3(x[..., :32], w)
    with pytest.raises(ValueError, match="HWIO"):
        cv.conv3x3(x, w[:, :, :, :32])
    with pytest.raises(TypeError, match="bfloat16 or both float32"):
        cv.conv3x3(x, w.bfloat16())
    with pytest.raises(TypeError):
        cv.conv3x3(x.double(), w.double())
    with pytest.raises(ValueError, match="contiguous"):
        cv.conv3x3(x.transpose(1, 2), w)
    with pytest.raises(ValueError, match="contiguous"):
        cv.conv3x3(x, w.transpose(0, 1))
    # the plain version ran on the CPU: no kernel launch is counted
    assert cv.conv3x3(x, w).shape == x.shape
    assert cv.launch_counts() == {"conv3x3": 0}


def test_probe_on_cpu_prints_its_json_line():
    proc = subprocess.run(
        [sys.executable, "-m", f"{PKG}.benchmarks.conv_probe", "--device", "cpu",
         "--batch", "2", "--iters", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(out) == {"probe", "batch", "dtype", "device", "rel_err_vs_cudnn", "kernel_ms",
                        "cudnn_ms", "kernel_tflops", "cudnn_tflops", "kernel_pct_of_peak",
                        "cudnn_pct_of_peak", "speedup_vs_cudnn"}
    assert out["device"] == "cpu" and out["batch"] == 2 and out["dtype"] == "bfloat16"
    assert out["rel_err_vs_cudnn"] < 3e-2
    # no device was measured
    assert out["kernel_tflops"] is None and out["kernel_pct_of_peak"] is None


def test_probe_defaults_to_cuda_and_raises_without_it(monkeypatch):
    from image_recognition_adversarial_example_attack_tpu_torch.benchmarks import conv_probe

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        conv_probe.main(["--batch", "1", "--iters", "1"])


# the card tests' shapes, the widest each type's buffers fit (73 in bf16, 61
# in float32; the launcher refuses wider), and bands of one or two rows up to
# the widest a band holds, 254
PLAN_CASES = [(56, 56), (7, 7), (1, 1), (9, 17), (5, 56), (3, 73), (3, 61), (13, 30),
              (2, 3), (60, 5), (11, 84), (4, 100), (3, 126), (6, 127), (2, 150),
              (1, 200), (3, 254), (70, 40), (5, 74)]


@pytest.mark.parametrize("h,w", PLAN_CASES)
def test_tile_plan_gathers_the_plain_im2col(h, w):
    """What the kernel does with the plan, on numpy arrays: each band's halo
    is the TMA box of the zero-bordered image, rows y0-1 .. y0+R; position q
    of the band reads halo row q + dy*(W+2) + dx for tap (dy, dx).  Every
    real position's nine rows are the plain version's tap-major im2col row,
    every output pixel is one band's real position exactly once, no real
    position reads a row outside the box (the rows past it are NaN here), and
    no position of the band, junk included, reads past the buffer."""
    plan = cv.tile_plan(h, w)
    wp, r = w + 2, plan.rows
    assert r * wp <= cv.BAND and r + 2 <= 256 and wp <= 256  # a TMA box's extents
    assert plan.halo_rows == (r + 2) * wp <= plan.buf_rows
    assert cv.BAND - 1 + 2 * wp + 2 < plan.buf_rows and plan.buf_rows % 8 == 0
    assert plan.tiles_per_image * r >= h > (plan.tiles_per_image - 1) * r
    rng = np.random.RandomState(h * 1000 + w)
    b, c = 2, 3
    x = rng.randn(b, h, w, c)
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))  # the plain version's padding
    im2col = np.concatenate([xp[:, dy:dy + h, dx:dx + w] for dy in range(3)
                             for dx in range(3)], axis=-1)  # [B,H,W,9C]
    # the TMA box reads zeros past the last row too (the ragged last band)
    tall = np.pad(x, ((0, 0), (1, r * plan.tiles_per_image - h + 1), (1, 1), (0, 0)))
    q = np.arange(cv.BAND)
    rows_read = q[:, None] + np.array([dy * wp + dx for dy in range(3) for dx in range(3)])
    assert rows_read.max() < plan.buf_rows
    covered = np.zeros((b, h, w), np.int64)
    for bi in range(b):
        for band in range(plan.tiles_per_image):
            y0 = band * r
            buf = np.full((plan.buf_rows, c), np.nan)
            buf[:plan.halo_rows] = tall[bi, y0:y0 + r + 2].reshape(-1, c)
            gathered = buf[rows_read].reshape(cv.BAND, 9 * c)
            yy, xx = q // wp, q % wp
            real = (xx < w) & (yy < r) & (y0 + yy < h)
            assert (rows_read[real] < plan.halo_rows).all()
            np.testing.assert_array_equal(gathered[real],
                                          im2col[bi, y0 + yy[real], xx[real]])
            np.add.at(covered[bi], (y0 + yy[real], xx[real]), 1)
    assert (covered == 1).all()


@pytest.mark.parametrize("h,w", [(4, 255), (1, 1000), (0, 8), (4, 0)])
def test_tile_plan_refuses_what_does_not_fit(h, w):
    """No band holds a row of more than 256 padded positions, nor an empty image."""
    with pytest.raises(ValueError, match="does not take"):
        cv.tile_plan(h, w)


def test_every_source_has_its_signature_table():
    from image_recognition_adversarial_example_attack_tpu_torch.kernels import build

    assert sorted(p.stem for p in build.CSRC_DIR.glob("*.cu")) == sorted(build.SIGNATURES)
    assert build.SIGNATURES["elementwise"] is build.ELEMENTWISE_SIGNATURES
    for name, table in build.SIGNATURES.items():
        text = (build.CSRC_DIR / f"{name}.cu").read_text()
        for fn in table:
            assert f"int {fn}(" in text, fn  # every declared launcher exists
    conv = (build.CSRC_DIR / "conv3x3.cu").read_text()
    # Hopper's tensor cores (wgmma) fed by TMA on mbarriers for bf16, and no
    # library GEMM or conv inside the kernel
    for part in ("wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16",
                 "cp.async.bulk.tensor.4d", "mbarrier.try_wait.parity",
                 "cuTensorMapEncodeTiled"):
        assert part in conv, part
    assert "mma.sync" not in conv  # the earlier mma.sync kernel is replaced, not kept
    for lib in ("cublas", "cudnn", "cutlass/gemm"):
        assert lib not in conv.lower()
    # the launchers take the tile plan and an int[4] for the grid they chose
    for fn in ("conv3x3_bf16_launch", "conv3x3_f32_launch"):
        assert (f"int {fn}(const void* x, const void* w, void* out, int batch, int h,"
                in conv)
        assert len(build.CONV3X3_SIGNATURES[fn][1]) == 10
    # the code the wrapper turns into ValueError for a plan that does not fit
    assert f"constexpr int kPlanRefused = {cv._PLAN_REFUSED};" in conv


@pytest.mark.parametrize("fail", [None, "conv3x3"])
def test_build_all_runs_one_nvcc_per_source_at_once(tmp_path, monkeypatch, fail):
    """build_all starts every nvcc before it waits for any, and waits for all
    of them even when one fails; a failed build leaves no library behind."""
    from image_recognition_adversarial_example_attack_tpu_torch.kernels import build

    log = tmp_path / "log"
    fake = tmp_path / "nvcc"
    # each fake compiler notes its start, waits until every one has started,
    # then writes its output (or fails, for the source named in $FAIL)
    fake.write_text(
        "#!/bin/sh\n"
        f'echo start >> "{log}"\n'
        f'n=0; while [ "$(wc -l < "{log}")" -lt {len(build.SIGNATURES)} ]; do\n'
        '  n=$((n+1)); [ $n -gt 200 ] && exit 3; sleep 0.05; done\n'
        'src=""; out=""\n'
        'while [ $# -gt 0 ]; do if [ "$1" = "-o" ]; then shift; out="$1"; else src="$1"; fi; shift; done\n'
        'case "$src" in *"$FAIL"*) [ -n "$FAIL" ] && { echo boom >&2; exit 1; } ;; esac\n'
        'echo lib > "$out"\n')
    fake.chmod(0o755)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "find_nvcc", lambda: str(fake))
    monkeypatch.setenv("FAIL", fail or "")
    if fail:
        with pytest.raises(RuntimeError, match=f"nvcc failed on {fail}.cu"):
            build.build_all()
    else:
        built = build.build_all()
        assert sorted(built) == sorted(build.SIGNATURES)
        for name, (path, _) in built.items():
            assert path == build.library_path(build.CSRC_DIR / f"{name}.cu") and path.is_file()
        assert build.build_all()[name][1] == ""  # built once: found, not rebuilt
    assert log.read_text().count("start") == len(build.SIGNATURES)
    left = sorted(p.name for p in (tmp_path / "build").iterdir())
    assert not any(n.endswith(".tmp") for n in left)
    if fail:
        assert not any(n.startswith(f"lib{fail}_") for n in left)
    else:
        assert len(left) == len(build.SIGNATURES)
