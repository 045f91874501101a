"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: each test skips (with its reason) where no CUDA device is
present.  Run them on a machine with an H100:

    python -m pytest tests/test_torch_cuda.py -m cuda
"""

import faulthandler

import numpy as np
import pytest
import torch

from image_recognition_adversarial_example_attack_tpu_torch.kernels import elementwise as ew

pytestmark = pytest.mark.cuda

EPS, ALPHA = 8 / 255, 2 / 255
# odd sizes exercise the masked tails of the grid-stride loops
SHAPES = [(2, 16, 16, 3), (3, 7, 5, 3), (1,), (5,), (1025, 3)]


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(shape, device, seed=0):
    rng = np.random.RandomState(seed)
    x = torch.tensor(rng.rand(*shape), dtype=torch.float32, device=device)
    g = torch.tensor(rng.randn(*shape), dtype=torch.float32, device=device)
    g.view(-1)[::3] = 0.0
    x0 = torch.tensor(rng.rand(*shape), dtype=torch.float32, device=device)
    return x, g, x0


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("alpha", [ALPHA, -ALPHA])
def test_pgd_step_kernel_bit_exact(cuda, shape, alpha):
    x, g, x0 = _inputs(shape, cuda)
    before = ew.LAUNCHES["pgd_step"]
    got = ew.pgd_step(x, g, x0, EPS, alpha)
    assert ew.LAUNCHES["pgd_step"] == before + 1
    assert torch.equal(got, ew.pgd_step_plain(x, g, x0, EPS, alpha))
    # the CPU path gives the same bits
    assert torch.equal(got.cpu(), ew.pgd_step(x.cpu(), g.cpu(), x0.cpu(), EPS, alpha))


@pytest.mark.parametrize("shape", SHAPES)
def test_quantize_kernel_bit_exact(cuda, shape):
    x, _, _ = _inputs(shape, cuda)
    x = x * 1.4 - 0.2
    x.view(-1)[::2] = (torch.arange(x.view(-1)[::2].numel(), device=cuda) % 15 + 0.5) / 15
    got = ew.quantize(x, 16)
    assert torch.equal(got, ew.quantize_plain(x, 16))
    assert torch.equal(got.cpu(), ew.quantize_plain(x.cpu(), 16))


@pytest.mark.parametrize("n", [1, 2, 3, 5, 4097, 1 << 20])
def test_noise_kernel_range_and_tail(cuda, n):
    from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed

    out = ew.uniform_noise((n,), EPS, generator_from_seed(0), cuda)
    eps32 = float(np.float32(EPS))
    assert out.shape == (n,) and out.dtype == torch.float32
    assert float(out.min()) >= -eps32 and float(out.max()) <= eps32
    if n >= 1 << 20:
        d = out.double()
        assert abs(float(d.mean())) < 5e-3 * EPS
        assert abs(float(d.var()) / (EPS ** 2 / 3) - 1) < 1e-2


def test_noise_kernel_is_a_function_of_the_seed(cuda):
    from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed

    a = ew.uniform_noise((4099,), EPS, generator_from_seed(7), cuda)
    b = ew.uniform_noise((4099,), EPS, generator_from_seed(7), cuda)
    c = ew.uniform_noise((4099,), EPS, generator_from_seed(8), cuda)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x, g, x0 = _inputs((4, 6), cuda)
    with pytest.raises(TypeError):
        ew.quantize(x.double(), 16)
    with pytest.raises(ValueError):
        ew.pgd_step(x.t(), g.t(), x0.t(), EPS, ALPHA)  # not contiguous
    with pytest.raises(ValueError):
        ew.pgd_step(x, g.cpu(), x0, EPS, ALPHA)


def test_pgd_attack_on_the_card_launches_the_kernels(cuda):
    from image_recognition_adversarial_example_attack_tpu_torch.attacks import (
        AttackParams, make_logits_fn, run_attack)
    from image_recognition_adversarial_example_attack_tpu_torch.models import load_model

    b = load_model("resnet_tiny", device=cuda)
    lf = make_logits_fn(b.model, b.mean, b.std)
    x = torch.rand((4, 32, 32, 3), device=cuda)
    y = lf(x).argmax(-1)
    ew.reset_launches()
    x_adv = run_attack("pgd", lf, x, y, AttackParams(steps=3))
    assert ew.launch_counts() == {"pgd_step": 3, "quantize": 0, "uniform_noise": 1}
    assert float((x_adv - x).abs().max()) <= EPS + 1e-6
    assert float(x_adv.min()) >= 0.0 and float(x_adv.max()) <= 1.0


@pytest.fixture()
def tiny_pair(cuda):
    """resnet_tiny on the card and on the CPU, the same seeded weights, with
    (logits_fn, features_fn) for each."""
    from image_recognition_adversarial_example_attack_tpu_torch.cli.common import make_fns
    from image_recognition_adversarial_example_attack_tpu_torch.models import load_model

    return {d: make_fns(load_model("resnet_tiny", device=d)) for d in ("cuda", "cpu")}


def test_adaptive_cell_launches_quantize_inside_the_attack(cuda, tiny_pair):
    """--adaptive: the gradient crosses the straight-through quantization,
    one quantize launch per step, plus one for the defended prediction."""
    from image_recognition_adversarial_example_attack_tpu_torch.eval.defense_eval import (
        DefenseEvalConfig, evaluate_defenses_batch)

    lf, ff = tiny_pair["cuda"]
    x = torch.rand((4, 32, 32, 3), device=cuda)
    y = lf(x).argmax(-1)
    cfg = DefenseEvalConfig(attack_name="pgd", eps=EPS, alpha=ALPHA, steps=3, adaptive=True)
    ew.reset_launches()
    out = evaluate_defenses_batch(lf, ff, x, y, 1.0, cfg)
    torch.cuda.synchronize()
    assert ew.launch_counts() == {"pgd_step": 3, "quantize": 4, "uniform_noise": 1}
    assert float((out["x_adv"] - x).abs().max()) <= EPS + 1e-6


def test_squeezing_score_on_the_card_matches_the_cpu(cuda, tiny_pair):
    from image_recognition_adversarial_example_attack_tpu_torch.defenses import squeezing_score

    x = torch.rand((3, 32, 32, 3), generator=torch.Generator().manual_seed(0)) * 1.2 - 0.1
    ew.reset_launches()
    with torch.no_grad():
        got = squeezing_score(tiny_pair["cuda"][0], x.to(cuda))
        want = squeezing_score(tiny_pair["cpu"][0], x)
    assert ew.launch_counts()["quantize"] == 1
    assert float((got.cpu() - want).abs().max()) <= 1e-5
    # under autograd the straight-through gradient reaches the input
    xg = x.to(cuda).requires_grad_(True)
    (g,) = torch.autograd.grad(squeezing_score(tiny_pair["cuda"][0], xg).sum(), xg)
    assert ew.launch_counts()["quantize"] == 2
    assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0


def test_detector_aware_pgd_on_the_card(cuda, tiny_pair):
    from image_recognition_adversarial_example_attack_tpu_torch.attacks import (
        detector_aware_pgd, pgd_linf_attack)
    from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed
    from image_recognition_adversarial_example_attack_tpu_torch.defenses import squeezing_score

    lf = tiny_pair["cuda"][0]
    x = torch.rand((4, 32, 32, 3), device=cuda)
    y = lf(x).argmax(-1)
    ew.reset_launches()
    x_adv = detector_aware_pgd(lf, lambda xx: squeezing_score(lf, xx), x, y, eps=EPS,
                               alpha=ALPHA, steps=3, generator=generator_from_seed(0),
                               threshold=0.0, lam=1.0)
    torch.cuda.synchronize()
    assert ew.launch_counts() == {"pgd_step": 3, "quantize": 3, "uniform_noise": 1}
    assert float((x_adv - x).abs().max()) <= EPS + 1e-6
    assert float(x_adv.min()) >= 0.0 and float(x_adv.max()) <= 1.0
    # lam = 0 is PGD, bit for bit, from the same generator
    a = detector_aware_pgd(lf, None, x, y, eps=EPS, alpha=ALPHA, steps=3,
                           generator=generator_from_seed(1), threshold=0.0, lam=0.0)
    b = pgd_linf_attack(lf, x, y, eps=EPS, alpha=ALPHA, steps=3, generator=generator_from_seed(1))
    assert torch.equal(a, b)


def test_mahalanobis_on_the_card_matches_the_cpu(cuda):
    from image_recognition_adversarial_example_attack_tpu_torch.defenses import (
        fit_mahalanobis, mahalanobis_score_from_features)

    rng = np.random.RandomState(0)
    f = torch.tensor(rng.randn(40, 64) + rng.randn(5, 64)[rng.randint(0, 5, 40)],
                     dtype=torch.float32)
    labels = torch.tensor(rng.randint(0, 5, 40))
    z = torch.tensor(rng.randn(6, 7, 7, 64), dtype=torch.float32)
    assert not torch.backends.cuda.matmul.allow_tf32
    want = mahalanobis_score_from_features(z, fit_mahalanobis(f, labels, 5))
    got = mahalanobis_score_from_features(z.to(cuda), fit_mahalanobis(f.to(cuda),
                                                                      labels.to(cuda), 5))
    assert float((got.cpu() - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.parametrize("uint8", [False, True])
def test_placer_on_the_card(cuda, uint8):
    """The streamed chunks' placer: float32 on the card, bit-equal to the
    host's chunk, or under uint8 to the host's round(x*255) / float32(255)."""
    from image_recognition_adversarial_example_attack_tpu_torch.eval.streaming import make_placer

    x = np.random.RandomState(0).uniform(-0.01, 1.01, (3, 16, 16, 3)).astype(np.float32)
    got = make_placer(cuda, transfer_uint8=uint8)(x)
    assert got.device.type == "cuda" and got.dtype == torch.float32
    u8 = np.clip(np.round(x * 255), 0, 255).astype(np.uint8)
    want = u8.astype(np.float32) / np.float32(255) if uint8 else x
    assert np.array_equal(got.cpu().numpy(), want)


def test_placer_chunks_in_flight_keep_their_bits(cuda):
    """Twenty chunks placed back to back, each host array dropped at once
    and nothing synchronised in between: every device tensor holds its own
    chunk, so no pinned buffer was reused while its copy was in flight."""
    from image_recognition_adversarial_example_attack_tpu_torch.eval.streaming import make_placer

    place = make_placer(cuda)
    outs = [place(np.full((8, 64, 64, 3), i / 20, np.float32)) for i in range(20)]
    torch.cuda.synchronize()
    for i, out in enumerate(outs):
        assert bool((out == np.float32(i / 20)).all()), i


def test_kernels_at_the_visualize_cli_batch_one_shape(cuda):
    """The visualize CLI's PGD and trajectory launch pgd_step and the noise
    at [1,224,224,3]."""
    from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed

    shape = (1, 224, 224, 3)
    x, g, x0 = _inputs(shape, cuda)
    assert torch.equal(ew.pgd_step(x, g, x0, EPS, ALPHA), ew.pgd_step_plain(x, g, x0, EPS, ALPHA))
    noise = ew.uniform_noise(shape, EPS, generator_from_seed(0), cuda).double()
    eps32 = float(np.float32(EPS))
    assert float(noise.min()) >= -eps32 and float(noise.max()) <= eps32
    assert abs(float(noise.mean())) < 1e-2 * EPS
    assert abs(float(noise.var()) / (EPS ** 2 / 3) - 1) < 2e-2


def test_ssim_guards_itself_against_tf32(cuda):
    """With TF32 allowed for cuDNN globally, SSIM on the card still agrees
    with the float64 CPU value within 1e-5, and the global flag is left as
    it was."""
    from image_recognition_adversarial_example_attack_tpu_torch.eval.metrics import ssim

    rs = np.random.RandomState(1)
    a = rs.uniform(0, 1, (2, 224, 224, 3)).astype(np.float32)
    b = np.clip(a + np.float32(8 / 255) * np.sign(rs.randn(*a.shape)), 0, 1).astype(np.float32)
    want = float(ssim(torch.from_numpy(a).double(), torch.from_numpy(b).double()))
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        got = float(ssim(torch.from_numpy(a).to(cuda), torch.from_numpy(b).to(cuda)))
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    assert abs(got - want) <= 1e-5


# Seconds a conv test may take before the whole process ends with its
# traceback: a kernel that waits forever on an mbarrier (a wrong byte count)
# blocks inside torch.cuda.synchronize(), where no Python exception reaches.
CONV_TIME_LIMIT = 240


@pytest.fixture()
def time_limit():
    faulthandler.dump_traceback_later(CONV_TIME_LIMIT, exit=True)
    yield
    faulthandler.cancel_dump_traceback_later()


def _conv_inputs(batch, h, w, dtype, device, seed=0):
    rng = np.random.RandomState(seed)
    x = torch.tensor(rng.randn(batch, h, w, 64), dtype=dtype, device=device)
    wt = torch.tensor(rng.randn(3, 3, 64, 64) * 0.05, dtype=dtype, device=device)
    return x, wt


# 5x56: H not a multiple of the band's R = 2; 256 x 56x56: more bands than
# resident blocks; 1x1: a halo that is all border; 2x73: the widest bf16 band
CONV_SHAPES_BF16 = [(128, 56, 56), (3, 7, 7), (1, 1, 1), (2, 9, 17), (2, 5, 56),
                    (1, 56, 56), (256, 56, 56), (2, 3, 73)]
CONV_SHAPES_F32 = [(128, 56, 56), (8, 56, 56), (3, 7, 7), (2, 9, 17), (2, 5, 56),
                   (1, 56, 56), (1, 1, 1), (2, 3, 61)]


@pytest.mark.parametrize("shape", CONV_SHAPES_BF16)
def test_conv3x3_kernel_bf16_within_one_ulp(cuda, time_limit, shape):
    """Both versions round a float32 sum of exact bf16 products, summed in
    different orders: each element lies in the bf16 rounding interval of
    that sum (one or two bf16 values unless the products cancel), and all
    but a few cancelling ones within one bf16 ulp of the plain version. The
    odd sizes exercise the zero border of the TMA box, ragged last bands and
    junk positions."""
    from image_recognition_adversarial_example_attack_tpu_torch.kernels import conv3x3 as cv

    x, w = _conv_inputs(*shape, torch.bfloat16, cuda)
    before = cv.LAUNCHES["conv3x3"]
    got = cv.conv3x3(x, w)
    assert cv.LAUNCHES["conv3x3"] == before + 1
    want = cv.conv3x3_plain(x, w)
    lo, hi = cv.bf16_rounding_interval(x, w)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert bool(((lo <= got) & (got <= hi)).all())
    assert bool(((lo <= want) & (want <= hi)).all())
    beyond = (got.float() - want.float()).abs() > torch.maximum(cv.bf16_ulp(got), cv.bf16_ulp(want))
    assert float(beyond.float().mean()) < 1e-3


@pytest.mark.parametrize("shape", CONV_SHAPES_F32)
def test_conv3x3_kernel_f32(cuda, time_limit, shape):
    """Exact float32 FMA, each sum in k order: within 1e-5 of the largest
    output of the plain product, and at 8x56x56 equal to it bit for bit
    (cuBLAS's SGEMM sums that product in the same order)."""
    from image_recognition_adversarial_example_attack_tpu_torch.kernels import conv3x3 as cv

    assert not torch.backends.cuda.matmul.allow_tf32
    x, w = _conv_inputs(*shape, torch.float32, cuda)
    got = cv.conv3x3(x, w)
    want = cv.conv3x3_plain(x, w)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    if shape == (8, 56, 56):
        assert torch.equal(got, want)
    # and the CPU's plain version
    want_cpu = cv.conv3x3(x.cpu(), w.cpu())
    assert float((got.cpu() - want_cpu).abs().max()) <= 1e-5 * float(want_cpu.abs().max())


def test_conv3x3_reports_its_launch(cuda, time_limit):
    from image_recognition_adversarial_example_attack_tpu_torch.kernels import conv3x3 as cv

    for dtype in (torch.bfloat16, torch.float32):
        x, w = _conv_inputs(2, 56, 56, dtype, cuda)
        cv.conv3x3(x, w)
        torch.cuda.synchronize()
        plan = cv.tile_plan(56, 56)
        assert cv.LAST_LAUNCH["rows"] == plan.rows
        assert 0 < cv.LAST_LAUNCH["smem_bytes"] <= 232_448  # sm_90's per-block limit
        assert cv.LAST_LAUNCH["threads"] == 384
        assert 1 <= cv.LAST_LAUNCH["blocks"] <= 2 * plan.tiles_per_image


@pytest.mark.parametrize("dtype,width", [(torch.bfloat16, 74), (torch.float32, 62)])
def test_conv3x3_refuses_widths_its_band_does_not_take(cuda, dtype, width):
    from image_recognition_adversarial_example_attack_tpu_torch.kernels import conv3x3 as cv

    x, w = _conv_inputs(1, 2, width, dtype, cuda)
    before = cv.LAUNCHES["conv3x3"]
    with pytest.raises(ValueError, match="shared memory"):
        cv.conv3x3(x, w)
    assert cv.LAUNCHES["conv3x3"] == before
    # the CPU's plain version takes any width
    assert cv.conv3x3(x.cpu(), w.cpu()).shape == x.shape


def test_conv3x3_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    from image_recognition_adversarial_example_attack_tpu_torch.kernels import conv3x3 as cv

    x, w = _conv_inputs(2, 8, 8, torch.bfloat16, cuda)
    before = cv.LAUNCHES["conv3x3"]
    with pytest.raises(TypeError):
        cv.conv3x3(x.half(), w.half())
    with pytest.raises(TypeError):
        cv.conv3x3(x, w.float())
    with pytest.raises(ValueError):
        cv.conv3x3(x[..., :32].contiguous(), w[:, :, :32].contiguous())
    with pytest.raises(ValueError):
        cv.conv3x3(x.transpose(1, 2), w)  # not contiguous
    with pytest.raises(ValueError):
        cv.conv3x3(x, w.cpu())
    shifted = torch.empty(x.numel() + 8, dtype=x.dtype, device=cuda)[1:1 + x.numel()]
    with pytest.raises(ValueError, match="16-byte"):
        cv.conv3x3(shifted.view(x.shape), w)
    assert cv.LAUNCHES["conv3x3"] == before
