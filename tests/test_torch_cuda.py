"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: each test skips (with its reason) where no CUDA device is
present.  Run them on a machine with an H100:

    python -m pytest tests/test_torch_cuda.py -m cuda
"""

import faulthandler

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_port_helpers import module_time_limit, one_thread, time_limit  # noqa: F401 (autouse)
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


@pytest.mark.parametrize("offset", [0, 1, 2, 3, 4, 4097])
def test_noise_kernel_offset_draws_the_whole_draws_elements(cuda, offset):
    """A shard's draw (``uniform_noise_at`` at an element offset) is those
    elements of the draw that starts at 0, aligned or not, tails masked."""
    whole = ew.uniform_noise_at((10_000,), EPS, 12345, cuda)
    for n in (1, 3, 5, 4099):
        part = ew.uniform_noise_at((n,), EPS, 12345, cuda, offset=offset)
        assert torch.equal(part, whole[offset:offset + n]), n


def test_sharded_pgd_on_the_card_draws_the_unsharded_start(cuda):
    """PGD over two slots of the card: each shard launches the kernels, and
    the result equals the one-device run's at the same seed (the noise's
    Philox counter offset by the shard's first element)."""
    from image_recognition_adversarial_example_attack_tpu_torch.attacks import make_logits_fn
    from image_recognition_adversarial_example_attack_tpu_torch.attacks.pgd import (
        pgd_linf_attack)
    from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed
    from image_recognition_adversarial_example_attack_tpu_torch.models import load_model
    from image_recognition_adversarial_example_attack_tpu_torch.parallel import (
        data_parallel as dp, make_mesh, shard_batch)

    b = load_model("resnet_tiny", device=cuda)
    lf = make_logits_fn(b.model, b.mean, b.std)
    x = torch.rand((8, 32, 32, 3), device=cuda)
    y = lf(x).argmax(-1)
    mesh = make_mesh(n_data=2, n_model=1, devices=[torch.device("cuda", 0)] * 2)
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        ew.reset_launches()
        got = dp.sharded_pgd_linf_attack(lf, shard_batch(x.cpu(), mesh), dp.shard_labels(y, mesh),
                                         eps=EPS, alpha=ALPHA, steps=3,
                                         generator=generator_from_seed(6))
        assert ew.launch_counts() == {"pgd_step": 6, "quantize": 0, "uniform_noise": 2}
        halves = [pgd_linf_attack(lf, x[i * 4:(i + 1) * 4], y[i * 4:(i + 1) * 4], eps=EPS,
                                  alpha=ALPHA, steps=3, generator=g)
                  for i, g in enumerate(dp.generators_for(generator_from_seed(6),
                                                          shard_batch(x.cpu(), mesh)))]
    finally:
        torch.backends.cudnn.deterministic = prev
    assert torch.equal(got.gather(), torch.cat(halves).cpu())
    start = ew.uniform_noise((8, 32, 32, 3), EPS, generator_from_seed(6), cuda)
    first = ew.uniform_noise((4, 32, 32, 3), EPS,
                             dp.generators_for(generator_from_seed(6),
                                               shard_batch(x.cpu(), mesh))[1], cuda)
    assert torch.equal(first, start[4:])


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


@pytest.mark.parametrize("name", ["vgg19", "densenet121", "vit_b_16", "swin_t"])
def test_transfer_family_float32_logits_on_the_card_match_the_cpu(cuda, name):
    """Each transfer family at full width, the same seeded weights: float32
    logits on the card (TF32 off) within 1e-5 of the largest CPU logit."""
    from image_recognition_adversarial_example_attack_tpu_torch.cli.common import make_fns
    from image_recognition_adversarial_example_attack_tpu_torch.models import load_model

    x = torch.rand((1, 224, 224, 3), generator=torch.Generator().manual_seed(0))
    out = {}
    for d in ("cpu", "cuda"):
        lf = make_fns(load_model(name, device=d))[0]
        with torch.no_grad():
            out[d] = lf(x.to(d)).cpu()
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
    scale = float(out["cpu"].abs().max())
    assert float((out["cuda"] - out["cpu"]).abs().max()) <= 1e-5 * scale


def test_transfer_cell_launches_exactly_its_pgd_kernels(cuda):
    """A pgd-3 transfer cell (resnet_tiny -> tiny) launches 3 pgd_step and 1
    noise kernel, and no more for the targets' forwards."""
    from image_recognition_adversarial_example_attack_tpu_torch.attacks import AttackParams
    from image_recognition_adversarial_example_attack_tpu_torch.cli.common import make_fns
    from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed
    from image_recognition_adversarial_example_attack_tpu_torch.eval.transfer import (
        transfer_attack_batch)
    from image_recognition_adversarial_example_attack_tpu_torch.models import load_model

    src = make_fns(load_model("resnet_tiny", device=cuda))[0]
    tgt = make_fns(load_model("tiny", device=cuda))[0]
    x = torch.rand((4, 32, 32, 3), device=cuda)
    ew.reset_launches()
    cell = transfer_attack_batch(src, {"tiny": tgt}, x, "pgd", AttackParams(steps=3),
                                 generator_from_seed(0), convention="blackbox")
    torch.cuda.synchronize()
    assert ew.launch_counts() == {"pgd_step": 3, "quantize": 0, "uniform_noise": 1}
    assert float((cell.x_adv - x).abs().max()) <= EPS + 1e-6
    assert set(cell.target_success["tiny"].tolist()) <= {0, 1}


def test_native_loader_inside_a_streamed_chunk(cuda, tmp_path, monkeypatch):
    """Under ADV_TPU_NATIVE_LOADER=1 the streamed chunks that reach the card
    are the native decoder's pixels; on a host whose compiler finds no
    libjpeg the stream raises instead of decoding with PIL."""
    from PIL import Image

    from image_recognition_adversarial_example_attack_tpu_torch.eval.streaming import make_placer
    from image_recognition_adversarial_example_attack_tpu_torch.utils import native_loader
    from image_recognition_adversarial_example_attack_tpu_torch.utils.pipeline import (
        EvalBatchPipeline)

    rng = np.random.RandomState(0)
    paths = []
    for i in range(5):
        paths.append(tmp_path / f"img_{i}.{'png' if i % 2 else 'jpg'}")
        Image.fromarray((rng.rand(260, 300, 3) * 255).astype(np.uint8)).save(paths[-1])
    monkeypatch.setenv("ADV_TPU_NATIVE_LOADER", "1")
    if not native_loader.native_available():
        with pytest.raises(RuntimeError, match="native image loader"):
            list(EvalBatchPipeline(paths, 2))
        return
    want, ok = native_loader.load_batch_native_with_status(paths)
    assert ok.all()
    place = make_placer(cuda)
    got = [place(x)[:n].cpu().numpy() for _, x, _, n in EvalBatchPipeline(paths, 2)]
    assert np.array_equal(np.concatenate(got), want)


# ---------------------------------------------------------------------------
# int8 inference (ops/int8.py): torch._int_mm on the card against the plain
# int64 route, bit for bit; the transfer family's launches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n", [(1, 2048, 1000), (128, 2048, 1000), (5, 147, 64),
                                   (4096, 147, 64), (33, 576, 64), (7, 10, 3)])
def test_int_mm_route_on_the_card_equals_the_plain_route(cuda, m, k, n):
    from image_recognition_adversarial_example_attack_tpu_torch.ops import int8

    g = torch.Generator().manual_seed(m + k + n)
    a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8)
    got = int8.int_matmul(a.to(cuda), w.to(cuda))
    assert got.dtype == torch.int32 and got.is_cuda
    assert torch.equal(got.cpu(), int8.int_matmul_plain(a, w))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("conv", [((2, 3, 32, 32), (8, 3, 7, 7), 2, 3),
                                  ((2, 16, 14, 14), (16, 16, 3, 3), 1, 1),
                                  ((2, 16, 14, 14), (32, 16, 1, 1), 2, 0)])
def test_int8_conv_on_the_card_equals_the_cpu(cuda, dtype, conv):
    """The same quantization and integer sums on both devices: bit-equal
    outputs; the gradient is the float convolution's."""
    from image_recognition_adversarial_example_attack_tpu_torch.ops import int8

    xs, ws, stride, pad = conv
    g = torch.Generator().manual_seed(1)
    x = torch.randn(xs, generator=g).to(dtype)
    w = (torch.randn(ws, generator=g) * 0.2).to(dtype)
    want = int8.int8_conv2d(x, w, stride, pad)
    xc = x.to(cuda).contiguous(memory_format=torch.channels_last).requires_grad_(True)
    got = int8.int8_conv2d(xc, w.to(cuda), stride, pad)
    assert torch.equal(got.cpu(), want)
    gout = torch.randn(got.shape, generator=g).to(dtype).to(cuda)
    (gx,) = torch.autograd.grad(got, xc, gout)
    xf = x.to(cuda).requires_grad_(True)
    (fx,) = torch.autograd.grad(torch.nn.functional.conv2d(xf, w.to(cuda), stride=stride,
                                                           padding=pad), xf, gout)
    torch.testing.assert_close(gx, fx)


def test_int8_resnet_on_the_card_calls_every_hooked_layer(cuda):
    from image_recognition_adversarial_example_attack_tpu_torch.attacks import make_logits_fn
    from image_recognition_adversarial_example_attack_tpu_torch.models import load_model
    from image_recognition_adversarial_example_attack_tpu_torch.ops import int8

    b = load_model("resnet_tiny", device=cuda, int8=True)
    lf = make_logits_fn(b.model, b.mean, b.std)
    int8.reset_calls()
    with torch.no_grad():
        out = lf(torch.rand((4, 32, 32, 3), device=cuda))
    assert int8.call_counts() == {"conv": 17, "linear": 1}
    assert bool(torch.isfinite(out).all())


@pytest.mark.parametrize("name", ["mifgsm", "dim", "tim"])
def test_transfer_attacks_launch_one_pgd_step_per_step(cuda, name):
    from image_recognition_adversarial_example_attack_tpu_torch.attacks import (
        AttackParams, make_logits_fn, run_attack)
    from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed
    from image_recognition_adversarial_example_attack_tpu_torch.models import load_model

    b = load_model("resnet_tiny", device=cuda)
    lf = make_logits_fn(b.model, b.mean, b.std)
    x = torch.rand((4, 32, 32, 3), device=cuda)
    y = lf(x).argmax(-1)
    ew.reset_launches()
    x_adv = run_attack(name, lf, x, y, AttackParams(steps=3), generator_from_seed(0))
    torch.cuda.synchronize()
    assert ew.launch_counts() == {"pgd_step": 3, "quantize": 0, "uniform_noise": 0}
    assert float((x_adv - x).abs().max()) <= EPS + 1e-6
    assert float(x_adv.min()) >= 0.0 and float(x_adv.max()) <= 1.0


# ---------------------------------------------------------------------------
# the white-box zoo: the noise kernel draws every L∞ random start (apgd's,
# fab's jitter, pgd_l1's at a = 1); pgd_multi_restart runs pgd_step
# ---------------------------------------------------------------------------

# name -> noise launches at steps 3 and 2 targets
ZOO_LAUNCHES = {"apgd": 1, "apgd_dlr": 1, "apgd_t": 2, "fab": 2, "pgd_l2": 0, "pgd_l1": 1,
                "deepfool": 0, "ead": 0, "jsma": 0, "stadv": 0, "spatial": 0}


@pytest.mark.parametrize("name", sorted(ZOO_LAUNCHES))
def test_white_box_zoo_on_the_card(cuda, name):
    from image_recognition_adversarial_example_attack_tpu_torch.attacks import (
        ATTACK_THREAT, AttackParams, make_logits_fn, run_attack)
    from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed
    from image_recognition_adversarial_example_attack_tpu_torch.models import load_model

    b = load_model("resnet_tiny", device=cuda)
    lf = make_logits_fn(b.model, b.mean, b.std)
    x = torch.rand((4, 32, 32, 3), generator=torch.Generator().manual_seed(3)).to(cuda)
    y = lf(x).argmax(-1)
    eps = {"pgd_l2": 0.5, "pgd_l1": 4.0}.get(name, EPS)
    params = AttackParams(eps=eps, steps=3, n_target_classes=2, cw_steps=3, deepfool_steps=3,
                          jsma_steps=3, stadv_steps=3, spatial_candidates=2)
    ew.reset_launches()
    x_adv = run_attack(name, lf, x, y, params, generator_from_seed(0))
    torch.cuda.synchronize()
    assert ew.launch_counts() == {"pgd_step": 0, "quantize": 0,
                                  "uniform_noise": ZOO_LAUNCHES[name]}
    again = run_attack(name, lf, x, y, params, generator_from_seed(0))
    assert torch.equal(x_adv, again)
    assert x_adv.is_cuda and bool(torch.isfinite(x_adv).all())
    assert float(x_adv.min()) >= 0.0 and float(x_adv.max()) <= 1.0
    d = (x_adv - x).reshape(4, -1)
    threat = ATTACK_THREAT[name]
    if threat == "linf":
        assert float(d.abs().max()) <= eps + 1e-6
    elif threat == "l2":
        assert float(d.norm(dim=1).max()) <= eps + 1e-4
    elif threat == "l1":
        assert float(d.abs().sum(dim=1).max()) <= eps + 1e-4
    elif threat == "l0":
        assert int((d.reshape(4, -1, 3) != 0).any(-1).sum(-1).max()) <= 2 * params.jsma_steps


@pytest.mark.parametrize("norm", ["linf", "l2"])
def test_apgd_and_fab_l2_draw_on_the_card(cuda, norm):
    """The L2 starts are normal draws made on the card (no noise launch)."""
    from image_recognition_adversarial_example_attack_tpu_torch.attacks import (
        apgd_attack, fab_targeted_attack, make_logits_fn)
    from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed
    from image_recognition_adversarial_example_attack_tpu_torch.models import load_model

    b = load_model("resnet_tiny", device=cuda)
    lf = make_logits_fn(b.model, b.mean, b.std)
    x = torch.rand((4, 32, 32, 3), generator=torch.Generator().manual_seed(4)).to(cuda)
    y = lf(x).argmax(-1)
    eps = EPS if norm == "linf" else 0.5
    ew.reset_launches()
    a = apgd_attack(lf, x, y, eps=eps, steps=3, generator=generator_from_seed(0), norm=norm)
    f = fab_targeted_attack(lf, x, y, eps=eps, steps=2, n_targets=2,
                            generator=generator_from_seed(0), norm=norm)
    torch.cuda.synchronize()
    assert ew.LAUNCHES["uniform_noise"] == (3 if norm == "linf" else 0)
    d = (a - x).reshape(4, -1)
    size = d.abs().max(dim=1).values if norm == "linf" else d.norm(dim=1)
    assert float(size.max()) <= eps + 1e-5
    assert bool(torch.isfinite(f).all()) and float(f.min()) >= 0.0 and float(f.max()) <= 1.0


def test_pgd_multi_restart_launches(cuda):
    from image_recognition_adversarial_example_attack_tpu_torch.attacks import (
        make_logits_fn, pgd_multi_restart)
    from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed
    from image_recognition_adversarial_example_attack_tpu_torch.models import load_model

    b = load_model("resnet_tiny", device=cuda)
    lf = make_logits_fn(b.model, b.mean, b.std)
    x = torch.rand((4, 32, 32, 3), generator=torch.Generator().manual_seed(5)).to(cuda)
    y = lf(x).argmax(-1)
    ew.reset_launches()
    x_adv = pgd_multi_restart(lf, x, y, eps=EPS, alpha=ALPHA, steps=3,
                              generator=generator_from_seed(0), restarts=3)
    torch.cuda.synchronize()
    assert ew.launch_counts() == {"pgd_step": 9, "quantize": 0, "uniform_noise": 3}
    assert float((x_adv - x).abs().max()) <= EPS + 1e-6


# ---------------------------------------------------------------------------
# the black-box group: nes, spsa and bandits take the pgd_step kernel once a
# step; the others launch nothing of the port's; every draw is made on the card
# ---------------------------------------------------------------------------

# name -> pgd_step launches at steps 2 and bandits_steps 3
BLACK_BOX_LAUNCHES = {"square": 0, "square_l2": 0, "nes": 2, "spsa": 2, "bandits": 3,
                      "hsja": 0, "boundary": 0, "simba": 0}


def _tiny_on(cuda, seed):
    from image_recognition_adversarial_example_attack_tpu_torch.attacks import make_logits_fn
    from image_recognition_adversarial_example_attack_tpu_torch.models import load_model

    b = load_model("resnet_tiny", device=cuda)
    lf = make_logits_fn(b.model, b.mean, b.std)
    x = torch.rand((4, 32, 32, 3), generator=torch.Generator().manual_seed(seed)).to(cuda)
    with torch.no_grad():
        return lf, x, lf(x).argmax(-1)


@pytest.mark.parametrize("name", sorted(BLACK_BOX_LAUNCHES))
def test_black_box_attacks_on_the_card(cuda, name):
    from image_recognition_adversarial_example_attack_tpu_torch.attacks import (
        ATTACK_THREAT, AttackParams, run_attack)
    from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed

    lf, x, y = _tiny_on(cuda, 6)
    eps = 0.5 if name == "square_l2" else EPS
    params = AttackParams(eps=eps, steps=2, est_samples=2, square_steps=5, bandits_steps=3,
                          bandits_prior_factor=4, hsja_steps=1, hsja_probes=3,
                          boundary_steps=4, simba_steps=4)
    ew.reset_launches()
    x_adv = run_attack(name, lf, x, y, params, generator_from_seed(0))
    torch.cuda.synchronize()
    assert ew.launch_counts() == {"pgd_step": BLACK_BOX_LAUNCHES[name], "quantize": 0,
                                  "uniform_noise": 0}
    assert torch.equal(x_adv, run_attack(name, lf, x, y, params, generator_from_seed(0)))
    assert x_adv.is_cuda and bool(torch.isfinite(x_adv).all())
    assert float(x_adv.min()) >= 0.0 and float(x_adv.max()) <= 1.0
    d = (x_adv - x).reshape(4, -1)
    if ATTACK_THREAT[name] == "linf":
        assert float(d.abs().max()) <= eps + 1e-6
    elif ATTACK_THREAT[name] == "l2":
        assert float(d.norm(dim=1).max()) <= eps + 1e-4


def test_black_box_draws_are_made_on_the_card(cuda):
    import numpy as np

    from image_recognition_adversarial_example_attack_tpu_torch.attacks import (
        bandits, grad_est, simba, square)
    from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed

    sides = square.square_schedule(6, 16, 16)
    for t in square.draw_square(6, 3, 16, 16, 3, sides, generator_from_seed(0), cuda):
        assert t.is_cuda
    for t in simba.draw_simba(6, 3, 4, 4, 3, generator_from_seed(0), cuda):
        assert t.is_cuda and int(t.max()) < 4
    g = torch.Generator(device=cuda)
    g.manual_seed(1)
    assert grad_est.draw_probe((2, 8), "rademacher", g, cuda).is_cuda
    assert bandits.draw_latent((2, 4), g, cuda).is_cuda
    r0 = square.draw_square(6, 4000, 16, 16, 3, sides, generator_from_seed(0), cuda)[1]
    assert int(r0.min()) == 0 and (r0.cpu().numpy() <= 16 - sides[:, None]).all()
    assert np.unique(r0[0].cpu().numpy()).size == 16 - int(sides[0]) + 1


def test_eot_mix_on_the_card_equals_the_cpu(cuda):
    from image_recognition_adversarial_example_attack_tpu_torch.attacks import eot
    from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed

    x = torch.rand((8, 224, 224, 3), generator=torch.Generator().manual_seed(2))
    assert int(eot.input_mix(x.to(cuda))) == int(eot.input_mix(x))
    lf, xs, _ = _tiny_on(cuda, 7)
    fn = eot.make_eot_logits_fn(lf, generator_from_seed(0), n_samples=3)
    out = fn(xs)
    assert out.is_cuda and torch.equal(out, fn(xs))
    assert torch.allclose(out.exp().sum(-1), torch.ones(4, device=cuda), atol=1e-5)


@pytest.mark.parametrize("protocol", ["lite", "standard", "rand"])
def test_robust_eval_protocols_on_the_card(cuda, protocol):
    """The L∞ random starts of APGD-CE/DLR, APGD-T and FAB-T are noise
    launches: 1 (lite), 1 + 2 + 2 (standard, 2 targets), 2 (rand)."""
    from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed
    from image_recognition_adversarial_example_attack_tpu_torch.eval import robust_eval

    lf, x, y = _tiny_on(cuda, 8)
    fn = {"lite": robust_eval.autoattack_lite, "standard": robust_eval.autoattack,
          "rand": robust_eval.autoattack_rand}[protocol]
    kw, want = {"lite": (dict(apgd_steps=2, square_steps=4, deepfool_steps=2), 1),
                "standard": (dict(apgd_steps=2, apgd_t_steps=2, apgd_t_targets=2, fab_steps=2,
                                  fab_targets=2, square_steps=4), 5),
                "rand": (dict(eot_samples=2, apgd_steps=2, square_steps=4), 2)}[protocol]
    ew.reset_launches()
    res = fn(lf, x, y, eps=EPS, generator=generator_from_seed(0), **kw)
    torch.cuda.synchronize()
    assert ew.launch_counts() == {"pgd_step": 0, "quantize": 0, "uniform_noise": want}
    assert res.x_adv.is_cuda and float((res.x_adv - x).abs().max()) <= EPS + 1e-6
    again = fn(lf, x, y, eps=EPS, generator=generator_from_seed(0), **kw)
    assert torch.equal(res.success, again.success) and torch.equal(res.x_adv, again.x_adv)


def test_query_curve_on_the_card(cuda):
    from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed
    from image_recognition_adversarial_example_attack_tpu_torch.eval import query_curves as qc

    lf, x, y = _tiny_on(cuda, 9)
    for attack in qc.CURVE_ATTACKS:
        ew.reset_launches()
        curve = qc.query_curve(attack, lf, x, y, eps=EPS, max_queries=20, est_samples=2,
                               generator=generator_from_seed(0))
        steps = qc.budget_to_steps(attack, 20, 2)
        assert len(curve["asr"]) == steps and 0.0 <= curve["final_asr"] <= 1.0
        pgd = steps if attack in ("nes", "spsa", "bandits") else 0
        assert ew.LAUNCHES["pgd_step"] == pgd


def test_resize_pad_on_the_card_equals_the_cpu(cuda):
    from image_recognition_adversarial_example_attack_tpu_torch.defenses import randomization

    g = torch.Generator().manual_seed(4)
    x = torch.rand((4, 224, 224, 3), generator=g)
    s = torch.tensor([0.7, 0.85, 0.93, 1.0])
    oy, ox = torch.rand(4, generator=g) * (1 - s) * 224, torch.rand(4, generator=g) * (1 - s) * 224
    want = randomization.resize_pad(x, s, oy, ox)
    got = randomization.resize_pad(x.to(cuda), s.to(cuda), oy.to(cuda), ox.to(cuda))
    assert float((got.cpu() - want).abs().max()) <= 1e-5


@pytest.mark.parametrize("name", ["ibp_tiny", "ibp_cnn7"])
def test_crown_ibp_margin_on_the_card_equals_the_cpu(cuda, name):
    """float32 on the card (TF32 off) against float64 on the CPU, relative
    to the margins' scale; with TF32 allowed the bounds refuse to run."""
    from image_recognition_adversarial_example_attack_tpu_torch.defenses import crown_ibp
    from image_recognition_adversarial_example_attack_tpu_torch.models import ibp, load_model

    b = load_model(name, device=cuda)
    spec, mean, std = b.model.spec, b.mean, b.std
    x = torch.rand((4, 32, 32, 3), generator=torch.Generator().manual_seed(1))
    y = torch.tensor([0, 3, 5, 9])
    got = crown_ibp.crown_ibp_margin(ibp.ibp_params(b.model), spec, x.to(cuda), y.to(cuda),
                                     8 / 255, mean, std).cpu().double()
    cpu = load_model(name, device="cpu").model.double()
    want = crown_ibp.crown_ibp_margin(ibp.ibp_params(cpu), spec, x.double(), y, 8 / 255, mean,
                                      std)
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
    torch.backends.cudnn.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="full float32"):
            crown_ibp.crown_ibp_margin(ibp.ibp_params(b.model), spec, x.to(cuda), y.to(cuda),
                                       8 / 255, mean, std)
    finally:
        torch.backends.cudnn.allow_tf32 = False


CORRUPTION_CONVS = ("defocus_blur", "glass_blur", "motion_blur", "snow", "elastic_transform",
                    "gaussian_blur", "fog")


@pytest.fixture()
def full_float32():
    """TF32 off for cuDNN and cuBLAS (``load_model`` does this), restored after."""
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.parametrize("severity", [1, 3, 5])
def test_corruption_bank_on_the_card_equals_the_cpu(cuda, full_float32, severity):
    """Every corruption on the card against the CPU on the same draws (made
    once on the CPU): within 1e-5, the order-0 gathers (pixelate) and the
    exact ones equal; the draws of a generator are made on the card; with
    TF32 allowed the convolutions refuse to run."""
    from image_recognition_adversarial_example_attack_tpu_torch.core.rng import (
        generator_from_seed)
    from image_recognition_adversarial_example_attack_tpu_torch.eval import corruptions as c

    x = torch.rand((3, 64, 64, 3), generator=torch.Generator().manual_seed(severity))
    for name in c.CORRUPTION_NAMES:
        draws = c.draw_corruption(name, x, severity, generator_from_seed(severity))
        want = c.apply_corruption(name, x, severity, draws=draws)
        got = c.apply_corruption(name, x.to(cuda), severity,
                                 draws=tuple(d.to(cuda) for d in draws)).cpu()
        if name in ("pixelate", "brightness", "impulse_noise", "shot_noise"):
            assert torch.equal(got, want), name
        assert float((got - want).abs().max()) <= 1e-5, name
        on_card = c.draw_corruption(name, x.to(cuda), severity, generator_from_seed(0))
        assert all(d.device.type == "cuda" for d in on_card), name
    torch.backends.cudnn.allow_tf32 = True
    for name in CORRUPTION_CONVS[:-1]:
        with pytest.raises(RuntimeError, match="full float32"):
            c.apply_corruption(name, x.to(cuda), severity, generator_from_seed(0))
    torch.backends.cuda.matmul.allow_tf32 = True
    with pytest.raises(RuntimeError, match="full float32"):
        c.apply_corruption("fog", x.to(cuda), severity, generator_from_seed(0))


def test_map_coordinates_on_the_card_equals_the_cpu(cuda):
    from image_recognition_adversarial_example_attack_tpu_torch.eval import corruptions as c

    g = torch.Generator().manual_seed(0)
    x = torch.rand((2, 32, 24, 3), generator=g, dtype=torch.float64)
    rr = torch.rand((2, 32, 24), generator=g, dtype=torch.float64) * 40 - 4
    cc = torch.rand((2, 32, 24), generator=g, dtype=torch.float64) * 30 - 3
    rr.view(-1)[:3] = torch.tensor([0.5, 2.5, -0.5], dtype=torch.float64)
    for order in (0, 1):
        want = c.map_coordinates(x, rr, cc, order)
        got = c.map_coordinates(x.to(cuda), rr.to(cuda), cc.to(cuda), order).cpu()
        assert float((got - want).abs().max()) <= 1e-12


def test_squeezing_cell_launches_quantize_once_on_the_stacked_batch(cuda):
    """The detector comparison's squeezing score on the stacked [2B] batch:
    one quantize launch, bit-equal to the plain version at that shape."""
    from image_recognition_adversarial_example_attack_tpu_torch.attacks import make_logits_fn
    from image_recognition_adversarial_example_attack_tpu_torch.defenses import squeezing_score
    from image_recognition_adversarial_example_attack_tpu_torch.eval import detector_eval
    from image_recognition_adversarial_example_attack_tpu_torch.models import load_model

    b = load_model("resnet_tiny", device=cuda)
    lf = make_logits_fn(b.model, b.mean, b.std)
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.rand((8, 224, 224, 3), generator=g, device=cuda)
    x_adv = torch.clamp(x + 0.03 * torch.randn(x.shape, generator=g, device=cuda), 0, 1)
    before = ew.LAUNCHES["quantize"]
    r = detector_eval.evaluate_detector_cell(lambda xx: squeezing_score(lf, xx), x, x_adv, 0.01,
                                             detector="squeezing", attack="toy")
    assert ew.LAUNCHES["quantize"] == before + 1 and 0.0 <= r.auc <= 1.0
    stacked = torch.cat([x, x_adv]) * 1.2 - 0.1
    assert torch.equal(ew.quantize(stacked, 16), ew.quantize_plain(stacked, 16))


# the test-scale variants of the CIFAR and lightweight families: (module, constructor)
TINY_FAMILIES = {
    "wrn_tiny": ("wideresnet", "wrn_tiny"),
    "preact_tiny": ("preactresnet", None),
    "mobilenet_tiny": ("mobilenet", "mobilenet_tiny"),
    "efficientnet_tiny": ("efficientnet", "efficientnet_tiny"),
    "convnext_micro": ("convnext", "convnext_micro"),
}


@pytest.mark.parametrize("name", sorted(TINY_FAMILIES))
def test_cifar_and_light_families_float32_on_the_card_match_the_cpu(cuda, name):
    """Each tiny variant, the same seeded weights (norm statistics and layer
    scales moved off their init): float32 logits at 32x32 on the card (TF32
    off, as load_model sets it) within 1e-5 of the largest CPU logit."""
    import importlib

    from image_recognition_adversarial_example_attack_tpu_torch.attacks import make_logits_fn
    from image_recognition_adversarial_example_attack_tpu_torch.core.constants import (
        CIFAR10_MEAN, CIFAR10_STD)
    from image_recognition_adversarial_example_attack_tpu_torch.models import zoo

    module, ctor = TINY_FAMILIES[name]
    mod = importlib.import_module(
        f"image_recognition_adversarial_example_attack_tpu_torch.models.{module}")
    model = (mod.PreActResNet(stage_sizes=(1, 1, 1, 1)) if ctor is None
             else getattr(mod, ctor)())
    zoo.random_init_(model).requires_grad_(False).eval()
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for key, t in model.state_dict().items():
            if key.endswith(("running_var", "layer_scale")) or (t.ndim == 1 and "weight" in key):
                t.copy_(torch.rand(t.shape, generator=g) + 0.5)
            elif key.endswith(("running_mean", "bias")):
                t.copy_(torch.randn(t.shape, generator=g) * 0.1)
    x = torch.rand((4, 32, 32, 3), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = make_logits_fn(model, CIFAR10_MEAN, CIFAR10_STD)(x)
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        card = model.to(cuda, memory_format=torch.channels_last)
        with torch.no_grad():
            got = make_logits_fn(card, CIFAR10_MEAN, CIFAR10_STD)(x.to(cuda)).cpu()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
    assert got.shape == want.shape == (4, 10)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * scale


# ---------------------------------------------------------------------------
# training (train/adversarial.py, train/augment.py), chip_smoke.py phase 23
# ---------------------------------------------------------------------------

def _train_pair(device, cfg, dtype=torch.float32):
    """A wrn_tiny TrainState on ``device`` from seeded weights, and a batch."""
    from image_recognition_adversarial_example_attack_tpu_torch.models import zoo
    from image_recognition_adversarial_example_attack_tpu_torch.models.wideresnet import wrn_tiny
    from image_recognition_adversarial_example_attack_tpu_torch.train import adversarial

    model = zoo.random_init_(wrn_tiny()).requires_grad_(False).eval()
    model.to(device, memory_format=torch.channels_last)
    bundle = zoo.ModelBundle(name="wrn_tiny", model=model, source="random",
                             dtype=torch.float32, device=device, input_size=32,
                             mean=zoo.model_meta("wrn_tiny")["mean"].copy(),
                             std=zoo.model_meta("wrn_tiny")["std"].copy())
    state = adversarial.train_state_from_bundle(bundle, cfg, dtype)
    g = torch.Generator().manual_seed(3)
    x = torch.rand((8, 32, 32, 3), generator=g).to(device)
    y = torch.randint(0, 10, (8,), generator=g).to(device)
    return bundle, state, x, y


@pytest.mark.parametrize("objective", ["pgd-at", "trades", "mart"])
def test_training_steps_on_the_card_launch_the_kernels(cuda, objective):
    """bf16 wrn_tiny, 3 inner steps: exactly 3 pgd_step launches a step (and
    one noise for PGD-AT and MART, whose start is the noise kernel)."""
    from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed
    from image_recognition_adversarial_example_attack_tpu_torch.train import adversarial

    cfg = adversarial.AdvTrainConfig(attack_steps=3, train_bn=objective == "trades")
    bundle, state, x, y = _train_pair(cuda, cfg, torch.bfloat16)
    make = {"pgd-at": adversarial.make_train_step, "trades": adversarial.make_trades_step,
            "mart": adversarial.make_mart_step}[objective]
    step = make(cfg, bundle.mean, bundle.std)
    ew.reset_launches()
    for s in range(2):
        state, m = step(state, x, y, generator_from_seed(s))
    assert ew.launch_counts() == {"pgd_step": 6, "quantize": 0,
                                  "uniform_noise": 0 if objective == "trades" else 2}
    assert torch.isfinite(m["loss"]) and state.step == 2
    assert all(p.dtype == torch.float32 and p.is_cuda for p in state.params.values())


@pytest.mark.parametrize("train_bn", [False, True])
def test_float32_training_step_on_the_card_matches_the_cpu(cuda, train_bn):
    """One float32 CE step (attack_steps 0) of wrn_tiny, TF32 off: the loss
    within 1e-5 relative and the gradient (AdamW's first moment) within 1e-5
    of its largest entry of the CPU's; with train_bn, calibrate_batch_stats
    too."""
    from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed
    from image_recognition_adversarial_example_attack_tpu_torch.train import adversarial

    cfg = adversarial.AdvTrainConfig(attack_steps=0, train_bn=train_bn, learning_rate=1e-3)
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = {}
        for dev in (cuda, torch.device("cpu")):
            bundle, state, x, y = _train_pair(dev, cfg)
            new, m = adversarial.make_train_step(cfg, bundle.mean, bundle.std)(
                state, x, y, generator_from_seed(0))
            stats = adversarial.calibrate_batch_stats(new, x, bundle.mean, bundle.std,
                                                      batch_size=4, min_batches=3)
            out[dev.type] = (float(m["loss"]), {k: v.cpu() for k, v in new.opt_state.mu.items()},
                             {k: v.cpu() for k, v in stats.items()})
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
    (lg, mu_g, st_g), (lc, mu_c, st_c) = out["cuda"], out["cpu"]
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    scale = max(float(v.abs().max()) for v in mu_c.values())
    assert max(float((mu_g[k] - mu_c[k]).abs().max()) for k in mu_c) <= 1e-5 * scale
    for k, v in st_c.items():
        assert torch.allclose(st_g[k].float(), v.float(), rtol=1e-5, atol=1e-5), k


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_sharded_remat_train_bn_step_on_the_card_matches_the_cpu(cuda, grad_accum):
    """One float32 CE step (attack_steps 0) of wrn_tiny with train_bn and
    remat over two slots of the card, TF32 off, against the same step over
    two CPU slots: the recompute in the backward (on the card, on autograd's
    device thread) reads the whole batch's statistics its first forward
    summed.  The loss within 1e-5 relative and the first moment within 1e-5
    of its largest entry, as the unsharded float32 step is held."""
    from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed
    from image_recognition_adversarial_example_attack_tpu_torch.parallel import (
        make_mesh, shard_batch)
    from image_recognition_adversarial_example_attack_tpu_torch.train import adversarial

    cfg = adversarial.AdvTrainConfig(attack_steps=0, train_bn=True, remat=True,
                                     grad_accum=grad_accum, learning_rate=1e-3)
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = {}
        for dev in (cuda, torch.device("cpu")):
            bundle, state, x, y = _train_pair(dev, cfg)
            mesh = make_mesh(n_data=2, n_model=1, devices=[dev, dev])
            new, m = adversarial.make_train_step(cfg, bundle.mean, bundle.std)(
                state, shard_batch(x.cpu(), mesh), y.cpu(), generator_from_seed(0))
            out[dev.type] = (float(m["loss"]), {k: v.cpu() for k, v in new.opt_state.mu.items()})
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
    (lg, mu_g), (lc, mu_c) = out["cuda"], out["cpu"]
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    scale = max(float(v.abs().max()) for v in mu_c.values())
    assert max(float((mu_g[k] - mu_c[k]).abs().max()) for k in mu_c) <= 1e-5 * scale


def test_augmentation_on_the_card_equals_the_cpu(cuda):
    """The same draws crop, flip and cut out the same pixels on the card."""
    from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed
    from image_recognition_adversarial_example_attack_tpu_torch.train import augment

    fn = augment.make_augment_fn(augment.AugmentConfig(pad=4, flip=True, cutout=8))
    x = torch.rand((16, 32, 32, 3), generator=torch.Generator().manual_seed(2))
    got = fn(generator_from_seed(5), x.to(cuda))
    assert got.is_cuda and torch.equal(got.cpu(), fn(generator_from_seed(5), x))


# Every objective, float32 with TF32 off, card against CPU.  Each step runs
# on the card, then on the CPU in float32 and in float64 (the step's float32
# casts lifted) from the card's state (parameters, moments, step) with the
# card's draws and inner iterates replayed (the PGD start, TRADES's start,
# each pgd_step output, the free delta), so that only rounding parts them.
# The card is held to the float64 step within FLOAT32_FACTOR times the CPU
# float32 step's own distance from it, or OBJ_REL_TOL where that is larger:
# the loss and every other metric relative, AdamW's first moment relative to
# its largest entry.  (Where the float32 arithmetic cancels, as TRADES's KL
# gradient does once the clean and adversarial predictions nearly agree,
# the CPU's own float32 step lies far from float64 too.)  An accuracy is held to the CPU float32's within one sample.  At most
# SIGN_FLIP_FRAC of the entries of an inner update and of the free delta
# differ from the CPU float32's (a sign() of an input gradient within
# float32 noise of zero may flip), and a parameter update differs from it by
# more than 1e-3 lr only where the first moment lies within the first
# moment's limit of zero: AdamW's update is about lr * sign(mu) wherever
# |mu| is well above its eps, so only such an entry may take the other sign.
OBJ_REL_TOL, FLOAT32_FACTOR, SIGN_FLIP_FRAC = 1e-4, 10.0, 1e-3
OBJECTIVES = {
    "pgd-at": dict(attack_steps=3),
    "pgd-at-train_bn-augment": dict(attack_steps=3, train_bn=True, aug_pad=4, aug_flip=True,
                                    aug_cutout=8),
    "trades": dict(attack_steps=3, train_bn=True, aug_pad=4, aug_flip=True),
    "mart": dict(attack_steps=3, train_bn=True),
    "free": dict(free_replays=1, train_bn=True),
    "ibp": dict(ibp_ramp_steps=1),
    "crown-ibp": dict(ibp_ramp_steps=1, ibp_bound="crown"),
}


def _objective_pair(device, name, cfg, dtype=torch.float32):
    """(step, state) of ``name`` on ``device`` from seeded weights held in
    ``dtype``, and a float32 batch."""
    import dataclasses

    from image_recognition_adversarial_example_attack_tpu_torch.models import load_model, zoo
    from image_recognition_adversarial_example_attack_tpu_torch.models.wideresnet import wrn_tiny
    from image_recognition_adversarial_example_attack_tpu_torch.train import adversarial

    g = torch.Generator().manual_seed(3)
    x = torch.rand((8, 32, 32, 3), generator=g).to(device)
    y = torch.randint(0, 10, (8,), generator=g).to(device)
    if "ibp" in name:
        bundle = load_model("ibp_tiny", dtype=torch.float32, device=device)
    else:
        model = zoo.random_init_(wrn_tiny()).requires_grad_(False).eval()
        bundle = zoo.ModelBundle(name="wrn_tiny", model=model.to(device), source="random",
                                 dtype=torch.float32, device=device, input_size=32,
                                 mean=zoo.model_meta("wrn_tiny")["mean"].copy(),
                                 std=zoo.model_meta("wrn_tiny")["std"].copy())
    bundle.model.to(dtype)
    bundle = dataclasses.replace(bundle, dtype=dtype)
    state = adversarial.train_state_from_bundle(bundle, cfg)
    if "ibp" in name:
        return adversarial.make_ibp_step(cfg, bundle.model.spec, bundle.mean,
                                         bundle.std), state, x, y
    make = {"trades": adversarial.make_trades_step, "mart": adversarial.make_mart_step,
            "free": adversarial.make_free_step}.get(name, adversarial.make_train_step)
    return make(cfg, bundle.mean, bundle.std), state, x, y


# A ReLU input this close to zero may fall on either side in float32 (the
# card's sums and the CPU's round differently): there the CPU replays take
# the card's side, as they take its PGD iterates; a side that differs
# farther out fails.  One such input in a TRADES step moves the first
# moment 1e-4-5e-4 of its scale (scripts/trades_relu_tie.py).
RELU_TIE = 1e-5

# kernel names that fingerprint cuDNN's and cuBLAS's choice of algorithm
FINGERPRINT_KEYS = ("conv", "gemm", "cudnn", "cutlass", "xmma", "wgrad", "dgrad", "sm80_",
                    "sm90_")


def card_fingerprint(step, args, checked) -> dict:
    """The conv and GEMM kernel names ``torch.profiler`` sees in a replay of
    card step ``step(*args)`` (the same state and draws; none where the
    profiler records no device activity), and how far the replay's first
    moment lies from the checked step's ``checked`` (its largest entry).
    The checked step itself runs outside the profiler."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        new = step(*args)[0]
        torch.cuda.synchronize()
    names = sorted({e.name for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and any(k in e.name.lower() for k in FINGERPRINT_KEYS)})
    replay = max(float((new.opt_state.mu[k] - v).abs().max())
                 for k, v in checked.opt_state.mu.items())
    return {"kernels": names, "replay_mu": replay}


def objective_steps(cuda, name, monkeypatch, card_cfg=None, steps=2, check=True,
                    profile=True):
    """Two steps of objective ``name`` on the card (float32), each replayed
    on the CPU in float32 and float64 with the card's draws and PGD
    iterates; ``card_cfg`` changes the card's configuration alone (a planted
    fault, read with ``check=False``).  Every check but the first moment's
    band is made here.  The CPU replays also take the card's side of every
    ReLU whose input lies within ``RELU_TIE`` of zero (``relu_ties``: how
    many, and the largest such input, in the float32 and float64 replays).
    Returns per step (card state, CPU float32 state, CPU
    float64 first moment, readings), the readings with the card's free
    memory just after the step and, with ``profile``, the fingerprint of
    the step's profiled replay (``card_fingerprint``; else ``kernels`` and
    ``replay_mu`` are None, and no profiler runs)."""
    from image_recognition_adversarial_example_attack_tpu_torch.attacks import pgd
    from image_recognition_adversarial_example_attack_tpu_torch.core.rng import chunk_generator
    from image_recognition_adversarial_example_attack_tpu_torch.train import adversarial
    from image_recognition_adversarial_example_attack_tpu_torch.train.optim import AdamState

    cfg = adversarial.AdvTrainConfig(**OBJECTIVES[name])
    cfg_g = adversarial.AdvTrainConfig(**{**OBJECTIVES[name], **(card_cfg or {})})
    cpu = torch.device("cpu")
    tape, flips = [], []
    real = {"pgd_step": ew.pgd_step, "draw_start": pgd.draw_start,
            "draw_trades_start": adversarial.draw_trades_start}
    homes = {"pgd_step": ew, "draw_start": pgd, "draw_trades_start": adversarial}

    def recorded(key):
        def fn(*a):
            out = real[key](*a)
            tape.append(out.detach().clone())
            return out
        return fn

    def replayed(key, at, count_flips):
        def fn(*a):
            card = tape[at[0]].cpu()
            at[0] += 1
            if count_flips and key == "pgd_step":  # the CPU's own update, same iterate
                flips.append(float((real[key](*a) != card).float().mean()))
            return card
        return fn

    real_relu = F.relu
    sides = []  # the card's ReLU sides (input > 0), call by call

    def card_relu(v, inplace=False):
        sides.append((v > 0).cpu())
        return real_relu(v, inplace=inplace)

    def replayed_relu(at, ties):
        def fn(v, inplace=False):
            card = sides[at[0]]
            at[0] += 1
            part = (v > 0) != card
            if bool(part.any()):
                ties.append(float(v.detach()[part].abs().max()))
            return v * card.to(v.dtype)
        return fn

    def run(step, args, wrap, relu):
        for key, home in homes.items():
            monkeypatch.setattr(home, key, wrap(key))
        monkeypatch.setattr(F, "relu", relu)
        try:
            return step(*args)
        finally:
            monkeypatch.setattr(F, "relu", real_relu)
            for key, home in homes.items():
                monkeypatch.setattr(home, key, real[key])

    def moved_to(template, st):
        dt = next(iter(template.params.values())).dtype
        to = lambda t: {k: v.to(cpu, dt) for k, v in t.items()}  # noqa: E731
        return template.replace(
            params=to(st.params), extra_variables=to(st.extra_variables), step=st.step,
            opt_state=AdamState(st.opt_state.count, to(st.opt_state.mu), to(st.opt_state.nu)))

    def err(a, b):
        return max(float((a[k].to(cpu, torch.float64) - v).abs().max()) for k, v in b.items())

    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    out = []
    try:
        step_g, state_g, x, y = _objective_pair(cuda, name, cfg_g)
        step_c, tmpl_c, _, _ = _objective_pair(cpu, name, cfg)
        step_d, tmpl_d, _, _ = _objective_pair(cpu, name, cfg, torch.float64)
        delta = torch.zeros_like(x)
        for s in range(steps):
            extra = (delta,) if name == "free" else ()
            tape.clear()
            sides.clear()
            out_g = run(step_g, (state_g, x, y, chunk_generator(0, "train:0", s), *extra),
                        recorded, card_relu)
            torch.cuda.synchronize()
            fingerprint = {"free_gib": torch.cuda.mem_get_info()[0] / 2**30, "kernels": None,
                           "replay_mu": None}
            if profile:
                fingerprint.update(card_fingerprint(
                    step_g, (state_g, x, y, chunk_generator(0, "train:0", s), *extra), out_g[0]))
            ties = {"float32": [], "float64": []}
            at, at_relu = [0], [0]
            out_c = run(step_c, (moved_to(tmpl_c, state_g), x.cpu(), y.cpu(),
                                 chunk_generator(0, "train:0", s), *(e.cpu() for e in extra)),
                        lambda key: replayed(key, at, True),
                        replayed_relu(at_relu, ties["float32"]))
            assert at[0] == len(tape), f"step {s}: {len(tape) - at[0]} card draws not replayed"
            assert at_relu[0] == len(sides), f"step {s}: {len(sides) - at_relu[0]} ReLUs left"
            at, at_relu = [0], [0]
            monkeypatch.setattr(adversarial, "LOSS_DTYPE", torch.float64)
            out_d = run(step_d, (moved_to(tmpl_d, state_g), x.cpu(), y.cpu(),
                                 chunk_generator(0, "train:0", s), *(e.cpu() for e in extra)),
                        lambda key: replayed(key, at, False),
                        replayed_relu(at_relu, ties["float64"]))
            monkeypatch.setattr(adversarial, "LOSS_DTYPE", torch.float32)
            assert at_relu[0] == len(sides), f"step {s}: {len(sides) - at_relu[0]} ReLUs left"
            relu_ties = {k: (len(v), max(v, default=0.0)) for k, v in ties.items()}
            assert not check or max(m for _, m in relu_ties.values()) <= RELU_TIE, (
                f"step {s}: a ReLU input off zero on the other side from the card's: "
                f"{relu_ties} (calls with one, largest input)")
            (new_g, m_g), (new_c, m_c), (new_d, m_d) = out_g[:2], out_c[:2], out_d[:2]
            assert set(m_g) == set(m_c) == set(m_d)
            for k in m_d if check else ():
                a, b, want = float(m_g[k]), float(m_c[k]), float(m_d[k])
                if "accuracy" in k:
                    assert abs(a - b) <= 1.0 / x.shape[0] + 1e-6, (s, k, a, b)
                    continue
                tol = max(OBJ_REL_TOL * abs(want), FLOAT32_FACTOR * abs(b - want)) + 1e-7
                assert abs(a - want) <= tol, (s, k, a, b, want)
            mu_d = new_d.opt_state.mu
            readings = {"mu_card": err(new_g.opt_state.mu, mu_d),
                        "mu_cpu": err(new_c.opt_state.mu, mu_d),
                        "mu_card_cpu": err(new_g.opt_state.mu, new_c.opt_state.mu),
                        "mu_scale": max(float(v.abs().max()) for v in mu_d.values()),
                        "relu_ties": relu_ties, **fingerprint}
            if name == "free":
                assert not check or float((out_g[2].cpu() != out_c[2]).float().mean()
                                          ) <= SIGN_FLIP_FRAC
                delta = out_g[2]
            out.append((new_g, new_c, mu_d, readings))
            state_g = new_g
        assert not check or max(flips, default=0.0) <= SIGN_FLIP_FRAC
        want = {"pgd-at": 6, "pgd-at-train_bn-augment": 6, "trades": 6, "mart": 6}.get(name, 0)
        assert len(flips) == want
        assert state_g.step == steps and all(p.is_cuda for p in state_g.params.values())
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
    return out


def mu_band(readings: dict) -> float:
    """The first moment's band around float64: OBJ_REL_TOL of its scale or
    FLOAT32_FACTOR times the CPU float32's own distance."""
    return max(OBJ_REL_TOL * readings["mu_scale"], FLOAT32_FACTOR * readings["mu_cpu"])


@pytest.mark.parametrize("name", sorted(OBJECTIVES))
def test_every_objective_on_the_card_matches_the_cpu(cuda, name, monkeypatch):
    from image_recognition_adversarial_example_attack_tpu_torch.train import adversarial

    lr = adversarial.AdvTrainConfig(**OBJECTIVES[name]).learning_rate
    for s, (new_g, new_c, mu_d, readings) in enumerate(objective_steps(cuda, name, monkeypatch)):
        band = mu_band(readings)
        print(f"{name} step {s}: first moment, card {readings['mu_card']:.3e} and CPU float32 "
              f"{readings['mu_cpu']:.3e} from float64; band {band:.3e} "
              f"(scale {readings['mu_scale']:.3e})")
        assert readings["mu_card"] <= band, (
            f"{name} step {s}: first moment {readings['mu_card']:.3e} from float64, band "
            f"{band:.3e} (scale {readings['mu_scale']:.3e}, CPU float32 "
            f"{readings['mu_cpu']:.3e}, the card {readings['mu_card_cpu']:.3e} from the CPU "
            f"float32; ReLU ties taken the card's way {readings['relu_ties']}); fingerprint: {readings['free_gib']:.2f} GiB free after "
            f"the step; a profiled replay of it {readings['replay_mu']:.3e} from its first "
            f"moment, kernels {readings['kernels'] or 'none recorded'}")
        for k, v in new_c.params.items():
            differ = (new_g.params[k].cpu() - v).abs() > 1e-3 * lr
            assert bool((mu_d[k][differ].abs() <= band).all()), (s, k)
