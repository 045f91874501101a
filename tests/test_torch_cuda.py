"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: each test skips (with its reason) where no CUDA device is
present.  Run them on a machine with an H100:

    python -m pytest tests/test_torch_cuda.py -m cuda
"""

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
