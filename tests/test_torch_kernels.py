"""The port's kernel wrappers on the CPU: their plain versions against the
JAX package's Pallas kernels (interpret mode) and jnp references.

pgd_step and quantize are bit-exact; the noise is held to its distribution
(its bits cannot match the TPU's PRNG).  The CUDA kernels themselves run in
tests/test_torch_cuda.py on a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import module_time_limit, one_thread, time_limit  # noqa: F401 (autouse)
from image_recognition_adversarial_example_attack_tpu.attacks.pgd import pgd_step as jax_pgd_step
from image_recognition_adversarial_example_attack_tpu.defenses.preprocess import (
    defense_quantization as jax_defense_quantization)
from image_recognition_adversarial_example_attack_tpu.ops import pgd_step_pallas, quantize_pallas
from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed
from image_recognition_adversarial_example_attack_tpu_torch.kernels import build
from image_recognition_adversarial_example_attack_tpu_torch.kernels import elementwise as ew

EPS, ALPHA = 8 / 255, 2 / 255


def _data(shape, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(*shape).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    g.reshape(-1)[::5] = 0.0  # sign(0) = 0
    x0 = rng.rand(*shape).astype(np.float32)
    return x, g, x0


@pytest.mark.parametrize("shape", [(2, 16, 16, 3), (3, 7, 5, 3)])
@pytest.mark.parametrize("targeted", [False, True])
def test_pgd_step_plain_is_bit_exact(shape, targeted):
    """(3,7,5,3) is not a multiple of 128: the Pallas pad/unpad path."""
    x, g, x0 = _data(shape)
    direction = -1.0 if targeted else 1.0
    g_j = jnp.asarray(g) * direction  # the JAX attack steps along sign(direction*g)
    want_ref = np.asarray(jax_pgd_step(jnp.asarray(x), g_j, jnp.asarray(x0), EPS, ALPHA))
    want_pallas = np.asarray(pgd_step_pallas(jnp.asarray(x), g_j, jnp.asarray(x0),
                                             EPS, ALPHA, interpret=True))
    t = [torch.from_numpy(a) for a in (x, g, x0)]
    alpha = -ALPHA if targeted else ALPHA  # the port passes -alpha instead
    plain = ew.pgd_step_plain(*t, EPS, alpha).numpy()
    wrapped = ew.pgd_step(*t, EPS, alpha).numpy()
    np.testing.assert_array_equal(plain, want_ref)
    np.testing.assert_array_equal(plain, want_pallas)
    np.testing.assert_array_equal(wrapped, plain)


def test_quantize_plain_is_bit_exact_with_ties():
    rng = np.random.RandomState(1)
    x = rng.uniform(-0.2, 1.2, size=(4, 9, 11, 3)).astype(np.float32)
    flat = x.reshape(-1)
    flat[::3] = ((np.arange(flat[::3].size) % 15) + 0.5) / 15  # exact .5 ties
    ties = np.sum(np.float32(np.clip(x, 0, 1)) * np.float32(15) % 1 == 0.5)
    assert ties > 0
    want_pallas = np.asarray(quantize_pallas(jnp.asarray(x), 16, interpret=True))
    want_ref = np.asarray(jax_defense_quantization(jnp.asarray(x), 16))
    plain = ew.quantize_plain(torch.from_numpy(x), 16).numpy()
    np.testing.assert_array_equal(plain, want_pallas)
    np.testing.assert_array_equal(plain, want_ref)
    np.testing.assert_array_equal(ew.quantize(torch.from_numpy(x), 16).numpy(), plain)
    # half to even: 1.5/15 -> 2/15 and 2.5/15 -> 2/15
    assert set(np.round(plain[(np.abs(x * 15 - 1.5) < 1e-6)] * 15).tolist()) <= {2.0}


@pytest.mark.parametrize("levels", [2, 8, 256])
def test_quantize_plain_levels(levels):
    x = np.linspace(-0.1, 1.1, 1001, dtype=np.float32)
    want = np.asarray(quantize_pallas(jnp.asarray(x), levels, interpret=True))
    np.testing.assert_array_equal(ew.quantize_plain(torch.from_numpy(x), levels).numpy(), want)


def test_noise_plain_distribution():
    shape = (4, 64, 64, 3)
    a = ew.uniform_noise(shape, EPS, generator_from_seed(1), "cpu").double()
    b = ew.uniform_noise(shape, EPS, generator_from_seed(2), "cpu").double()
    again = ew.uniform_noise(shape, EPS, generator_from_seed(1), "cpu").double()
    eps32 = float(np.float32(EPS))
    assert a.shape == shape
    assert float(a.min()) >= -eps32 and float(a.max()) <= eps32
    n = a.numel()
    assert abs(float(a.mean())) < 5 * EPS / np.sqrt(3 * n)
    assert abs(float(a.var()) / (EPS ** 2 / 3) - 1) < 0.03
    assert abs(float(torch.corrcoef(torch.stack([a.reshape(-1), b.reshape(-1)]))[0, 1])) < 5 / np.sqrt(n)
    assert torch.equal(a, again)


def test_wrappers_check_shapes_and_count_only_launches():
    x, g, x0 = (torch.from_numpy(a) for a in _data((2, 4, 4, 3)))
    with pytest.raises(ValueError, match="shapes differ"):
        ew.pgd_step(x, g[:1], x0, EPS, ALPHA)
    ew.reset_launches()
    ew.pgd_step(x, g, x0, EPS, ALPHA)
    ew.quantize(x, 16)
    ew.uniform_noise(x.shape, EPS, generator_from_seed(0), "cpu")
    # the plain versions ran: no kernel launch is counted
    assert ew.launch_counts() == {"pgd_step": 0, "quantize": 0, "uniform_noise": 0}


def test_build_targets_sm90a_without_fast_math(tmp_path):
    src = build.CSRC_DIR / "elementwise.cu"
    cmd = build.nvcc_command("nvcc", src, tmp_path / "lib.so")
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    assert not any("fast_math" in c or "fast-math" in c for c in cmd)
    lib = build.library_path(src)
    assert lib.parent == build.BUILD_DIR and lib.name.startswith("libelementwise_")
    text = src.read_text()
    for name in build.ELEMENTWISE_SIGNATURES:
        assert f"int {name}(" in text  # every declared launcher exists
    assert "rintf" in text and "roundf" not in text


def test_build_dir_is_the_checkouts_or_a_user_cache(tmp_path, monkeypatch):
    assert build.BUILD_DIR == build.PACKAGE_DIR.parent / "build" / "torch_kernels"
    installed = tmp_path / "site-packages" / build.PACKAGE_DIR.name
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert build.default_build_dir(installed) == (
        tmp_path / "cache" / build.PACKAGE_DIR.name / "torch_kernels")
    monkeypatch.delenv("XDG_CACHE_HOME")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert build.default_build_dir(installed) == (
        tmp_path / "home" / ".cache" / build.PACKAGE_DIR.name / "torch_kernels")
