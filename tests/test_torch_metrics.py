"""The port's perturbation metrics and ECE (eval/metrics.py) against the JAX
package's on the same float32 inputs (CPU).

Tolerances: SSIM 1e-5 (E[x^2] - E[x]^2 after a depthwise filter, summed in
another order).  The norms within 1e-6 relative and PSNR within 1e-4 dB of
the float64 values of the same float32 difference, and all three within
1e-12 of JAX's in float64.  (XLA's float32 reduction on the CPU drifts by
up to 1.2e-5 relative on an fgsm-like pair, whose squares are all equal, so
the two float32 readings are not held to each other.)  The perturbed-pixel
share and the high-frequency ratio count the same elements exactly; their
percentages may differ in the last bit, as XLA computes ``jnp.mean`` as a
product with the rounded reciprocal of n.  ECE: the same bins exactly, the
value within 2**-23 (64 confidences summed in float32 in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import module_time_limit, one_thread, time_limit  # noqa: F401 (autouse)
from image_recognition_adversarial_example_attack_tpu.eval import metrics as jax_metrics
from image_recognition_adversarial_example_attack_tpu_torch.eval import metrics

NORMS = ("L∞ (pixel)", "L2", "L1")


def _pair(kind: str, shape=(2, 40, 48, 3), seed=0):
    rs = np.random.RandomState(seed)
    x = rs.uniform(0, 1, shape).astype(np.float32)
    if kind == "same":
        return x, x.copy()
    if kind == "sign":  # an fgsm-like step of 8/255
        step = np.float32(8 / 255) * np.sign(rs.randn(*shape)).astype(np.float32)
        return x, np.clip(x + step, 0, 1).astype(np.float32)
    if kind == "small":  # a cw-like perturbation, mostly under 1/255
        return x, np.clip(x + rs.randn(*shape).astype(np.float32) * 0.003, 0, 1)
    return x, rs.uniform(0, 1, shape).astype(np.float32)  # "unrelated"


@pytest.mark.parametrize("kind", ["same", "sign", "small", "unrelated"])
def test_attack_metrics_match_jax(kind):
    a, b = _pair(kind)
    want = jax_metrics.metrics_to_python(jax_metrics.attack_metrics(jnp.asarray(a),
                                                                    jnp.asarray(b)))
    got = metrics.metrics_to_python(metrics.attack_metrics(torch.from_numpy(a),
                                                           torch.from_numpy(b)))
    assert list(got) == list(want)  # the reference's seven keys, in order
    d = (b - a).astype(np.float64)
    exact = {"L∞ (pixel)": np.abs(d).max(), "L2": np.sqrt(np.sum(d * d)), "L1": np.abs(d).sum()}
    for k in NORMS:
        assert got[k] == pytest.approx(exact[k], rel=1e-6, abs=0), k
    assert got["L∞ (pixel)"] == want["L∞ (pixel)"]
    assert abs(got["SSIM"] - want["SSIM"]) <= 1e-5
    assert 0.0 <= got["SSIM"] <= 1.0 + 1e-6
    mse = np.mean(d * d)
    assert abs(got["PSNR"] - (-10 * np.log10(mse) if mse > 1e-10 else 100.0)) <= 1e-4
    for k, n in (("Perturbed Pixels %", d.size), ("High Freq Ratio %", d[0].size)):
        assert round(got[k] * n / 100) == round(want[k] * n / 100), k
        np.testing.assert_array_max_ulp(np.float32(got[k]), np.float32(want[k]), maxulp=1)
    if kind == "same":
        assert got["PSNR"] == 100.0 and got["SSIM"] == pytest.approx(1.0, abs=1e-6)


@pytest.mark.parametrize("kind", ["sign", "small"])
def test_float64_metrics_match_jax(kind):
    """In float64 the norms and PSNR agree to 1e-12 relative.  SSIM to
    1e-8: both packages build the Gaussian window in float32, and JAX's
    float32 sum of its 11 weights is one ulp below the correctly rounded
    sum the port's gives, so the windows differ by up to 3 ulps."""
    a, b = (v.astype(np.float64) for v in _pair(kind, seed=2))
    with jax.enable_x64():
        want = jax_metrics.metrics_to_python(jax_metrics.attack_metrics(jnp.asarray(a),
                                                                        jnp.asarray(b)))
    got = metrics.metrics_to_python(metrics.attack_metrics(torch.from_numpy(a),
                                                           torch.from_numpy(b)))
    for k in (*NORMS, "PSNR"):
        assert got[k] == pytest.approx(want[k], rel=1e-12, abs=0), k
    assert abs(got["SSIM"] - want["SSIM"]) <= 1e-8
    np.testing.assert_array_max_ulp(metrics._gaussian_kernel().numpy(),
                                    np.asarray(jax_metrics._gaussian_kernel()), maxulp=3)


@pytest.mark.parametrize("kind", ["sign", "small", "unrelated"])
def test_ssim_per_sample_matches_jax(kind):
    a, b = _pair(kind, shape=(3, 23, 17, 3), seed=1)
    want = np.asarray(jax_metrics.ssim_per_sample(jnp.asarray(a), jnp.asarray(b)))
    got = metrics.ssim_per_sample(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.shape == (3,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert float(metrics.ssim(torch.from_numpy(a), torch.from_numpy(b))) == pytest.approx(
        float(np.mean(got)), abs=1e-7)


@pytest.mark.parametrize("n_bins", [15, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_ece_matches_jax(n_bins, seed):
    rs = np.random.RandomState(seed)
    logits = (rs.randn(64, 10) * 3).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    labels = rs.randint(0, 10, 64)
    labels[:20] = probs[:20].argmax(-1)
    probs[0] = 0.0
    probs[0, labels[0]] = 1.0  # confidence 1.0 lands in the last bin
    want = float(jax_metrics.expected_calibration_error(jnp.asarray(probs), jnp.asarray(labels),
                                                        n_bins=n_bins))
    got = float(metrics.expected_calibration_error(torch.from_numpy(probs),
                                                   torch.from_numpy(labels), n_bins=n_bins))
    assert 0.0 <= got <= 1.0 and abs(got - want) <= 2.0 ** -23
    conf, correct = probs.max(-1), (probs.argmax(-1) == labels).astype(np.float32)
    got = float(metrics.ece_from_conf_correct(torch.from_numpy(conf), torch.from_numpy(correct),
                                              n_bins=n_bins))
    assert abs(got - want) <= 2.0 ** -23
    # the bins agree exactly: each sample alone gives the same ECE
    for i in range(0, 64, 7):
        one = [float(m.ece_from_conf_correct(to(conf[i:i + 1]), to(correct[i:i + 1]),
                                             n_bins=n_bins))
               for m, to in ((metrics, torch.from_numpy), (jax_metrics, jnp.asarray))]
        assert one[0] == one[1]
