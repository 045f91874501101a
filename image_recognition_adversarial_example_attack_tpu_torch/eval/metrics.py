"""Perturbation quality metrics (port of ``eval/metrics.py``), as torch ops on
the tensors' device.

The reference's seven metrics (visualized_attacks.py:228-262):

- L-inf, L2 and L1 norms of the perturbation over the whole batch;
- SSIM (Gaussian 11x11 window, sigma 1.5, k1 0.01, k2 0.03, data range 1,
  the torchmetrics defaults);
- PSNR = 20 log10(1 / sqrt(MSE));
- the share of perturbed values (|delta| > 1/255), in percent;
- the high-frequency ratio: the share of FFT bins of image 0 above the
  mean magnitude, in percent.

Plus ECE (expected calibration error) from probabilities or from per-sample
(confidence, correctness) vectors.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F


@contextlib.contextmanager
def _no_tf32():
    """SSIM is E[x^2] - E[x]^2 after the Gaussian filter, a difference that
    cancels: its filter must run in full float32 (the JAX package forces
    ``Precision.HIGHEST`` for the same reason).  PyTorch lets cuDNN run
    float32 convolutions in TF32 by default, and a caller of the metrics may
    never have loaded a model (``load_model`` turns TF32 off), so the filter
    turns it off for itself."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """The normalized 2-D Gaussian window, built in float32 as JAX's is."""
    coords = torch.arange(size, dtype=torch.float32) - (size - 1) / 2.0
    g = torch.exp(-(coords ** 2) / (2.0 * sigma ** 2))
    g = g / torch.sum(g)
    return torch.outer(g, g)


def _filter2d_per_channel(x: torch.Tensor, kernel2d: torch.Tensor) -> torch.Tensor:
    """Depthwise VALID 2-D filter of an NHWC batch."""
    c = x.shape[-1]
    weight = kernel2d.to(device=x.device, dtype=x.dtype)[None, None].repeat(c, 1, 1, 1)
    with _no_tf32():
        out = F.conv2d(x.permute(0, 3, 1, 2), weight, groups=c)
    return out.permute(0, 2, 3, 1)


def ssim_per_sample(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0,
                    kernel_size: int = 11, sigma: float = 1.5, k1: float = 0.01,
                    k2: float = 0.03) -> torch.Tensor:
    """Per-sample SSIM of an NHWC pair -> [B]."""
    kernel = _gaussian_kernel(kernel_size, sigma)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    mu_a = _filter2d_per_channel(a, kernel)
    mu_b = _filter2d_per_channel(b, kernel)
    sigma_aa = _filter2d_per_channel(a * a, kernel) - mu_a * mu_a
    sigma_bb = _filter2d_per_channel(b * b, kernel) - mu_b * mu_b
    sigma_ab = _filter2d_per_channel(a * b, kernel) - mu_a * mu_b
    num = (2 * mu_a * mu_b + c1) * (2 * sigma_ab + c2)
    den = (mu_a * mu_a + mu_b * mu_b + c1) * (sigma_aa + sigma_bb + c2)
    return torch.mean((num / den).reshape(a.shape[0], -1), dim=-1)


def ssim(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0, kernel_size: int = 11,
         sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """Mean SSIM of an NHWC pair (0-d): the batch mean of
    ``ssim_per_sample`` (every sample's map has the same size)."""
    return torch.mean(ssim_per_sample(a, b, data_range=data_range, kernel_size=kernel_size,
                                      sigma=sigma, k1=k1, k2=k2))


def psnr(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """PSNR in dB; 100 where the MSE is at most 1e-10."""
    mse = torch.mean(torch.square(a - b))
    value = 20.0 * np.log10(data_range) - 10.0 * torch.log10(mse)
    return torch.where(mse > 1e-10, value, torch.full_like(value, 100.0))


def high_freq_ratio(diff: torch.Tensor) -> torch.Tensor:
    """% of the FFT bins of image 0 (over H and W, per channel) whose
    magnitude is above the mean magnitude."""
    mag = torch.abs(torch.fft.fft2(diff[0], dim=(0, 1)))
    return torch.mean((mag > torch.mean(mag)).to(torch.float32)) * 100.0


def attack_metrics(x_clean: torch.Tensor, x_adv: torch.Tensor) -> dict[str, torch.Tensor]:
    """The reference's seven metrics of an NHWC pair, keys verbatim, as 0-d
    tensors on the pair's device."""
    diff = x_adv - x_clean
    return {
        "L∞ (pixel)": torch.amax(torch.abs(diff)),
        "L2": torch.sqrt(torch.sum(torch.square(diff))),
        "L1": torch.sum(torch.abs(diff)),
        "SSIM": ssim(x_clean, x_adv),
        "PSNR": psnr(x_clean, x_adv),
        "Perturbed Pixels %": torch.mean((torch.abs(diff) > 1.0 / 255.0).to(torch.float32))
        * 100.0,
        "High Freq Ratio %": high_freq_ratio(diff),
    }


def metrics_to_python(metrics: dict) -> dict[str, float]:
    return {k: float(v) for k, v in metrics.items()}


def ece_from_conf_correct(conf: torch.Tensor, correct: torch.Tensor,
                          n_bins: int = 15) -> torch.Tensor:
    """ECE from per-sample confidence and correctness, equal-width bins (a
    confidence of 1.0 lands in the last bin), each bin's gap weighted by its
    share of the samples."""
    conf = torch.as_tensor(conf).to(torch.float32)
    correct = torch.as_tensor(correct).to(torch.float32)
    idx = torch.clamp((conf * n_bins).to(torch.int64), max=n_bins - 1)
    onehot = F.one_hot(idx, n_bins).to(torch.float32)  # [B, n_bins]
    count = torch.sum(onehot, dim=0)
    acc_sum = correct @ onehot
    conf_sum = conf @ onehot
    gap = torch.abs(acc_sum - conf_sum) / torch.clamp(count, min=1.0)
    return torch.sum(gap * count) / torch.clamp(torch.sum(count), min=1.0)


def expected_calibration_error(probs: torch.Tensor, labels: torch.Tensor,
                               n_bins: int = 15) -> torch.Tensor:
    """ECE (Guo et al. 2017) of [B,K] softmax outputs against [B] labels, a
    0-d tensor in [0, 1]."""
    conf = torch.amax(probs, dim=-1)
    correct = (torch.argmax(probs, dim=-1) == labels).to(torch.float32)
    return ece_from_conf_correct(conf, correct, n_bins=n_bins)
