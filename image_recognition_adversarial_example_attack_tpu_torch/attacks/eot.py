"""EOT: expectation over transformation (Athalye et al., ICML 2018; port of
``gaussian_noise_transform`` and ``make_eot_logits_fn`` of ``attacks/eot.py``).

``make_eot_logits_fn`` wraps a logits function so that every call averages
the softmax over ``n_samples`` random transforms of its input, one [n*B]
forward: an attack on the wrapped function attacks the expected loss under
the transforms, the standard way to break randomized defenses.  With the
default Gaussian-noise transform it is a Monte-Carlo estimate of the
randomized-smoothing classifier.  Autograd runs through the average.

The draws are a function of the wrapper's seed and of the input, as in the
JAX package, where the key is ``fold_in(key, mix)`` with ``mix`` the
wrapping int32 sum of the input's float32 bits: successive attack iterates
(different x) see fresh draws, and the same x the same ones.  Here a
generator on the input's device is seeded from (seed, mix) (``input_mix``,
``call_generator``), which reads ``mix`` from the card: one host read per
wrapped call, the only one.

``universal_perturbation`` is one shared [H,W,C] delta maximizing the mean
cross-entropy over a batch: the full-batch form of ``attacks/uap.py``'s
trainer, ``steps`` epochs of one batch each.
"""

from __future__ import annotations

import hashlib
from typing import Callable

import torch

from ..core.rng import seed_draw, standard_normal
from .api import LogitsFn
from .uap import uap_attack

# transform: (generator, x [B,H,W,C]) -> x' [B,H,W,C]
TransformFn = Callable[[torch.Generator, torch.Tensor], torch.Tensor]


def draw_noise(shape, generator: torch.Generator, device: torch.device | str) -> torch.Tensor:
    """One transform's N(0, 1) draw, float32 of ``shape`` on ``device``."""
    return standard_normal(shape, generator, device)


def gaussian_noise_transform(sigma: float) -> TransformFn:
    """The randomized-smoothing transform: x + N(0, sigma^2), unclipped."""

    def transform(generator, x):
        return x + sigma * draw_noise(x.shape, generator, x.device).to(x.dtype)

    return transform


def input_mix(x01: torch.Tensor) -> torch.Tensor:
    """The wrapping int32 sum of the float32 bits of ``x01`` (a 0-d int32
    tensor on its device), JAX's ``jnp.sum(bitcast(x.astype(f32), int32))``:
    torch sums int32 into int64, so the sum is wrapped back to int32 here."""
    bits = x01.detach().to(torch.float32).contiguous().view(torch.int32)
    total = torch.sum(bits, dtype=torch.int64)
    return (torch.remainder(total + 2**31, 2**32) - 2**31).to(torch.int32)


def call_generator(seed: int, mix: int, device: torch.device | str) -> torch.Generator:
    """The generator of one wrapped call, on ``device``: seeded with the first
    63 bits of SHA-256 of ``"<seed>|<mix>"``, the counterpart of
    ``fold_in(key, mix)``."""
    digest = hashlib.sha256(f"{int(seed)}|{int(mix)}".encode()).digest()
    g = torch.Generator(device=device)
    g.manual_seed(int.from_bytes(digest[:8], "big") >> 1)
    return g


def make_eot_logits_fn(logits_fn: LogitsFn, generator: torch.Generator, n_samples: int = 8,
                       transform: TransformFn | None = None, sigma: float = 0.25) -> LogitsFn:
    """Wrap ``logits_fn`` so each call returns log(mean softmax) over
    ``n_samples`` random transforms: a drop-in logits function for any
    attack of the zoo (the log of the smoothed classifier's class
    probabilities).  The wrapper's seed is one draw of ``generator``."""
    if transform is None:
        transform = gaussian_noise_transform(sigma)
    seed = seed_draw(generator)
    n = int(n_samples)

    def eot_fn(x01: torch.Tensor) -> torch.Tensor:
        b = x01.shape[0]
        g = call_generator(seed, int(input_mix(x01)), x01.device)  # the host read
        stacked = torch.cat([transform(g, x01) for _ in range(n)], dim=0)  # one [n*B] forward
        probs = torch.softmax(logits_fn(stacked), dim=-1)
        probs = probs.reshape(n, b, -1).mean(dim=0)
        return torch.log(torch.clamp_min(probs, 1e-12))

    return eot_fn


def universal_perturbation(logits_fn: LogitsFn, x: torch.Tensor, y_true: torch.Tensor, *,
                           eps: float, alpha: float, steps: int, generator: torch.Generator,
                           random_start: bool = True) -> torch.Tensor:
    """One L∞-bounded delta [H,W,C] fooling as much of the batch as it can:
    sign-gradient ascent on the batch-mean cross-entropy of ``x + delta``.
    Returns the delta (add it to any [0,1] image and clip); ``steps``
    full-batch updates are ``steps`` one-batch epochs of ``uap_attack``."""
    return uap_attack(logits_fn, x, y_true, eps=eps, alpha=alpha, epochs=steps,
                      generator=generator, random_start=random_start).delta
