"""Randomized smoothing: certified L2 robustness through Gaussian noise
(Cohen, Rosenfeld & Kolter, ICML 2019; port of ``defenses/smoothing.py``).

The smoothed classifier g(x) = argmax_c P(f(x + N(0, sigma^2 I)) = c) is
certifiably constant within the L2 radius R = sigma * Phi^-1(p_lower)
around x wherever the top class's lower confidence bound p_lower exceeds
1/2.

The Monte-Carlo votes are the hot path: per chunk one [chunk, B, H, W, C]
noise draw (``draw_noise``), unclipped as in the original, one [chunk*B]
forward, its argmax, and one-hot vote sums in int32 on the device.  Only
the [B, K] counts reach the host, once per slice of ``max_batch`` images,
where scipy's Clopper-Pearson bound (``beta.ppf``), exact binomial test
and ``norm.ppf`` run.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..attacks.api import LogitsFn
from ..core.rng import standard_normal

ABSTAIN = -1


@dataclass(frozen=True)
class SmoothingConfig:
    """Configuration of the smoothed classifier.

    sigma     -- Gaussian noise scale in [0,1] pixel units.
    n0        -- selection samples (certify's class guess).
    n         -- estimation samples (the certified bound's sample size).
    chunk     -- noisy copies per forward; n0 and n round UP to full chunks
                 (more samples never weaken the bound).
    alpha     -- failure probability of the certificate / abstention test.
    max_batch -- images per counts call; each chunk's forward is
                 [chunk * min(B, max_batch)] images, and larger inputs go
                 through in zero-padded slices of max_batch.
    """

    sigma: float = 0.25
    n0: int = 32
    n: int = 512
    chunk: int = 32
    alpha: float = 0.001
    max_batch: int = 4


def _n_chunks(n: int, chunk: int) -> int:
    return max(1, -(-int(n) // int(chunk)))


def draw_noise(shape, generator: torch.Generator, device: torch.device | str) -> torch.Tensor:
    """One chunk's N(0, 1) noise, float32 of ``shape`` ``[chunk, B, ...]``
    on ``device``."""
    return standard_normal(shape, generator, device, axis=1)


def make_counts_fn(logits_fn: LogitsFn, chunk: int):
    """``counts(x, generator, sigma, n_chunks) -> [B, K] int32`` votes.

    Each of the ``n_chunks`` rounds draws [chunk, B, H, W, C] noise, scales
    it by ``sigma`` (a plain argument: one function serves a whole sigma
    sweep), evaluates the base classifier on the flattened [chunk*B] batch
    and adds its one-hot argmax votes.  The function carries its ``chunk``
    so that a classifier can check it against its config."""

    def counts(x: torch.Tensor, generator: torch.Generator, sigma: float,
               n_chunks: int) -> torch.Tensor:
        b = x.shape[0]
        acc = None
        with torch.no_grad():
            for _ in range(int(n_chunks)):
                noise = sigma * draw_noise((chunk,) + tuple(x.shape), generator,
                                           x.device).to(dtype=x.dtype)
                noisy = (x[None] + noise).reshape((chunk * b,) + tuple(x.shape[1:]))
                logits = logits_fn(noisy)
                preds = torch.argmax(logits, dim=-1).reshape(chunk, b)
                votes = F.one_hot(preds, logits.shape[-1]).sum(dim=0).to(torch.int32)
                acc = votes if acc is None else acc + votes
        return acc

    counts.chunk = int(chunk)
    return counts


def _binom_p_lower(successes: int, trials: int, alpha: float) -> float:
    """One-sided (1 - alpha) Clopper-Pearson lower confidence bound."""
    from scipy.stats import beta

    if successes == 0:
        return 0.0
    return float(beta.ppf(alpha, successes, trials - successes + 1))


def _binom_two_sided_p(k: int, n: int) -> float:
    """Two-sided exact binomial test p-value against p = 0.5."""
    from scipy.stats import binomtest

    return float(binomtest(k, n, 0.5).pvalue)


class SmoothedClassifier:
    """Cohen et al.'s PREDICT / CERTIFY over the Monte-Carlo votes."""

    def __init__(self, logits_fn: LogitsFn, config: SmoothingConfig = SmoothingConfig(),
                 counts_fn=None):
        """``counts_fn`` lets several classifiers (a sigma sweep) share one
        voting function, built by ``make_counts_fn``.  Its chunk must equal
        ``config.chunk``: the statistics count ``n_chunks * chunk`` votes
        from the config, and another chunk would draw another number."""
        self.config = config
        if counts_fn is not None:
            fn_chunk = getattr(counts_fn, "chunk", None)
            if fn_chunk is not None and int(fn_chunk) != int(config.chunk):
                raise ValueError(
                    f"counts_fn was built with chunk={fn_chunk} but the "
                    f"config says chunk={config.chunk}; the certificate's "
                    "vote count would be wrong")
        self._counts = counts_fn or make_counts_fn(logits_fn, config.chunk)

    def _sample(self, x: torch.Tensor, generator: torch.Generator, n: int) -> np.ndarray:
        """Vote counts of every image, in slices of ``max_batch`` images (the
        tail slice zero-padded to the same shape, its padded rows dropped)."""
        n_chunks = _n_chunks(n, self.config.chunk)
        b = x.shape[0]
        mb = max(1, min(int(self.config.max_batch), b))
        out = []
        for i in range(0, b, mb):
            part = x[i:i + mb]
            valid = part.shape[0]
            if valid < mb:
                pad = torch.zeros((mb - valid,) + tuple(x.shape[1:]), dtype=x.dtype,
                                  device=x.device)
                part = torch.cat([part, pad], dim=0)
            counts = self._counts(part, generator, float(self.config.sigma), n_chunks)
            out.append(counts.cpu().numpy()[:valid])
        return np.concatenate(out, axis=0)

    def predict(self, x: torch.Tensor, generator: torch.Generator) -> np.ndarray:
        """PREDICT (the paper's algorithm 2): [B,H,W,C] -> [B] classes,
        ABSTAIN where the top-two vote split is not significant at alpha."""
        counts = self._sample(x, generator, self.config.n)
        out = np.full((counts.shape[0],), ABSTAIN, np.int64)
        for i, row in enumerate(counts):
            top2 = np.argsort(-row)[:2]
            na, nb = int(row[top2[0]]), int(row[top2[1]])
            if na + nb > 0 and _binom_two_sided_p(na, na + nb) <= self.config.alpha:
                out[i] = int(top2[0])
        return out

    def certify(self, x: torch.Tensor, generator: torch.Generator
                ) -> tuple[np.ndarray, np.ndarray]:
        """CERTIFY (the paper's algorithm 1): [B,H,W,C] -> ([B] classes,
        [B] L2 radii); an abstention has class ABSTAIN and radius 0.  The
        class guess takes n0 samples, the bound n further ones (their
        independence makes the certificate valid)."""
        counts0 = self._sample(x, generator, self.config.n0)
        counts = self._sample(x, generator, self.config.n)
        return self.certify_counts(counts0, counts)

    def certify_counts(self, counts0: np.ndarray, counts: np.ndarray
                       ) -> tuple[np.ndarray, np.ndarray]:
        """CERTIFY's host statistics on given selection and estimation
        votes."""
        from scipy.stats import norm

        n_total = _n_chunks(self.config.n, self.config.chunk) * self.config.chunk
        classes = np.full((counts.shape[0],), ABSTAIN, np.int64)
        radii = np.zeros((counts.shape[0],), np.float64)
        for i in range(counts.shape[0]):
            c_hat = int(np.argmax(counts0[i]))
            p_lower = _binom_p_lower(int(counts[i, c_hat]), n_total, self.config.alpha)
            if p_lower > 0.5:
                classes[i] = c_hat
                radii[i] = self.config.sigma * float(norm.ppf(p_lower))
        return classes, radii
