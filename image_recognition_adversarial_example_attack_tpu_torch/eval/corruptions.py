"""Common-corruption bank, ImageNet-C family (port of ``eval/corruptions.py``;
Hendrycks & Dietterich, ICLR 2019).

Seventeen batch transforms of a ``[B,H,W,C]`` float32 batch in [0,1], with
the JAX module's severity tables and registry order: the 15 ImageNet-C
corruptions but frost and spatter (asset-dependent), plus speckle_noise,
gaussian_blur and saturate of the "extra" set.  The JAX module's docstring
lists where the bank departs from ImageNet-C's host implementation.

The randomness is split from the arithmetic.  Each stochastic corruption
(the four noises, motion_blur, glass_blur, snow, fog, elastic_transform) has
a draw function, fed by a ``torch.Generator`` on the batch's device
(``core.rng.device_generator``), and an arithmetic function that takes the
draws; ``apply_corruption(..., draws=...)`` takes draws made elsewhere, so
the tests feed JAX's draws through the port's arithmetic.

Held to the JAX module on its draws:

- ``map_coordinates`` is ``jax.scipy.ndimage.map_coordinates`` with
  ``mode="nearest"`` vmapped over images and channels: order 0 rounds half
  away from zero (``torch.round`` rounds half to even), order 1 takes
  ``floor`` and the weights ``(1 - f, f)``, indices are clamped to
  ``[0, n-1]``, and the products are summed in ``itertools.product`` order;
- the depthwise convolutions are cross-correlations on an edge-padded
  input; per-image kernels (motion_blur, snow) are one grouped conv with
  ``groups = B*C``.  They run in full float32: on a CUDA tensor they refuse
  to run while TF32 is allowed (``core.device.require_full_float32``);
- fog's ``jax.image.resize(..., "linear")`` is
  ``defenses.randomization.weight_matrix`` along each axis;
- ``jnp.std`` is the population std, ``jnp.round`` (glass_blur) rounds half
  to even, as ``torch.round`` does;
- elastic_transform blurs and normalizes its displacement field in float64,
  where JAX stays in float32: the normalization divides by the field's std
  (~0.01 at 224x224), which magnifies float32 rounding enough to make the
  card and the CPU disagree by 3e-5;
- a division by a constant has a tensor divisor: PyTorch divides a CUDA
  tensor by a Python scalar as a multiplication by its reciprocal.
"""

from __future__ import annotations

import itertools
import math
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from ..core.device import require_full_float32
from ..core.rng import device_generator
from ..defenses.jpeg_dct import jpeg_dct_roundtrip
from ..defenses.randomization import weight_matrix

Draws = tuple[torch.Tensor, ...]

# ---------------------------------------------------------------------------
# helpers


def _c(v: float, like: torch.Tensor) -> torch.Tensor:
    """``v`` as a 0-d tensor of ``like``'s dtype and device (a divisor)."""
    return torch.full((), v, dtype=like.dtype, device=like.device)


def _luminance(x: torch.Tensor) -> torch.Tensor:
    """[B,H,W,C] -> [B,H,W,1] Rec.601 luma (mean for non-RGB channel counts)."""
    if x.shape[-1] == 3:
        w = torch.tensor([0.299, 0.587, 0.114], dtype=x.dtype, device=x.device)
        return torch.sum(x * w, dim=-1, keepdim=True)
    return torch.mean(x, dim=-1, keepdim=True)


def _conv_nhwc(x: torch.Tensor, weight: torch.Tensor, groups: int) -> torch.Tensor:
    """Edge-padded 'valid' cross-correlation of NHWC ``x`` with an OIHW
    ``weight`` of odd kh, kw."""
    require_full_float32(x, "the corruption bank's convolutions")
    kh, kw = weight.shape[-2:]
    xp = F.pad(x.permute(0, 3, 1, 2), (kw // 2, kw // 2, kh // 2, kh // 2), mode="replicate")
    return F.conv2d(xp, weight.to(x.dtype), groups=groups).permute(0, 2, 3, 1)


def _depthwise2d(x: torch.Tensor, k2d: torch.Tensor) -> torch.Tensor:
    """Depthwise 2-D convolution with edge padding: ``x`` [B,H,W,C], ``k2d``
    [kh,kw] shared across channels."""
    c = x.shape[-1]
    return _conv_nhwc(x, k2d.expand(c, 1, *k2d.shape), groups=c)


def _depthwise2d_per_image(x: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """Per-image kernels: ``x`` [B,H,W,C], ``kernels`` [B,kh,kw]; one grouped
    conv over the B*C planes."""
    b, h, w, c = x.shape
    planes = x.permute(1, 2, 0, 3).reshape(1, h, w, b * c)
    weight = kernels[:, None, None].expand(b, c, 1, *kernels.shape[1:])
    out = _conv_nhwc(planes, weight.reshape(b * c, 1, *kernels.shape[1:]), groups=b * c)
    return out.reshape(h, w, b, c).permute(2, 0, 1, 3)


def _gauss1d(sigma: torch.Tensor, radius: int) -> torch.Tensor:
    """The normalized Gaussian taps in ``sigma``'s dtype."""
    t = torch.arange(-radius, radius + 1, dtype=sigma.dtype, device=sigma.device)
    k = torch.exp(-0.5 * torch.square(t / torch.clamp_min(sigma, 1e-3)))
    return k / torch.sum(k)


def _gauss_blur(x: torch.Tensor, sigma: torch.Tensor, radius: int) -> torch.Tensor:
    """Separable Gaussian blur in ``x``'s dtype; ``sigma`` a 0-d tensor,
    ``radius`` static."""
    k = _gauss1d(sigma.to(x.dtype), radius)
    x = _depthwise2d(x, k[:, None])
    return _depthwise2d(x, k[None, :])


def _round_half_away_from_zero(a: torch.Tensor) -> torch.Tensor:
    """``lax.round``'s default rounding: ``a - trunc(a)`` is exact, so the
    tie test is too."""
    t = torch.trunc(a)
    return torch.where(torch.abs(a - t) >= 0.5, t + torch.sign(a), t)


def map_coordinates(x: torch.Tensor, rr: torch.Tensor, cc: torch.Tensor,
                    order: int = 1) -> torch.Tensor:
    """Sample ``x`` [B,H,W,C] at row/col coordinate maps ``rr``, ``cc`` of
    shape [H',W'] (shared) or [B,H',W'] (per image) -> [B,H',W',C].

    ``jax.scipy.ndimage.map_coordinates(order, mode="nearest")`` on each
    image and channel (the JAX module's ``_resample``)."""
    b, h, w, _ = x.shape
    if order == 0:
        def nodes(coord):
            return [(_round_half_away_from_zero(coord).to(torch.int64), None)]
    elif order == 1:
        def nodes(coord):
            lower = torch.floor(coord)
            upper_weight = coord - lower
            index = lower.to(torch.int64)
            return [(index, 1 - upper_weight), (index + 1, upper_weight)]
    else:
        raise NotImplementedError("map_coordinates takes order 0 or 1")
    bi = torch.arange(b, device=x.device)[:, None, None]
    out = None
    for (ri, wr), (ci, wc) in itertools.product(nodes(rr), nodes(cc)):
        v = x[bi, ri.clamp(0, h - 1), ci.clamp(0, w - 1)]
        term = v if order == 0 else (wr * wc)[..., None] * v
        out = term if out is None else out + term
    return out


def _grid(h: int, w: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    return torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                          torch.arange(w, dtype=torch.float32, device=device), indexing="ij")


def _zoom_coords(h: int, w: int, factor: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Center-anchored zoom-in sampling coordinates."""
    rr, cc = _grid(h, w, factor.device)
    cr, ccn = (h - 1) / 2.0, (w - 1) / 2.0
    f = torch.clamp_min(factor.to(torch.float32), 1e-3)
    return cr + (rr - cr) / f, ccn + (cc - ccn) / f


def _clip01(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 1.0)


def _uniform(shape, lo, hi, g: torch.Generator) -> torch.Tensor:
    """float32 Uniform[lo, hi) on the generator's device."""
    u = torch.rand(tuple(shape), generator=g, dtype=torch.float32, device=g.device)
    return u * (hi - lo) + lo


def _normal(shape, g: torch.Generator) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=g, dtype=torch.float32, device=g.device)


# ---------------------------------------------------------------------------
# corruptions: fn(x, row, *draws); row = the severity's constants; draw(x,
# row, generator) -> draws for the stochastic ones

_GAUSSIAN_NOISE = [[0.08], [0.12], [0.18], [0.26], [0.38]]


def _draw_normal(x, row, g):
    return (_normal(x.shape, g),)


def _c_gaussian_noise(x, row, noise):
    return _clip01(x + row[0] * noise)


_SHOT_NOISE = [[60.0], [25.0], [12.0], [5.0], [3.0]]


def _draw_shot_noise(x, row, g):
    return (torch.poisson(x * row[0], generator=g),)


def _c_shot_noise(x, row, counts):
    return _clip01(counts.to(x.dtype) / row[0])


_IMPULSE_NOISE = [[0.03], [0.06], [0.09], [0.17], [0.27]]


def _draw_impulse_noise(x, row, g):
    return (_uniform(x.shape, 0.0, 1.0, g),)


def _c_impulse_noise(x, row, u):
    p = row[0]
    x = torch.where(u < p / 2, 0.0, x)
    return torch.where(u > 1.0 - p / 2, 1.0, x)


_SPECKLE_NOISE = [[0.15], [0.20], [0.35], [0.45], [0.60]]


def _c_speckle_noise(x, row, noise):
    return _clip01(x + x * row[0] * noise)


_GAUSSIAN_BLUR = [[1.0], [2.0], [3.0], [4.0], [6.0]]
_GAUSS_BLUR_RADIUS = 12  # static grid covering 2*sigma_max


def _c_gaussian_blur(x, row):
    return _clip01(_gauss_blur(x, row[0], _GAUSS_BLUR_RADIUS))


# (disk radius px, edge softness px) — ImageNet-C pairs (radius, alias blur)
_DEFOCUS_BLUR = [[3.0, 0.1], [4.0, 0.5], [6.0, 0.5], [8.0, 0.5], [10.0, 0.5]]
_DEFOCUS_RADIUS = 10


def _c_defocus_blur(x, row):
    r = _DEFOCUS_RADIUS
    yy, xx = _grid(2 * r + 1, 2 * r + 1, x.device)
    dist = torch.sqrt(torch.square(yy - r) + torch.square(xx - r))
    edge = torch.clamp_min(row[1] * 2.0, 0.5)
    disk = torch.clamp((row[0] + 0.5 - dist) / edge, 0.0, 1.0)
    disk = disk / torch.sum(disk)
    return _clip01(_depthwise2d(x, disk))


# (line length px, along-line Gaussian sigma) — angle ~ U(-45°, 45°) per image
_MOTION_BLUR = [[10.0, 3.0], [15.0, 5.0], [15.0, 8.0], [15.0, 12.0], [20.0, 15.0]]
_MOTION_RADIUS = 20


def _line_kernel(length, sigma_par, theta: torch.Tensor, radius: int) -> torch.Tensor:
    """Gaussian-profiled line kernels [B, 2r+1, 2r+1], one per angle of
    ``theta`` [B]."""
    yy, xx = _grid(2 * radius + 1, 2 * radius + 1, theta.device)
    yy, xx = yy - radius, xx - radius
    cos, sin = torch.cos(theta)[:, None, None], torch.sin(theta)[:, None, None]
    d_par = xx * cos + yy * sin
    d_perp = -xx * sin + yy * cos
    profile = torch.exp(-0.5 * torch.square(d_par / torch.clamp_min(sigma_par, 1e-3)))
    mask = torch.clamp(length / 2.0 + 0.5 - torch.abs(d_par), 0.0, 1.0)
    width = torch.exp(-0.5 * torch.square(d_perp / _c(0.7, d_perp)))
    k = profile * mask * width
    return k / torch.clamp_min(torch.sum(k, dim=(1, 2), keepdim=True), 1e-8)


def _draw_motion_blur(x, row, g):
    return (_uniform((x.shape[0],), -math.pi / 4, math.pi / 4, g),)


def _c_motion_blur(x, row, theta):
    kernels = _line_kernel(row[0], row[1], theta, _MOTION_RADIUS)
    return _clip01(_depthwise2d_per_image(x, kernels))


_ZOOM_BLUR = [[1.11], [1.16], [1.21], [1.26], [1.31]]
_ZOOM_STEPS = 10


def _c_zoom_blur(x, row):
    h, w = x.shape[1], x.shape[2]
    acc = torch.zeros_like(x)
    for i in range(_ZOOM_STEPS):
        f = 1.0 + (i / (_ZOOM_STEPS - 1)) * (row[0] - 1.0)
        rr, cc = _zoom_coords(h, w, f)
        acc = acc + map_coordinates(x, rr, cc, order=1)
    return _clip01(acc / _c(_ZOOM_STEPS, acc))


# (pre-blur sigma, jitter radius px) — two vectorized jitter passes
_GLASS_BLUR = [[0.7, 1.0], [0.9, 2.0], [1.0, 2.0], [1.1, 3.0], [1.5, 4.0]]


def _draw_glass_blur(x, row, g):
    """(dr, dc) of the first pass, then of the second, each [B,H,W] in
    [-row[1], row[1])."""
    shape = (x.shape[0], x.shape[1], x.shape[2])
    return tuple(_uniform(shape, -row[1], row[1], g) for _ in range(4))


def _c_glass_blur(x, row, dr0, dc0, dr1, dc1):
    h, w = x.shape[1], x.shape[2]
    x = _gauss_blur(x, row[0], 4)
    rr, cc = _grid(h, w, x.device)
    for dr, dc in ((dr0, dc0), (dr1, dc1)):
        x = map_coordinates(x, rr[None] + torch.round(dr), cc[None] + torch.round(dc), order=0)
    return _clip01(_gauss_blur(x, row[0] / 2.0, 4))


# (layer mean, layer std, zoom, threshold, streak length, whiten mix)
_SNOW = [[0.1, 0.3, 1.25, 0.50, 8.0, 0.70],
         [0.2, 0.3, 1.35, 0.55, 10.0, 0.65],
         [0.55, 0.3, 1.50, 0.55, 12.0, 0.57],
         [0.55, 0.3, 1.75, 0.60, 14.0, 0.55],
         [0.55, 0.3, 2.00, 0.65, 16.0, 0.50]]


def _draw_snow(x, row, g):
    """(the flake layer's normals [B,H,W,1], the streak angles [B])."""
    b, h, w = x.shape[0], x.shape[1], x.shape[2]
    return (_normal((b, h, w, 1), g), _uniform((b,), -3 * math.pi / 4, -math.pi / 4, g))


def _c_snow(x, row, noise, theta):
    h, w = x.shape[1], x.shape[2]
    layer = row[0] + row[1] * noise
    rr, cc = _zoom_coords(h, w, row[2])
    layer = map_coordinates(layer, rr, cc, order=1)
    layer = torch.where(layer < row[3], 0.0, layer)
    # streaks: motion-blur the flake field steeply downward (-45°..-135°)
    kernels = _line_kernel(row[4], row[4] / 2.0, theta, _MOTION_RADIUS)
    layer = torch.clamp(_depthwise2d_per_image(layer, kernels), 0.0, 1.0)
    gray = _luminance(x)
    whitened = row[5] * x + (1.0 - row[5]) * torch.maximum(x, gray * 1.5 + 0.5)
    return _clip01(whitened + layer + torch.flip(layer, dims=(1, 2)))


# (fog amount, octave decay) — plasma approximated by octave noise
_FOG = [[1.5, 2.0], [2.0, 2.0], [2.5, 1.7], [2.5, 1.5], [3.0, 1.4]]


def _fog_octaves(h: int, w: int) -> int:
    return max(1, int(np.log2(max(min(h, w) // 4, 1))) + 1)


def _draw_fog(x, row, g):
    """One [B,s,s] uniform field per octave, s = 4, 8, 16, ..."""
    b, h, w = x.shape[0], x.shape[1], x.shape[2]
    return tuple(_uniform((b, 4 * 2 ** o, 4 * 2 ** o), 0.0, 1.0, g)
                 for o in range(_fog_octaves(h, w)))


def _resize_linear(u: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``jax.image.resize(u, (B, h, w), "linear")`` of ``u`` [B,s,t]: a
    weight matrix per axis that changes size, the rows first."""
    one = torch.ones(1, dtype=u.dtype, device=u.device)
    zero = torch.zeros(1, dtype=u.dtype, device=u.device)
    s, t = u.shape[1], u.shape[2]
    if s != h:
        u = torch.einsum("bsw,hs->bhw", u, weight_matrix(s, h, one * (h / s), zero)[0])
    if t != w:
        u = torch.einsum("bht,wt->bhw", u, weight_matrix(t, w, one * (w / t), zero)[0])
    return u


def _c_fog(x, row, *fields):
    b, h, w = x.shape[0], x.shape[1], x.shape[2]
    plasma = torch.zeros((b, h, w), dtype=x.dtype, device=x.device)
    for o, u in enumerate(fields):
        require_full_float32(u, "the corruption bank's resampling")
        u = _resize_linear(u, h, w)
        plasma = plasma + u * torch.pow(row[1], -_c(float(o), row))
    lo = torch.amin(plasma, dim=(1, 2), keepdim=True)
    hi = torch.amax(plasma, dim=(1, 2), keepdim=True)
    plasma = (plasma - lo) / torch.clamp_min(hi - lo, 1e-8)
    max_val = torch.amax(x, dim=(1, 2, 3), keepdim=True)
    fogged = x + row[0] * plasma[..., None]
    return _clip01(fogged * max_val / (max_val + row[0]))


_BRIGHTNESS = [[0.1], [0.2], [0.3], [0.4], [0.5]]


def _c_brightness(x, row):
    return _clip01(x + row[0])


_CONTRAST = [[0.4], [0.3], [0.2], [0.1], [0.05]]


def _c_contrast(x, row):
    mean = torch.mean(x, dim=(1, 2), keepdim=True)
    return _clip01((x - mean) * row[0] + mean)


# (gray-axis scale, value offset) — severities 1-2 desaturate, 3-5 oversaturate
# (the ImageNet-C "saturate" severity schedule is deliberately non-monotone)
_SATURATE = [[0.3, 0.0], [0.1, 0.0], [2.0, 0.0], [5.0, 0.1], [20.0, 0.2]]


def _c_saturate(x, row):
    gray = _luminance(x)
    return _clip01(gray + row[0] * (x - gray) + row[1])


# (displacement amplitude px, field smoothness as fraction of min(H,W))
_ELASTIC = [[1.5, 0.080], [3.0, 0.065], [5.0, 0.050], [7.0, 0.040], [10.0, 0.035]]


def _draw_elastic_transform(x, row, g):
    b, h, w = x.shape[0], x.shape[1], x.shape[2]
    return (_uniform((b, h, w, 2), -1.0, 1.0, g),)


def _c_elastic_transform(x, row, d):
    h, w = x.shape[1], x.shape[2]
    radius = max(3, min(h, w) // 8)  # static blur support for the field
    # the field is blurred and normalized in float64 (JAX: float32): its std
    # is ~0.01 at 224x224, so the division magnifies a float32 sum's rounding
    # a hundredfold, and two summation orders (card, CPU) moved the output
    # by up to 3e-5
    d = _gauss_blur(d.to(torch.float64), row[1].to(torch.float64) * min(h, w), radius)
    std = torch.std(d, dim=(1, 2), keepdim=True, correction=0)
    d = (d / torch.clamp_min(std, 1e-8) * row[0]).to(torch.float32)
    rr, cc = _grid(h, w, x.device)
    return map_coordinates(x, rr[None] + d[..., 0], cc[None] + d[..., 1], order=1)


_PIXELATE = [[0.6], [0.5], [0.4], [0.3], [0.25]]


def _c_pixelate(x, row):
    h, w = x.shape[1], x.shape[2]
    block = 1.0 / torch.clamp_min(row[0], 1e-3)
    rr, cc = _grid(h, w, x.device)
    rr = (torch.floor(rr / block) + 0.5) * block
    cc = (torch.floor(cc / block) + 0.5) * block
    return map_coordinates(x, rr, cc, order=0)


_JPEG = [[25.0], [18.0], [15.0], [10.0], [7.0]]


def _c_jpeg_compression(x, row):
    if x.shape[-1] != 3:
        raise ValueError("jpeg_compression requires RGB inputs")
    return jpeg_dct_roundtrip(x, quality=row[0])


# ---------------------------------------------------------------------------
# registry / dispatch: name -> (fn, severity table, draw function or None)

_REGISTRY: dict[str, tuple[Callable, np.ndarray, Callable | None]] = {
    "gaussian_noise": (_c_gaussian_noise, np.asarray(_GAUSSIAN_NOISE), _draw_normal),
    "shot_noise": (_c_shot_noise, np.asarray(_SHOT_NOISE), _draw_shot_noise),
    "impulse_noise": (_c_impulse_noise, np.asarray(_IMPULSE_NOISE), _draw_impulse_noise),
    "defocus_blur": (_c_defocus_blur, np.asarray(_DEFOCUS_BLUR), None),
    "glass_blur": (_c_glass_blur, np.asarray(_GLASS_BLUR), _draw_glass_blur),
    "motion_blur": (_c_motion_blur, np.asarray(_MOTION_BLUR), _draw_motion_blur),
    "zoom_blur": (_c_zoom_blur, np.asarray(_ZOOM_BLUR), None),
    "snow": (_c_snow, np.asarray(_SNOW), _draw_snow),
    "fog": (_c_fog, np.asarray(_FOG), _draw_fog),
    "brightness": (_c_brightness, np.asarray(_BRIGHTNESS), None),
    "contrast": (_c_contrast, np.asarray(_CONTRAST), None),
    "elastic_transform": (_c_elastic_transform, np.asarray(_ELASTIC), _draw_elastic_transform),
    "pixelate": (_c_pixelate, np.asarray(_PIXELATE), None),
    "jpeg_compression": (_c_jpeg_compression, np.asarray(_JPEG), None),
    # ImageNet-C "extra" set
    "speckle_noise": (_c_speckle_noise, np.asarray(_SPECKLE_NOISE), _draw_normal),
    "gaussian_blur": (_c_gaussian_blur, np.asarray(_GAUSSIAN_BLUR), None),
    "saturate": (_c_saturate, np.asarray(_SATURATE), None),
}

CORRUPTION_NAMES: tuple[str, ...] = tuple(_REGISTRY)

#: corruptions whose output is a deterministic function of (x, severity)
DETERMINISTIC: frozenset[str] = frozenset(n for n, e in _REGISTRY.items() if e[2] is None)


def _entry(name: str):
    if name not in _REGISTRY:
        raise KeyError(f"unknown corruption {name!r}; choose from {CORRUPTION_NAMES}")
    return _REGISTRY[name]


def severity_row(name: str, severity, device=None) -> torch.Tensor:
    """The float32 row of per-severity constants on ``device``; ``severity``
    is clamped to 1..5."""
    table = _entry(name)[1]
    idx = min(max(int(severity), 1), 5) - 1
    return torch.tensor(table[idx], dtype=torch.float32, device=device)


def draw_corruption(name: str, x: torch.Tensor, severity,
                    generator: torch.Generator) -> Draws:
    """The random draws of a stochastic corruption on ``x`` (float32
    [B,H,W,C]) at ``severity``, made on ``x``'s device
    (``device_generator(generator, x.device)``); () for a deterministic
    one."""
    draw = _entry(name)[2]
    if draw is None:
        return ()
    x = x.to(torch.float32)
    return draw(x, severity_row(name, severity, x.device), device_generator(generator, x.device))


def apply_corruption(name: str, x: torch.Tensor, severity,
                     generator: torch.Generator | None = None,
                     draws: Draws | None = None) -> torch.Tensor:
    """Corrupt a [B,H,W,C] batch in [0,1] at ``severity`` (1..5).

    A stochastic corruption takes ``draws`` when given (``draw_corruption``'s
    layout), else draws them from ``generator``; without either it raises
    ValueError.  A deterministic one ignores both."""
    fn, _, draw = _entry(name)
    x = x.to(torch.float32)
    row = severity_row(name, severity, x.device)
    if draw is None:
        return fn(x, row)
    if draws is None:
        if generator is None:
            raise ValueError(f"corruption {name!r} is stochastic: pass a generator")
        draws = draw(x, row, device_generator(generator, x.device))
    return fn(x, row, *draws)


def make_corruption_run(logits_fn, name: str):
    """``run(x, y, severity, generator) -> bool[B]``: the correctness mask
    of the model's top-1 under the corruption."""

    def run(x, y, severity, generator=None):
        with torch.no_grad():
            xc = apply_corruption(name, x, severity, generator)
            return torch.argmax(logits_fn(xc), dim=-1) == y

    return run
