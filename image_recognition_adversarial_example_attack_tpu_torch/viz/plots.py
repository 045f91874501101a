"""The defense grid's figures (port of ``plot_defense_heatmaps`` and
``plot_attack_samples`` of ``viz/plots.py``), drawn with PIL alone.

The contract with the JAX package is the file names and the plotted values,
not the styling:

- ``<prefix>_attack_trend.png``: attack success rate against eps, one line
  per attack, colored by the attack's identity;
- ``<prefix>_defense_matrix.png``: heatmaps (eps rows x attack columns) of
  the preprocessing defense's accuracy (green ramp), the detector's flag
  rate (blue) and the bypass rate (orange), each cell annotated with its
  rate to 3 decimals;
- ``attack_samples.png``: one row per sample, clean / adversarial /
  defended image and the perturbation's magnitude (magma ramp).

PIL, because the CUDA machines the port runs on need not have matplotlib;
Pillow is there already for the image pipeline.  Nothing here touches the
device: every input is host numpy (NHWC, [0,1]) or host ints.
"""

from __future__ import annotations

from pathlib import Path
from typing import Mapping, Sequence

import numpy as np
from PIL import Image, ImageDraw, ImageFont

# Color and marker follow the attack's identity, never the plot order (the
# JAX package's house style); another attack is gray with a diamond.
_ATTACK_STYLE = {"FGSM": ("#2a78d6", "o"), "PGD": ("#eb6834", "s"), "CW": ("#1baf7a", "^")}
_OTHER_STYLE = ("#6e6d69", "d")

# Sequential single-hue ramps, one per metric (matplotlib's Greens, Blues,
# Oranges and magma, sampled at a few stops and interpolated linearly).
_RAMPS = {
    "Greens": ["#f7fcf5", "#c7e9c0", "#74c476", "#238b45", "#00441b"],
    "Blues": ["#f7fbff", "#c6dbef", "#6baed6", "#2171b5", "#08306b"],
    "Oranges": ["#fff5eb", "#fdd0a2", "#fd8d3c", "#d94801", "#7f2704"],
    "magma": ["#000004", "#3b0f70", "#8c2981", "#de4968", "#fe9f6d", "#fcfdbf"],
}
# (column name, panel title, ramp) of the defense matrix's three panels
MATRIX_PANELS = (
    ("Preproc_Defense_Acc", "Preprocessing defense accuracy", "Greens"),
    ("Detector_Adv_Flag", "Detector flag rate", "Blues"),
    ("Bypass_Detection", "Bypass detection success rate", "Oranges"),
)
_WHITE, _INK, _GRID, _MISSING = (255, 255, 255), (30, 30, 30), (200, 200, 200), (235, 235, 235)


def _hex(c: str) -> tuple[int, int, int]:
    return tuple(int(c[i:i + 2], 16) for i in (1, 3, 5))


def ramp(values, name: str) -> np.ndarray:
    """Values in [0, 1] -> uint8 RGB of the named ramp, [..., 3]."""
    stops = np.asarray([_hex(c) for c in _RAMPS[name]], np.float64)
    v = np.clip(np.nan_to_num(np.asarray(values, np.float64)), 0.0, 1.0)
    pos = v * (len(stops) - 1)
    lo = np.minimum(np.floor(pos).astype(int), len(stops) - 2)
    frac = (pos - lo)[..., None]
    return np.round(stops[lo] * (1 - frac) + stops[lo + 1] * frac).astype(np.uint8)


def _font(size: int):
    try:
        return ImageFont.load_default(size=size)
    except TypeError:  # Pillow before 10.1: the fixed bitmap font
        return ImageFont.load_default()


def _text(draw: ImageDraw.ImageDraw, xy, text: str, font, fill=_INK,
          align: str = "center") -> None:
    """Text centered vertically on ``xy``, one line per newline; ``align``
    places each line's center, left or right end at ``xy``'s x.  Positions
    come from the measured text, so the bitmap font works too."""
    lines = text.split("\n")
    height = draw.textbbox((0, 0), "Ag", font=font)[3] + 4
    x, y = xy
    top = y - height * len(lines) / 2
    for i, line in enumerate(lines):
        width = draw.textlength(line, font=font)
        left = {"center": x - width / 2, "left": x, "right": x - width}[align]
        draw.text((left, top + i * height), line, font=font, fill=fill)


def _vertical_text(img: Image.Image, center, text: str, font) -> None:
    """Text rotated by 90 degrees, centered on ``center``."""
    box = ImageDraw.Draw(img).textbbox((0, 0), text, font=font)
    tile = Image.new("RGB", (box[2] + 8, box[3] + 8), _WHITE)
    ImageDraw.Draw(tile).text((4, 4), text, font=font, fill=_INK)
    tile = tile.rotate(90, expand=True)
    img.paste(tile, (int(center[0] - tile.width / 2), int(center[1] - tile.height / 2)))


def _marker(draw: ImageDraw.ImageDraw, x: float, y: float, kind: str, color, r: int = 9):
    if kind == "s":
        draw.rectangle((x - r, y - r, x + r, y + r), fill=color)
    elif kind == "^":
        draw.polygon([(x, y - r - 2), (x - r - 1, y + r), (x + r + 1, y + r)], fill=color)
    elif kind == "o":
        draw.ellipse((x - r, y - r, x + r, y + r), fill=color)
    else:  # "d": a diamond
        draw.polygon([(x, y - r - 2), (x + r + 2, y), (x, y + r + 2), (x - r - 2, y)],
                     fill=color)


def defense_rates(results: Mapping[tuple[str, float], Mapping[str, int]]) -> list[dict]:
    """One row of rates per (attack, eps) cell, sorted by attack then eps:
    the values the figures plot."""
    rows = []
    for (attack_name, eps), stats in results.items():
        count = max(1, stats["count"])
        rows.append({
            "Attack": attack_name.upper(),
            "Eps": float(eps),
            "Attack_Success": stats["attack_success"] / count,
            "Preproc_Defense_Acc": stats["defense_preproc_success"] / count,
            "Detector_Clean_Pass": 1.0 - stats["detector_flags_clean"] / count,
            "Detector_Adv_Flag": stats["detector_flags_adv"] / count,
            "Bypass_Detection": stats["detector_attack_success"] / count,
        })
    return sorted(rows, key=lambda r: (r["Attack"], r["Eps"]))


def pivot(rows: list[dict], metric: str) -> tuple[list[float], list[str], np.ndarray]:
    """(eps ascending, attacks sorted, [n_eps, n_attacks] values, NaN where
    the grid has no cell): the heatmap's table."""
    eps = sorted({r["Eps"] for r in rows})
    attacks = sorted({r["Attack"] for r in rows})
    table = np.full((len(eps), len(attacks)), np.nan)
    for r in rows:
        table[eps.index(r["Eps"]), attacks.index(r["Attack"])] = r[metric]
    return eps, attacks, table


def _plot_trend(rows: list[dict], path: Path) -> None:
    w, h = 1600, 800
    left, right, top, bottom = 130, 300, 90, 120
    img = Image.new("RGB", (w, h), _WHITE)
    draw = ImageDraw.Draw(img)
    f_title, f_label, f_tick = _font(30), _font(22), _font(18)
    x0, x1, y0, y1 = left, w - right, top, h - bottom
    eps_all = sorted({r["Eps"] for r in rows})
    lo, hi = eps_all[0], eps_all[-1]
    pad = (hi - lo) * 0.05 if hi > lo else max(abs(lo) * 0.5, 1e-3)
    lo, hi = lo - pad, hi + pad

    def px(e: float) -> float:
        return x0 + (e - lo) / (hi - lo) * (x1 - x0)

    def py(v: float) -> float:
        return y1 - v * (y1 - y0)

    for i in range(6):  # y grid and ticks at 0, 0.2, ..., 1.0
        v = i / 5
        draw.line((x0, py(v), x1, py(v)), fill=_GRID, width=1)
        _text(draw, (x0 - 12, py(v)), f"{v:.1f}", f_tick, align="right")
    for e in eps_all:
        draw.line((px(e), y0, px(e), y1), fill=_GRID, width=1)
        _text(draw, (px(e), y1 + 22), f"{e:.4f}", f_tick)
    draw.rectangle((x0, y0, x1, y1), outline=_INK, width=2)

    attacks = list(dict.fromkeys(r["Attack"] for r in rows))
    for k, attack in enumerate(attacks):
        pts = [(px(r["Eps"]), py(r["Attack_Success"])) for r in rows if r["Attack"] == attack]
        hex_color, kind = _ATTACK_STYLE.get(attack, _OTHER_STYLE)
        color = _hex(hex_color)
        if len(pts) > 1:
            draw.line(pts, fill=color, width=4, joint="curve")
        for x, y in pts:
            _marker(draw, x, y, kind, color)
        ly = y0 + 20 + 40 * k  # legend, right of the axes
        draw.line((x1 + 30, ly, x1 + 80, ly), fill=color, width=4)
        _marker(draw, x1 + 55, ly, kind, color)
        _text(draw, (x1 + 95, ly), attack, f_label, align="left")

    _text(draw, ((x0 + x1) / 2, 40), "Attack success rate vs. perturbation strength", f_title)
    _text(draw, ((x0 + x1) / 2, h - 45), "Perturbation budget (eps)", f_label)
    _vertical_text(img, (40, (y0 + y1) / 2), "Attack success rate", f_label)
    img.save(path)


def _heatmap_panel(img: Image.Image, box, rows: list[dict], metric: str, title: str,
                   ramp_name: str) -> None:
    draw = ImageDraw.Draw(img)
    f_title, f_label, f_cell = _font(26), _font(20), _font(22)
    bx0, by0, bx1, by1 = box
    eps, attacks, table = pivot(rows, metric)
    gx0, gy0, gx1, gy1 = bx0 + 190, by0 + 70, bx1 - 130, by1 - 90
    cw, ch = (gx1 - gx0) / len(attacks), (gy1 - gy0) / len(eps)
    colors = ramp(table, ramp_name)
    for i in range(len(eps)):
        for j in range(len(attacks)):
            cell = (gx0 + j * cw, gy0 + i * ch, gx0 + (j + 1) * cw, gy0 + (i + 1) * ch)
            v = table[i, j]
            if np.isnan(v):
                draw.rectangle(cell, fill=_MISSING, outline=_WHITE, width=2)
                continue
            draw.rectangle(cell, fill=tuple(int(c) for c in colors[i, j]),
                           outline=_WHITE, width=2)
            ink = _WHITE if v > 0.55 else _INK
            _text(draw, ((cell[0] + cell[2]) / 2, (cell[1] + cell[3]) / 2), f"{v:.3f}",
                  f_cell, fill=ink)
    for j, attack in enumerate(attacks):
        _text(draw, (gx0 + (j + 0.5) * cw, gy1 + 22), attack, f_label)
    for i, e in enumerate(eps):
        _text(draw, (gx0 - 12, gy0 + (i + 0.5) * ch), f"{e:.4f}", f_label, align="right")
    # color bar: the ramp from 0 (bottom) to 1 (top)
    cx0, cx1 = gx1 + 30, gx1 + 55
    bar = ramp(np.linspace(1.0, 0.0, int(gy1 - gy0)), ramp_name)[:, None, :]
    img.paste(Image.fromarray(np.repeat(bar, cx1 - cx0, axis=1)), (int(cx0), int(gy0)))
    _text(draw, (cx1 + 8, gy0), "1.0", f_label, align="left")
    _text(draw, (cx1 + 8, gy1), "0.0", f_label, align="left")
    _text(draw, (cx1 + 8, (gy0 + gy1) / 2), "rate", f_label, align="left")
    _text(draw, ((gx0 + gx1) / 2, by0 + 30), title, f_title)
    _text(draw, ((gx0 + gx1) / 2, gy1 + 60), "Attack method", f_label)
    _vertical_text(img, (bx0 + 40, (gy0 + gy1) / 2), "Perturbation (eps)", f_label)


def plot_defense_heatmaps(results: Mapping[tuple[str, float], Mapping[str, int]],
                          output_dir, save_prefix: str = "defense_results") -> None:
    """The attack-trend figure and the 2x2 defense matrix (three heatmaps).

    ``results``: {(attack_name, eps): the six counters + 'count'}."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    rows = defense_rates(results)
    _plot_trend(rows, output_dir / f"{save_prefix}_attack_trend.png")

    w, h = 1800, 1300
    img = Image.new("RGB", (w, h), _WHITE)
    _text(ImageDraw.Draw(img), (w / 2, 40), "Defense performance matrix", _font(32))
    for idx, (metric, title, ramp_name) in enumerate(MATRIX_PANELS):
        r, c = divmod(idx, 2)
        box = (c * w // 2, 80 + r * (h - 80) // 2, (c + 1) * w // 2, 80 + (r + 1) * (h - 80) // 2)
        _heatmap_panel(img, box, rows, metric, title, ramp_name)
    img.save(output_dir / f"{save_prefix}_defense_matrix.png")


def _to_uint8(x: np.ndarray) -> np.ndarray:
    return np.round(np.clip(x, 0.0, 1.0) * 255.0).astype(np.uint8)


def plot_attack_samples(samples: Sequence[Mapping], output_dir, eps: float) -> Path:
    """n x 4 grid: clean / adversarial / defended / |perturbation| summed
    over the channels (magma, scaled to its own range).

    Each sample dict: x (HWC), x_adv, x_def, pred_clean, conf_clean,
    pred_adv, pred_def."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    n = len(samples)
    if n == 0:
        raise ValueError("no samples to plot")
    tile, head, gap, top = 256, 90, 24, 80
    w = 4 * tile + 5 * gap + 60
    h = top + n * (tile + head + gap)
    img = Image.new("RGB", (w, h), _WHITE)
    draw = ImageDraw.Draw(img)
    f_head, f_title = _font(18), _font(28)
    _text(draw, (w / 2, top / 2), f"Attack & defense samples (eps={eps:.3f})", f_title)
    for idx, s in enumerate(samples):
        perturb = np.abs(np.asarray(s["x_adv"]) - np.asarray(s["x"])).sum(axis=-1)
        span = float(perturb.max() - perturb.min())
        heat = ramp((perturb - perturb.min()) / span if span > 0 else perturb * 0, "magma")
        tiles = [_to_uint8(np.asarray(s["x"])), _to_uint8(np.asarray(s["x_adv"])),
                 _to_uint8(np.asarray(s["x_def"])), heat]
        titles = [
            f"Clean\npred: {s['pred_clean']}\nconf: {s['conf_clean']:.3f}",
            f"Adversarial\npred: {s['pred_adv']}",
            f"Defended\npred: {s['pred_def']}",
            f"Perturbation\nmagnitude (max {float(perturb.max()):.3f})",
        ]
        y = top + idx * (tile + head + gap)
        for col in range(4):
            x = gap + col * (tile + gap)
            _text(draw, (x + tile / 2, y + head / 2), titles[col], f_head)
            im = Image.fromarray(tiles[col]).resize((tile, tile), Image.Resampling.NEAREST)
            img.paste(im, (x, y + head))
    out = output_dir / "attack_samples.png"
    img.save(out)
    return out
