"""Plain float32 Swin Transformer (Liu et al., ICCV 2021, arXiv 2103.14030) over
a state dict in torchvision's layout (``swin_t``'s, at any widths).

From the published architecture: a patch partition and linear embedding (a
convolution whose kernel and stride are the patch size) and a LayerNorm;
four stages of blocks, each block pre-norm (Eq. 3): ``x + W-MSA(LN(x))``
then ``x + MLP(LN(x))``, the MLP two linear layers with the erf GELU and
ratio 4; between stages a patch merging, which concatenates each 2x2
neighbourhood (4C), normalizes it and maps it linearly to 2C; then a
LayerNorm, the global average over the map and a linear head.  Input: a
normalized NCHW batch.

Window attention (§3.2): the map is cut into non-overlapping M x M windows
and each head computes ``softmax(q k^T / sqrt(d) + B) v`` inside a window,
``B`` read from the (2M-1)^2-row table at ``(dy + M - 1)(2M - 1) + dx + M -
1`` for the relative position (dy, dx) of query and key.  Every second block
of a stage shifts the windows by floor(M/2), computed as the paper's
efficient batch computation: a cyclic shift of the map by -floor(M/2) on
both axes, a mask between positions of different sub-windows of the
shifted map, and the reverse shift after the attention.  A map no larger
than one window is not shifted.

Departures from the paper's text, each as torchvision (and the authors'
code) has them: qkv carries a bias; the mask adds -100, not -inf; LayerNorm
eps is 1e-5 (the paper states none); the merging concatenates x[0::2, 0::2],
x[1::2, 0::2], x[0::2, 1::2], x[1::2, 1::2] in that order.  None changes the
mathematics the paper defines.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _ln(x, sd, p):
    return F.layer_norm(x, (x.shape[-1],), sd[p + ".weight"], sd[p + ".bias"], 1e-5)


def relative_index(m: int, device=None) -> torch.Tensor:
    """[M*M, M*M] rows of the bias table for each (query, key) of a window."""
    ij = torch.arange(m, device=device)
    dy = ij.repeat_interleave(m)  # row of each of the M*M positions, row-major
    dx = ij.repeat(m)
    rel_y = dy[:, None] - dy[None, :] + (m - 1)
    rel_x = dx[:, None] - dx[None, :] + (m - 1)
    return rel_y * (2 * m - 1) + rel_x


def shift_mask(h: int, w: int, m: int, s: int, device=None) -> torch.Tensor:
    """[nW, M*M, M*M]: -100 between positions that lie in different
    sub-windows of the map shifted by -s, 0 elsewhere.  The shifted map's
    rows fall into three bands, [0, h-M), [h-M, h-s), [h-s, h), and so do its
    columns; a sub-window is one pair of bands."""
    def band(n):
        i = torch.arange(n, device=device)
        return (i >= n - m).long() + (i >= n - s).long()

    label = band(h)[:, None] * 3 + band(w)[None, :]
    win = label.reshape(h // m, m, w // m, m).permute(0, 2, 1, 3).reshape(-1, m * m)
    return (win[:, :, None] != win[:, None, :]).float() * -100.0


def _windows(x, m):
    b, h, w, c = x.shape
    return x.reshape(b, h // m, m, w // m, m, c).permute(0, 1, 3, 2, 4, 5).reshape(-1, m * m, c)


def _unwindows(x, b, h, w, m):
    c = x.shape[-1]
    return x.reshape(b, h // m, w // m, m, m, c).permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


def _window_attention(x, sd, p, heads, m, shifted):
    b, h, w, c = x.shape
    if h % m or w % m:
        raise ValueError(f"a {h}x{w} map is no whole number of {m}x{m} windows")
    s = m // 2 if shifted and (h > m or w > m) else 0
    if s:
        x = torch.roll(x, shifts=(-s, -s), dims=(1, 2))
    win = _windows(x, m)  # [B * nW, M*M, C]
    qkv = F.linear(win, sd[p + ".qkv.weight"], sd[p + ".qkv.bias"])
    q, k, v = qkv.reshape(win.shape[0], m * m, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    scores = q @ k.transpose(-2, -1) / math.sqrt(c // heads)  # [B * nW, heads, N, N]
    table = sd[p + ".relative_position_bias_table"]
    scores = scores + table[relative_index(m, x.device)].permute(2, 0, 1)
    if s:
        n_win = (h // m) * (w // m)
        scores = (scores.reshape(b, n_win, heads, m * m, m * m)
                  + shift_mask(h, w, m, s, x.device)[None, :, None]).reshape(scores.shape)
    out = (scores.softmax(dim=-1) @ v).transpose(1, 2).reshape(win.shape)
    out = _unwindows(F.linear(out, sd[p + ".proj.weight"], sd[p + ".proj.bias"]), b, h, w, m)
    if s:
        out = torch.roll(out, shifts=(s, s), dims=(1, 2))
    return out


def _merge(x, sd, p):
    x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
    return F.linear(_ln(x, sd, p + ".norm"), sd[p + ".reduction.weight"])


def forward(x, sd, config):
    """[B,3,H,W] normalized -> [B,classes] logits."""
    m = config["window_size"]
    x = F.conv2d(x, sd["features.0.0.weight"], sd["features.0.0.bias"],
                 stride=config["patch_size"]).permute(0, 2, 3, 1)
    x = _ln(x, sd, "features.0.2")
    for s, (depth, heads) in enumerate(zip(config["depths"], config["num_heads"])):
        if s > 0:
            x = _merge(x, sd, f"features.{2 * s}")
        for blk in range(depth):
            p = f"features.{2 * s + 1}.{blk}"
            x = x + _window_attention(_ln(x, sd, p + ".norm1"), sd, p + ".attn", heads, m,
                                      shifted=blk % 2 == 1)
            hidden = F.gelu(F.linear(_ln(x, sd, p + ".norm2"), sd[p + ".mlp.0.weight"],
                                     sd[p + ".mlp.0.bias"]))
            x = x + F.linear(hidden, sd[p + ".mlp.3.weight"], sd[p + ".mlp.3.bias"])
    x = _ln(x, sd, "norm").mean(dim=(1, 2))
    return F.linear(x, sd["head.weight"], sd["head.bias"])


def param_spec(config):
    """[(name, shape, mean, std)] in torchvision's order, every float leaf
    (the static relative position index is none), for the benchmark's own
    init (``mean + std * N(0, 1)``): LeCun-normal linear and patch weights,
    small biases, LayerNorm affine around the identity, bias tables of
    standard deviation 0.02."""
    c, p, m = config["embed_dim"], config["patch_size"], config["window_size"]
    ratio = config["mlp_ratio"]
    spec = [("features.0.0.weight", (c, 3, p, p), 0.0, (1.0 / (3 * p * p)) ** 0.5),
            ("features.0.0.bias", (c,), 0.0, 0.02)]

    def ln(name, d):
        spec.extend([(name + ".weight", (d,), 1.0, 0.1), (name + ".bias", (d,), 0.0, 0.1)])

    def dense(name, out, inp, bias=True):
        spec.append((name + ".weight", (out, inp), 0.0, (1.0 / inp) ** 0.5))
        if bias:
            spec.append((name + ".bias", (out,), 0.0, 0.02))

    ln("features.0.2", c)
    for s, (depth, heads) in enumerate(zip(config["depths"], config["num_heads"])):
        if s > 0:
            dense(f"features.{2 * s}.reduction", 2 * c, 4 * c, bias=False)
            ln(f"features.{2 * s}.norm", 4 * c)
            c *= 2
        for blk in range(depth):
            q = f"features.{2 * s + 1}.{blk}"
            ln(q + ".norm1", c)
            spec.append((q + ".attn.relative_position_bias_table", ((2 * m - 1) ** 2, heads),
                         0.0, 0.02))
            dense(q + ".attn.qkv", 3 * c, c)
            dense(q + ".attn.proj", c, c)
            ln(q + ".norm2", c)
            dense(q + ".mlp.0", ratio * c, c)
            dense(q + ".mlp.3", c, ratio * c)
    ln("norm", c)
    dense("head", config["num_classes"], c)
    return spec


POSITIVE = ()
