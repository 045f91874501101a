"""Swin Transformer in PyTorch (port of ``models/swin.py``): ``swin_t``,
``swin_tiny_test``, and ``swin_l``, which the JAX package does not have.

Submodules carry torchvision's names: ``features.0.{0,2}`` the patch conv and
its LayerNorm, ``features.{1,3,5,7}.B`` the blocks of stages 1-4
(``norm1``, ``attn.{qkv, proj, relative_position_bias_table}``, ``norm2``,
``mlp.0``, ``mlp.3``), ``features.{2,4,6}`` the patch mergings
(``reduction``, ``norm``), then ``norm`` and ``head``.  Each attention holds
torchvision's buffer ``relative_position_index`` (the flattened static
index, which the JAX converter skips), so a torchvision ``.pth`` loads with
``strict=True``; a state dict that leaves the index out loads too, and one
whose index is not the window's raises.

As the JAX model computes it: feature maps NHWC between blocks; a block's
windowed attention rolls the map by (-s, -s) on odd blocks and back, with
the -100 additive mask across the rolled seams, and does not shift where
the map is no larger than one window (``models/swin.py:78``); the relative
position bias is gathered from the table by the static index; patch merging
concatenates x0, x1, x2, x3 (``:173-177``); LayerNorm eps 1e-5 in float32;
GELU in its erf form.

Spans (``utils/profiling.py``, recorded only under a profiler session) tile
a forward: ``swin.embed`` (the patch conv and its LayerNorm), per block
``swin.attn`` (norm1, the window attention, its residual add) and
``swin.mlp`` (norm2, the MLP, its residual add), ``swin.merge`` per patch
merging, and ``swin.head`` (the final LayerNorm, the mean and the head).
Each window attention counts ``window_attn.shifted`` or
``window_attn.plain`` into its block's span, by whether it rolled the map,
and ``window_attn.fused`` or ``window_attn.written`` by its route.

The route: where ``kernels/window_attn.py::plan`` takes a call (a CUDA
bfloat16 map, plain float linears, head dim 32, window 7, a bias table
that needs no gradient), the block runs qkv on the unpartitioned map, the
shifted-window attention kernel pair (the roll, the partition, the head split
and the bias gather in its addressing) and proj.  Every other call (the CPU,
float32, int8, a training forward whose table is a leaf) runs the attention
written out (``WindowAttention._attend``).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import window_attn
from ..ops.int8 import conv2d_class, linear_class
from ..utils.profiling import count, span
from .vit import LayerNorm, attention, merge_heads, split_heads


def relative_position_index(window: int) -> np.ndarray:
    """[ws*ws, ws*ws] indices into the (2ws-1)^2-row bias table (static)."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1)


def shift_attn_mask(h: int, w: int, window: int, shift: int) -> np.ndarray:
    """Additive mask [nW, ws*ws, ws*ws] of shifted-window attention: -100
    between positions from different regions of the rolled map (static)."""
    img = np.zeros((h, w), np.int32)
    cnt = 0
    slices = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    for hs in slices:
        for ws_ in slices:
            img[hs, ws_] = cnt
            cnt += 1
    img = img.reshape(h // window, window, w // window, window)
    img = img.transpose(0, 2, 1, 3).reshape(-1, window * window)
    diff = img[:, :, None] - img[:, None, :]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


class WindowAttention(nn.Module):
    """Shifted-window attention.  ``int8=True`` quantizes qkv and proj, whose
    input is ``[B * nW, ws*ws, C]``: one activation scale per window, as in
    the JAX model; the attention products stay float."""

    def __init__(self, dim: int, num_heads: int, window: int, shift: int, int8: bool = False):
        super().__init__()
        self.num_heads, self.window, self.shift = num_heads, window, shift
        self.qkv = linear_class(int8)(dim, 3 * dim)
        self.proj = linear_class(int8)(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, num_heads))
        self.register_buffer("relative_position_index",
                             torch.from_numpy(relative_position_index(window).reshape(-1)))
        self._masks: dict[tuple, torch.Tensor] = {}  # (h, w, device, dtype) -> mask

    def _mask(self, h: int, w: int, shift: int, like: torch.Tensor) -> torch.Tensor:
        key = (h, w, like.device, like.dtype)
        if key not in self._masks:
            self._masks[key] = torch.from_numpy(shift_attn_mask(h, w, self.window, shift)).to(
                device=like.device, dtype=like.dtype)
        return self._masks[key]

    def _load_from_state_dict(self, state_dict, prefix, local_metadata, strict, missing_keys,
                              unexpected_keys, error_msgs):
        """The static index stays the window's own: a state dict may leave it
        out (one drawn from float leaves alone), and one that carries an index
        other than the window's is an error, which names the key."""
        key = prefix + "relative_position_index"
        given = state_dict.get(key)
        if given is not None:
            own = self.relative_position_index
            if given.shape != own.shape or not torch.equal(given.to(own), own):
                error_msgs.append(f"{key}: not the static relative position index of a "
                                  f"{self.window}x{self.window} window")
            state_dict = {k: v for k, v in state_dict.items() if k != key}
        super()._load_from_state_dict(state_dict, prefix, local_metadata, strict, missing_keys,
                                      unexpected_keys, error_msgs)
        if key in missing_keys:
            missing_keys.remove(key)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, H, W, C] -> [B, H, W, C]: through the kernel pair where
        ``window_attn.plan`` takes the call, else written out."""
        _, h, w, _ = x.shape
        sh = 0 if (h <= self.window and w <= self.window) else self.shift
        p = window_attn.plan(x, self, sh)
        fused = not isinstance(p, str)
        with count("window_attn.shifted" if sh > 0 else "window_attn.plain"), \
                count("window_attn.fused" if fused else "window_attn.written"):
            if fused:
                return self.proj(window_attn.launch(self.qkv(x),
                                                    self.relative_position_bias_table, p))
            return self._attend(x, sh)

    def _attend(self, x: torch.Tensor, sh: int) -> torch.Tensor:
        b, h, w, c = x.shape
        ws, nh = self.window, self.num_heads
        if sh > 0:
            x = torch.roll(x, shifts=(-sh, -sh), dims=(1, 2))
        # partition into [B * nW, ws*ws, C]
        x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
        nw = (h // ws) * (w // ws)
        x = x.reshape(b * nw, ws * ws, c)
        # heads as [B, nW, H, ws*ws, hd]: the bias [H, .., ..] and the mask
        # [nW, 1, .., ..] broadcast over them without a copy per window
        q, k, v = (t.reshape(b, nw, nh, ws * ws, -1) for t in split_heads(self.qkv(x), nh))
        bias = self.relative_position_bias_table[self.relative_position_index]
        bias = bias.reshape(ws * ws, ws * ws, nh).permute(2, 0, 1).to(q.dtype)
        if sh > 0:
            bias = bias + self._mask(h, w, sh, q)[:, None]
        out = attention(q, k, v, bias).reshape(b * nw, nh, ws * ws, -1)
        out = self.proj(merge_heads(out))
        # reverse the partition
        out = out.reshape(b, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
        out = out.reshape(b, h, w, c)
        if sh > 0:
            out = torch.roll(out, shifts=(sh, sh), dims=(1, 2))
        return out


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: int, shift: int, mlp_ratio: int = 4,
                 int8: bool = False):
        super().__init__()
        dense = linear_class(int8)
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, num_heads, window, shift, int8)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        # torchvision's MLP: Linear, GELU, Dropout, Linear, Dropout; on the
        # [B, H, W, C] map, so one activation scale per example
        self.mlp = nn.Sequential(dense(dim, dim * mlp_ratio), nn.GELU(), nn.Identity(),
                                 dense(dim * mlp_ratio, dim), nn.Identity())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("swin.attn"):
            x = x + self.attn(self.norm1(x))
        with span("swin.mlp"):
            return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    """2x2 neighbourhood concatenated (4C) -> LayerNorm -> Linear to 2C."""

    def __init__(self, dim: int, int8: bool = False):
        super().__init__()
        self.reduction = linear_class(int8)(4 * dim, 2 * dim, bias=False)
        self.norm = LayerNorm(4 * dim, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("swin.merge"):
            x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                           x[:, 1::2, 1::2]], dim=-1)
            return self.reduction(self.norm(x))


class PatchEmbed(nn.Sequential):
    """``features.0``: the patch conv (0), NCHW -> NHWC (1), LayerNorm (2)."""

    def __init__(self, patch_size: int, dim: int, int8: bool = False):
        super().__init__(conv2d_class(int8)(3, dim, patch_size, stride=patch_size),
                         nn.Identity(), LayerNorm(dim, eps=1e-5))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("swin.embed"):
            return self[2](self[0](x).permute(0, 2, 3, 1))


class SwinTransformer(nn.Module):
    """``int8=True``: the patch conv, qkv, proj, the MLPs, the patch
    mergings' reduction and the head run in int8 (``ops/int8.py``)."""

    def __init__(self, patch_size: int = 4, embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 6, 2), num_heads: Sequence[int] = (3, 6, 12, 24),
                 window: int = 7, num_classes: int = 1000, int8: bool = False):
        super().__init__()
        layers: list[nn.Module] = [PatchEmbed(patch_size, embed_dim, int8)]
        dim = embed_dim
        for s, (depth, heads) in enumerate(zip(depths, num_heads)):
            if s > 0:
                layers.append(PatchMerging(dim, int8))
                dim *= 2
            layers.append(nn.Sequential(*[
                SwinBlock(dim, heads, window, 0 if blk % 2 == 0 else window // 2, int8=int8)
                for blk in range(depth)]))
        self.features = nn.Sequential(*layers)
        self.norm = LayerNorm(dim, eps=1e-5)
        self.head = linear_class(int8)(dim, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B,3,H,W] normalized input -> [B,num_classes] logits."""
        x = self.features(x)  # [B, h, w, C]
        with span("swin.head"):
            return self.head(self.norm(x).mean(dim=(1, 2)))


def swin_t(num_classes: int = 1000, int8: bool = False) -> SwinTransformer:
    return SwinTransformer(num_classes=num_classes, int8=int8)


def swin_l(num_classes: int = 1000, int8: bool = False) -> SwinTransformer:
    """Swin-L (Liu et al., ICCV 2021, §3.3): C = 192, layer numbers 2-2-18-2,
    6-12-24-48 heads of 32, window 7, MLP ratio 4; 196,532,476 parameters
    at 1000 classes.  At 224² stage 4's 7x7 map is one window, so its two
    blocks do not shift: 11 shifted and 13 plain window attentions a
    forward."""
    return SwinTransformer(patch_size=4, embed_dim=192, depths=(2, 2, 18, 2),
                           num_heads=(6, 12, 24, 48), window=7, num_classes=num_classes,
                           int8=int8)


def swin_tiny_test(num_classes: int = 10, int8: bool = False) -> SwinTransformer:
    """The JAX package's miniature Swin (same code path): 32x32, window 4."""
    return SwinTransformer(patch_size=2, embed_dim=16, depths=(2, 2), num_heads=(2, 4),
                           window=4, num_classes=num_classes, int8=int8)
