"""Vision Transformer in PyTorch (port of ``models/vit.py``): ``vit_b_16`` and
``vit_tiny``.

Submodules and parameters carry torchvision's names (``conv_proj``,
``class_token``, ``encoder.pos_embedding``,
``encoder.layers.encoder_layer_N.{ln_1, self_attention.in_proj_weight,
self_attention.in_proj_bias, self_attention.out_proj, ln_2, mlp.0, mlp.3}``,
``encoder.ln``, ``heads.head``), so a torchvision ``.pth`` loads with
``strict=True``.  The fused qkv projection is torch's packed ``[3D, D]``;
the JAX model stores the same values head-aligned ``[D, 3, H, hd]``
(``models/convert.py`` re-lays them).

As in the JAX model: LayerNorm eps 1e-6, the erf form of GELU, and the
attention written out, ``softmax(q k^T / sqrt(hd)) v``; it is not
``scaled_dot_product_attention``.  LayerNorm computes in float32 in a
bfloat16 model, as Flax's does.  The softmax of a bfloat16 model is
PyTorch's on bfloat16 scores, which keeps its running max and sum in float32
and rounds only its output; Flax's computes the exponentials in bfloat16.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.int8 import conv2d_class, linear, linear_class


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last axis that normalizes in its parameters' dtype
    (float32 in a bfloat16 model, see ``zoo.set_compute_dtype``) and returns
    the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.to(self.weight.dtype), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(x.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias: torch.Tensor | None = None) -> torch.Tensor:
    """``softmax(q k^T / sqrt(hd) + bias) v`` over [..., T, hd] heads."""
    scores = q @ k.transpose(-2, -1) / math.sqrt(q.shape[-1])
    if bias is not None:
        scores = scores + bias
    return scores.softmax(dim=-1) @ v


def split_heads(qkv: torch.Tensor, num_heads: int) -> tuple[torch.Tensor, ...]:
    """[B, T, 3D] packed (part, head, head_dim) -> q, k, v as [B, H, T, hd]."""
    b, t, _ = qkv.shape
    parts = qkv.reshape(b, t, 3, num_heads, -1).permute(2, 0, 3, 1, 4)
    return parts[0], parts[1], parts[2]


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, T, hd] -> [B, T, H * hd]."""
    b, h, t, hd = x.shape
    return x.transpose(1, 2).reshape(b, t, h * hd)


class SelfAttention(nn.Module):
    """Multi-head self-attention with one packed qkv projection, named as
    ``nn.MultiheadAttention``'s parameters.  ``int8=True`` quantizes the qkv
    and output projections; the attention products stay float."""

    def __init__(self, dim: int, num_heads: int, int8: bool = False):
        super().__init__()
        self.num_heads, self.int8 = num_heads, int8
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = linear_class(int8)(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = split_heads(linear(x, self.in_proj_weight, self.in_proj_bias, self.int8),
                              self.num_heads)
        return self.out_proj(merge_heads(attention(q, k, v)))


class EncoderBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_dim: int, int8: bool = False):
        super().__init__()
        dense = linear_class(int8)
        self.ln_1 = LayerNorm(dim, eps=1e-6)
        self.self_attention = SelfAttention(dim, num_heads, int8)
        self.ln_2 = LayerNorm(dim, eps=1e-6)
        # torchvision's MLPBlock: Linear, GELU, Dropout, Linear, Dropout
        self.mlp = nn.Sequential(dense(dim, mlp_dim), nn.GELU(), nn.Identity(),
                                 dense(mlp_dim, dim), nn.Identity())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attention(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class Encoder(nn.Module):
    def __init__(self, n_tokens: int, dim: int, depth: int, num_heads: int, mlp_dim: int,
                 int8: bool = False):
        super().__init__()
        self.pos_embedding = nn.Parameter(torch.zeros(1, n_tokens, dim))
        self.layers = nn.Sequential()
        for i in range(depth):
            self.layers.add_module(f"encoder_layer_{i}",
                                   EncoderBlock(dim, num_heads, mlp_dim, int8))
        self.ln = LayerNorm(dim, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ln(self.layers(x + self.pos_embedding.to(x.dtype)))


class ViT(nn.Module):
    """torchvision's ViT: conv patchify, class token, learned position
    embedding, pre-norm encoder, the class token's head.  ``int8=True``
    quantizes the patch conv, every token Linear (per example over
    [T, D]) and the head (``ops/int8.py``)."""

    def __init__(self, patch_size: int = 16, dim: int = 768, depth: int = 12,
                 num_heads: int = 12, mlp_dim: int = 3072, num_classes: int = 1000,
                 image_size: int = 224, int8: bool = False):
        super().__init__()
        self.conv_proj = conv2d_class(int8)(3, dim, patch_size, stride=patch_size)
        self.class_token = nn.Parameter(torch.zeros(1, 1, dim))
        n_tokens = (image_size // patch_size) ** 2 + 1
        self.encoder = Encoder(n_tokens, dim, depth, num_heads, mlp_dim, int8)
        self.heads = nn.Sequential()
        self.heads.add_module("head", linear_class(int8)(dim, num_classes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B,3,H,W] normalized input -> [B,num_classes] logits."""
        x = self.conv_proj(x).flatten(2).transpose(1, 2)  # [B, T, D], row-major patches
        cls = self.class_token.to(x.dtype).expand(x.shape[0], -1, -1)
        x = self.encoder(torch.cat([cls, x], dim=1))
        return self.heads(x[:, 0])


def vit_b_16(num_classes: int = 1000, int8: bool = False) -> ViT:
    return ViT(num_classes=num_classes, int8=int8)


def vit_tiny(num_classes: int = 10, int8: bool = False) -> ViT:
    """The JAX package's miniature ViT (same code path): 32x32 / 8, depth 2."""
    return ViT(patch_size=8, dim=32, depth=2, num_heads=2, mlp_dim=64,
               num_classes=num_classes, image_size=32, int8=int8)
