"""Plain float32 Vision Transformer (Dosovitskiy et al., ICLR 2021;
torchvision ``vit_b_16``) over a state dict in torchvision's layout.

From the published architecture: a patch convolution (kernel and stride the
patch size), a learned class token prepended, a learned position embedding
added, pre-norm encoder blocks (LayerNorm eps 1e-6; multi-head
self-attention ``softmax(q k^T / sqrt(d_head)) v`` with one packed qkv
projection laid out as torch's ``MultiheadAttention``; an MLP of two linear
layers with the erf GELU), a final LayerNorm and a linear head on the class
token.  Input: a normalized NCHW batch.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _ln(x, sd, p):
    return F.layer_norm(x, (x.shape[-1],), sd[p + ".weight"], sd[p + ".bias"], 1e-6)


def _attention(x, sd, p, heads):
    b, t, d = x.shape
    qkv = F.linear(x, sd[p + ".in_proj_weight"], sd[p + ".in_proj_bias"])
    q, k, v = qkv.reshape(b, t, 3, heads, d // heads).permute(2, 0, 3, 1, 4)
    scores = q @ k.transpose(-2, -1) / math.sqrt(d // heads)
    out = (scores.softmax(dim=-1) @ v).transpose(1, 2).reshape(b, t, d)
    return F.linear(out, sd[p + ".out_proj.weight"], sd[p + ".out_proj.bias"])


def forward(x, sd, config):
    """[B,3,H,W] normalized -> [B,classes] logits."""
    heads = config["num_heads"]
    x = F.conv2d(x, sd["conv_proj.weight"], sd["conv_proj.bias"], stride=config["patch_size"])
    x = x.flatten(2).transpose(1, 2)
    x = torch.cat([sd["class_token"].expand(x.shape[0], -1, -1), x], dim=1)
    x = x + sd["encoder.pos_embedding"]
    for i in range(config["num_layers"]):
        p = f"encoder.layers.encoder_layer_{i}"
        x = x + _attention(_ln(x, sd, p + ".ln_1"), sd, p + ".self_attention", heads)
        h = F.gelu(F.linear(_ln(x, sd, p + ".ln_2"), sd[p + ".mlp.0.weight"], sd[p + ".mlp.0.bias"]))
        x = x + F.linear(h, sd[p + ".mlp.3.weight"], sd[p + ".mlp.3.bias"])
    x = _ln(x, sd, "encoder.ln")
    return F.linear(x[:, 0], sd["heads.head.weight"], sd["heads.head.bias"])


def param_spec(config):
    """[(name, shape, mean, std)] in torchvision's order, for the
    benchmark's own init (``mean + std * N(0, 1)``): LeCun-normal linear and
    patch weights, small biases, LayerNorm affine around the identity, a
    class token and position embedding of standard deviation 0.02."""
    d, mlp, p = config["hidden_dim"], config["mlp_dim"], config["patch_size"]
    tokens = (config["image_size"] // p) ** 2 + 1
    spec = [("class_token", (1, 1, d), 0.0, 0.02),
            ("conv_proj.weight", (d, 3, p, p), 0.0, (1.0 / (3 * p * p)) ** 0.5),
            ("conv_proj.bias", (d,), 0.0, 0.02),
            ("encoder.pos_embedding", (1, tokens, d), 0.0, 0.02)]

    def ln(name):
        spec.extend([(name + ".weight", (d,), 1.0, 0.1), (name + ".bias", (d,), 0.0, 0.1)])

    def dense(name, out, inp):
        spec.extend([(name + ".weight", (out, inp), 0.0, (1.0 / inp) ** 0.5),
                     (name + ".bias", (out,), 0.0, 0.02)])

    for i in range(config["num_layers"]):
        q = f"encoder.layers.encoder_layer_{i}"
        ln(q + ".ln_1")
        spec.extend([(q + ".self_attention.in_proj_weight", (3 * d, d), 0.0, (1.0 / d) ** 0.5),
                     (q + ".self_attention.in_proj_bias", (3 * d,), 0.0, 0.02)])
        dense(q + ".self_attention.out_proj", d, d)
        ln(q + ".ln_2")
        dense(q + ".mlp.0", mlp, d)
        dense(q + ".mlp.3", d, mlp)
    ln("encoder.ln")
    dense("heads.head", config["num_classes"], d)
    return spec


POSITIVE = ()
