"""Multiply-accumulates of one Vision Transformer forward on one image, from
the architecture's shapes: the patch projection, and in each encoder layer
the packed qkv projection, the attention scores and the attention-weighted
values over all heads, the output projection and the two MLP layers, then
the head on the class token.  LayerNorm, softmax, GELU and the additions
are not counted, as in the published 17.56 GMAC of ViT-B/16 at 224x224."""


def forward_macs(config) -> float:
    d, mlp, p = config["hidden_dim"], config["mlp_dim"], config["patch_size"]
    patches = (config["image_size"] // p) ** 2
    t = patches + 1
    per_layer = t * d * 3 * d + 2 * t * t * d + t * d * d + 2 * t * d * mlp
    return float(patches * d * 3 * p * p + config["num_layers"] * per_layer
                 + d * config["num_classes"])
