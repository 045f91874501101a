"""Multiply-accumulates of one Swin Transformer forward on one image, from the
architecture's shapes: the patch embedding, and in each block the qkv
projection, the attention scores and the attention-weighted values over
the tokens of each window, the output projection and the two MLP layers;
each patch merging (4C to 2C on the halved map), and the head.  LayerNorm,
softmax, GELU, the relative position bias, the mask, the shifts and the
additions are not counted, as in the published figures (Swin-T 4.5 G,
Swin-L 34.5 G at 224x224)."""


def forward_macs(config) -> float:
    p, c, m = config["patch_size"], config["embed_dim"], config["window_size"]
    ratio = config["mlp_ratio"]
    side = config["image_size"] // p
    macs = side * side * c * 3 * p * p
    for s, depth in enumerate(config["depths"]):
        if s > 0:
            side //= 2
            macs += side * side * 4 * c * 2 * c
            c *= 2
        n, window = side * side, min(m, side) ** 2
        macs += depth * (n * c * 3 * c + 2 * n * window * c + n * c * c + 2 * n * c * ratio * c)
    return float(macs + c * config["num_classes"])
