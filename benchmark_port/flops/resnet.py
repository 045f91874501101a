"""Multiply-accumulates of one ResNet v1.5 forward on one image, from the
architecture's shapes: every convolution (output positions x output
channels x input channels x kernel area) and the linear head.  BatchNorm,
ReLU, pooling and the residual additions are not counted, as in the
published 4.09 GMAC of ResNet-50 at 224x224."""


def _out(size: int, k: int, stride: int) -> int:
    return (size + 2 * (k // 2) - k) // stride + 1


def forward_macs(config) -> float:
    w, blocks = config["width"], config["stage_blocks"]
    s = _out(config["image_size"], 7, 2)
    macs = s * s * w * 3 * 49
    s = _out(s, 3, 2)  # the max pool
    cin = w
    for stage, n in enumerate(blocks):
        feats = w * 2 ** stage
        for i in range(n):
            stride = 2 if (stage > 0 and i == 0) else 1
            macs += s * s * feats * cin  # conv1, 1x1 at the input's size
            so = _out(s, 3, stride)
            macs += so * so * feats * feats * 9  # conv2, 3x3 with the stride
            macs += so * so * feats * 4 * feats  # conv3, 1x1
            if i == 0:
                macs += so * so * feats * 4 * cin  # the projection
            s, cin = so, feats * 4
    return float(macs + cin * config["num_classes"])


def stage3_macs(config) -> float:
    """The forward up to the end of the third stage (the detector's
    features): the whole forward less the fourth stage and the head."""
    last = dict(config, stage_blocks=config["stage_blocks"][:3], num_classes=0)
    return forward_macs(last)
