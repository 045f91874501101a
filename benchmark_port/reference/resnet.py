"""Plain float32 ResNet v1.5 (He et al., CVPR 2016; torchvision ``resnet50``)
over a state dict in torchvision's layout.

It is written from the published architecture, not from the program: a 7x7
stem of stride 2 with padding 3, BatchNorm, ReLU, a 3x3 max pool of stride 2
with padding 1, then bottleneck stages (1x1, 3x3 with the stage's stride,
1x1 of four times the width), each stage's first block projecting its
shortcut with a strided 1x1 and BatchNorm, global average pooling and a
linear head.  BatchNorm normalizes by its running statistics (inference, and
fine-tuning with frozen statistics), eps 1e-5.  Input: a normalized NCHW
batch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _same(t):
    return t


def _bn(x, sd, p):
    return F.batch_norm(x, sd[p + ".running_mean"], sd[p + ".running_var"],
                        sd[p + ".weight"], sd[p + ".bias"], False, 0.0, 1e-5)


def _conv(x, w, cast, stride=1):
    return F.conv2d(cast(x), cast(w), stride=stride, padding=w.shape[-1] // 2)


def _block(x, sd, p, stride, project, cast):
    out = F.relu(_bn(_conv(x, sd[p + ".conv1.weight"], cast), sd, p + ".bn1"))
    out = F.relu(_bn(_conv(out, sd[p + ".conv2.weight"], cast, stride), sd, p + ".bn2"))
    out = _bn(_conv(out, sd[p + ".conv3.weight"], cast), sd, p + ".bn3")
    short = (_bn(_conv(x, sd[p + ".downsample.0.weight"], cast, stride), sd, p + ".downsample.1")
             if project else x)
    return F.relu(out + short)


def stem(x, sd, cast=_same):
    x = F.relu(_bn(_conv(x, sd["conv1.weight"], cast, 2), sd, "bn1"))
    return F.max_pool2d(x, 3, stride=2, padding=1)


def stages(x, sd, config, upto=None, cast=_same):
    blocks = config["stage_blocks"]
    for s, n in enumerate(blocks[:upto]):
        for i in range(n):
            stride = 2 if (s > 0 and i == 0) else 1
            x = _block(x, sd, f"layer{s + 1}.{i}", stride, (i == 0), cast)
    return x


def forward(x, sd, config, cast=_same):
    """[B,3,H,W] normalized -> [B,classes] logits.  ``cast`` is applied to
    the inputs and weights of every convolution and of the head (the
    identity; a lower precision for the control)."""
    x = stages(stem(x, sd, cast), sd, config, cast=cast)
    return F.linear(cast(x.mean(dim=(2, 3))), cast(sd["fc.weight"]), sd["fc.bias"])


def features_stage3(x, sd, config):
    """The activation after the third stage, NCHW."""
    return stages(stem(x, sd), sd, config, upto=3)


def param_spec(config):
    """[(name, shape, mean, std)] of every leaf in torchvision's order: the
    benchmark's own init draws ``mean + std * N(0, 1)`` for each (an int64
    leaf is zero).  Convs are He-normal on their fan-in, so the second moment
    holds through conv and ReLU; BatchNorm's affine and running statistics
    are drawn around the identity; each block's last BatchNorm scale is small
    (0.2), so that sixteen residual additions keep the activations near unit
    scale; the head is LeCun-normal, which gives logits of unit scale."""
    w, blocks, classes = config["width"], config["stage_blocks"], config["num_classes"]
    spec = []

    def conv(name, cout, cin, k):
        spec.append((name, (cout, cin, k, k), 0.0, (2.0 / (cin * k * k)) ** 0.5))

    def bn(name, c, scale=1.0):
        spec.extend([(name + ".weight", (c,), scale, 0.1 * scale),
                     (name + ".bias", (c,), 0.0, 0.1),
                     (name + ".running_mean", (c,), 0.0, 0.1),
                     (name + ".running_var", (c,), 1.0, 0.1),
                     (name + ".num_batches_tracked", (), 0.0, 0.0)])

    conv("conv1.weight", w, 3, 7)
    bn("bn1", w)
    cin = w
    for s, n in enumerate(blocks):
        feats = w * 2 ** s
        for i in range(n):
            p = f"layer{s + 1}.{i}"
            conv(p + ".conv1.weight", feats, cin, 1)
            bn(p + ".bn1", feats)
            conv(p + ".conv2.weight", feats, feats, 3)
            bn(p + ".bn2", feats)
            conv(p + ".conv3.weight", feats * 4, feats, 1)
            bn(p + ".bn3", feats * 4, scale=0.2)
            if i == 0:
                conv(p + ".downsample.0.weight", feats * 4, cin, 1)
                bn(p + ".downsample.1", feats * 4)
            cin = feats * 4
    spec.append(("fc.weight", (classes, cin), 0.0, (1.0 / cin) ** 0.5))
    spec.append(("fc.bias", (classes,), 0.0, 0.02))
    return spec


# leaves whose draws are folded to positive values (|mean + std * n|)
POSITIVE = (".running_var",)
