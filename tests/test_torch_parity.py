"""Cross-framework parity: attacks + layer semantics vs independent torch.

The reference's behavior is defined by torch ops; these tests rebuild the
same math independently in torch (CPU), port the tiny model's weights, and
assert the two frameworks produce the same adversarial examples.  Run in
float64 on both sides so that sign() decisions cannot flip on float32
noise — agreement is then tight (1e-9-ish), making the tests deterministic.

Also pins op-level conventions where silent parity bugs live: SAME conv
padding, stride-2 pooling, count-include-pad average pooling.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_port_helpers import module_time_limit, one_thread, time_limit  # noqa: F401 (autouse)
from image_recognition_adversarial_example_attack_tpu.attacks import (
    cw_l2_attack,
    fgsm_attack,
    pgd_linf_attack,
)

EPS, ALPHA = 8 / 255, 2 / 255


@pytest.fixture(autouse=True)
def _x64():
    """Every test in this module runs with jax x64 enabled (thread-local)
    and torch defaulting to float64 — RESTORED afterwards, because the
    torch default is process-global and would otherwise poison every
    torch-using test that runs later in the session (their models would
    silently build float64 weights)."""
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        with jax.enable_x64():
            yield
    finally:
        torch.set_default_dtype(prev)


# --- a tiny 2-layer model expressed in BOTH frameworks, shared weights ---

class _Weights:
    def __init__(self, seed=0):
        rng = np.random.RandomState(seed)
        self.w1 = rng.randn(3, 3, 3, 8).astype(np.float64) * 0.3   # HWIO
        self.b1 = rng.randn(8).astype(np.float64) * 0.1
        self.w2 = rng.randn(8, 6).astype(np.float64) * 0.3         # [in, out]
        self.b2 = rng.randn(6).astype(np.float64) * 0.1


WEIGHTS = _Weights()


def logits_jax(x01):  # [B,H,W,3] float64 in [0,1]
    mean = jnp.asarray([0.485, 0.456, 0.406], jnp.float64)
    std = jnp.asarray([0.229, 0.224, 0.225], jnp.float64)
    x = (x01 - mean) / std
    x = jax.lax.conv_general_dilated(
        x, jnp.asarray(WEIGHTS.w1), (1, 1), ((1, 1), (1, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    ) + jnp.asarray(WEIGHTS.b1)
    x = jax.nn.relu(x)
    x = jnp.mean(x, axis=(1, 2))
    return x @ jnp.asarray(WEIGHTS.w2) + jnp.asarray(WEIGHTS.b2)


def logits_torch(x01_nchw):  # [B,3,H,W] float64 in [0,1]
    mean = torch.tensor([0.485, 0.456, 0.406]).view(1, 3, 1, 1)
    std = torch.tensor([0.229, 0.224, 0.225]).view(1, 3, 1, 1)
    x = (x01_nchw - mean) / std
    w1 = torch.tensor(WEIGHTS.w1.transpose(3, 2, 0, 1))  # HWIO -> OIHW
    x = F.conv2d(x, w1, torch.tensor(WEIGHTS.b1), padding=1)
    x = F.relu(x)
    x = x.mean(dim=(2, 3))
    return x @ torch.tensor(WEIGHTS.w2) + torch.tensor(WEIGHTS.b2)


@pytest.fixture(scope="module")
def data():
    with jax.enable_x64():
        rng = np.random.RandomState(7)
        x = rng.uniform(0.1, 0.9, size=(4, 8, 8, 3))
        lg = np.asarray(logits_jax(jnp.asarray(x)))
        y = lg.argmax(-1).astype(np.int64)
    return x, y


def _to_torch(x_nhwc):
    return torch.tensor(np.transpose(x_nhwc, (0, 3, 1, 2)))


def _to_nhwc(x_t):
    return np.transpose(x_t.detach().numpy(), (0, 2, 3, 1))


def test_model_port_is_identical(data):
    x, _ = data
    a = np.asarray(logits_jax(jnp.asarray(x)))
    b = logits_torch(_to_torch(x)).detach().numpy()
    np.testing.assert_allclose(a, b, atol=1e-10)


def test_fgsm_cross_framework(data):
    x, y = data
    ours = np.asarray(fgsm_attack(logits_jax, jnp.asarray(x), jnp.asarray(y), eps=EPS))

    xt = _to_torch(x).requires_grad_(True)
    loss = F.cross_entropy(logits_torch(xt), torch.tensor(y))
    (grad,) = torch.autograd.grad(loss, xt)
    theirs = _to_nhwc(torch.clamp(xt + EPS * grad.sign(), 0.0, 1.0))
    np.testing.assert_allclose(ours, theirs, atol=1e-9)


def test_pgd_cross_framework(data):
    x, y = data
    steps = 10
    ours = np.asarray(
        pgd_linf_attack(logits_jax, jnp.asarray(x), jnp.asarray(y),
                        eps=EPS, alpha=ALPHA, steps=steps,
                        key=jax.random.PRNGKey(0), random_start=False)
    )

    x0 = _to_torch(x)
    xa = x0.clone()
    for _ in range(steps):
        xa = xa.detach().requires_grad_(True)
        loss = F.cross_entropy(logits_torch(xa), torch.tensor(y))
        (grad,) = torch.autograd.grad(loss, xa)
        xa = xa + ALPHA * grad.sign()
        xa = torch.max(torch.min(xa, x0 + EPS), x0 - EPS)
        xa = torch.clamp(xa, 0.0, 1.0)
    theirs = _to_nhwc(xa)
    np.testing.assert_allclose(ours, theirs, atol=1e-9)


def test_cw_cross_framework(data):
    """Full CW: tanh reparam + Adam + margin loss + best tracking, 40 steps."""
    x, y = data
    steps, c, lr = 40, 5.0, 0.05
    res = cw_l2_attack(logits_jax, jnp.asarray(x), jnp.asarray(y),
                       c=c, kappa=0.0, steps=steps, lr=lr)
    ours = np.asarray(res.x_adv)
    ours_success = np.asarray(res.success)

    x0 = torch.clamp(_to_torch(x), 0.0, 1.0)
    tiny = 1e-6
    w = torch.atanh((x0 * (1 - 2 * tiny) + tiny) * 2 - 1).detach().requires_grad_(True)
    opt = torch.optim.Adam([w], lr=lr)
    yt = torch.tensor(y)
    best_adv = x0.clone()
    best_l2 = torch.full((x0.shape[0],), float("inf"))
    best_success = torch.zeros(x0.shape[0], dtype=torch.bool)
    for _ in range(steps):
        xa = 0.5 * (torch.tanh(w) + 1.0)
        lg = logits_torch(xa)
        onehot = F.one_hot(yt, lg.shape[1]).to(lg.dtype)
        real = (lg * onehot).sum(1)
        other = (lg - 1e4 * onehot).amax(1)
        f = torch.clamp(real - other, min=0.0)
        success = lg.argmax(1) != yt
        l2 = (xa - x0).flatten(1).pow(2).sum(1)
        improved = success & (l2 < best_l2)
        best_l2 = torch.where(improved, l2, best_l2)
        best_success |= improved
        best_adv = torch.where(improved.view(-1, 1, 1, 1), xa.detach(), best_adv)
        loss = (l2 + c * f).sum()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    # final-iterate success check (the post-scan evaluation cw.py added in
    # round 3 — ADVICE r2; the loop above only sees pre-update iterates)
    with torch.no_grad():
        xa = 0.5 * (torch.tanh(w) + 1.0)
        lg = logits_torch(xa)
        success = lg.argmax(1) != yt
        l2 = (xa - x0).flatten(1).pow(2).sum(1)
        improved = success & (l2 < best_l2)
        best_success |= improved
        best_adv = torch.where(improved.view(-1, 1, 1, 1), xa, best_adv)
        final = torch.where(best_success.view(-1, 1, 1, 1), best_adv, xa)
    theirs = _to_nhwc(final)

    np.testing.assert_array_equal(ours_success, best_success.numpy())
    np.testing.assert_allclose(ours, theirs, atol=1e-7)


class TestOpSemantics:
    """Layer conventions: flax/lax vs torch on random data (float64)."""

    def test_maxpool_3x3_s2_p1(self):
        import flax.linen as nn

        rng = np.random.RandomState(1)
        x = rng.randn(2, 9, 9, 4)
        a = np.asarray(nn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2),
                                   padding=((1, 1), (1, 1))))
        b = F.max_pool2d(torch.tensor(np.transpose(x, (0, 3, 1, 2))),
                         3, stride=2, padding=1)
        np.testing.assert_allclose(a, np.transpose(b.numpy(), (0, 2, 3, 1)), atol=1e-12)

    def test_avgpool_2x2_matches(self):
        import flax.linen as nn

        rng = np.random.RandomState(2)
        x = rng.randn(2, 8, 8, 4)
        a = np.asarray(nn.avg_pool(jnp.asarray(x), (2, 2), strides=(2, 2)))
        b = F.avg_pool2d(torch.tensor(np.transpose(x, (0, 3, 1, 2))), 2)
        np.testing.assert_allclose(a, np.transpose(b.numpy(), (0, 2, 3, 1)), atol=1e-12)

    def test_stride2_conv_padding1(self):
        """ResNet downsample conv convention: torch pad=1 == explicit (1,1)."""
        rng = np.random.RandomState(3)
        x = rng.randn(1, 7, 7, 3)
        w = rng.randn(3, 3, 3, 5)  # HWIO
        a = np.asarray(jax.lax.conv_general_dilated(
            jnp.asarray(x), jnp.asarray(w), (2, 2), ((1, 1), (1, 1)),
            dimension_numbers=("NHWC", "HWIO", "NHWC")))
        b = F.conv2d(torch.tensor(np.transpose(x, (0, 3, 1, 2))),
                     torch.tensor(w.transpose(3, 2, 0, 1)), stride=2, padding=1)
        np.testing.assert_allclose(a, np.transpose(b.numpy(), (0, 2, 3, 1)), atol=1e-10)

    def test_gelu_erf_form(self):
        import flax.linen as nn

        x = np.linspace(-3, 3, 101)
        a = np.asarray(nn.gelu(jnp.asarray(x), approximate=False))
        b = F.gelu(torch.tensor(x)).numpy()
        np.testing.assert_allclose(a, b, atol=1e-12)

    def test_batchnorm_inference(self):
        import flax.linen as nn

        rng = np.random.RandomState(4)
        x = rng.randn(2, 4, 4, 3)
        scale, bias = rng.randn(3), rng.randn(3)
        mean, var = rng.randn(3), rng.rand(3) + 0.5
        bn = nn.BatchNorm(use_running_average=True, epsilon=1e-5)
        variables = {
            "params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
            "batch_stats": {"mean": jnp.asarray(mean), "var": jnp.asarray(var)},
        }
        a = np.asarray(bn.apply(variables, jnp.asarray(x)))
        b = F.batch_norm(
            torch.tensor(np.transpose(x, (0, 3, 1, 2))),
            torch.tensor(mean), torch.tensor(var),
            torch.tensor(scale), torch.tensor(bias),
            training=False, eps=1e-5,
        )
        np.testing.assert_allclose(a, np.transpose(b.numpy(), (0, 2, 3, 1)), atol=1e-10)


def test_vgg_flatten_ordering_matches_torch():
    """VGG's classifier consumes a CHW-ordered flatten in torch; our NHWC
    model transposes before flattening.  Same weights -> same logits."""
    rng = np.random.RandomState(11)
    w_conv = rng.randn(3, 3, 3, 4).astype(np.float64) * 0.3  # HWIO
    b_conv = rng.randn(4).astype(np.float64) * 0.1
    w_fc = rng.randn(6, 4 * 4 * 4).astype(np.float64) * 0.2  # [out, C*H*W]
    b_fc = rng.randn(6).astype(np.float64) * 0.1
    x = rng.rand(2, 8, 8, 3).astype(np.float64)

    with jax.enable_x64():
        # the VGG code path: conv -> relu -> 2x2 pool -> NCHW-flatten -> dense
        h = jax.lax.conv_general_dilated(
            jnp.asarray(x), jnp.asarray(w_conv), (1, 1), ((1, 1), (1, 1)),
            dimension_numbers=("NHWC", "HWIO", "NHWC")) + jnp.asarray(b_conv)
        h = jax.nn.relu(h)
        h = h.reshape(2, 4, 2, 4, 2, 4).max(axis=(2, 4))  # 2x2 max pool
        h = jnp.transpose(h, (0, 3, 1, 2)).reshape(2, -1)  # models/vgg.py flatten
        ours = np.asarray(h @ jnp.asarray(w_fc.T) + jnp.asarray(b_fc))

    ht = F.conv2d(torch.tensor(x.transpose(0, 3, 1, 2)),
                  torch.tensor(w_conv.transpose(3, 2, 0, 1)),
                  torch.tensor(b_conv), padding=1)
    ht = F.relu(ht)
    ht = F.max_pool2d(ht, 2)
    ht = torch.flatten(ht, 1)  # torch's CHW flatten (what the weights expect)
    theirs = (ht @ torch.tensor(w_fc).T + torch.tensor(b_fc)).numpy()
    np.testing.assert_allclose(ours, theirs, atol=1e-10)


def _deepfool_oracle(x, steps, k, overshoot, eta):
    """An independent torch DeepFool on ``logits_torch``: the per-class
    backward loop of reference-style code.  NHWC numpy in and out."""
    x0 = _to_torch(x)
    with torch.no_grad():
        logits0 = logits_torch(x0)
    idx = logits0.argsort(dim=1, descending=True)[:, :k]
    k0 = idx[:, 0]
    r_tot = torch.zeros_like(x0)
    for _ in range(steps):
        x_adv = (x0 + (1.0 + overshoot) * r_tot).clamp(0, 1).detach()
        x_adv.requires_grad_(True)
        f = logits_torch(x_adv)
        fooled = f.argmax(dim=1) != k0
        grads = []
        for j in range(k):
            g = torch.autograd.grad(
                f.gather(1, idx[:, j:j + 1]).sum(), x_adv,
                retain_graph=(j < k - 1),
            )[0]
            grads.append(g)
        g = torch.stack(grads)                       # [k, B, C, H, W]
        w = g[1:] - g[:1]                            # [k-1, B, C, H, W]
        f_sel = f.gather(1, idx)
        f_diff = (f_sel[:, 1:] - f_sel[:, :1]).T     # [k-1, B]
        w_norm = w.flatten(2).norm(dim=2)
        dist = f_diff.abs() / w_norm.clamp_min(1e-12)
        l = dist.argmin(dim=0)
        w_l = w.gather(0, l.view(1, -1, 1, 1, 1).expand(1, *w.shape[1:]))[0]
        fd_l = f_diff.abs().gather(0, l.view(1, -1))[0]
        wn_l = w_norm.gather(0, l.view(1, -1))[0]
        step_v = (fd_l + eta).view(-1, 1, 1, 1) * w_l \
            / wn_l.clamp_min(1e-12).view(-1, 1, 1, 1) ** 2
        r_tot = torch.where(fooled.view(-1, 1, 1, 1), r_tot,
                            (r_tot + step_v).detach())
    return _to_nhwc((x0 + (1.0 + overshoot) * r_tot).clamp(0, 1))


def test_deepfool_cross_framework(data):
    """DeepFool is deterministic, so an independent torch implementation of
    the same linearization (per-class backward loop, the shape reference
    -style code uses) must produce the SAME adversarial examples as the
    fused vjp/scan program (attacks/deepfool.py)."""
    from image_recognition_adversarial_example_attack_tpu.attacks import (
        deepfool_attack,
    )

    x, _ = data
    x_jax = jnp.asarray(x)
    steps, k, overshoot, eta = 12, 4, 0.02, 1e-4

    got = np.asarray(
        deepfool_attack(logits_jax, x_jax, steps=steps, num_classes=k,
                        overshoot=overshoot, eta=eta)
    )
    expected = _deepfool_oracle(x, steps, k, overshoot, eta)
    np.testing.assert_allclose(got, expected, atol=1e-9)


def test_port_deepfool_equals_the_torch_oracle(data):
    """The port's DeepFool (attacks/deepfool.py of the PyTorch package) on
    the same model agrees with the oracle above, and so with JAX's."""
    from image_recognition_adversarial_example_attack_tpu_torch.attacks.deepfool import (
        deepfool_attack as port_deepfool)

    x, _ = data
    steps, k, overshoot, eta = 12, 4, 0.02, 1e-4
    got = port_deepfool(lambda z: logits_torch(z.permute(0, 3, 1, 2)), torch.tensor(x),
                        steps=steps, num_classes=k, overshoot=overshoot, eta=eta).numpy()
    np.testing.assert_allclose(got, _deepfool_oracle(x, steps, k, overshoot, eta), atol=1e-9)
