"""The fused BatchNorm -> (add) -> ReLU route of the port's ResNets
(``kernels/bn_act.py``, ``csrc/bn_act.cu``, ``models/resnet.py::bn_relu``).

On the CPU: the route's choice for each thing it observes, the plain route
against the unfused code the models ran before it (bit for bit, whole
models included), the ``bn_fused`` / ``bn_plain`` counters and the
benchmark's reader of them, and the kernels' signature table.  Marked
``cuda``: the kernels on the card against the plain composition, their
launch counts in a PGD-10 run, and their refusals.  Run those on a machine
with an H100:

    python -m pytest tests/test_torch_bn_act.py -m cuda --noconftest
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

import pytest
import torch

from _torch_port_helpers import module_time_limit, one_thread, time_limit  # noqa: F401 (autouse)
from image_recognition_adversarial_example_attack_tpu_torch.kernels import bn_act, build
from image_recognition_adversarial_example_attack_tpu_torch.models import resnet
from image_recognition_adversarial_example_attack_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parent.parent


def _frozen_bn(c: int, seed: int = 0, device="cpu") -> resnet.FrozenBatchNorm2d:
    """A BatchNorm as ``load_model`` leaves it: float32, no grad, statistics
    away from the identity."""
    g = torch.Generator().manual_seed(seed)
    bn = resnet.FrozenBatchNorm2d(c)
    with torch.no_grad():
        bn.running_mean.copy_(torch.randn(c, generator=g) * 0.5)
        bn.running_var.copy_(torch.rand(c, generator=g) * 2 + 0.05)
        bn.weight.copy_(torch.randn(c, generator=g))
        bn.bias.copy_(torch.randn(c, generator=g) * 0.3)
    return bn.requires_grad_(False).eval().to(device)


def _act(shape, seed: int = 1, dtype=torch.bfloat16, device="cpu") -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g) * 2
    return x.to(dtype).to(device).contiguous(memory_format=torch.channels_last)


# ---------------------------------------------------------------------------
# the route, from what it observes (the device is checked last)
# ---------------------------------------------------------------------------

def _case(name):
    """(x, bn, z, z_bn, grad enabled) of one route case: everything the
    kernels take except what ``name`` changes."""
    bn, z_bn = _frozen_bn(16), None
    x, z, grad = _act((2, 16, 5, 3)), None, True
    if name == "float32":
        x = x.float()
    elif name == "nchw":
        x = x.contiguous()
    elif name == "param_grad":
        bn.weight.requires_grad_(True)
    elif name == "param_grad_no_grad_mode":
        bn.weight.requires_grad_(True)
        grad = False
    elif name == "shard_channels":  # a shard whose channels are not the BatchNorm's
        x = _act((2, 8, 5, 3))
    elif name == "channels_not_8":
        bn, x = _frozen_bn(12), _act((2, 12, 5, 3))
    elif name == "too_many_channels":
        bn, x = _frozen_bn(2056), _act((1, 2056, 1, 1))
    elif name == "residual_float32":
        z = _act((2, 16, 5, 3), seed=2).float()
    elif name == "residual_shape":
        z = _act((2, 16, 5, 4), seed=2)
    elif name == "residual_bn_grad":
        z, z_bn = _act((2, 16, 5, 3), seed=2), _frozen_bn(16, seed=3)
        z_bn.bias.requires_grad_(True)
    elif name == "residual_bn_eps":
        z, z_bn = _act((2, 16, 5, 3), seed=2), _frozen_bn(16, seed=3)
        z_bn.eps = 1e-3
    elif name == "residual":
        z, z_bn = _act((2, 16, 5, 3), seed=2), _frozen_bn(16, seed=3)
    return x, bn, z, z_bn, grad


ROUTE_CASES = {
    "takes_all_but_device": "not a CUDA tensor",
    "float32": "not bfloat16",
    "nchw": "channels_last",
    "param_grad": "requires grad",
    "param_grad_no_grad_mode": "not a CUDA tensor",
    "shard_channels": "channels",
    "channels_not_8": "multiples of 8",
    "too_many_channels": "up to 2048",
    "residual_float32": "not bfloat16",
    "residual_shape": "residual of shape",
    "residual_bn_grad": "requires grad",
    "residual_bn_eps": "eps differ",
    "residual": "not a CUDA tensor",
}


@pytest.mark.parametrize("name", sorted(ROUTE_CASES))
def test_route_reports_each_observable(name):
    x, bn, z, z_bn, grad = _case(name)
    with torch.set_grad_enabled(grad):
        why = bn_act.plan(x, bn, z, z_bn)
    assert isinstance(why, str) and ROUTE_CASES[name] in why, why


def test_direct_call_refuses_what_the_kernels_do_not_take():
    bn = _frozen_bn(16)
    before = bn_act.launch_counts()
    for x in (_act((2, 16, 5, 3)), _act((2, 16, 5, 3)).float(), _act((2, 16, 5, 3)).contiguous()):
        with pytest.raises(ValueError, match="do not take"):
            bn_act.bn_act(x, bn)
    assert bn_act.launch_counts() == before


# ---------------------------------------------------------------------------
# the plain route is the unfused code, bit for bit
# ---------------------------------------------------------------------------

_RELU = torch.nn.ReLU()  # the models' ReLU module before the helper


def _old_chain(x, bn, z=None, z_bn=None):
    """The models' chain before the helper: module BatchNorm, nn.ReLU, +."""
    out = bn(x)
    if z is None:
        return _RELU(out)
    identity = z if z_bn is None else z_bn(z)
    return _RELU(out + identity)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", ["bn_relu", "bn_add_relu", "bn_bn_add_relu"])
def test_plain_route_equals_the_unfused_chain(dtype, variant):
    bn = _frozen_bn(24)
    x = _act((3, 24, 7, 5), dtype=dtype).requires_grad_(True)
    z = z_bn = None
    if variant != "bn_relu":
        z = _act((3, 24, 7, 5), seed=4, dtype=dtype).requires_grad_(True)
    if variant == "bn_bn_add_relu":
        z_bn = _frozen_bn(24, seed=5)
    before = bn_act.launch_counts()
    got = resnet.bn_relu(x, bn, z, z_bn)
    want = _old_chain(x, bn, z, z_bn)
    assert got.dtype == dtype and torch.equal(got, want)
    g = _act((3, 24, 7, 5), seed=6, dtype=dtype)
    inputs = (x,) if z is None else (x, z)
    for a, b in zip(torch.autograd.grad(got, inputs, g), torch.autograd.grad(want, inputs, g)):
        assert torch.equal(a, b)
    assert bn_act.launch_counts() == before  # the plain route launches nothing


def _old_block_forward(self, x):
    identity = x if self.downsample is None else self.downsample(x)
    out = _RELU(self.bn1(self.conv1(x)))
    out = _RELU(self.bn2(self.conv2(out)))
    out = self.bn3(self.conv3(out))
    return _RELU(out + identity)


def _old_stem(self, x):
    return self.maxpool(_RELU(self.bn1(self.conv1(x))))


def _logits_and_grad(model, x):
    xg = x.clone().requires_grad_(True)
    logits = model(xg)
    (grad,) = torch.autograd.grad(logits.float().square().sum(), xg)
    return logits, grad


@pytest.mark.parametrize("name,dtype,size", [
    ("resnet_tiny", torch.float32, 32), ("resnet_tiny", torch.bfloat16, 32),
    ("resnet50", torch.bfloat16, 64), ("resnet50", torch.float32, 64)])
def test_models_unchanged_on_the_cpu(monkeypatch, name, dtype, size):
    """Logits and input gradients of the zoo's models on the CPU: the same
    bits as the models' code before the fused route."""
    from image_recognition_adversarial_example_attack_tpu_torch.models.zoo import load_model

    with pytest.warns(UserWarning, match="no weights found"):
        model = load_model(name, dtype=dtype, device="cpu").model
    x = torch.rand((2, 3, size, size), generator=torch.Generator().manual_seed(7))
    x = x.to(dtype).contiguous(memory_format=torch.channels_last)
    got = _logits_and_grad(model, x)
    monkeypatch.setattr(resnet.Bottleneck, "forward", _old_block_forward)
    monkeypatch.setattr(resnet.ResNet, "stem", _old_stem)
    want = _logits_and_grad(model, x)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the counters, and the benchmark's reader of them
# ---------------------------------------------------------------------------

def test_each_chain_counts_fused_or_plain_into_its_span():
    from torch.profiler import ProfilerActivity, profile

    model = resnet.resnet_tiny().requires_grad_(False).eval()
    x = torch.rand((1, 3, 32, 32)).contiguous(memory_format=torch.channels_last)
    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("model.net"):
            model(x)
        model(x)  # no open span: dropped
    (rec,) = [s for s in profiling.spans() if s["name"] == "model.net"]
    profiling.reset_spans()
    # the stem and three chains in each of the four blocks, all plain on the CPU
    assert rec["counts"]["bn_plain"]["n"] == 13
    assert "bn_fused" not in rec["counts"]
    # off the profiler nothing is recorded
    model(x)
    assert profiling.spans() == []


def _reader(name: str):
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    path = REPO / "benchmark_port" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("_bn_reader_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _span(i, counts, name="model.net", parent=None):
    return {"name": name, "id": i, "parent": parent, "top": 1, "host_enter_ns": 0,
            "host_exit_ns": 1, "device_enter_ns": None, "device_exit_ns": None,
            "counts": {k: {"n": n, "blocked_s": 0.0} for k, n in counts.items()}}


@pytest.mark.parametrize("kind", ["eval", "train"])
def test_bn_fused_share_readers(kind):
    reader = _reader(f"bn_fused_share.{kind}")
    other = "train" if kind == "eval" else "eval"
    spans = [_span(1, {}, name="attack"), _span(2, {"bn_fused": 49, "syncs": 2}, parent=1),
             _span(3, {"bn_fused": 49}, parent=1), _span(4, {"bn_plain": 49}, parent=1)]
    assert reader.read({"kind": kind}, spans=spans) == pytest.approx(100.0 * 98 / 147)
    assert reader.read({"kind": other}, spans=spans) is None
    # a program without the counters (the parent commit): nothing to read
    assert reader.read({"kind": kind}, spans=[_span(1, {"syncs": 2})]) is None
    assert reader.read({"kind": kind}, spans=[]) is None
    manifest = json.loads((REPO / "BENCHMARK.json").read_text())
    (entry,) = [m for m in manifest["per_layer"] if m["name"] == f"bn_fused_share.{kind}"]
    assert entry["layer"] == "models" and entry["source"] == "program_counter"
    assert entry["moves"] == ("eval_ex_per_s" if kind == "eval" else "train_ex_per_s")


# ---------------------------------------------------------------------------
# the launch counters and the backward's gradient operand (the launchers
# stood in for: the bookkeeping around them runs on the CPU)
# ---------------------------------------------------------------------------

class _FakeLibrary:
    def bn_act_forward_launch(self, *args):
        return 0

    def bn_act_backward_launch(self, *args):
        return 0


@pytest.mark.parametrize("mode", [bn_act.RELU, bn_act.ADD_RELU, bn_act.BN_ADD_RELU])
def test_launches_counted_by_variant_and_direction(monkeypatch, mode):
    monkeypatch.setattr(bn_act, "load_library", lambda name: _FakeLibrary())
    monkeypatch.setattr(bn_act, "_stream", lambda t: 0)
    bn, x = _frozen_bn(16), _act((2, 16, 5, 3))
    z = None if mode == bn_act.RELU else _act((2, 16, 5, 3), seed=2)
    stats = bn_act._bn_tensors(bn)
    p = (mode, bn.eps, [t.data_ptr() for t in stats], [None] * 4, (stats, None))
    monkeypatch.setattr(bn_act, "LAUNCHES", dict.fromkeys(bn_act.LAUNCHES, 0))
    y = bn_act._forward(x, z, p)
    bn_act._backward(torch.ones_like(y), y, p)
    bn_act._backward(torch.ones_like(y), y, p, with_z=False)  # the bn_relu kernel
    variant = bn_act.VARIANTS[mode]
    want = dict.fromkeys(bn_act.LAUNCHES, 0)
    want[variant] += 1
    want[variant + "_backward"] += 1
    want["bn_relu_backward"] += 1
    assert bn_act.launch_counts() == want


def test_backward_takes_an_aligned_channels_last_gradient():
    y = _act((2, 16, 5, 3))
    assert bn_act._grad_operand(y, y) is y
    # a channels_last view one element into its storage: 2 bytes off 16
    storage = torch.zeros(y.numel() + 1, dtype=torch.bfloat16)
    shifted = storage[1:].view(2, 5, 3, 16).permute(0, 3, 1, 2)
    shifted.copy_(y)
    assert shifted.is_contiguous(memory_format=torch.channels_last)
    assert bn_act._act_refusal(shifted) == "not 16-byte aligned"
    for grad in (shifted, y.contiguous()):
        got = bn_act._grad_operand(grad, y)
        assert bn_act._act_refusal(got) is None and torch.equal(got, y)
    for bad in (y.float(), _act((2, 16, 5, 4))):
        with pytest.raises(ValueError, match="a gradient of"):
            bn_act._grad_operand(bad, y)


# ---------------------------------------------------------------------------
# the signature table
# ---------------------------------------------------------------------------

def test_bn_act_signature_table():
    assert build.SIGNATURES["bn_act"] is build.BN_ACT_SIGNATURES
    text = (build.CSRC_DIR / "bn_act.cu").read_text()
    fwd = "int bn_act_forward_launch(int mode, const void* x, const void* z,"
    bwd = "int bn_act_backward_launch(int mode, const void* grad, const void* y,"
    assert fwd in text and bwd in text
    assert len(build.BN_ACT_SIGNATURES["bn_act_forward_launch"][1]) == 16
    assert len(build.BN_ACT_SIGNATURES["bn_act_backward_launch"][1]) == 13
    # every kernel is named bn_..., which the benchmark counts as BatchNorm
    kernels = [line.rsplit("(", 1)[0].split()[-1] for line in text.splitlines()
               if line.startswith("__global__")]
    assert len(kernels) == 6 and all(k.startswith("bn_") for k in kernels), kernels
    classes = json.loads((REPO / "benchmark_port" / "kernel_classes.json").read_text())
    first = next(c for c, frags in classes if any(f in kernels[0].lower() for f in frags))
    assert first == "batchnorm"
    assert "fast_math" not in " ".join(build.NVCC_FLAGS) and "rsqrtf" in text


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the bn_act kernels have no CPU mode")
    return torch.device("cuda")


# ResNet-50's shapes at batch 128, and odd row counts (3*7*5 rows; 24
# channels: a block of 10 rows of 3 threads)
CARD_SHAPES = {
    "bn_relu": [(128, 64, 112, 112), (128, 512, 28, 28), (3, 24, 7, 5)],
    "bn_add_relu": [(128, 256, 56, 56), (128, 2048, 7, 7), (3, 64, 7, 5)],
    "bn_bn_add_relu": [(128, 1024, 14, 14), (128, 256, 56, 56), (3, 24, 7, 5)],
}


def _card_case(variant, shape, device):
    c = shape[1]
    bn = _frozen_bn(c, seed=11, device=device)
    x = _act(shape, seed=12, device=device)
    z = z_bn = None
    if variant != "bn_relu":
        z = _act(shape, seed=13, device=device)
    if variant == "bn_bn_add_relu":
        z_bn = _frozen_bn(c, seed=14, device=device)
    return x, bn, z, z_bn


@pytest.mark.cuda
@pytest.mark.parametrize("variant,shape", [(v, s) for v, ss in CARD_SHAPES.items() for s in ss])
def test_kernels_against_the_plain_chain_on_the_card(cuda, variant, shape):
    """Forward within one bf16 ulp of the plain composition on every element
    (the share that differ is printed); backward bit-identical to the plain
    composition's autograd, given the same forward."""
    x, bn, z, z_bn = _card_case(variant, shape, cuda)
    assert not isinstance(bn_act.plan(x, bn, z, z_bn), str)
    got = bn_act.bn_act(x, bn, z, z_bn)
    want = bn_act.bn_act_plain(x, bn, z, z_bn)
    torch.cuda.synchronize()
    assert got.is_contiguous(memory_format=torch.channels_last)
    ulp = torch.finfo(torch.bfloat16).eps * want.float().abs().clamp_min(2.0 ** -126)
    diff = (got.float() - want.float()).abs()
    share = float((diff > 0).float().mean())
    print(f"{variant} {shape}: forward differs from the plain chain on {share:.3e} of elements")
    assert bool((diff <= ulp).all()), float(diff.max())

    # the backward, given the plain forward's output
    xg = x.clone().requires_grad_(True)
    zg = None if z is None else z.clone().requires_grad_(True)
    y = bn_act.bn_act_plain(xg, bn, zg, z_bn)
    g = _act(shape, seed=15, device=cuda)
    g[..., ::7] = 0.0
    inputs = (xg,) if zg is None else (xg, zg)
    want_grads = torch.autograd.grad(y, inputs, g)
    gx, gz = bn_act._backward(g, y.detach(), bn_act.plan(x, bn, z, z_bn))
    torch.cuda.synchronize()
    assert torch.equal(gx, want_grads[0])
    if zg is not None:
        assert torch.equal(gz, want_grads[1])

    # and through autograd: the Function's gradients are the kernel's
    xf = x.clone().requires_grad_(True)
    zf = None if z is None else z.clone().requires_grad_(True)
    yf = bn_act.bn_act(xf, bn, zf, z_bn)
    assert torch.equal(yf, got)
    got_grads = torch.autograd.grad(yf, (xf,) if zf is None else (xf, zf), g)
    mask_same = torch.equal(yf > 0, y > 0)
    if mask_same:
        for a, b in zip(got_grads, want_grads):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_refusals_on_the_card(cuda):
    bn = _frozen_bn(64, device=cuda)
    x = _act((2, 64, 5, 3), device=cuda)
    for bad in (x.contiguous(), x.float()):
        with pytest.raises(ValueError, match="do not take"):
            bn_act.bn_act(bad, bn)
    # the launchers' own refusal of a channel count they do not take
    lib = build.load_library("bn_act")
    out = torch.empty_like(x)
    ptrs = [t.data_ptr() for t in bn_act._bn_tensors(bn)]
    stream = torch.cuda.current_stream().cuda_stream
    assert lib.bn_act_forward_launch(0, x.data_ptr(), None, *ptrs, *[None] * 4, out.data_ptr(),
                                     30, 12, 1e-5, stream) == -1
    assert lib.bn_act_backward_launch(0, x.data_ptr(), x.data_ptr(), ptrs[1], ptrs[2], None,
                                      None, out.data_ptr(), None, 15, 4096, 1e-5, stream) == -1
    with pytest.raises(ValueError, match="does not take"):
        bn_act._raise_on_error("bn_act", -1)


@pytest.mark.cuda
def test_launches_count_a_pgd10_run_exactly(cuda):
    """49 chains a ResNet-50 pass (the stem and two a block bn_relu, each
    identity block's last bn_add_relu, each projecting block's last, with
    both its BatchNorms, bn_bn_add_relu): PGD-10 launches 10 passes of each
    direction, and the prediction one forward more."""
    from image_recognition_adversarial_example_attack_tpu_torch.attacks.api import (
        AttackParams, make_logits_fn, predict_labels, run_attack)
    from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed
    from image_recognition_adversarial_example_attack_tpu_torch.models.zoo import load_model

    with pytest.warns(UserWarning, match="no weights found"):
        b = load_model("resnet50", dtype=torch.bfloat16, device=cuda)
    lf = make_logits_fn(b.model, b.mean, b.std, input_dtype=torch.bfloat16)
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.rand((4, 96, 96, 3), generator=g, device=cuda)
    y = torch.randint(0, 1000, (4,), generator=g, device=cuda)
    bn_act.reset_launches()
    x_adv = run_attack("pgd", lf, x, y, AttackParams(eps=8 / 255, alpha=2 / 255, steps=10),
                       generator_from_seed(1))
    per_pass = {"bn_relu": 33, "bn_add_relu": 12, "bn_bn_add_relu": 4}
    want = {f"{v}{d}": 10 * n for d in ("", "_backward") for v, n in per_pass.items()}
    assert bn_act.launch_counts() == want
    predict_labels(lf, x_adv)
    assert bn_act.launch_counts() == {k: v + (per_pass[k] if k in per_pass else 0)
                                      for k, v in want.items()}


@pytest.mark.cuda
def test_resnet50_fused_against_plain_on_the_card(cuda):
    """The whole bf16 ResNet-50 on the card, fused against the plain route
    (BatchNorm weights that require grad send every chain to it): logits
    and input gradients, the share of elements that differ printed."""
    from image_recognition_adversarial_example_attack_tpu_torch.models.zoo import load_model

    with pytest.warns(UserWarning, match="no weights found"):
        model = load_model("resnet50", dtype=torch.bfloat16, device=cuda).model
    x = torch.rand((8, 3, 224, 224), generator=torch.Generator(device=cuda).manual_seed(3),
                   device=cuda).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    torch.backends.cudnn.deterministic = True
    try:
        fused = _logits_and_grad(model, x)
        bns = [m for m in model.modules() if isinstance(m, resnet.FrozenBatchNorm2d)]
        for m in bns:
            m.weight.requires_grad_(True)
        plain = _logits_and_grad(model, x)
        for m in bns:
            m.weight.requires_grad_(False)
    finally:
        torch.backends.cudnn.deterministic = False
    for name, a, b in zip(("logits", "input grad"), fused, plain):
        a, b = a.detach().float(), b.detach().float()
        rel = float((a - b).norm() / b.norm())
        print(f"resnet50 {name}: fused vs plain rel {rel:.3e}, "
              f"differ on {float((a != b).float().mean()):.3e}")
        assert rel < 2e-2, rel
