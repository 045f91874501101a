"""Swin's shifted-window attention kernel pair (``kernels/window_attn.py``,
``csrc/window_attn.cu``) and its route in ``models/swin.py::WindowAttention``.

On the CPU: the kernels' plain version, which takes the unpartitioned qkv
map with the shift folded into its indices, against the written-out
attention (``WindowAttention._attend``) in float32, forward and input
gradient; the route's choice for each thing it observes; the launch
counters and the gradient operand with the launchers stood in for; the
signature table.  Marked ``cuda``: the kernels on the card against the plain version at each Swin-L
stage's shape, their launch counts in a Swin-T PGD step, and their
refusals.  Run those on a machine with an H100:

    python -m pytest tests/test_torch_swin_window_attn.py -m cuda --noconftest
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import pytest
import torch

from _torch_port_helpers import module_time_limit, one_thread, time_limit  # noqa: F401 (autouse)
from image_recognition_adversarial_example_attack_tpu_torch.kernels import build, window_attn
from image_recognition_adversarial_example_attack_tpu_torch.models import swin

REPO = Path(__file__).resolve().parent.parent


def _attention(dim=64, heads=2, window=7, shift=3, seed=0, dtype=torch.float32,
               int8=False) -> swin.WindowAttention:
    """A WindowAttention with seeded weights and a bias table away from 0,
    no parameter requiring grad (as ``load_model`` leaves it)."""
    torch.manual_seed(seed)
    attn = swin.WindowAttention(dim, heads, window, shift, int8=int8)
    with torch.no_grad():
        attn.relative_position_bias_table.normal_(0.0, 0.5)
    return attn.to(dtype).requires_grad_(False).eval()


def _map(shape, seed=1, dtype=torch.float32, device="cpu") -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dtype).to(device)


# ---------------------------------------------------------------------------
# the plain version against the written-out attention, float32
# ---------------------------------------------------------------------------

# (map side, window, shift the block asks for): a 14x14 map shifted and
# plain, a one-window map (which does not shift), window 4 on 8x8
PLAIN_CASES = {"14x14_shifted": (14, 7, 3), "14x14_plain": (14, 7, 0),
               "one_window": (7, 7, 3), "8x8_window4_shifted": (8, 4, 2)}


@pytest.mark.parametrize("case", list(PLAIN_CASES))
def test_plain_version_matches_the_written_out_attention(case):
    side, window, shift = PLAIN_CASES[case]
    attn = _attention(window=window, shift=shift)
    x = _map((2, side, side, 64)).requires_grad_(True)
    sh = 0 if side <= window else shift
    want = attn._attend(x, sh)
    (want_g,) = torch.autograd.grad(want.square().sum(), x)
    got = attn.proj(window_attn.window_attn_plain(attn.qkv(x), attn.relative_position_bias_table,
                                                  attn.num_heads, window, sh))
    (got_g,) = torch.autograd.grad(got.square().sum(), x)
    for a, b in ((got.detach(), want.detach()), (got_g, want_g)):
        assert float((a - b).abs().max()) <= 1e-6 * max(1.0, float(b.abs().max()))


def test_the_plain_versions_index_and_mask_are_the_models_static_ones():
    for window in (4, 7):
        assert torch.equal(window_attn.relative_index(window),
                           torch.from_numpy(swin.relative_position_index(window)))
    for side, window, shift in ((14, 7, 3), (56, 7, 3), (8, 4, 2)):
        assert torch.equal(window_attn.seam_mask(side, side, window, shift),
                           torch.from_numpy(swin.shift_attn_mask(side, side, window, shift)))
    assert not window_attn.seam_mask(14, 14, 7, 0).any()
    rows, cols = window_attn.unrolled_positions(14, 7, 7, 3)
    assert rows.tolist() == [[3, 4, 5, 6, 7, 8, 9], [10, 11, 12, 13, 0, 1, 2]]
    assert cols.tolist() == [[3, 4, 5, 6, 0, 1, 2]]


# ---------------------------------------------------------------------------
# the route, from what it observes (the device is checked last)
# ---------------------------------------------------------------------------

def _route_case(name):
    """(x, attn, shift) of one case: everything the kernels take (but the
    device) except what ``name`` changes."""
    dim, heads, window, dtype, int8 = 64, 2, 7, torch.bfloat16, False
    if name == "head_dim_16":
        heads = 4
    elif name.startswith("window_"):
        window = int(name.split("_")[1])
    elif name == "float32":
        dtype = torch.float32
    elif name == "int8":
        int8 = True
    attn = _attention(dim, heads, window, window // 2, int8=int8, dtype=dtype)
    side = 2 * window
    x = _map((2, side, side, dim), dtype=dtype)
    if name == "table_grad":
        attn.relative_position_bias_table.requires_grad_(True)
    if name == "odd_map":
        x = _map((2, side + 1, side, dim), dtype=dtype)
    if name == "strided":
        x = x.transpose(1, 2)
    return x, attn, window // 2


ROUTE_CASES = {
    "cpu": "not a CUDA tensor",
    "float32": "not bfloat16",
    "int8": "int8",
    "table_grad": "requires grad",
    "head_dim_16": "head dim 32 only",
    "window_4": "window 7 only",
    "window_8": "window 7 only",
    "window_9": "window 7 only",
    "odd_map": "not a multiple of the window",
    "strided": "not contiguous",
}


@pytest.mark.parametrize("name", sorted(ROUTE_CASES))
def test_route_reports_each_observable(name):
    x, attn, shift = _route_case(name)
    with torch.enable_grad():
        why = window_attn.plan(x, attn, shift)
    assert isinstance(why, str) and ROUTE_CASES[name] in why, why


def test_a_table_that_requires_grad_is_taken_under_no_grad():
    x, attn, shift = _route_case("table_grad")
    with torch.no_grad():
        assert window_attn.plan(x, attn, shift) == "not a CUDA tensor (cpu)"


def test_direct_call_refuses_what_the_kernels_do_not_take():
    attn = _attention(dtype=torch.bfloat16)
    table = attn.relative_position_bias_table
    qkv = _map((2, 14, 14, 192), dtype=torch.bfloat16)
    before = window_attn.launch_counts()
    for bad, heads in ((qkv, 2), (qkv.float(), 2), (qkv, 3)):
        with pytest.raises(ValueError, match="do not take"):
            window_attn.window_attn(bad, table, heads, 7, 3)
    assert window_attn.launch_counts() == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_model_on_the_cpu_runs_the_written_out_attention(monkeypatch, dtype):
    """On the CPU every call takes ``_attend``, so the model's output is
    the written-out attention's, bit for bit."""
    attn = _attention(dtype=dtype)
    x = _map((2, 14, 14, 64), dtype=dtype)
    with torch.no_grad():
        want = attn._attend(x, 3)
        monkeypatch.setattr(window_attn, "launch", lambda *a: pytest.fail("launched"))
        got = attn(x)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the launch counters and the gradient operand (the launchers stood in for:
# the bookkeeping around them runs on the CPU)
# ---------------------------------------------------------------------------

class _FakeLibrary:
    def __init__(self):
        self.calls = []

    def window_attn_forward_launch(self, *args):
        self.calls.append(("forward", args))
        return 0

    def window_attn_backward_launch(self, *args):
        self.calls.append(("backward", args))
        return 0


def test_launches_counted_and_the_gradient_made_contiguous(monkeypatch):
    lib = _FakeLibrary()
    monkeypatch.setattr(window_attn, "load_library", lambda name: lib)
    monkeypatch.setattr(window_attn, "_stream", lambda t: 0)
    monkeypatch.setattr(window_attn, "LAUNCHES", dict.fromkeys(window_attn.LAUNCHES, 0))
    attn = _attention(dtype=torch.bfloat16)
    qkv = _map((2, 14, 14, 192), dtype=torch.bfloat16)
    table = attn.relative_position_bias_table
    p = (14, 14, 64, 2, 7, 3)
    out = window_attn._forward(qkv, table, p)
    assert out.shape == (2, 14, 14, 64) and out.dtype == torch.bfloat16
    grad = _map((2, 14, 14, 64), dtype=torch.bfloat16)
    strided = grad.transpose(1, 2).contiguous().transpose(1, 2)
    dqkv = window_attn._backward(qkv, table, strided, p)
    assert dqkv.shape == qkv.shape
    assert window_attn.launch_counts() == {"window_attn": 1, "window_attn_backward": 1}
    (_, fwd), (_, bwd) = lib.calls
    assert fwd[3:10] == (2, 14, 14, 64, 2, 7, 3) and bwd[4:11] == (2, 14, 14, 64, 2, 7, 3)
    assert fwd[0] == bwd[0] == qkv.data_ptr() and fwd[1] == bwd[1] == table.data_ptr()
    assert bwd[2] != strided.data_ptr()  # a strided gradient is copied, not read as it lies
    with pytest.raises(ValueError, match="a gradient of"):
        window_attn._backward(qkv, table, grad.float(), p)
    for bad in (qkv.float(), qkv[..., :96], qkv.transpose(1, 2)):
        with pytest.raises(ValueError, match="qkv of"):
            window_attn._forward(bad, table, p)
    assert window_attn.launch_counts() == {"window_attn": 1, "window_attn_backward": 1}


def test_window_attn_signature_table_and_kernel_names():
    assert build.SIGNATURES["window_attn"] is build.WINDOW_ATTN_SIGNATURES
    text = (build.CSRC_DIR / "window_attn.cu").read_text()
    assert "int window_attn_forward_launch(const void* qkv, const void* table, void* out," in text
    assert ("int window_attn_backward_launch(const void* qkv, const void* table, "
            "const void* grad_out,") in text
    assert len(build.WINDOW_ATTN_SIGNATURES["window_attn_forward_launch"][1]) == 11
    assert len(build.WINDOW_ATTN_SIGNATURES["window_attn_backward_launch"][1]) == 12
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in text
    assert "cp.async.cg.shared.global" in text
    for lib in ("cublas", "cudnn", "cutlass"):
        assert lib not in text.lower()
    # the kernels are none of the benchmark's norm or copy classes
    kernels = [line.rsplit("(", 1)[0].split()[-1] for line in text.splitlines()
               if line.startswith("__global__")]
    assert kernels == ["window_attn_kernel", "window_attn_backward_kernel"]
    classes = json.loads((REPO / "benchmark_port" / "kernel_classes.json").read_text())
    assert not [c for c, frags in classes for k in kernels if any(f in k for f in frags)]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the window attention kernels have no CPU mode")
    return torch.device("cuda")


# Swin-L's four stages at 224² (map side, heads), batch 2; each shifted
# (stage 4's one window too, which the model does not shift) and plain
SWIN_L_STAGES = [(56, 6), (28, 12), (14, 24), (7, 48)]
CARD_CASES = [(side, heads, shift) for side, heads in SWIN_L_STAGES for shift in (3, 0)]
# the kernels' bf16 tolerances against the plain version, as relative L2
# norms (``window_attn.FORWARD_REL_TOL``, ``BACKWARD_REL_TOL``)
_rel = window_attn.rel_l2


@pytest.mark.cuda
@pytest.mark.parametrize("side,heads,shift", CARD_CASES)
def test_kernels_against_the_plain_version_on_the_card(cuda, side, heads, shift):
    c = heads * 32
    g = torch.Generator(device=cuda).manual_seed(side + shift)
    qkv = torch.randn((2, side, side, 3 * c), generator=g, device=cuda).to(torch.bfloat16)
    table = (torch.randn((169, heads), generator=g, device=cuda) * 0.5).to(torch.bfloat16)
    dout = torch.randn((2, side, side, c), generator=g, device=cuda).to(torch.bfloat16)
    window_attn.reset_launches()
    got = window_attn.window_attn(qkv, table, heads, 7, shift)
    want = window_attn.window_attn_plain(qkv, table, heads, 7, shift)
    torch.cuda.synchronize()
    rel = _rel(got, want)
    print(f"[{side}x{side}, {heads} heads, shift {shift}] forward rel {rel:.3e}, differs on "
          f"{float((got != want).float().mean()):.3e}")
    assert rel < window_attn.FORWARD_REL_TOL, rel

    q1, q2 = qkv.clone().requires_grad_(True), qkv.clone().requires_grad_(True)
    (got_g,) = torch.autograd.grad(window_attn.window_attn(q1, table, heads, 7, shift), q1, dout)
    (want_g,) = torch.autograd.grad(window_attn.window_attn_plain(q2, table, heads, 7, shift),
                                    q2, dout)
    torch.cuda.synchronize()
    for part in range(3):
        sl = slice(part * c, (part + 1) * c)
        rel = _rel(got_g[..., sl], want_g[..., sl])
        print(f"  d{'qkv'[part]} rel {rel:.3e}")
        assert rel < window_attn.BACKWARD_REL_TOL, (part, rel)
    assert window_attn.launch_counts() == {"window_attn": 2, "window_attn_backward": 1}


@pytest.mark.cuda
def test_refusals_on_the_card(cuda):
    qkv = torch.randn((2, 14, 14, 192), device=cuda).to(torch.bfloat16)
    table = torch.zeros((169, 2), device=cuda, dtype=torch.bfloat16)
    leaf = table.clone().requires_grad_(True)
    before = window_attn.launch_counts()
    for bad, tab, heads in ((qkv.float(), table, 2), (qkv, table, 3),
                            (qkv[:, :, :13].contiguous(), table, 2),
                            (qkv, table.float(), 2), (qkv, leaf, 2)):
        with pytest.raises(ValueError, match="do not take"):
            window_attn.window_attn(bad, tab, heads, 7, 3)
    assert window_attn.launch_counts() == before
    # the launchers' own refusal of a head dim, windows and a shift they do not take
    lib = build.load_library("window_attn")
    out = torch.empty((2, 14, 14, 64), device=cuda, dtype=torch.bfloat16)
    stream = torch.cuda.current_stream().cuda_stream
    for ints in ((2, 14, 14, 64, 1, 7, 3), (2, 8, 8, 64, 2, 4, 2), (2, 16, 16, 64, 2, 8, 4),
                 (2, 18, 18, 64, 2, 9, 3), (2, 14, 14, 64, 2, 7, 7)):
        assert lib.window_attn_forward_launch(qkv.data_ptr(), table.data_ptr(), out.data_ptr(),
                                              *ints, stream) == -1
        assert lib.window_attn_backward_launch(qkv.data_ptr(), table.data_ptr(), out.data_ptr(),
                                               qkv.data_ptr(), *ints, stream) == -1
    with pytest.raises(ValueError, match="does not take"):
        window_attn._raise_on_error("window_attn", -1)


@pytest.mark.cuda
def test_swin_t_fused_against_written_out_on_the_card(cuda):
    """The whole bf16 Swin-T on the card, the kernels against the
    written-out attention (bias tables that require grad send every call to
    it): logits and input gradients, and one launch each way a block."""
    from image_recognition_adversarial_example_attack_tpu_torch.models.zoo import load_model

    with pytest.warns(UserWarning, match="no weights found"):
        model = load_model("swin_t", dtype=torch.bfloat16, device=cuda).model
    x = torch.rand((4, 3, 224, 224), generator=torch.Generator(device=cuda).manual_seed(3),
                   device=cuda).to(torch.bfloat16)

    def logits_and_grad():
        xg = x.clone().requires_grad_(True)
        z = model(xg).float()
        (g,) = torch.autograd.grad(z.logsumexp(-1).sum(), xg)
        return z.detach(), g

    window_attn.reset_launches()
    fused = logits_and_grad()
    assert window_attn.launch_counts() == {"window_attn": 12, "window_attn_backward": 12}
    tables = [m.relative_position_bias_table for m in model.modules()
              if isinstance(m, swin.WindowAttention)]
    for t in tables:
        t.requires_grad_(True)
    try:
        written = logits_and_grad()
    finally:
        for t in tables:
            t.requires_grad_(False)
    assert window_attn.launch_counts() == {"window_attn": 12, "window_attn_backward": 12}
    for name, a, b in zip(("logits", "input grad"), fused, written):
        rel = _rel(a, b)
        print(f"swin_t {name}: fused vs written-out rel {rel:.3e}")
        assert rel < 3e-2, rel
    assert math.isfinite(float(fused[1].float().norm()))
