"""Swin-L in the port (``models/swin.py::swin_l``, the zoo's port-only name
``swin_l``) against the benchmark's plain reference
(``benchmark_port/reference/swin.py``), on the CPU.

No forward runs at Swin-L's widths: its count of parameters, its
multiply-accumulates (``benchmark_port/flops/swin.py``) and its state-dict
keys are read on the meta device, and the forward passes run at a narrow
width (C = 32, heads of 32, as Swin-L's) with Swin-L's depths and window on
two 224x224 images, so every stage map and shift of Swin-L is taken, and at
``swin_tiny_test``'s shapes.  Also: the static relative position index on
loading, and the spans and counters that a profiler session records.
"""

from __future__ import annotations

import importlib.util
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from image_recognition_adversarial_example_attack_tpu_torch.attacks.api import make_logits_fn
from image_recognition_adversarial_example_attack_tpu_torch.models import swin, zoo
from image_recognition_adversarial_example_attack_tpu_torch.models.convert import (
    from_jax_variables, to_jax_variables)
from image_recognition_adversarial_example_attack_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parent.parent
MEAN, STD = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]
SWIN_L = dict(patch_size=4, embed_dim=192, depths=[2, 2, 18, 2], num_heads=[6, 12, 24, 48],
              window_size=7, mlp_ratio=4, image_size=224, num_classes=1000, mean=MEAN, std=STD)
SWIN_T = dict(SWIN_L, embed_dim=96, depths=[2, 2, 6, 2], num_heads=[3, 6, 12, 24])
# Swin-L's depths, window and head size (32) at a narrow width, 224x224
NARROW_L = dict(SWIN_L, embed_dim=32, num_heads=[1, 2, 4, 8], num_classes=10)
# swin_tiny_test's shapes: 32x32, patch 2, window 4
TINY = dict(SWIN_L, patch_size=2, embed_dim=16, depths=[2, 2], num_heads=[2, 4], window_size=4,
            image_size=32, num_classes=10)
SHAPES = {"narrow_swin_l": NARROW_L, "swin_tiny_test": TINY}


def _bench(relative: str):
    """A file of the benchmark, loaded by its path."""
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    path = REPO / "benchmark_port" / f"{relative}.py"
    spec = importlib.util.spec_from_file_location(
        "_swin_bench_" + relative.replace("/", "_").replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


ref = _bench("reference/swin")
inputs = _bench("inputs")


def _port(config) -> swin.SwinTransformer:
    return swin.SwinTransformer(patch_size=config["patch_size"], embed_dim=config["embed_dim"],
                                depths=tuple(config["depths"]),
                                num_heads=tuple(config["num_heads"]),
                                window=config["window_size"], num_classes=config["num_classes"])


def _loaded(config, seed):
    """The port with the benchmark's seeded weights (strict load), and them."""
    sd = inputs.make_weights(ref.param_spec(config), ref.POSITIVE, seed, "cpu")
    model = _port(config)
    model.load_state_dict(sd, strict=True)
    return model.requires_grad_(False).eval(), sd


def _logits_and_grad(logits_fn, x, y):
    x = x.clone().requires_grad_(True)
    z = logits_fn(x)
    (g,) = torch.autograd.grad(F.cross_entropy(z, y, reduction="sum"), x)
    return z.detach(), g


# ---------------------------------------------------------------------------
# the port against the plain reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", list(SHAPES))
def test_the_port_matches_the_plain_reference_in_logits_and_input_gradients(shape):
    """float32 on both sides, through the benchmark's own logits closures.
    The two compute the same products in the same order but for the
    attention's additive terms (the port adds the mask to the bias, then the
    sum to the scores; the reference adds them to the scores in turn) and
    their layouts, so they may part by float32 rounding: 1e-5 of the logits'
    scale (order 1), and 1e-5 of the largest input-gradient element."""
    config = SHAPES[shape]
    seed = 2**33 + 5
    model, sd = _loaded(config, seed)
    x, y = inputs.make_batch(seed, 0, 2, config["image_size"], config["num_classes"], "cpu")
    chk = _bench("reference/check_attack")
    z_port, g_port = _logits_and_grad(make_logits_fn(model, MEAN, STD), x, y)
    z_ref, g_ref = _logits_and_grad(chk.make_logits_fn(ref.forward, sd, config, "cpu"), x, y)
    assert z_ref.std() > 0.1  # logits of unit scale, not saturated
    assert torch.allclose(z_port, z_ref, rtol=1e-5, atol=1e-5), (z_port - z_ref).abs().max()
    scale = float(g_ref.abs().max())
    assert scale > 0
    assert torch.allclose(g_port, g_ref, rtol=0, atol=1e-5 * scale), (g_port - g_ref).abs().max()


@pytest.mark.parametrize("window,side", [(7, 56), (7, 28), (7, 14), (4, 16), (4, 8)])
def test_the_references_index_and_mask_are_the_ports_static_ones(window, side):
    """The reference derives them from the paper's definitions on its own;
    they equal the port's numpy tables at every stage map of Swin-L and of
    swin_tiny_test."""
    assert torch.equal(ref.relative_index(window).reshape(-1),
                       torch.from_numpy(swin.relative_position_index(window).reshape(-1)))
    shift = window // 2
    np.testing.assert_array_equal(ref.shift_mask(side, side, window, shift).numpy(),
                                  swin.shift_attn_mask(side, side, window, shift))


# ---------------------------------------------------------------------------
# the published widths, on the meta device
# ---------------------------------------------------------------------------

def test_swin_l_is_built_at_its_published_widths():
    with torch.device("meta"):
        model = zoo.build_model("swin_l")
    assert sum(p.numel() for p in model.parameters()) == 196_532_476
    blocks = [b for b in model.modules() if isinstance(b, swin.SwinBlock)]
    assert len(blocks) == 24
    widths = [b.norm1.normalized_shape[0] for b in blocks]
    assert widths == [192] * 2 + [384] * 2 + [768] * 18 + [1536] * 2
    assert all(b.attn.window == 7 and b.norm1.normalized_shape[0] == 32 * b.attn.num_heads
               for b in blocks)
    assert [b.mlp[0].out_features for b in blocks] == [4 * w for w in widths]
    assert [b.attn.shift for b in blocks] == [0, 3] * 12
    assert model.features[0][0].stride == (4, 4) and model.head.out_features == 1000
    assert zoo.model_family("swin_l") == "swin"
    meta = zoo.model_meta("swin_l")
    assert meta["input_size"] == 224
    np.testing.assert_array_equal(meta["mean"], zoo.model_meta("swin_t")["mean"])
    np.testing.assert_array_equal(meta["std"], zoo.model_meta("swin_t")["std"])
    assert zoo.PORT_ONLY == ("swin_l",) and "swin_l" not in zoo.CONVERTIBLE


@pytest.mark.parametrize("name,config,gmac", [("swin_l", SWIN_L, 34.476), ("swin_t", SWIN_T, 4.49)])
def test_the_flop_count_reads_the_published_figures(name, config, gmac):
    """34.476 G at Swin-L and 4.49 G at Swin-T (torchvision's figure for
    swin_t; the paper's Table 1: 34.5 G and 4.5 G)."""
    flops = _bench("flops/swin")
    assert round(flops.forward_macs(config) / 1e9, 3 if name == "swin_l" else 2) == gmac


@pytest.mark.parametrize("name,config", [("swin_l", SWIN_L), ("swin_t", SWIN_T)])
def test_the_reference_spec_is_the_ports_state_dict_less_the_indices(name, config):
    with torch.device("meta"):
        sd = zoo.build_model(name).state_dict()
    spec = ref.param_spec(config)
    assert [s[0] for s in spec] == [k for k in sd if not k.endswith("relative_position_index")]
    assert all(tuple(sd[n].shape) == tuple(shape) for n, shape, _, _ in spec)


# ---------------------------------------------------------------------------
# the static index on loading
# ---------------------------------------------------------------------------

def test_a_state_dict_without_the_index_loads_strictly_and_keeps_the_static_index():
    model, sd = _loaded(TINY, 7)
    assert not any(k.endswith("relative_position_index") for k in sd)
    for m in model.modules():
        if isinstance(m, swin.WindowAttention):
            assert torch.equal(m.relative_position_index,
                               torch.from_numpy(swin.relative_position_index(4).reshape(-1)))
    # a missing float leaf is still missing
    del sd["head.bias"]
    with pytest.raises(RuntimeError, match=r"Missing key\(s\).*head\.bias"):
        _port(TINY).load_state_dict(sd, strict=True)


def test_a_wrong_index_raises_and_names_the_module():
    model, _ = _loaded(TINY, 8)
    sd = model.state_dict()
    key = "features.3.1.attn.relative_position_index"
    sd[key] = sd[key].flip(0)
    fresh = _port(TINY)
    with pytest.raises(RuntimeError, match=r"features\.3\.1\.attn\.relative_position_index: "
                                           r"not the static relative position index of a 4x4"):
        fresh.load_state_dict(sd, strict=True)
    assert torch.equal(fresh.features[3][1].attn.relative_position_index,
                       model.features[3][1].attn.relative_position_index)
    sd[key] = sd[key][:-1]  # of another shape
    with pytest.raises(RuntimeError, match="not the static relative position index"):
        _port(TINY).load_state_dict(sd, strict=False)


def test_a_torchvision_layout_state_dict_with_the_index_loads_as_before():
    model, _ = _loaded(TINY, 9)
    sd = model.state_dict()
    assert sum(k.endswith("relative_position_index") for k in sd) == 4
    again = _port(TINY)
    again.load_state_dict(sd, strict=True)
    for k, v in again.state_dict().items():
        assert torch.equal(v, sd[k]), k
    sd["features.1.0.attn.unexpected"] = torch.zeros(1)
    with pytest.raises(RuntimeError, match="Unexpected key"):
        _port(TINY).load_state_dict(sd, strict=True)


def test_swin_l_depths_round_trip_through_the_flax_bridge():
    """``.msgpack`` weights reach the port through the ``swin`` family's
    converter, which writes the index of each table's window."""
    model, _ = _loaded(NARROW_L, 10)
    back = _port(NARROW_L)
    back.load_state_dict(from_jax_variables(to_jax_variables(model, "swin"), "swin"), strict=True)
    for k, v in model.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k


# ---------------------------------------------------------------------------
# spans and counters
# ---------------------------------------------------------------------------

def _expected_children(depths):
    out = ["swin.embed"]
    for s, depth in enumerate(depths):
        if s > 0:
            out.append("swin.merge")
        out.extend(["swin.attn", "swin.mlp"] * depth)
    return out + ["swin.head"]


def _span_of(module_name: str) -> str:
    """The span that each leaf module's call must lie in, by its name."""
    if module_name.startswith("features.0."):
        return "swin.embed"
    if module_name in ("norm", "head"):
        return "swin.head"
    parts = module_name.split(".")
    if int(parts[1]) % 2 == 0:
        return "swin.merge"
    return "swin.attn" if parts[3] in ("norm1", "attn") else "swin.mlp"


@pytest.mark.parametrize("shape,shifted,plain", [("narrow_swin_l", 11, 13),
                                                 ("swin_tiny_test", 2, 2)])
def test_the_spans_tile_a_forward_and_count_each_window_attention(shape, shifted, plain):
    from torch.profiler import ProfilerActivity, profile

    config = SHAPES[shape]
    model, _ = _loaded(config, 11)
    x, _ = inputs.make_batch(11, 0, 1, config["image_size"], config["num_classes"], "cpu")
    calls = []  # (leaf module name, host ns at its call's start and end)
    handles = []
    for name, m in model.named_modules():
        if not list(m.children()) and not isinstance(m, torch.nn.Identity):
            handles.append(m.register_forward_pre_hook(
                lambda mod, a, n=name: calls.append([n, time.perf_counter_ns(), None])))
            handles.append(m.register_forward_hook(
                lambda mod, a, out: calls[-1].__setitem__(2, time.perf_counter_ns())))
    logits_fn = make_logits_fn(model, MEAN, STD)
    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]), torch.no_grad():
        logits_fn(x)
    spans = profiling.spans()
    profiling.reset_spans()
    for h in handles:
        h.remove()

    (net,) = [s for s in spans if s["name"] == "model.net"]
    children = [s for s in spans if s["parent"] == net["id"]]
    assert [s["name"] for s in children] == _expected_children(config["depths"])
    # leaves: no span below the model's own
    assert not any(s["parent"] in {c["id"] for c in children} for s in spans)
    # every leaf module's call lies in the span of its part of the model:
    # the patch conv and its LayerNorm; a block's norm1, qkv, proj, norm2 and
    # MLP (two linears, the GELU); a merging's LayerNorm and reduction; the
    # final LayerNorm and the head
    assert len(calls) == 2 + 7 * sum(config["depths"]) + 2 * (len(config["depths"]) - 1) + 2
    for name, t0, t1 in calls:
        assert any(s["name"] == _span_of(name) and s["host_enter_ns"] <= t0 <= t1
                   <= s["host_exit_ns"] for s in children), name
    counts = {k: sum(s["counts"].get(k, {"n": 0})["n"] for s in spans)
              for k in ("window_attn.shifted", "window_attn.plain")}
    assert counts == {"window_attn.shifted": shifted, "window_attn.plain": plain}
    assert all(set(s["counts"]) <= {"window_attn.shifted", "window_attn.plain"}
               and (not s["counts"] or s["name"] == "swin.attn") for s in children)
    # off a profiler session nothing is recorded
    with torch.no_grad():
        logits_fn(x)
    assert profiling.spans() == []
