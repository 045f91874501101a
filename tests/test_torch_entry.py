"""The port's entry points (entry.py, the counterpart of __graft_entry__.py)
on the CPU: ``dryrun_multichip(4, device="cpu")`` runs its sharded
evaluation step through tensor-parallel models, its PGD-AT step with
grad_accum and remat, and its ViT TP check, and prints JAX's JSON line;
``entry`` gives the bf16 ResNet-50 forward; the slots repeat the visible
devices round-robin; ``cuda`` is the default and raises without a card."""

import contextlib
import io
import json

import pytest
import torch

from image_recognition_adversarial_example_attack_tpu_torch.entry import (
    dryrun_multichip, entry, mesh_slots)


def test_dryrun_multichip_prints_the_json_line():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        got = dryrun_multichip(4, device="cpu")
    lines = buf.getvalue().splitlines()
    assert lines[0].startswith("dryrun_multichip OK: mesh={'data': 2, 'model': 2} batch=8 ")
    assert "vit_tp_shard_frac=0.50" in lines[0]
    assert json.loads(lines[-1]) == got
    assert got == {"dryrun_multichip": "ok", "n_devices": 4, "mesh": {"data": 2, "model": 2},
                   "batch": 8, "vit_tp": True, "platform": "cpu", "devices_visible": 1}


def test_entry_is_the_bf16_resnet50_forward():
    fn, (x,) = entry("cpu")
    assert x.shape == (8, 224, 224, 3) and x.dtype == torch.float32
    out = fn(x[:1])
    assert out.shape == (1, 1000) and out.dtype == torch.float32
    assert bool(torch.isfinite(out).all())


def test_slots_repeat_the_visible_devices():
    assert mesh_slots(3, "cpu") == [torch.device("cpu")] * 3


def test_cuda_is_the_default_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry()
