"""Entry points of a quick check: a one-card forward and a multi-card dry run
(the port's counterpart of the repository's ``__graft_entry__.py``).

``entry()``             -> (forward callable, example args) on the flagship
                           model: ResNet-50 at 224², bf16 compute, on the card.
``dryrun_multichip(n)`` -> builds an n-slot ('data', 'model') mesh (a model
                           axis of 2 when n is even), runs one sharded
                           evaluation step (PGD + defense + detector, the
                           counters summed over the data axis) through
                           tensor-parallel models, one data-parallel PGD-AT
                           step with ``grad_accum=2`` and remat, and checks
                           ViT's tensor parallelism (the qkv shard at most
                           half its kernel, the logits within 1e-4 of the
                           replicated ones); it prints the JAX dry run's JSON
                           line.

Where fewer than n cards are visible the slots repeat the visible cards
round-robin, so the dry run still runs on the card; it never moves to the
CPU on its own (``device="cpu"`` is for the tests).

    python -c "from image_recognition_adversarial_example_attack_tpu_torch.entry import \\
        dryrun_multichip; dryrun_multichip(4)"
"""

from __future__ import annotations

import json

import numpy as np
import torch

from .attacks.api import make_logits_fn
from .core.constants import IMAGENET_MEAN, IMAGENET_STD
from .core.device import resolve_device
from .models.zoo import random_init_, set_compute_dtype


def entry(device: torch.device | str = "cuda"):
    """The bf16 ResNet-50 logits callable (seeded random weights) and an
    example ``[8, 224, 224, 3]`` input, both on ``device``."""
    from .models.resnet import resnet50

    device = resolve_device(device)
    model = random_init_(resnet50()).requires_grad_(False).eval()
    set_compute_dtype(model, torch.bfloat16)
    model.to(device=device, memory_format=torch.channels_last)
    logits_fn = make_logits_fn(model, IMAGENET_MEAN, IMAGENET_STD, input_dtype=torch.bfloat16)
    x = torch.zeros((8, 224, 224, 3), dtype=torch.float32, device=device)
    return logits_fn, (x,)


def mesh_slots(n_devices: int, device: torch.device | str = "cuda") -> list[torch.device]:
    """``n_devices`` slots over the visible devices, round-robin (the CPU:
    every slot the CPU)."""
    from .parallel.mesh import visible_devices

    visible = visible_devices(device)
    return [visible[i % len(visible)] for i in range(int(n_devices))]


def dryrun_multichip(n_devices: int, device: torch.device | str = "cuda") -> dict:
    """One sharded evaluation step and one PGD-AT step on an n-slot mesh;
    prints two lines (a summary and the JSON line) and returns the JSON."""
    from .defenses.detector import make_features_fn
    from .eval.defense_eval import DefenseEvalConfig
    from .models.resnet import resnet_tiny
    from .models.vit import vit_tiny
    from .models.zoo import ModelBundle
    from .parallel.data_parallel import evaluate_defenses_sharded, shard_labels, sharded_counts
    from .parallel.mesh import PerDevice, make_mesh, shard_batch
    from .parallel.tensor_parallel import shard_fractions, tensor_parallel_model
    from .train.adversarial import AdvTrainConfig, make_train_step, train_state_from_bundle

    device = resolve_device(device)
    slots = mesh_slots(n_devices, device)
    n_model = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    mesh = make_mesh(n_data=n_devices // n_model, n_model=n_model, devices=slots)
    lead = slots[0]
    if device.type == "cuda":
        # the TP check compares float32 logits
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    model = random_init_(resnet_tiny(num_classes=16)).requires_grad_(False).eval().to(lead)
    size, batch = 64, 2 * n_devices
    # each data row's model: stage convs and head cut over the row's model
    # slots (replicated when the model axis is 1)
    rows = {str(r[0]): i for i, r in enumerate(mesh.devices)}
    tp = PerDevice(lambda d: tensor_parallel_model(model, mesh, "resnet", data_row=rows[str(d)]))
    logits_fn = PerDevice(lambda d: make_logits_fn(tp(d), IMAGENET_MEAN, IMAGENET_STD))
    features_fn = PerDevice(lambda d: make_features_fn(tp(d), IMAGENET_MEAN, IMAGENET_STD))
    config = DefenseEvalConfig(attack_name="pgd", eps=8 / 255, alpha=2 / 255, steps=2,
                               cw_steps=2)
    rng = np.random.RandomState(0)
    x_np = rng.rand(batch, size, size, 3).astype(np.float32)
    x = shard_batch(x_np, mesh)
    y = shard_labels(np.zeros((batch,), np.int64), mesh)
    gen = torch.Generator().manual_seed(0)
    out = evaluate_defenses_sharded(logits_fn, features_fn, x, y, 1.0, config, gen)
    counters = sharded_counts(out)
    counters.pop("count")
    assert tuple(out["x_adv"].shape) == (batch, size, size, 3)
    assert counters["attack_success"] >= 0

    # one PGD-AT step over the data axis: grad_accum's micro-batches and the
    # checkpointed backward compose with the sum of the gradients
    at_cfg = AdvTrainConfig(eps=8 / 255, alpha=2 / 255, attack_steps=2, learning_rate=1e-3,
                            grad_accum=2, remat=True)
    bundle = ModelBundle(name="resnet_tiny", model=model, source="random",
                         dtype=torch.float32, device=lead, input_size=size)
    state = train_state_from_bundle(bundle, at_cfg)
    state, metrics = make_train_step(at_cfg)(state, x, y, torch.Generator().manual_seed(1))
    assert state.step == 1
    assert bool(torch.isfinite(metrics["loss"]))

    # tensor parallelism on the model axis: ViT's qkv, MLP and head cut over
    # 'model', the logits equal to the replicated forward's
    tp_frac = 1.0
    if n_model > 1:
        vit = random_init_(vit_tiny(num_classes=16)).requires_grad_(False).eval().to(lead)
        vit_tp = tensor_parallel_model(vit, mesh, "vit")
        fracs = shard_fractions(vit_tp, vit)
        tp_frac = fracs["encoder.layers.encoder_layer_0.self_attention.in_proj_weight"]
        assert tp_frac <= 0.5 + 1e-9, "qkv kernel did not partition"
        xv = torch.from_numpy(rng.rand(batch, 32, 32, 3).astype(np.float32)).to(lead)
        with torch.no_grad():
            got = make_logits_fn(vit_tp, IMAGENET_MEAN, IMAGENET_STD)(xv)
            want = make_logits_fn(vit, IMAGENET_MEAN, IMAGENET_STD)(xv)
        # numpy's assert_allclose(atol=1e-4, rtol=1e-4), as the JAX dry run
        err = float((got - want).abs().max())
        assert bool(((got - want).abs() <= 1e-4 + 1e-4 * want.abs()).all()), (
            f"ViT TP logits differ from the replicated ones by {err}")

    print(f"dryrun_multichip OK: mesh={mesh.shape} batch={batch} counters={counters} "
          f"train_loss={float(metrics['loss']):.4f} vit_tp_shard_frac={tp_frac:.2f}")
    line = {"dryrun_multichip": "ok", "n_devices": int(n_devices), "mesh": mesh.shape,
            "batch": batch, "vit_tp": bool(n_model > 1),
            "platform": "gpu" if device.type == "cuda" else "cpu",
            "devices_visible": len({str(s) for s in slots})}
    print(json.dumps(line))
    return line
