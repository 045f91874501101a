"""The reference against the program on the CPU in float32, at small input
sizes: ResNet-50 at its published widths on 64x64 images, and ViT at a
small width, both with the benchmark's own weights."""

from __future__ import annotations

import json

import torch

from conftest import BENCH, load_harness

harness = load_harness(BENCH)


def _logits_pair(config, port_model, seed=2**31 + 11, batch=2):
    ref = harness.load(f"reference/{config['reference']}")
    inputs = harness.load("inputs")
    chk = harness.load("reference/check_attack")
    sd = inputs.make_weights(ref.param_spec(config), ref.POSITIVE, seed, "cpu")
    port_model.load_state_dict(sd, strict=True)
    port_model.eval()
    x, _ = inputs.make_batch(seed, 0, batch, config["image_size"], config["num_classes"], "cpu")
    from image_recognition_adversarial_example_attack_tpu_torch.attacks.api import make_logits_fn

    with torch.no_grad():
        z_port = make_logits_fn(port_model, config["mean"], config["std"])(x)
        z_ref = chk.make_logits_fn(ref.forward, sd, config, "cpu")(x)
    return z_port, z_ref


def test_resnet50_reference_matches_the_port():
    from image_recognition_adversarial_example_attack_tpu_torch.models.resnet import resnet50

    config = json.loads((BENCH / "configs" / "resnet50-in224-bf16.json").read_text())
    config["image_size"] = 64
    z_port, z_ref = _logits_pair(config, resnet50())
    assert z_ref.std() > 0.1  # logits of unit scale, not saturated
    assert torch.allclose(z_port, z_ref, rtol=1e-4, atol=1e-4), (z_port - z_ref).abs().max()


def test_vit_reference_matches_the_port():
    from image_recognition_adversarial_example_attack_tpu_torch.models.vit import ViT

    config = json.loads((BENCH / "configs" / "vit_b_16-in224-bf16.json").read_text())
    config.update(patch_size=8, hidden_dim=32, num_layers=2, num_heads=2, mlp_dim=64,
                  num_classes=10, image_size=32)
    port = ViT(patch_size=8, dim=32, depth=2, num_heads=2, mlp_dim=64, num_classes=10,
               image_size=32)
    z_port, z_ref = _logits_pair(config, port)
    assert z_ref.std() > 0.1
    assert torch.allclose(z_port, z_ref, rtol=1e-5, atol=1e-5), (z_port - z_ref).abs().max()


def test_resnet_stage3_reference_matches_the_port():
    from image_recognition_adversarial_example_attack_tpu_torch.models.resnet import resnet50

    config = json.loads((BENCH / "configs" / "resnet50-in224-bf16.json").read_text())
    config["image_size"] = 64
    ref, inputs = harness.load("reference/resnet"), harness.load("inputs")
    sd = inputs.make_weights(ref.param_spec(config), ref.POSITIVE, 5, "cpu")
    port = resnet50()
    port.load_state_dict(sd)
    x = torch.rand(2, 3, 64, 64)
    with torch.no_grad():
        assert torch.allclose(port.features_stage3(x), ref.features_stage3(x, sd, config),
                              rtol=1e-4, atol=1e-4)


def test_plain_pgd_step_and_quantize_match_the_ports_plain_versions():
    from image_recognition_adversarial_example_attack_tpu_torch.kernels import elementwise

    plain = harness.load("reference/plain_kernels")
    g = torch.Generator().manual_seed(3)
    x0 = torch.rand(4, 8, 8, 3, generator=g)
    x = torch.clamp(x0 + (torch.rand(x0.shape, generator=g) - 0.5) * 0.06, 0, 1)
    grad = torch.randn(x0.shape, generator=g)
    grad[0, 0, 0] = 0.0
    eps, alpha = 8 / 255, 2 / 255
    assert torch.equal(plain.pgd_step(x, torch.sign(grad), x0, eps, alpha),
                       elementwise.pgd_step_plain(x, grad, x0, eps, alpha))
    assert torch.equal(plain.quantize(x * 1.2 - 0.1, 16),
                       elementwise.quantize_plain(x * 1.2 - 0.1, 16))


def test_plain_defend_matches_the_ports_defense_chain():
    from image_recognition_adversarial_example_attack_tpu_torch.defenses.preprocess import (
        DefenseConfig, defend_input)

    plain = harness.load("reference/plain_kernels")
    x = torch.rand(2, 16, 16, 3, generator=torch.Generator().manual_seed(4)) * 1.1 - 0.05
    assert torch.equal(plain.defend(x, 16), defend_input(x, DefenseConfig()))


def test_philox_copy_is_counter_based_and_uniform():
    plain = harness.load("reference/plain_kernels")
    a = plain.uniform_noise((1000, 7), 0.5, 2**62 + 12345, "cpu")
    b = plain.uniform_noise((7000,), 0.5, 2**62 + 12345, "cpu")
    assert torch.equal(a.reshape(-1), b)  # element i depends on (seed, i) alone
    assert a.min() >= -0.5 and a.max() < 0.5
    assert abs(float(a.mean())) < 0.01 and abs(float(a.var()) - 1 / 12) < 0.005
    # the published Philox4x32-10 known-answer vector (Salmon et al.): counter
    # and key all zero
    words = plain.philox4x32_10(torch.zeros(1, dtype=torch.int64),
                                torch.zeros(1, dtype=torch.int64), 0)
    assert [int(w) for w in words] == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
