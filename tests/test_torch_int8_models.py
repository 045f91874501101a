"""The six families with ``int8=True`` in the port against the JAX
families with ``int8=True`` on the CPU (ops/int8.py; the per-op parity is in
``test_torch_int8.py``).

The tiny variants run in float64 with the same weights, carried across by
``from_jax_variables``: the quantization casts to float32, so the two
frameworks' float64 differences (about 1e-15) do not move a rounding
decision, and logits and input gradients agree within 1e-9 (absolute; the
logits are of order 1).  The JAX reference is compiled with XLA's
algebraic simplifier off: with it, XLA's CPU compiler turns the division of
a scale by 127 into a multiplication by its reciprocal, one float32 ulp off
in some scales, where the function (and JAX run op by op) divides.
Each forward's quantized-op calls are counted against the JAX families'
hooked layers.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import module_time_limit, one_thread, time_limit  # noqa: F401 (autouse)
from _torch_port_helpers import init_shaped
from _torch_scaleout_helpers import seeded_variables
from image_recognition_adversarial_example_attack_tpu.core.constants import (
    IMAGENET_MEAN, IMAGENET_STD)
from image_recognition_adversarial_example_attack_tpu.core.normalize import (
    normalize_batch as jax_normalize)
from image_recognition_adversarial_example_attack_tpu_torch.core.normalize import (
    normalize_batch as port_normalize)
from image_recognition_adversarial_example_attack_tpu_torch.models.convert import (
    from_jax_variables)
from image_recognition_adversarial_example_attack_tpu_torch.ops import int8

MODEL_TOL = 1e-9
# XLA's algebraic simplifier turns a division by a constant into a
# multiplication by its reciprocal; without it the compiled reference divides
EXACT_DIVISION = {"xla_disable_hlo_passes": "algsimp"}

# test variant -> (module, the head whose output is the uncast logits, family)
FAMILIES = {
    "resnet_tiny": ("resnet", "fc"),
    "tiny": ("tiny", "Dense_0"),
    "vgg_tiny": ("vgg", "classifier_6"),
    "densenet_tiny": ("densenet", "classifier"),
    "vit_tiny": ("vit", "head"),
    "swin_tiny_test": ("swin", "head"),
}
# quantized-op calls per forward: (convs, linears), one per hooked layer
HOOKS = {"resnet_tiny": (1 + 4 * 3 + 4, 1), "tiny": (2, 1), "vgg_tiny": (2, 3),
         "densenet_tiny": (1 + 2 * 2 * 2 + 1, 1), "vit_tiny": (1, 2 * 4 + 1),
         "swin_tiny_test": (1, 4 * 4 + 1 + 1)}


def _jax_module(name, int8_on):
    family = FAMILIES[name][0]
    mod = importlib.import_module(f"image_recognition_adversarial_example_attack_tpu.models.{family}")
    if name == "tiny":
        return mod.TinyCNN(num_classes=10, dtype=jnp.float64, int8=int8_on)
    return getattr(mod, name)(dtype=jnp.float64, int8=int8_on)


def _port_model(name, int8_on):
    family = FAMILIES[name][0]
    mod = importlib.import_module(
        f"image_recognition_adversarial_example_attack_tpu_torch.models.{family}")
    if name == "tiny":
        return mod.TinyCNN(num_classes=10, int8=int8_on)
    return getattr(mod, name)(int8=int8_on)


def _perturb(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng)
            continue
        v = np.asarray(v, np.float64)
        if k == "var":
            v = rng.uniform(0.5, 1.5, v.shape)
        elif k == "scale":
            v = rng.uniform(0.7, 1.3, v.shape)
        elif k in ("mean", "bias", "class_token"):
            v = v + rng.randn(*v.shape) * 0.1
        out[k] = v
    return out


@pytest.fixture(scope="module", params=list(FAMILIES))
def family(request):
    name = request.param
    module = _jax_module(name, True)
    variables = seeded_variables(_port_model(name, True), FAMILIES[name][0],
                                 lambda t, rng: _perturb(init_shaped(t, module), rng), seed=3)
    model = _port_model(name, True).double()
    model.load_state_dict(from_jax_variables(variables, FAMILIES[name][0]), strict=True)
    model.requires_grad_(False).eval()
    x = np.random.RandomState(0).uniform(0, 1, (3, 32, 32, 3))
    return name, module, variables, model, x, np.array([1, 4, 7])


def _jax_logits(name, module, variables, x01):
    head = FAMILIES[name][1]
    _, state = module.apply(variables, jax_normalize(x01, IMAGENET_MEAN, IMAGENET_STD),
                            capture_intermediates=lambda mdl, _: mdl.name == head)
    return state["intermediates"][head]["__call__"][0]


def test_int8_families_equal_jaxs_logits_and_input_gradients(family):
    name, module, variables, model, x, y = family

    def ce(v):
        logits = _jax_logits(name, module, variables, v)
        loss = -jnp.take_along_axis(jax.nn.log_softmax(logits), jnp.asarray(y)[:, None], 1).sum()
        return loss, logits

    # compiled without the algebraic simplifier: the quantization divides
    # (see the module docstring)
    with jax.enable_x64():
        xj = jnp.asarray(x)
        fn = jax.jit(jax.value_and_grad(ce, has_aux=True)).lower(xj).compile(
            compiler_options=EXACT_DIVISION)
        (_, want), want_g = fn(xj)
        want, want_g = np.asarray(want), np.asarray(want_g)
    assert want.dtype == np.float64 and want.shape == (3, 10)
    xt = torch.from_numpy(x).requires_grad_(True)
    int8.reset_calls()
    logits = model(port_normalize(xt, IMAGENET_MEAN, IMAGENET_STD).permute(0, 3, 1, 2))
    assert tuple(int8.call_counts().values()) == HOOKS[name]
    loss = -torch.log_softmax(logits, -1).gather(-1, torch.from_numpy(y)[:, None]).sum()
    (grad,) = torch.autograd.grad(loss, xt)
    np.testing.assert_allclose(logits.detach().numpy(), want, rtol=0, atol=MODEL_TOL)
    np.testing.assert_allclose(grad.numpy(), want_g, rtol=0, atol=MODEL_TOL)
    assert np.abs(want_g).max() > 1e-4
    # quantization changes the function: the float model's logits differ
    float_model = _port_model(name, False).double()
    float_model.load_state_dict(model.state_dict(), strict=True)
    with torch.no_grad():
        ref = float_model(port_normalize(torch.from_numpy(x), IMAGENET_MEAN,
                                         IMAGENET_STD).permute(0, 3, 1, 2))
    assert np.abs(ref.numpy() - want).max() > 1e-6
