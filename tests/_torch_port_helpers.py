"""Shared set-up of the port's parity tests (tests/test_torch_*.py).

The JAX package's Flax ResNet is initialized, its BatchNorm statistics and
affine parameters are perturbed from a numpy seed (so that BatchNorm is not
an identity), and the same variables are carried into the port through
``models.convert.from_jax_variables``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from image_recognition_adversarial_example_attack_tpu.models import resnet as jax_resnet
from image_recognition_adversarial_example_attack_tpu_torch.models import resnet as port_models
from image_recognition_adversarial_example_attack_tpu_torch.models.convert import (
    from_jax_variables)

JAX_DTYPES = {np.float64: jnp.float64, np.float32: jnp.float32}
TORCH_DTYPES = {np.float64: torch.float64, np.float32: torch.float32}


def _perturb(tree, rng, path=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng, path + (k,))
            continue
        v = np.asarray(v, np.float64)
        if k == "mean" or (k == "bias" and v.ndim == 1 and "fc" not in path):
            v = v + rng.randn(*v.shape) * 0.1
        elif k == "var":
            v = rng.uniform(0.5, 1.5, v.shape)
        elif k == "scale":
            v = rng.uniform(0.7, 1.3, v.shape)
        out[k] = v
    return out


def flax_resnet(name: str, dtype=np.float64, num_classes: int | None = None,
                size: int = 32, seed: int = 0):
    """(flax module computing in ``dtype``, numpy variables of ``dtype``)."""
    factory = getattr(jax_resnet, name)
    kw = {} if num_classes is None else {"num_classes": num_classes}
    module = factory(dtype=JAX_DTYPES[dtype], **kw)
    variables = jax.jit(module.init)(jax.random.PRNGKey(0),
                                     jnp.zeros((1, size, size, 3), JAX_DTYPES[dtype]))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    variables = {k: dict(v) for k, v in variables.items()}
    perturbed = _perturb(variables, np.random.RandomState(seed))
    return module, jax.tree_util.tree_map(lambda a: np.asarray(a, dtype), perturbed)


def port_resnet(name: str, variables, dtype=np.float64, num_classes: int | None = None):
    """The port's model with the Flax variables bridged in (strict load)."""
    kw = {} if num_classes is None else {"num_classes": num_classes}
    model = getattr(port_models, name)(**kw).to(TORCH_DTYPES[dtype])
    model.load_state_dict(from_jax_variables(variables), strict=True)
    model.requires_grad_(False)
    return model.eval()


def torchvision_resnet50_keys() -> set[str]:
    """torchvision's resnet50 state-dict key set, written out from its
    architecture (320 keys), independently of the port's module tree."""
    keys = {"conv1.weight", "fc.weight", "fc.bias"}
    bn = ("weight", "bias", "running_mean", "running_var", "num_batches_tracked")
    keys |= {f"bn1.{leaf}" for leaf in bn}
    for stage, n_blocks in enumerate((3, 4, 6, 3), start=1):
        for i in range(n_blocks):
            p = f"layer{stage}.{i}"
            for j in (1, 2, 3):
                keys.add(f"{p}.conv{j}.weight")
                keys |= {f"{p}.bn{j}.{leaf}" for leaf in bn}
            if i == 0:
                keys.add(f"{p}.downsample.0.weight")
                keys |= {f"{p}.downsample.1.{leaf}" for leaf in bn}
    return keys
