"""Shared set-up of the port's parity tests (tests/test_torch_*.py).

The JAX package's Flax ResNet is initialized (once a process for each
model), its BatchNorm statistics and affine parameters are perturbed from a
numpy seed (so that BatchNorm is not an identity), and the same variables
are carried into the port through ``models.convert.from_jax_variables``.

Every port test module takes the autouse fixtures here with one import
line, ``from _torch_port_helpers import module_time_limit, one_thread,
time_limit  # noqa: F401 (autouse)``: one intra-op thread per test process,
and a limit of ``TEST_TIME_LIMIT`` seconds on each test and on each module's
set-up.  The modules that load JAX models through the JAX package's zoo (its
CLIs) import ``jax_zoo_init_once`` on the same line.  JAX is imported only
inside the functions that use it, so that the files whose card tests run
where JAX is absent (``-m cuda --noconftest``) take the fixtures too.
"""

from __future__ import annotations

import signal
import threading

import numpy as np
import pytest
import torch

from image_recognition_adversarial_example_attack_tpu_torch.core.constants import (
    IMAGENET_MEAN, IMAGENET_STD)
from image_recognition_adversarial_example_attack_tpu_torch.core.normalize import (
    normalize_batch as port_normalize)
from image_recognition_adversarial_example_attack_tpu_torch.models import resnet as port_models
from image_recognition_adversarial_example_attack_tpu_torch.models.convert import (
    from_jax_variables)

TORCH_DTYPES = {np.float64: torch.float64, np.float32: torch.float32}
# seconds a port test may run (its call and its fixtures' set-up and
# teardown, module-scoped ones included): three times the slowest port test's
TEST_TIME_LIMIT = 120.0


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread per test process: the suite runs several
    processes at once, and more threads than cores slow every run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _timed_here() -> bool:
    """The timer runs on a process's main thread (xdist runs each worker's
    tests there) where no card is present: a card test, and the kernel
    builds it sets up, run under their caller's own timeout."""
    return threading.current_thread() is threading.main_thread() and not torch.cuda.is_available()


_timed = [""]  # what the running timer times, for its message


def _arm(what: str) -> None:
    _timed[0] = what
    signal.setitimer(signal.ITIMER_REAL, TEST_TIME_LIMIT)


def _expire(signum, frame):
    pytest.fail(f"{_timed[0]} ran past its {TEST_TIME_LIMIT:g}-s limit", pytrace=False)


@pytest.fixture(scope="module", autouse=True)
def module_time_limit(request):
    """Arms the timer before the module's other fixtures (autouse fixtures
    come first in their scope), so that the set-up of its module-scoped
    fixtures is timed too, and stops it after their teardown.  A hang inside
    native code (a compile, a collective) that never returns to Python is
    beyond a Python signal handler."""
    if not _timed_here():
        yield
        return
    previous = signal.signal(signal.SIGALRM, _expire)
    _arm(f"the set-up of {request.node.nodeid}'s module-scoped fixtures")
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)


@pytest.fixture(autouse=True)
def time_limit(request, module_time_limit):
    """Fails the test, by its nodeid, once it has run ``TEST_TIME_LIMIT``
    seconds, so that a hang costs one test and not the whole run.  From its
    teardown the timer runs on over the fixtures torn down and set up before
    the next test (a parametrised module fixture's next instance)."""
    if not _timed_here():
        yield
        return
    _arm(request.node.nodeid)
    yield
    _arm(f"the fixtures torn down or set up after {request.node.nodeid}")


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


def flax_resnet(name: str, dtype=np.float64, num_classes: int | None = None, seed: int = 0):
    """(flax module computing in ``dtype``, numpy variables of ``dtype``):
    the Flax module's ``init``, compiled once a process, perturbed from
    ``seed``."""
    import jax.numpy as jnp

    from image_recognition_adversarial_example_attack_tpu.models import resnet as jax_resnet

    kw = {} if num_classes is None else {"num_classes": num_classes}
    module = getattr(jax_resnet, name)(dtype=getattr(jnp, np.dtype(dtype).name), **kw)
    perturbed = _perturb(flax_init(module), np.random.RandomState(seed))
    return module, _map(lambda a: np.array(a, dtype), perturbed)  # copies: not the cache


_INITS: dict = {}


def flax_init(module, input_size: int = 32) -> dict:
    """``module.init`` (key 0, on float32 zeros of ``input_size``; numpy
    leaves, keys in order), compiled once a process for each module, size
    and x64 mode, whatever dtype the module computes in (the families draw
    their parameters in float32).  A ResNet's, once for every size too: its
    parameters do not depend on the input's size."""
    import jax
    import jax.numpy as jnp

    from image_recognition_adversarial_example_attack_tpu.models import resnet as jax_resnet

    if hasattr(module, "dtype"):
        module = module.clone(dtype=jnp.float32)
    if isinstance(module, jax_resnet.ResNet):
        input_size = 32
    # a parameter drawn at Flax's default dtype is float64 in x64 mode
    key = (repr(module), input_size, jax.dtypes.canonicalize_dtype(np.float64))
    if key not in _INITS:
        x = jnp.zeros((1, input_size, input_size, 3), jnp.float32)
        _INITS[key] = _map(np.asarray, jax.device_get(jax.jit(module.init)(
            jax.random.PRNGKey(0), x)))
    return _INITS[key]


def init_shaped(tree: dict, module, input_size: int = 32) -> dict:
    """``tree`` (the port's seeded init through the converter), once its
    paths and shapes are found equal to those of ``module.init``'s tree:
    the converter gives the Flax tree.  ``jax.eval_shape`` traces the
    ``init`` and compiles nothing."""
    import jax
    import jax.numpy as jnp

    want = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                          jax.ShapeDtypeStruct((1, input_size, input_size, 3), jnp.float32))

    def layout(t):
        leaves = jax.tree_util.tree_flatten_with_path(t)[0]
        return {jax.tree_util.keystr(path): tuple(np.shape(v)) for path, v in leaves}

    assert layout(tree) == layout(want)
    return tree


@pytest.fixture(scope="module", autouse=True)
def jax_zoo_init_once():
    """The JAX zoo's template (``models.zoo._init_variables``: a compiled
    Flax ``init`` on every model load, the weights then read into it) from
    ``flax_init``: the same variables, compiled once a process.  Autouse in
    the modules that import it."""
    from image_recognition_adversarial_example_attack_tpu.models import zoo as jax_zoo

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_zoo, "_init_variables",
                   lambda module, size: _map(np.array, flax_init(module, size)))
        yield


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def port_resnet(name: str, variables, dtype=np.float64, num_classes: int | None = None):
    """The port's model with the Flax variables bridged in (strict load)."""
    kw = {} if num_classes is None else {"num_classes": num_classes}
    model = getattr(port_models, name)(**kw).to(TORCH_DTYPES[dtype])
    model.load_state_dict(from_jax_variables(variables, "resnet"), strict=True)
    model.requires_grad_(False)
    return model.eval()


def _jax_logits_uncast(m, x):
    """The JAX ResNet's ``__call__`` without its final cast to float32."""
    import jax.numpy as jnp

    x = m._run_stages(m.stem(x), len(m.stage_sizes))
    return m.fc(jnp.mean(x, axis=(1, 2)))


def _jax_stage3_uncast(m, x):
    """The JAX ResNet's ``features_stage3`` without its final cast."""
    return m._run_stages(m.stem(x), 3)


def uncast_fns(module, variables, model):
    """{"jax": (logits_fn, features_fn), "port": (...)} that keep the model's
    dtype: both packages cast the logits and the features to float32, so a
    float64 oracle of what comes after the model needs these."""
    from image_recognition_adversarial_example_attack_tpu.core.normalize import (
        normalize_batch as jax_normalize)

    def jax_fn(method):
        def fn(x01):
            x = jax_normalize(x01, IMAGENET_MEAN, IMAGENET_STD)
            return module.apply(variables, x, method=method)
        return fn

    def port_fn(method, perm):
        def fn(x01):
            x = port_normalize(x01, IMAGENET_MEAN, IMAGENET_STD).permute(0, 3, 1, 2)
            out = method(x)
            return out if perm is None else out.permute(*perm)
        return fn

    return {
        "jax": (jax_fn(_jax_logits_uncast), jax_fn(_jax_stage3_uncast)),
        "port": (port_fn(model, None), port_fn(model.features_stage3, (0, 2, 3, 1))),
    }


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
