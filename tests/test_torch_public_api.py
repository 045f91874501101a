"""The port's console scripts and its small public API against the JAX
package's: the eight ``advtpu-torch-*`` scripts of pyproject.toml (each
target imports and ``main(["--help"])`` exits 0, in process), and
``models.zoo.register`` / ``register_lazy``, ``core.labels.label_name``,
``models.tiny.make_tiny``, ``utils.profiling.device_timer`` and
``core.normalize.normalizer`` held to the JAX functions' behaviour.
"""

import importlib
import time
import tomllib
from contextlib import redirect_stdout
from io import StringIO
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_recognition_adversarial_example_attack_tpu.core import labels as jax_labels
from image_recognition_adversarial_example_attack_tpu.core import normalize as jax_normalize
from image_recognition_adversarial_example_attack_tpu.models import tiny as jax_tiny
from image_recognition_adversarial_example_attack_tpu.models import zoo as jax_zoo
from image_recognition_adversarial_example_attack_tpu.utils import profiling as jax_profiling
from image_recognition_adversarial_example_attack_tpu_torch.core import labels, normalize
from image_recognition_adversarial_example_attack_tpu_torch.models import convert, tiny, zoo
from image_recognition_adversarial_example_attack_tpu_torch.utils import profiling

PORT = "image_recognition_adversarial_example_attack_tpu_torch"
JAX = "image_recognition_adversarial_example_attack_tpu"
SCRIPTS = tomllib.loads((Path(__file__).resolve().parent.parent / "pyproject.toml")
                        .read_text())["project"]["scripts"]
PORT_SCRIPTS = {k: v for k, v in SCRIPTS.items() if k.startswith("advtpu-torch-")}


def test_the_port_has_one_script_for_each_jax_script():
    jax_scripts = {k: v for k, v in SCRIPTS.items() if not k.startswith("advtpu-torch-")}
    assert len(jax_scripts) == len(PORT_SCRIPTS) == 8
    assert all(t.startswith(f"{JAX}.cli.") for t in jax_scripts.values())
    for name, target in jax_scripts.items():
        port = PORT_SCRIPTS[name.replace("advtpu-", "advtpu-torch-", 1)]
        assert port == target.replace(f"{JAX}.", f"{PORT}.", 1)


@pytest.mark.parametrize("script", sorted(PORT_SCRIPTS))
def test_each_port_script_target_imports_and_prints_its_help(script):
    module_name, func = PORT_SCRIPTS[script].split(":")
    main = getattr(importlib.import_module(module_name), func)
    out = StringIO()
    with redirect_stdout(out), pytest.raises(SystemExit) as exit_info:
        main(["--help"])
    assert exit_info.value.code == 0
    assert out.getvalue().startswith("usage:")


@pytest.fixture
def registered():
    """Names added to both registries, removed again afterwards."""
    names = []
    yield names
    for n in names:
        zoo._REGISTRY.pop(n, None)
        jax_zoo._REGISTRY.pop(n, None)


def test_register_reaches_list_models_model_meta_and_load_model(registered):
    registered.append("my_tiny")
    zoo.register("my_tiny", "tiny")(lambda int8=False: tiny.TinyCNN(num_classes=5, int8=int8))
    jax_zoo.register("my_tiny")(lambda dtype, **kw: jax_tiny.TinyCNN(num_classes=5, dtype=dtype,
                                                                      **kw))
    assert "my_tiny" in zoo.list_models() and "my_tiny" in jax_zoo.list_models()
    assert sorted(set(zoo.list_models()) ^ set(jax_zoo.list_models())) == ["swin_l"]
    _same_meta("my_tiny")
    with pytest.warns(UserWarning, match="random init"):
        bundle = zoo.load_model("my_tiny", device="cpu")
    assert bundle.source == "random" and zoo.model_family("my_tiny") == "tiny"
    assert bundle.model.Dense_0.out_features == 5
    assert zoo.build_model("my_tiny", int8=True).Conv_0.__class__.__name__ != "Conv2d"


def test_register_lazy_imports_on_first_use(registered):
    registered.append("lazy_tiny")
    zoo.register_lazy("lazy_tiny", ".tiny", "TinyCNN", "tiny")
    jax_zoo.register_lazy("lazy_tiny", ".tiny", "TinyCNN")
    assert "lazy_tiny" in zoo.list_models() and "lazy_tiny" in jax_zoo.list_models()
    _same_meta("lazy_tiny")
    with pytest.warns(UserWarning, match="random init"):
        bundle = zoo.load_model("lazy_tiny", device="cpu")
    assert isinstance(bundle.model, tiny.TinyCNN)
    # an absolute module path, and the int8 switch of the imported constructor
    registered.append("lazy_resnet_tiny")
    zoo.register_lazy("lazy_resnet_tiny", f"{PORT}.models.resnet", "resnet_tiny", "resnet")
    assert zoo.build_model("lazy_resnet_tiny", int8=True).fc.__class__.__name__ == "QuantLinear"
    registered.append("lazy_missing")
    zoo.register_lazy("lazy_missing", ".no_such_module", "f", "tiny")
    with pytest.raises(ModuleNotFoundError):
        zoo.build_model("lazy_missing")


def _same_meta(name: str) -> None:
    want, got = jax_zoo.model_meta(name), zoo.model_meta(name)
    assert got["input_size"] == want["input_size"]
    np.testing.assert_array_equal(got["mean"], want["mean"])
    np.testing.assert_array_equal(got["std"], want["std"])


@pytest.mark.parametrize("given", [None, ["cat", "dog", "eel"]], ids=["imagenet", "custom"])
def test_label_name_equals_jaxs(given, monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)  # no imagenet_classes.txt of the working directory
    monkeypatch.delenv("IMAGENET_CLASSES", raising=False)
    labels.load_imagenet_labels.cache_clear()
    jax_labels.load_imagenet_labels.cache_clear()
    try:
        for idx in (-1, 0, 2, 3, 999, 1000, 5000):
            assert labels.label_name(idx, given) == jax_labels.label_name(idx, given)
    finally:
        labels.load_imagenet_labels.cache_clear()
        jax_labels.load_imagenet_labels.cache_clear()


def test_make_tiny_loads_jaxs_variables_and_matches_its_layout():
    x = np.random.RandomState(0).rand(4, 16, 16, 3).astype(np.float32)
    jmodel, jvars = jax_tiny.make_tiny(seed=1, image_size=16, num_classes=8)
    model, variables = tiny.make_tiny(seed=1, image_size=16, num_classes=8)
    # the port's tree has JAX's layout: every path, shape and dtype
    want = jax.tree_util.tree_leaves_with_path(jvars)
    got = jax.tree_util.tree_leaves_with_path(variables)
    assert [(p, np.shape(a)) for p, a in want] == [(p, np.shape(a)) for p, a in got]
    # JAX's variables in the port's module give JAX's logits
    model.load_state_dict(convert.from_jax_variables(jax.tree_util.tree_map(np.asarray, jvars),
                                                     "tiny"), strict=True)
    with torch.no_grad():
        logits = model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(logits, np.asarray(jmodel.apply(jvars, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)
    # the port's own init is a function of the seed, and LeCun-normal like Flax's
    _, again = tiny.make_tiny(seed=1)
    _, other = tiny.make_tiny(seed=2)
    k1 = variables["params"]["Conv_1"]["kernel"]
    assert np.array_equal(k1, again["params"]["Conv_1"]["kernel"])
    assert not np.array_equal(k1, other["params"]["Conv_1"]["kernel"])
    assert abs(float(np.std(k1)) - (1 / 72) ** 0.5) < 0.03
    assert not any(p.requires_grad for p in model.parameters()) and not model.training


def test_device_timer_has_jaxs_contract():
    for timer in (profiling.device_timer, jax_profiling.device_timer):
        with timer() as t:
            time.sleep(0.02)
            inside = t()
        after = t()
        assert 0.02 <= inside <= after


@pytest.mark.parametrize("stats", ["imagenet", "identity"])
def test_normalizer_equals_jaxs(stats):
    x = np.random.RandomState(1).rand(2, 5, 5, 3).astype(np.float32)
    kw = {} if stats == "imagenet" else {"mean": np.zeros(3), "std": np.ones(3)}
    got = normalize.normalizer(**kw)(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_normalize.normalizer(**kw)(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    if stats == "identity":
        np.testing.assert_array_equal(got, x)
