"""The port's weight import (cli/import_weights.py) and the zoo's msgpack
cache write after a ``.pth`` load (models/zoo.py) against the JAX
package's on the CPU.

- A ``.pth`` saved from the port's own random resnet_tiny (torchvision
  names, BatchNorm statistics drawn from a seed) goes through both
  packages' ``import_weights``: the two ``.msgpack`` files restore to
  equal trees, bit for bit, and are the same bytes; JAX's ``load_model``
  of the port's file gives the port's logits within ``LOGIT_TOL``;
  ``--verify`` prints JAX's line.
- ``load_model`` of a ``.pth`` writes ``<weights dir>/<name>.msgpack`` (the
  same bytes as the import) and the second load says ``source="cache"``,
  in both packages, each reading the other's cache; ``cache_converted=False``
  writes nothing.
- A name without a converter in the JAX package raises its ValueError in
  both.
- The parser is JAX's but for ``--device``; the default device raises
  without CUDA; a missing checkpoint exits.
"""

import io
import re
import warnings
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from _torch_port_helpers import jax_zoo_init_once, module_time_limit, one_thread, time_limit  # noqa: F401 (autouse)
from image_recognition_adversarial_example_attack_tpu.attacks import api as jax_api
from image_recognition_adversarial_example_attack_tpu.cli import import_weights as jax_cli
from image_recognition_adversarial_example_attack_tpu.models import zoo as jax_zoo
from image_recognition_adversarial_example_attack_tpu_torch.attacks import make_logits_fn
from image_recognition_adversarial_example_attack_tpu_torch.cli import import_weights as cli
from image_recognition_adversarial_example_attack_tpu_torch.models import zoo

LOGIT_TOL = 1e-5  # float32 logits, relative to the largest


def _port_pth(name: str, path, seed: int = 0):
    """The port's random ``name`` with BatchNorm statistics drawn from
    ``seed``, saved under torchvision's names; returns its state dict."""
    model = zoo.random_init_(zoo.build_model(name))
    g = torch.Generator().manual_seed(seed)
    for key, t in model.state_dict().items():
        if key.endswith("running_mean"):
            t.copy_(torch.randn(t.shape, generator=g) * 0.1)
        elif key.endswith("running_var"):
            t.copy_(torch.rand(t.shape, generator=g) + 0.5)
    sd = model.state_dict()
    torch.save(sd, path)
    return sd


def _run(main, argv) -> str:
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


def _trees_equal(a, b) -> bool:
    if isinstance(a, dict):
        return isinstance(b, dict) and set(a) == set(b) and all(_trees_equal(a[k], b[k])
                                                                  for k in a)
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.fixture()
def wdir(tmp_path, monkeypatch):
    d = tmp_path / "weights"
    d.mkdir()
    monkeypatch.setenv("ADV_TPU_WEIGHTS_DIR", str(d))
    return d


@pytest.fixture(scope="module")
def imported(tmp_path_factory):
    """Both imports of one .pth, with ``--verify``, run once."""
    tmp = tmp_path_factory.mktemp("import")
    pth = tmp / "resnet_tiny.pth"
    sd = _port_pth("resnet_tiny", pth, seed=1)
    ours, theirs = tmp / "ours.msgpack", tmp / "theirs.msgpack"
    empty = tmp / "weights"
    empty.mkdir()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ADV_TPU_WEIGHTS_DIR", str(empty))
        out_o = _run(cli.main, ["resnet_tiny", str(pth), "--out", str(ours), "--verify",
                                "--device", "cpu"])
        out_t = _run(jax_cli.main, ["resnet_tiny", str(pth), "--out", str(theirs), "--verify"])
    return {"pth": pth, "sd": sd, "ours": ours, "theirs": theirs, "out": (out_o, out_t),
            "cached": list(empty.iterdir())}


def test_both_imports_write_the_same_tree_and_bytes(imported):
    ours = serialization.msgpack_restore(imported["ours"].read_bytes())
    theirs = serialization.msgpack_restore(imported["theirs"].read_bytes())
    assert _trees_equal(ours, theirs)
    assert imported["ours"].read_bytes() == imported["theirs"].read_bytes()
    assert imported["cached"] == []  # the import writes no cache of its own
    out_o, out_t = imported["out"]
    assert out_o.splitlines()[0] == f"converted {imported['pth']} -> {imported['ours']}"


def test_verify_prints_jaxs_line(imported):
    lines = [ln for out in imported["out"] for ln in out.splitlines() if ln.startswith("verify")]
    assert len(lines) == 2
    pattern = re.compile(r"^verify: top-5 on a white image: \[(\(\d+, [0-9.e-]+\)(, )?){5}\]$")
    got = []
    for line in lines:
        assert pattern.match(line), line
        got.append([(int(i), float(p)) for i, p in re.findall(r"\((\d+), ([0-9.e-]+)\)", line)])
    (ids_o, p_o), (ids_t, p_t) = (zip(*g) for g in got)
    np.testing.assert_allclose(p_o, p_t, rtol=0, atol=1e-4 + 1e-12)  # printed to 4 places
    for i in range(5):
        near = [j for j in (i - 1, i + 1) if 0 <= j < 5 and abs(p_t[j] - p_t[i]) <= 2e-4]
        if not near:
            assert ids_o[i] == ids_t[i]


def test_jax_loads_the_ports_file_to_the_ports_logits(imported):
    x = np.random.RandomState(0).rand(3, 64, 64, 3).astype(np.float32)
    theirs = jax_zoo.load_model("resnet_tiny", weights=imported["ours"])
    assert theirs.source == "cache"
    lf_t = jax_api.make_logits_fn(theirs.module, theirs.variables, theirs.mean, theirs.std)
    ours = zoo.load_model("resnet_tiny", weights=imported["ours"], device="cpu")
    assert ours.source == "cache"
    with torch.no_grad():
        lo = make_logits_fn(ours.model, ours.mean, ours.std)(torch.from_numpy(x)).numpy()
    lt = np.asarray(jax.jit(lf_t)(jnp.asarray(x)))
    np.testing.assert_array_less(np.abs(lo - lt), LOGIT_TOL * np.abs(lt).max())
    # the port's model holds the .pth's values
    for k, v in ours.model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, imported["sd"][k]), k


@pytest.mark.parametrize("first", ["port", "jax"])
def test_a_pth_load_writes_the_cache_and_the_second_load_reads_it(first, tmp_path, wdir,
                                                                  imported):
    """Either package converts the .pth and writes the cache; the next load
    in both packages reads it (``source="cache"``)."""
    (wdir / "resnet_tiny.pth").write_bytes(imported["pth"].read_bytes())
    cache = wdir / "resnet_tiny.msgpack"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if first == "port":
            b = zoo.load_model("resnet_tiny", device="cpu", cache_converted=False)
            assert b.source == "converted" and not cache.exists()
            b = zoo.load_model("resnet_tiny", device="cpu")
        else:
            b = jax_zoo.load_model("resnet_tiny")
        assert b.source == "converted" and cache.is_file()
        assert cache.read_bytes() == imported["ours"].read_bytes()
        assert zoo.load_model("resnet_tiny", device="cpu").source == "cache"
        assert jax_zoo.load_model("resnet_tiny").source == "cache"


@pytest.mark.parametrize("name", ["tiny", "wrn_tiny", "ibp_tiny"])
def test_a_name_without_a_converter_raises_in_both(name, tmp_path, wdir):
    pth = tmp_path / f"{name}.pth"
    _port_pth(name, pth)
    want = f"no torch->flax converter registered for '{name}'"
    with pytest.raises(ValueError, match=re.escape(want)):
        zoo.load_model(name, weights=pth, device="cpu")
    with pytest.raises(ValueError, match=re.escape(want)):
        jax_zoo.load_model(name, weights=pth)
    with pytest.raises(ValueError, match=re.escape(want)):
        cli.main([name, str(pth), "--device", "cpu"])
    assert list(wdir.iterdir()) == []
    assert name not in zoo.CONVERTIBLE


def test_convertible_names_are_jaxs():
    from image_recognition_adversarial_example_attack_tpu.models import convert as jax_convert

    assert zoo.CONVERTIBLE == set(jax_convert.RENAMES)


def test_parser_keeps_the_jax_flags():
    ours = {a.dest: (a.default, a.choices) for a in cli.build_parser()._actions}
    theirs = {a.dest: (a.default, a.choices) for a in jax_cli.build_parser()._actions}
    assert set(ours) - set(theirs) == {"device"} and set(theirs) - set(ours) == set()
    assert {k for k in theirs if ours[k] != theirs[k]} == set()


def test_refusals(tmp_path, monkeypatch):
    with pytest.raises(SystemExit, match="checkpoint not found"):
        cli.main(["resnet_tiny", str(tmp_path / "none.pth"), "--device", "cpu"])
    with pytest.raises(SystemExit, match="checkpoint not found"):
        jax_cli.main(["resnet_tiny", str(tmp_path / "none.pth")])
    pth = tmp_path / "r.pth"
    _port_pth("resnet_tiny", pth)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["resnet_tiny", str(pth)])
