"""The port's serve CLI (cli/serve.py) against the JAX package's on the CPU.

- The service function, JAX's ``_make_service_fn`` against the port's on the
  same images and resnet_tiny weights carried across
  (``convert.from_jax_variables``): plain, ``--defend``, ``--detector
  feature`` and ``--detector squeezing``, with and without
  ``--transfer_uint8``; probabilities and scores within ``TOL`` in float32,
  the defended top-1 equal where its margin exceeds ``TOL``; in float64
  with both packages' float32 casts lifted (``uncast_fns``), where the
  quantizer's rounding decides the defended top-1 and the squeezing score,
  probabilities within 1e-12 and the defended top-1 equal.
- ``_chunk_responses``: equal dicts for the same outputs.
- ``main(argv)`` in process on one msgpack file of resnet_tiny weights and
  the same PNGs: the file mode's JSON lines equal JAX's (keys; top-1, top-k,
  defended top-1 and flag where the margins allow; one error line for the
  missing file; ``latency_ms > 0``); ``--overlap`` and a stdin stream equal
  to the sequential run; a producer error reaching the consumer.
- ``_LineStream`` sees a buffered burst; SIGTERM in a subprocess drains.
- ``--sharded``: the service over a mesh of two CPU devices equals the
  unsharded one; with one device the ready line says ``"sharded": false``.
- The parser is JAX's but for ``--device``; the default device raises
  without CUDA.
"""

import argparse
import io
import json
import os
import signal
import subprocess
import sys
import threading
import time
import warnings
from contextlib import redirect_stdout
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from PIL import Image

from _torch_port_helpers import jax_zoo_init_once, module_time_limit, one_thread, time_limit  # noqa: F401 (autouse)
from _torch_port_helpers import flax_resnet, port_resnet, uncast_fns
from image_recognition_adversarial_example_attack_tpu.attacks import api as jax_api
from image_recognition_adversarial_example_attack_tpu.cli import serve as jax_serve
from image_recognition_adversarial_example_attack_tpu.core.constants import (
    IMAGENET_MEAN, IMAGENET_STD)
from image_recognition_adversarial_example_attack_tpu.defenses import detector as jax_det
from image_recognition_adversarial_example_attack_tpu.defenses.preprocess import (
    defend_input as jax_defend_input)
from image_recognition_adversarial_example_attack_tpu_torch.attacks import make_logits_fn
from image_recognition_adversarial_example_attack_tpu_torch.cli import serve
from image_recognition_adversarial_example_attack_tpu_torch.defenses import make_features_fn
from image_recognition_adversarial_example_attack_tpu_torch.models import zoo
from image_recognition_adversarial_example_attack_tpu_torch.parallel import make_mesh

REPO = Path(__file__).resolve().parent.parent
TOL = 1e-5  # float32 probabilities and scores, relative to max(1, |value|)
MODES = {"plain": (False, "none"), "defend": (True, "none"),
         "feature": (False, "feature"), "squeezing": (False, "squeezing")}


def _args(mode: str, transfer_uint8: bool = False) -> argparse.Namespace:
    defend, detector = MODES[mode]
    return argparse.Namespace(defend=defend, detector=detector, transfer_uint8=transfer_uint8)


def _images(n: int = 6, size: int = 32, seed: int = 0) -> np.ndarray:
    """Decoded-looking pixels (on the 1/255 grid), as the service sees them."""
    rs = np.random.RandomState(seed)
    return (rs.randint(0, 256, (n, size, size, 3)) / 255.0).astype(np.float32)


def _close(a, b, tol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    np.testing.assert_array_less(np.abs(a - b), tol * np.maximum(1.0, np.abs(b)) + 1e-300)


@pytest.fixture(scope="module")
def nets32():
    module, variables = flax_resnet("resnet_tiny", np.float32, num_classes=10, seed=3)
    model = port_resnet("resnet_tiny", variables, np.float32, num_classes=10)
    return {
        "jax": (jax_api.make_logits_fn(module, variables, IMAGENET_MEAN, IMAGENET_STD),
                jax_det.make_features_fn(module, variables, IMAGENET_MEAN, IMAGENET_STD)),
        "port": (make_logits_fn(model, IMAGENET_MEAN, IMAGENET_STD),
                 make_features_fn(model, IMAGENET_MEAN, IMAGENET_STD)),
    }


@pytest.mark.parametrize("transfer_uint8", [False, True], ids=["float32", "uint8"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_service_fn_matches_jaxs_in_float32(nets32, mode, transfer_uint8):
    x = _images()
    if transfer_uint8:
        x = np.clip(np.round(x * 255.0), 0, 255).astype(np.uint8)
    args = _args(mode, transfer_uint8)
    theirs = jax.device_get(jax_serve._make_service_fn(*nets32["jax"], args)(jnp.asarray(x)))
    ours = serve._device_get(serve._make_service_fn(*nets32["port"], args)(torch.from_numpy(x)))
    assert set(ours) == set(theirs)
    _close(ours["probs"], theirs["probs"], TOL)
    if "score" in ours:
        _close(ours["score"], theirs["score"], TOL)
    if "defended_pred" in ours:
        x01 = jnp.asarray(x, jnp.float32) / (255.0 if transfer_uint8 else 1.0)
        logits = np.sort(np.asarray(nets32["jax"][0](jax_defend_input(x01))), axis=-1)
        clear = logits[:, -1] - logits[:, -2] > TOL * np.maximum(1.0, np.abs(logits[:, -1]))
        assert clear.any()
        np.testing.assert_array_equal(ours["defended_pred"][clear],
                                      theirs["defended_pred"][clear])


@pytest.fixture(scope="module")
def fns64():
    with jax.enable_x64():
        module, variables = flax_resnet("resnet_tiny", np.float64, num_classes=10, seed=5)
    model = port_resnet("resnet_tiny", variables, np.float64, num_classes=10)
    return uncast_fns(module, variables, model)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_service_fn_matches_jaxs_in_float64(fns64, mode):
    """The casts lifted: the quantizer's rounding, which decides the
    defended top-1 and the squeezing score, is the same in both packages."""
    fns = fns64
    x = _images(seed=1).astype(np.float64)
    with jax.enable_x64():
        args = _args(mode)
        theirs = jax.device_get(jax_serve._make_service_fn(*fns["jax"], args)(jnp.asarray(x)))
    ours = serve._device_get(serve._make_service_fn(*fns["port"], args)(torch.from_numpy(x)))
    assert set(ours) == set(theirs) and ours["probs"].dtype == np.float64
    _close(ours["probs"], theirs["probs"], 1e-12)
    if "score" in ours:
        _close(ours["score"], theirs["score"], 1e-12)
    if "defended_pred" in ours:
        np.testing.assert_array_equal(ours["defended_pred"], theirs["defended_pred"])


@pytest.mark.parametrize("threshold", [None, 0.3])
def test_chunk_responses_equal_jaxs(threshold):
    rs = np.random.RandomState(2)
    probs = rs.dirichlet(np.ones(10), size=4).astype(np.float32)
    out = {"probs": probs, "defended_pred": rs.randint(0, 10, 4),
           "score": rs.rand(4).astype(np.float32)}
    names = ["a.png", "b.png", "c.png"]  # the fourth row is padding
    for labels in (None, [f"name_{i}" for i in range(10)], ["only", "three", "labels"]):
        assert (serve._chunk_responses(out, names, 3, labels, threshold)
                == jax_serve._chunk_responses(out, names, 3, labels, threshold))
    plain = {"probs": probs}
    assert (serve._chunk_responses(plain, names, 5, None, threshold)
            == jax_serve._chunk_responses(plain, names, 5, None, threshold))


def test_parser_keeps_the_jax_flags():
    ours = {a.dest: (a.default, a.choices) for a in serve.build_parser()._actions}
    theirs = {a.dest: (a.default, a.choices) for a in jax_serve.build_parser()._actions}
    assert set(ours) - set(theirs) == {"device"} and set(theirs) - set(ours) == set()
    assert {k for k in theirs if ours[k] != theirs[k]} == set()


def test_the_default_device_raises_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--model", "resnet_tiny", "--input", str(tmp_path / "none.txt")])


# ---------------------------------------------------------------------------
# main(argv) in process

@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Seven PNGs of several sizes, a request file with a missing path in the
    middle, and one msgpack file of perturbed resnet_tiny weights."""
    root = tmp_path_factory.mktemp("serve")
    rs = np.random.RandomState(7)
    paths = []
    for i, (h, w) in enumerate([(40, 50), (64, 48), (30, 30), (80, 60), (50, 50), (45, 70),
                                (33, 41)]):
        p = root / f"img_{i}.png"
        Image.fromarray((rs.rand(h, w, 3) * 255).astype(np.uint8)).save(p)
        paths.append(str(p))
    lines = paths[:3] + [str(root / "missing.png")] + paths[3:]
    req = root / "requests.txt"
    req.write_text("".join(f"{ln}\n" for ln in lines))
    _, variables = flax_resnet("resnet_tiny", np.float32, num_classes=10, seed=9)
    weights = root / "resnet_tiny.msgpack"
    weights.write_bytes(serialization.to_bytes(variables))
    return {"root": root, "req": req, "lines": lines, "weights": str(weights)}


@pytest.fixture()
def keep_signal_handlers():
    """main() installs SIGTERM/SIGINT handlers; put the test process's back."""
    saved = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    yield
    for s, h in saved.items():
        signal.signal(s, h)


def _run(main, argv) -> list[dict]:
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert main(argv) == 0
    return [json.loads(ln) for ln in buf.getvalue().splitlines()]


SERVE_FLAGS = ["--model", "resnet_tiny", "--batch", "3", "--defend", "--detector", "squeezing",
               "--detector_threshold", "0.02", "--topk", "4"]


def _same_response(a: dict, b: dict, tol: float = TOL) -> None:
    """Equal keys; probabilities and scores within ``tol``; the ranking, the
    defended top-1 and the flag equal wherever no near-tie could swap them."""
    assert set(a) == set(b) and a["path"] == b["path"]
    if "error" in b:
        return
    assert abs(a["prob"] - b["prob"]) <= tol
    pa = [p for _, p in a["topk"]]
    pb = [p for _, p in b["topk"]]
    np.testing.assert_allclose(pa, pb, rtol=0, atol=tol)
    for i, (ca, cb) in enumerate(zip(a["topk"], b["topk"])):
        near = [j for j in (i - 1, i + 1) if 0 <= j < len(pb) and abs(pb[j] - pb[i]) <= 2 * tol]
        if not near:
            assert ca[0] == cb[0], (i, a["topk"], b["topk"])
    if pb[0] - pb[1] > 2 * tol:
        assert a["top1"] == b["top1"] and a["label"] == b["label"]
    assert abs(a["detector_score"] - b["detector_score"]) <= tol
    if abs(b["detector_score"] - 0.02) > tol:
        assert a["detector_flag"] == b["detector_flag"]
    # the defended top-1's margin is not in the response: held by the
    # service tests above; here it must name a class
    assert 0 <= a["defended_top1"] < 10


def test_file_mode_lines_equal_jaxs(served, keep_signal_handlers):
    flags = [*SERVE_FLAGS, "--weights", served["weights"], "--input", str(served["req"])]
    ours = _run(serve.main, [*flags, "--device", "cpu"])
    theirs = _run(jax_serve.main, flags)
    assert ours[0] == {"ready": True, "batch": 3, "devices": 1, "sharded": False,
                       "device": "cpu"}
    assert set(theirs[0]) == set(ours[0])
    ours, theirs = ours[1:], theirs[1:]
    assert [r["path"] for r in ours] == served["lines"]
    assert len(ours) == len(theirs) == len(served["lines"])
    errors = [r for r in ours if "error" in r]
    assert len(errors) == 1 and errors[0]["path"].endswith("missing.png")
    assert "latency_ms" not in errors[0]
    for a, b in zip(ours, theirs):
        _same_response(a, b)
        assert a["batch_size"] == 3 and a["request_count"] == len(served["lines"])
        assert a["decode_ms"] > 0
        if "error" not in a:
            assert a["latency_ms"] > 0
    # 7 readable images in chunks of 3: three device calls
    assert len({r["latency_ms"] for r in ours if "error" not in r}) <= 3


def _strip_timing(rows):
    return [{k: v for k, v in r.items() if k not in ("latency_ms", "decode_ms",
                                                      "request_count")} for r in rows]


def test_overlap_equals_the_sequential_run(served, keep_signal_handlers):
    flags = [*SERVE_FLAGS, "--weights", served["weights"], "--input", str(served["req"]),
             "--device", "cpu"]
    seq = _run(serve.main, flags)
    ovl = _run(serve.main, [*flags, "--overlap"])
    assert seq[0] == ovl[0]
    assert _strip_timing(seq[1:]) == _strip_timing(ovl[1:])
    assert all(r["latency_ms"] > 0 for r in ovl[1:] if "error" not in r)


@pytest.mark.parametrize("overlap", [False, True], ids=["sequential", "overlap"])
def test_a_stdin_stream_equals_the_file_mode(served, overlap, monkeypatch, keep_signal_handlers):
    """The line protocol on a pipe: every line answered in order, the
    responses those of the file mode; micro-batches of at most ``--batch``."""
    flags = [*SERVE_FLAGS, "--weights", served["weights"], "--device", "cpu",
             "--max_wait_ms", "50"]
    want = _run(serve.main, [*flags, "--input", str(served["req"])])
    r, w = os.pipe()
    os.write(w, served["req"].read_bytes())
    os.close(w)
    with os.fdopen(r) as stdin:
        monkeypatch.setattr(sys, "stdin", stdin)
        got = _run(serve.main, [*flags, *(["--overlap"] if overlap else [])])
    assert got[0] == want[0]
    assert _strip_timing(got[1:]) == _strip_timing(want[1:])
    assert all(1 <= row["request_count"] <= 3 for row in got[1:])


def test_overlap_producer_error_reaches_the_consumer(served, monkeypatch):
    """A producer-thread exception must end the service, not hang it."""
    def boom(paths, size):
        raise RuntimeError("decode thread died")

    monkeypatch.setattr(serve, "_decode_drain", boom)
    holder: dict = {}

    def run():
        try:
            serve.main(["--model", "resnet_tiny", "--batch", "2", "--overlap", "--device",
                        "cpu", "--input", str(served["req"])])
        except BaseException as e:  # noqa: BLE001 — recorded for the assert
            holder["exc"] = e

    t = threading.Thread(target=run, daemon=True)
    with redirect_stdout(io.StringIO()):
        t.start()
        t.join(timeout=120.0)
    assert not t.is_alive(), "--overlap hung after the producer died"
    assert isinstance(holder.get("exc"), RuntimeError)
    assert "decode thread died" in str(holder["exc"])


def test_linestream_sees_a_buffered_burst():
    r, w = os.pipe()
    try:
        os.write(w, b"a.jpg\nb.jpg\nc.jpg\nd.jpg\n")
        reader = serve._LineStream(r)
        t0 = time.monotonic()
        got = serve._drain_requests(reader, batch=8, max_wait_s=0.05)
        assert got == ["a.jpg", "b.jpg", "c.jpg", "d.jpg"]
        assert time.monotonic() - t0 < 1.0
        # a partial line stays buffered until its newline (or EOF) arrives
        os.write(w, b"e.jp")
        assert reader.readline(0.05) is None and not reader.eof
        os.write(w, b"g\n")
        os.close(w)
        w = None
        assert reader.readline(1.0) == "e.jpg"
        assert reader.readline(1.0) is None and reader.eof
    finally:
        os.close(r)
        if w is not None:
            os.close(w)


def test_sigterm_drains_in_a_subprocess(served):
    """SIGTERM while streaming: the request in flight is answered, then the
    shutdown line, exit 0."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "image_recognition_adversarial_example_attack_tpu_torch.cli.serve",
         "--model", "resnet_tiny", "--batch", "2", "--device", "cpu"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=str(REPO), env={**os.environ, "OMP_NUM_THREADS": "1"})
    try:
        ready = json.loads(proc.stdout.readline())
        assert ready["ready"] is True and ready["sharded"] is False
        proc.stdin.write(f"{served['lines'][0]}\n")
        proc.stdin.flush()
        resp = json.loads(proc.stdout.readline())
        assert resp["top1"] >= 0 and resp["latency_ms"] > 0
        assert resp["batch_size"] == 2 and resp["request_count"] == 1
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
        assert proc.returncode == 0, err[-2000:]
        assert json.loads(out.splitlines()[-1]) == {"shutdown": True,
                                                     "signal": int(signal.SIGTERM)}
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


# ---------------------------------------------------------------------------
# --sharded

def test_sharded_service_equals_the_unsharded_one():
    """The batch split over a mesh of two CPU devices, one replica each, then
    gathered: the outputs of the whole batch in one call."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # random init: no weights file
        bundle = zoo.load_model("resnet_tiny", device="cpu")
    from image_recognition_adversarial_example_attack_tpu_torch.cli.common import make_fns
    from image_recognition_adversarial_example_attack_tpu_torch.parallel import data_sharding

    args = _args("squeezing")
    args.defend = True
    mesh = make_mesh(devices=[torch.device("cpu")] * 2)
    sharded = serve._sharded_service(bundle, args, mesh)
    x = _images(n=4, seed=4)
    want = serve._device_get(serve._make_service_fn(*make_fns(bundle), args)(torch.from_numpy(x)))
    got = serve._device_get(sharded(data_sharding(mesh).place(x)))
    assert set(got) == set(want) == {"probs", "defended_pred", "score"}
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
