"""The port's HTTP front end (cli/serve.py: ``_BatchWorker``,
``make_http_server``, ``--http``) on the CPU: every case of
tests/test_serve_http.py against the port's worker and server, over the JAX
package's ``tiny`` CNN (conftest's ``tiny_model``) carried into the port's
``TinyCNN`` (``convert.from_jax_variables``), plus the responses' parity
with the JAX service on the same images (probabilities within ``TOL``).
"""

import argparse
import base64
import json
import os
import signal
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from _torch_port_helpers import module_time_limit, one_thread, time_limit  # noqa: F401 (autouse)
from image_recognition_adversarial_example_attack_tpu.core.constants import (
    IMAGENET_MEAN, IMAGENET_STD)
from image_recognition_adversarial_example_attack_tpu.core.images import (
    load_image as jax_load_image)
from image_recognition_adversarial_example_attack_tpu_torch.attacks import make_logits_fn
from image_recognition_adversarial_example_attack_tpu_torch.cli import serve
from image_recognition_adversarial_example_attack_tpu_torch.eval.streaming import make_placer
from image_recognition_adversarial_example_attack_tpu_torch.models.convert import (
    from_jax_variables)
from image_recognition_adversarial_example_attack_tpu_torch.models.tiny import TinyCNN

REPO = Path(__file__).resolve().parent.parent
TOL = 1e-5  # float32 probabilities


@pytest.fixture(scope="module")
def http_server(tiny_model):
    """The port's worker and server over the carried-over tiny CNN (port 0 =
    ephemeral)."""
    _, variables = tiny_model
    model = TinyCNN(num_classes=8)
    model.load_state_dict(from_jax_variables(jax.tree_util.tree_map(np.array, variables), "tiny"),
                          strict=True)
    model.requires_grad_(False).eval()
    args = argparse.Namespace(defend=False, detector="none", transfer_uint8=False)
    service = serve._make_service_fn(make_logits_fn(model, IMAGENET_MEAN, IMAGENET_STD),
                                     None, args)
    worker = serve._BatchWorker(service, make_placer("cpu"), batch=4, topk=3, labels=None,
                                detector_threshold=None, max_wait_s=0.2)
    server = serve.make_http_server("127.0.0.1", 0, worker, {"ready": True, "batch": 4},
                                    size=16)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    t.join(timeout=10)
    worker.shutdown()
    assert not t.is_alive() and not worker._thread.is_alive()


def _post(url, payload: dict) -> dict:
    req = urllib.request.Request(
        url + "/classify", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _img_file(tmp_path: Path, name: str, seed: int) -> Path:
    rng = np.random.RandomState(seed)
    p = tmp_path / name
    Image.fromarray((rng.rand(24, 24, 3) * 255).astype(np.uint8)).save(p)
    return p


def test_healthz(http_server):
    with urllib.request.urlopen(http_server + "/healthz", timeout=30) as r:
        data = json.loads(r.read())
    assert data["ready"] is True and data["batch"] == 4


def test_unknown_route_404(http_server):
    for get in (True, False):
        with pytest.raises(urllib.error.HTTPError) as e:
            if get:
                urllib.request.urlopen(http_server + "/nope", timeout=30)
            else:
                urllib.request.urlopen(urllib.request.Request(
                    http_server + "/nope", data=b"{}", method="POST"), timeout=30)
        assert e.value.code == 404


def test_classify_path_matches_the_jax_service(http_server, tmp_path, tiny_logits_fn):
    p = _img_file(tmp_path, "a.png", 0)
    (resp,) = _post(http_server, {"path": str(p)})["results"]
    assert resp["path"] == str(p)
    assert 0.0 <= resp["prob"] <= 1.0 and len(resp["topk"]) == 3
    assert resp["latency_ms"] > 0 and resp["batch_size"] == 4
    assert "decode_ms" in resp
    probs = np.asarray(jax.nn.softmax(tiny_logits_fn(jnp.asarray(jax_load_image(p, 16))), -1))[0]
    order = np.argsort(-probs)[:3]
    np.testing.assert_allclose([q for _, q in resp["topk"]], probs[order], rtol=0, atol=TOL)
    if probs[order[0]] - probs[order[1]] > 2 * TOL:
        assert resp["top1"] == int(order[0])


def test_classify_b64_equals_the_path_route(http_server, tmp_path):
    p = _img_file(tmp_path, "b.png", 1)
    b64 = base64.b64encode(p.read_bytes()).decode()
    (resp,) = _post(http_server, {"image_b64": b64})["results"]
    assert 0.0 <= resp["prob"] <= 1.0 and resp["path"] == "b64"
    (by_path,) = _post(http_server, {"path": str(p)})["results"]
    assert resp["topk"] == by_path["topk"]


def test_error_isolation(http_server, tmp_path):
    """One bad entry never poisons the others in the same request."""
    p = _img_file(tmp_path, "c.png", 2)
    results = _post(http_server, {"paths": [str(p), str(tmp_path / "missing.png")],
                                  "image_b64": "!!!not-base64!!!"})["results"]
    assert len(results) == 3
    ok = [r for r in results if "error" not in r]
    bad = [r for r in results if "error" in r]
    assert len(ok) == 1 and len(bad) == 2


def test_multi_image_request_batches_one_device_call(http_server, tmp_path):
    """A paths-list request (and an images_b64 one) enqueues everything
    before waiting, so the worker serves it as ONE batch."""
    ps = [_img_file(tmp_path, f"m{i}.png", 10 + i) for i in range(3)]
    for payload in ({"paths": [str(p) for p in ps]},
                    {"images_b64": [base64.b64encode(p.read_bytes()).decode() for p in ps]}):
        results = _post(http_server, payload)["results"]
        assert len(results) == 3
        assert {r["request_count"] for r in results} == {3}
        assert len({r["latency_ms"] for r in results}) == 1
    assert [r["path"] for r in results] == ["b64[0]", "b64[1]", "b64[2]"]


def test_bad_body_400(http_server):
    for payload in ({}, {"junk": 1}):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(http_server, payload)
        assert e.value.code == 400
    req = urllib.request.Request(http_server + "/classify", data=b"{not json",
                                 method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 400


def test_metrics_endpoint(http_server, tmp_path):
    """GET /metrics: JAX's six names; the counters advance with traffic."""
    def scrape():
        with urllib.request.urlopen(http_server + "/metrics", timeout=30) as r:
            assert r.headers["Content-Type"].startswith("text/plain")
            text = r.read().decode()
        return {ln.split()[0]: float(ln.split()[1])
                for ln in text.splitlines() if ln and not ln.startswith("#")}

    before = scrape()
    assert set(before) == {"serve_images_total", "serve_batches_total", "serve_device_ms_sum",
                           "serve_errors_total", "serve_decode_errors_total",
                           "serve_batch_capacity"}
    p = _img_file(tmp_path, "metrics.png", 42)
    _post(http_server, {"paths": [str(p), str(tmp_path / "nope.png")]})
    after = scrape()
    assert after["serve_images_total"] == before["serve_images_total"] + 1
    assert after["serve_batches_total"] >= before["serve_batches_total"] + 1
    assert after["serve_decode_errors_total"] == before["serve_decode_errors_total"] + 1
    assert after["serve_device_ms_sum"] > before["serve_device_ms_sum"]
    assert after["serve_errors_total"] == before["serve_errors_total"]
    assert after["serve_batch_capacity"] == 4


def test_concurrent_clients_batch_and_isolate(http_server, tmp_path):
    """12 clients at once (batch 4, max_wait 0.2 s): each gets its own
    image's prediction, the bad path stays isolated, b64 works under
    concurrency, and the worker served fewer batches than requests."""
    paths = [_img_file(tmp_path, f"cc_{i}.png", seed=100 + i) for i in range(10)]
    want = {str(p): _post(http_server, {"path": str(p)})["results"][0]["topk"] for p in paths}
    results: dict = {}

    def client(i):
        try:
            if i == 10:
                results[i] = _post(http_server, {"path": "/nope/missing.png"})
            elif i == 11:
                results[i] = _post(http_server, {
                    "image_b64": base64.b64encode(paths[0].read_bytes()).decode()})
            else:
                results[i] = _post(http_server, {"path": str(paths[i])})
        except Exception as e:  # noqa: BLE001 — surfaced in the main thread
            results[i] = e

    threads = [threading.Thread(target=client, args=(i,)) for i in range(12)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and len(results) == 12
    for i in range(10):
        assert not isinstance(results[i], Exception), results[i]
        (resp,) = results[i]["results"]
        assert resp["path"] == str(paths[i])
        assert resp["topk"] == want[str(paths[i])], "co-batched differs from sequential"
    assert "error" in results[10]["results"][0]
    assert results[11]["results"][0]["topk"] == want[str(paths[0])]
    assert max(r["results"][0].get("request_count", 1) for r in results.values()) > 1


def test_a_failing_batch_answers_every_request_with_an_error():
    """The worker's per-batch isolation: an exception in the service call
    becomes an error response for each request of that batch, counted."""
    def broken(x):
        raise RuntimeError("device fault")

    worker = serve._BatchWorker(broken, make_placer("cpu"), batch=2, topk=1, labels=None,
                                detector_threshold=None, max_wait_s=0.05)
    try:
        img = np.zeros((16, 16, 3), np.float32)
        resp = worker.submit(img, "x.png")
        assert resp == {"path": "x.png", "error": "RuntimeError: device fault"}
        assert worker.stats["errors_total"] == 1 and worker.stats["batches_total"] == 0
    finally:
        worker.shutdown()
    assert not worker._thread.is_alive()


def test_serve_cli_http_end_to_end(tmp_path):
    """The CLI in a subprocess: --http 0, the ready line carries the bound
    port, a classify round trip with the detector, SIGTERM drains (exit 0)."""
    img = _img_file(tmp_path, "e2e.png", 7)
    proc = subprocess.Popen(
        [sys.executable, "-m", "image_recognition_adversarial_example_attack_tpu_torch.cli.serve",
         "--model", "resnet_tiny", "--batch", "2", "--http", "0", "--device", "cpu",
         "--detector", "feature", "--detector_threshold", "0.5"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=str(REPO),
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    try:
        ready = json.loads(proc.stdout.readline())
        assert ready["ready"] is True and ready["device"] == "cpu"
        url = f"http://{ready['http']['host']}:{ready['http']['port']}"
        (resp,) = _post(url, {"path": str(img)})["results"]
        assert resp["top1"] >= 0 and resp["latency_ms"] > 0
        assert "detector_score" in resp and "detector_flag" in resp
        proc.send_signal(signal.SIGTERM)
        stdout, stderr = proc.communicate(timeout=60)
        assert proc.returncode == 0, stderr[-2000:]
        assert json.loads(stdout.splitlines()[-1]) == {"shutdown": True,
                                                        "signal": int(signal.SIGTERM)}
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
