"""Persistent batched inference service (port of ``cli/serve.py``).

Start once, warm the service once, then classify a stream of images:

    python -m image_recognition_adversarial_example_attack_tpu_torch.cli.serve \\
        --batch 8 --defend --detector squeezing --detector_threshold 0.5 < paths.txt

Protocol (the JAX CLI's): one image path per input line; one JSON object
per output line (``path``, ``top1``/``label``/``prob``/``topk``, optional
``defended_top1``, optional ``detector_score``/``detector_flag``, and the
timing fields: ``latency_ms`` the wall time of the chunk that served this
response, from before its upload until its outputs are on the host;
``decode_ms`` the host decode time of the drain it arrived in;
``batch_size`` the fixed device batch; ``request_count`` the requests in the
drain).  A ``{"ready": true, ...}`` line follows the warm-up, which runs the
exact service at the serving shape (the kernels' build at first use,
cuDNN's set-up).  An unreadable image gets a ``{"path", "error"}`` line.
SIGTERM/SIGINT drain: the batch in flight finishes, a final
``{"shutdown": true, "signal": N}`` line is printed, and the process exits
0.  ``--input FILE`` serves the file's lines and exits.

One service function (forward, + the defended forward, + the detector
score) runs at a fixed ``--batch``; short batches pad with zeros.
``--overlap`` decodes the next drain on a producer thread while the card
computes the current one, and resolves responses one drain behind, so chunk
t+1's pinned, non-blocking upload overlaps chunk t's compute (at most two
chunks in flight).  ``--transfer_uint8`` ships uint8 pixels and converts
them on the device inside the service.  ``--sharded`` splits each batch
over every visible card (``parallel/mesh.py``; the batch rounds up to a
multiple of the card count), one model replica a card; with one card it is
off.

``--http PORT`` serves HTTP instead (stdlib ThreadingHTTPServer): ``GET
/healthz``, ``GET /metrics`` and ``POST /classify`` with a JSON body of
``path``/``paths``/``image_b64``/``images_b64``.  Handler threads only
decode; one worker thread batches submissions across requests and does all
device work.

``--device`` defaults to ``cuda`` and raises where CUDA is absent unless
given ``cpu``.  The input size is 224 whatever the model, as in the JAX CLI.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import os
import select
import signal
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..core.images import load_image_batch_tolerant
from ..core.labels import load_imagenet_labels
from ..parallel.mesh import ShardedTensor, data_sharding, make_mesh, visible_devices
from .common import add_model_args, load_bundle, make_fns


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Persistent batched inference service (line protocol)")
    parser.add_argument("--batch", type=int, default=8,
                        help="fixed device batch size (requests pad up to this)")
    parser.add_argument("--topk", type=int, default=5)
    parser.add_argument("--defend", action="store_true",
                        help="also classify through the preprocessing "
                             "defense (smooth+quantize)")
    parser.add_argument("--detector", type=str, default="none",
                        choices=["none", "feature", "squeezing"],
                        help="score every input with the chosen detector")
    parser.add_argument("--detector_threshold", type=float, default=None,
                        help="flag inputs whose score exceeds this")
    parser.add_argument("--max_wait_ms", type=float, default=5.0,
                        help="micro-batching window after the first request")
    parser.add_argument("--input", type=str, default="-",
                        help="'-' = stdin stream; a file path = serve its "
                             "lines then exit")
    parser.add_argument("--http", type=int, default=None, metavar="PORT",
                        help="serve HTTP instead of the line protocol: "
                             "GET /healthz, POST /classify with "
                             "{path|paths|image_b64|images_b64}; handler "
                             "threads decode, ONE worker micro-batches "
                             "across concurrent requests (port 0 = pick a "
                             "free port, printed in the ready line)")
    parser.add_argument("--http_host", type=str, default="127.0.0.1",
                        help="HTTP bind address (default loopback)")
    parser.add_argument("--sharded", action="store_true",
                        help="split request batches over every visible card "
                             "when more than one is visible (batch rounds up "
                             "to a multiple of the card count)")
    parser.add_argument("--transfer_uint8", action="store_true",
                        help="ship uint8 pixels to the device and convert "
                             "to float there: 4x less host->device transfer; "
                             "pixels re-quantize to the 1/255 grid post-resize, "
                             "so predictions can differ in the last ulp")
    parser.add_argument("--overlap", action="store_true",
                        help="pipeline the line-protocol request path: a "
                             "producer thread drains+decodes the NEXT batch "
                             "while the device computes the current one, and "
                             "responses resolve one drain behind so chunk "
                             "t+1's upload overlaps chunk t's compute "
                             "(latency_ms then includes the overlap window)")
    add_model_args(parser)
    return parser


def _chunk_responses(out: dict, names: list[str], topk: int, labels,
                     detector_threshold) -> list[dict]:
    """Host outputs of ONE chunk -> per-request response dicts (the line
    protocol's and the HTTP front end's); the first ``len(names)`` rows are
    real requests, the rest padding."""
    probs = out["probs"]
    responses = []
    for j, name in enumerate(names):
        row = probs[j]
        order = np.argsort(-row)[:topk]
        resp = {
            "path": name,
            "top1": int(order[0]),
            "label": (labels[order[0]] if labels and
                      order[0] < len(labels) else str(order[0])),
            "prob": float(row[order[0]]),
            "topk": [[int(c), float(row[c])] for c in order],
        }
        if "defended_pred" in out:
            resp["defended_top1"] = int(out["defended_pred"][j])
        if "score" in out:
            score = float(out["score"][j])
            resp["detector_score"] = score
            if detector_threshold is not None:
                resp["detector_flag"] = bool(score > float(detector_threshold))
        responses.append(resp)
    return responses


def _make_service_fn(logits_fn, features_fn, args):
    """The one service function: softmax of the float32 logits (+ the
    defended forward's argmax, + the feature or squeezing score), returning
    device tensors without waiting for them.

    It runs under ``torch.no_grad()`` itself, since grad mode is per thread
    and the HTTP worker calls it from its own.  With ``--transfer_uint8`` it
    takes uint8 pixels and divides them by 255 on the device."""
    from ..defenses.detector import score_from_features, squeezing_score
    from ..defenses.preprocess import DefenseConfig, defend_input

    defense_cfg = DefenseConfig()
    uint8_in = bool(getattr(args, "transfer_uint8", False))

    @torch.no_grad()
    def service(x: torch.Tensor) -> dict[str, torch.Tensor]:
        if uint8_in:
            # by a 0-d tensor filled on the device (no host copy, no wait):
            # PyTorch divides by a Python scalar as a product with its
            # reciprocal
            x = x.to(torch.float32) / torch.full((), 255.0, device=x.device)
        out = {"probs": torch.softmax(logits_fn(x), dim=-1)}
        if args.defend:
            out["defended_pred"] = torch.argmax(logits_fn(defend_input(x, defense_cfg)), dim=-1)
        if args.detector == "feature":
            out["score"] = score_from_features(features_fn(x))
        elif args.detector == "squeezing":
            out["score"] = squeezing_score(logits_fn, x)
        return out

    return service


def _sharded_service(bundle, args, mesh):
    """The service over a ``ShardedTensor`` batch: one model replica and one
    service a device of the mesh, each shard served on its own device (the
    launches are asynchronous, so the devices work at once); each output is
    a ``ShardedTensor`` of the same sharding."""
    services = []
    for dev in mesh.flat_devices:
        replica = dataclasses.replace(bundle, model=copy.deepcopy(bundle.model).to(dev),
                                      device=dev)
        services.append((dev, _make_service_fn(*make_fns(replica), args)))

    def service(xs: ShardedTensor) -> dict[str, ShardedTensor]:
        outs = []
        for (dev, fn), x in zip(services, xs.shards):
            with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
                outs.append(fn(x))
        return {k: ShardedTensor(tuple(o[k] for o in outs), xs.sharding) for k in outs[0]}

    return service


def _device_get(out: dict) -> dict[str, np.ndarray]:
    """The service's outputs on the host; waits for the device work."""
    return {k: (v.gather() if isinstance(v, ShardedTensor) else v.cpu()).numpy()
            for k, v in out.items()}


class _BatchWorker:
    """Cross-request micro-batcher for the HTTP front end.

    Handler threads decode their own request and ``submit()`` the image;
    ONE worker thread drains up to ``batch`` submissions within the
    ``max_wait_s`` window and serves them with one service call, so all
    device work stays on this thread (and the default stream).
    """

    def __init__(self, service, place, batch: int, topk: int, labels,
                 detector_threshold, max_wait_s: float) -> None:
        import queue
        import threading

        self._service = service
        self._place = place
        self._batch = batch
        self._topk = topk
        self._labels = labels
        self._threshold = detector_threshold
        self._max_wait_s = max_wait_s
        self._queue: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        # the counters of GET /metrics: only the worker thread writes the
        # batch and device entries, only handler threads the decode errors
        self.stats = {"images_total": 0, "batches_total": 0,
                      "device_ms_sum": 0.0, "errors_total": 0,
                      "decode_errors_total": 0}
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit_async(self, img: np.ndarray, name: str) -> dict:
        """Enqueue a request; returns a ticket for ``result()``.  Multi-
        image requests enqueue ALL their images before waiting so they
        batch together in one device call."""
        import threading

        item = {"img": img, "name": name, "event": threading.Event(),
                "resp": None}
        self._queue.put(item)
        return item

    @staticmethod
    def result(item: dict) -> dict:
        item["event"].wait()
        return item["resp"]

    def submit(self, img: np.ndarray, name: str) -> dict:
        """Block until the worker has served this request; returns the
        response dict (timing fields included)."""
        return self.result(self.submit_async(img, name))

    def shutdown(self) -> None:
        """Stop the worker and join it, so no thread is left mid-launch."""
        self._stop.set()
        self._thread.join(timeout=10.0)

    def _drain(self) -> list[dict]:
        import queue

        while True:
            try:  # bounded block so shutdown() is honored while idle
                first = self._queue.get(timeout=0.25)
                break
            except queue.Empty:
                if self._stop.is_set():
                    return []
        items = [first]
        deadline = time.monotonic() + self._max_wait_s
        while len(items) < self._batch:
            remaining = deadline - time.monotonic()
            try:
                items.append(self._queue.get(timeout=max(0.0, remaining)))
            except queue.Empty:
                break
        return items

    def _run(self) -> None:
        while True:
            items = self._drain()
            if not items:
                if self._stop.is_set():
                    return
                continue
            x_np = np.stack([it["img"] for it in items])
            pad = self._batch - len(items)
            if pad > 0:
                x_np = np.concatenate(
                    [x_np, np.zeros((pad,) + x_np.shape[1:], np.float32)])
            t_dev = time.perf_counter()
            try:
                out = _device_get(self._service(self._place(x_np)))
            except Exception as e:  # noqa: BLE001 — per-batch isolation
                self.stats["errors_total"] += len(items)
                for it in items:
                    it["resp"] = {"path": it["name"],
                                  "error": f"{type(e).__name__}: {e}"}
                    it["event"].set()
                continue
            dev_ms = (time.perf_counter() - t_dev) * 1e3
            self.stats["batches_total"] += 1
            self.stats["images_total"] += len(items)
            self.stats["device_ms_sum"] += dev_ms
            built = _chunk_responses(out, [it["name"] for it in items],
                                     self._topk, self._labels,
                                     self._threshold)
            for it, resp in zip(items, built):
                resp["latency_ms"] = round(dev_ms, 2)
                resp["batch_size"] = self._batch
                resp["request_count"] = len(items)
                it["resp"] = resp
                it["event"].set()


def make_http_server(host: str, port: int, worker: _BatchWorker,
                     ready_info: dict, size: int):
    """HTTP front end over the batch worker (stdlib only, threaded).

        GET  /healthz              -> the ready line as JSON
        GET  /metrics              -> Prometheus text exposition
            (serve_images_total, serve_batches_total,
             serve_device_ms_sum, serve_errors_total,
             serve_decode_errors_total, serve_batch_capacity)
        POST /classify             -> {"results": [response, ...]}
            body: {"path": p} | {"paths": [...]} |
                  {"image_b64": b} | {"images_b64": [...]}
                  (base64 of any decodable image file's BYTES)

    Handler threads decode; the worker micro-batches across concurrent
    requests.  Returns the server; callers run ``serve_forever()``.
    """
    import base64
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from ..core.images import load_image, load_image_bytes

    def decode_entry(entry: dict) -> tuple[np.ndarray | None, str, str | None]:
        """-> (img, name, error).  Decode failures isolate per request."""
        if "path" in entry:
            name = str(entry["path"])
            try:
                return load_image(name, size=size)[0], name, None
            except Exception as e:  # noqa: BLE001
                return None, name, f"{type(e).__name__}: {e}"
        name = str(entry.get("name", "b64"))
        try:
            raw = base64.b64decode(entry["image_b64"], validate=True)
            return load_image_bytes(raw, size=size), name, None
        except Exception as e:  # noqa: BLE001
            return None, name, f"{type(e).__name__}: {e}"

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):  # route access logs to stderr
            print("http: " + fmt % a, file=sys.stderr)

        def _send(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 — http.server API
            if self.path in ("/healthz", "/health", "/"):
                self._send(200, ready_info)
            elif self.path == "/metrics":
                s = worker.stats
                lines = [
                    "# TYPE serve_images_total counter",
                    f"serve_images_total {s['images_total']}",
                    "# TYPE serve_batches_total counter",
                    f"serve_batches_total {s['batches_total']}",
                    "# TYPE serve_device_ms_sum counter",
                    f"serve_device_ms_sum {s['device_ms_sum']:.3f}",
                    "# TYPE serve_errors_total counter",
                    f"serve_errors_total {s['errors_total']}",
                    "# TYPE serve_decode_errors_total counter",
                    f"serve_decode_errors_total {s['decode_errors_total']}",
                    "# TYPE serve_batch_capacity gauge",
                    f"serve_batch_capacity {ready_info.get('batch', 0)}",
                    "",
                ]
                body = "\n".join(lines).encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._send(404, {"error": f"no route {self.path}"})

        def do_POST(self):  # noqa: N802 — http.server API
            if self.path != "/classify":
                self._send(404, {"error": f"no route {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
            except (ValueError, json.JSONDecodeError) as e:
                self._send(400, {"error": f"bad JSON body: {e}"})
                return
            entries = []
            if "paths" in req:
                entries += [{"path": p} for p in req["paths"]]
            if "path" in req:
                entries.append({"path": req["path"]})
            if "images_b64" in req:
                entries += [{"image_b64": b, "name": f"b64[{i}]"}
                            for i, b in enumerate(req["images_b64"])]
            if "image_b64" in req:
                entries.append({"image_b64": req["image_b64"]})
            if not entries:
                self._send(400, {"error": "body needs path|paths|"
                                          "image_b64|images_b64"})
                return
            # decode everything first, then enqueue all images back to back,
            # then wait: a multi-image request reaches the worker as one
            # burst and batches into one device call
            decoded: list[tuple[np.ndarray | None, str, str | None, float]] = []
            for entry in entries:
                t0 = time.perf_counter()
                img, name, err = decode_entry(entry)
                if err is not None:
                    worker.stats["decode_errors_total"] += 1
                decoded.append((img, name, err,
                                (time.perf_counter() - t0) * 1e3))
            tickets = [
                (None if err else worker.submit_async(img, name),
                 {"path": name, "error": err} if err else None,
                 decode_ms)
                for img, name, err, decode_ms in decoded
            ]
            results = []
            for ticket, err_resp, decode_ms in tickets:
                resp = err_resp if ticket is None else worker.result(ticket)
                resp["decode_ms"] = round(decode_ms, 2)
                results.append(resp)
            self._send(200, {"results": results})

    return ThreadingHTTPServer((host, port), Handler)


class _LineStream:
    """Non-blocking line reader over a raw fd with its own byte buffer.

    Micro-batching must see every line the OS has already delivered.  A
    ``select()`` on a buffered TextIOWrapper cannot: ``readline()`` pulls a
    whole burst into Python's buffer, where select never reports it, so a
    bursty client would degrade to batches of one, each paying the full wait
    window.  Reading raw bytes with ``os.read`` into our own buffer makes
    buffered but unconsumed lines visible to the drain loop at once.
    """

    def __init__(self, fileno: int) -> None:
        self._fd = fileno
        self._buf = bytearray()
        self.eof = False

    def _pop_line(self) -> str | None:
        i = self._buf.find(b"\n")
        if i >= 0:
            line = self._buf[:i].decode("utf-8", "replace")
            del self._buf[: i + 1]
            return line
        if self.eof and self._buf:
            line = self._buf.decode("utf-8", "replace")
            self._buf.clear()
            return line
        return None

    def readline(self, timeout: float | None) -> str | None:
        """Next line without its newline; ``None`` on timeout or EOF
        (check ``.eof`` to distinguish).  ``timeout=0`` takes whatever is
        buffered or OS-ready without waiting."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            line = self._pop_line()
            if line is not None:
                return line
            if self.eof:
                return None
            if deadline is None:
                ready, _, _ = select.select([self._fd], [], [])
            else:
                remaining = max(0.0, deadline - time.monotonic())
                ready, _, _ = select.select([self._fd], [], [], remaining)
                if not ready:
                    return None
            chunk = os.read(self._fd, 65536)
            if not chunk:
                self.eof = True
            else:
                self._buf += chunk


def _drain_requests(reader: _LineStream, batch: int, max_wait_s: float,
                    should_stop=None) -> list[str] | None:
    """Block for one request line, then micro-batch any more that arrive
    within the wait window (or are already buffered), up to ``batch``.
    Returns None at end of stream or when ``should_stop()`` turns true
    while idle (graceful signal drain)."""
    while True:
        # bounded block: wake periodically so a SIGTERM received while idle
        # drains the service instead of leaving it parked in select
        first = reader.readline(0.25)
        if first is not None:
            break
        if reader.eof or (should_stop is not None and should_stop()):
            return None
    lines = [first]
    deadline = time.monotonic() + max_wait_s
    while len(lines) < batch:
        remaining = deadline - time.monotonic()
        # timeout 0 still harvests buffered/OS-ready lines without waiting
        nxt = reader.readline(max(0.0, remaining))
        if nxt is None:
            break  # timeout/EOF; a partial line stays buffered for next drain
        lines.append(nxt)
    return [ln for ln in lines if ln.strip()]


def _decode_drain(paths: list[str], size: int):
    """Batched tolerant decode with per-request failure isolation.

    Returns ``(responses, ok_pairs, decode_ms)``: ``responses`` holds error
    dicts at failed indices (None elsewhere), ``ok_pairs`` is
    ``[(request_idx, img), ...]`` in request order.  The loader writes its
    skip warnings to stderr itself, so nothing here touches stdout, which
    the main thread writes the protocol to while this runs on the
    ``--overlap`` producer thread."""
    from ..core.images import load_image

    t0 = time.perf_counter()
    try:
        x_ok, kept = load_image_batch_tolerant(paths, size=size)
    except Exception as e:  # noqa: BLE001 — the service must not die on a
        # request batch (every path unreadable, a broken native loader):
        # the per-path retries below harvest the real per-request errors
        print(f"batched decode failed, retrying per path: {e}",
              file=sys.stderr)
        x_ok, kept = None, []
    kept_set = {str(Path(p)) for p in kept}
    ok_idx = [i for i, p in enumerate(paths) if str(Path(p)) in kept_set]
    ok_set = set(ok_idx)
    imgs = list(x_ok) if x_ok is not None else []

    responses: list[dict | None] = [None] * len(paths)
    for i, p in enumerate(paths):
        if i in ok_set:
            continue
        # failed in the batched pass: retry alone for a specific error
        # message; a surprise success joins the batch
        try:
            imgs.append(load_image(p, size=size)[0])
            ok_idx.append(i)
            ok_set.add(i)
        except Exception as e:  # noqa: BLE001 — per-request failure isolation
            responses[i] = {"path": p, "error": f"{type(e).__name__}: {e}"}
    decode_ms = (time.perf_counter() - t0) * 1e3
    return responses, list(zip(ok_idx, imgs)), decode_ms


def _serve_http(args, service, place, batch: int, ready_info: dict,
                size: int) -> int:
    """HTTP mode: worker + ThreadingHTTPServer; SIGTERM/SIGINT drain the
    batch in flight and stop cleanly (exit 0)."""
    import threading

    worker = _BatchWorker(service, place, batch, int(args.topk),
                          load_imagenet_labels(), args.detector_threshold,
                          float(args.max_wait_ms) / 1e3)
    server = make_http_server(args.http_host, int(args.http), worker,
                              ready_info, size)
    host, port = server.server_address[:2]
    ready = dict(ready_info)
    ready["http"] = {"host": host, "port": int(port)}
    print(json.dumps(ready), flush=True)

    got_signal: list[int] = []
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, lambda s, _f: got_signal.append(s))
        except (ValueError, OSError):  # not the main thread
            pass

    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        while not got_signal:
            time.sleep(0.2)
    finally:
        server.shutdown()  # stop accepting; handlers in flight finish
        t.join(timeout=10.0)
        worker.shutdown()
    print(json.dumps({"shutdown": True,
                      "signal": int(got_signal[0]) if got_signal else 0}),
          flush=True)
    return 0


def main(argv=None) -> int:
    from ..eval.streaming import make_placer

    args = build_parser().parse_args(argv)
    batch = max(1, int(args.batch))

    bundle = load_bundle(args)
    device = bundle.device
    logits_fn, features_fn = make_fns(bundle)
    labels = load_imagenet_labels()
    service = _make_service_fn(logits_fn, features_fn, args)

    # optional scale-out: split request batches over every visible card,
    # one replica a card; these per-sample outputs need no cross-card traffic
    sharding = None
    devices = visible_devices(device)
    n_dev = len(devices)
    if args.sharded and n_dev > 1:
        if batch % n_dev:
            batch = ((batch // n_dev) + 1) * n_dev
            print(f"(sharded: batch rounded up to {batch} for {n_dev} devices)",
                  file=sys.stderr)
        sharding = data_sharding(make_mesh(n_data=n_dev, n_model=1, devices=devices))
        service = _sharded_service(bundle, args, sharding.mesh)

    transfer_uint8 = bool(args.transfer_uint8)
    put = make_placer(device, transfer_uint8=False)  # pinned, non-blocking

    def place(x_np):
        if transfer_uint8:
            x_np = np.clip(np.round(np.asarray(x_np) * 255.0), 0, 255
                           ).astype(np.uint8)
        return sharding.place(x_np) if sharding is not None else put(x_np)

    # warm the service itself at the serving shape: the kernels' build at
    # first use and cuDNN's set-up happen here, before the ready line
    size = 224
    _device_get(service(place(np.zeros((batch, size, size, 3), np.float32))))
    ready_info = {"ready": True, "batch": batch, "devices": n_dev,
                  "sharded": sharding is not None,
                  "device": str(devices[0])}

    if args.http is not None:
        return _serve_http(args, service, place, batch, ready_info, size)
    print(json.dumps(ready_info), flush=True)

    if args.input == "-":
        reader = _LineStream(sys.stdin.fileno())
        streaming = True
    else:
        with open(args.input) as f:
            file_lines = [ln.rstrip("\n") for ln in f.readlines() if ln.strip()]
        streaming = False

    # graceful drain: finish the batch in flight, answer it, then exit 0
    got_signal: list[int] = []
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, lambda s, _f: got_signal.append(s))
        except (ValueError, OSError):  # not the main thread
            pass

    topk = int(args.topk)

    def next_drain() -> list[str] | None:
        if streaming:
            return _drain_requests(reader, batch,
                                   float(args.max_wait_ms) / 1e3,
                                   should_stop=lambda: bool(got_signal))
        return file_lines or None

    def submit_chunks(ok_pairs):
        """Generator: upload and enqueue one padded chunk per iteration
        WITHOUT waiting for its outputs (the launches are asynchronous, so
        while the consumer defers ``_device_get``, chunk t+1's upload
        overlaps chunk t's compute)."""
        for chunk_start in range(0, len(ok_pairs), batch):
            pairs = ok_pairs[chunk_start:chunk_start + batch]
            chunk = [i for i, _ in pairs]
            x_np = np.stack([img for _, img in pairs])
            pad = batch - len(chunk)
            if pad:
                x_np = np.concatenate(
                    [x_np, np.zeros((pad,) + x_np.shape[1:], np.float32)])
            # the clock starts before place(): latency_ms covers the host
            # quantization, the upload and the compute
            t_sub = time.perf_counter()
            yield (chunk, service(place(x_np)), t_sub)

    def resolve_chunks(paths, responses, chunk_futs) -> dict[int, float]:
        """Wait for each chunk's outputs on the host and fill ``responses``;
        returns request idx -> latency (submit-to-host wall time; in
        overlap mode it includes the overlap window by design)."""
        chunk_ms: dict[int, float] = {}
        for chunk, fut, t_dev in chunk_futs:
            out = _device_get(fut)
            dev_ms = (time.perf_counter() - t_dev) * 1e3
            chunk_ms.update((i, dev_ms) for i in chunk)
            built = _chunk_responses(out, [paths[i] for i in chunk],
                                     topk, labels, args.detector_threshold)
            for i, resp in zip(chunk, built):
                responses[i] = resp
        return chunk_ms

    def emit(paths, responses, chunk_ms, decode_ms) -> None:
        # latency_ms is the wall time of the chunk that served THIS response
        # (error responses never reach the device and carry none);
        # batch_size is the device batch, not the request count
        for i, resp in enumerate(responses):
            resp = dict(resp)
            if i in chunk_ms:
                resp["latency_ms"] = round(chunk_ms[i], 2)
            resp["decode_ms"] = round(decode_ms, 2)
            resp["batch_size"] = batch
            resp["request_count"] = len(paths)
            print(json.dumps(resp), flush=True)

    if args.overlap:
        # double-buffered request path: a producer thread drains and decodes
        # drain t+1 while the device computes drain t, and the consumer
        # submits drain t+1's uploads BEFORE resolving drain t, so decode,
        # upload and compute overlap; responses resolve one drain behind
        # (same request order)
        import queue as queue_mod
        import threading

        q: "queue_mod.Queue" = queue_mod.Queue(maxsize=2)

        def produce() -> None:
            # an exception here (reader I/O, memory) must reach the
            # consumer: a silently dead producer would hang q.get() forever
            try:
                while True:
                    paths = next_drain()
                    if paths is None:
                        q.put(None)
                        return
                    q.put((paths, _decode_drain(paths, size)))
                    if not streaming or got_signal:
                        q.put(None)
                        return
            except BaseException as e:  # noqa: BLE001 — handed to the consumer, which raises it
                q.put(e)

        threading.Thread(target=produce, daemon=True).start()
        # at most this many chunks unresolved at once: a file-mode drain can
        # carry hundreds of chunks, and issuing them all before the first
        # wait would queue the whole file's inputs and outputs on the
        # device; 2 is enough to overlap the upload with the compute
        max_inflight = 2

        def flush_prev(prev) -> None:
            p_paths, p_resp, p_futs, p_ms, p_dec = prev
            p_ms.update(resolve_chunks(p_paths, p_resp, p_futs))
            emit(p_paths, p_resp, p_ms, p_dec)

        prev = None
        while True:
            try:
                item = q.get(timeout=0.25)
            except queue_mod.Empty:
                # idle flush: no next drain arrived, so answer the deferred
                # one now; a lockstep client (waiting for a response before
                # it sends more) is never starved
                if prev is not None:
                    flush_prev(prev)
                    prev = None
                continue
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            paths, (responses, ok_pairs, decode_ms) = item
            window: list = []
            chunk_ms: dict[int, float] = {}
            for one in submit_chunks(ok_pairs):
                window.append(one)
                if len(window) > max_inflight:
                    chunk_ms.update(
                        resolve_chunks(paths, responses, [window.pop(0)]))
            if prev is not None:
                flush_prev(prev)
            prev = (paths, responses, window, chunk_ms, decode_ms)
        if prev is not None:
            flush_prev(prev)
    else:
        while True:
            paths = next_drain()
            if paths is None:
                break
            responses, ok_pairs, decode_ms = _decode_drain(paths, size)
            chunk_ms: dict[int, float] = {}
            if ok_pairs:
                # sequential: each chunk resolves before the next submits
                for one in submit_chunks(ok_pairs):
                    chunk_ms.update(resolve_chunks(paths, responses, [one]))
            emit(paths, responses, chunk_ms, decode_ms)
            if not streaming:
                break
            if got_signal:
                break

    if got_signal:
        print(json.dumps({"shutdown": True, "signal": int(got_signal[0])}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
