"""A JSON endpoint over one serving engine, on the standard library's
``http.server`` (port of the single-engine part of
``deepdfa_tpu/serve/http.py``).

    POST /score
        {"functions": [{"id"?, "graph": {"num_nodes", "senders",
         "receivers", "feats": {subkey: [...]}}, "code"?}, ...],
         "deadline_ms"?}
        -> 200 {"results": [{"rid", "prob", "model", "degraded",
                "cached"} | {"error", ...}, ...]}  (errors inline)
        -> 400 {"error": "bad_request", "detail"} on a malformed envelope
        -> 413 {"results": [...]} when every function was oversized
        -> 429 {"error": "rejected", "retry_after_s"} with an integer
           Retry-After header when every function was shed by
           backpressure
        -> 500 {"results": [{"error": "internal", ...}, ...]} when every
           function died in a failed micro-batch (flush isolation: only
           that flush fails, the queue keeps draining)
    GET /metrics -> the engine's ServingStats snapshot as JSON (queue
                    depth, occupancy, p50/p99 latency, cache hit rate,
                    compile count; ``n_replicas`` and ``replicas`` as the
                    reference's one-replica fleet reports them), and the
                    process's ``kernel_launches`` by kernel name
    GET /healthz -> {"status": "ok", "warm_buckets": N} (+ the card's
                    allocated and peak bytes on CUDA)
    anything else -> 404 {"error": "not_found"}

A function whose code scores on the combined lane answers
``"model": "combined"``; one whose tokenizer failed answers the gnn
lane's probability with ``"degraded": true``. The reference answers an
all-oversized POST 200 with the errors inline; here it is 413, the
errors still inline.

Transport threads (``ThreadingHTTPServer``, one a connection) submit and
block on each request's event; one pump thread owns execution, waking at
the batcher's flush horizon, so no device work runs on a transport
thread. The reference's telemetry (``telemetry_drops``, trace context),
SLO monitor, scan service, fleet and lame-duck drain are not ported yet.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple

from deepdfa_tpu_torch.serve.batcher import OversizedError, RejectedError
from deepdfa_tpu_torch.serve.engine import BadRequestError, ServeEngine

logger = logging.getLogger(__name__)

# Pump idle sleep bounds: a first request into an empty queue waits at
# most ~2 ms before its flush window is tracked; an idle pump does not
# spin.
_PUMP_MIN_SLEEP_S = 0.002
_PUMP_MAX_SLEEP_S = 0.050
# The reference's one-replica fleet names its replica so.
_REPLICA_ID = "r0"


def _retry_header(seconds: float) -> Dict[str, str]:
    """Retry-After as RFC 7231 delay-seconds: a whole number, at least 1."""
    return {"Retry-After": str(max(int(-(-seconds // 1)), 1))}


class _PumpThread(threading.Thread):
    """The engine's one execution thread: pumps whatever is due, then
    sleeps until the batcher's next flush horizon; drains on stop."""

    def __init__(self, engine: ServeEngine):
        super().__init__(name="serve-pump", daemon=True)
        self.engine = engine
        self._halt = threading.Event()

    def stop(self) -> None:
        self._halt.set()

    def run(self) -> None:
        while not self._halt.is_set():
            try:
                self.engine.pump()
            except Exception:
                logger.exception("pump failed")
            horizon = self.engine.next_flush_time()
            if horizon is None:
                sleep = _PUMP_MAX_SLEEP_S
            else:
                sleep = min(max(horizon - self.engine.now(),
                                _PUMP_MIN_SLEEP_S), _PUMP_MAX_SLEEP_S)
            self._halt.wait(sleep)
        # Shutdown: answer whatever is still queued.
        try:
            self.engine.drain()
        except Exception:
            logger.exception("drain on shutdown failed")


class ServeHandler(BaseHTTPRequestHandler):
    server: "ServeHTTPServer"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # access logs go to logging
        logger.debug("%s %s", self.address_string(), fmt % args)

    def _send_json(self, code: int, payload: Dict,
                   headers: Optional[Dict[str, str]] = None) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:
        engine = self.server.engine
        if self.path == "/healthz":
            doc: Dict = {"status": "ok", "warm_buckets": engine.n_warm}
            if engine.device.type == "cuda":
                import torch

                doc["device_bytes_in_use"] = torch.cuda.memory_allocated(
                    engine.device)
                doc["device_peak_bytes_in_use"] = \
                    torch.cuda.max_memory_allocated(engine.device)
            self._send_json(200, doc)
        elif self.path == "/metrics":
            self._send_json(200, self.server.metrics())
        else:
            self._send_json(404, {"error": "not_found"})

    def do_POST(self) -> None:
        if self.path != "/score":
            self._send_json(404, {"error": "not_found"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            doc = json.loads(self.rfile.read(length) or b"{}")
            functions = doc["functions"]
            if not isinstance(functions, list) or not functions:
                raise ValueError("'functions' must be a non-empty list")
            deadline_ms = doc.get("deadline_ms")
            if deadline_ms is not None:
                deadline_ms = float(deadline_ms)
                if not deadline_ms > 0:
                    raise ValueError("deadline_ms must be > 0")
        except Exception as e:
            self._send_json(400, {"error": "bad_request", "detail": str(e)})
            return
        engine = self.server.engine
        submitted, results = [], []
        for fn in functions:
            entry: Dict = {}
            try:
                lane = fn.get("lane")
                req = engine.submit(
                    fn["graph"] if lane != "gen" else fn.get("graph"),
                    code=fn.get("code"), deadline_ms=deadline_ms, lane=lane)
                submitted.append((req, entry))
            except RejectedError as e:
                entry.update(error="rejected", retry_after_s=e.retry_after_s)
            except OversizedError as e:
                entry.update(error="oversized", detail=str(e))
            except BadRequestError as e:
                entry.update(error="bad_request", detail=str(e))
            except KeyError as e:
                entry.update(error="bad_request", detail=f"missing field {e}")
            except (TypeError, AttributeError) as e:
                # A null or a string where a function object belongs: the
                # inline-error contract covers malformed entries too.
                entry.update(error="bad_request", detail=str(e))
            results.append(entry)

        if not submitted and all(r.get("error") == "rejected"
                                 for r in results):
            retry = max(r["retry_after_s"] for r in results)
            self._send_json(429, {"error": "rejected",
                                  "retry_after_s": retry},
                            headers=_retry_header(retry))
            return
        if not submitted and all(r.get("error") == "oversized"
                                 for r in results):
            self._send_json(413, {"results": results})
            return
        # Block until the pump answers each admitted request; generous,
        # so a stuck pump surfaces as an error rather than a hang.
        wait_s = ((deadline_ms or engine.config.deadline_ms) / 1000.0) \
            * 10 + 30.0
        for req, entry in submitted:
            if req.event.wait(timeout=wait_s) and req.result is not None:
                entry.update(req.result)
            else:
                entry.update(error="timeout")
        status = 500 if all(r.get("error") == "internal"
                            for r in results) else 200
        self._send_json(status, {"results": results})


class ServeHTTPServer(ThreadingHTTPServer):
    """The threaded HTTP server over ``engine`` with its pump thread
    (started by :meth:`start_pump`, stopped and drained by
    :meth:`shutdown`)."""

    daemon_threads = True

    def __init__(self, address: Tuple[str, int], engine: ServeEngine):
        super().__init__(address, ServeHandler)
        self.engine = engine
        self.pump_thread = _PumpThread(engine)

    def metrics(self) -> Dict:
        """The ``/metrics`` body: the engine's snapshot, with the
        reference's one-replica fleet sections, and every kernel's
        launches in this process (a client reads them before and after
        its traffic)."""
        from deepdfa_tpu_torch.ops import launch_counts

        snap = self.engine.snapshot()
        replica = dict(snap, lame_duck=False, in_flight=0)
        return dict(snap, n_replicas=1, replicas={_REPLICA_ID: replica},
                    kernel_launches=launch_counts())

    def start_pump(self) -> None:
        self.pump_thread.start()

    def shutdown(self) -> None:  # type: ignore[override]
        self.pump_thread.stop()
        super().shutdown()
        self.pump_thread.join(timeout=10.0)


def serve_forever(engine: ServeEngine, host: str = "127.0.0.1",
                  port: int = 8080, port_file: Optional[str] = None) -> None:
    """Blocking entry: start the pump and serve until interrupted.
    Ctrl-C (KeyboardInterrupt) shuts the server down cleanly: the pump
    answers what is queued and the socket closes. ``port_file`` gets the
    bound port after bind (how a client finds an ephemeral ``port=0``).
    Warm the engine first."""
    server = ServeHTTPServer((host, port), engine)
    thread = threading.Thread(target=server.serve_forever,
                              name="serve-http", daemon=True)
    try:
        server.start_pump()
        thread.start()
        if port_file:
            tmp = f"{port_file}.tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                f.write(str(server.server_address[1]))
            os.replace(tmp, port_file)
        logger.info("serving on %s:%d (%d warm buckets)", host,
                    server.server_address[1], engine.n_warm)
        try:
            while thread.is_alive():
                thread.join(timeout=0.5)
        except KeyboardInterrupt:
            logger.info("interrupted: shutting down")
    finally:
        if thread.is_alive():
            server.shutdown()  # the pump drains and stops too
        elif server.pump_thread.is_alive():
            server.pump_thread.stop()
            server.pump_thread.join(timeout=10.0)
        server.server_close()
