"""A JSON endpoint over a serving engine or fleet, on the standard
library's ``http.server`` (port of ``deepdfa_tpu/serve/http.py``).

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
    GET /metrics -> the fleet's snapshot as JSON (queue depth,
                    occupancy, p50/p99 latency, cache hit rate, compiles
                    and compiles after warmup, graph-pool bytes, summed
                    over the replicas; ``n_replicas`` and each replica's
                    own snapshot under ``replicas``), and the process's
                    ``kernel_launches`` by kernel name
    GET /healthz -> {"status": "ok", "warm_buckets": N} (+ the card's
                    allocated and peak bytes on CUDA; + a ``fleet``
                    section with more than one replica: some replicas
                    draining reads "degraded", all "draining", both 503)
    anything else -> 404 {"error": "not_found"}

A function whose code scores on the combined lane answers
``"model": "combined"``; one whose tokenizer failed answers the gnn
lane's probability with ``"degraded": true``. The reference answers an
all-oversized POST 200 with the errors inline; here it is 413, the
errors still inline.

Transport threads (``ThreadingHTTPServer``, one a connection) submit
through the fleet's router and block on each request's event; each
replica has one pump thread that owns its execution, waking at its
batcher's flush horizon, so no device work runs on a transport thread.
The reference's telemetry (``telemetry_drops``, trace context), SLO
monitor, scan service and server-wide lame-duck drain are not ported
yet.
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
from deepdfa_tpu_torch.serve.fleet import ServeFleet

logger = logging.getLogger(__name__)

# Pump idle sleep bounds: a first request into an empty queue waits at
# most ~2 ms before its flush window is tracked; an idle pump does not
# spin.
_PUMP_MIN_SLEEP_S = 0.002
_PUMP_MAX_SLEEP_S = 0.050


def _retry_header(seconds: float) -> Dict[str, str]:
    """Retry-After as RFC 7231 delay-seconds: a whole number, at least 1."""
    return {"Retry-After": str(max(int(-(-seconds // 1)), 1))}


class _PumpThread(threading.Thread):
    """One replica's execution thread: pumps whatever is due, then sleeps
    until its batcher's next flush horizon; drains on stop."""

    def __init__(self, engine: ServeEngine):
        super().__init__(name=(f"serve-pump-{engine.replica}"
                               if engine.replica else "serve-pump"),
                         daemon=True)
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
        fleet = self.server.fleet
        if self.path == "/healthz":
            doc: Dict = {"status": "ok", "warm_buckets": fleet.n_warm}
            if fleet.size > 1:
                # A replica mid-roll degrades the fleet (part of its
                # capacity is out) without taking it out of rotation.
                health = fleet.health()
                doc["fleet"] = health
                if health["live"] == 0:
                    doc["status"] = "draining"
                elif health["live"] < health["size"]:
                    doc["status"] = "degraded"
            device = self.server.engine.device
            if device.type == "cuda":
                import torch

                doc["device_bytes_in_use"] = torch.cuda.memory_allocated(
                    device)
                doc["device_peak_bytes_in_use"] = \
                    torch.cuda.max_memory_allocated(device)
            self._send_json(200 if doc["status"] == "ok" else 503, doc)
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
        fleet = self.server.fleet
        submitted, results = [], []
        for fn in functions:
            entry: Dict = {}
            try:
                lane = fn.get("lane")
                req = fleet.submit(
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
        wait_s = ((deadline_ms or fleet.config.deadline_ms) / 1000.0) \
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
    """The threaded HTTP server over ``engine`` (a ``ServeEngine``, taken
    as a one-replica fleet, or a ``ServeFleet``) with one pump thread a
    replica (started by :meth:`start_pump`, stopped and drained by
    :meth:`shutdown`)."""

    daemon_threads = True
    # The listen backlog: socketserver's default of 5 drops the SYNs of a
    # burst of new connections beyond it, and each dropped client retries
    # a second later (16 clients on a 2-replica fleet: p99 over 1 s).
    request_queue_size = 128

    def __init__(self, address: Tuple[str, int], engine):
        super().__init__(address, ServeHandler)
        self.fleet = (engine if isinstance(engine, ServeFleet)
                      else ServeFleet.from_engine(engine))
        self.pump_threads = [_PumpThread(r.engine)
                             for r in self.fleet.replicas]
        self.pump_thread = self.pump_threads[0]

    @property
    def engine(self) -> ServeEngine:
        """The primary replica's engine."""
        return self.fleet.primary.engine

    def metrics(self) -> Dict:
        """The ``/metrics`` body: the fleet's snapshot and every kernel's
        launches in this process (a client reads them before and after
        its traffic)."""
        from deepdfa_tpu_torch.ops import launch_counts

        return dict(self.fleet.snapshot(), kernel_launches=launch_counts())

    def start_pump(self) -> None:
        for t in self.pump_threads:
            t.start()

    def shutdown(self) -> None:  # type: ignore[override]
        for t in self.pump_threads:
            t.stop()
        super().shutdown()
        for t in self.pump_threads:
            t.join(timeout=10.0)


def serve_forever(engine, host: str = "127.0.0.1",
                  port: int = 8080, port_file: Optional[str] = None) -> None:
    """Blocking entry: start the pumps and serve until interrupted.
    ``engine`` is a ``ServeEngine`` or a ``ServeFleet`` (one pump thread
    a replica). Ctrl-C (KeyboardInterrupt) shuts the server down cleanly:
    the pumps answer what is queued and the socket closes. ``port_file``
    gets the bound port after bind (how a client finds an ephemeral
    ``port=0``). Warm the engine or fleet first."""
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
        logger.info("serving on %s:%d (%d replica(s), %d warm buckets)",
                    host, server.server_address[1], server.fleet.size,
                    server.fleet.n_warm)
        try:
            while thread.is_alive():
                thread.join(timeout=0.5)
        except KeyboardInterrupt:
            logger.info("interrupted: shutting down")
    finally:
        if thread.is_alive():
            server.shutdown()  # the pumps drain and stop too
        else:
            for pump in server.pump_threads:
                if pump.is_alive():
                    pump.stop()
                    pump.join(timeout=10.0)
        server.server_close()
