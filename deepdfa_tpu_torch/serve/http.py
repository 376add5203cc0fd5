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
        -> 503 {"error": "draining", "retry_after_s"} with Retry-After
           while the server drains (lame duck)
        A ``traceparent`` header (``00-<trace32>-<span16>-01``) joins the
        client's trace: the requests' ``serve.request`` spans carry its
        trace id; a malformed one bumps ``trace_ctx_malformed_total``.
    GET /metrics -> the fleet's snapshot as JSON (queue depth,
                    occupancy, p50/p99 latency, cache hit rate, compiles
                    and compiles after warmup, graph-pool bytes, summed
                    over the replicas; ``n_replicas`` and each replica's
                    own snapshot under ``replicas``), and the process's
                    ``kernel_launches`` by kernel name. With an ``Accept``
                    header asking for ``text/plain`` or OpenMetrics: the
                    process registry in Prometheus text (every replica's
                    predeclared ``serve_<rid>_*`` series) plus the
                    snapshot's numbers as ``serve_*`` gauges
    GET /healthz -> {"status", "warm_buckets", "telemetry_drops"} (+ the
                    card's allocated and peak bytes from the memory
                    sampler on CUDA; + ``slo`` with an SLO monitor, a
                    burning SLO reads "degraded"; + a ``fleet`` section
                    with more than one replica: some replicas draining
                    reads "degraded", all "draining"); "draining" while
                    the server drains; anything but "ok" answers 503
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
The first pump also observes: once a second it samples the card's memory,
feeds the SLO monitor and flushes the telemetry run.

:func:`serve_forever` registers with the process lifecycle coordinator
(``resilience/lifecycle.py``): on SIGTERM or SIGINT the server drains
(new POSTs answer 503 with Retry-After, partial buckets flush at once,
every request admitted before the notice is answered and written), the
telemetry run is flushed, and the notice comes back to ``cli serve``,
which exits 75. The reference's scan service is not ported.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple

from deepdfa_tpu_torch import telemetry
from deepdfa_tpu_torch.serve.batcher import OversizedError, RejectedError
from deepdfa_tpu_torch.serve.engine import BadRequestError, ServeEngine
from deepdfa_tpu_torch.serve.fleet import ServeFleet
from deepdfa_tpu_torch.telemetry import context as trace_context
from deepdfa_tpu_torch.telemetry.memory import SAMPLER
from deepdfa_tpu_torch.telemetry.slo import SLOMonitor

logger = logging.getLogger(__name__)

# Pump idle sleep bounds: a first request into an empty queue waits at
# most ~2 ms before its flush window is tracked; an idle pump does not
# spin.
_PUMP_MIN_SLEEP_S = 0.002
_PUMP_MAX_SLEEP_S = 0.050
# SLO and memory observation cadence on the observing pump.
_OBSERVE_INTERVAL_S = 1.0

# The reference's checkpoint series, predeclared so the Prometheus
# exposition always carries them, as the reference's does.
_PREDECLARED_COUNTERS = (
    "ckpt_superseded_total",
    "ckpt_async_writes_total",
    "ckpt_async_errors_total",
)
_PREDECLARED_HISTOGRAMS = ("ckpt_drain_wait_ms",)


def _predeclare_metrics() -> None:
    for name in _PREDECLARED_COUNTERS:
        telemetry.REGISTRY.counter(name)
    for name in _PREDECLARED_HISTOGRAMS:
        telemetry.REGISTRY.histogram(name)


def _retry_header(seconds: float) -> Dict[str, str]:
    """Retry-After as RFC 7231 delay-seconds: a whole number, at least 1."""
    return {"Retry-After": str(max(int(-(-seconds // 1)), 1))}


def slo_values(observed) -> Dict:
    """The SLO monitor's snapshot: the registry (histograms expand, so
    ``serve_latency_ms.p99`` resolves) merged with ``observed``'s (an
    engine's or fleet's) stats, plus the reference's aliases so one spec
    (the built-in ``smoke``) resolves here as on a trace report:
    ``compiles.after_warmup``, ``compiles.total``,
    ``serve.request_ms_p99`` (the submit-to-complete p99) and
    ``telemetry_drops``."""
    values = dict(telemetry.REGISTRY.snapshot())
    snap = observed.snapshot()
    values.update(snap)
    caw = observed.compiles_after_warmup
    if caw is not None:
        values["compiles_after_warmup"] = caw
    values["serve_compiles"] = snap.get("compiles", 0)
    values["compiles"] = {"after_warmup": caw,
                          "total": snap.get("compiles", 0)}
    values["serve"] = {"request_ms_p99": values.get("latency_p99_ms", 0.0)}
    values["telemetry_drops"] = telemetry.drop_count()
    return values


class _PumpThread(threading.Thread):
    """One replica's execution thread: pumps whatever is due, then sleeps
    until its batcher's next flush horizon; drains on stop. The observer
    (one a server) also samples memory, feeds ``slo_monitor`` with
    ``observed``'s state (the fleet's) and flushes the telemetry run, at
    most once a second."""

    def __init__(self, engine: ServeEngine,
                 slo_monitor: Optional[SLOMonitor] = None,
                 observed=None, observer: bool = True):
        super().__init__(name=(f"serve-pump-{engine.replica}"
                               if engine.replica else "serve-pump"),
                         daemon=True)
        self.engine = engine
        self.slo_monitor = slo_monitor
        self.observed = observed if observed is not None else engine
        self.observer = observer
        self._halt = threading.Event()
        self._last_observe = 0.0

    def stop(self) -> None:
        self._halt.set()

    def _observe(self) -> None:
        now = time.monotonic()
        if now - self._last_observe < _OBSERVE_INTERVAL_S:
            return
        self._last_observe = now
        if telemetry.enabled():
            SAMPLER.sample(self.engine.device)
        if self.slo_monitor is None:
            return
        for breach in self.slo_monitor.observe(slo_values(self.observed)):
            logger.warning("SLO breach: %(metric)s=%(value)s over "
                           "threshold %(threshold)s (burn %(burn_rate)s "
                           "of budget %(budget)s)", breach)

    def run(self) -> None:
        while not self._halt.is_set():
            try:
                self.engine.pump()
                if self.observer:
                    self._observe()
                    # Keeps events.jsonl current for live readers (a
                    # no-op without a run); inside the guard: a full disk
                    # costs the trace, never the serving.
                    telemetry.flush()
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

    def _send_text(self, code: int, body: str, content_type: str) -> None:
        data = body.encode()
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self) -> None:
        fleet = self.server.fleet
        if self.path == "/healthz":
            doc: Dict = {
                "status": "draining" if self.server.draining else "ok",
                "warm_buckets": fleet.n_warm,
                # Nonzero: the rings overflowed and the trace is missing
                # events.
                "telemetry_drops": telemetry.drop_count(),
            }
            if fleet.size > 1:
                # A replica mid-roll degrades the fleet (part of its
                # capacity is out) without taking it out of rotation.
                health = fleet.health()
                doc["fleet"] = health
                if doc["status"] == "ok":
                    if health["live"] == 0:
                        doc["status"] = "draining"
                    elif health["live"] < health["size"]:
                        doc["status"] = "degraded"
            monitor = self.server.slo_monitor
            if monitor is not None:
                slo = monitor.status()
                doc["slo"] = slo
                # A burning SLO degrades health; a drain outranks it.
                if not slo["ok"] and doc["status"] == "ok":
                    doc["status"] = "degraded"
            # Read now, whether or not telemetry is on: a card's server
            # always reports its bytes.
            mem = SAMPLER.sample(self.server.engine.device)
            if mem is not None:
                doc["device_bytes_in_use"] = mem["bytes_in_use"]
                doc["device_peak_bytes_in_use"] = mem["peak_bytes_in_use"]
            self._send_json(200 if doc["status"] == "ok" else 503, doc)
        elif self.path == "/metrics":
            accept = self.headers.get("Accept", "") or ""
            if "text/plain" in accept or "openmetrics" in accept:
                snap = fleet.snapshot()
                body = telemetry.REGISTRY.prometheus_text(
                    extra={f"serve_{k}": v for k, v in snap.items()})
                self._send_text(200, body, "text/plain; version=0.0.4")
            else:
                self._send_json(200, self.server.metrics())
        else:
            self._send_json(404, {"error": "not_found"})

    def _reject_draining(self) -> bool:
        """Lame duck: a new POST is shed with 503 and Retry-After (a retry
        lands on a live server), while requests admitted before the
        notice keep being answered. True when rejected."""
        if not self.server.draining:
            return False
        retry_s = self.server.drain_retry_after_s()
        self._send_json(503, {"error": "draining", "retry_after_s": retry_s},
                        headers=_retry_header(retry_s))
        return True

    def _request_trace(self) -> Tuple[str, bool]:
        """(trace id, continued): the client's from a valid traceparent
        header, else a fresh one; a malformed header is counted and
        ignored, never a failed request."""
        raw = self.headers.get(trace_context.TRACEPARENT_HEADER)
        if raw is not None:
            parsed = trace_context.parse_traceparent(raw)
            if parsed is not None:
                return parsed[0], True
            telemetry.REGISTRY.counter("trace_ctx_malformed_total").inc()
        return trace_context.new_trace_id(), False

    def do_POST(self) -> None:
        # Counted in flight BEFORE the draining check: the drain waiter
        # must never see (pending 0, in flight 0) while a handler sits
        # between its admission and its response. A 503 written after the
        # increment is an answer, not a drop.
        with self.server.track_inflight():
            if self._reject_draining():
                return
            self._do_post()

    def _do_post(self) -> None:
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
        trace_id, trace_continued = self._request_trace()
        submitted, results = [], []
        with telemetry.span("http.post", n_functions=len(functions),
                            trace_id=trace_id,
                            trace_continued=trace_continued) as hs:
            for fn in functions:
                entry: Dict = {}
                try:
                    lane = fn.get("lane")
                    req = fleet.submit(
                        fn["graph"] if lane != "gen" else fn.get("graph"),
                        code=fn.get("code"), deadline_ms=deadline_ms,
                        lane=lane, trace_id=trace_id,
                        trace_continued=trace_continued)
                    submitted.append((req, entry))
                except RejectedError as e:
                    entry.update(error="rejected",
                                 retry_after_s=e.retry_after_s)
                except OversizedError as e:
                    entry.update(error="oversized", detail=str(e))
                except BadRequestError as e:
                    entry.update(error="bad_request", detail=str(e))
                except KeyError as e:
                    entry.update(error="bad_request",
                                 detail=f"missing field {e}")
                except (TypeError, AttributeError) as e:
                    # A null or a string where a function object belongs:
                    # the inline-error contract covers malformed entries.
                    entry.update(error="bad_request", detail=str(e))
                results.append(entry)

            if not submitted and all(r.get("error") == "rejected"
                                     for r in results):
                retry = max(r["retry_after_s"] for r in results)
                hs.set(status=429)
                self._send_json(429, {"error": "rejected",
                                      "retry_after_s": retry},
                                headers=_retry_header(retry))
                return
            if not submitted and all(r.get("error") == "oversized"
                                     for r in results):
                hs.set(status=413)
                self._send_json(413, {"results": results})
                return
            # Block until the pump answers each admitted request;
            # generous, so a stuck pump surfaces as an error, not a hang.
            wait_s = ((deadline_ms or fleet.config.deadline_ms) / 1000.0) \
                * 10 + 30.0
            for req, entry in submitted:
                if req.event.wait(timeout=wait_s) and req.result is not None:
                    entry.update(req.result)
                else:
                    entry.update(error="timeout")
            status = 500 if all(r.get("error") == "internal"
                                for r in results) else 200
            hs.set(status=status,
                   rids=[req.rid for req, _ in submitted[:64]])
            self._send_json(status, {"results": results})


class ServeHTTPServer(ThreadingHTTPServer):
    """The threaded HTTP server over ``engine`` (a ``ServeEngine``, taken
    as a one-replica fleet, or a ``ServeFleet``) with one pump thread a
    replica (started by :meth:`start_pump`, stopped and drained by
    :meth:`shutdown`); the first pump observes for ``slo_monitor``."""

    daemon_threads = True
    # The listen backlog: socketserver's default of 5 drops the SYNs of a
    # burst of new connections beyond it, and each dropped client retries
    # a second later (16 clients on a 2-replica fleet: p99 over 1 s).
    request_queue_size = 128

    def __init__(self, address: Tuple[str, int], engine,
                 slo_monitor: Optional[SLOMonitor] = None):
        super().__init__(address, ServeHandler)
        self.fleet = (engine if isinstance(engine, ServeFleet)
                      else ServeFleet.from_engine(engine))
        self.slo_monitor = slo_monitor
        _predeclare_metrics()
        self.pump_threads = [
            _PumpThread(r.engine,
                        slo_monitor=slo_monitor if i == 0 else None,
                        observed=self.fleet if i == 0 else None,
                        observer=(i == 0))
            for i, r in enumerate(self.fleet.replicas)]
        self.pump_thread = self.pump_threads[0]
        # Lame duck: `draining` turns admission into 503s; `_inflight`
        # counts transport threads still writing the answer of an admitted
        # POST (the queue may be empty while a handler writes its body:
        # both must reach zero before shutdown).
        self.draining = False
        self.drain_notice = None
        self._inflight = 0
        self._inflight_lock = threading.Lock()

    @property
    def engine(self) -> ServeEngine:
        """The primary replica's engine."""
        return self.fleet.primary.engine

    def metrics(self) -> Dict:
        """The ``/metrics`` JSON body: the fleet's snapshot and every
        kernel's launches in this process (a client reads them before and
        after its traffic)."""
        from deepdfa_tpu_torch.ops import launch_counts

        return dict(self.fleet.snapshot(), kernel_launches=launch_counts())

    @contextlib.contextmanager
    def track_inflight(self):
        with self._inflight_lock:
            self._inflight += 1
        try:
            yield
        finally:
            with self._inflight_lock:
                self._inflight -= 1

    @property
    def inflight(self) -> int:
        with self._inflight_lock:
            return self._inflight

    def drain_retry_after_s(self) -> float:
        """The Retry-After hint while draining: the notice's remaining
        grace, at least one flush window and one second."""
        floor = (self.engine.config.flush_fraction
                 * self.engine.config.deadline_ms / 1000.0)
        notice = self.drain_notice
        if notice is None:
            return max(floor, 1.0)
        return max(notice.remaining(), floor, 1.0)

    def begin_drain(self, notice=None) -> None:
        """Enter lame duck: new POSTs answer 503, /healthz reads
        "draining", every replica's batcher flushes partial buckets at
        once."""
        self.drain_notice = notice
        self.draining = True
        self.fleet.enter_lame_duck()

    def await_drained(self, deadline_s: float,
                      beat: Optional[Callable[[], None]] = None,
                      poll_s: float = 0.01) -> bool:
        """Wait until every admitted request is answered AND written
        (fleet queue 0, no handler in flight) or the deadline passes;
        ``beat`` feeds the lifecycle watchdog while progress is made."""
        deadline = time.monotonic() + max(deadline_s, 0.0)
        last = (-1, -1)
        while time.monotonic() < deadline:
            state = (self.fleet.pending(), self.inflight)
            if state == (0, 0):
                return True
            if beat is not None and state != last:
                beat()
                last = state
            time.sleep(poll_s)
        return self.fleet.pending() == 0 and self.inflight == 0

    def start_pump(self) -> None:
        for t in self.pump_threads:
            t.start()

    def shutdown(self) -> None:  # type: ignore[override]
        for t in self.pump_threads:
            t.stop()
        super().shutdown()
        for t in self.pump_threads:
            t.join(timeout=10.0)


def serve_forever(engine, host: str = "127.0.0.1", port: int = 8080,
                  slo_monitor: Optional[SLOMonitor] = None,
                  port_file: Optional[str] = None):
    """Blocking entry: start the pumps and serve until a preemption notice
    (SIGTERM or SIGINT through the process lifecycle coordinator, or a
    simulated one). ``engine`` is a ``ServeEngine`` or a ``ServeFleet``
    (one pump thread a replica); warm it first. ``port_file`` gets the
    bound port after bind (how a client finds an ephemeral ``port=0``).

    On the notice the coordinator's monitor thread drains: admission
    503s with Retry-After, partial buckets flush at once, every admitted
    request is answered and written, the telemetry run is flushed, then
    the server stops and the pumps drain what is left. Returns the notice
    (None after a plain :meth:`~ServeHTTPServer.shutdown`), so the caller
    can exit with the preemption code."""
    from deepdfa_tpu_torch.resilience import lifecycle

    server = ServeHTTPServer((host, port), engine, slo_monitor=slo_monitor)
    coordinator = lifecycle.coordinator()
    participant_box: Dict[str, object] = {}

    def on_notice(notice) -> None:
        # Every phase beats the watchdog; a wedged flush trips it instead
        # of eating the grace window.
        participant = participant_box.get("p")
        beat = participant.beat if participant else (lambda: None)
        with telemetry.span("lifecycle.drain_serve"):
            server.begin_drain(notice)
            beat()
            budget = participant.deadline_s if participant else notice.grace_s
            drained = server.await_drained(
                min(budget, notice.remaining()), beat=beat)
            if not drained:
                logger.error("lame-duck drain overran its budget: pending=%d "
                             "inflight=%d", server.fleet.pending(),
                             server.inflight)
        if participant:
            participant.drained(ok=drained)
        telemetry.flush()
        server.shutdown()

    serving = False
    try:
        server.start_pump()
        if port_file:
            tmp = f"{port_file}.tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                f.write(str(server.server_address[1]))
            os.replace(tmp, port_file)
        logger.info("serving on %s:%d (%d replica(s), %d warm buckets)",
                    host, server.server_address[1], server.fleet.size,
                    server.fleet.n_warm)
        participant_box["p"] = coordinator.register("serve",
                                                    on_notice=on_notice)
        try:
            serving = True
            server.serve_forever()
        finally:
            coordinator.unregister(participant_box["p"])
    finally:
        if serving:
            server.shutdown()  # a no-op after the drain's: pumps stopped
        else:
            # shutdown() waits for a serve_forever that never ran.
            for pump in server.pump_threads:
                if pump.is_alive():
                    pump.stop()
                    pump.join(timeout=10.0)
        server.server_close()
    return coordinator.notice
