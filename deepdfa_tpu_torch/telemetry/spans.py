"""Run-scoped tracing spans over per-thread ring buffers (port of
``deepdfa_tpu/telemetry/spans.py``).

* **Nestable spans.** ``with span("serve.flush", n=n) as sp: ...``
  records one timed event into the current thread's ring buffer;
  appends take that thread's own lock (contended only while the
  exporter drains). Every span record carries its ``parent`` and
  ``depth``.
* **Fences.** CUDA runs asynchronously: a wall-clock delta around a
  launch measures the dispatch, not the execution. ``sp.fence(t)``
  records a CUDA event on the current stream of each CUDA tensor in
  ``t`` when it is called, and the span's exit waits on those events,
  so a fenced span splits into ``host_ms`` (up to the fence) and its
  whole duration (device-inclusive). The wait is on the tensor's own
  stream, never the whole card: replicas sharing a card do not wait on
  each other's work. A fence asked for while the stream is capturing a
  CUDA graph raises :class:`FenceError` (the event would break the
  capture). A CPU tensor's work is already done: its fence waits on
  nothing. The fence runs whether or not a run is active: it is timing
  semantics at the call site, and waiting changes no value. Where the
  caller's next step is a barrier of its own (a flush's host copy),
  ``sp.mark()`` ends ``host_ms`` there with no event to wait on.
* **Run scoping.** ``start_run(run_dir)`` / ``end_run()`` (or the
  ``run_scope`` context manager) bind the process to one
  ``<run_dir>/telemetry/`` sink. With no run active, or with
  ``DEEPDFA_TELEMETRY=0``, every hook is a cheap no-op and nothing is
  written anywhere.

The reference also forwards every backend compile into the run from a
``jax.monitoring`` listener. The port compiles nothing per shape: the
serving engine's CUDA graph captures are its programs, and each one is a
``serve.compile`` span of its own.

Drops are counted, never silent: a ring at capacity drops the new event
and bumps its drop counter, surfaced in ``/healthz`` and the run's final
``telemetry.flush`` event.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

ENV_VAR = "DEEPDFA_TELEMETRY"
RING_ENV_VAR = "DEEPDFA_TELEMETRY_RING"
DEFAULT_RING_CAPACITY = 65536
# Trace retention: the active shard seals into a segment at the rotate
# threshold, and sealed segments are dropped oldest-first past the
# retention budget, so a long-lived serve appends bounded bytes, with
# every rotation and drop counted in the registry.
ROTATE_ENV_VAR = "DEEPDFA_TRACE_ROTATE_BYTES"
RETAIN_ENV_VAR = "DEEPDFA_TRACE_RETAIN_BYTES"
DEFAULT_ROTATE_BYTES = 64 * 1024 * 1024
DEFAULT_RETAIN_BYTES = 512 * 1024 * 1024

_ENABLED: Optional[bool] = None  # tri-state: None = read the env lazily
# Guards writes to _ENABLED only: every thread reaches enabled() through
# event()/span(), and the lazy env read must not race set_enabled. The
# hot path still reads lock-free; only the None->value transition and the
# explicit override serialize.
_ENABLED_LOCK = threading.Lock()


def enabled() -> bool:
    """Master switch: ``DEEPDFA_TELEMETRY=0`` disables spans, events,
    runs, and exports entirely (fences at call sites still run — they
    are timing semantics, not telemetry)."""
    global _ENABLED
    if _ENABLED is None:
        with _ENABLED_LOCK:
            if _ENABLED is None:
                _ENABLED = os.environ.get(ENV_VAR, "1") != "0"
    return _ENABLED


def set_enabled(value: Optional[bool]) -> None:
    """Override the env switch (``None`` re-reads the env) — the
    bench A/B and test hook."""
    global _ENABLED
    with _ENABLED_LOCK:
        _ENABLED = value


# ---------------------------------------------------------------------------
# Per-thread ring buffers
# ---------------------------------------------------------------------------


class _Ring:
    """Bounded event buffer owned by one thread.

    ``append`` takes this ring's own lock — uncontended except while the
    exporter swaps the buffer out (the "lock-cheap" design: no global
    lock anywhere near the hot path)."""

    def __init__(self, tid: int, capacity: int):
        self.tid = tid
        self.capacity = capacity
        self.lock = threading.Lock()
        self.events: List[Dict[str, Any]] = []
        self.drops = 0

    def append(self, record: Dict[str, Any]) -> None:
        with self.lock:
            if len(self.events) >= self.capacity:
                self.drops += 1
                return
            self.events.append(record)

    def drain(self) -> List[Dict[str, Any]]:
        with self.lock:
            out, self.events = self.events, []
            return out


class _ThreadState(threading.local):
    def __init__(self):
        self.ring: Optional[_Ring] = None
        self.stack: List[str] = []  # open span names, outermost first


_TLS = _ThreadState()
_RINGS: List[_Ring] = []
_RINGS_LOCK = threading.Lock()
_REAPED_DROPS = 0  # drop counts carried over from reaped dead-thread rings


def _ring() -> _Ring:
    ring = _TLS.ring
    if ring is None:
        capacity = int(os.environ.get(RING_ENV_VAR, DEFAULT_RING_CAPACITY))
        ring = _Ring(threading.get_ident(), capacity)
        _TLS.ring = ring
        with _RINGS_LOCK:
            _RINGS.append(ring)
    return ring


def _reap_dead_rings() -> None:
    """Drop rings whose owner thread is gone (one HTTP handler thread per
    connection would otherwise leak a ring per request, and every flush/
    drop_count walk would grow with total requests served). Callers drain
    first; only the drop counter survives, folded into the global."""
    global _REAPED_DROPS
    live = {t.ident for t in threading.enumerate()}
    with _RINGS_LOCK:
        kept = []
        for ring in _RINGS:
            if ring.tid in live:
                kept.append(ring)
            else:
                _REAPED_DROPS += ring.drops
        _RINGS[:] = kept


def drop_count() -> int:
    """Events dropped by full rings, process-wide (the /healthz field)."""
    with _RINGS_LOCK:
        rings = list(_RINGS)
        reaped = _REAPED_DROPS
    return reaped + sum(r.drops for r in rings)


# ---------------------------------------------------------------------------
# The active run
# ---------------------------------------------------------------------------


class TelemetryRun:
    """One process's sink into a run: ``<run_dir>/telemetry/``.

    The PRIMARY process (the one that opened the run) writes
    ``events.jsonl`` and owns the merged ``trace.json`` view; a process
    with an *inherited* context (``DEEPDFA_TRACE_CONTEXT`` from its
    parent, or a post-``fork`` rebind) writes its own
    ``events-<process>-<pid>.jsonl`` shard into the SAME run dir, on the
    SAME clock (``t0`` is inherited; ``perf_counter`` is system-wide
    CLOCK_MONOTONIC on Linux, so timestamps merge into one timeline).

    Every shard file opens with a ``kind: "meta"`` record carrying the
    emitter's pid/process name — the Chrome view stamps the *emitter's*
    pid on every event, never the reader's. ``flush()`` drains every
    thread's ring and appends (a single writer per shard under one
    lock); at the rotate threshold the active file seals into a
    ``.seg-NNNNNN.jsonl`` segment and sealed segments beyond the
    retention budget are dropped oldest-first, all counted. ``close()``
    flushes, emits the final summary event, and (primary only)
    regenerates the merged Chrome-trace view from every shard present.
    """

    def __init__(self, run_dir: str, process: str = "main", inherit=None):
        self.run_dir = run_dir
        self.process = process
        self.pid = os.getpid()
        self.inherited = inherit is not None
        self.dir = os.path.join(run_dir, "telemetry")
        os.makedirs(self.dir, exist_ok=True)
        self.trace_path = os.path.join(self.dir, "trace.json")
        if inherit is None:
            self.run_id = (f"{os.path.basename(os.path.abspath(run_dir)) or 'run'}"
                           f"-{os.urandom(4).hex()}")
            self.t0 = time.perf_counter()
            self.wall_start = time.time()
            shard = "events.jsonl"
        else:
            # One timeline: the child stamps ts relative to the PARENT's
            # t0 (shared monotonic clock), under the parent's run id.
            self.run_id = inherit.run_id
            self.t0 = float(inherit.t0)
            self.wall_start = float(inherit.wall_start)
            from deepdfa_tpu_torch.telemetry.context import sanitize_process

            shard = f"events-{sanitize_process(process)}-{self.pid}.jsonl"
        self.events_path = os.path.join(self.dir, shard)
        self.rotate_bytes = int(os.environ.get(ROTATE_ENV_VAR,
                                               DEFAULT_ROTATE_BYTES))
        self.retain_bytes = int(os.environ.get(RETAIN_ENV_VAR,
                                               DEFAULT_RETAIN_BYTES))
        self.rotations = 0
        self.segments_dropped = 0
        self.segment_bytes_dropped = 0
        self._seg_seq = 0
        self.drops0 = drop_count()  # ring drops are process-lifetime;
        # the run reports its own delta
        self.n_written = 0
        self._write_lock = threading.Lock()
        if inherit is None:
            # Fresh files per run: a resumed run dir must not interleave
            # two runs' clocks, a previous run's shards/segments must not
            # pose as this run's processes, and a stale trace.json must
            # not pose as a view of the new run (regenerated at close()).
            for name in os.listdir(self.dir):
                if name.startswith("events") and name.endswith(".jsonl"):
                    try:
                        os.remove(os.path.join(self.dir, name))
                    except OSError:
                        pass
            if os.path.exists(self.trace_path):
                os.remove(self.trace_path)
            with open(self.events_path, "w") as f:
                self._write_meta(f)
        else:
            # A shard never truncates: the parent's files are live, and a
            # pid-reusing sibling's history is worth more than a clean
            # slate. Each (re)open appends a fresh meta record.
            with open(self.events_path, "a") as f:
                self._write_meta(f)

    def now(self) -> float:
        return time.perf_counter() - self.t0

    def _write_meta(self, f) -> None:
        """The shard header: who is writing this file. Readers annotate
        every subsequent record with this pid/process, so the Chrome
        view carries the emitter's identity, not the reader's."""
        f.write(json.dumps({
            "kind": "meta", "name": "telemetry.shard", "ts": self.now(),
            "pid": self.pid, "process": self.process,
            "run_id": self.run_id, "wall_start": self.wall_start,
        }) + "\n")

    def flush(self) -> int:
        """Drain all rings into this process's shard; returns events
        written. Rotation happens here, under the same write lock."""
        with _RINGS_LOCK:
            rings = list(_RINGS)
        batch: List[Dict[str, Any]] = []
        for ring in rings:
            batch.extend(ring.drain())
        _reap_dead_rings()
        if not batch:
            return 0
        batch.sort(key=lambda r: r.get("ts", 0.0))
        with self._write_lock:
            with open(self.events_path, "a") as f:
                for rec in batch:
                    f.write(json.dumps(rec) + "\n")
                size = f.tell()
            self.n_written += len(batch)
            if self.rotate_bytes > 0 and size >= self.rotate_bytes:
                self._rotate_locked(size)
        return len(batch)

    def _rotate_locked(self, size: int) -> None:
        """Seal the active file into a segment and enforce the retention
        budget over this shard's sealed segments (oldest-first drops,
        all accounted — a long-run trace loses its oldest history, never
        its accounting)."""
        from deepdfa_tpu_torch.telemetry.registry import REGISTRY

        self._seg_seq += 1
        stem = self.events_path[:-len(".jsonl")]
        seg = f"{stem}.seg-{self._seg_seq:06d}.jsonl"
        os.replace(self.events_path, seg)
        self.rotations += 1
        REGISTRY.counter("telemetry_rotations_total").inc()
        with open(self.events_path, "w") as f:
            self._write_meta(f)
        prefix = os.path.basename(stem) + ".seg-"
        segments = sorted(
            name for name in os.listdir(self.dir)
            if name.startswith(prefix) and name.endswith(".jsonl")
        )
        sizes = {}
        for name in segments:
            try:
                sizes[name] = os.path.getsize(os.path.join(self.dir, name))
            except OSError:
                sizes[name] = 0
        total = sum(sizes.values())
        dropped = 0
        while segments and total > self.retain_bytes and len(segments) > 1:
            victim = segments.pop(0)
            try:
                os.remove(os.path.join(self.dir, victim))
            except OSError:
                break
            total -= sizes[victim]
            dropped += 1
            self.segments_dropped += 1
            self.segment_bytes_dropped += sizes[victim]
            REGISTRY.counter(
                "telemetry_retention_dropped_segments_total").inc()
            REGISTRY.counter(
                "telemetry_retention_dropped_bytes_total").inc(
                    sizes[victim])
        # Queued into the ring: lands in the fresh active file on the
        # next flush — the rotation is auditable from the trace itself.
        event("telemetry.rotate", segment=os.path.basename(seg),
              bytes=size, process=self.process,
              dropped_segments=dropped)

    def close(self) -> None:
        # Final traffic.shape/traffic.pad emission BEFORE the summary
        # event: the run's last events must carry each series' complete
        # distribution (the offline report keys on last-per-process).
        from deepdfa_tpu_torch.telemetry import sketch as _sketch

        _sketch.flush_traffic()
        event("telemetry.flush", drops=drop_count() - self.drops0,
              events=self.n_written, process=self.process,
              rotations=self.rotations,
              segments_dropped=self.segments_dropped)
        self.flush()
        if not self.inherited:
            # The merged Perfetto view over every shard present at close
            # (children that already exited included). A shard-writing
            # child never writes trace.json — the primary owns the view.
            from deepdfa_tpu_torch.telemetry.export import write_merged_trace

            write_merged_trace(self.run_dir, wall_start=self.wall_start)


_RUN: Optional[TelemetryRun] = None


def current_run() -> Optional[TelemetryRun]:
    return _RUN


def start_run(run_dir: str) -> Optional[TelemetryRun]:
    """Bind the process to one run sink. No-op (returns None) when
    telemetry is disabled; nested runs are an error — end the previous
    one first (``run_scope`` does).

    When the process was spawned with a ``DEEPDFA_TRACE_CONTEXT`` env
    payload, the inherited context WINS over ``run_dir``: the
    child binds to the parent's run directory and writes its own
    ``events-<process>-<pid>.jsonl`` shard on the parent's clock, so one
    merged timeline covers both processes. Without the env var, behavior
    is unchanged — the caller's run_dir, the primary ``events.jsonl``.
    """
    global _RUN
    if not enabled():
        return None
    if _RUN is not None:
        raise RuntimeError(
            f"telemetry run already active ({_RUN.run_dir}); end it first"
        )
    from deepdfa_tpu_torch.telemetry import context as _context

    ctx = _context.inherited()
    if ctx is not None:
        _RUN = TelemetryRun(ctx.run_dir, process=ctx.process, inherit=ctx)
    else:
        _RUN = TelemetryRun(run_dir)
    # Traffic sketches are per-run: a process serving several runs must
    # not leak one run's shape distribution into the next run's trace.
    from deepdfa_tpu_torch.telemetry import sketch as _sketch

    _sketch.reset_traffic()
    event("telemetry.start", run_dir=_RUN.run_dir,
          process=_RUN.process,
          **({"requested_run_dir": run_dir} if ctx is not None else {}))
    return _RUN


def rebind_forked(process: str) -> Optional[TelemetryRun]:
    """Post-``fork`` shard rebind: the forked child inherited the
    parent's run object and ring *copies* by memory; writing either from
    the child would duplicate the parent's events or tear its file. This
    discards the copied rings and binds the child to its own shard of
    the same run (same run id, same clock). No-op when no run is active,
    telemetry is disabled, or the caller is not actually a fork (same
    pid)."""
    global _RUN, _REAPED_DROPS
    run = _RUN
    if run is None or not enabled():
        return None
    if run.pid == os.getpid():
        return run
    with _RINGS_LOCK:
        _RINGS.clear()
    _REAPED_DROPS = 0
    _TLS.ring = None
    _RUN = TelemetryRun(run.run_dir, process=process, inherit=run)
    # The fork copied the parent's sketch states by memory; re-emitting
    # them from this child's shard would double-count the parent's
    # samples in the merged report. Start the child's traffic ledger
    # from zero.
    from deepdfa_tpu_torch.telemetry import sketch as _sketch

    _sketch.reset_traffic()
    event("telemetry.start", run_dir=run.run_dir, process=process,
          forked=True)
    return _RUN


def in_child_shard() -> bool:
    """True when this process writes a shard of an inherited run — the
    hook per-item flush policies key on (a forked ETL worker must make
    its events durable before it can be killed)."""
    run = _RUN
    return run is not None and run.inherited


def end_run() -> None:
    global _RUN
    run = _RUN
    if run is None:
        return
    try:
        # close() emits the final summary event, so the run must still be
        # current while it runs.
        run.close()
    finally:
        _RUN = None


@contextlib.contextmanager
def run_scope(run_dir: str):
    """``with run_scope(run_dir): ...`` — the command-level entry."""
    run = start_run(run_dir)
    try:
        yield run
    finally:
        if run is not None:
            end_run()


def flush() -> int:
    """Drain rings into the active run's events.jsonl (0 when none).

    Emits any dirty traffic sketches first, so an explicit flush always
    leaves the shape distributions on disk current."""
    run = _RUN
    if run is None:
        return 0
    from deepdfa_tpu_torch.telemetry import sketch as _sketch

    _sketch.flush_traffic()
    return run.flush()


# ---------------------------------------------------------------------------
# Spans and events
# ---------------------------------------------------------------------------


class FenceError(RuntimeError):
    """A fence asked for while a CUDA stream is capturing a graph."""


def _cuda_tensors(value: Any) -> List[Any]:
    """The CUDA tensors in ``value``: a tensor, or lists, tuples and dicts
    of them, nested."""
    out: List[Any] = []
    todo = [value]
    while todo:
        v = todo.pop()
        if isinstance(v, (list, tuple)):
            todo.extend(v)
        elif isinstance(v, dict):
            todo.extend(v.values())
        elif getattr(v, "is_cuda", False):
            out.append(v)
    return out


def fence_events(value: Any) -> List[Any]:
    """One CUDA event recorded now on the current stream of each card
    that holds a CUDA tensor of ``value`` (none for CPU tensors). Raises
    :class:`FenceError` when that stream is capturing a CUDA graph."""
    tensors = _cuda_tensors(value)
    if not tensors:
        return []
    import torch

    events = []
    for device in dict.fromkeys(t.device for t in tensors):
        with torch.cuda.device(device):
            if torch.cuda.is_current_stream_capturing():
                raise FenceError(
                    f"fence on {device} while its stream is capturing a "
                    "CUDA graph: fence after capture_end")
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(device))
        events.append(ev)
    return events


class Span:
    """One timed region. Always measures (two perf_counter reads — the
    call-site contract that ``dur_s`` is usable even when no run is
    active); emits only into an active run."""

    __slots__ = ("name", "attrs", "_t0", "_t_fence", "_events", "dur_s",
                 "host_s")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name = name
        self.attrs = attrs
        self._t0 = 0.0
        self._t_fence: Optional[float] = None
        self._events: List[Any] = []
        self.dur_s = 0.0   # total duration (device-inclusive when fenced)
        self.host_s: Optional[float] = None  # up to the fence, fenced spans

    def fence(self, value: Any) -> None:
        """Mark the dispatch boundary at ``value``: a CUDA event on the
        current stream of each of its CUDA tensors' cards now (raises
        :class:`FenceError` during a capture), waited on at span exit, so
        the span splits into host_ms (up to here) and dur_ms (through the
        device work queued before it)."""
        self._events = fence_events(value)
        self._t_fence = time.perf_counter()

    def mark(self) -> None:
        """Mark the dispatch boundary where the caller's next step is
        itself the barrier (a host copy of the result): a fence with no
        device event, so ``host_ms`` ends here and ``dur_ms`` at exit."""
        self._t_fence = time.perf_counter()

    def set(self, **attrs: Any) -> None:
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        _TLS.stack.append(self.name)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._t_fence is not None:
            for ev in self._events:
                ev.synchronize()
            self._events = []
            self.host_s = self._t_fence - self._t0
        self.dur_s = time.perf_counter() - self._t0
        stack = _TLS.stack
        if stack and stack[-1] == self.name:
            stack.pop()
        run = _RUN
        if run is not None:
            rec: Dict[str, Any] = {
                "kind": "span",
                "name": self.name,
                "ts": self._t0 - run.t0,
                "dur_ms": self.dur_s * 1e3,
                "tid": threading.get_ident(),
                "depth": len(stack),
            }
            if stack:
                rec["parent"] = stack[-1]
            if self.host_s is not None:
                rec["host_ms"] = self.host_s * 1e3
                rec["fenced"] = True
            if exc_type is not None:
                rec["error"] = exc_type.__name__
            if self.attrs:
                rec["attrs"] = self.attrs
            _ring().append(rec)
        return False


class _NullSpan:
    """The disabled-path span: every method a no-op, ``dur_s`` stays 0
    (disabled means *disabled* — not even the clock is read)."""

    __slots__ = ()
    dur_s = 0.0
    host_s: Optional[float] = None

    def fence(self, value: Any) -> None:
        pass

    def mark(self) -> None:
        pass

    def set(self, **attrs: Any) -> None:
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


_NULL_SPAN = _NullSpan()


def span(name: str, /, **attrs: Any):
    """``with span("train.step", step=n) as sp:`` — nestable timed
    region. Cheap no-op object when telemetry is disabled."""
    if not enabled():
        return _NULL_SPAN
    return Span(name, attrs)


def record_span(name: str, start_s: float, end_s: Optional[float] = None,
                **attrs: Any) -> None:
    """Retroactive span from explicit perf_counter timestamps — for
    regions whose start and end live on different threads (a serving
    request's submit -> finish)."""
    run = _RUN
    if run is None or not enabled():
        return
    end_s = time.perf_counter() if end_s is None else end_s
    rec: Dict[str, Any] = {
        "kind": "span",
        "name": name,
        "ts": start_s - run.t0,
        "dur_ms": (end_s - start_s) * 1e3,
        "tid": threading.get_ident(),
        "depth": 0,
    }
    if attrs:
        rec["attrs"] = attrs
    _ring().append(rec)


def event(name: str, /, **attrs: Any) -> None:
    """Instant event into the active run (no-op without one). The event
    name is positional-only so an attr may itself be called ``name``
    (the cost-model and memory events carry the kernel's)."""
    run = _RUN
    if run is None or not enabled():
        return
    rec: Dict[str, Any] = {
        "kind": "event",
        "name": name,
        "ts": run.now(),
        "tid": threading.get_ident(),
    }
    if attrs:
        rec["attrs"] = attrs
    _ring().append(rec)


def now() -> float:
    """THE telemetry clock (perf_counter seconds) — call sites that
    stamp retroactive spans must use this, not their own clock."""
    return time.perf_counter()
