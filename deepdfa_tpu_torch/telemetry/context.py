"""Cross-process trace context: one run, many processes, one timeline
(port of ``deepdfa_tpu/telemetry/context.py``).

* :class:`TraceContext` — what a parent hands a child: the run directory
  and run id, the child's process name, the parent's clock origin
  (``t0``/``wall_start``: ``time.perf_counter`` is CLOCK_MONOTONIC on
  Linux, shared across processes, so both stamp events on one
  run-relative timeline), and optionally a trace id and parent span id.
* **Env propagation** — :func:`child_env` serializes the active run's
  context into ``DEEPDFA_TRACE_CONTEXT`` for an exec'd child;
  ``spans.start_run`` in the child sees :func:`inherited` and binds to
  the parent's run dir, writing its own ``events-<process>-<pid>.jsonl``
  shard.
* **Fork propagation** — :func:`init_forked_worker` rebinds a
  fork-inherited run to the worker's own shard.
* **HTTP propagation** — a W3C ``traceparent``-style header
  (``00-<trace32>-<span16>-01``): :func:`make_traceparent` on the client,
  :func:`parse_traceparent` on the server (a malformed value is ignored
  with a ``trace_ctx_malformed_total`` bump, never a 500), and the
  ``serve.request`` span carries the client's trace id.

The env var, the header and the JSON payload are the reference's: a
child of either package reads a context the other encoded. A malformed
env payload is counted and ignored: a broken parent never crashes a
child at import time.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import re
from typing import Dict, Mapping, Optional, Tuple

from deepdfa_tpu_torch.telemetry.registry import REGISTRY

logger = logging.getLogger(__name__)

ENV_VAR = "DEEPDFA_TRACE_CONTEXT"
# Lowercase per RFC 9110 header-name case-insensitivity; the stdlib
# server's self.headers.get() is case-insensitive anyway.
TRACEPARENT_HEADER = "traceparent"

_TRACEPARENT_RE = re.compile(
    r"^00-([0-9a-f]{32})-([0-9a-f]{16})-[0-9a-f]{2}$")
_PROCESS_SAFE = re.compile(r"[^A-Za-z0-9_-]")


def sanitize_process(name: str) -> str:
    """Process name -> shard-filename-safe fragment (no dots: segment
    suffixes are dot-delimited)."""
    out = _PROCESS_SAFE.sub("_", str(name) or "proc")
    return out or "proc"


def new_trace_id() -> str:
    """128-bit hex trace id (the traceparent trace-id field)."""
    return os.urandom(16).hex()


def new_span_id() -> str:
    """64-bit hex span id (the traceparent parent-id field)."""
    return os.urandom(8).hex()


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """What a child inherits: where the run lives, who the child is, and
    the parent's clock origin."""

    run_dir: str
    run_id: str
    process: str
    t0: float           # parent's perf_counter at run start (shared clock)
    wall_start: float
    parent_process: str = "main"
    trace_id: Optional[str] = None
    parent_span: Optional[str] = None

    def encode(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def decode(cls, payload: str) -> "TraceContext":
        """Parse an env payload; raises ValueError on anything malformed
        (callers count-and-ignore — see :func:`inherited`)."""
        try:
            doc = json.loads(payload)
        except Exception as e:
            raise ValueError(f"unparseable trace context: {e}") from e
        if not isinstance(doc, dict):
            raise ValueError("trace context payload must be an object")
        try:
            return cls(
                run_dir=str(doc["run_dir"]),
                run_id=str(doc["run_id"]),
                process=sanitize_process(str(doc["process"])),
                t0=float(doc["t0"]),
                wall_start=float(doc["wall_start"]),
                parent_process=str(doc.get("parent_process", "main")),
                trace_id=(str(doc["trace_id"])
                          if doc.get("trace_id") else None),
                parent_span=(str(doc["parent_span"])
                             if doc.get("parent_span") else None),
            )
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(f"incomplete trace context: {e}") from e


# Cached once per process: the payload is set by the spawning parent and
# never changes underneath a running child.
_INHERITED_READ = False
_INHERITED: Optional[TraceContext] = None


def inherited() -> Optional[TraceContext]:
    """The context this process was spawned with (``DEEPDFA_TRACE_CONTEXT``),
    or None. A malformed payload is ignored with a counter bump — a
    broken parent must never crash the child."""
    global _INHERITED_READ, _INHERITED
    if not _INHERITED_READ:
        _INHERITED_READ = True
        payload = os.environ.get(ENV_VAR)
        if payload:
            try:
                _INHERITED = TraceContext.decode(payload)
            except ValueError:
                REGISTRY.counter("trace_ctx_malformed_total").inc()
                logger.warning("ignoring malformed %s", ENV_VAR,
                               exc_info=True)
    return _INHERITED


def reset_inherited() -> None:
    """Re-read the env on next :func:`inherited` — test isolation only."""
    global _INHERITED_READ, _INHERITED
    _INHERITED_READ = False
    _INHERITED = None


def child_env(process: str,
              base: Optional[Mapping[str, str]] = None,
              **extra: str) -> Dict[str, str]:
    """A subprocess env that joins the active run's trace plane.

    Returns a full env mapping (a copy of ``base``, default
    ``os.environ``) with ``DEEPDFA_TRACE_CONTEXT`` carrying the active
    run's context under the child's ``process`` name. With no
    active run (or telemetry disabled) the var is *removed*: a stale
    payload from this process's own parent must not leak a wrong process
    name into the grandchild.
    """
    from deepdfa_tpu_torch.telemetry import spans

    env = dict(os.environ if base is None else base)
    env.update(extra)
    run = spans.current_run()
    if run is not None and spans.enabled():
        ctx = TraceContext(
            run_dir=os.path.abspath(run.run_dir),
            run_id=run.run_id,
            process=sanitize_process(process),
            t0=run.t0,
            wall_start=run.wall_start,
            parent_process=run.process,
        )
        env[ENV_VAR] = ctx.encode()
    else:
        env.pop(ENV_VAR, None)
    return env


def init_forked_worker(process: str = "forked") -> None:
    """``ProcessPoolExecutor(initializer=...)`` hook: rebind a
    fork-inherited telemetry run to THIS process's own shard, discarding
    the parent's copied ring contents (the parent is their durable
    writer). A no-op without an active run."""
    from deepdfa_tpu_torch.telemetry import spans

    spans.rebind_forked(sanitize_process(process))


def make_traceparent(trace_id: Optional[str] = None,
                     span_id: Optional[str] = None) -> str:
    """The propagation header value for one outbound request."""
    return f"00-{trace_id or new_trace_id()}-{span_id or new_span_id()}-01"


def parse_traceparent(value: Optional[str]
                      ) -> Optional[Tuple[str, str]]:
    """``(trace_id, parent_span_id)`` from a traceparent header, or None
    when absent/malformed (all-zero ids are malformed per the W3C spec)."""
    if not isinstance(value, str):
        return None
    m = _TRACEPARENT_RE.match(value.strip().lower())
    if m is None:
        return None
    trace_id, span_id = m.group(1), m.group(2)
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return trace_id, span_id
