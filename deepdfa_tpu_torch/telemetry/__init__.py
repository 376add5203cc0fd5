"""Telemetry: run-scoped spans, one metrics registry, exporters (port of
``deepdfa_tpu/telemetry``).

* :mod:`~deepdfa_tpu_torch.telemetry.spans` — nestable ``span()``
  context managers over per-thread ring buffers, fenced on CUDA events
  for honest host/device attribution, and instant ``event()`` records,
  written per run into ``<run_dir>/telemetry/events.jsonl`` with shard
  rotation and retention.
* :mod:`~deepdfa_tpu_torch.telemetry.registry` — the one counter, gauge
  and histogram registry ``ServingStats`` and ``IngestStats`` publish
  into, with a Prometheus text exposition.
* :mod:`~deepdfa_tpu_torch.telemetry.sketch` — bounded request-shape
  sketches and the bucket-ladder math over them.
* :mod:`~deepdfa_tpu_torch.telemetry.context` — cross-process trace
  context (``DEEPDFA_TRACE_CONTEXT``) and the ``traceparent`` header.
* :mod:`~deepdfa_tpu_torch.telemetry.export` — the Chrome trace view
  (``trace.json``, loadable in Perfetto) of a run's shards.
* :mod:`~deepdfa_tpu_torch.telemetry.slo` — declarative SLO specs
  evaluated as burn rates over registry snapshots (the live serve
  monitor behind ``/healthz``'s ``slo``).
* :mod:`~deepdfa_tpu_torch.telemetry.memory` — the live device memory
  sampler.

The event names, attributes, series names and file formats are the
reference's, so one reader takes either package's run. The reference's
offline report (``report.py``), its XLA cost model (``costmodel.py``)
and compiled-memory accounting have no counterpart yet.

``DEEPDFA_TELEMETRY=0`` disables everything; with no run active every
hook is a cheap no-op, so the instrumentation lives on the serving path.
"""

from deepdfa_tpu_torch.telemetry import context, sketch
from deepdfa_tpu_torch.telemetry.registry import REGISTRY, Registry, sanitize
from deepdfa_tpu_torch.telemetry.sketch import (
    SHAPE_SERIES,
    ShapeSketch,
    observe_shape,
    observe_train_pad,
)
from deepdfa_tpu_torch.telemetry.spans import (
    ENV_VAR,
    FenceError,
    Span,
    TelemetryRun,
    current_run,
    drop_count,
    enabled,
    end_run,
    event,
    flush,
    in_child_shard,
    now,
    rebind_forked,
    record_span,
    run_scope,
    set_enabled,
    span,
    start_run,
)

__all__ = [
    "ENV_VAR",
    "FenceError",
    "REGISTRY",
    "Registry",
    "SHAPE_SERIES",
    "ShapeSketch",
    "Span",
    "TelemetryRun",
    "context",
    "current_run",
    "drop_count",
    "enabled",
    "end_run",
    "event",
    "flush",
    "in_child_shard",
    "now",
    "observe_shape",
    "observe_train_pad",
    "rebind_forked",
    "record_span",
    "run_scope",
    "sanitize",
    "set_enabled",
    "sketch",
    "span",
    "start_run",
]
