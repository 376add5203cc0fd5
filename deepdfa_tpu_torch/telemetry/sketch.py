"""Bounded deterministic request-shape sketches (port of
``deepdfa_tpu/telemetry/sketch.py``).

Serving pads every input up a bucket ladder, so the cost of a ladder is
decided by the raw pre-bucket shape distribution. A :class:`ShapeSketch`
records those raw sizes (node and edge counts per graph) into a fixed
log-spaced bin ladder:

  * values 1..8 get exact unit bins;
  * each octave ``[2^o, 2^(o+1))`` above splits into 8 linear
    sub-buckets (3 significant bits, <= 12.5% relative error), clamped
    at ``2^24``;

so a sketch is at most ~180 integer counters whatever the traffic.
Binning is integer arithmetic (``bit_length`` and shifts), the same in
every process, so merging two sketches is bin-wise addition: associative,
commutative and exact.

Quantiles are nearest-rank over the bins and return the bin's inclusive
upper edge: the "pad-to" value a bucket ladder needs to cover the bin,
the unit :func:`fit_ladder` and :func:`predicted_waste_pct` work in.

Series names are the fixed tuple :data:`SHAPE_SERIES` (never formatted
from request data), registered in the telemetry
:class:`~deepdfa_tpu_torch.telemetry.registry.Registry` and mirrored as
cumulative ``traffic.shape`` trace events on a power-of-two count
schedule plus a final flush, so ``events.jsonl`` alone holds every
distribution.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Mapping, Optional, Sequence

from deepdfa_tpu_torch.telemetry.registry import REGISTRY

# --------------------------------------------------------------------------
# Fixed bin ladder: exact unit bins 1..8, then 8 linear sub-buckets per
# pow2 octave. Integer-only arithmetic keeps indexing deterministic.

_SUB = 8                 # sub-buckets per octave (3 significant bits)
MAX_VALUE = 1 << 24      # clamp: far above every ladder top in the repo


def bucket_index(value: int) -> int:
    """Bin index for ``value`` (clamped to [1, MAX_VALUE])."""
    v = int(value)
    if v < 1:
        v = 1
    elif v > MAX_VALUE:
        v = MAX_VALUE
    if v <= _SUB:
        return v - 1
    o = v.bit_length() - 1           # octave, >= 3
    sub = (v - (1 << o)) >> (o - 3)  # 0..7 within the octave
    return _SUB * (o - 3) + sub + _SUB


def bucket_value(index: int) -> int:
    """Inclusive upper edge of bin ``index`` — the conservative
    "pad-to" representative every consumer (quantiles, predicted-waste
    math) uses for values landing in that bin."""
    i = int(index)
    if i < _SUB:
        return i + 1
    j = i - _SUB
    o = j // _SUB + 3
    sub = j % _SUB
    return min((1 << o) + ((sub + 1) << (o - 3)) - 1, MAX_VALUE)


def merge_states(states: Iterable[Mapping]) -> Dict:
    """Exact merge of sketch states (bin-wise sum; associative and
    commutative by construction). States are ``ShapeSketch.state()``
    dicts or the attrs of ``traffic.shape`` events."""
    out: Dict = {"count": 0, "total": 0, "min": None, "max": None,
                 "bins": {}}
    for st in states:
        if not st or not st.get("count"):
            continue
        out["count"] += int(st["count"])
        out["total"] += int(st.get("total", 0))
        for key in ("min", "max"):
            v = st.get(key)
            if v is None:
                continue
            cur = out[key]
            better = (min if key == "min" else max)
            out[key] = int(v) if cur is None else better(cur, int(v))
        for idx, cnt in (st.get("bins") or {}).items():
            k = str(idx)
            out["bins"][k] = out["bins"].get(k, 0) + int(cnt)
    return out


def state_from_values(values: Iterable[int]) -> Dict:
    """Build a sketch state offline from exact values (distributions held
    per event, like per-flush request counts), so one quantile and ladder
    code path serves both."""
    st: Dict = {"count": 0, "total": 0, "min": None, "max": None,
                "bins": {}}
    for v in values:
        v = int(v)
        st["count"] += 1
        st["total"] += v
        st["min"] = v if st["min"] is None else min(st["min"], v)
        st["max"] = v if st["max"] is None else max(st["max"], v)
        k = str(bucket_index(v))
        st["bins"][k] = st["bins"].get(k, 0) + 1
    return st


def quantile_from_bins(bins: Mapping, q: float) -> Optional[int]:
    """Nearest-rank quantile over a ``{index: count}`` bin map,
    returned as the owning bin's inclusive upper edge."""
    items = sorted((int(i), int(c)) for i, c in bins.items() if int(c) > 0)
    total = sum(c for _, c in items)
    if not total:
        return None
    # Nearest rank = ceil(q * total), computed in exact integer millionths
    # so 0.9 * 10 can never float-drift past rank 9.
    q_millionths = int(round(float(q) * 1_000_000))
    rank = max(1, min(total, -(-(q_millionths * total) // 1_000_000)))
    seen = 0
    for idx, cnt in items:
        seen += cnt
        if seen >= rank:
            return bucket_value(idx)
    return bucket_value(items[-1][0])


def summarize_state(state: Mapping,
                    quantiles: Sequence[float] = (0.5, 0.9, 0.99)) -> Dict:
    """Report-facing summary of a (merged) sketch state."""
    count = int(state.get("count") or 0)
    out: Dict = {"count": count}
    if not count:
        return out
    total = int(state.get("total") or 0)
    out["mean"] = round(total / count, 2)
    out["min"] = state.get("min")
    out["max"] = state.get("max")
    bins = state.get("bins") or {}
    for q in quantiles:
        out[f"p{int(q * 100)}"] = quantile_from_bins(bins, q)
    return out


# --------------------------------------------------------------------------
# Ladder fitting and predicted-waste math.
# Everything operates in bin-edge space: values and rungs are both bin
# upper edges, so the arithmetic below is exact over the sketch.

def fit_ladder(state: Mapping,
               quantiles: Sequence[float] = (0.5, 0.75, 0.9, 0.95,
                                             0.99, 1.0)) -> List[int]:
    """Percentile-fitted bucket ladder: the deduped, sorted bin edges at
    ``quantiles`` (1.0 always included so the ladder covers the max)."""
    bins = state.get("bins") or {}
    qs = sorted(set(float(q) for q in quantiles) | {1.0})
    rungs = sorted({v for v in (quantile_from_bins(bins, q) for q in qs)
                    if v is not None})
    return rungs


def predicted_waste_pct(state: Mapping, rungs: Sequence[int]) -> Optional[float]:
    """Predicted pad waste of a ladder over the sketched distribution:
    ``100 * (1 - sum(c*v) / sum(c*rung(v)))`` with v = bin upper edge and
    rung(v) = smallest rung >= v (values above the top rung clamp to it —
    callers ensure the ladder covers the observed max)."""
    ladder = sorted(int(r) for r in rungs)
    if not ladder:
        return None
    top = ladder[-1]
    used = 0
    padded = 0
    for idx, cnt in (state.get("bins") or {}).items():
        c = int(cnt)
        if c <= 0:
            continue
        v = min(bucket_value(int(idx)), top)
        rung = next((r for r in ladder if r >= v), top)
        used += c * v
        padded += c * rung
    if not padded:
        return None
    return round(100.0 * (1.0 - used / padded), 2)


# --------------------------------------------------------------------------
# The registry metric: a named sketch with bounded bins. ``Registry``
# constructs these via ``REGISTRY.sketch(name)`` (create-or-get, like
# counters/gauges/histograms).

class ShapeSketch:
    """Thread-safe bounded quantile sketch (a telemetry metric kind)."""

    kind = "sketch"

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._bins: Dict[int, int] = {}
        self._count = 0
        self._total = 0
        self._min: Optional[int] = None
        self._max: Optional[int] = None
        # Count at the last traffic.shape event emission: the flush hook
        # re-emits only when new samples landed since.
        self._emitted_count = 0

    def observe(self, value: int) -> int:
        v = int(value)
        idx = bucket_index(v)
        with self._lock:
            self._bins[idx] = self._bins.get(idx, 0) + 1
            self._count += 1
            self._total += v
            self._min = v if self._min is None else min(self._min, v)
            self._max = v if self._max is None else max(self._max, v)
            return self._count

    def state(self) -> Dict:
        """Cumulative mergeable state (the ``traffic.shape`` payload)."""
        with self._lock:
            return {
                "count": self._count,
                "total": self._total,
                "min": self._min,
                "max": self._max,
                "bins": {str(i): c for i, c in sorted(self._bins.items())},
            }

    def quantile(self, q: float) -> Optional[int]:
        with self._lock:
            bins = dict(self._bins)
        return quantile_from_bins(bins, q)

    def mark_emitted(self, count: int) -> None:
        with self._lock:
            self._emitted_count = max(self._emitted_count, int(count))

    def dirty(self) -> bool:
        with self._lock:
            return self._count > self._emitted_count

    def reset(self) -> None:
        with self._lock:
            self._bins.clear()
            self._count = 0
            self._total = 0
            self._min = None
            self._max = None
            self._emitted_count = 0

    @property
    def value(self) -> Dict:
        """Registry snapshot value (quantiles in pad-to bin edges)."""
        with self._lock:
            bins = dict(self._bins)
            count, total = self._count, self._total
            vmin, vmax = self._min, self._max
        out: Dict = {"count": count, "sum": total}
        if count:
            out.update({
                "min": vmin,
                "max": vmax,
                "p50": quantile_from_bins(bins, 0.5),
                "p90": quantile_from_bins(bins, 0.9),
                "p99": quantile_from_bins(bins, 0.99),
            })
        return out


# --------------------------------------------------------------------------
# Capture plane: every sketch name in the process is a member of THIS
# tuple, never formatted from runtime data; observed only while telemetry
# is enabled, so the disabled side is a true no-op.

SHAPE_SERIES = (
    "traffic_shape_serve_gnn_nodes",
    "traffic_shape_serve_gnn_edges",
    "traffic_shape_serve_combined_nodes",
    "traffic_shape_serve_combined_edges",
    "traffic_shape_serve_gen_src_tokens",
    "traffic_shape_train_nodes",
    "traffic_shape_train_edges",
    "traffic_shape_scan_source_bytes",
)

# Kill switch for the capture plane alone (telemetry stays on), to
# measure the sketches' cost apart from the rest of the trace. None = on.
_capture_on: Optional[bool] = None
_capture_lock = threading.Lock()

# Train-side pad accumulator: cumulative element counts, mirrored as
# traffic.pad events on the same pow2 + flush schedule.
_train_pad = {"batches": 0, "elems_used": 0, "elems_budget": 0}
_train_pad_emitted = 0


def set_capture(on: Optional[bool]) -> None:
    """Force the shape-capture plane on/off (None restores default)."""
    global _capture_on
    _capture_on = on


def capture_enabled() -> bool:
    from deepdfa_tpu_torch.telemetry import spans
    if not spans.enabled():
        return False
    return _capture_on is None or bool(_capture_on)


def _emit_shape(sk: ShapeSketch) -> None:
    from deepdfa_tpu_torch.telemetry import spans
    st = sk.state()
    spans.event("traffic.shape", series=sk.name, **st)
    sk.mark_emitted(st["count"])


def observe_shape(series: str, value: int) -> None:
    """Record one raw pre-bucket size into ``series``.

    Emits a cumulative ``traffic.shape`` trace event whenever the
    series' count reaches a power of two — O(log n) events per series —
    and the flush hook (:func:`flush_traffic`) emits the final state, so
    ``events.jsonl`` always ends with the complete distribution.
    """
    if series not in SHAPE_SERIES:
        raise ValueError(f"unknown traffic series {series!r} "
                         "(add it to telemetry.sketch.SHAPE_SERIES)")
    if not capture_enabled():
        return
    sk = REGISTRY.sketch(series)
    count = sk.observe(value)
    if count & (count - 1) == 0:
        _emit_shape(sk)


def observe_train_pad(elems_used: int, elems_budget: int) -> None:
    """Record one training batch's node-element fill against its padded
    budget."""
    if not capture_enabled():
        return
    global _train_pad_emitted
    with _capture_lock:
        _train_pad["batches"] += 1
        _train_pad["elems_used"] += int(elems_used)
        _train_pad["elems_budget"] += int(elems_budget)
        batches = _train_pad["batches"]
        snap = dict(_train_pad)
    REGISTRY.counter("traffic_train_elems_used_total").inc(int(elems_used))
    REGISTRY.counter("traffic_train_elems_budget_total").inc(
        int(elems_budget))
    if batches & (batches - 1) == 0:
        from deepdfa_tpu_torch.telemetry import spans
        spans.event("traffic.pad", scope="train", **snap)
        with _capture_lock:
            _train_pad_emitted = max(_train_pad_emitted, batches)


def flush_traffic() -> None:
    """Emit the final cumulative state of every dirty series — called
    from the telemetry flush/end-run path so the trace's last
    ``traffic.shape``/``traffic.pad`` events always hold the complete
    picture (a reader keys on the LAST event per process and series)."""
    global _train_pad_emitted
    if not capture_enabled():
        return
    for sk in REGISTRY.sketches():
        if sk.dirty():
            _emit_shape(sk)
    with _capture_lock:
        batches = _train_pad["batches"]
        snap = dict(_train_pad)
        dirty_pad = batches > _train_pad_emitted
        if dirty_pad:
            _train_pad_emitted = batches
    if dirty_pad:
        from deepdfa_tpu_torch.telemetry import spans
        spans.event("traffic.pad", scope="train", **snap)


def reset_traffic() -> None:
    """Zero the capture plane (new telemetry run / tests): sketches are
    per-run so a process serving several runs never leaks one run's
    distribution into the next run's trace."""
    global _train_pad_emitted
    for sk in REGISTRY.sketches():
        sk.reset()
    with _capture_lock:
        _train_pad.update(batches=0, elems_used=0, elems_budget=0)
        _train_pad_emitted = 0
