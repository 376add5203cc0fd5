"""Classification, serving and ingest metrics (port of ``BinaryStats``,
``binary_stats``, ``compute_metrics``, ``ServingStats``,
``latency_quantile`` and ``IngestStats`` from
``deepdfa_tpu/core/metrics.py``).

Confusion counts are summable tensors, so a training epoch folds them on
the device and reads them once. Serving keeps host-side counters, a
rolling latency window and per-(lane, bucket) padding cells, each bump
mirrored into the process registry (``telemetry.REGISTRY``) under the
reference's series names; ingest counters are mirrored there too.
"""

from __future__ import annotations

import threading
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from deepdfa_tpu_torch.telemetry.registry import REGISTRY, sanitize


class BinaryStats(NamedTuple):
    """Sufficient statistics for binary classification metrics (f32
    scalar tensors), summable across batches."""

    tp: torch.Tensor
    fp: torch.Tensor
    tn: torch.Tensor
    fn: torch.Tensor

    def __add__(self, other: "BinaryStats") -> "BinaryStats":  # type: ignore[override]
        return BinaryStats(self.tp + other.tp, self.fp + other.fp,
                           self.tn + other.tn, self.fn + other.fn)

    @staticmethod
    def zeros(device=None) -> "BinaryStats":
        z = torch.zeros((), dtype=torch.float32, device=device)
        return BinaryStats(z, z, z, z)


def binary_stats(probs: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor, threshold: float = 0.5) -> BinaryStats:
    """Confusion counts at ``threshold`` over masked entries."""
    pred = (probs >= threshold).float()
    lab = labels.float()
    m = mask.float()
    return BinaryStats(
        tp=torch.sum(m * pred * lab),
        fp=torch.sum(m * pred * (1.0 - lab)),
        tn=torch.sum(m * (1.0 - pred) * (1.0 - lab)),
        fn=torch.sum(m * (1.0 - pred) * lab),
    )


def compute_metrics(stats: BinaryStats) -> Dict[str, torch.Tensor]:
    """Accuracy / precision / recall / F1 from counts; an empty
    denominator gives 0."""
    tp, fp, tn, fn = stats.tp, stats.fp, stats.tn, stats.fn

    def _safe(n, d):
        return torch.where(d > 0, n / torch.where(d > 0, d, 1.0),
                           torch.zeros_like(d))

    acc = _safe(tp + tn, tp + fp + tn + fn)
    prec = _safe(tp, tp + fp)
    rec = _safe(tp, tp + fn)
    f1 = _safe(2 * prec * rec, prec + rec)
    return {"acc": acc, "precision": prec, "recall": rec, "f1": f1}


def latency_quantile(samples_ms, q: float) -> float:
    """Nearest-rank quantile over latency samples (ms); 0.0 when empty."""
    xs = np.sort(np.asarray(samples_ms, np.float64))
    if xs.size == 0:
        return 0.0
    rank = min(int(np.ceil(q * xs.size)) - 1, xs.size - 1)
    return float(xs[max(rank, 0)])


class ServingStats:
    """Thread-safe counters, latency ring and padding cells of one engine.

    ``compiles`` counts the engine's programs (one a CUDA graph capture),
    as the reference counts its compiles. Every bump also lands in the
    process registry: the fleet-wide ``serve_<counter>_total`` series
    and, for an engine with a ``replica`` id (one of the fixed
    ``REPLICA_IDS``), that replica's own ``serve_<rid>_*`` series.
    """

    COUNTERS = (
        "submitted", "completed", "rejected", "oversized", "cache_hits",
        "cache_misses", "degraded", "batches", "compiles", "failures",
    )

    def __init__(self, latency_window: int = 8192,
                 replica: Optional[str] = None):
        self._lock = threading.Lock()
        for name in self.COUNTERS:
            setattr(self, name, 0)
        self._replica = replica
        self.occupancy_used = 0
        self.occupancy_slots = 0
        self._padding: Dict[tuple, Dict[str, int]] = {}
        self._latency_window = latency_window
        self._latencies_ms = np.zeros(latency_window, np.float64)
        self._latency_count = 0

    def bump(self, counter: str, by: int = 1) -> None:
        if counter not in self.COUNTERS:
            raise ValueError(f"unknown serving counter {counter!r}")
        with self._lock:
            setattr(self, counter, getattr(self, counter) + by)
        REGISTRY.counter(f"serve_{counter}_total").inc(by)
        if self._replica is not None:
            REGISTRY.counter(
                f"serve_{self._replica}_{counter}_total").inc(by)

    def observe_latency(self, seconds: float) -> None:
        with self._lock:
            self._latencies_ms[
                self._latency_count % self._latency_window
            ] = seconds * 1000.0
            self._latency_count += 1
        REGISTRY.histogram("serve_latency_ms").observe(seconds * 1000.0)
        if self._replica is not None:
            REGISTRY.histogram(
                f"serve_{self._replica}_latency_ms").observe(
                    seconds * 1000.0)

    def record_batch(self, n_real: int, n_slots: int,
                     lane: Optional[str] = None,
                     elems_used: Optional[int] = None,
                     elems_per_slot: Optional[int] = None,
                     elems_budget: Optional[int] = None) -> None:
        """Fold one flushed micro-batch into the per-(lane, bucket) cells.

        The element axis splits the bucket's padded node budget into
        ``slot_underfill + inslot_pad + flush_overhead ==
        elems_budget - elems_used``, as in the reference.
        """
        elems = (elems_used is not None and elems_per_slot is not None
                 and elems_budget is not None)
        with self._lock:
            self.batches += 1
            self.occupancy_used += n_real
            self.occupancy_slots += n_slots
            if lane is not None:
                cell = self._padding.setdefault(
                    (lane, int(n_slots)),
                    {"used": 0, "slots": 0, "flushes": 0})
                cell["used"] += n_real
                cell["slots"] += n_slots
                cell["flushes"] += 1
                if elems:
                    per_slot = int(elems_per_slot)
                    for key, add in (
                        ("elems_used", int(elems_used)),
                        ("elems_budget", int(elems_budget)),
                        ("elems_slot_underfill",
                         (n_slots - n_real) * per_slot),
                        ("elems_inslot_pad",
                         n_real * per_slot - int(elems_used)),
                        ("elems_flush_overhead",
                         int(elems_budget) - n_slots * per_slot),
                    ):
                        cell[key] = cell.get(key, 0) + add
                    elem_waste = 100.0 * (
                        1.0 - cell["elems_used"] / cell["elems_budget"])
                waste_pct = 100.0 * (1.0 - cell["used"] / cell["slots"])
        if lane is not None:
            # Gauge names from the lane, the slot ladder and the fixed
            # replica id: never from request data.
            suffix = f"_{self._replica}" if self._replica else ""
            REGISTRY.gauge(
                f"serve_padding_waste_pct_{lane}_b{int(n_slots)}{suffix}"
            ).set(round(waste_pct, 4))
            if elems:
                REGISTRY.gauge(
                    f"serve_elem_waste_pct_{lane}_b{int(n_slots)}{suffix}"
                ).set(round(elem_waste, 4))
        REGISTRY.counter("serve_batches_total").inc()
        REGISTRY.counter("serve_slots_occupied_total").inc(n_real)
        REGISTRY.counter("serve_slots_padded_total").inc(n_slots - n_real)
        if elems:
            REGISTRY.counter("serve_elems_used_total").inc(int(elems_used))
            REGISTRY.counter("serve_elems_budget_total").inc(
                int(elems_budget))
        if self._replica is not None:
            REGISTRY.counter(f"serve_{self._replica}_batches_total").inc()

    @property
    def latencies_ms(self) -> np.ndarray:
        with self._lock:
            n = min(self._latency_count, self._latency_window)
            return self._latencies_ms[:n].copy()

    @property
    def occupancy(self) -> float:
        return (self.occupancy_used / self.occupancy_slots
                if self.occupancy_slots else 0.0)

    @property
    def cache_hit_rate(self) -> float:
        looked = self.cache_hits + self.cache_misses
        return self.cache_hits / looked if looked else 0.0

    def snapshot(self, queue_depth: int = 0) -> Dict[str, float]:
        """One JSON-able dict (the reference's /metrics body keys)."""
        out: Dict[str, float] = {name: getattr(self, name)
                                 for name in self.COUNTERS}
        lat = self.latencies_ms
        out.update(
            queue_depth=queue_depth,
            batch_occupancy=self.occupancy,
            cache_hit_rate=self.cache_hit_rate,
            latency_p50_ms=latency_quantile(lat, 0.50),
            latency_p99_ms=latency_quantile(lat, 0.99),
            latency_samples=int(lat.size),
            padding_waste_pct=round(100.0 * (1.0 - self.occupancy), 4)
            if self.occupancy_slots else 0.0,
        )
        with self._lock:
            padding = {}
            for (lane, slots), cell in sorted(self._padding.items()):
                c = {"used": cell["used"], "slots": cell["slots"],
                     "waste_pct": round(
                         100.0 * (1.0 - cell["used"] / cell["slots"]), 2),
                     "flushes": cell["flushes"]}
                b = cell.get("elems_budget", 0)
                if b:
                    c.update({k: cell[k] for k in (
                        "elems_used", "elems_budget", "elems_slot_underfill",
                        "elems_inslot_pad", "elems_flush_overhead")})
                    c["elem_waste_pct"] = round(
                        100.0 * (1.0 - cell["elems_used"] / b), 2)
                    for part in ("slot_underfill", "inslot_pad",
                                 "flush_overhead"):
                        c[f"{part}_pct"] = round(
                            100.0 * cell[f"elems_{part}"] / b, 2)
                padding[f"{lane}:b{slots}"] = c
            e_used = sum(c.get("elems_used", 0)
                         for c in self._padding.values())
            e_budget = sum(c.get("elems_budget", 0)
                           for c in self._padding.values())
        if e_budget:
            out["elem_waste_pct"] = round(
                100.0 * (1.0 - e_used / e_budget), 4)
        if padding:
            out["padding_waste"] = padding
        return out


# A padding cell's counts, each summable across engines; the pct keys
# are recomputed from the sums.
_PADDING_SUM_KEYS = (
    "used", "slots", "flushes", "elems_used", "elems_budget",
    "elems_slot_underfill", "elems_inslot_pad", "elems_flush_overhead",
)


def merge_padding_cells(cell_maps) -> Dict[str, Dict[str, float]]:
    """The per-(lane, bucket) padding cells of several engine snapshots
    (their ``padding_waste`` maps; None entries skipped) merged: counts
    summed, ``waste_pct`` and the element-axis pct keys recomputed from
    the sums (the fleet's ``/metrics``)."""
    merged: Dict[str, Dict[str, float]] = {}
    for cells in cell_maps:
        for key, cell in (cells or {}).items():
            acc = merged.setdefault(key, {"used": 0, "slots": 0})
            for k in _PADDING_SUM_KEYS:
                if k in cell:
                    acc[k] = acc.get(k, 0) + cell[k]
    for cell in merged.values():
        cell["waste_pct"] = round(
            100.0 * (1.0 - cell["used"] / cell["slots"]), 2
        ) if cell["slots"] else 0.0
        b = cell.get("elems_budget")
        if b:
            cell["elem_waste_pct"] = round(
                100.0 * (1.0 - cell.get("elems_used", 0) / b), 2)
            for part in ("slot_underfill", "inslot_pad", "flush_overhead"):
                cell[f"{part}_pct"] = round(
                    100.0 * cell.get(f"elems_{part}", 0) / b, 2)
    return merged


class IngestStats:
    """Per-boundary ingestion counters (``contracts.STATS``).

    Boundaries are free-form strings ("cache", "serve", ...); fields are
    ``seen``/``valid``/``rejected``/``repaired`` plus ``reason:<code>``
    and ``repair:<code>`` counters. Host-side and thread-safe; every
    bump is mirrored into the process registry as
    ``ingest_<boundary>_<field>_total`` (sanitized).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: Dict[str, Dict[str, int]] = {}

    def bump(self, boundary: str, field: str, by: int = 1) -> None:
        with self._lock:
            b = self._counts.setdefault(boundary, {})
            b[field] = b.get(field, 0) + by
        REGISTRY.counter(
            f"ingest_{sanitize(boundary)}_{sanitize(field)}_total").inc(by)

    def get(self, boundary: str, field: str) -> int:
        with self._lock:
            return self._counts.get(boundary, {}).get(field, 0)

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()

    def snapshot(self) -> Dict[str, Dict[str, int]]:
        """JSON-able per-boundary counter map (``cli validate``'s
        ``ingest_stats``)."""
        with self._lock:
            return {b: dict(sorted(fields.items()))
                    for b, fields in sorted(self._counts.items())}
