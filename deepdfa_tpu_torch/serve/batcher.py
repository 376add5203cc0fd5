"""Request queue + deadline-aware micro-batcher (port of
``deepdfa_tpu/serve/batcher.py``).

Requests accumulate per lane and flush as one padded micro-batch when
the lane holds a full ``batch_slots`` bucket (fill-flush) or its oldest
request has spent ``flush_fraction`` of its deadline waiting
(deadline-flush). When several lanes are due, the one with the least
remaining budget flushes first. A bucket is sealed when the pump takes
it, so admissions that land in between ride along. Both thresholds
are live: :meth:`MicroBatcher.set_flush_policy` (the adaptive policy's
levers, clamped here) moves the deadline fraction and the fill count,
and drain mode makes every non-empty lane due at once (a replica
leaving rotation). Backpressure is explicit: :class:`RejectedError` past
``queue_capacity``, :class:`OversizedError` for a graph no slot could
hold.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Deque, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from deepdfa_tpu_torch import telemetry
from deepdfa_tpu_torch.serve.config import ServeConfig


class RejectedError(Exception):
    """Queue full — retry after ``retry_after_s``."""

    def __init__(self, retry_after_s: float):
        self.retry_after_s = retry_after_s
        super().__init__(
            f"serving queue full; retry after {retry_after_s:.3f}s")


class OversizedError(Exception):
    """Request exceeds the per-slot graph budget (no bucket could hold it)."""


@dataclasses.dataclass
class ServeRequest:
    """One function to score, plus its result. ``event`` lets a transport
    thread block until the pump thread (or a cache hit) finishes it;
    single-threaded callers read ``result`` after draining."""

    rid: int
    key: str                      # content hash (cache line)
    graph: Optional[Mapping]
    lane: str                     # "gnn" | "combined"
    arrival: float                # engine-clock seconds
    deadline_s: float
    t_submit: float = 0.0         # telemetry clock (perf_counter seconds)
    input_ids: Optional[np.ndarray] = None   # the combined lane's row
    # The distributed trace this request rides (continued from a client's
    # traceparent header, or minted at admission): the serve.request span
    # carries both.
    trace_id: Optional[str] = None
    trace_continued: bool = False
    degraded: bool = False        # tokenizer failed -> gnn lane
    completed_at: Optional[float] = None
    result: Optional[Dict] = None
    event: threading.Event = dataclasses.field(
        default_factory=threading.Event, repr=False)

    def finish(self, result: Dict) -> None:
        self.result = result
        self.event.set()

    def flush_at(self, fraction: float) -> float:
        """Clock time at which this request forces a deadline-flush."""
        return self.arrival + fraction * self.deadline_s


class MicroBatcher:
    """Per-lane FIFO queues with the two-condition flush policy; time
    comes from the caller (the engine's clock), never the wall.
    ``replica`` tags the ``serve.enqueue`` events (rids are per engine)."""

    def __init__(self, config: ServeConfig, lanes: Sequence[str] = ("gnn",),
                 replica: Optional[str] = None):
        self.config = config
        self._replica = replica
        self._pending: Dict[str, Deque[ServeRequest]] = {
            lane: collections.deque() for lane in lanes}
        self._lock = threading.Lock()
        # Drain mode: any non-empty lane is due now, so a replica leaving
        # rotation answers what it admitted without waiting out a flush.
        self._drain_mode = False
        # The live flush thresholds; the defaults are the config's.
        self._flush_fraction = config.flush_fraction
        self._fill_slots = config.batch_slots
        # Why each lane's last bucket sealed (fill / deadline / drain): the
        # engine stamps it onto the serve.flush span.
        self._last_cause: Dict[str, str] = {}

    def set_flush_policy(self, fraction: Optional[float] = None,
                         fill_slots: Optional[int] = None) -> None:
        """Retune the two flush thresholds. ``fraction`` clamps to
        [flush_fraction_min, flush_fraction_max], ``fill_slots`` to
        [1, batch_slots]: the clamp lives here, so no policy can push the
        batcher past the band."""
        with self._lock:
            if fraction is not None:
                self._flush_fraction = min(
                    max(float(fraction), self.config.flush_fraction_min),
                    self.config.flush_fraction_max)
            if fill_slots is not None:
                self._fill_slots = min(max(int(fill_slots), 1),
                                       self.config.batch_slots)

    @property
    def flush_fraction(self) -> float:
        return self._flush_fraction

    @property
    def fill_slots(self) -> int:
        return self._fill_slots

    def set_drain_mode(self, on: bool = True) -> None:
        with self._lock:
            self._drain_mode = bool(on)

    @property
    def drain_mode(self) -> bool:
        return self._drain_mode

    @property
    def lanes(self) -> Tuple[str, ...]:
        return tuple(self._pending)

    def depth(self) -> int:
        with self._lock:
            return sum(len(q) for q in self._pending.values())

    def admit(self, req: ServeRequest) -> None:
        """Enqueue or raise (RejectedError / OversizedError)."""
        if req.graph is not None:
            n = int(req.graph["num_nodes"])
            e = len(req.graph["senders"]) + n  # + self loops, as batching
            reason = self.config.admission_caps(n, e)
            if reason is not None:
                raise OversizedError(reason)
        with self._lock:
            if req.lane not in self._pending:
                raise ValueError(f"unknown lane {req.lane!r}")
            if sum(len(q) for q in self._pending.values()) \
                    >= self.config.queue_capacity:
                raise RejectedError(
                    self._flush_fraction * self.config.deadline_ms / 1000.0)
            self._pending[req.lane].append(req)
            depth = sum(len(q) for q in self._pending.values())
        # Outside the lock: the enqueue step of the request's trace.
        attrs = dict(rid=req.rid, lane=req.lane, depth=depth)
        if self._replica is not None:
            attrs["replica"] = self._replica
        telemetry.event("serve.enqueue", **attrs)

    def due(self, now: float) -> Optional[str]:
        """The lane to flush at ``now`` (least remaining budget first), or
        None. Deadlines are scanned over the whole queue: a short-deadline
        request behind a long-deadline head still forces its flush."""
        with self._lock:
            best: Optional[Tuple[float, str]] = None
            for lane, q in self._pending.items():
                if not q:
                    continue
                filled = len(q) >= self._fill_slots
                deadline_due = now >= min(
                    r.flush_at(self._flush_fraction) for r in q)
                if not (filled or deadline_due or self._drain_mode):
                    continue
                remaining = min(r.arrival + r.deadline_s for r in q) - now
                if best is None or remaining < best[0]:
                    best = (remaining, lane)
            return best[1] if best else None

    def next_flush_time(self, now: float) -> Optional[float]:
        """Earliest clock time any lane becomes due (<= now when one is)."""
        with self._lock:
            t: Optional[float] = None
            for q in self._pending.values():
                if not q:
                    continue
                when = (now if (len(q) >= self._fill_slots
                                or self._drain_mode)
                        else min(r.flush_at(self._flush_fraction)
                                 for r in q))
                if t is None or when < t:
                    t = when
            return t

    def take(self, lane: str) -> List[ServeRequest]:
        """Pop the lane's next micro-batch (FIFO, up to batch_slots) — the
        seal point of the bucket. It always caps at the static
        ``batch_slots``: the fill threshold decides when to flush, never
        a new shape."""
        with self._lock:
            q = self._pending[lane]
            # Classified under the lock that seals: a full bucket is a
            # fill-flush even in drain mode.
            if len(q) >= self._fill_slots:
                self._last_cause[lane] = "fill"
            elif self._drain_mode:
                self._last_cause[lane] = "drain"
            else:
                self._last_cause[lane] = "deadline"
            return [q.popleft()
                    for _ in range(min(len(q), self.config.batch_slots))]

    def last_flush_cause(self, lane: str) -> Optional[str]:
        """Why ``lane``'s most recent bucket sealed (None before any)."""
        with self._lock:
            return self._last_cause.get(lane)
