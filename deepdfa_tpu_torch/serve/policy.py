"""Adaptive flush policy (port of ``deepdfa_tpu/serve/policy.py``).

Each replica's batcher has two flush levers (``serve/batcher.py``): the
deadline fraction (how much of a request's budget may go to waiting for
companions) and the fill threshold (how full a bucket must be to flush
on occupancy alone). This policy moves them from the replica's own
numbers: its rolling latency window and the occupancy of the buckets it
flushed since its last decision. A replica whose tail latency is over
target flushes sooner; an idle one waits longer for fuller buckets.

- Clamped: the batcher clamps the fraction to [flush_fraction_min,
  flush_fraction_max] and the fill to [1, batch_slots].
- Hysteresis: a move needs ``adaptive_patience`` consecutive signals in
  one direction.
- Recorded: every decision (a move or a hold) is returned as a dict and
  emitted as a ``serve.flush_policy`` trace event, as in the reference.

Time comes from the engine's clock, so a replayed run decides the same
way every time.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from deepdfa_tpu_torch import telemetry
from deepdfa_tpu_torch.core.metrics import latency_quantile
from deepdfa_tpu_torch.serve.config import ServeConfig

__all__ = ["AdaptiveFlushPolicy"]


@dataclasses.dataclass
class _Decision:
    action: str               # "lower" | "raise" | "hold"
    fraction: float
    fill_slots: int
    p99_ms: float
    occupancy: float


class AdaptiveFlushPolicy:
    """One replica's flush-threshold controller.

    ``maybe_update(engine)`` runs from the engine's ``pump`` at most once
    an ``adaptive_interval_s`` of engine clock. It compares the replica's
    p99 with ``adaptive_target_p99_frac * deadline_ms`` and moves the
    thresholds one ``adaptive_step`` at a time after
    ``adaptive_patience`` consecutive signals.
    """

    def __init__(self, config: ServeConfig, replica: Optional[str] = None):
        self.config = config
        self.replica = replica
        self.fraction = min(
            max(config.flush_fraction, config.flush_fraction_min),
            config.flush_fraction_max)
        self.fill_slots = config.batch_slots
        self.target_p99_ms = (config.adaptive_target_p99_frac
                              * config.deadline_ms)
        self._pressure = 0      # consecutive over-target windows
        self._slack = 0         # consecutive well-under-target windows
        self._last_eval: Optional[float] = None
        self._last_traffic = -1  # completed + failures at the last decision
        # The occupancy counters at the last decision: the policy reads
        # the buckets flushed since then, not the lifetime average.
        self._last_used = 0
        self._last_slots = 0
        self.decisions = 0

    def _window_occupancy(self, engine) -> float:
        """Occupancy of the buckets flushed since the last decision; 1.0
        when none was (no evidence of empty buckets)."""
        used = engine.stats.occupancy_used
        slots = engine.stats.occupancy_slots
        d_used, d_slots = used - self._last_used, slots - self._last_slots
        self._last_used, self._last_slots = used, slots
        return d_used / d_slots if d_slots > 0 else 1.0

    def maybe_update(self, engine) -> Optional[Dict[str, Any]]:
        """Decide once an interval: the decision dict, or None when the
        interval has not passed or no request completed or failed since
        the last decision (an idle replica has nothing to decide)."""
        now = engine.now()
        if (self._last_eval is not None
                and now - self._last_eval < self.config.adaptive_interval_s):
            return None
        traffic = engine.stats.completed + engine.stats.failures
        if traffic == self._last_traffic:
            self._last_eval = now
            return None
        self._last_traffic = traffic
        self._last_eval = now
        decision = self._decide(
            latency_quantile(engine.stats.latencies_ms, 0.99),
            self._window_occupancy(engine))
        engine.batcher.set_flush_policy(fraction=decision.fraction,
                                        fill_slots=decision.fill_slots)
        # The batcher clamped: read back what it holds.
        self.fraction = engine.batcher.flush_fraction
        self.fill_slots = engine.batcher.fill_slots
        self.decisions += 1
        doc = {
            "replica": self.replica or "r0",
            "action": decision.action,
            "fraction": round(self.fraction, 4),
            "fill_slots": self.fill_slots,
            "p99_ms": round(decision.p99_ms, 3),
            "occupancy": round(decision.occupancy, 4),
            "target_p99_ms": round(self.target_p99_ms, 3),
            "pressure": self._pressure,
            "slack": self._slack,
        }
        telemetry.event("serve.flush_policy", **doc)
        return doc

    def _decide(self, p99_ms: float, occupancy: float) -> _Decision:
        cfg = self.config
        action = "hold"
        if p99_ms > self.target_p99_ms:
            # Tail over target: wait less and flush at smaller fills.
            self._pressure += 1
            self._slack = 0
            if self._pressure >= cfg.adaptive_patience:
                action = "lower"
                self.fraction -= cfg.adaptive_step
                self.fill_slots = max(1, self.fill_slots // 2)
                self._pressure = 0
        elif p99_ms < 0.5 * self.target_p99_ms and occupancy < 0.5:
            # Comfortable tail and half-empty buckets: wait longer so
            # buckets fill.
            self._slack += 1
            self._pressure = 0
            if self._slack >= cfg.adaptive_patience:
                action = "raise"
                self.fraction += cfg.adaptive_step
                self.fill_slots = min(cfg.batch_slots, self.fill_slots * 2)
                self._slack = 0
        else:
            self._pressure = 0
            self._slack = 0
        self.fraction = min(max(self.fraction, cfg.flush_fraction_min),
                            cfg.flush_fraction_max)
        return _Decision(action, self.fraction, self.fill_slots,
                         p99_ms, occupancy)
