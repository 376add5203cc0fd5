"""Seeded traffic traces and virtual-clock replay (port of the
single-engine part of ``deepdfa_tpu/serve/replay.py``).

Arrivals come from a seeded bursty generator (no wall-clock randomness:
the trace is the same every run), the clock is virtual, and only
measured compute advances it. Each replay step either advances the clock
to the next arrival and submits, or advances it to the next flush time
and pumps; the engine adds each flush's measured wall time to the
virtual clock, so queueing behind slow compute is accounted exactly. A
request's latency is its completion clock less its arrival clock. The
fleet, scan and multi-process replays are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np

from deepdfa_tpu_torch.core.config import FeatureSpec


class VirtualClock:
    """Injectable monotonic clock: ``clock()`` reads, the caller advances."""

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt

    def advance_to(self, t: float) -> None:
        self.t = max(self.t, t)


@dataclasses.dataclass
class TraceEvent:
    at: float                 # virtual arrival time (seconds)
    graph: Optional[Mapping]
    code: Optional[str] = None


def bursty_trace(
    n_requests: int,
    feature: FeatureSpec = FeatureSpec(),
    seed: int = 0,
    burst_mean: float = 12.0,
    gap_ms_range: "tuple[float, float]" = (5.0, 60.0),
    intra_ms: float = 0.3,
    duplicate_fraction: float = 0.25,
    with_code: bool = False,
) -> List[TraceEvent]:
    """CI-scan-shaped traffic: bursts of near-simultaneous requests
    separated by idle gaps, with a duplicate fraction (re-scans of
    unchanged functions) that exercises the content cache. Fully
    determined by ``seed``: the reference's trace, event for event."""
    from deepdfa_tpu_torch.data.synthetic import synthetic_bigvul

    rng = np.random.default_rng(seed)
    uniques = synthetic_bigvul(n_requests, feature, positive_fraction=0.5,
                               seed=seed)
    events: List[TraceEvent] = []
    t = 0.0
    next_unique = 0
    while len(events) < n_requests:
        burst = max(1, int(rng.poisson(burst_mean)))
        for _ in range(min(burst, n_requests - len(events))):
            if next_unique and rng.random() < duplicate_fraction:
                g = uniques[int(rng.integers(next_unique))]
            else:
                g = uniques[next_unique]
                next_unique = min(next_unique + 1, len(uniques) - 1)
            code = None
            if with_code:
                code = f"int f_{int(g['id'])}(char *p) {{ return p[0]; }}"
            events.append(TraceEvent(at=t, graph=g, code=code))
            t += intra_ms / 1000.0
        t += float(rng.uniform(*gap_ms_range)) / 1000.0
    return events


def replay(engine, trace: Sequence[TraceEvent], clock: VirtualClock) -> Dict:
    """Drive ``engine`` (whose clock must be ``clock``) through ``trace``.

    Returns the engine's metrics snapshot (plus ``dropped``, ``span_s``
    and ``graphs_per_sec``) and the replayed requests in submission
    order. A rejected submission is pumped and retried once; a second
    rejection is counted in ``dropped`` and the event skipped.
    """
    from deepdfa_tpu_torch.serve.batcher import RejectedError

    requests = []
    dropped = 0
    i = 0
    while i < len(trace) or engine.pending():
        t_arrival = trace[i].at if i < len(trace) else float("inf")
        t_flush = engine.next_flush_time()
        if t_flush is None:
            t_flush = float("inf")
        if t_flush <= t_arrival:
            clock.advance_to(t_flush)
            ran = engine.pump()
            if not ran and not engine.pending():
                break
            continue
        clock.advance_to(t_arrival)
        ev = trace[i]
        i += 1
        try:
            requests.append(engine.submit(ev.graph, code=ev.code))
        except RejectedError:
            engine.pump()
            try:
                requests.append(engine.submit(ev.graph, code=ev.code))
            except RejectedError:
                dropped += 1
    report = engine.snapshot()
    report["dropped"] = dropped
    span = clock() - (trace[0].at if trace else 0.0)
    report["span_s"] = span
    report["graphs_per_sec"] = (len(requests) / span) if span > 0 else 0.0
    return {"metrics": report, "requests": requests}
