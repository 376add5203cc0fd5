"""Seeded traffic traces and virtual-clock replay (port of the engine
and fleet parts of ``deepdfa_tpu/serve/replay.py``).

Arrivals come from a seeded bursty generator (no wall-clock randomness:
the trace is the same every run), the clock is virtual, and only
measured compute advances it. Each replay step either advances the clock
to the next arrival and submits, or advances it to the next flush time
and pumps; the engine adds each flush's measured wall time to the
virtual clock, so queueing behind slow compute is accounted exactly. A
request's latency is its completion clock less its arrival clock.

The fleet replay (:func:`open_loop_trace`, :func:`replay_fleet`) is the
same idea as a discrete-event simulation of a fleet: open-loop seeded
Poisson arrivals, and each replica crediting its measured flush time to
its own :class:`ReplicaTimeline` over one shared clock, so N replicas
overlap as N devices would (on one card that makes the N-replica rate a
model of N cards, not a measurement of one). A full queue sheds. The
scan and multi-process replays are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np

from deepdfa_tpu_torch.core.config import FeatureSpec
from deepdfa_tpu_torch.core.metrics import latency_quantile


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

    def flush_done(self, dt: float) -> float:
        """The engine's completion-clock protocol: credit a flush's
        measured time and return its completion time (on one serial
        timeline, advance and read)."""
        self.advance(dt)
        return self.t


class ReplicaTimeline:
    """One replica's busy horizon over a shared virtual clock.

    Every replica reads the one clock (arrival order stays global), but
    each credits its flushes to its own ``busy_until``: replica A's flush
    does not stall replica B, as on N devices. A replica's own flushes
    serialize: one dispatched while the previous still "runs" starts at
    the busy horizon.
    """

    def __init__(self, shared: VirtualClock):
        self.shared = shared
        self.busy_until = 0.0

    def __call__(self) -> float:
        return self.shared()

    def flush_done(self, dt: float) -> float:
        start = max(self.shared(), self.busy_until)
        self.busy_until = start + dt
        return self.busy_until


@dataclasses.dataclass
class TraceEvent:
    at: float                 # virtual arrival time (seconds)
    graph: Optional[Mapping]
    code: Optional[str] = None
    lane: Optional[str] = None   # "gen" rides the generation lane


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


# ---------------------------------------------------------------------------
# Sustained load on a fleet: open-loop arrivals over replica timelines
# ---------------------------------------------------------------------------


def open_loop_trace(
    n_requests: int,
    feature: FeatureSpec = FeatureSpec(),
    seed: int = 0,
    rps: float = 2000.0,
    duplicate_fraction: float = 0.25,
    code_fraction: float = 0.0,
    gen_fraction: float = 0.0,
) -> List[TraceEvent]:
    """An open-loop arrival schedule at ``rps`` requests a second: the
    arrival times are fixed by the seeded Poisson schedule, never by
    completions, so a slow server faces a growing queue. ``code_fraction``
    of the requests carry source (the combined lane); ``gen_fraction`` are
    generation requests (``lane="gen"``, source and no graph), which
    replay once the gen lane is ported. The reference's trace, event for
    event."""
    from deepdfa_tpu_torch.data.synthetic import synthetic_bigvul

    rng = np.random.default_rng(seed)
    uniques = synthetic_bigvul(n_requests, feature, positive_fraction=0.5,
                               seed=seed)
    events: List[TraceEvent] = []
    t = 0.0
    next_unique = 0
    for _ in range(n_requests):
        if next_unique and rng.random() < duplicate_fraction:
            g = uniques[int(rng.integers(next_unique))]
        else:
            g = uniques[next_unique]
            next_unique = min(next_unique + 1, len(uniques) - 1)
        code = None
        if gen_fraction and rng.random() < gen_fraction:
            code = f"int gen_{int(g['id'])}(char *p);"
            events.append(TraceEvent(at=t, graph=None, code=code,
                                     lane="gen"))
            t += float(rng.exponential(1.0 / rps))
            continue
        if code_fraction and rng.random() < code_fraction:
            code = f"int f_{int(g['id'])}(char *p) {{ return p[0]; }}"
        events.append(TraceEvent(at=t, graph=g, code=code))
        t += float(rng.exponential(1.0 / rps))
    return events


def replay_fleet(fleet, trace: Sequence[TraceEvent],
                 clock: VirtualClock) -> Dict:
    """Drive a :class:`~deepdfa_tpu_torch.serve.fleet.ServeFleet` (whose
    replicas run :class:`ReplicaTimeline` views of ``clock``) through an
    open-loop trace as a discrete-event simulation.

    The next event is whichever comes first: the next arrival, or the
    earliest replica able to flush (its batcher's horizon, no earlier
    than its busy horizon). A flush's measured time goes to the flushing
    replica's own timeline, while arrivals keep landing and joining
    pending buckets. A full queue sheds (``shed``): an open-loop client
    waits on nothing. ``rps`` is completed over span.
    """
    timelines: List[ReplicaTimeline] = []
    for r in fleet.replicas:
        tl = r.engine.clock
        if not isinstance(tl, ReplicaTimeline):
            raise ValueError(
                f"replica {r.rid} clock must be a ReplicaTimeline view of "
                "the shared virtual clock (ServeFleet.build clock_factory)")
        timelines.append(tl)

    from deepdfa_tpu_torch.serve.batcher import RejectedError

    requests = []
    shed = 0
    i = 0
    stalls = 0
    while i < len(trace) or fleet.pending():
        t_arr = trace[i].at if i < len(trace) else float("inf")
        best = None
        for r, tl in zip(fleet.replicas, timelines):
            horizon = r.engine.next_flush_time()
            if horizon is None:
                continue
            ready = max(horizon, tl.busy_until)
            if best is None or ready < best[0]:
                best = (ready, r)
        t_flush = best[0] if best is not None else float("inf")
        if t_arr == float("inf") and t_flush == float("inf"):
            break
        if t_arr <= t_flush:
            clock.advance_to(t_arr)
            ev = trace[i]
            i += 1
            try:
                requests.append(fleet.submit(ev.graph, code=ev.code,
                                             lane=ev.lane))
            except RejectedError:
                shed += 1
            stalls = 0
        else:
            clock.advance_to(t_flush)
            ran = best[1].engine.pump(max_batches=1)
            # A horizon that keeps firing with nothing to flush would spin
            # this loop forever: a fault, not load.
            stalls = 0 if ran else stalls + 1
            if stalls > 2 * len(fleet.replicas) + 2:
                raise RuntimeError(
                    "fleet replay stalled: flush horizons keep firing "
                    "without a dispatchable bucket")

    end = max([clock()] + [tl.busy_until for tl in timelines])
    span = end - (trace[0].at if trace else 0.0)
    completed = [r for r in requests if r.result is not None
                 and "prob" in r.result]
    lat_ms = [(r.completed_at - r.arrival) * 1e3 for r in completed
              if r.completed_at is not None]
    lanes: Dict[str, Dict[str, float]] = {}
    for lane in sorted({r.lane for r in completed}):
        ms = [(r.completed_at - r.arrival) * 1e3 for r in completed
              if r.lane == lane and r.completed_at is not None]
        lanes[lane] = {
            "requests": len(ms),
            "latency_p50_ms": latency_quantile(ms, 0.50),
            "latency_p99_ms": latency_quantile(ms, 0.99),
        }
    offered = (len(trace) / (trace[-1].at - trace[0].at)
               if len(trace) > 1 and trace[-1].at > trace[0].at else 0.0)
    return {
        "metrics": fleet.snapshot(),
        "requests": requests,
        "n_offered": len(trace),
        "offered_rps": offered,
        "completed": len(completed),
        "shed": shed,
        "span_s": span,
        "rps": len(completed) / span if span > 0 else 0.0,
        "latency_p50_ms": latency_quantile(lat_ms, 0.50),
        "latency_p99_ms": latency_quantile(lat_ms, 0.99),
        "lanes": lanes,
        "compiles_after_warmup": fleet.compiles_after_warmup,
    }
