"""The serving fleet: N engine replicas behind one router (port of
``deepdfa_tpu/serve/fleet.py``).

One :class:`~deepdfa_tpu_torch.serve.engine.ServeEngine` drives one
device. The fleet is N of them behind one front end: each replica owns a
shard of the devices (``parallel.mesh.replica_device_shards``), warms its
buckets on its own and runs its own micro-batcher and pump thread, so
the transport threads share only each replica's admission queue with the
execution path. Replicas on one device share its model module (and, on
a card, its default stream: their flushes take turns there); a replica
on another device gets its own copy, since ``Module.to`` moves a module
in place.

**Routing** is content-affine, load-aware and drain-aware:

- rendezvous hashing on the request's content key picks a preferred
  replica, so a re-submission lands on the replica whose cache holds its
  answer;
- the preference yields when that replica is mid-flush or holds a full
  bucket's worth of requests: the least-loaded sibling takes the request
  (idle ones first, round-robin on ties), so an arrival never waits out
  a busy replica's flush;
- a lame-duck replica leaves the routing set at once while its admitted
  requests drain.

**Rolling** (:meth:`ServeFleet.roll_replica`) is drain, out of rotation,
back: the replica's batcher flushes partial buckets at once, the router
stops choosing it, every admitted request is answered, and it comes back
with its warmed buckets, so a roll never counts a compile.

Telemetry: a fleet predeclares each tagged replica's ``serve_<rid>_*``
series in the process registry (:func:`predeclare_fleet_metrics`), so the
Prometheus exposition carries every replica from the first scrape, and a
roll emits ``fleet.replica_drain`` and ``fleet.replica_restore`` events.
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from deepdfa_tpu_torch import telemetry
from deepdfa_tpu_torch.core.device import resolve_device
from deepdfa_tpu_torch.core.metrics import (
    ServingStats,
    latency_quantile,
    merge_padding_cells,
)
from deepdfa_tpu_torch.serve.batcher import (
    OversizedError,
    RejectedError,
    ServeRequest,
)
from deepdfa_tpu_torch.serve.cache import content_hash
from deepdfa_tpu_torch.serve.config import MAX_REPLICAS, REPLICA_IDS, ServeConfig
from deepdfa_tpu_torch.serve.engine import BadRequestError, ServeEngine
from deepdfa_tpu_torch.serve.policy import AdaptiveFlushPolicy

__all__ = ["Replica", "ServeFleet", "predeclare_fleet_metrics"]


def predeclare_fleet_metrics(active: Sequence[str]) -> None:
    """Create every active replica's counter and histogram series up front
    (``active`` chooses which of ``REPLICA_IDS`` materialize)."""
    wanted = set(active)
    for rid in REPLICA_IDS:
        if rid not in wanted:
            continue
        for counter in ServingStats.COUNTERS:
            telemetry.REGISTRY.counter(f"serve_{rid}_{counter}_total")
        telemetry.REGISTRY.histogram(f"serve_{rid}_latency_ms")


def _stable_hash(text: str) -> int:
    """A hash that is the same in every process (the builtin ``hash`` is
    salted per process), for rendezvous routing."""
    return int.from_bytes(hashlib.blake2b(text.encode(),
                                          digest_size=8).digest(), "big")


def _device_key(device) -> str:
    """A device's name with its index: "cuda" and "cuda:0" are one card."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


def _per_device(module):
    """device -> the module a replica there runs: ``module`` itself for
    the first device asked for, one copy of it for each other device
    (replicas of one device share it)."""
    on: Dict[str, Any] = {}

    def get(device):
        key = _device_key(device)
        if key not in on:
            on[key] = module if not on else copy.deepcopy(module)
        return on[key]

    return get


@dataclasses.dataclass
class Replica:
    """One engine plus its fleet bookkeeping."""

    rid: str
    engine: ServeEngine
    devices: Sequence[Any] = ()

    @property
    def lame_duck(self) -> bool:
        return self.engine.lame_duck

    def load(self) -> int:
        return self.engine.load()


class ServeFleet:
    """N engine replicas behind one admission front end.

    The fleet speaks the single engine's surface (``submit``, ``pump``,
    ``drain``, ``pending``, ``score_sync``, ``snapshot``, ``warmup``,
    ``config``, ``required_subkeys``), so the HTTP server and ``cli
    score`` drive a fleet and a lone engine through the same code.
    """

    def __init__(self, replicas: Sequence[Replica]):
        if not replicas:
            raise ValueError("a fleet needs at least one replica")
        if len(replicas) > MAX_REPLICAS:
            raise ValueError(
                f"fleet size {len(replicas)} exceeds the replica ids "
                f"fixed in REPLICA_IDS ({MAX_REPLICAS})")
        self.replicas: List[Replica] = list(replicas)
        # Only tagged replicas: an untagged engine (from_engine) never
        # writes serve_r0_*, so declaring them would show a replica with
        # no traffic.
        predeclare_fleet_metrics([r.rid for r in self.replicas
                                  if r.engine.replica is not None])
        # Round-robin cursor for load ties: a burst on an idle fleet
        # would otherwise pile onto r0 until its queue visibly deepens.
        self._rr = 0

    # -- construction ------------------------------------------------------

    @classmethod
    def build(cls, gnn_model, config: Optional[ServeConfig] = None,
              n_replicas: Optional[int] = None, combined_model=None,
              tokenizer=None, clock: Callable[[], float] = time.monotonic,
              clock_factory: Optional[Callable[[int], Callable[[], float]]]
              = None,
              devices: Optional[Sequence[Any]] = None) -> "ServeFleet":
        """N engines over the devices (default: the visible CUDA devices;
        raises without one unless ``devices`` names the CPU).
        ``clock_factory(i)`` overrides the shared ``clock`` for replica i:
        the replay gives each replica its own timeline over one virtual
        clock."""
        from deepdfa_tpu_torch.parallel.mesh import replica_device_shards

        config = config or ServeConfig()
        n = n_replicas if n_replicas is not None else config.replicas
        if not 1 <= n <= MAX_REPLICAS:
            raise ValueError(f"n_replicas must be in [1, {MAX_REPLICAS}]")
        shards = replica_device_shards(n, devices=devices)
        gnn_on = _per_device(gnn_model)
        combined_on = (_per_device(combined_model)
                       if combined_model is not None else None)
        replicas: List[Replica] = []
        for i in range(n):
            rid = REPLICA_IDS[i]
            device = shards[i][0]
            policy = (AdaptiveFlushPolicy(config, replica=rid)
                      if config.adaptive_flush else None)
            engine = ServeEngine(
                gnn_on(device), config,
                clock=clock_factory(i) if clock_factory else clock,
                device=device,
                combined_model=(combined_on(device)
                                if combined_on is not None else None),
                tokenizer=tokenizer, replica=rid, policy=policy)
            replicas.append(Replica(rid=rid, engine=engine,
                                    devices=tuple(shards[i])))
        return cls(replicas)

    @classmethod
    def from_engine(cls, engine: ServeEngine) -> "ServeFleet":
        """One pre-built engine as a one-replica fleet (how the HTTP
        server takes a lone engine). The engine keeps its replica tag,
        or none."""
        return cls([Replica(rid=engine.replica or REPLICA_IDS[0],
                            engine=engine)])

    # -- the single engine's surface ---------------------------------------

    @property
    def primary(self) -> Replica:
        return self.replicas[0]

    @property
    def config(self) -> ServeConfig:
        return self.primary.engine.config

    @property
    def required_subkeys(self) -> List[str]:
        return self.primary.engine.required_subkeys

    @property
    def size(self) -> int:
        return len(self.replicas)

    @property
    def live(self) -> List[Replica]:
        return [r for r in self.replicas if not r.lame_duck]

    def now(self) -> float:
        return self.primary.engine.now()

    def warmup(self) -> int:
        """Warm every replica on its own; the buckets run now in all."""
        return sum(r.engine.warmup() for r in self.replicas)

    @property
    def n_warm(self) -> int:
        return sum(r.engine.n_warm for r in self.replicas)

    @property
    def graphs_captured(self) -> int:
        return sum(r.engine.graphs_captured for r in self.replicas)

    @property
    def graph_pool_bytes(self) -> int:
        return sum(r.engine.graph_pool_bytes for r in self.replicas)

    @property
    def compiles_after_warmup(self) -> Optional[int]:
        """Buckets first run after warmup, summed over the replicas (must
        stay 0); None until every replica is warm."""
        per = [r.engine.compiles_after_warmup for r in self.replicas]
        if any(c is None for c in per):
            return None
        return sum(per)  # type: ignore[arg-type]

    def prime(self, graphs: Sequence[Mapping]) -> int:
        """Run every warmed bucket once more on every replica, with real
        graphs (``sum(slot_buckets)`` distinct ones, disjoint from what is
        measured next or with the cache off), so a measured replay pays
        no first-run cost; then rewind virtual timelines and their shared
        clock to 0 (priming is set-up, not load). The reference also
        primes the gen lane's (slot, source) ladder; the gen lane is not
        ported yet. Returns the primed submissions."""
        need = sum(self.config.slot_buckets)
        if len(graphs) < need:
            raise ValueError(
                f"prime needs >= {need} distinct graphs "
                f"(sum of slot_buckets), got {len(graphs)}")
        n = 0
        for r in self.replicas:
            it = iter(graphs)
            for slots in self.config.slot_buckets:
                for _ in range(slots):
                    r.engine.submit(next(it))
                    n += 1
                r.engine.drain()
        for r in self.replicas:
            tl = r.engine.clock
            if hasattr(tl, "busy_until"):
                tl.busy_until = 0.0
            shared = getattr(tl, "shared", None)
            if shared is not None and hasattr(shared, "t"):
                shared.t = 0.0
        return n

    def pending(self) -> int:
        return sum(r.engine.pending() for r in self.replicas)

    def pump(self) -> int:
        """Flush every due lane on every replica (one driving thread;
        threaded serving runs one pump a replica instead)."""
        return sum(r.engine.pump() for r in self.replicas)

    def drain(self) -> int:
        return sum(r.engine.drain() for r in self.replicas)

    def next_flush_time(self) -> Optional[float]:
        horizons = [r.engine.next_flush_time() for r in self.replicas]
        horizons = [h for h in horizons if h is not None]
        return min(horizons) if horizons else None

    # -- routing -----------------------------------------------------------

    def route(self, key: Optional[str]) -> Replica:
        """The replica for a content key: its rendezvous preference unless
        that one is mid-flush or holds ``batch_slots`` requests or more;
        then the least-loaded live replica, idle ones first, round-robin
        on ties. Raises RejectedError when every replica is draining."""
        live = self.live
        if not live:
            # The whole fleet is draining: shed with the usual retry hint;
            # admitted work is still answered behind this.
            raise RejectedError(self.config.deadline_ms / 1000.0)
        if len(live) == 1:
            return live[0]
        if key is not None:
            pref = max(live, key=lambda r: _stable_hash(f"{key}|{r.rid}"))
            if pref.engine.in_flight == 0 \
                    and pref.load() < self.config.batch_slots:
                return pref
        order = live[self._rr % len(live):] + live[:self._rr % len(live)]
        self._rr += 1
        return min(order, key=lambda r: (r.engine.in_flight > 0, r.load()))

    def submit(self, graph: Optional[Mapping], code: Optional[str] = None,
               deadline_ms: Optional[float] = None,
               lane: Optional[str] = None,
               trace_id: Optional[str] = None,
               trace_continued: bool = False) -> ServeRequest:
        """Admit one request through the router. A rejection by the routed
        replica (its queue filled between the load read and the admit) is
        retried once on the least-loaded live sibling before it reaches
        the caller. ``trace_id``/``trace_continued`` go to the engine."""
        try:
            # The graph alone is the routing key (code left out), so every
            # cache line one function may write lands on one replica.
            key = content_hash(graph)
        except Exception:
            # A malformed payload (or a gen request, which has no graph):
            # route on load alone and let the engine raise its 400.
            key = None
        replica = self.route(key)
        try:
            return replica.engine.submit(graph, code=code,
                                         deadline_ms=deadline_ms, lane=lane,
                                         trace_id=trace_id,
                                         trace_continued=trace_continued)
        except RejectedError:
            others = [r for r in self.live if r is not replica]
            if not others:
                raise
            fallback = min(others, key=lambda r: r.load())
            return fallback.engine.submit(graph, code=code,
                                          deadline_ms=deadline_ms, lane=lane,
                                          trace_id=trace_id,
                                          trace_continued=trace_continued)

    def score_sync(self, graphs: Sequence[Mapping],
                   codes: Optional[Sequence[Optional[str]]] = None
                   ) -> List[Dict]:
        """The offline client over the fleet, as
        ``ServeEngine.score_sync``: results in submission order, the same
        probabilities as one engine (the same weights, the same buckets);
        backpressure drains and retries, admission errors come back
        inline."""
        out: List[Optional[ServeRequest]] = []
        errors: Dict[int, Dict] = {}
        for i, graph in enumerate(graphs):
            code = codes[i] if codes is not None else None
            try:
                out.append(self.submit(graph, code=code))
            except RejectedError:
                self.drain()
                out.append(self.submit(graph, code=code))
            except OversizedError as e:
                errors[i] = {"error": "oversized", "detail": str(e)}
                out.append(None)
            except BadRequestError as e:
                errors[i] = {"error": "bad_request", "detail": str(e)}
                out.append(None)
        self.drain()
        return [errors[i] if r is None else r.result
                for i, r in enumerate(out)]

    # -- lame duck and roll ------------------------------------------------

    def enter_lame_duck(self) -> None:
        """Every replica flushes partial buckets at once. Idempotent."""
        for r in self.replicas:
            r.engine.enter_lame_duck()

    def begin_replica_drain(self, rid: str) -> Replica:
        """Take one replica out of rotation: its batcher flushes partial
        buckets now, the router stops choosing it, its pump answers what
        it admitted; the rest of the fleet keeps serving."""
        replica = self._replica(rid)
        replica.engine.enter_lame_duck()
        telemetry.event("fleet.replica_drain", replica=rid, reason="roll",
                        pending=replica.engine.pending())
        return replica

    def await_replica_drained(self, rid: str, deadline_s: float,
                              poll_s: float = 0.01) -> bool:
        """Wait until the replica answered everything it admitted (queue
        empty, nothing mid-flush) or the deadline passes; True when
        drained."""
        replica = self._replica(rid)
        deadline = time.monotonic() + max(deadline_s, 0.0)
        while time.monotonic() < deadline:
            if (replica.engine.pending(), replica.engine.in_flight) == (0, 0):
                return True
            time.sleep(poll_s)
        return (replica.engine.pending(), replica.engine.in_flight) == (0, 0)

    def restore_replica(self, rid: str) -> Replica:
        """Bring a drained replica back into rotation, with the buckets it
        warmed (no compile)."""
        replica = self._replica(rid)
        replica.engine.lame_duck = False
        replica.engine.batcher.set_drain_mode(False)
        telemetry.event("fleet.replica_restore", replica=rid)
        return replica

    def roll_replica(self, rid: str, deadline_s: float = 30.0) -> bool:
        """Drain, wait, restore, in one call; True when the replica
        drained within ``deadline_s``."""
        self.begin_replica_drain(rid)
        drained = self.await_replica_drained(rid, deadline_s)
        self.restore_replica(rid)
        return drained

    def _replica(self, rid: str) -> Replica:
        for r in self.replicas:
            if r.rid == rid:
                return r
        raise KeyError(f"no replica {rid!r} "
                       f"(fleet: {[r.rid for r in self.replicas]})")

    # -- observability -----------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """The ``/metrics`` body: the single engine's keys (counters
        summed, ``compiles_after_warmup`` and ``graph_pool_bytes`` too,
        latency quantiles over the pooled windows, rates recomputed,
        padding cells merged) plus ``n_replicas`` and each replica's own
        snapshot with its drain state under ``replicas``."""
        per: Dict[str, Dict[str, Any]] = {}
        out: Dict[str, Any] = {name: 0 for name in ServingStats.COUNTERS}
        used = slots = depth = 0
        pools: List[np.ndarray] = []
        for r in self.replicas:
            snap = r.engine.snapshot()
            snap["lame_duck"] = r.lame_duck
            snap["in_flight"] = r.engine.in_flight
            per[r.rid] = snap
            for name in ServingStats.COUNTERS:
                out[name] += snap[name]
            used += r.engine.stats.occupancy_used
            slots += r.engine.stats.occupancy_slots
            depth += r.engine.pending()
            pools.append(r.engine.stats.latencies_ms)
        lat = np.concatenate(pools)
        looked = out["cache_hits"] + out["cache_misses"]
        out.update(
            compiles_after_warmup=self.compiles_after_warmup,
            graph_pool_bytes=sum(snap["graph_pool_bytes"]
                                 for snap in per.values()),
            queue_depth=depth,
            batch_occupancy=(used / slots) if slots else 0.0,
            cache_hit_rate=(out["cache_hits"] / looked) if looked else 0.0,
            latency_p50_ms=latency_quantile(lat, 0.50),
            latency_p99_ms=latency_quantile(lat, 0.99),
            latency_samples=int(lat.size),
            padding_waste_pct=round(100.0 * (1.0 - used / slots), 4)
            if slots else 0.0,
            n_replicas=len(self.replicas),
            replicas=per,
        )
        padding = merge_padding_cells(
            snap.get("padding_waste") for snap in per.values())
        if padding:
            out["padding_waste"] = padding
            e_used = sum(c.get("elems_used", 0) for c in padding.values())
            e_budget = sum(c.get("elems_budget", 0)
                           for c in padding.values())
            if e_budget:
                out["elem_waste_pct"] = round(
                    100.0 * (1.0 - e_used / e_budget), 4)
        return out

    def health(self) -> Dict[str, Any]:
        """The fleet's part of ``/healthz``: size, live count and each
        replica's rotation state (the server maps some replicas draining
        to "degraded")."""
        return {
            "size": len(self.replicas),
            "live": len(self.live),
            "replicas": {
                r.rid: {
                    "status": "draining" if r.lame_duck else "ok",
                    "pending": r.engine.pending(),
                    "in_flight": r.engine.in_flight,
                    "warm_buckets": r.engine.n_warm,
                }
                for r in self.replicas
            },
        }
