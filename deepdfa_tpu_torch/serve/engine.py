"""The serving engine, graph and combined lanes (port of
``deepdfa_tpu/serve/engine.py``).

Requests are validated at admission (the reference's contract and 400
messages), answered from a content-hash LRU when they repeat, and
otherwise queued per lane and flushed as padded micro-batches on the
bucket ladder of ``ServeConfig``. Two lanes:

- ``gnn``: a FlowGNN classifier scores the graph;
- ``combined``: DeepDFA+LineVul scores the graph and the function's
  source together (a request that carries ``code`` when the engine has a
  combined model). When the tokenizer fails on a request's code, the
  request degrades to the ``gnn`` lane and its answer says
  ``degraded``.

Each flush packs its graphs on the host, moves the batch to the engine's
device, runs the lane's model under ``torch.inference_mode`` and brings
the probabilities back in one transfer. A flush that raises fails only
its own requests (flush isolation); the queue keeps draining.

Warmup runs every (lane, slot bucket) pair once, so every kernel library
is built and loaded before the first request. ``stats.compiles`` counts
warmed pairs, and also a flush of a pair warmup did not run: after
warmup it must not move (``compiles_after_warmup`` stays 0).

Time comes from an injected ``clock`` (monotonic seconds). A clock with
``flush_done(dt)`` (a fleet replay's replica timeline) takes each
flush's measured time and returns its completion time; otherwise a
virtual clock exposing ``advance(dt)`` is advanced by it, as in the
reference. In a fleet (``serve/fleet.py``) an engine carries its
``replica`` id, its adaptive flush ``policy`` (driven from ``pump``), the
requests of the flush it is running (``in_flight``, the router's busy
signal) and its lame-duck state. The gen lane, telemetry spans and
fault-injection hooks are not ported yet.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import time
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Set, \
    Tuple

import numpy as np
import torch

from deepdfa_tpu_torch.contracts.schema import ContractError, validate_example
from deepdfa_tpu_torch.core.config import subkeys_for
from deepdfa_tpu_torch.core.device import DeviceLike, resolve_device
from deepdfa_tpu_torch.core.metrics import ServingStats
from deepdfa_tpu_torch.graphs.batch import GraphBatch, batch_graphs
from deepdfa_tpu_torch.models.flowgnn import FlowGNN
from deepdfa_tpu_torch.models.infer import make_combined_infer, make_gnn_infer
from deepdfa_tpu_torch.ops.tile_spmm import DEFAULT_TILE
from deepdfa_tpu_torch.serve.batcher import (
    MicroBatcher,
    OversizedError,
    RejectedError,
    ServeRequest,
)
from deepdfa_tpu_torch.serve.cache import ResultCache, content_hash
from deepdfa_tpu_torch.serve.config import ServeConfig

logger = logging.getLogger(__name__)


class BadRequestError(Exception):
    """Malformed scoring payload (missing subkeys, out-of-range edges)."""


@dataclasses.dataclass
class _Lane:
    subkeys: Sequence[str]
    band: bool  # uses_band_adj: banded adjacency, tile-aligned budgets


def bucket_batch(config: ServeConfig, graphs: Sequence[Mapping], slots: int,
                 subkeys: Sequence[str], band: bool = False) -> GraphBatch:
    """Pack ``graphs`` into the ``slots``-slot bucket shape on the host —
    the one constructor for warmup and live batches alike."""
    budget = config.budget_for(slots, tile=DEFAULT_TILE if band else None)
    return batch_graphs(
        graphs, slots, budget["max_nodes"], budget["max_edges"], subkeys,
        build_band_adj=band,
        band_bandwidth=config.band_bandwidth if band else None)


def _make_lane(graph_cfg) -> _Lane:
    if graph_cfg.message_impl not in ("segment", "band", "fused",
                                      "persistent"):
        raise ValueError(
            f"serving supports message_impl 'segment', 'band', 'fused' "
            f"or 'persistent', got {graph_cfg.message_impl!r}")
    return _Lane(subkeys_for(graph_cfg.feature),
                 band=graph_cfg.uses_band_adj)


class ServeEngine:
    """Model-to-responses inference engine.

    ``gnn_model``: a FlowGNN classifier (label_style "graph"), always
    present: the graph-only lane and the degradation target.
    ``combined_model`` (a ``LineVul`` with a graph encoder) and
    ``tokenizer``: the DeepDFA+LineVul lane for requests that carry
    source code. The models move to ``device`` (default ``cuda``; raises
    without CUDA unless "cpu" is asked for). ``replica``: the engine's id
    in a fleet (one of ``REPLICA_IDS``); ``policy``: its adaptive flush
    controller. ``submit`` may run on several threads; ``pump``/``drain``
    on one.
    """

    def __init__(self, gnn_model: FlowGNN, config: Optional[ServeConfig] = None,
                 clock: Callable[[], float] = time.monotonic,
                 device: DeviceLike = None, combined_model=None,
                 tokenizer=None, replica: Optional[str] = None,
                 policy=None):
        self.config = config or ServeConfig()
        self.replica = replica
        self.policy = policy
        # Requests of the flush now running (the router reads it to send
        # arrivals to a replica that is not mid-flush).
        self.in_flight = 0
        # Lame duck (enter_lame_duck): the batcher flushes at once and the
        # fleet's router stops choosing this engine.
        self.lame_duck = False
        self.device = resolve_device(device)
        self.model = gnn_model.to(self.device)
        self._infer = make_gnn_infer(self.model)
        self._lanes: Dict[str, _Lane] = {
            "gnn": _make_lane(gnn_model.config)}
        self.combined_model = None
        self.tokenizer = tokenizer
        if combined_model is not None:
            if tokenizer is None:
                raise ValueError("combined serving needs a tokenizer")
            self.combined_model = combined_model.to(self.device)
            self._combined_infer = make_combined_infer(self.combined_model)
            self._lanes["combined"] = _make_lane(combined_model.graph_config)
        self.stats = ServingStats(self.config.latency_window)
        self.cache = ResultCache(self.config.cache_capacity)
        self._clock = clock
        self._rid = itertools.count()
        self._warm: Set[Tuple[str, int]] = set()
        # Compile count at the end of warmup(): the baseline of
        # compiles_after_warmup (None until warmed).
        self.warmup_compiles: Optional[int] = None
        self.batcher = MicroBatcher(self.config, lanes=tuple(self._lanes))

    def now(self) -> float:
        return self._clock()

    @property
    def clock(self) -> Callable[[], float]:
        """The injected clock (the fleet replay reads its timelines)."""
        return self._clock

    @property
    def required_subkeys(self) -> List[str]:
        """The union of every lane's feature subkeys: the feats a request
        graph must carry."""
        return sorted({k for lane in self._lanes.values()
                       for k in lane.subkeys})

    # -- buckets -----------------------------------------------------------

    @property
    def n_warm(self) -> int:
        """(lane, slot bucket) pairs run so far."""
        return len(self._warm)

    def warm_buckets(self) -> List[Tuple[str, int]]:
        return [(lane, slots) for lane in self._lanes
                for slots in self.config.slot_buckets]

    def warmup(self) -> int:
        """Run every (lane, slot bucket) pair not yet run once, on an
        empty batch, so each kernel library is built and loaded before
        the first request; returns the pairs run now (0 when already
        warm)."""
        before = self.stats.compiles
        for lane, slots in self.warm_buckets():
            if (lane, slots) in self._warm:
                continue
            self._execute(lane, [], slots)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.warmup_compiles = self.stats.compiles
        return self.stats.compiles - before

    @property
    def compiles_after_warmup(self) -> Optional[int]:
        """Pairs first run after warmup() (must stay 0); None before."""
        if self.warmup_compiles is None:
            return None
        return self.stats.compiles - self.warmup_compiles

    def _graph_batch(self, lane: _Lane, graphs: Sequence[Mapping],
                     slots: int) -> GraphBatch:
        gb = bucket_batch(self.config, graphs, slots, lane.subkeys,
                          band=lane.band)
        return gb.to(self.device)

    def _execute(self, lane_name: str, reqs: Sequence[ServeRequest],
                 slots: int) -> torch.Tensor:
        """One lane's forward over ``reqs`` packed in the ``slots``-slot
        bucket: per-slot probabilities on the device. The first run of a
        (lane, bucket) pair counts as a compile."""
        lane = self._lanes[lane_name]
        gb = self._graph_batch(lane, [r.graph for r in reqs], slots)
        if lane_name == "combined":
            ids = np.full((slots, self.config.block_size),
                          int(self.tokenizer.pad_token_id), np.int32)
            for i, r in enumerate(reqs):
                ids[i] = r.input_ids
            probs = self._combined_infer(
                torch.from_numpy(ids).to(self.device), gb)
        else:
            probs = self._infer(gb)
        if (lane_name, slots) not in self._warm:
            self._warm.add((lane_name, slots))
            self.stats.bump("compiles")
        return probs

    # -- admission ---------------------------------------------------------

    def _normalize_graph(self, graph: Mapping) -> Dict:
        try:
            return validate_example(graph, self.required_subkeys,
                                    boundary="serve")
        except ContractError as e:
            raise BadRequestError(str(e))

    def submit(self, graph: Optional[Mapping], code: Optional[str] = None,
               deadline_ms: Optional[float] = None,
               lane: Optional[str] = None) -> ServeRequest:
        """Admit one scoring request. A request with ``code`` rides the
        combined lane when the engine has one (the ``gnn`` lane, flagged
        ``degraded``, when the tokenizer fails on it); ``lane`` must be
        omitted (the gen lane is not ported). Cache hits complete at
        once; misses enqueue for the next micro-batch. Raises
        BadRequestError / OversizedError / RejectedError (HTTP 400 / 413
        / 429)."""
        now = self._clock()
        self.stats.bump("submitted")
        deadline_s = (deadline_ms if deadline_ms is not None
                      else self.config.deadline_ms) / 1000.0
        if lane == "gen":
            raise BadRequestError(
                "lane 'gen': no generation lane attached (the gen lane is "
                "not ported)")
        if lane is not None:
            raise BadRequestError(
                f"unknown lane {lane!r} (expected 'gen' or omitted)")
        norm = self._normalize_graph(graph)
        lane, input_ids, degraded = "gnn", None, False
        if code is not None and "combined" in self._lanes:
            try:
                from deepdfa_tpu_torch.data.text import encode_function

                input_ids = encode_function(code, self.tokenizer,
                                            self.config.block_size)
                lane = "combined"
            except Exception:
                # The tokenizer is down for this payload: degrade to the
                # graph-only lane rather than fail the request.
                logger.warning("tokenizer failed; degrading to gnn lane",
                               exc_info=True)
                degraded = True
                self.stats.bump("degraded")
        req = ServeRequest(
            rid=next(self._rid),
            key=content_hash(norm, code if lane == "combined" else None),
            graph=norm, lane=lane, arrival=now, deadline_s=deadline_s,
            input_ids=input_ids, degraded=degraded)
        cached = self.cache.get(req.key)
        if cached is not None:
            self.stats.bump("cache_hits")
            self.stats.bump("completed")
            self.stats.observe_latency(0.0)
            req.completed_at = now
            req.finish(dict(cached, rid=req.rid, cached=True,
                            degraded=req.degraded))
            return req
        try:
            self.batcher.admit(req)
        except OversizedError:
            self.stats.bump("oversized")
            raise
        except RejectedError:
            self.stats.bump("rejected")
            raise
        # Counted for admitted requests only: a rejected submission that
        # is retried must not count twice.
        self.stats.bump("cache_misses")
        return req

    # -- execution ---------------------------------------------------------

    def pump(self, max_batches: Optional[int] = None) -> int:
        """Flush every lane currently due; returns micro-batches run."""
        n = 0
        while max_batches is None or n < max_batches:
            lane = self.batcher.due(self._clock())
            if lane is None:
                break
            reqs = self.batcher.take(lane)
            if reqs:
                self._run_batch(lane, reqs)
                n += 1
        if self.policy is not None:
            # Rate-limited inside, on the engine clock, so a replayed
            # policy decides the same way every run.
            self.policy.maybe_update(self)
        return n

    def drain(self) -> int:
        """Flush everything pending regardless of deadlines."""
        n = 0
        while self.batcher.depth():
            for lane in self.batcher.lanes:
                reqs = self.batcher.take(lane)
                if reqs:
                    self._run_batch(lane, reqs)
                    n += 1
        return n

    def pending(self) -> int:
        return self.batcher.depth()

    def load(self) -> int:
        """Queued and in-flight requests: the fleet router's load signal."""
        return self.batcher.depth() + self.in_flight

    def enter_lame_duck(self) -> None:
        """Flush partially filled buckets at once from now on, so the pump
        answers every admitted request as fast as the device allows (the
        fleet stops routing here). Idempotent."""
        if not self.lame_duck:
            self.lame_duck = True
            self.batcher.set_drain_mode(True)

    def next_flush_time(self) -> Optional[float]:
        return self.batcher.next_flush_time(self._clock())

    def _run_batch(self, lane_name: str, reqs: List[ServeRequest]) -> None:
        slots = self.config.bucket_for(len(reqs))
        w0 = time.perf_counter()
        band = self._lanes[lane_name].band
        budget = self.config.budget_for(
            slots, tile=DEFAULT_TILE if band else None)
        e_used = sum(int(r.graph["num_nodes"]) for r in reqs)
        self.in_flight = len(reqs)
        try:
            # One host transfer per micro-batch (it is also the flush's
            # device barrier).
            p = self._execute(lane_name, reqs, slots).cpu().numpy()
            values = [{"prob": float(p[i]), "model": lane_name}
                      for i in range(len(reqs))]
        except Exception as e:
            # Flush isolation: this micro-batch's requests fail (HTTP 500
            # class); the queue keeps draining.
            self.in_flight = 0
            logger.exception("micro-batch failed (%s lane, %d requests)",
                             lane_name, len(reqs))
            self.stats.bump("failures", by=len(reqs))
            detail = f"{type(e).__name__}: {e}"
            for r in reqs:
                r.finish({"rid": r.rid, "error": "internal", "detail": detail,
                          "cached": False, "degraded": r.degraded})
            return
        elapsed = time.perf_counter() - w0
        flush_done = getattr(self._clock, "flush_done", None)
        if flush_done is not None:
            # A replica timeline: the flush runs on this replica's own
            # busy horizon, so N replicas' flushes overlap in the replay.
            done = flush_done(elapsed)
        else:
            advance = getattr(self._clock, "advance", None)
            if advance is not None:
                advance(elapsed)
            done = self._clock()
        self.in_flight = 0
        self.stats.record_batch(len(reqs), slots, lane=lane_name,
                                elems_used=e_used,
                                elems_per_slot=self.config.max_nodes_per_graph,
                                elems_budget=budget["max_nodes"])
        for r, value in zip(reqs, values):
            # The cache line holds content-derived values only; "degraded"
            # describes this request's handling, not the content.
            self.cache.put(r.key, value)
            r.completed_at = done
            r.finish(dict(value, rid=r.rid, cached=False,
                          degraded=r.degraded))
            self.stats.bump("completed")
            self.stats.observe_latency(done - r.arrival)

    # -- offline client ----------------------------------------------------

    def score_sync(self, graphs: Sequence[Mapping],
                   codes: Optional[Sequence[Optional[str]]] = None
                   ) -> List[Dict]:
        """Score a list of functions through the full serving path (cache
        + batcher + bucketed execution), results in submission order;
        ``codes[i]`` sends function i's source to the combined lane.
        Backpressure drains and retries; per-function admission failures
        come back inline as ``{"error", "detail"}``."""
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

    def snapshot(self) -> Dict[str, float]:
        return self.stats.snapshot(queue_depth=self.batcher.depth())
