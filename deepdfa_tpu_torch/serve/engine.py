"""The serving engine, GNN lane (port of ``deepdfa_tpu/serve/engine.py``).

Requests are validated at admission (the reference's contract and 400
messages), answered from a content-hash LRU when they repeat, and
otherwise queued per lane and flushed as padded micro-batches on the
bucket ladder of ``ServeConfig``. Each flush packs its graphs on the
host, moves the batch to the engine's device, runs the model under
``torch.inference_mode`` and brings the probabilities back in one
transfer. A flush that raises fails only its own requests (flush
isolation); the queue keeps draining.

Time comes from an injected ``clock`` (monotonic seconds); virtual
clocks exposing ``advance(dt)`` are advanced by each flush's measured
time, as in the reference. The combined and gen lanes, fleet, policy,
HTTP transport, telemetry spans and fault-injection hooks are not ported
yet.
"""

from __future__ import annotations

import itertools
import logging
import time
from typing import Callable, Dict, List, Mapping, Optional, Sequence

import torch

from deepdfa_tpu_torch.contracts.schema import ContractError, validate_example
from deepdfa_tpu_torch.core.device import DeviceLike, resolve_device
from deepdfa_tpu_torch.core.metrics import ServingStats
from deepdfa_tpu_torch.graphs.batch import GraphBatch, batch_graphs
from deepdfa_tpu_torch.models.flowgnn import FlowGNN
from deepdfa_tpu_torch.models.infer import make_gnn_infer
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

LANE = "gnn"


class BadRequestError(Exception):
    """Malformed scoring payload (missing subkeys, out-of-range edges)."""


def bucket_batch(config: ServeConfig, graphs: Sequence[Mapping], slots: int,
                 subkeys: Sequence[str], band: bool = False) -> GraphBatch:
    """Pack ``graphs`` into the ``slots``-slot bucket shape on the host —
    the one constructor for warmup and live batches alike."""
    budget = config.budget_for(slots, tile=DEFAULT_TILE if band else None)
    return batch_graphs(
        graphs, slots, budget["max_nodes"], budget["max_edges"], subkeys,
        build_band_adj=band,
        band_bandwidth=config.band_bandwidth if band else None)


class ServeEngine:
    """Model-to-responses inference engine for the GNN lane.

    ``gnn_model``: a FlowGNN classifier (label_style "graph"); it is moved
    to ``device`` (default ``cuda``; raises without CUDA unless "cpu" is
    asked for). ``submit`` may run on several threads; ``pump``/``drain``
    on one.
    """

    def __init__(self, gnn_model: FlowGNN, config: Optional[ServeConfig] = None,
                 clock: Callable[[], float] = time.monotonic,
                 device: DeviceLike = None):
        self.config = config or ServeConfig()
        self.device = resolve_device(device)
        graph_cfg = gnn_model.config
        if graph_cfg.message_impl not in ("segment", "band", "fused",
                                          "persistent"):
            raise ValueError(
                f"serving supports message_impl 'segment', 'band', 'fused' "
                f"or 'persistent', got {graph_cfg.message_impl!r}")
        self.model = gnn_model.to(self.device)
        self._infer = make_gnn_infer(self.model)
        self._subkeys = list(gnn_model.subkeys)
        self._band = graph_cfg.uses_band_adj
        self.stats = ServingStats(self.config.latency_window)
        self.cache = ResultCache(self.config.cache_capacity)
        self._clock = clock
        self._rid = itertools.count()
        self.batcher = MicroBatcher(self.config, lanes=(LANE,))

    @property
    def required_subkeys(self) -> List[str]:
        return sorted(self._subkeys)

    # -- buckets -----------------------------------------------------------

    def warmup(self) -> int:
        """Run every slot bucket once on an empty batch, so the kernel
        library is built and loaded before the first request; returns the
        number of buckets warmed."""
        for slots in self.config.slot_buckets:
            self._infer(self._graph_batch([], slots))
            self.stats.bump("compiles")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return len(self.config.slot_buckets)

    def _graph_batch(self, graphs: Sequence[Mapping], slots: int) -> GraphBatch:
        gb = bucket_batch(self.config, graphs, slots, self._subkeys,
                          band=self._band)
        return gb.to(self.device)

    # -- admission ---------------------------------------------------------

    def _normalize_graph(self, graph: Mapping) -> Dict:
        try:
            return validate_example(graph, self.required_subkeys,
                                    boundary="serve")
        except ContractError as e:
            raise BadRequestError(str(e))

    def submit(self, graph: Mapping,
               deadline_ms: Optional[float] = None) -> ServeRequest:
        """Admit one scoring request. Cache hits complete at once; misses
        enqueue for the next micro-batch. Raises BadRequestError /
        OversizedError / RejectedError (HTTP 400 / 413 / 429)."""
        now = self._clock()
        self.stats.bump("submitted")
        deadline_s = (deadline_ms if deadline_ms is not None
                      else self.config.deadline_ms) / 1000.0
        norm = self._normalize_graph(graph)
        req = ServeRequest(rid=next(self._rid), key=content_hash(norm),
                           graph=norm, lane=LANE, arrival=now,
                           deadline_s=deadline_s)
        cached = self.cache.get(req.key)
        if cached is not None:
            self.stats.bump("cache_hits")
            self.stats.bump("completed")
            self.stats.observe_latency(0.0)
            req.completed_at = now
            req.finish(dict(cached, rid=req.rid, cached=True, degraded=False))
            return req
        try:
            self.batcher.admit(req)
        except OversizedError:
            self.stats.bump("oversized")
            raise
        except RejectedError:
            self.stats.bump("rejected")
            raise
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
                self._run_batch(reqs)
                n += 1
        return n

    def drain(self) -> int:
        """Flush everything pending regardless of deadlines."""
        n = 0
        while self.batcher.depth():
            reqs = self.batcher.take(LANE)
            if reqs:
                self._run_batch(reqs)
                n += 1
        return n

    def pending(self) -> int:
        return self.batcher.depth()

    def next_flush_time(self) -> Optional[float]:
        return self.batcher.next_flush_time(self._clock())

    def _run_batch(self, reqs: List[ServeRequest]) -> None:
        slots = self.config.bucket_for(len(reqs))
        w0 = time.perf_counter()
        budget = self.config.budget_for(
            slots, tile=DEFAULT_TILE if self._band else None)
        e_used = sum(int(r.graph["num_nodes"]) for r in reqs)
        try:
            gb = self._graph_batch([r.graph for r in reqs], slots)
            # One host transfer per micro-batch (it is also the flush's
            # device barrier).
            p = self._infer(gb).cpu().numpy()
            values = [{"prob": float(p[i]), "model": LANE}
                      for i in range(len(reqs))]
        except Exception as e:
            # Flush isolation: this micro-batch's requests fail (HTTP 500
            # class); the queue keeps draining.
            logger.exception("micro-batch failed (%d requests)", len(reqs))
            self.stats.bump("failures", by=len(reqs))
            detail = f"{type(e).__name__}: {e}"
            for r in reqs:
                r.finish({"rid": r.rid, "error": "internal", "detail": detail,
                          "cached": False, "degraded": False})
            return
        elapsed = time.perf_counter() - w0
        advance = getattr(self._clock, "advance", None)
        if advance is not None:
            advance(elapsed)
        done = self._clock()
        self.stats.record_batch(len(reqs), slots, lane=LANE,
                                elems_used=e_used,
                                elems_per_slot=self.config.max_nodes_per_graph,
                                elems_budget=budget["max_nodes"])
        for r, value in zip(reqs, values):
            self.cache.put(r.key, value)
            r.completed_at = done
            r.finish(dict(value, rid=r.rid, cached=False, degraded=False))
            self.stats.bump("completed")
            self.stats.observe_latency(done - r.arrival)

    # -- offline client ----------------------------------------------------

    def score_sync(self, graphs: Sequence[Mapping]) -> List[Dict]:
        """Score a list of functions through the full serving path (cache
        + batcher + bucketed execution), results in submission order.
        Backpressure drains and retries; per-function admission failures
        come back inline as ``{"error", "detail"}``."""
        out: List[Optional[ServeRequest]] = []
        errors: Dict[int, Dict] = {}
        for i, graph in enumerate(graphs):
            try:
                out.append(self.submit(graph))
            except RejectedError:
                self.drain()
                out.append(self.submit(graph))
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
