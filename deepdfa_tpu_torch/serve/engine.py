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

Each (lane, slot bucket) pair owns a program: a resident device batch
(every field of its ``GraphBatch``, and on the combined lane the
``input_ids`` block, as views of one device buffer, staged through one
pinned host buffer) and, on a CUDA device, a CUDA graph of the lane's
forward over it (the counterpart of the reference's AOT executable). A
flush packs its graphs on the host, copies every field whole into the
pair's host buffer and on in one transfer (a flush of fewer graphs than
the last leaves no stale slot, node, edge or row group), replays the
graph on the engine's own stream and brings the probabilities back in
one transfer. On the CPU the same buffers run the forward eagerly. A
flush that raises fails only its own requests (flush isolation); the
queue keeps draining.

Warmup builds every pair's program, largest bucket first: one eager run
on its buffers, so every kernel library is built and every module
loaded, then the capture under ``torch.inference_mode`` into a memory
pool the engine's pairs share. A band batch whose values need f32 (an
edge repeated more than 256 times) is a pair of its own, captured at its
first flush: it is never rounded into the bf16 pair's buffer.
``stats.compiles`` counts programs built, one a capture, as the
reference counts one a compile, and also those a flush builds after
warmup: ``compiles_after_warmup`` must stay 0. A capture that fails
raises, naming the lane, the bucket and the op; no flush runs eagerly in
its place. The launch counts (``ops.launch_counts``) and
``FlowGNN.over_gate_dispatches`` move by what one capture queued at
every replay.

Time comes from an injected ``clock`` (monotonic seconds). A clock with
``flush_done(dt)`` (a fleet replay's replica timeline) takes each
flush's measured time and returns its completion time; otherwise a
virtual clock exposing ``advance(dt)`` is advanced by it, as in the
reference. In a fleet (``serve/fleet.py``) an engine carries its
``replica`` id, its adaptive flush ``policy`` (driven from ``pump``), the
requests of the flush it is running (``in_flight``, the router's busy
signal) and its lame-duck state.

Telemetry (``deepdfa_tpu_torch/telemetry``) sees what the reference's
engine shows: a ``serve.compile`` span around each program built (its
fence after the capture ends), ``serve.warmup_done``, the raw node and
edge counts of each admitted graph (``observe_shape``), a ``serve.flush``
span a micro-batch (lane, n, slots, ordinal, elems, elems_slot,
elems_budget, the batcher's seal cause, the replica), whose fence is
the probabilities' host copy (no device event), and a ``serve.request``
span a request with its trace id; ``lifecycle.lame_duck`` when the
engine leaves rotation. The ``serve.batch`` fault site fires on the host before
each flush's replay: a raise there fails that flush alone. The gen lane
is not ported yet.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import logging
import os
import time
import traceback
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Set, \
    Tuple

import numpy as np
import torch

from deepdfa_tpu_torch import telemetry
from deepdfa_tpu_torch.contracts.schema import (
    STATS,
    ContractError,
    validate_example,
)
from deepdfa_tpu_torch.core.config import subkeys_for
from deepdfa_tpu_torch.core.device import DeviceLike, resolve_device
from deepdfa_tpu_torch.core.metrics import ServingStats
from deepdfa_tpu_torch.graphs.batch import GraphBatch, batch_graphs
from deepdfa_tpu_torch.models.flowgnn import FlowGNN
from deepdfa_tpu_torch.models.infer import make_combined_infer, make_gnn_infer
from deepdfa_tpu_torch.ops import add_launches, recording_launches
from deepdfa_tpu_torch.ops.band_spmm import pad_row_groups
from deepdfa_tpu_torch.ops.tile_spmm import DEFAULT_TILE
from deepdfa_tpu_torch.resilience import inject
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
    the one constructor for warmup and live batches alike. A band batch's
    row-group cut points are padded to the bucket's bound with empty
    trailing groups, and its ``max_group_rows`` is the bound's
    (``ServeConfig.group_bound``): every batch of the bucket launches the
    persistent forward with one grid, one shared-memory size and one gate
    decision. Raises ValueError when a group of the batch is larger than
    the bound (a graph over ``max_nodes_per_graph``: admission turns
    those away first)."""
    budget = config.budget_for(slots, tile=DEFAULT_TILE if band else None)
    gb = batch_graphs(
        graphs, slots, budget["max_nodes"], budget["max_edges"], subkeys,
        build_band_adj=band,
        band_bandwidth=config.band_bandwidth if band else None)
    if band:
        bound = config.group_bound(slots, DEFAULT_TILE)
        adj = gb.band_adj
        if adj.max_group_rows > bound["rows"]:
            raise ValueError(
                f"a row group of {adj.max_group_rows} rows is over the "
                f"{slots}-slot bucket's bound of {bound['rows']} (a graph "
                f"over max_nodes_per_graph "
                f"{config.max_nodes_per_graph})")
        gb.band_adj = dataclasses.replace(
            adj, row_groups=torch.from_numpy(pad_row_groups(
                adj.row_groups.numpy(), bound["groups"])),
            max_group_rows=bound["rows"])
    return gb


class CaptureError(RuntimeError):
    """A (lane, bucket) pair's CUDA graph capture failed."""


#: Byte alignment of each field in a program's staging buffer.
_ALIGN = 256


def _batch_fields(gb: GraphBatch) -> List[Tuple[str, torch.Tensor]]:
    """Every tensor of a serving batch, by name (the band adjacency's
    values and cut points included)."""
    fields = [(f"node_feats.{k}", v) for k, v in sorted(gb.node_feats.items())]
    fields += [(name, getattr(gb, name)) for name in (
        "node_vuln", "senders", "receivers", "node_graph", "node_mask",
        "edge_mask", "graph_mask", "graph_ids")]
    if gb.band_adj is not None:
        fields += [("band_adj.vals", gb.band_adj.vals),
                   ("band_adj.row_groups", gb.band_adj.row_groups)]
    return fields


class _Staged:
    """A pair's resident inputs: each field of its batch (and the
    combined lane's ``input_ids``) a view of one device buffer at a fixed
    offset, filled from one host buffer (pinned on CUDA) in one transfer.
    ``batch`` and ``input_ids`` are the views the forward reads."""

    def __init__(self, template: GraphBatch, ids: Optional[torch.Tensor],
                 device: torch.device):
        fields = _batch_fields(template)
        if ids is not None:
            fields.append(("input_ids", ids))
        # (name, byte offset, shape, dtype, bytes) of each field.
        self.layout: List[Tuple[str, int, torch.Size, torch.dtype, int]] = []
        size = 0
        for name, t in fields:
            nbytes = t.numel() * t.element_size()
            self.layout.append((name, size, t.shape, t.dtype, nbytes))
            size += -(-nbytes // _ALIGN) * _ALIGN
        self.device = device
        self.host = torch.zeros(max(size, _ALIGN), dtype=torch.uint8,
                                pin_memory=device.type == "cuda")
        self.dev = torch.zeros_like(self.host, device=device)
        self.host_views = self._views(self.host)
        views = self._views(self.dev)
        band = template.band_adj
        self.batch = GraphBatch(
            node_feats={k: views[f"node_feats.{k}"]
                        for k in template.node_feats},
            **{name: views[name] for name in (
                "node_vuln", "senders", "receivers", "node_graph",
                "node_mask", "edge_mask", "graph_mask", "graph_ids")},
            band_adj=None if band is None else dataclasses.replace(
                band, vals=views["band_adj.vals"],
                row_groups=views["band_adj.row_groups"]),
            node_graph_sorted=template.node_graph_sorted)
        self.input_ids = views.get("input_ids")
        # Recorded after each transfer; the next stage waits for it.
        self._copied = (torch.cuda.Event() if device.type == "cuda"
                        else None)

    @property
    def nbytes(self) -> int:
        return self.dev.numel()

    def _views(self, buf: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {name: buf[offset:offset + nbytes].view(dtype).view(shape)
                for name, offset, shape, dtype, nbytes in self.layout}

    def stage(self, gb: GraphBatch, ids: Optional[torch.Tensor]) -> None:
        """Copy every field of ``gb`` whole into the host buffer, then the
        buffer to the device on the current stream (asynchronous on
        CUDA: the next stage waits for this copy before it writes)."""
        if self._copied is not None:
            self._copied.synchronize()  # a no-op before the first record
        fields = _batch_fields(gb)
        if ids is not None:
            fields.append(("input_ids", ids))
        if len(fields) != len(self.layout):
            raise ValueError("batch fields do not match the pair's layout")
        if self.batch.node_graph_sorted and not gb.node_graph_sorted:
            # The pair's pooling searches node_graph as it is.
            raise ValueError("the batch's node_graph is not sorted; the "
                             "pair's forward takes it as sorted")
        for name, t in fields:
            view = self.host_views[name]
            if t.shape != view.shape or t.dtype != view.dtype:
                raise ValueError(
                    f"{name}: {tuple(t.shape)} {t.dtype} does not match the "
                    f"pair's {tuple(view.shape)} {view.dtype}")
            view.copy_(t)
        self.dev.copy_(self.host, non_blocking=True)
        if self._copied is not None:
            self._copied.record()


@dataclasses.dataclass
class _Program:
    """One pair's staged inputs and, on CUDA, its captured forward:
    ``out`` the probabilities a replay writes, ``launches`` the counts the
    capture queued (``ops.recording_launches``)."""

    staged: _Staged
    graph: Optional["torch.cuda.CUDAGraph"] = None
    out: Optional[torch.Tensor] = None
    launches: Dict = dataclasses.field(default_factory=dict)


def _failing_op(exc: BaseException) -> str:
    """The innermost frame of the port's code in ``exc``'s traceback
    (where a capture hit an op it cannot capture), as ``function
    (file:line)``."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    frames = [f for f in traceback.extract_tb(exc.__traceback__)
              if os.path.abspath(f.filename).startswith(root)]
    if not frames:
        return "capture_end"
    f = frames[-1]
    return (f"{f.name} ({os.path.relpath(f.filename, os.path.dirname(root))}"
            f":{f.lineno}: {f.line})")


def _pool_bytes(pool, device: torch.device) -> int:
    """Bytes of the caching allocator's segments that belong to the
    graph memory pool ``pool`` on ``device``."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    want = tuple(pool)
    return sum(int(seg["total_size"])
               for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == want
               and seg.get("device", index) == index)


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
        self.stats = ServingStats(self.config.latency_window,
                                  replica=replica)
        self.cache = ResultCache(self.config.cache_capacity)
        self._clock = clock
        self._rid = itertools.count()
        self._flush_ordinal = itertools.count()
        self._warm: Set[Tuple[str, int]] = set()
        # (lane, slots, band value dtype or None) -> its program.
        self._programs: Dict[Tuple, _Program] = {}
        # Compile count at the end of warmup(): the baseline of
        # compiles_after_warmup (None until warmed).
        self.warmup_compiles: Optional[int] = None
        self.batcher = MicroBatcher(self.config, lanes=tuple(self._lanes),
                                    replica=replica)
        # On a card: the engine's own stream (every copy, capture and
        # replay of its flushes) and the memory pool its graphs share.
        self._stream = self._pool = None
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        #: Bytes of the graph memory pool, read after each capture.
        self.graph_pool_bytes = 0

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
        """(lane, slot bucket) pairs with a program."""
        return len(self._warm)

    @property
    def graphs_captured(self) -> int:
        """Programs with a CUDA graph (0 on the CPU)."""
        return sum(p.graph is not None
                   for p in list(self._programs.values()))

    def warm_buckets(self) -> List[Tuple[str, int]]:
        return [(lane, slots) for lane in self._lanes
                for slots in self.config.slot_buckets]

    def warmup(self) -> int:
        """Build every (lane, slot bucket) pair's program not built yet,
        largest bucket first, from an empty batch (on CUDA: one eager run,
        then the capture); returns the programs built now (0 when already
        warm)."""
        before = self.stats.compiles
        for lane, slots in sorted(self.warm_buckets(),
                                  key=lambda pair: -pair[1]):
            gb, ids = self._pack(lane, [], slots)
            with self._on_stream():
                self._program(lane, slots, gb, ids)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        # The trace's warmup marker: a serve.compile span after it is a
        # program built after warmup.
        telemetry.event("serve.warmup_done",
                        warmed=self.stats.compiles - before,
                        buckets=self.n_warm)
        self.warmup_compiles = self.stats.compiles
        if self.graphs_captured:
            logger.info("captured %d CUDA graphs (%s), pool %d bytes",
                        self.graphs_captured, self.replica or "engine",
                        self.graph_pool_bytes)
        return self.stats.compiles - before

    @property
    def compiles_after_warmup(self) -> Optional[int]:
        """Programs first built after warmup() (must stay 0); None
        before."""
        if self.warmup_compiles is None:
            return None
        return self.stats.compiles - self.warmup_compiles

    def _pack(self, lane_name: str, graphs: Sequence[Mapping], slots: int,
              input_ids: Sequence = ()) -> Tuple[GraphBatch,
                                                 Optional[torch.Tensor]]:
        """A flush's inputs on the host: the bucket batch and, on the
        combined lane, the [slots, block_size] token block (pad rows
        past the requests)."""
        lane = self._lanes[lane_name]
        gb = bucket_batch(self.config, graphs, slots, lane.subkeys,
                          band=lane.band)
        ids = None
        if lane_name == "combined":
            block = np.full((slots, self.config.block_size),
                            int(self.tokenizer.pad_token_id), np.int32)
            for i, row in enumerate(input_ids):
                block[i] = row
            ids = torch.from_numpy(block)
        return gb, ids

    @contextlib.contextmanager
    def _on_stream(self):
        """The engine's stream as the current one (CUDA), after the work
        already queued on the caller's (the model's weights)."""
        if self._stream is None:
            yield
            return
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            yield

    def _forward(self, lane_name: str, batch: GraphBatch,
                 ids: Optional[torch.Tensor]) -> torch.Tensor:
        """The lane's forward, eagerly, on device tensors."""
        if lane_name == "combined":
            return self._combined_infer(ids, batch)
        return self._infer(batch)

    def _program(self, lane_name: str, slots: int, gb: GraphBatch,
                 ids: Optional[torch.Tensor]) -> _Program:
        """The pair's program for this batch's band value dtype, built
        first if there is none (counted as a compile): its buffers staged
        with ``gb``, one eager run on them, then on CUDA the capture."""
        key = (lane_name, slots,
               None if gb.band_adj is None else gb.band_adj.vals.dtype)
        prog = self._programs.get(key)
        if prog is not None:
            return prog
        with telemetry.span("serve.compile", lane=lane_name,
                            slots=slots) as sp:
            staged = _Staged(gb, ids, self.device)
            staged.stage(gb, ids)
            prog = _Program(staged)
            out = self._forward(lane_name, staged.batch, staged.input_ids)
            if self._stream is not None:
                self._capture(lane_name, slots, prog)
            # After capture_end: the eager run and the staging copy.
            sp.fence(out)
        self._programs[key] = prog
        self._warm.add((lane_name, slots))
        self.stats.bump("compiles")
        return prog

    def _capture(self, lane_name: str, slots: int, prog: _Program) -> None:
        """Capture the lane's forward over the pair's buffers on the
        engine's stream, in ``thread_local`` error mode (other replicas'
        threads may launch and allocate meanwhile), into the engine's
        pool; record the launch counts it queued. Raises CaptureError
        naming the lane, the bucket and the op."""
        staged = prog.staged
        self._stream.synchronize()
        graph = torch.cuda.CUDAGraph()
        try:
            with recording_launches() as launches, torch.inference_mode():
                graph.capture_begin(pool=self._pool,
                                    capture_error_mode="thread_local")
                try:
                    out = self._forward(lane_name, staged.batch,
                                        staged.input_ids)
                finally:
                    graph.capture_end()
        except Exception as e:
            # After an op the capture refused, capture_end fails too:
            # report the op's exception, which capture_end's replaced.
            if e.__context__ is not None and traceback.extract_tb(
                    e.__traceback__)[-1].name == "capture_end":
                e = e.__context__
            raise CaptureError(
                f"CUDA graph capture of the {lane_name} lane's {slots}-slot "
                f"bucket failed at {_failing_op(e)}: {type(e).__name__}: "
                f"{e}") from e
        prog.graph, prog.out, prog.launches = graph, out, dict(launches)
        self.graph_pool_bytes = _pool_bytes(self._pool, self.device)

    def forward(self, lane_name: str, graphs: Sequence[Mapping], slots: int,
                input_ids: Sequence = (), span=None) -> torch.Tensor:
        """Per-slot probabilities (host float32 [slots]) of ``graphs``
        packed in the ``slots``-slot bucket: the pair's program (built
        first if needed), staged and replayed on the engine's stream.
        ``span`` (a telemetry span) is marked just before their host
        copy, which is its fence."""
        gb, ids = self._pack(lane_name, graphs, slots, input_ids)
        with self._on_stream():
            prog = self._program(lane_name, slots, gb, ids)
            prog.staged.stage(gb, ids)
            if prog.graph is None:
                probs = self._forward(lane_name, prog.staged.batch,
                                      prog.staged.input_ids)
            else:
                prog.graph.replay()
                add_launches(prog.launches)
                probs = prog.out
            if span is not None:
                span.mark()
            # One host transfer per micro-batch (it is also the flush's
            # device barrier), on the engine's stream.
            return probs.cpu()

    def _execute(self, lane_name: str, reqs: Sequence[ServeRequest],
                 slots: int, span=None) -> torch.Tensor:
        """One lane's forward over ``reqs`` packed in the ``slots``-slot
        bucket: per-slot probabilities on the host (:meth:`forward`)."""
        return self.forward(lane_name, [r.graph for r in reqs], slots,
                            [r.input_ids for r in reqs], span=span)

    # -- admission ---------------------------------------------------------

    def _normalize_graph(self, graph: Mapping) -> Dict:
        try:
            return validate_example(graph, self.required_subkeys,
                                    boundary="serve", stats=STATS)
        except ContractError as e:
            raise BadRequestError(str(e))

    def submit(self, graph: Optional[Mapping], code: Optional[str] = None,
               deadline_ms: Optional[float] = None,
               lane: Optional[str] = None,
               trace_id: Optional[str] = None,
               trace_continued: bool = False) -> ServeRequest:
        """Admit one scoring request. A request with ``code`` rides the
        combined lane when the engine has one (the ``gnn`` lane, flagged
        ``degraded``, when the tokenizer fails on it); ``lane`` must be
        omitted (the gen lane is not ported). Cache hits complete at
        once; misses enqueue for the next micro-batch. Raises
        BadRequestError / OversizedError / RejectedError (HTTP 400 / 413
        / 429). ``trace_id``/``trace_continued``: the distributed trace
        the request rides (the HTTP layer continues a client's
        traceparent), carried on its ``serve.request`` span."""
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
        # The raw pre-bucket shape at admission (a fixed series a lane).
        telemetry.observe_shape(f"traffic_shape_serve_{lane}_nodes",
                                int(norm["num_nodes"]))
        telemetry.observe_shape(f"traffic_shape_serve_{lane}_edges",
                                len(norm["senders"]))
        req = ServeRequest(
            rid=next(self._rid),
            key=content_hash(norm, code if lane == "combined" else None),
            graph=norm, lane=lane, arrival=now, deadline_s=deadline_s,
            t_submit=telemetry.now(), input_ids=input_ids,
            trace_id=trace_id, trace_continued=trace_continued,
            degraded=degraded)
        cached = self.cache.get(req.key)
        if cached is not None:
            self.stats.bump("cache_hits")
            self.stats.bump("completed")
            self.stats.observe_latency(0.0)
            req.completed_at = now
            req.finish(dict(cached, rid=req.rid, cached=True,
                            degraded=req.degraded))
            hit_attrs: Dict = dict(rid=req.rid, lane=req.lane, cached=True,
                                   **self._trace_attrs(req))
            if self.replica is not None:
                hit_attrs["replica"] = self.replica
            telemetry.record_span("serve.request", req.t_submit, **hit_attrs)
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
            telemetry.event("lifecycle.lame_duck", pending=self.pending())

    def next_flush_time(self) -> Optional[float]:
        return self.batcher.next_flush_time(self._clock())

    @staticmethod
    def _trace_attrs(req: ServeRequest) -> Dict:
        """The request's trace identity for its span (none untraced)."""
        if req.trace_id is None:
            return {}
        return {"trace_id": req.trace_id,
                "trace_continued": req.trace_continued}

    def _run_batch(self, lane_name: str, reqs: List[ServeRequest]) -> None:
        slots = self.config.bucket_for(len(reqs))
        ordinal = next(self._flush_ordinal)
        w0 = time.perf_counter()
        band = self._lanes[lane_name].band
        budget = self.config.budget_for(
            slots, tile=DEFAULT_TILE if band else None)
        e_used = sum(int(r.graph["num_nodes"]) for r in reqs)
        e_slot = self.config.max_nodes_per_graph
        span_attrs: Dict = dict(lane=lane_name, n=len(reqs), slots=slots,
                                ordinal=ordinal, elems=e_used,
                                elems_slot=e_slot,
                                elems_budget=budget["max_nodes"])
        cause = self.batcher.last_flush_cause(lane_name)
        if cause is not None:
            span_attrs["cause"] = cause
        if self.replica is not None:
            span_attrs["replica"] = self.replica
        self.in_flight = len(reqs)
        try:
            with telemetry.span("serve.flush", **span_attrs) as sp:
                # Fault site (index = flush ordinal), on the host before
                # the replay: a raise stands for a device failure.
                inject.fire("serve.batch", index=ordinal)
                p = self._execute(lane_name, reqs, slots, span=sp).numpy()
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
                telemetry.record_span("serve.request", r.t_submit,
                                      rid=r.rid, lane=lane_name,
                                      cached=False, error=type(e).__name__,
                                      **self._trace_attrs(r))
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
        t_done = telemetry.now()
        self.in_flight = 0
        self.stats.record_batch(len(reqs), slots, lane=lane_name,
                                elems_used=e_used, elems_per_slot=e_slot,
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
            # Admission to response on the telemetry clock (never the
            # engine's virtual one); queue_ms is the wait before the flush.
            req_attrs: Dict = dict(
                rid=r.rid, lane=lane_name, cached=False,
                degraded=r.degraded,
                queue_ms=max(w0 - r.t_submit, 0.0) * 1e3,
                flush_ordinal=ordinal, **self._trace_attrs(r))
            if self.replica is not None:
                req_attrs["replica"] = self.replica
            telemetry.record_span("serve.request", r.t_submit, t_done,
                                  **req_attrs)

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
        """The stats' snapshot plus ``compiles_after_warmup`` and the
        bytes of the engine's graph pool (``graph_pool_bytes``)."""
        return dict(self.stats.snapshot(queue_depth=self.batcher.depth()),
                    compiles_after_warmup=self.compiles_after_warmup,
                    graph_pool_bytes=self.graph_pool_bytes)
