"""The serving engine's static-buffer path (the CPU side of its CUDA
graphs): the serving buckets' static row-group geometry and its bound,
the padded band against the unpadded one, flushes that leave no stale
state in a pair's buffers, compile parity with the JAX engine, the batch
whose band values need f32, the ordered segment sum's index plan, the
launch record a capture keeps, and a failed capture's error."""

import contextlib
import threading

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from torch.utils._python_dispatch import TorchDispatchMode

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from deepdfa_tpu.core.config import FeatureSpec as JFeatureSpec
from deepdfa_tpu.core.config import FlowGNNConfig as JFlowGNNConfig
from deepdfa_tpu.models.flowgnn import FlowGNN as JFlowGNN
from deepdfa_tpu.serve import ServeConfig as JServeConfig
from deepdfa_tpu.serve import ServeEngine as JServeEngine
from deepdfa_tpu.serve.engine import random_gnn_params
from deepdfa_tpu.serve.replay import VirtualClock as JVirtualClock
from deepdfa_tpu.serve.replay import bursty_trace as j_bursty_trace
from deepdfa_tpu.serve.replay import replay as j_replay
from deepdfa_tpu_torch import ops
from deepdfa_tpu_torch.core.config import (
    FeatureSpec,
    FlowGNNConfig,
    subkeys_for,
)
from deepdfa_tpu_torch.data.synthetic import synthetic_bigvul
from deepdfa_tpu_torch.graphs import segment
from deepdfa_tpu_torch.graphs.batch import batch_graphs
from deepdfa_tpu_torch.models.convert import flowgnn_from_flax
from deepdfa_tpu_torch.models.flowgnn import FlowGNN
from deepdfa_tpu_torch.ops import fused_gnn
from deepdfa_tpu_torch.ops.band_spmm import (
    PERSISTENT_GROUP_ROWS,
    closed_group_bound,
    closed_row_groups,
)
from deepdfa_tpu_torch.ops.tile_spmm import DEFAULT_TILE
from deepdfa_tpu_torch.serve import ServeConfig, ServeEngine
from deepdfa_tpu_torch.serve import engine as engine_mod
from deepdfa_tpu_torch.serve.engine import CaptureError, bucket_batch
from deepdfa_tpu_torch.serve.replay import VirtualClock, bursty_trace, replay

LIMITS = dict(limit_all=20, limit_subkeys=20)
MODEL = dict(hidden_dim=4, n_steps=2, num_output_layers=2)
SUBKEYS = list(subkeys_for(FeatureSpec(**LIMITS)))
# The A4 baseline: the port's served probabilities against the JAX
# engine's on the same converted weights (f32 in another order).
JAX_TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    """Exact float comparisons in one intra-op thread (a fresh process's
    first multi-threaded exp can differ in one chunk)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clean(graphs):
    for g in graphs:  # clients send no labels
        for key in ("label", "vuln", "df_in", "df_out", "project"):
            g.pop(key, None)
    return graphs


def _graphs(n, seed, **kw):
    return _clean(synthetic_bigvul(n, FeatureSpec(**LIMITS), seed=seed, **kw))


def _model(impl="persistent", dtype="float32", seed=0):
    return FlowGNN(FlowGNNConfig(feature=FeatureSpec(**LIMITS),
                                 message_impl=impl, dtype=dtype, **MODEL),
                   device="cpu", seed=seed)


def _engines(impl, slots, **config):
    """The JAX engine and the port's on the same converted weights."""
    jmodel = JFlowGNN(JFlowGNNConfig(feature=JFeatureSpec(**LIMITS),
                                     message_impl=impl, **MODEL))
    jcfg = JServeConfig(batch_slots=slots, **config)
    params = random_gnn_params(jmodel, jcfg, seed=3)
    jclock, clock = JVirtualClock(), VirtualClock()
    jeng = JServeEngine(jmodel, params, config=jcfg, clock=jclock)
    model = _model(impl)
    model.load_state_dict(flowgnn_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    peng = ServeEngine(model, ServeConfig(batch_slots=slots, **config),
                       clock=clock, device="cpu")
    return (jeng, jclock), (peng, clock)


# ---------------------------------------------------------------------------
# The bound on a bucket's row groups
# ---------------------------------------------------------------------------


@st.composite
def _bucket(draw):
    """A bucket's worth of graphs, each at most max_nodes_per_graph nodes
    with edges inside it (chains make long closed components, random
    edges the rest)."""
    slots = draw(st.sampled_from([1, 2, 4, 8, 16]))
    max_nodes = draw(st.sampled_from([8, 17, 32, 33, 40, 64, 100]))
    graphs = []
    for gi in range(draw(st.integers(0, slots))):
        n = draw(st.integers(1, max_nodes))
        chain = draw(st.integers(0, n - 1))
        start = draw(st.integers(0, n - 1 - chain))
        s = list(range(start, start + chain))
        r = list(range(start + 1, start + chain + 1))
        for _ in range(draw(st.integers(0, n))):
            a = draw(st.integers(0, n - 1))
            b = draw(st.integers(max(0, a - 3), min(n - 1, a + 3)))
            s.append(a)
            r.append(b)
        graphs.append(dict(
            num_nodes=n, senders=np.asarray(s[:3 * n], np.int32),
            receivers=np.asarray(r[:3 * n], np.int32), vuln=np.zeros(n),
            feats={k: np.zeros(n, np.int32) for k in SUBKEYS}, id=gi))
    return slots, max_nodes, graphs


@settings(max_examples=150, deadline=None)
@given(_bucket())
def test_row_group_bound_holds_for_any_bucket(case):
    slots, max_nodes, graphs = case
    config = ServeConfig(batch_slots=16, max_nodes_per_graph=max_nodes)
    bound = config.group_bound(slots, DEFAULT_TILE)
    budget = config.budget_for(slots, tile=DEFAULT_TILE)
    plain = batch_graphs(graphs, slots, budget["max_nodes"],
                         budget["max_edges"], SUBKEYS, impl="python")
    mask = plain.edge_mask.numpy()
    real = closed_row_groups(plain.senders.numpy()[mask],
                             plain.receivers.numpy()[mask],
                             budget["max_nodes"])
    assert len(real) - 1 <= bound["groups"]
    assert int(np.diff(real).max()) <= bound["rows"]
    padded = bucket_batch(config, graphs, slots, SUBKEYS, band=True).band_adj
    cuts = padded.row_groups.numpy()
    assert len(cuts) == bound["groups"] + 1
    assert np.all(np.diff(cuts) >= 0) and cuts[-1] == budget["max_nodes"]
    np.testing.assert_array_equal(cuts[:len(real)], real)
    assert padded.max_group_rows == bound["rows"]


def test_row_group_bound_is_tight_against_the_greedy_worst_case():
    # One isolated row, then a closed component one row past the target:
    # the greedy cut makes two groups every target + 2 rows, the most any
    # edge set makes; the bound is 2 (n // (target + 1)) + 1.
    t = PERSISTENT_GROUP_ROWS
    n = 4 * (t + 2)
    s, r = [], []
    for base in range(0, n, t + 2):
        s += list(range(base + 1, base + t + 1))
        r += list(range(base + 2, base + t + 2))
    groups = closed_row_groups(np.asarray(s), np.asarray(r), n)
    assert len(groups) - 1 == 8
    assert closed_group_bound(n, t + 1) == (2 * (n // (t + 1)) + 1, t + 1)
    assert len(groups) - 1 <= closed_group_bound(n, t + 1)[0]
    # The serving bucket: 63 groups of up to 64 rows at 16 slots.
    assert ServeConfig().group_bound(16, DEFAULT_TILE) == {"groups": 63,
                                                           "rows": 64}


@pytest.mark.parametrize("n", [40, 41, 60])
def test_bucket_batch_refuses_a_group_over_the_bound(n):
    """A graph over max_nodes_per_graph that reaches bucket_batch without
    admission (a chain of ``n`` rows: one closed component) would make a
    group larger than the rows the bucket's kernel is sized for:
    bucket_batch raises, naming the bound, unless the group fits."""
    config = ServeConfig(batch_slots=2, max_nodes_per_graph=40)
    bound = config.group_bound(2, DEFAULT_TILE)
    assert bound["rows"] == 40
    graph = dict(num_nodes=n, senders=np.arange(n - 1, dtype=np.int32),
                 receivers=np.arange(1, n, dtype=np.int32),
                 vuln=np.zeros(n),
                 feats={k: np.zeros(n, np.int32) for k in SUBKEYS}, id=0)
    if n <= bound["rows"]:
        adj = bucket_batch(config, [graph], 2, SUBKEYS, band=True).band_adj
        assert adj.max_group_rows == bound["rows"]
        return
    with pytest.raises(ValueError, match="bound of 40"):
        bucket_batch(config, [graph], 2, SUBKEYS, band=True)
    # Without the band layout there is no group to bound.
    bucket_batch(config, [graph], 2, SUBKEYS, band=False)


def test_step_plan_depends_on_the_row_count_alone():
    # The per-step kernels' launch (grid, tile, cluster) comes from
    # n_rows, hidden and the SM count: a bucket's rows are static, so is
    # its launch.
    for kernel in ("fused_step_kernel", "fused_step_kernel_bf16"):
        plans = {str(fused_gnn.step_plan(1024, 128, 132, kernel))
                 for _ in range(3)}
        assert len(plans) == 1


# ---------------------------------------------------------------------------
# The padded band against the unpadded one
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["persistent", "fused", "band"])
def test_flowgnn_on_the_padded_band_equals_the_unpadded(impl, dtype):
    config = ServeConfig(batch_slots=8)
    graphs = synthetic_bigvul(7, FeatureSpec(**LIMITS), seed=5)
    padded = bucket_batch(config, graphs, 8, SUBKEYS, band=True)
    budget = config.budget_for(8, tile=DEFAULT_TILE)
    plain = batch_graphs(graphs, 8, budget["max_nodes"], budget["max_edges"],
                         SUBKEYS, build_band_adj=True,
                         band_bandwidth=config.band_bandwidth)
    assert padded.band_adj.row_groups.numel() > plain.band_adj.row_groups.numel()
    model = _model(impl, dtype)
    with torch.inference_mode():
        got, want = model(padded), model(plain)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# No stale state; compile parity with the JAX engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["persistent", "segment"])
def test_partial_flush_after_a_full_one_leaves_no_stale_state(impl):
    (jeng, _), (peng, _) = _engines(impl, slots=16)
    full, partial = _graphs(16, seed=7), _graphs(3, seed=8)
    answers = jeng.score_sync(partial)
    # forward() takes graphs as admission leaves them.
    full, partial = ([peng._normalize_graph(g) for g in gs]
                     for gs in (full, partial))
    peng.warmup()
    first = peng.forward("gnn", full, 16)
    got = peng.forward("gnn", partial, 16)
    # The pair's buffers hold the partial batch whole: nothing of the
    # full one's slots, nodes, edges or row groups is left.
    staged = peng._programs[("gnn", 16, _vals_dtype(peng))].staged
    fresh = bucket_batch(peng.config, partial, 16, peng.required_subkeys,
                         band=impl == "persistent")
    for name, t in engine_mod._batch_fields(fresh):
        assert torch.equal(staged.host_views[name], t), name
    (_, _), (fresh_eng, _) = _engines(impl, slots=16)
    want = fresh_eng.forward("gnn", partial, 16)
    assert torch.equal(got, want)
    assert not torch.equal(first[:3], got[:3])
    np.testing.assert_allclose(got[:3].numpy(), [r["prob"] for r in answers],
                               rtol=JAX_TOL, atol=JAX_TOL)
    assert peng.compiles_after_warmup == 0


def _vals_dtype(engine):
    """The band value dtype of the gnn lane's warmed programs."""
    return torch.bfloat16 if engine._lanes["gnn"].band else None


@pytest.mark.parametrize("impl", ["persistent", "segment"])
def test_compiles_match_the_jax_engine_over_a_replayed_trace(impl):
    (jeng, jclock), (peng, clock) = _engines(impl, slots=4)
    assert jeng.warmup() == peng.warmup() == 3
    jout = j_replay(jeng, j_bursty_trace(48, JFeatureSpec(**LIMITS), seed=1),
                    jclock)
    out = replay(peng, bursty_trace(48, FeatureSpec(**LIMITS), seed=1), clock)
    assert out["metrics"]["compiles"] == jout["metrics"]["compiles"] == 3
    assert peng.compiles_after_warmup == jeng.compiles_after_warmup == 0
    assert out["metrics"]["compiles_after_warmup"] == 0
    want = {int(r.graph["id"]): r.result["prob"] for r in jout["requests"]}
    got = {int(r.graph["id"]): r.result["prob"] for r in out["requests"]}
    assert got.keys() == want.keys()
    np.testing.assert_allclose([got[k] for k in sorted(got)],
                               [want[k] for k in sorted(got)],
                               rtol=JAX_TOL, atol=JAX_TOL)


# ---------------------------------------------------------------------------
# A batch whose band values need f32
# ---------------------------------------------------------------------------


def _repeated_edge(graph, times):
    """``graph`` with the edge 1 -> 2 there ``times`` times in all."""
    g = dict(graph)
    s = np.asarray(g["senders"], np.int32)
    r = np.asarray(g["receivers"], np.int32)
    more = times - int(np.sum((s == 1) & (r == 2)))
    g["senders"] = np.concatenate([s, np.full(more, 1, np.int32)])
    g["receivers"] = np.concatenate([r, np.full(more, 2, np.int32)])
    return g


@pytest.mark.parametrize("times", [300, 257])
def test_an_f32_band_batch_gets_a_pair_of_its_own(times):
    """An edge repeated over 256 times makes the band values f32. The JAX
    engine's AOT executable was compiled for bf16 band values, so it
    fails that flush (every request "internal", a TypeError naming
    ``batch.band_adj.vals``) and counts no compile. The port answers it
    from a second program for the pair, at f32 values (never rounded into
    the bf16 buffer), and counts that program as a compile after
    warmup."""
    cfg = dict(max_edges_per_node=8)
    (jeng, _), (peng, _) = _engines("persistent", slots=4, **cfg)
    jeng.warmup()
    peng.warmup()
    graphs = _graphs(2, seed=9, min_nodes=60, max_nodes=60)
    heavy = _repeated_edge(graphs[0], times)
    jres = jeng.score_sync([heavy, graphs[1]])
    assert [r.get("error") for r in jres] == ["internal", "internal"]
    assert "band_adj.vals" in jres[0]["detail"]
    assert "bfloat16" in jres[0]["detail"]
    assert jeng.compiles_after_warmup == 0

    res = peng.score_sync([heavy, graphs[1]])
    assert all("prob" in r for r in res)
    assert peng.compiles_after_warmup == 1
    staged = peng._programs[("gnn", 2, torch.float32)].staged
    vals = staged.host_views["band_adj.vals"]
    assert vals.dtype == torch.float32 and float(vals.max()) == times
    norm = [peng._normalize_graph(g) for g in (heavy, graphs[1])]
    gb, _ = peng._pack("gnn", norm, 2)
    eager = peng._forward("gnn", gb, None)
    assert [r["prob"] for r in res] == eager[:2].tolist()
    # Rounded into bf16 the values would answer otherwise where the
    # count is not bf16-exact.
    gb = bucket_batch(peng.config, norm, 2, peng.required_subkeys,
                      band=True)
    gb.band_adj.vals = gb.band_adj.vals.to(torch.bfloat16)
    with torch.inference_mode():
        rounded = torch.sigmoid(peng.model(gb))[:2].tolist()
    assert (rounded == eager[:2].tolist()) == (times == 300)
    # The pair's bf16 program still serves the bf16 batches.
    peng.score_sync(_graphs(2, seed=10))
    assert peng.compiles_after_warmup == 1


# ---------------------------------------------------------------------------
# The ordered segment sum's index plan
# ---------------------------------------------------------------------------


class _HostReads(TorchDispatchMode):
    """Records every op that reads device data back to the host (or sizes
    its output from the data), which a CUDA graph cannot capture."""

    HOST_READS = ("_local_scalar_dense", "nonzero", "bincount", "unique",
                  "masked_select", "repeat_interleave", "segment_reduce")

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._schema.name.split("::")[-1]
        if name.lstrip("_") in self.HOST_READS:
            self.seen.append(name)
        return func(*args, **(kwargs or {}))


def _kernel_walk(data, keys, order, n):
    """The kernel's arithmetic: bucket ``s`` owns the rows ``order[k]``
    for ``k`` between the lower bounds of ``s`` and ``s + 1`` in the
    sorted ``keys``, added in turn, one add at the data's dtype each."""
    out = torch.zeros((n,) + tuple(data.shape[1:]), dtype=data.dtype)
    bounds = torch.searchsorted(keys, torch.arange(n + 1, dtype=keys.dtype))
    for s in range(n):
        acc = torch.zeros(data.shape[1:], dtype=data.dtype)
        for k in range(int(bounds[s]), int(bounds[s + 1])):
            acc = acc + data[int(order[k])]
        out[s] = acc
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
def test_segment_sum_plan_reads_no_host_and_walks_the_level_loop(dtype,
                                                                 masked):
    rng = np.random.default_rng(11)
    n_rows, n_seg = 300, 23
    ids = torch.from_numpy(rng.integers(0, n_seg, n_rows).astype(np.int32))
    data = torch.from_numpy(rng.normal(size=(n_rows, 5)).astype(np.float32)
                            ).to(dtype)
    mask = torch.from_numpy(rng.random(n_rows) > 0.3) if masked else None
    if masked:
        data = torch.where(mask[:, None], data, 0.0)
    with _HostReads() as mode:
        plan = segment.segment_sum_plan(ids, n_seg, mask)
    assert mode.seen == []
    # One stable sort of the int32 keyed ids: the masked rows (id n_seg)
    # sort last, past every bucket's rows.
    keyed = segment._bucket_ids(ids, n_seg, mask)
    kept = n_rows if mask is None else int(mask.sum())
    assert plan.num_segments == n_seg
    assert plan.ids.dtype == plan.keys.dtype == torch.int32
    assert torch.equal(plan.ids, keyed)
    assert torch.equal(plan.keys, keyed[plan.order])
    assert torch.all(plan.keys[1:] >= plan.keys[:-1])
    assert torch.all(plan.keys[kept:] == n_seg)
    assert torch.all(plan.order[1:][plan.keys[1:] == plan.keys[:-1]]
                     > plan.order[:-1][plan.keys[1:] == plan.keys[:-1]])
    got = _kernel_walk(data, plan.keys, plan.order, n_seg)
    want = segment._segment_sum_ordered(data, ids.long(), n_seg)
    assert torch.equal(got, want)
    assert plan.mask is None and torch.equal(plan.keyed(), keyed)
    assert torch.equal(segment.segment_sum_rows(data, plan), want)
    if dtype == torch.bfloat16:
        # A sum rounded once differs from the chain of roundings.
        once = segment._segment_sum_ordered(data.float(), ids.long(),
                                            n_seg).to(dtype)
        assert not torch.equal(once, want)


# ---------------------------------------------------------------------------
# The launch record of a capture; a failed capture
# ---------------------------------------------------------------------------


def test_recorded_launches_are_this_threads_and_replay_adds_them():
    class Wrapper:
        launches = 0

    other = threading.Thread(
        target=lambda: [ops.count_launch(Wrapper) for _ in range(5)])
    with ops.recording_launches() as record:
        ops.count_launch(Wrapper)
        ops.count_launch(Wrapper)
        other.start()
        other.join()
    assert Wrapper.launches == 5  # the other thread counted as before
    assert record == {(Wrapper, "launches"): 2}
    for _ in range(3):
        ops.add_launches(record)
    assert Wrapper.launches == 11


class _FakeGraph:
    """A stand-in for torch.cuda.CUDAGraph on the CPU: the capture runs
    the forward once; after an op it refused (``invalidated``),
    capture_end raises, as cudaStreamEndCapture does."""

    invalidated = False

    def capture_begin(self, pool=None, capture_error_mode="global"):
        assert capture_error_mode == "thread_local"
        _FakeGraph.invalidated = False

    def capture_end(self):
        if _FakeGraph.invalidated:
            raise RuntimeError("operation failed due to a previous error "
                               "during capture")


def test_a_failed_capture_raises_naming_lane_bucket_and_op(monkeypatch):
    model = _model("persistent")
    eng = ServeEngine(model, ServeConfig(batch_slots=2), device="cpu")
    calls = []
    real = fused_gnn.persistent_reference

    def reads_the_host(*args, **kw):
        calls.append(1)
        if len(calls) % 2 == 0:  # the capture's run, after the eager one
            _FakeGraph.invalidated = True
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        return real(*args, **kw)

    class Stream:
        def synchronize(self):
            pass

    monkeypatch.setattr(fused_gnn, "persistent_reference", reads_the_host)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(engine_mod, "_pool_bytes", lambda pool, dev: 0)
    monkeypatch.setattr(eng, "_on_stream", contextlib.nullcontext)
    eng._stream = Stream()
    with pytest.raises(CaptureError) as info:
        eng.warmup()
    msg = str(info.value)
    assert "the gnn lane's 2-slot bucket" in msg
    assert "persistent_unroll (deepdfa_tpu_torch/ops/fused_gnn.py" in msg
    assert "operation not permitted when stream is capturing" in msg
    assert eng.stats.compiles == 0 and eng.n_warm == 0
    # A flush of the pair captures again and fails again: no eager
    # answer in its place.
    req = eng.submit(_graphs(1, seed=3)[0])
    eng.drain()
    assert req.result["error"] == "internal"
    assert "CaptureError" in req.result["detail"]
