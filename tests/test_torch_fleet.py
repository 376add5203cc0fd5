"""The port's serving fleet (``serve/fleet.py``, ``serve/policy.py``,
``parallel/mesh.py``, the fleet half of ``serve/replay.py``) against the
JAX package's on the CPU, at the reference tests' tiny configuration
(hidden 4, one step) with the same converted weights: the replica
shards, the router's picks, offline parity, the policy's decisions, the
open-loop trace, and the replay decision for decision under a
fixed-cost timeline; then what the port alone holds: one model a
device, the launch counters under threads, the fleet over HTTP with a
roll, the config and the CLI."""

import dataclasses
import json
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from deepdfa_tpu.core.config import FeatureSpec as JFeatureSpec
from deepdfa_tpu.core.config import FlowGNNConfig as JFlowGNNConfig
from deepdfa_tpu.data.synthetic import synthetic_bigvul as j_synthetic_bigvul
from deepdfa_tpu.models.flowgnn import FlowGNN as JFlowGNN
from deepdfa_tpu.parallel.mesh import replica_device_shards as j_shards
from deepdfa_tpu.serve import AdaptiveFlushPolicy as JAdaptiveFlushPolicy
from deepdfa_tpu.serve import MicroBatcher as JMicroBatcher
from deepdfa_tpu.serve import RejectedError as JRejectedError
from deepdfa_tpu.serve import ServeConfig as JServeConfig
from deepdfa_tpu.serve import ServeFleet as JServeFleet
from deepdfa_tpu.serve import ServeRequest as JServeRequest
from deepdfa_tpu.serve import config as jserve_config
from deepdfa_tpu.serve.engine import random_gnn_params
from deepdfa_tpu.serve.replay import ReplicaTimeline as JReplicaTimeline
from deepdfa_tpu.serve.replay import VirtualClock as JVirtualClock
from deepdfa_tpu.serve.replay import open_loop_trace as j_open_loop_trace
from deepdfa_tpu.serve.replay import replay_fleet as j_replay_fleet
from deepdfa_tpu_torch import cli
from deepdfa_tpu_torch.core.config import FeatureSpec, FlowGNNConfig
from deepdfa_tpu_torch.core.metrics import ServingStats, merge_padding_cells
from deepdfa_tpu_torch.data.synthetic import synthetic_bigvul
from deepdfa_tpu_torch.models.convert import flowgnn_from_flax
from deepdfa_tpu_torch.models.flowgnn import FlowGNN
from deepdfa_tpu_torch.ops import count_launch
from deepdfa_tpu_torch.parallel.mesh import replica_device_shards
from deepdfa_tpu_torch.serve import (
    MAX_REPLICAS,
    REPLICA_IDS,
    AdaptiveFlushPolicy,
    MicroBatcher,
    RejectedError,
    ServeConfig,
    ServeEngine,
    ServeFleet,
    ServeRequest,
)
from deepdfa_tpu_torch.serve.http import ServeHTTPServer
from deepdfa_tpu_torch.serve.replay import (
    ReplicaTimeline,
    VirtualClock,
    open_loop_trace,
    replay_fleet,
)

LIMITS = dict(limit_all=20, limit_subkeys=20)
TINY = dict(hidden_dim=4, n_steps=1, num_output_layers=1)
FEAT = FeatureSpec(**LIMITS)
JFEAT = JFeatureSpec(**LIMITS)
CPU = [torch.device("cpu")]
PROB_TOL = 1e-5
# The fixed flush cost of the replay's timelines: both packages credit
# it in place of the measured time, so their clocks move the same way.
FIXED_FLUSH_S = 0.002


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, so the exact comparisons do not meet the
    first multi-threaded ``torch.exp`` of a process, which can be wrong
    in one thread's chunk (``scripts/torch_first_exp_race.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(seed=3, slots=8):
    """(JAX model, its params, the port's model with the same weights)."""
    jmodel = JFlowGNN(JFlowGNNConfig(feature=JFEAT, **TINY))
    params = random_gnn_params(jmodel, JServeConfig(batch_slots=slots),
                               seed=seed)
    model = FlowGNN(FlowGNNConfig(feature=FEAT, **TINY), device="cpu")
    model.load_state_dict(flowgnn_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    return jmodel, params, model


def _fleets(n, config_kw, clock_factories=(None, None)):
    """The same n-replica fleet in both packages."""
    jmodel, params, model = _models(slots=config_kw.get("batch_slots", 16))
    jfleet = JServeFleet.build(jmodel, params, config=JServeConfig(
        **config_kw), n_replicas=n, clock_factory=clock_factories[0])
    kw = {} if clock_factories[1] is None else dict(
        clock_factory=clock_factories[1])
    fleet = ServeFleet.build(model, ServeConfig(**config_kw), n_replicas=n,
                             devices=CPU, **kw)
    return jfleet, fleet


def _graphs(n, seed):
    return (j_synthetic_bigvul(n, JFEAT, positive_fraction=0.5, seed=seed),
            synthetic_bigvul(n, FEAT, positive_fraction=0.5, seed=seed))


# ---------------------------------------------------------------------------
# (a) Shards
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_devices", range(1, 9))
def test_replica_device_shards_match_jax(n_devices):
    devices = [f"dev{i}" for i in range(n_devices)]
    for n in range(1, 9):
        assert replica_device_shards(n, devices=devices) == j_shards(
            n, devices=devices), n
    for bad in (0, -1):
        with pytest.raises(ValueError):
            j_shards(bad, devices=devices)
        with pytest.raises(ValueError):
            replica_device_shards(bad, devices=devices)


def test_replica_device_shards_default_to_the_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="devices="):
        replica_device_shards(2)
    with pytest.raises(RuntimeError, match="devices="):
        ServeFleet.build(_models()[2], ServeConfig(), n_replicas=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert replica_device_shards(2) == [
        [torch.device("cuda", 0), torch.device("cuda", 1)],
        [torch.device("cuda", 2)]]
    assert replica_device_shards(4)[3] == [torch.device("cuda", 0)]


# ---------------------------------------------------------------------------
# (b) Routing
# ---------------------------------------------------------------------------


def _route_script(fleet, graphs, rejected):
    """A scripted routing run: the picks and outcomes as plain values."""
    keys = [f"k{i}" for i in range(24)]
    out = []

    def picks(tag):
        out.append((tag, [fleet.route(k).rid for k in keys]))

    engines = [r.engine for r in fleet.replicas]
    picks("idle")
    picks("idle")
    engines[0].in_flight = 3
    picks("r0 busy")
    engines[0].in_flight = 0
    for g in graphs[:fleet.config.batch_slots]:
        engines[1].submit(g)
    picks("r1 saturated")
    engines[2].in_flight = 1
    picks("r1 saturated, r2 busy")
    fleet.begin_replica_drain("r0")
    picks("r0 draining")
    for e in engines:
        e.in_flight = 2
    picks("all busy")
    for e in engines:
        e.in_flight = 0
    fleet.restore_replica("r0")
    engines[1].drain()
    picks("restored")
    # Admissions through the router: the replica each lands on, and the
    # sheds once every queue is full.
    for g in graphs[fleet.config.batch_slots:]:
        try:
            fleet.submit(g)
            out.append(("submit", [e.pending() for e in engines]))
        except rejected:
            out.append(("submit", "rejected"))
    for rid in ("r0", "r1", "r2"):
        fleet.begin_replica_drain(rid)
    with pytest.raises(rejected):
        fleet.route("k0")
    return out


def test_routing_picks_match_jax():
    kw = dict(batch_slots=4, queue_capacity=8, deadline_ms=100.0)
    jfleet, fleet = _fleets(3, kw)
    jgraphs, graphs = _graphs(40, seed=5)
    want = _route_script(jfleet, jgraphs, JRejectedError)
    got = _route_script(fleet, graphs, RejectedError)
    assert got == want
    assert [o for tag, o in got if tag == "submit"].count("rejected") > 0
    # Rendezvous: a key's preference does not move while the fleet idles,
    # and every replica is some key's preference.
    assert got[0] == got[1] and set(got[0][1]) == {"r0", "r1", "r2"}


# ---------------------------------------------------------------------------
# (c) Offline parity
# ---------------------------------------------------------------------------


def test_offline_parity_200_requests_against_one_engine_and_jax():
    config = ServeConfig(batch_slots=8, deadline_ms=100.0)
    jmodel, params, model = _models()
    jgraphs, graphs = _graphs(200, seed=1)
    single = ServeEngine(model, config, clock=VirtualClock(), device="cpu")
    single.warmup()
    ref = single.score_sync(graphs)

    fleet = ServeFleet.build(model, config, n_replicas=3, devices=CPU)
    assert fleet.warmup() == 3 * len(config.slot_buckets)
    got = fleet.score_sync(graphs)
    jfleet = JServeFleet.build(jmodel, params, config=JServeConfig(
        batch_slots=8, deadline_ms=100.0), n_replicas=3)
    jfleet.warmup()
    want = jfleet.score_sync(jgraphs)

    assert len(got) == len(ref) == len(want) == 200
    assert [a["prob"] for a in got] == [b["prob"] for b in ref]
    np.testing.assert_allclose([a["prob"] for a in got],
                               [b["prob"] for b in want], rtol=0,
                               atol=PROB_TOL)
    assert [r.engine.stats.completed for r in fleet.replicas] == [
        r.engine.stats.completed for r in jfleet.replicas]
    assert all(r.engine.stats.completed > 0 for r in fleet.replicas)
    assert fleet.compiles_after_warmup == 0
    assert all(r.engine.compiles_after_warmup == 0 for r in fleet.replicas)


# ---------------------------------------------------------------------------
# (d) The policy
# ---------------------------------------------------------------------------


class _Stats:
    def __init__(self):
        self.completed = self.failures = 0
        self.occupancy_used = self.occupancy_slots = 0
        self.latencies_ms = np.zeros(0)


class _Engine:
    """What the policy reads of an engine, driven by a script."""

    def __init__(self, batcher):
        self.t = 0.0
        self.stats = _Stats()
        self.batcher = batcher

    def now(self):
        return self.t


@pytest.mark.parametrize("patience,step", [(1, 0.1), (2, 0.2), (3, 0.15)])
def test_policy_decisions_match_jax(patience, step):
    kw = dict(batch_slots=8, deadline_ms=100.0, adaptive_flush=True,
              adaptive_patience=patience, adaptive_step=step,
              flush_fraction_min=0.2, flush_fraction_max=0.8)
    target = 0.8 * 100.0
    # _decide alone over a seeded sequence that crosses both clamps.
    jpol, pol = JAdaptiveFlushPolicy(JServeConfig(**kw)), \
        AdaptiveFlushPolicy(ServeConfig(**kw))
    rng = np.random.default_rng(patience)
    for i in range(120):
        regime = (i // 30) % 3
        p99 = float(rng.uniform(*[(1.2, 3.0), (0.0, 0.45), (0.5, 0.9)][
            regime])) * target
        occ = float(rng.uniform(0.0, 0.4) if regime == 1
                    else rng.uniform(0.0, 1.0))
        a, b = jpol._decide(p99, occ), pol._decide(p99, occ)
        assert dataclasses.astuple(b) == dataclasses.astuple(a), i
    # maybe_update through the rate limit, idle windows and the batcher's
    # clamp, on scripted engine numbers.
    jeng = _Engine(JMicroBatcher(JServeConfig(**kw)))
    eng = _Engine(MicroBatcher(ServeConfig(**kw)))
    jpol, pol = JAdaptiveFlushPolicy(JServeConfig(**kw), replica="r1"), \
        AdaptiveFlushPolicy(ServeConfig(**kw), replica="r1")
    rng = np.random.default_rng(10 + patience)
    decided = 0
    for i in range(200):
        dt = float(rng.uniform(0.0, 0.3))
        served = int(rng.poisson(3)) if rng.random() < 0.8 else 0
        lat = rng.uniform(0.0, 2.0 * target, size=int(rng.integers(1, 40)))
        slots = 8 * int(rng.integers(0, 3))
        used = int(rng.integers(0, slots + 1))
        for e in (jeng, eng):
            e.t += dt
            e.stats.completed += served
            e.stats.occupancy_used += used
            e.stats.occupancy_slots += slots
            e.stats.latencies_ms = lat
        a, b = jpol.maybe_update(jeng), pol.maybe_update(eng)
        assert b == a, i
        decided += a is not None
        assert eng.batcher.flush_fraction == jeng.batcher.flush_fraction
        assert eng.batcher.fill_slots == jeng.batcher.fill_slots
    assert decided > 20 and pol.decisions == jpol.decisions == decided


def _req(cls, rid, arrival, deadline_s=0.1, lane="gnn"):
    g = {"num_nodes": 2, "senders": np.zeros(1, np.int32),
         "receivers": np.ones(1, np.int32), "feats": {}}
    return cls(rid=rid, key=f"k{rid}", graph=g, lane=lane, arrival=arrival,
               deadline_s=deadline_s)


def _batcher_script(batcher, req_cls, rejected):
    out = []
    t = 0.0
    rid = 0
    rng = np.random.default_rng(7)
    for i in range(60):
        t += float(rng.uniform(0.0, 0.03))
        if i == 20:
            batcher.set_flush_policy(fraction=0.05, fill_slots=3)
        if i == 35:
            batcher.set_flush_policy(fraction=2.0, fill_slots=99)
        if i == 45:
            batcher.set_drain_mode(True)
        if i == 52:
            batcher.set_drain_mode(False)
        try:
            batcher.admit(_req(req_cls, rid, t,
                               deadline_s=float(rng.choice([0.05, 0.2]))))
            rid += 1
        except rejected as e:
            out.append(("rejected", e.retry_after_s))
        out.append((batcher.due(t), batcher.next_flush_time(t),
                    batcher.flush_fraction, batcher.fill_slots,
                    batcher.drain_mode))
        if rng.random() < 0.3:
            lane = batcher.due(t)
            if lane is not None:
                out.append([r.rid for r in batcher.take(lane)])
    return out


def test_batcher_thresholds_and_drain_mode_match_jax():
    kw = dict(batch_slots=8, queue_capacity=10, flush_fraction_min=0.2,
              flush_fraction_max=0.8)
    want = _batcher_script(JMicroBatcher(JServeConfig(**kw)), JServeRequest,
                           JRejectedError)
    got = _batcher_script(MicroBatcher(ServeConfig(**kw)), ServeRequest,
                          RejectedError)
    assert got == want
    b = MicroBatcher(ServeConfig(**kw))
    b.set_flush_policy(fraction=0.01, fill_slots=0)
    assert (b.flush_fraction, b.fill_slots) == (0.2, 1)
    b.set_flush_policy(fraction=5.0, fill_slots=99)
    assert (b.flush_fraction, b.fill_slots) == (0.8, 8)


# ---------------------------------------------------------------------------
# (e) Traces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("code_fraction,gen_fraction",
                         [(0.0, 0.0), (0.4, 0.0), (0.3, 0.2)])
def test_open_loop_trace_matches_jax(code_fraction, gen_fraction):
    kw = dict(seed=4, rps=3000.0, duplicate_fraction=0.25,
              code_fraction=code_fraction, gen_fraction=gen_fraction)
    want = j_open_loop_trace(300, JFEAT, **kw)
    got = open_loop_trace(300, FEAT, **kw)

    def rows(trace):
        return [(e.at, None if e.graph is None else int(e.graph["id"]),
                 e.code, e.lane) for e in trace]

    assert rows(got) == rows(want)
    for a, b in zip(got, want):
        if a.graph is not None:
            np.testing.assert_array_equal(a.graph["senders"],
                                          b.graph["senders"])
    if gen_fraction:
        assert any(e.lane == "gen" for e in got)
    if code_fraction:
        assert any(e.code and e.lane is None for e in got)


# ---------------------------------------------------------------------------
# (f) The replay, decision for decision
# ---------------------------------------------------------------------------


class _FixedTimeline(ReplicaTimeline):
    def flush_done(self, dt):
        return super().flush_done(FIXED_FLUSH_S)


class _JFixedTimeline(JReplicaTimeline):
    def flush_done(self, dt):
        return super().flush_done(FIXED_FLUSH_S)


def _record_policies(fleet):
    log = []
    for r in fleet.replicas:
        pol = r.engine.policy

        def recorded(engine, inner=pol.maybe_update, rid=r.rid):
            out = inner(engine)
            log.append((rid, engine.now(), out))
            return out

        pol.maybe_update = recorded
    return log


def test_fleet_replay_matches_jax_decision_for_decision():
    kw = dict(batch_slots=8, deadline_ms=200.0, queue_capacity=64,
              cache_capacity=0, adaptive_flush=True)
    jclock, clock = JVirtualClock(), VirtualClock()
    jtl = [_JFixedTimeline(jclock) for _ in range(3)]
    tl = [_FixedTimeline(clock) for _ in range(3)]
    jfleet, fleet = _fleets(3, kw, (lambda i: jtl[i], lambda i: tl[i]))
    jfleet.warmup()
    fleet.warmup()
    jlog, log = _record_policies(jfleet), _record_policies(fleet)
    kw_trace = dict(seed=2, rps=6000.0, duplicate_fraction=0.0)
    want = j_replay_fleet(jfleet, j_open_loop_trace(240, JFEAT, **kw_trace),
                          jclock)
    got = replay_fleet(fleet, open_loop_trace(240, FEAT, **kw_trace), clock)

    for key in ("completed", "shed", "span_s", "n_offered", "offered_rps",
                "rps", "latency_p50_ms", "latency_p99_ms",
                "compiles_after_warmup"):
        assert got[key] == want[key], key
    assert got["completed"] + got["shed"] == 240
    assert got["compiles_after_warmup"] == 0
    assert [(r.arrival, r.completed_at) for r in got["requests"]] == [
        (r.arrival, r.completed_at) for r in want["requests"]]
    for rid, snap in got["metrics"]["replicas"].items():
        jsnap = want["metrics"]["replicas"][rid]
        for name in ServingStats.COUNTERS:
            assert snap[name] == jsnap[name], (rid, name)
        assert snap["padding_waste"] == jsnap["padding_waste"], rid
    assert log == jlog
    assert any(out is not None for _, _, out in log)
    assert len({rid for rid, _, out in log if out is not None}) == 3
    np.testing.assert_allclose(
        [r.result["prob"] for r in got["requests"]],
        [r.result["prob"] for r in want["requests"]], rtol=0, atol=PROB_TOL)


def test_fleet_prime_rewinds_the_timelines():
    clock = VirtualClock()
    tl = [ReplicaTimeline(clock) for _ in range(2)]
    fleet = ServeFleet.build(_models()[2], ServeConfig(batch_slots=4),
                             n_replicas=2, devices=CPU,
                             clock_factory=lambda i: tl[i])
    fleet.warmup()
    assert fleet.prime(_graphs(7, seed=9)[1]) == 14
    assert clock() == 0.0 and all(t.busy_until == 0.0 for t in tl)
    assert all(r.engine.stats.batches == 3 for r in fleet.replicas)
    with pytest.raises(ValueError, match="prime needs"):
        fleet.prime(_graphs(3, seed=9)[1])
    with pytest.raises(ValueError, match="ReplicaTimeline"):
        replay_fleet(ServeFleet.build(_models()[2], ServeConfig(),
                                      devices=CPU), [], clock)


# ---------------------------------------------------------------------------
# The engine's fleet surface
# ---------------------------------------------------------------------------


class _Watch:
    """A virtual clock with the completion protocol that notes the
    engine's in-flight count when a flush completes."""

    def __init__(self):
        self.t = 0.0
        self.seen = []
        self.engine = None

    def __call__(self):
        return self.t

    def flush_done(self, dt):
        self.seen.append((self.engine.in_flight, self.engine.load()))
        self.t += 1.0
        return self.t


def test_engine_in_flight_load_and_completion_clock(monkeypatch):
    watch = _Watch()
    eng = ServeEngine(_models()[2], ServeConfig(batch_slots=4),
                      clock=watch, device="cpu", replica="r3")
    watch.engine = eng
    eng.warmup()
    graphs = _graphs(7, seed=11)[1]
    reqs = [eng.submit(g) for g in graphs]
    assert eng.load() == 7 and eng.in_flight == 0
    eng.drain()
    # The flush of 4 saw itself in flight with 3 queued, then the 3.
    assert watch.seen == [(4, 7), (3, 3)]
    assert [r.completed_at for r in reqs] == [1.0] * 4 + [2.0] * 3
    assert eng.in_flight == 0 and eng.load() == 0 and eng.clock is watch
    # A failed flush clears the in-flight count too.
    monkeypatch.setattr(eng, "_execute", lambda *a: 1 / 0)
    bad = eng.submit(_graphs(8, seed=12)[1][7])
    eng.drain()
    assert bad.result["error"] == "internal" and eng.in_flight == 0
    # Lame duck: a lone request is due at once.
    eng.submit(_graphs(9, seed=13)[1][8])
    assert eng.batcher.due(watch.t) is None
    eng.enter_lame_duck()
    eng.enter_lame_duck()
    assert eng.lame_duck and eng.batcher.due(watch.t) == "gnn"


def test_merge_padding_cells_matches_jax():
    from deepdfa_tpu.core.metrics import merge_padding_cells as j_merge

    cells = [
        {"gnn:b4": {"used": 3, "slots": 4, "flushes": 1, "elems_used": 50,
                    "elems_budget": 256, "elems_slot_underfill": 64,
                    "elems_inslot_pad": 142, "elems_flush_overhead": 0}},
        None,
        {"gnn:b4": {"used": 4, "slots": 4, "flushes": 1},
         "combined:b2": {"used": 1, "slots": 2, "flushes": 1}},
        {},
    ]
    assert merge_padding_cells(cells) == j_merge(cells)


def test_rows_pooling_is_the_same_wherever_a_graph_sits():
    """The pooling's per-graph sums (``impl="rows"``, what the card runs
    when no gradient flows) give a graph the same bits at any slot of any
    bucket, contiguous or slot-packed, and agree with the assignment
    matrix form."""
    from deepdfa_tpu_torch.graphs.batch import batch_graphs
    from deepdfa_tpu_torch.models.flowgnn import GlobalAttentionPool
    from deepdfa_tpu_torch.serve.engine import bucket_batch

    model = FlowGNN(FlowGNNConfig(), device="cpu")
    graphs = synthetic_bigvul(12, model.config.feature, seed=14)
    subkeys = list(model.subkeys)
    config = ServeConfig(batch_slots=8)
    target = graphs[0]
    layouts = [bucket_batch(config, [target], 1, subkeys, band=True),
               bucket_batch(config, graphs[1:4] + [target], 4, subkeys,
                            band=True),
               bucket_batch(config, graphs[4:9] + [target] + graphs[9:11],
                            8, subkeys, band=True),
               batch_graphs(graphs[1:3] + [target], 4, 256, 1024, subkeys,
                            slot_nodes=64)]
    slots = [0, 3, 5, 2]
    pools = {impl: GlobalAttentionPool(
        model.config.out_dim, torch.Generator().manual_seed(3), impl=impl)
        for impl in ("rows", "matmul")}
    got = []
    with torch.inference_mode():
        for batch, slot in zip(layouts, slots):
            emb = torch.cat([model.embeds[k](batch.node_feats[k])
                             for k in model.subkeys], dim=-1)
            feat = torch.cat([emb, emb.flip(-1)], dim=-1)
            rows = pools["rows"](feat, batch.node_graph, batch.node_mask,
                                 batch.n_graphs)
            mat = pools["matmul"](feat, batch.node_graph, batch.node_mask,
                                  batch.n_graphs)
            torch.testing.assert_close(rows, mat, rtol=1e-6, atol=1e-6)
            got.append(rows[slot])
    for other in got[1:]:
        assert torch.equal(other, got[0])


# ---------------------------------------------------------------------------
# (g) One model a device
# ---------------------------------------------------------------------------


def test_replicas_share_a_device_model_and_copy_it_for_another():
    model = _models()[2]
    before = {k: v.clone() for k, v in model.state_dict().items()}
    fleet = ServeFleet.build(
        model, ServeConfig(batch_slots=4), n_replicas=3,
        devices=[torch.device("cpu", 0), torch.device("cpu", 1)])
    models = [r.engine.model for r in fleet.replicas]
    assert [r.devices for r in fleet.replicas] == [
        (torch.device("cpu", 0),), (torch.device("cpu", 1),),
        (torch.device("cpu", 0),)]
    assert models[0] is model and models[2] is model
    assert models[1] is not model
    for k, v in models[1].state_dict().items():
        assert torch.equal(v, before[k]), k
        assert v.data_ptr() != model.state_dict()[k].data_ptr(), k
    # The first device keeps the caller's module, weights unchanged.
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    # One device, one model for every replica.
    fleet = ServeFleet.build(model, ServeConfig(batch_slots=4),
                             n_replicas=4, devices=CPU)
    assert all(r.engine.model is model for r in fleet.replicas)


# ---------------------------------------------------------------------------
# The launch counters under threads
# ---------------------------------------------------------------------------


def test_count_launch_loses_no_increment_under_threads():
    def wrapper():
        pass

    wrapper.launches = wrapper.launches_bf16 = 0
    n_threads, per = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def bump():
            for i in range(per):
                count_launch(wrapper, "launches_bf16" if i % 2 else
                             "launches")

        threads = [threading.Thread(target=bump) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert wrapper.launches == wrapper.launches_bf16 == n_threads * per // 2


# ---------------------------------------------------------------------------
# (h) HTTP on the CPU
# ---------------------------------------------------------------------------


def _payload(graphs):
    return [{"id": int(g["id"]), "graph": {
        "num_nodes": int(g["num_nodes"]),
        "senders": np.asarray(g["senders"]).tolist(),
        "receivers": np.asarray(g["receivers"]).tolist(),
        "feats": {k: np.asarray(v).tolist()
                  for k, v in g["feats"].items()}}} for g in graphs]


def _call(base, path, doc=None):
    req = urllib.request.Request(
        f"{base}{path}", data=None if doc is None else json.dumps(
            doc).encode(), headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_fleet_over_http_sections_health_and_roll():
    fleet = ServeFleet.build(
        _models()[2], ServeConfig(batch_slots=2, deadline_ms=40.0,
                                  adaptive_flush=True),
        n_replicas=2, devices=CPU)
    fleet.warmup()
    server = ServeHTTPServer(("127.0.0.1", 0), fleet)
    assert [t.name for t in server.pump_threads] == [
        "serve-pump-r0", "serve-pump-r1"]
    server.start_pump()
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        payload = _payload(_graphs(12, seed=9)[1])
        status, out = _call(base, "/score", {"functions": payload[:6]})
        assert status == 200 and all("prob" in r for r in out["results"])
        status, metrics = _call(base, "/metrics")
        assert status == 200 and metrics["n_replicas"] == 2
        assert set(metrics["replicas"]) == {"r0", "r1"}
        for name in ServingStats.COUNTERS:
            assert metrics[name] == sum(
                m[name] for m in metrics["replicas"].values()), name
        assert metrics["completed"] == 6
        assert "kernel_launches" in metrics
        assert metrics["latency_samples"] == 6
        status, health = _call(base, "/healthz")
        assert status == 200 and health["status"] == "ok"
        assert health["warm_buckets"] == 4 and health["fleet"]["live"] == 2
        compiles = metrics["compiles"]

        fleet.begin_replica_drain("r1")
        status, health = _call(base, "/healthz")
        assert status == 503 and health["status"] == "degraded"
        assert health["fleet"]["replicas"]["r1"]["status"] == "draining"
        status, out = _call(base, "/score", {"functions": payload[6:10]})
        assert status == 200 and all("prob" in r for r in out["results"])
        assert fleet.await_replica_drained("r1", deadline_s=30.0)
        fleet.restore_replica("r1")
        status, health = _call(base, "/healthz")
        assert status == 200 and health["status"] == "ok"
        # A whole roll while requests keep coming.
        box = {}
        roller = threading.Thread(target=lambda: box.update(
            drained=fleet.roll_replica("r0", deadline_s=30.0)))
        roller.start()
        status, out = _call(base, "/score", {"functions": payload[10:]})
        roller.join(timeout=60)
        assert box["drained"] and status == 200
        assert all("prob" in r for r in out["results"])
        status, metrics = _call(base, "/metrics")
        assert metrics["compiles"] == compiles
        assert metrics["completed"] == 12 and metrics["failures"] == 0
        fleet.enter_lame_duck()
        status, health = _call(base, "/healthz")
        assert status == 503 and health["status"] == "draining"
        status, out = _call(base, "/score", {"functions": payload[:1]})
        assert status == 429
    finally:
        server.shutdown()
        server.server_close()
    assert not any(t.is_alive() for t in server.pump_threads)


def test_a_burst_of_connections_waits_in_the_listen_queue():
    """32 clients connecting at once while no connection is accepted yet
    all complete their handshake (a backlog of 5 left the rest to retry
    their SYN a second later)."""
    import socket

    server = ServeHTTPServer(("127.0.0.1", 0), ServeFleet.build(
        _models()[2], ServeConfig(batch_slots=2), devices=CPU))
    socks = []
    try:
        for _ in range(32):
            sock = socket.socket()
            sock.settimeout(0.5)
            socks.append(sock)
            sock.connect(server.server_address)
    finally:
        for sock in socks:
            sock.close()
        server.server_close()
    assert len(socks) == 32


# ---------------------------------------------------------------------------
# (i) Config
# ---------------------------------------------------------------------------


def _defaults(cls):
    return {f.name: f.default for f in dataclasses.fields(cls)}


def test_serve_config_fields_match_jax_but_the_gen_lane():
    want = {k: v for k, v in _defaults(JServeConfig).items()
            if not k.startswith("gen_")}
    assert _defaults(ServeConfig) == want
    assert REPLICA_IDS == jserve_config.REPLICA_IDS
    assert MAX_REPLICAS == jserve_config.MAX_REPLICAS == 8


@pytest.mark.parametrize("bad", [
    dict(replicas=0), dict(replicas=9), dict(flush_fraction_min=0.0),
    dict(flush_fraction_min=0.6, flush_fraction_max=0.5),
    dict(flush_fraction_max=1.5), dict(adaptive_patience=0)])
def test_serve_config_refuses_what_jax_refuses(bad):
    with pytest.raises(ValueError):
        JServeConfig(**bad)
    with pytest.raises(ValueError):
        ServeConfig(**bad)


# ---------------------------------------------------------------------------
# (j) The CLI
# ---------------------------------------------------------------------------


def _score(tmp_path, capsys, name, *extra):
    out = str(tmp_path / name)
    assert cli.main(["score", "--dataset", "synthetic:48", "--device", "cpu",
                     "--batch-slots", "4", "--out-dir", out, *extra]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with open(report["out"]) as f:
        return report, f.read()


def test_cli_score_replicas_write_the_same_predictions(tmp_path, capsys):
    one, want = _score(tmp_path, capsys, "one", "--replicas", "1")
    three, got = _score(tmp_path, capsys, "three", "--replicas", "3",
                        "--adaptive-flush")
    assert got == want and len(got.splitlines()) == 49
    assert "n_replicas" not in one["serving"]  # a lone engine's report
    assert three["serving"]["n_replicas"] == 3
    assert all(s["completed"] > 0
               for s in three["serving"]["replicas"].values())
    assert three["device"] == "cpu" and three["over_gate_dispatches"] == 0


def test_cli_serving_flags_and_their_environment(monkeypatch):
    monkeypatch.setenv("DEEPDFA_SERVE_REPLICAS", "2")
    monkeypatch.setenv("DEEPDFA_ADAPTIVE_FLUSH", "1")
    for command in ("serve", "score"):
        args = cli.build_parser().parse_args([command, "--device", "cpu"])
        assert args.replicas == 2 and args.adaptive_flush
    fleet, cfgs, restored = cli._build_serve_engine(args)
    assert isinstance(fleet, ServeFleet) and fleet.size == 2
    assert restored == {} and cfgs["model"].message_impl == "persistent"
    assert all(r.engine.policy is not None
               and r.engine.policy.replica == r.rid for r in fleet.replicas)
    monkeypatch.setenv("DEEPDFA_SERVE_REPLICAS", "1")
    monkeypatch.setenv("DEEPDFA_ADAPTIVE_FLUSH", "0")
    args = cli.build_parser().parse_args(["serve", "--device", "cpu",
                                          "--adaptive-flush"])
    engine, _, _ = cli._build_serve_engine(args)
    assert isinstance(engine, ServeEngine) and engine.policy is not None
    monkeypatch.setenv("DEEPDFA_SERVE_REPLICAS", "x")
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["score", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'|devices="):
        cli.main(["score", "--dataset", "synthetic:8", "--replicas", "2"])
