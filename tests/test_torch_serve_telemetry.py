"""The serving path's telemetry (``serve/engine.py``, ``serve/batcher.py``,
``serve/policy.py``, ``serve/fleet.py``, ``serve/http.py``) against the
JAX package's on the CPU: the same bursty trace through the JAX engine
and the port's, on converted weights and a virtual clock that credits
each flush a fixed cost (so both see one timeline), each under its own
telemetry run. The ``serve.flush`` span sequence, the ``serve.request``
count, every ``serve_*_total`` counter and the Prometheus text are the
reference's; a ``serve.batch`` fault fails the same requests in both; a
``traceparent`` header lands on its requests' spans; the policy's
``serve.flush_policy`` events and a fleet's series and roll events match.
Probabilities hold the existing baselines: 1e-5 against the JAX engine,
1e-6 against the port's offline eval, and bit for bit with telemetry on
and off."""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from deepdfa_tpu import telemetry as jtel
from deepdfa_tpu.core.config import FeatureSpec as JFeatureSpec
from deepdfa_tpu.core.config import FlowGNNConfig as JFlowGNNConfig
from deepdfa_tpu.models.flowgnn import FlowGNN as JFlowGNN
from deepdfa_tpu.resilience import inject as jinject
from deepdfa_tpu.serve import AdaptiveFlushPolicy as JAdaptiveFlushPolicy
from deepdfa_tpu.serve import ServeConfig as JServeConfig
from deepdfa_tpu.serve import ServeEngine as JServeEngine
from deepdfa_tpu.serve import fleet as jfleet_mod
from deepdfa_tpu.serve.engine import random_gnn_params
from deepdfa_tpu.serve.http import ServeHTTPServer as JServeHTTPServer
from deepdfa_tpu.serve.replay import VirtualClock as JVirtualClock
from deepdfa_tpu.serve.replay import bursty_trace as j_bursty_trace
from deepdfa_tpu.serve.replay import replay as j_replay
from deepdfa_tpu_torch import telemetry as ptel
from deepdfa_tpu_torch.core.config import (
    DataConfig,
    FeatureSpec,
    FlowGNNConfig,
    TrainConfig,
    subkeys_for,
)
from deepdfa_tpu_torch.models.convert import flowgnn_from_flax
from deepdfa_tpu_torch.models.flowgnn import FlowGNN
from deepdfa_tpu_torch.resilience import inject as pinject
from deepdfa_tpu_torch.serve import AdaptiveFlushPolicy, ServeConfig
from deepdfa_tpu_torch.serve import ServeEngine, ServeFleet
from deepdfa_tpu_torch.serve import fleet as pfleet_mod
from deepdfa_tpu_torch.serve.http import ServeHTTPServer
from deepdfa_tpu_torch.serve.replay import VirtualClock, bursty_trace, replay
from deepdfa_tpu_torch.telemetry import context as pctx

LIMITS = dict(limit_all=20, limit_subkeys=20)
MODEL = dict(hidden_dim=4, n_steps=2, num_output_layers=2)
# The existing baselines: the port's served probabilities against the
# JAX engine's (f32 in another order), and against its own offline eval.
JAX_TOL = 1e-5
OFFLINE_TOL = 1e-6
# The virtual cost of every flush: both engines see one timeline.
FLUSH_S = 0.004
FLUSH_ATTRS = ("lane", "n", "slots", "ordinal", "elems", "elems_slot",
               "elems_budget", "cause")


class _Fixed(VirtualClock):
    def flush_done(self, dt):
        self.advance(FLUSH_S)
        return self.t


class _JFixed(JVirtualClock):
    def flush_done(self, dt):
        self.advance(FLUSH_S)
        return self.t


@pytest.fixture(autouse=True)
def _clean_state():
    """Fresh registries, no run, no armed plan, one intra-op thread
    (exact float comparisons)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    for tel in (jtel, ptel):
        tel.end_run()
        tel.set_enabled(None)
        tel.REGISTRY.reset()
    yield
    for tel, inj in ((jtel, jinject), (ptel, pinject)):
        tel.end_run()
        tel.set_enabled(None)
        inj.clear()
    torch.set_num_threads(n)


def _engines(impl="persistent", slots=4, policy=False, live=False,
             **config):
    """The JAX engine and the port's on the same converted weights, on
    fixed-cost virtual clocks (``live``: the wall clock, for HTTP)."""
    jmodel = JFlowGNN(JFlowGNNConfig(feature=JFeatureSpec(**LIMITS),
                                     message_impl=impl, **MODEL))
    jcfg = JServeConfig(batch_slots=slots, **config)
    params = random_gnn_params(jmodel, jcfg, seed=3)
    jclock, clock = _JFixed(), _Fixed()
    if live:
        jclock = clock = time.monotonic
    jeng = JServeEngine(jmodel, params, config=jcfg, clock=jclock,
                        policy=JAdaptiveFlushPolicy(jcfg) if policy
                        else None)
    model = FlowGNN(FlowGNNConfig(feature=FeatureSpec(**LIMITS),
                                  message_impl=impl, **MODEL), device="cpu")
    model.load_state_dict(flowgnn_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    pcfg = ServeConfig(batch_slots=slots, **config)
    peng = ServeEngine(model, pcfg, clock=clock, device="cpu",
                       policy=AdaptiveFlushPolicy(pcfg) if policy else None)
    return (jeng, jclock), (peng, clock), model


def _events(run_dir):
    with open(os.path.join(run_dir, "telemetry", "events.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def _named(events, name):
    return [e for e in events if e.get("name") == name]


def _run(tel, run_dir, engine, clock, trace, replay_fn):
    with tel.run_scope(run_dir):
        engine.warmup()
        out = replay_fn(engine, trace, clock)
    return out, _events(run_dir)


def _serve_counters(registry):
    return {k: v for k, v in registry.snapshot().items()
            if k.startswith("serve_") and k.endswith("_total")}


def _without_hbm(text):
    return "".join(line + "\n" for line in text.splitlines()
                   if "deepdfa_hbm_peak_" not in line)


def _flushes(events):
    return [tuple(s["attrs"].get(k) for k in FLUSH_ATTRS)
            for s in _named(events, "serve.flush")]


@pytest.mark.parametrize("impl,slots", [("persistent", 4), ("segment", 8)])
def test_flush_spans_requests_and_series_match_the_jax_engine(tmp_path, impl,
                                                              slots):
    from deepdfa_tpu_torch.train import loop

    (jeng, jclock), (peng, clock), model = _engines(impl, slots,
                                                    deadline_ms=60.0)
    feat = FeatureSpec(**LIMITS)
    trace = bursty_trace(120, feat, seed=1)
    jout, jev = _run(jtel, str(tmp_path / "j"), jeng, jclock,
                     j_bursty_trace(120, JFeatureSpec(**LIMITS), seed=1),
                     j_replay)
    pout, pev = _run(ptel, str(tmp_path / "p"), peng, clock, trace, replay)

    flushes = _flushes(pev)
    assert flushes == _flushes(jev)
    assert len(flushes) == pout["metrics"]["batches"] > 1
    assert {f[-1] for f in flushes} >= {"fill", "deadline"}
    assert [f[3] for f in flushes] == list(range(len(flushes)))
    reqs = _named(pev, "serve.request")
    assert len(reqs) == len(_named(jev, "serve.request")) == 120
    assert sum(r["attrs"]["cached"] for r in reqs) == \
        pout["metrics"]["cache_hits"] > 0
    assert len(_named(pev, "serve.enqueue")) == \
        len(_named(jev, "serve.enqueue")) == pout["metrics"]["cache_misses"]
    compiles = _named(pev, "serve.compile")
    assert [(c["attrs"]["lane"], c["attrs"]["slots"]) for c in compiles] == \
        sorted(((c["attrs"]["lane"], c["attrs"]["slots"])
                for c in _named(jev, "serve.compile")),
               key=lambda pair: -pair[1])
    assert all(c["fenced"] for c in compiles)
    assert [e["attrs"] for e in _named(pev, "serve.warmup_done")] == \
        [e["attrs"] for e in _named(jev, "serve.warmup_done")]
    assert all(f["fenced"] and f["host_ms"] <= f["dur_ms"]
               for f in _named(pev, "serve.flush"))

    def last_shapes(events):
        return {e["attrs"]["series"]: {k: v for k, v in e["attrs"].items()}
                for e in _named(events, "traffic.shape")}

    assert last_shapes(pev) == last_shapes(jev)
    assert _serve_counters(ptel.REGISTRY) == _serve_counters(jtel.REGISTRY)
    # The reference's XLA memory analysis (hbm_peak_*) has no counterpart.
    assert ptel.REGISTRY.prometheus_text() == _without_hbm(
        jtel.REGISTRY.prometheus_text())
    for k in ("completed", "batches", "compiles", "cache_hits"):
        assert pout["metrics"][k] == jout["metrics"][k]

    got = {int(r.graph["id"]): r.result["prob"] for r in pout["requests"]}
    want = {int(r.graph["id"]): r.result["prob"] for r in jout["requests"]}
    assert got.keys() == want.keys()
    ids = sorted(got)
    np.testing.assert_allclose([got[i] for i in ids], [want[i] for i in ids],
                               rtol=0, atol=JAX_TOL)
    graphs = [e.graph for e in trace]
    offline = loop.evaluate(loop.make_eval_step(model, TrainConfig()),
                            graphs, np.arange(len(graphs)),
                            DataConfig(eval_batch_size=16),
                            subkeys_for(feat), "cpu",
                            build_band_adj=model.config.uses_band_adj)
    for gid, p in zip(offline.graph_ids, offline.probs):
        assert got[int(gid)] == pytest.approx(float(p), abs=OFFLINE_TOL)


def test_probabilities_are_bit_for_bit_with_telemetry_on_and_off(tmp_path):
    trace = bursty_trace(80, FeatureSpec(**LIMITS), seed=2)
    probs = {}
    for mode in ("off", "on", "no_run"):
        _, (peng, clock), _ = _engines("persistent", 8)
        if mode == "off":
            ptel.set_enabled(False)
            peng.warmup()
            out = replay(peng, trace, clock)
            ptel.set_enabled(None)
        elif mode == "on":
            out, events = _run(ptel, str(tmp_path / "on"), peng, clock,
                               trace, replay)
            assert len(_named(events, "serve.flush")) == \
                out["metrics"]["batches"]
        else:
            peng.warmup()
            out = replay(peng, trace, clock)
        probs[mode] = [r.result["prob"] for r in out["requests"]]
        assert peng.compiles_after_warmup == 0
    assert probs["on"] == probs["off"] == probs["no_run"]


@pytest.mark.parametrize("ordinal", [0, 3])
def test_a_serve_batch_fault_fails_the_same_requests_in_both(tmp_path,
                                                             ordinal):
    plan = {"seed": 7, "faults": [
        {"site": "serve.batch", "kind": "raise", "at": ordinal}]}
    (jeng, jclock), (peng, clock), _ = _engines("segment", 4)
    trace = bursty_trace(40, FeatureSpec(**LIMITS), seed=3)
    with jinject.armed(jinject.FaultPlan.from_doc(plan)):
        jout, jev = _run(jtel, str(tmp_path / "j"), jeng, jclock,
                         j_bursty_trace(40, JFeatureSpec(**LIMITS), seed=3),
                         j_replay)
    with pinject.armed(pinject.FaultPlan.from_doc(plan)):
        pout, pev = _run(ptel, str(tmp_path / "p"), peng, clock, trace,
                         replay)

    def failed(out):
        return [(r.rid, int(r.graph["id"])) for r in out["requests"]
                if "error" in r.result]

    assert failed(pout) == failed(jout) and failed(pout)
    assert all(r.result["error"] == "internal" and
               "FaultError" in r.result["detail"]
               for r in pout["requests"] if "error" in r.result)
    assert pout["metrics"]["failures"] == jout["metrics"]["failures"] == \
        len(failed(pout))
    (fired,) = _named(pev, "fault.fired")
    assert fired["attrs"] == _named(jev, "fault.fired")[0]["attrs"] == {
        "site": "serve.batch", "kind": "raise", "index": ordinal, "seed": 7}
    (bad,) = [f for f in _named(pev, "serve.flush") if "error" in f]
    assert bad["error"] == "FaultError" and bad["attrs"]["ordinal"] == ordinal
    errs = [r for r in _named(pev, "serve.request")
            if "error" in r["attrs"]]
    assert len(errs) == len(failed(pout))
    assert _serve_counters(ptel.REGISTRY) == _serve_counters(jtel.REGISTRY)


def test_the_policy_events_match_the_jax_engine(tmp_path):
    (jeng, jclock), (peng, clock), _ = _engines(
        "segment", 8, policy=True, deadline_ms=40.0, adaptive_interval_s=0.02,
        adaptive_patience=1, adaptive_target_p99_frac=0.3)
    trace = bursty_trace(160, FeatureSpec(**LIMITS), seed=4)
    _, jev = _run(jtel, str(tmp_path / "j"), jeng, jclock,
                  j_bursty_trace(160, JFeatureSpec(**LIMITS), seed=4),
                  j_replay)
    _, pev = _run(ptel, str(tmp_path / "p"), peng, clock, trace, replay)
    docs = [e["attrs"] for e in _named(pev, "serve.flush_policy")]
    assert docs == [e["attrs"] for e in _named(jev, "serve.flush_policy")]
    assert len(docs) == peng.policy.decisions > 3
    assert {d["action"] for d in docs} - {"hold"}
    assert _flushes(pev) == _flushes(jev)


def test_fleet_series_and_roll_events_match_the_jax_fleet(tmp_path):
    active = ["r0", "r2", "r5"]
    pfleet_mod.predeclare_fleet_metrics(active)
    jfleet_mod.predeclare_fleet_metrics(active)
    assert ptel.REGISTRY.prometheus_text() == jtel.REGISTRY.prometheus_text()
    assert "deepdfa_serve_r5_failures_total 0" in \
        ptel.REGISTRY.prometheus_text()
    ptel.REGISTRY.reset()
    model = FlowGNN(FlowGNNConfig(feature=FeatureSpec(**LIMITS), **MODEL),
                    device="cpu")
    run = str(tmp_path / "fleet")
    with ptel.run_scope(run):
        fleet = ServeFleet.build(model, ServeConfig(batch_slots=2),
                                 n_replicas=2, devices=["cpu"])
        fleet.warmup()
        assert fleet.roll_replica("r1", deadline_s=10.0)
    names = [e["name"] for e in _events(run)
             if e["name"].startswith(("fleet.", "lifecycle."))]
    # The engine's lame duck lands in the ring before the fleet's event.
    assert names == ["lifecycle.lame_duck", "fleet.replica_drain",
                     "fleet.replica_restore"]
    (drain,) = _named(_events(run), "fleet.replica_drain")
    assert drain["attrs"] == {"replica": "r1", "reason": "roll",
                              "pending": 0}
    text = ptel.REGISTRY.prometheus_text()
    for rid in ("r0", "r1"):
        assert f"deepdfa_serve_{rid}_compiles_total 2" in text
        assert f"# TYPE deepdfa_serve_{rid}_latency_ms histogram" in text


def _payload(graphs):
    return [{"id": int(g["id"]),
             "graph": {"num_nodes": int(g["num_nodes"]),
                       "senders": np.asarray(g["senders"]).tolist(),
                       "receivers": np.asarray(g["receivers"]).tolist(),
                       "feats": {k: np.asarray(v).tolist()
                                 for k, v in g["feats"].items()}}}
            for g in graphs]


def _post(base, doc, headers=None, accept=None):
    req = urllib.request.Request(
        f"{base}/score", data=json.dumps(doc).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


def _get(base, path, accept=None):
    req = urllib.request.Request(f"{base}{path}",
                                 headers={"Accept": accept} if accept else {})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.headers["Content-Type"], resp.read().decode()


def _serve(server):
    server.start_pump()
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return f"http://127.0.0.1:{server.server_address[1]}"


def test_a_traceparent_post_lands_on_its_serve_requests(tmp_path):
    """A POST with a traceparent header: its requests' serve.request spans
    and its http.post span carry the client's trace id, as the JAX
    server's do; a malformed header is counted and starts a fresh trace;
    the Prometheus text carries the same series as the JAX server's."""
    (jeng, _), (peng, _), _ = _engines("segment", 2, live=True,
                                       deadline_ms=20.0)
    graphs = [e.graph for e in bursty_trace(6, FeatureSpec(**LIMITS),
                                            seed=5)][:3]
    tid, sid = pctx.new_trace_id(), pctx.new_span_id()
    header = {"traceparent": pctx.make_traceparent(tid, sid)}
    texts, reqs = {}, {}
    for name, tel, eng, server_cls in (
            ("jax", jtel, jeng, JServeHTTPServer),
            ("port", ptel, peng, ServeHTTPServer)):
        run = str(tmp_path / name)
        with tel.run_scope(run):
            eng.warmup()
            server = server_cls(("127.0.0.1", 0), eng)
            base = _serve(server)
            try:
                assert _post(base, {"functions": _payload(graphs)},
                             header)[0] == 200
                assert _post(base, {"functions": _payload(graphs[:1])},
                             {"traceparent": "00-zz-bad-01"})[0] == 200
                assert _post(base, {"functions": _payload(graphs[1:2])}
                             )[0] == 200
                ctype, texts[name] = _get(base, "/metrics", "text/plain")
                assert ctype.startswith("text/plain")
                jtype, body = _get(base, "/metrics")
                assert jtype == "application/json"
                assert json.loads(body)["submitted"] == 5
            finally:
                server.shutdown()
                server.server_close()
        events = _events(run)
        reqs[name] = _named(events, "serve.request")
        posts = _named(events, "http.post")
        assert [p["attrs"]["trace_continued"] for p in posts] == \
            [True, False, False]
        assert posts[0]["attrs"]["trace_id"] == tid
        assert len({p["attrs"]["trace_id"] for p in posts}) == 3
        assert tel.REGISTRY.counter("trace_ctx_malformed_total").value == 1
    for name in ("jax", "port"):
        joined = [r for r in reqs[name]
                  if r["attrs"].get("trace_id") == tid]
        assert len(joined) == 3
        assert all(r["attrs"]["trace_continued"] for r in joined)
        assert len(reqs[name]) == 5
    assert sorted(sorted(r["attrs"]) for r in reqs["port"]) == \
        sorted(sorted(r["attrs"]) for r in reqs["jax"])

    def series(text):
        return sorted(line for line in text.splitlines()
                      if line.startswith("# TYPE"))

    # The port's own /metrics keys, as serve_* gauges.
    port_only = {"# TYPE deepdfa_serve_compiles_after_warmup gauge",
                 "# TYPE deepdfa_serve_graph_pool_bytes gauge"}
    assert port_only <= set(series(texts["port"]))
    assert sorted(set(series(texts["port"])) - port_only) == \
        series(_without_hbm(texts["jax"]))
