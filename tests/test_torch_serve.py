"""The port's serving engine (GNN lane) against the JAX engine: the same
requests, the same converted parameters, the same answers, cache hits
and error classes; plus the port's flush policy, flush isolation and
the ``cli score`` report."""

import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from deepdfa_tpu.core.config import FeatureSpec as JFeatureSpec
from deepdfa_tpu.core.config import FlowGNNConfig as JFlowGNNConfig
from deepdfa_tpu.models.flowgnn import FlowGNN as JFlowGNN
from deepdfa_tpu.serve import ServeConfig as JServeConfig
from deepdfa_tpu.serve import ServeEngine as JServeEngine
from deepdfa_tpu.serve.engine import random_gnn_params
from deepdfa_tpu_torch.core.config import FeatureSpec, FlowGNNConfig
from deepdfa_tpu_torch.data.synthetic import synthetic_bigvul
from deepdfa_tpu_torch.models.convert import flowgnn_from_flax
from deepdfa_tpu_torch.models.flowgnn import FlowGNN
from deepdfa_tpu_torch.serve import (
    BadRequestError,
    OversizedError,
    ServeConfig,
    ServeEngine,
)

LIMITS = dict(limit_all=20, limit_subkeys=20)
MODEL = dict(hidden_dim=4, n_steps=2, num_output_layers=2)


class Clock:
    """A virtual monotonic clock the engine advances by each flush."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _requests():
    graphs = synthetic_bigvul(32, FeatureSpec(**LIMITS), seed=4)
    for g in graphs:  # clients send no labels
        for key in ("label", "vuln", "df_in", "df_out", "project"):
            g.pop(key)
    return graphs


def _engines(impl, slots=4):
    jmodel = JFlowGNN(JFlowGNNConfig(feature=JFeatureSpec(**LIMITS),
                                     message_impl=impl, **MODEL))
    jcfg = JServeConfig(batch_slots=slots)
    params = random_gnn_params(jmodel, jcfg, seed=3)
    jeng = JServeEngine(jmodel, params, config=jcfg, clock=Clock())
    model = FlowGNN(FlowGNNConfig(feature=FeatureSpec(**LIMITS),
                                  message_impl=impl, **MODEL), device="cpu")
    model.load_state_dict(flowgnn_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    peng = ServeEngine(model, ServeConfig(batch_slots=slots), clock=Clock(),
                       device="cpu")
    return jeng, peng


@pytest.mark.parametrize("impl", ["segment", "persistent"])
def test_served_probs_and_cache_match_jax(impl):
    jeng, peng = _engines(impl)
    reqs = _requests()
    # 32 distinct functions, then 8 duplicates once their first copies
    # are answered: the duplicates come from the cache.
    results = {}
    for name, eng in (("jax", jeng), ("port", peng)):
        first = eng.score_sync(reqs)
        dup = eng.score_sync(reqs[::4])
        results[name] = (first, dup, eng.snapshot())
    (jfirst, jdup, jsnap), (pfirst, pdup, psnap) = results["jax"], \
        results["port"]
    assert len(pfirst) == 32 and len(pdup) == 8
    np.testing.assert_allclose([r["prob"] for r in pfirst + pdup],
                               [r["prob"] for r in jfirst + jdup],
                               rtol=1e-5, atol=1e-5)
    assert all(not r["cached"] for r in pfirst)
    assert all(r["cached"] for r in pdup)
    for key in ("submitted", "completed", "cache_hits", "cache_misses",
                "batches", "failures"):
        assert psnap[key] == jsnap[key], key
    assert psnap["cache_hits"] == 8
    assert psnap["padding_waste"].keys() == jsnap["padding_waste"].keys()
    for cell, c in psnap["padding_waste"].items():
        assert c == jsnap["padding_waste"][cell], cell


def _bad_payloads():
    base = _requests()[0]
    big = synthetic_bigvul(1, FeatureSpec(**LIMITS), seed=1,
                           min_nodes=70, max_nodes=70)[0]
    no_feat = dict(base, feats={k: v for k, v in base["feats"].items()
                                if k != "api"})
    dangling = dict(base, senders=np.asarray(base["senders"]) + 500)
    return {
        "oversize_nodes": big,
        "oversize_edges": dict(base, senders=np.zeros(400, np.int32),
                               receivers=np.zeros(400, np.int32)),
        "missing_field": {k: v for k, v in base.items() if k != "num_nodes"},
        "missing_subkey": no_feat,
        "dangling": dangling,
        "empty": dict(base, num_nodes=0),
        "not_an_object": [1, 2, 3],
    }


def test_bad_requests_map_to_the_same_error_classes():
    jeng, peng = _engines("segment")
    for name, payload in _bad_payloads().items():
        errors = []
        for eng in (jeng, peng):
            try:
                eng.submit(payload)
            except Exception as e:  # compared below, class name and text
                errors.append((type(e).__name__, str(e)))
            else:
                errors.append(None)
        assert errors[0] is not None, name
        assert errors[1] == errors[0], name
    expect = {"oversize_nodes": OversizedError,
              "missing_subkey": BadRequestError}
    for name, cls in expect.items():
        with pytest.raises(cls):
            peng.submit(_bad_payloads()[name])
    # score_sync reports them inline, in the reference's shape.
    payloads = list(_bad_payloads().values())
    jres = jeng.score_sync(payloads)
    pres = peng.score_sync(payloads)
    assert [r["error"] for r in pres] == [r["error"] for r in jres]
    assert {r["error"] for r in pres} == {"oversized", "bad_request"}
    assert peng.pending() == 0


def test_deadline_and_fill_flushes():
    _, peng = _engines("segment")
    reqs = _requests()
    clock = peng._clock
    peng.submit(reqs[0])
    assert peng.pump() == 0  # not full, deadline not half spent
    assert peng.next_flush_time() == pytest.approx(0.05)
    clock.t = 0.051
    assert peng.pump() == 1  # deadline flush of a 1-slot bucket
    for g in reqs[1:5]:
        peng.submit(g)
    assert peng.pump() == 1  # fill flush of the 4-slot bucket
    assert peng.snapshot()["padding_waste"].keys() == {"gnn:b1", "gnn:b4"}
    assert peng.pending() == 0


def test_flush_isolation_fails_only_its_own_requests():
    _, peng = _engines("segment")
    reqs = _requests()
    real_infer = peng._infer
    calls = []

    def flaky(batch):
        calls.append(batch.n_graphs)
        if len(calls) == 1:
            raise RuntimeError("device lost")
        return real_infer(batch)

    peng._infer = flaky
    handles = [peng.submit(g) for g in reqs[:8]]
    assert peng.drain() == 2
    assert [h.result.get("error") for h in handles] == ["internal"] * 4 + [
        None] * 4
    assert "device lost" in handles[0].result["detail"]
    assert all("prob" in h.result for h in handles[4:])
    assert peng.snapshot()["failures"] == 4
    # The failed functions were not cached; they score on resubmission.
    again = peng.score_sync(reqs[:4])
    assert all("prob" in r and not r["cached"] for r in again)


def test_warmup_runs_every_bucket_on_the_cpu():
    _, peng = _engines("persistent", slots=8)
    assert peng.warmup() == 4  # buckets 1, 2, 4, 8
    assert peng.snapshot()["compiles"] == 4
    assert peng.snapshot()["completed"] == 0


def test_cli_score_report_parses(tmp_path, capsys):
    from deepdfa_tpu_torch import cli
    from deepdfa_tpu_torch.ops import fused_gnn

    assert cli.main(["score", "--dataset", "synthetic:32", "--device", "cpu",
                     "--out-dir", str(tmp_path)]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["n_scored"] == 32 and report["n_errors"] == 0
    assert report["device"] == "cpu"
    assert report["message_impl"] == "persistent"
    assert report["serving"]["completed"] == 32
    # On the CPU the plain versions run: no kernel launch is counted.
    assert report["kernel_launches"] == fused_gnn.launch_counts() == {
        "fused_step_kernel": 0, "persistent_fwd_kernel": 0}
    with open(report["out"]) as f:
        lines = f.read().splitlines()
    assert lines[0] == "index,prob,label" and len(lines) == 33


def _payload_variants():
    base = _requests()[1]
    n = base["num_nodes"]
    feats = base["feats"]
    with_feat = lambda k, v: dict(base, feats=dict(feats, **{k: v}))
    return {
        "as_is": base,
        "json_lists": dict(base, senders=list(map(int, base["senders"])),
                           receivers=[float(r) for r in base["receivers"]],
                           num_nodes=float(n), id=True),
        "bool_feat": with_feat("api", np.ones(n, bool)),
        "fractional": with_feat("api", np.full(n, 0.5)),
        "nan": with_feat("api", np.full(n, np.nan)),
        "negative": with_feat("api", -np.ones(n, np.int64)),
        "short_feat": with_feat("api", np.ones(n - 1, np.int64)),
        "wide_ints": dict(base, senders=np.asarray(base["senders"],
                                                   np.int64) + 2 ** 40),
        "strings": dict(base, senders=["a"] * len(base["senders"])),
        "feats_not_object": dict(base, feats=[1]),
        "fractional_nodes": dict(base, num_nodes=2.5),
        "ragged_edges": dict(base, receivers=base["receivers"][:-1]),
        "extra_subkey": with_feat("extra", np.ones(n, np.int64)),
    }


@pytest.mark.parametrize("name", sorted(_payload_variants()))
def test_admission_contract_matches_jax(name):
    from deepdfa_tpu.contracts import schema as jschema
    from deepdfa_tpu_torch.contracts import schema as pschema

    payload = _payload_variants()[name]
    subkeys = sorted(payload["feats"]) if name != "extra_subkey" else [
        "api", "datatype", "literal", "operator"]
    outcomes = []
    for validate, kw in ((jschema.validate_example, {"with_label": False}),
                         (pschema.validate_example, {})):
        try:
            out = validate(payload, subkeys, boundary="serve", **kw)
        except ValueError as e:
            outcomes.append(("error", getattr(e, "reason", None), str(e)))
        else:
            outcomes.append(("ok", out))
    (jk, *jrest), (pk, *prest) = outcomes
    assert pk == jk, (outcomes, name)
    if pk == "error":
        assert prest == jrest
        return
    jout, pout = jrest[0], prest[0]
    assert sorted(pout) == sorted(jout)
    for key in ("senders", "receivers", "vuln"):
        assert pout[key].dtype == jout[key].dtype
        np.testing.assert_array_equal(pout[key], jout[key])
    for k in jout["feats"]:
        np.testing.assert_array_equal(pout["feats"][k], jout["feats"][k])
    assert pout["num_nodes"] == jout["num_nodes"]
    assert pout.get("id") == jout.get("id")
