"""The port's combined DeepDFA+LineVul serving lane and replay harness
against the JAX package's: the same requests through both engines (graph
only, with code, duplicates, a tokenizer failure) on converted params
give probabilities within 1e-5 and the same lanes, cache hits and
degradations; warmup covers every (lane, bucket) pair; the seeded trace
is the reference's event for event; and the reference's 200-request
replay gate (``tests/test_serve.py``) holds for the port."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from deepdfa_tpu.core.config import FeatureSpec as JFeatureSpec
from deepdfa_tpu.core.config import FlowGNNConfig as JFlowGNNConfig
from deepdfa_tpu.data import text as jtext
from deepdfa_tpu.models import infer as jinfer
from deepdfa_tpu.models.flowgnn import FlowGNN as JFlowGNN
from deepdfa_tpu.models.linevul import LineVul as JLineVul
from deepdfa_tpu.models.transformer import EncoderConfig as JEncoderConfig
from deepdfa_tpu.serve import ServeConfig as JServeConfig
from deepdfa_tpu.serve import ServeEngine as JServeEngine
from deepdfa_tpu.serve import replay as jreplay
from deepdfa_tpu.serve.cache import content_hash as jcontent_hash
from deepdfa_tpu.serve.engine import bucket_batch as jbucket_batch
from deepdfa_tpu.serve.engine import random_gnn_params
from deepdfa_tpu_torch.core.config import (
    FeatureSpec,
    FlowGNNConfig,
    TrainConfig,
    subkeys_for,
)
from deepdfa_tpu_torch.data import text as ptext
from deepdfa_tpu_torch.data.synthetic import synthetic_bigvul
from deepdfa_tpu_torch.models import infer as pinfer
from deepdfa_tpu_torch.models.convert import (
    flowgnn_from_flax,
    linevul_from_flax,
)
from deepdfa_tpu_torch.models.flowgnn import FlowGNN
from deepdfa_tpu_torch.models.linevul import LineVul
from deepdfa_tpu_torch.models.transformer import EncoderConfig
from deepdfa_tpu_torch.serve import ServeConfig, ServeEngine
from deepdfa_tpu_torch.serve.cache import content_hash
from deepdfa_tpu_torch.serve.replay import VirtualClock, bursty_trace, replay

LIMITS = dict(limit_all=20, limit_subkeys=20)
GNN = dict(hidden_dim=4, n_steps=1, num_output_layers=1)
BLOCK = 32
# Served probabilities, port against JAX (f32 in another order through
# the encoder and the graph model); the replay against the port's own
# offline eval, as the reference's gate holds its engine.
PROB_TOL = 1e-5
OFFLINE_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the first ``torch.exp`` of a process that
    splits across threads (MKL's ``vmsExp``, more than 2048 elements)
    can come back with a relative error near 1e-4 in one thread's chunk
    (``scripts/torch_first_exp_race.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class JFailing(jtext.HashingCodeTokenizer):
    def tokenize(self, text):
        if "BOOM" in text:
            raise RuntimeError("tokenizer down")
        return super().tokenize(text)


class PFailing(ptext.HashingCodeTokenizer):
    def tokenize(self, text):
        if "BOOM" in text:
            raise RuntimeError("tokenizer down")
        return super().tokenize(text)


def _enc(pkg_cfg):
    return dataclasses.replace(pkg_cfg.tiny(), max_position_embeddings=70)


def _engines(slots=2, impl="segment", cache=4096):
    jg = JFlowGNNConfig(feature=JFeatureSpec(**LIMITS), message_impl=impl,
                        **GNN)
    pg = FlowGNNConfig(feature=FeatureSpec(**LIMITS), message_impl=impl,
                       **GNN)
    jcfg = JServeConfig(batch_slots=slots, block_size=BLOCK,
                        cache_capacity=cache)
    gnn = JFlowGNN(jg)
    gnn_params = random_gnn_params(gnn, jcfg, seed=3)
    comb = JLineVul(_enc(JEncoderConfig),
                    graph_config=dataclasses.replace(jg, encoder_mode=True))
    empty = jbucket_batch(jcfg, [], slots, subkeys_for(pg.feature),
                          band=jg.uses_band_adj)
    comb_params = comb.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((slots, BLOCK), jnp.int32), empty, deterministic=True)
    enc = _enc(EncoderConfig)
    jeng = JServeEngine(gnn, gnn_params, config=jcfg, combined_model=comb,
                        combined_params=comb_params,
                        tokenizer=JFailing(enc.vocab_size),
                        clock=jreplay.VirtualClock())
    pgnn = FlowGNN(pg, device="cpu")
    pgnn.load_state_dict(flowgnn_from_flax(
        jax.tree_util.tree_map(np.asarray, gnn_params)))
    pcomb = LineVul(enc, dataclasses.replace(pg, encoder_mode=True),
                    device="cpu")
    pcomb.load_state_dict(linevul_from_flax(comb_params))
    peng = ServeEngine(pgnn, ServeConfig(batch_slots=slots, block_size=BLOCK,
                                         cache_capacity=cache),
                       clock=VirtualClock(), device="cpu",
                       combined_model=pcomb,
                       tokenizer=PFailing(enc.vocab_size))
    return jeng, peng


def _requests(n=6, seed=15):
    graphs = synthetic_bigvul(n, FeatureSpec(**LIMITS), seed=seed)
    for g in graphs:
        for key in ("label", "vuln", "df_in", "df_out", "project"):
            g.pop(key)
    codes = [f"int f{i}(char *p) {{ return p[{i}] + {i * 7}; }}"
             for i in range(n)]
    return graphs, codes


@pytest.mark.parametrize("impl", ["segment", "persistent"])
def test_combined_lane_matches_jax(impl):
    jeng, peng = _engines(impl=impl)
    assert jeng.warmup() == peng.warmup() == 4  # 2 lanes x buckets {1, 2}
    graphs, codes = _requests()
    # Graph only, with code, a tokenizer failure, then duplicates of the
    # coded ones (cached) and a graph-only copy of a coded graph (its
    # own cache line: the code is part of the combined key).
    mix_g = graphs + graphs[:3] + [graphs[0]]
    mix_c = [None, codes[1], "BOOM", codes[3], None, codes[5]] \
        + [None, codes[1], "BOOM"] + [None]
    out = {}
    for name, eng in (("jax", jeng), ("port", peng)):
        first = eng.score_sync(mix_g[:6], mix_c[:6])
        again = eng.score_sync(mix_g[6:], mix_c[6:])
        out[name] = (first + again, eng.snapshot())
    (jres, jsnap), (pres, psnap) = out["jax"], out["port"]
    np.testing.assert_allclose([r["prob"] for r in pres],
                               [r["prob"] for r in jres], rtol=0,
                               atol=PROB_TOL)
    for key in ("model", "cached", "degraded"):
        assert [r[key] for r in pres] == [r[key] for r in jres], key
    assert [r["model"] for r in pres[:6]] == [
        "gnn", "combined", "gnn", "combined", "gnn", "combined"]
    assert [r["cached"] for r in pres[6:]] == [True, True, True, True]
    for key in ("submitted", "completed", "cache_hits", "cache_misses",
                "degraded", "batches", "failures", "compiles"):
        assert psnap[key] == jsnap[key], key
    assert psnap["padding_waste"].keys() == jsnap["padding_waste"].keys()
    assert peng.compiles_after_warmup == 0


def test_degraded_answer_is_the_gnn_lane_and_shares_its_line():
    _, peng = _engines()
    peng.warmup()
    graphs, codes = _requests(2, seed=21)
    ok = peng.submit(graphs[0], code=codes[0])
    broken = peng.submit(graphs[1], code="BOOM")
    graph_only = peng.submit(graphs[1])
    peng.drain()
    assert ok.result["model"] == "combined" and not ok.result["degraded"]
    assert broken.result["model"] == "gnn" and broken.result["degraded"]
    assert not graph_only.result["degraded"]
    assert broken.result["prob"] == graph_only.result["prob"]
    # Answered, the degraded request's line is the graph's own.
    again = peng.submit(graphs[1], code="BOOM")
    assert again.result["cached"] and again.result["degraded"]
    assert again.result["prob"] == graph_only.result["prob"]
    assert peng.stats.degraded == 2
    assert broken.event.is_set() and graph_only.event.is_set()


def test_first_run_of_an_unwarmed_pair_counts_a_compile():
    _, peng = _engines(slots=4)
    assert peng.warmup_compiles is None and peng.compiles_after_warmup is None
    graphs, codes = _requests(3, seed=2)
    peng.score_sync(graphs, codes)  # a 4-slot combined flush, unwarmed
    assert peng.stats.compiles == 1 and peng.n_warm == 1
    assert peng.warmup() == 5  # the other 5 of 2 lanes x buckets {1, 2, 4}
    assert peng.warmup() == 0 and peng.compiles_after_warmup == 0
    assert sorted(peng.warm_buckets()) == sorted(
        (lane, s) for lane in ("gnn", "combined") for s in (1, 2, 4))


def test_content_hash_matches_jax():
    graphs, codes = _requests(3, seed=8)
    for g, c in zip(graphs, codes):
        for code in (None, c, ""):
            assert content_hash(g, code) == jcontent_hash(g, code)
    assert content_hash(graphs[0]) != content_hash(graphs[0], codes[0])


def test_gen_lane_and_unknown_lanes_are_refused_as_the_reference():
    from deepdfa_tpu.serve.engine import BadRequestError as JBad
    from deepdfa_tpu_torch.serve import BadRequestError

    jeng, peng = _engines()
    graphs, _ = _requests(1)
    for lane, match in (("gen", "no generation lane"),
                        ("fast", "unknown lane")):
        with pytest.raises(JBad, match=match):
            jeng.submit(graphs[0], code="int f();", lane=lane)
        with pytest.raises(BadRequestError, match=match):
            peng.submit(graphs[0], code="int f();", lane=lane)


def test_infer_factories_match_jax():
    jg = JFlowGNNConfig(feature=JFeatureSpec(**LIMITS), **GNN)
    jtext_model = JLineVul(_enc(JEncoderConfig))
    ids = np.full((3, BLOCK), 1, np.int32)
    ids[:, 0] = 0
    ids[0, 1:9] = np.arange(10, 18)
    ids[1, 1:20] = np.arange(40, 59)
    ids[2, 1:4] = [3, 7, 9]
    params = jtext_model.init({"params": jax.random.PRNGKey(4)},
                              jnp.asarray(ids), None, deterministic=True)
    want = np.asarray(jinfer.make_text_infer(jtext_model)(params,
                                                          jnp.asarray(ids)))
    pmodel = LineVul(_enc(EncoderConfig), device="cpu")
    pmodel.load_state_dict(linevul_from_flax(params))
    got = pinfer.make_text_infer(pmodel)(torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PROB_TOL)
    with pytest.raises(ValueError, match="graph encoder"):
        pinfer.make_text_infer(LineVul(_enc(EncoderConfig), dataclasses.replace(
            FlowGNNConfig(feature=FeatureSpec(**LIMITS), **GNN),
            encoder_mode=True), device="cpu"))
    with pytest.raises(ValueError, match="graph_config"):
        pinfer.make_combined_infer(pmodel)
    assert jg.feature.limit_all == LIMITS["limit_all"]


@pytest.mark.parametrize("with_code", [False, True])
def test_bursty_trace_is_the_references(with_code):
    want = jreplay.bursty_trace(60, JFeatureSpec(**LIMITS), seed=3,
                                with_code=with_code)
    got = bursty_trace(60, FeatureSpec(**LIMITS), seed=3,
                       with_code=with_code)
    assert [e.at for e in got] == [e.at for e in want]
    assert [int(e.graph["id"]) for e in got] == [
        int(e.graph["id"]) for e in want]
    assert [e.code for e in got] == [e.code for e in want]
    assert [e.at for e in bursty_trace(60, FeatureSpec(**LIMITS),
                                       seed=4)] != [e.at for e in got]


def test_replay_200_requests_matches_offline_eval():
    """The reference's acceptance gate, on the port: a 200-request trace
    after warmup completes with no new compile, at least 50 % batch
    occupancy, cache hits, and every answer equal to the offline eval
    path (``make_eval_step``'s probabilities) on the same graphs; and the
    JAX engine replaying the same trace on the converted params gives
    the same probabilities within 1e-5."""
    from deepdfa_tpu_torch.core.config import DataConfig
    from deepdfa_tpu_torch.train import loop

    feat = FeatureSpec(**LIMITS)
    jmodel = JFlowGNN(JFlowGNNConfig(feature=JFeatureSpec(**LIMITS), **GNN))
    jcfg = JServeConfig(batch_slots=8)
    jparams = random_gnn_params(jmodel, jcfg, seed=5)
    model = FlowGNN(FlowGNNConfig(feature=feat, **GNN), device="cpu")
    model.load_state_dict(flowgnn_from_flax(
        jax.tree_util.tree_map(np.asarray, jparams)))
    clock = VirtualClock()
    eng = ServeEngine(model, ServeConfig(batch_slots=8, deadline_ms=100.0),
                      clock=clock, device="cpu")
    warmed = eng.warmup()
    trace = bursty_trace(200, feat, seed=1)
    out = replay(eng, trace, clock)
    m = out["metrics"]
    assert m["compiles"] == warmed, "steady-state traffic compiled"
    assert m["completed"] == 200 and m["dropped"] == 0
    assert m["batch_occupancy"] >= 0.5
    assert m["cache_hit_rate"] > 0
    assert all(r.result is not None for r in out["requests"])

    by_id = {int(r.graph["id"]): r.result["prob"] for r in out["requests"]}
    graphs = [e.graph for e in trace]
    offline = loop.evaluate(loop.make_eval_step(model, TrainConfig()),
                            graphs, np.arange(len(graphs)),
                            DataConfig(eval_batch_size=16),
                            subkeys_for(feat), "cpu")
    for gid, p in zip(offline.graph_ids, offline.probs):
        assert by_id[int(gid)] == pytest.approx(float(p), abs=OFFLINE_TOL)

    jclock = jreplay.VirtualClock()
    jeng = JServeEngine(jmodel, jparams, config=jcfg, clock=jclock)
    jeng.warmup()
    jout = jreplay.replay(jeng, jreplay.bursty_trace(
        200, JFeatureSpec(**LIMITS), seed=1), jclock)
    assert jout["metrics"]["completed"] == 200
    np.testing.assert_allclose(
        [r.result["prob"] for r in out["requests"]],
        [r.result["prob"] for r in jout["requests"]], rtol=0, atol=PROB_TOL)
