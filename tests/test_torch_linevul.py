"""The port's DeepDFA+LineVul path (models/transformer.py,
models/linevul.py, models/convert.py, data/text.py, data/combined.py,
train/text_loop.py, cli fit-text) against the JAX package.

Inputs are made once (numpy, synthetic graphs and text from a seed) and
go through both packages; parameters are carried across with
``models/convert.py``. The JAX encoder's flash path runs its Pallas
kernels in interpret mode on the CPU; the port's runs the kernels' plain
versions. Dropout is off wherever the two are compared (their random
streams cannot match).

Tolerances: encoder outputs and logits within 1e-5 (f32 in another
order; flax's LayerNorm takes its variance as E[x^2] - E[x]^2), the
20-step loss trajectory within 1e-4, data byte for byte.
"""

import dataclasses
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from deepdfa_tpu.core.config import FeatureSpec as JFeatureSpec
from deepdfa_tpu.core.config import FlowGNNConfig as JFlowGNNConfig
from deepdfa_tpu.core.config import TransformerTrainConfig as JTrainConfig
from deepdfa_tpu.data import combined as jcombined
from deepdfa_tpu.data import text as jtext
from deepdfa_tpu.data.synthetic import synthetic_bigvul as j_synthetic
from deepdfa_tpu.models import linevul as jlinevul
from deepdfa_tpu.models import transformer as jtransformer
from deepdfa_tpu.train import text_loop as jloop
from deepdfa_tpu_torch.core.config import (
    FeatureSpec,
    FlowGNNConfig,
    TransformerTrainConfig,
)
from deepdfa_tpu_torch.data import combined, text
from deepdfa_tpu_torch.models import linevul, transformer
from deepdfa_tpu_torch.models.convert import (
    encoder_from_flax,
    linevul_from_flax,
    roberta_from_hf,
)
from deepdfa_tpu_torch.ops import attention as A
from deepdfa_tpu_torch.train import text_loop

VOCAB = 512
BLOCK = 64
SUBKEYS = ["api", "datatype", "literal", "operator"]
TOL = 1e-5
TRAJ_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread. The tier-1 run shares the cores among several
    workers, and these shapes gain nothing from more. And the first
    ``torch.exp`` of a process that splits across threads (more than 2048
    elements; MKL's ``vmsExp``, here fed the masked scores at NEG_INF) can
    come back with a relative error near 1e-4 in one thread's chunk: a
    race in MKL's first use, seen in a few percent of fresh processes at
    two threads and never at one (``scripts/torch_first_exp_race.py``).
    Run in one thread, the plain versions give the same bits every call."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _enc(pkg, **kw):
    return dataclasses.replace(pkg.EncoderConfig.tiny(vocab_size=VOCAB), **kw)


def _gcfg(pkg_flow, pkg_feat, **kw):
    return pkg_flow(feature=pkg_feat(limit_all=30), hidden_dim=4, n_steps=2,
                    encoder_mode=True, **kw)


def _ids(b=4, t=24, seed=0):
    """Token ids with <s> first, padded tails and one all-pad row."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, VOCAB, size=(b, t)).astype(np.int32)
    ids[:, 0] = 0
    for row, n in enumerate(rng.integers(t // 2, t, size=b)):
        ids[row, n:] = 1
    ids[-1] = 1
    return ids


def _np(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


# ---------------------------------------------------------------------------
# Configuration and data: field for field, byte for byte
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ctor", ["__call__", "tiny", "codebert_base",
                                  "unixcoder_base"])
def test_encoder_config_matches_jax(ctor):
    def make(pkg):
        cls = pkg.EncoderConfig
        return cls() if ctor == "__call__" else getattr(cls, ctor)()

    assert dataclasses.asdict(make(transformer)) == dataclasses.asdict(
        make(jtransformer))


def _examples(n, seed=0):
    ex = j_synthetic(n, JFeatureSpec(limit_all=30), positive_fraction=0.5,
                     seed=seed)
    for i, e in enumerate(ex):
        e["label"] = int(np.asarray(e["vuln"]).max())
        e["id"] = i
    return ex


def test_text_encoding_matches_jax():
    ex = _examples(30)
    want_rows = jtext.attach_synthetic_text([dict(e) for e in ex], seed=3)
    got_rows = text.attach_synthetic_text([dict(e) for e in ex], seed=3)
    assert [r["code"] for r in got_rows] == [r["code"] for r in want_rows]
    want = jtext.encode_dataset(want_rows, jtext.HashingCodeTokenizer(VOCAB),
                                block_size=BLOCK)
    got = text.encode_dataset(got_rows, text.HashingCodeTokenizer(VOCAB),
                              block_size=BLOCK)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert got[k].tobytes() == want[k].tobytes(), k
    # Truncation keeps <s> ... </s> around block_size - 2 tokens.
    ids = text.encode_function("a " * 40, text.HashingCodeTokenizer(VOCAB), 8)
    assert ids.tolist()[0] == 0 and ids.tolist()[-1] == 2 and len(ids) == 8


def test_combined_dataset_and_budget_match_jax():
    tok_j, tok_p = jtext.HashingCodeTokenizer(VOCAB), text.HashingCodeTokenizer(
        VOCAB)
    jd, js, jg = jcombined.load_combined_dataset(
        "synthetic:40", JFeatureSpec(limit_all=30), tok_j, BLOCK,
        graphs="synthetic", seed=2)
    pd, ps, pg = combined.load_combined_dataset(
        "synthetic:40", FeatureSpec(limit_all=30), tok_p, BLOCK,
        graphs="synthetic", seed=2)
    for k in jd:
        assert pd[k].tobytes() == jd[k].tobytes(), k
    for k in js:
        assert ps[k].tobytes() == js[k].tobytes(), k
    assert sorted(pg) == sorted(jg)
    for kw in ({}, {"max_nodes": 300, "max_edges": 900}):
        want = jcombined.graph_join_and_budget(list(jg.values()), 8, **kw)[1]
        got = combined.graph_join_and_budget(list(pg.values()), 8, **kw)[1]
        assert got == want
    with pytest.raises(ValueError, match="synthetic"):
        combined.load_combined_dataset("data/msr", FeatureSpec(), tok_p, 8)


@pytest.mark.parametrize("band", [False, True])
def test_text_graph_batches_match_jax(band):
    """Missing graphs and over-budget graphs masked, a padded last batch,
    the shuffle: every array byte for byte."""
    ex = _examples(21, seed=1)
    rows = jtext.attach_synthetic_text([dict(e) for e in ex], seed=0)
    data = jtext.encode_dataset(rows, jtext.HashingCodeTokenizer(VOCAB),
                                block_size=BLOCK)
    graphs = {int(e["id"]): e for e in ex if int(e["id"]) % 5 != 3}
    budget = {"max_nodes": 160, "max_edges": 640}  # tight: some overflow
    kw = dict(graphs_by_id=graphs, subkeys=SUBKEYS, graph_budget=budget,
              build_band_adj=band)
    want = list(jloop.text_graph_batches(
        data, np.arange(21), 8, shuffle_rng=np.random.default_rng(4), **kw))
    got = list(text_loop.text_graph_batches(
        data, np.arange(21), 8, shuffle_rng=np.random.default_rng(4), **kw))
    assert len(got) == len(want) == 3
    assert sum(b.n_missing for b in got) > 4  # missing and over budget
    for gb, jb in zip(got, want):
        assert gb.n_missing == jb.n_missing
        for name in ("input_ids", "labels", "example_mask", "index"):
            a, b = getattr(gb, name), getattr(jb, name)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
        for name in ("node_vuln", "senders", "receivers", "node_graph",
                     "node_mask", "edge_mask", "graph_mask", "graph_ids"):
            a, b = _np(getattr(gb.graphs, name)), _np(getattr(jb.graphs,
                                                              name))
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
        for k in SUBKEYS:
            assert _np(gb.graphs.node_feats[k]).tobytes() == _np(
                jb.graphs.node_feats[k]).tobytes()
        if band:
            assert gb.graphs.band_adj.bandwidth == jb.graphs.band_adj.bandwidth
            assert _np(gb.graphs.band_adj.vals).tobytes() == _np(
                jb.graphs.band_adj.vals).tobytes()


@pytest.mark.parametrize("max_steps,frac", [(10, 0.2), (7, 0.2), (1, 0.2),
                                            (30, 0.5)])
def test_schedule_matches_jax(max_steps, frac):
    want = jloop.make_schedule(JTrainConfig(warmup_fraction=frac), max_steps)
    got = text_loop.make_schedule(
        TransformerTrainConfig(warmup_fraction=frac), max_steps)
    for count in range(max_steps + 3):
        assert np.float32(got(count)) == np.float32(want(count)), count
    assert got(0) == 0.0  # the first update runs at lr 0


# ---------------------------------------------------------------------------
# Models on converted parameters
# ---------------------------------------------------------------------------


def _encoder_pair(impl="dense", gelu_approximate=True, **kw):
    jcfg = _enc(jtransformer, attention_impl=impl,
                gelu_approximate=gelu_approximate, **kw)
    pcfg = _enc(transformer, attention_impl=impl,
                gelu_approximate=gelu_approximate, **kw)
    params = jtransformer.RobertaEncoder(jcfg).init(
        jax.random.PRNGKey(0), jnp.asarray(_ids()))
    enc = transformer.RobertaEncoder(pcfg, torch.Generator().manual_seed(0))
    enc.load_state_dict(encoder_from_flax(params))
    return jcfg, params, enc


@pytest.mark.parametrize("impl", ["dense", "flash"])
@pytest.mark.parametrize("gelu_approximate", [True, False])
def test_encoder_matches_jax(impl, gelu_approximate):
    jcfg, params, enc = _encoder_pair(impl, gelu_approximate)
    ids = _ids()
    want, _ = jtransformer.RobertaEncoder(jcfg).apply(params, jnp.asarray(ids))
    got, _ = enc(torch.from_numpy(ids))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=TOL, rtol=TOL)


def test_positions_past_the_table_clamp_as_in_jax():
    # 80 tokens ride the tiny 66-entry position table (as T 4096 rides
    # codebert's 514): ids past it clamp to the last entry.
    jcfg, params, enc = _encoder_pair("dense")
    ids = _ids(b=2, t=80, seed=3)
    want, _ = jtransformer.RobertaEncoder(jcfg).apply(params, jnp.asarray(ids))
    got, _ = enc(torch.from_numpy(ids))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=TOL, rtol=TOL)


def test_input_embeds_replace_the_word_lookup():
    enc = transformer.RobertaEncoder(_enc(transformer, attention_impl="flash"),
                                     torch.Generator().manual_seed(0))
    ids = torch.from_numpy(_ids())
    want, _ = enc(ids)
    embeds = enc.word_embeddings(ids).detach().requires_grad_()
    got, _ = enc(ids, input_embeds=embeds)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    got.sum().backward()  # the attribution hook: a gradient wrt embeds
    assert embeds.grad is not None and torch.isfinite(embeds.grad).all()


def test_output_attentions_dense_only():
    jcfg, params, enc = _encoder_pair("dense")
    ids = _ids()
    _, want = jtransformer.RobertaEncoder(jcfg).apply(
        params, jnp.asarray(ids), output_attentions=True)
    _, got = enc(torch.from_numpy(ids), output_attentions=True)
    assert len(got) == len(want) == jcfg.num_layers
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=TOL)
    _, _, flash = _encoder_pair("flash")
    with pytest.raises(ValueError, match="output_attentions"):
        flash(torch.from_numpy(ids), output_attentions=True)


def _encoder_grads(enc, ids, deterministic=True, seed=None):
    enc.zero_grad(set_to_none=True)
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    out, _ = enc(torch.from_numpy(ids), deterministic=deterministic,
                 generator=gen)
    (out ** 2).sum().backward()
    return {k: p.grad.clone() for k, p in enc.named_parameters()}


@pytest.mark.parametrize("dropout_on", [False, True])
def test_remat_equals_no_remat(dropout_on):
    ids = _ids()
    plain = transformer.RobertaEncoder(_enc(transformer, attention_impl="flash"),
                                       torch.Generator().manual_seed(0))
    remat = transformer.RobertaEncoder(
        _enc(transformer, attention_impl="flash", remat_layers=True),
        torch.Generator())
    remat.load_state_dict(plain.state_dict())
    kw = dict(deterministic=not dropout_on, seed=5 if dropout_on else None)
    a, b = _encoder_grads(plain, ids, **kw), _encoder_grads(remat, ids, **kw)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_encoder_matches_hf_roberta(monkeypatch):
    # The comparison is with HF's torch model: keep transformers from
    # importing TensorFlow as well (about half of this test's time).
    monkeypatch.setenv("USE_TF", "0")
    tr = pytest.importorskip("transformers")
    cfg = _enc(transformer, gelu_approximate=False)
    hf_cfg = tr.RobertaConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        num_hidden_layers=cfg.num_layers, num_attention_heads=cfg.num_heads,
        intermediate_size=cfg.intermediate_size,
        max_position_embeddings=cfg.max_position_embeddings,
        type_vocab_size=1, pad_token_id=1, layer_norm_eps=cfg.layer_norm_eps,
        attention_probs_dropout_prob=0.0, hidden_dropout_prob=0.0)
    torch.manual_seed(0)
    hf = tr.RobertaModel(hf_cfg, add_pooling_layer=False).eval()
    ids = _ids()[:-1].astype(np.int64)  # HF gives an all-pad row NaN-free
    with torch.no_grad():
        want = hf(torch.from_numpy(ids),
                  attention_mask=torch.from_numpy(ids != 1)).last_hidden_state
    for prefix in ("", "roberta."):
        sd = {prefix + k: v for k, v in hf.state_dict().items()}
        enc = transformer.RobertaEncoder(cfg, torch.Generator())
        enc.load_state_dict(roberta_from_hf(sd))
        with torch.no_grad():
            got, _ = enc(torch.from_numpy(ids))
        keep = torch.from_numpy(ids != 1)
        torch.testing.assert_close(got[keep], want[keep], atol=TOL, rtol=TOL)


def _linevul_pair(combined_model=True, impl="flash", dropout_rate=0.1,
                  message_impl="segment"):
    jcfg = _enc(jtransformer, attention_impl=impl, dropout_rate=dropout_rate)
    pcfg = _enc(transformer, attention_impl=impl, dropout_rate=dropout_rate)
    jg = (_gcfg(JFlowGNNConfig, JFeatureSpec, message_impl=message_impl)
          if combined_model else None)
    pg = (_gcfg(FlowGNNConfig, FeatureSpec, message_impl=message_impl)
          if combined_model else None)
    return jlinevul.LineVul(jcfg, jg), linevul.LineVul(pcfg, pg,
                                                       device="cpu")


def _combined_batch(n=12, seed=0, batch=8):
    ex = _examples(n, seed)
    rows = jtext.attach_synthetic_text([dict(e) for e in ex], seed=seed)
    data = jtext.encode_dataset(rows, jtext.HashingCodeTokenizer(VOCAB),
                                block_size=BLOCK)
    graphs = {int(e["id"]): e for e in ex}
    kw = dict(graphs_by_id=graphs, subkeys=SUBKEYS,
              graph_budget={"max_nodes": 512, "max_edges": 2048})
    idx = np.arange(min(n, batch - 2))  # two padded, all-pad rows
    return (next(jloop.text_graph_batches(data, idx, batch, **kw)),
            next(text_loop.text_graph_batches(data, idx, batch, **kw)),
            data, graphs, kw)


@pytest.mark.parametrize("combined_model", [True, False])
@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_linevul_logits_match_jax(combined_model, impl):
    jmodel, pmodel = _linevul_pair(combined_model, impl)
    jb, pb, *_ = _combined_batch()
    graphs_j = jb.graphs if combined_model else None
    params = jmodel.init({"params": jax.random.PRNGKey(0)},
                         jnp.asarray(jb.input_ids), graphs_j)
    pmodel.load_state_dict(linevul_from_flax(params))
    want = np.asarray(jmodel.apply(params, jnp.asarray(jb.input_ids),
                                   graphs_j))
    with torch.no_grad():
        got = pmodel(torch.from_numpy(pb.input_ids),
                     pb.graphs if combined_model else None).numpy()
    assert got.shape == (8, 2) and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_cross_entropy_neutralizes_masked_rows():
    logits = np.array([[0.3, -1.2], [np.nan, np.inf], [2.0, 0.5],
                       [-np.inf, 1.0]], np.float32)
    labels = np.array([1, 0, 0, 1], np.int32)
    mask = np.array([True, False, True, False])
    want = float(jlinevul.cross_entropy_loss(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask)))
    lt = torch.from_numpy(logits).requires_grad_()
    loss = linevul.cross_entropy_loss(lt, torch.from_numpy(labels),
                                      torch.from_numpy(mask))
    assert abs(float(loss.detach()) - want) <= TOL
    loss.backward()
    assert torch.isfinite(lt.grad).all()
    assert torch.all(lt.grad[~torch.from_numpy(mask)] == 0)
    none = linevul.cross_entropy_loss(lt, torch.from_numpy(labels),
                                      torch.zeros(4, dtype=torch.bool))
    assert float(none.detach()) == 0.0


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def _trajectory_gap(message_impl="segment"):
    """20 train steps (TINY encoder + a tiny FlowGNN with this
    ``message_impl``, dropout off): the port's step (flash's plain
    versions through the autograd Function, clip, AdamW at the scheduled
    lr) against make_text_train_step (blockwise attention, the JAX
    package's "auto" on the CPU). Returns (port losses, JAX losses)."""
    jmodel, pmodel = _linevul_pair(True, "auto", dropout_rate=0.0,
                                   message_impl=message_impl)
    _, _, data, graphs, kw = _combined_batch(n=48, batch=8)
    kw = dict(kw, build_tile_adj=message_impl == "tile")
    train = np.arange(40)
    cfg_j = JTrainConfig(batch_size=8, max_epochs=4, learning_rate=1e-3,
                         block_size=BLOCK)
    cfg_p = TransformerTrainConfig(batch_size=8, max_epochs=4,
                                   learning_rate=1e-3, block_size=BLOCK)
    max_steps = 20

    def batches(loop):
        rng = np.random.default_rng(0)
        while True:
            yield from loop.text_graph_batches(data, train, 8,
                                               shuffle_rng=rng, **kw)

    jb = batches(jloop)
    example = next(jloop.text_graph_batches(data, train, 8, **kw))
    state, tx = jloop.make_text_train_state(jmodel, example, cfg_j, max_steps)
    pmodel.load_state_dict(linevul_from_flax(state.params))
    jstep = jax.jit(jloop.make_text_train_step(jmodel, tx, cfg_j))
    want = []
    for _ in range(max_steps):
        b = next(jb)
        state, loss, _ = jstep(state, jnp.asarray(b.input_ids),
                               jnp.asarray(b.labels),
                               jnp.asarray(b.example_mask), b.graphs)
        want.append(float(loss))

    opt = text_loop.make_text_optimizer(pmodel.parameters(), cfg_p)
    step = text_loop.make_text_train_step(pmodel, opt, cfg_p)
    schedule = text_loop.make_schedule(cfg_p, max_steps)
    pb = batches(text_loop)
    got = [float(step(next(pb), schedule(i))[0]) for i in range(max_steps)]
    return got, want


def test_train_trajectory_matches_jax():
    got, want = _trajectory_gap()
    np.testing.assert_allclose(got, want, atol=TRAJ_TOL, rtol=0)
    assert want[-1] < want[0]  # it trains


def test_tile_graph_encoder_trajectory_matches_jax():
    """The same 20 steps with the graph encoder's ``message_impl="tile"``
    (the counterpart of tests/test_tile_pipeline.py:77): the port's tile
    product and its VJP against the JAX package's."""
    got, want = _trajectory_gap("tile")
    np.testing.assert_allclose(got, want, atol=TRAJ_TOL, rtol=0)
    assert want[-1] < want[0]


def _fit_setup(n=40, **cfg_kw):
    tok = text.HashingCodeTokenizer(VOCAB)
    data, splits, graphs = combined.load_combined_dataset(
        f"synthetic:{n}", FeatureSpec(limit_all=30), tok, 32,
        graphs="synthetic", seed=1)
    graphs, budget = combined.graph_join_and_budget(list(graphs.values()), 8)
    model = linevul.LineVul(_enc(transformer, attention_impl="auto",
                                 max_position_embeddings=40),
                            _gcfg(FlowGNNConfig, FeatureSpec), device="cpu")
    cfg = TransformerTrainConfig(batch_size=8, block_size=32,
                                 learning_rate=1e-3, **cfg_kw)
    return model, data, splits, cfg, dict(graphs_by_id=graphs,
                                          subkeys=SUBKEYS,
                                          graph_budget=budget)


def test_fit_text_history_best_state_and_early_stop():
    model, data, splits, cfg, kw = _fit_setup(max_epochs=3,
                                              early_stop_patience=0)
    best, history = text_loop.fit_text(model, data, splits, cfg, **kw)
    e = history["epochs"]
    assert 1 <= len(e) <= 3
    assert len(e) < 3 or not history.get("early_stopped")
    assert len(e[0]["step_losses"]) == 4  # 32 training rows, batches of 8
    assert all(np.isfinite(e[0]["step_losses"]))
    assert {"train_loss", "train_metrics", "val_loss", "val_metrics",
            "num_missing", "seconds"} <= set(e[0])
    assert history["best_epoch"] == int(np.argmax(
        [r["val_metrics"]["f1"] for r in e]))
    assert best.step == 4 * (history["best_epoch"] + 1)
    if len(e) < 3:  # patience 0: the first epoch without a gain stops
        assert history["early_stopped"]


@pytest.mark.parametrize("policy", ["raise", "rollback"])
def test_fit_text_anomaly_guard(monkeypatch, policy):
    model, data, splits, cfg, kw = _fit_setup(
        max_epochs=2, detect_anomaly=True, anomaly_policy=policy)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    real = text_loop.cross_entropy_loss
    calls = {"n": 0}

    def poisoned(logits, labels, mask):
        calls["n"] += 1
        loss = real(logits, labels, mask)
        return loss * float("nan") if calls["n"] == 2 else loss

    monkeypatch.setattr(text_loop, "cross_entropy_loss", poisoned)
    if policy == "raise":
        with pytest.raises(FloatingPointError, match="epoch 0"):
            text_loop.fit_text(model, data, splits, cfg, **kw)
        return
    _, history = text_loop.fit_text(model, data, splits, cfg, **kw)
    assert history["anomaly_rollbacks"] == 1
    assert history["epochs"][0]["rolled_back"]
    assert "rolled_back" not in history["epochs"][1]
    assert not any(torch.equal(start[k], v)
                   for k, v in model.state_dict().items()
                   if k.endswith("query.weight"))  # epoch 1 trained


def test_cli_fit_text_on_cpu(tmp_path, capsys):
    from deepdfa_tpu_torch.cli import main

    out = tmp_path / "run"
    assert main(["fit-text", "--dataset", "synthetic:40", "--graphs",
                 "synthetic", "--tiny", "--block-size", "32", "--epochs", "1",
                 "--batch-size", "8", "--device", "cpu", "--out-dir",
                 str(out)]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["best_epoch"] == 0 and "f1" in result["test"]
    desc = json.loads((out / "model.json").read_text())
    assert desc["combined"] and desc["attention_impl"] == "auto"
    assert desc["graph_config"]["encoder_mode"]
    history = json.loads((out / "history.json").read_text())
    # On the CPU the wrappers take the plain versions: no launches.
    assert history["kernel_launches"] == dict.fromkeys(A.KERNELS, 0)
    lines = (out / "predictions.csv").read_text().splitlines()
    assert lines[0] == "index,prob,label" and len(lines) == 1 + 4


@pytest.mark.parametrize("impl", ["auto", "flash"])
def test_cli_fit_text_tiny_refuses_the_card_kernels(tmp_path, impl):
    # The tiny encoder's head width is 8; the CUDA kernels take 64. The
    # refusal comes before a model is built or a device is touched.
    from deepdfa_tpu_torch.cli import main

    with pytest.raises(ValueError, match="--attention-impl dense"):
        main(["fit-text", "--tiny", "--device", "cuda", "--attention-impl",
              impl, "--out-dir", str(tmp_path / "run")])


def test_smoke_gradient_check_catches_a_zeroed_dq(monkeypatch):
    """chip_smoke's card-against-CPU gradient check passes equal
    gradients and refuses a backward whose dq is dropped (the first
    tensor it reads, the word embeddings, then misses by about 1e-1 of
    its largest entry against the 1e-4 limit)."""
    import chip_smoke

    model, data, splits, cfg, kw = _fit_setup()
    batch = next(text_loop.text_graph_batches(data, splits["train"], 8,
                                              **kw))
    good = chip_smoke._text_grads(model, batch, "cpu")
    same = chip_smoke._compare_text_grads(good, good)
    assert same["grad_gap_share_of_limit"] == 0.0
    assert same["tensors"] == len(list(model.parameters()))
    fused = A.flash_bwd_fused

    def no_dq(*args, **kwargs):
        dq, dk, dv = fused(*args, **kwargs)
        return torch.zeros_like(dq), dk, dv

    monkeypatch.setattr(A, "flash_bwd_fused", no_dq)
    bad = chip_smoke._text_grads(model, batch, "cpu")
    with pytest.raises(AssertionError, match=r"gradient of \S+: \|card"):
        chip_smoke._compare_text_grads(bad, good)
