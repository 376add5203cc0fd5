"""The port's T5 stack and CodeT5 defect model (models/t5.py, the T5
converters of models/convert.py, ``t5_config_from_hf`` and
``load_pretrained``'s t5 branch, the t5 text encoding) against the JAX
package and HuggingFace's ``T5ForConditionalGeneration``.

Inputs are made from numpy seeds and go through both packages;
parameters are carried across with ``t5_from_flax``/``defect_from_flax``.
A combined model's fused and persistent graph lanes run the JAX Pallas
kernels in interpret mode and the port's plain versions. Dropout is off
wherever the two are compared.

Tolerances: position buckets, eos pooling, ``shift_right`` and the
encodings byte for byte (over every distance in [-1024, 1024]); T5
hidden states, tied logits and DefectModel logits within 1e-5 (f32 in
another order); gradients within 1e-5 of each tensor's largest entry
(plus 1e-8 for entries that are zero in exact arithmetic, such as the
pooling gate's bias); the decoder hidden state of an HF T5 read through
``load_pretrained`` within 1e-5 of HF torch.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from deepdfa_tpu.core.config import FeatureSpec as JFeatureSpec
from deepdfa_tpu.core.config import FlowGNNConfig as JFlowGNNConfig
from deepdfa_tpu.data import combined as jcombined
from deepdfa_tpu.data import text as jtext
from deepdfa_tpu.data.synthetic import synthetic_bigvul as j_synthetic
from deepdfa_tpu.models import linevul as jlinevul
from deepdfa_tpu.models import t5 as jt5
from deepdfa_tpu.train import text_loop as jloop
from deepdfa_tpu_torch.core.config import FeatureSpec, FlowGNNConfig
from deepdfa_tpu_torch.data import combined, text
from deepdfa_tpu_torch.models import t5
from deepdfa_tpu_torch.models.convert import (
    defect_from_flax,
    t5_from_flax,
    t5_from_hf,
    t5_to_hf,
)
from deepdfa_tpu_torch.models.linevul import cross_entropy_loss
from deepdfa_tpu_torch.models.pretrained import (
    load_pretrained,
    t5_config_from_hf,
    write_safetensors,
)
from deepdfa_tpu_torch.train import text_loop

BLOCK = 48
SUBKEYS = ["api", "datatype", "literal", "operator"]
TOL = 1e-5
GRAD_TOL = 1e-5
GRAD_FLOOR = 1e-8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the first multi-threaded ``torch.exp`` of a
    process can be off in one thread's chunk (MKL's first use,
    ``scripts/torch_first_exp_race.py``), and these shapes gain nothing
    from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    return (dataclasses.replace(jt5.T5Config.tiny(), **kw),
            dataclasses.replace(t5.T5Config.tiny(), **kw))


def _ids(b=4, t=24, seed=0, vocab=128):
    """Token ids: rows of different lengths ending in </s> (2), one row
    with two eos, one with none, and one all-pad row (pad 0)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, vocab, size=(b, t)).astype(np.int32)
    ids[:, 0] = 1
    for row, n in enumerate(rng.integers(t // 2, t - 1, size=b)):
        ids[row, n] = 2
        ids[row, n + 1:] = 0
    ids[0, 3] = 2  # two eos: the last one pools
    ids[1, ids[1] == 2] = 5  # no eos: position 0 pools
    ids[-1] = 0
    return ids


# ---------------------------------------------------------------------------
# Configuration, buckets, pooling, encodings: field for field, byte for byte
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ctor", ["__call__", "tiny", "codet5_small",
                                  "codet5_base", "codet5_large"])
def test_t5_config_matches_jax(ctor):
    def make(pkg):
        cls = pkg.T5Config
        return cls() if ctor == "__call__" else getattr(cls, ctor)()

    assert dataclasses.asdict(make(t5)) == dataclasses.asdict(make(jt5))


@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("num_buckets,max_distance", [(32, 128), (16, 40)])
def test_relative_position_bucket_matches_jax(bidirectional, num_buckets,
                                              max_distance):
    dist = np.arange(-1024, 1025, dtype=np.int32)
    want = np.asarray(jt5.relative_position_bucket(
        jnp.asarray(dist), bidirectional, num_buckets, max_distance))
    got = t5.relative_position_bucket(torch.from_numpy(dist), bidirectional,
                                      num_buckets, max_distance).numpy()
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    # The [Q, K] grid the attention reads, as the reference builds it.
    grid = t5._bucket_grid(7, 300, bidirectional, num_buckets, max_distance,
                           torch.device("cpu"))
    ctx, mem = np.arange(7)[:, None], np.arange(300)[None, :]
    want = np.asarray(jt5.relative_position_bucket(
        jnp.asarray(mem - ctx), bidirectional, num_buckets, max_distance))
    assert np.array_equal(grid.numpy(), want)


def test_last_eos_vector_and_shift_right_match_jax():
    ids = _ids(b=5, t=16, seed=3)
    hidden = np.random.default_rng(1).standard_normal(
        (5, 16, 8)).astype(np.float32)
    want = np.asarray(jt5.last_eos_vector(jnp.asarray(hidden),
                                          jnp.asarray(ids), 2))
    got = t5.last_eos_vector(torch.from_numpy(hidden),
                             torch.from_numpy(ids), 2).numpy()
    assert got.tobytes() == want.tobytes()
    assert np.array_equal(got[1], hidden[1, 0])  # no eos: position 0
    for start in (0, 7):
        want = np.asarray(jt5.shift_right(jnp.asarray(ids), start))
        got = t5.shift_right(torch.from_numpy(ids), start).numpy()
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def _examples(n, seed=0):
    ex = j_synthetic(n, JFeatureSpec(limit_all=30), positive_fraction=0.5,
                     seed=seed)
    for i, e in enumerate(ex):
        e["label"] = int(np.asarray(e["vuln"]).max())
        e["id"] = i
    return ex


@pytest.mark.parametrize("block", [32, 64])
def test_t5_encoding_matches_jax(block):
    ex = _examples(20)
    rows = jtext.attach_synthetic_text([dict(e) for e in ex], seed=3)
    want = jtext.encode_dataset(rows, jtext.HashingT5Tokenizer(128),
                                block_size=block, style="t5")
    got = text.encode_dataset(rows, text.HashingT5Tokenizer(128),
                              block_size=block, style="t5")
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert got[k].tobytes() == want[k].tobytes(), k
    # Exactly one </s> a row, <s> first, padded with 0.
    ids = got["input_ids"]
    assert (ids == 2).sum(axis=1).tolist() == [1] * len(rows)
    assert (ids[:, 0] == 1).all()
    long = text.encode_function_t5("a " * 100, text.HashingT5Tokenizer(128),
                                   8)
    assert long.tolist()[0] == 1 and long.tolist()[-1] == 2
    tok = text.HashingT5Tokenizer(128)
    assert (tok.pad_token_id, tok.bos_token_id, tok.eos_token_id) == (0, 1, 2)
    assert min(tok.convert_tokens_to_ids(tok.tokenize(rows[0]["code"]))) >= 3
    for pkg in (jtext, text):
        with pytest.raises(ValueError) as err:
            pkg.encode_dataset(rows, pkg.HashingT5Tokenizer(128), 8,
                               style="bert")
        assert "unknown encoding style" in str(err.value)


def test_t5_encoding_of_bpe_assets_matches_jax(tmp_path):
    pytest.importorskip("tokenizers")
    from deepdfa_tpu.etl.tokenizer_train import train_bpe

    ex = _examples(30)
    rows = jtext.attach_synthetic_text([dict(e) for e in ex], seed=0)
    corpus = tmp_path / "corpus.txt"
    corpus.write_text("\n".join(r["code"] for r in rows))
    train_bpe([str(corpus)], str(tmp_path / "bpe"), prefix="codet5",
              vocab_size=400, min_frequency=2)
    j = jtext.load_bpe_tokenizer(str(tmp_path / "bpe"))
    p = text.load_bpe_tokenizer(str(tmp_path / "bpe"))
    assert (p.pad_token_id, p.bos_token_id, p.eos_token_id) == (0, 1, 2)
    want = jtext.encode_dataset(rows, j, block_size=BLOCK, style="t5")
    got = text.encode_dataset(rows, p, block_size=BLOCK, style="t5")
    for k in want:
        assert got[k].tobytes() == want[k].tobytes(), k
    text.check_tok_vocab(p, 32100, pad_id=0, eos_id=2)


def test_combined_dataset_t5_style_matches_jax():
    block = 160  # longer than every synthetic function: padded tails
    jd, js, jg = jcombined.load_combined_dataset(
        "synthetic:30", JFeatureSpec(limit_all=30),
        jtext.HashingT5Tokenizer(128), block, style="t5", graphs="synthetic",
        seed=2)
    pd, ps, pg = combined.load_combined_dataset(
        "synthetic:30", FeatureSpec(limit_all=30),
        text.HashingT5Tokenizer(128), block, style="t5", graphs="synthetic",
        seed=2)
    for k in jd:
        assert pd[k].tobytes() == jd[k].tobytes(), k
    for k in js:
        assert ps[k].tobytes() == js[k].tobytes(), k
    assert sorted(pg) == sorted(jg)
    assert (pd["input_ids"] == 0).any()  # padded with codet5's pad id


# ---------------------------------------------------------------------------
# The T5 stack and DefectModel against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("tie", [True, False])
def test_t5_model_matches_jax(gated, tie):
    jcfg, pcfg = _cfgs(gated_ffn=gated, tie_word_embeddings=tie,
                       dropout_rate=0.0)
    ids = _ids()
    dec = np.asarray(jt5.shift_right(jnp.asarray(ids), 0))
    mask = ids != 0
    jm = jt5.T5Model(jcfg)
    # Through logits too: an untied model's lm_head is made on first use.
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(ids),
                     jnp.asarray(dec),
                     method=lambda m, i, d: m.logits(m(i, d)))
    want = np.asarray(jm.apply(params, jnp.asarray(ids), jnp.asarray(dec),
                               attn_mask=jnp.asarray(mask),
                               decoder_mask=jnp.asarray(mask)))
    want_enc = np.asarray(jm.apply(params, jnp.asarray(ids),
                                   jnp.asarray(mask),
                                   method=jt5.T5Model.encode))
    want_logits = np.asarray(jm.apply(params, jnp.asarray(want),
                                      method=jt5.T5Model.logits))
    pm = t5.T5Model(pcfg, device="cpu")
    pm.load_state_dict(t5_from_flax(params))
    pids = torch.from_numpy(ids)
    with torch.no_grad():
        got = pm(pids, torch.from_numpy(dec), attn_mask=pids != 0,
                 decoder_mask=pids != 0).numpy()
        got_enc = pm.encode(pids, pids != 0).numpy()
        got_logits = pm.logits(torch.from_numpy(want)).numpy()
    assert got.shape == (4, 24, 32) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got_enc, want_enc, atol=TOL, rtol=TOL)
    assert got_logits.shape == (4, 24, 128)
    np.testing.assert_allclose(got_logits, want_logits, atol=TOL, rtol=TOL)
    # The reference's default masks: the source's pad mask, all-ones for
    # the decoder.
    want = np.asarray(jm.apply(params, jnp.asarray(ids), jnp.asarray(dec)))
    with torch.no_grad():
        got = pm(pids, torch.from_numpy(dec)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def _graph_cfgs(impl):
    kw = dict(hidden_dim=4, n_steps=2, encoder_mode=True, message_impl=impl)
    return (JFlowGNNConfig(feature=JFeatureSpec(limit_all=30), **kw),
            FlowGNNConfig(feature=FeatureSpec(limit_all=30), **kw))


def _defect_batch(impl, n=10, batch=8, seed=0):
    """One t5-style batch (6 examples, 2 padded rows) from both packages'
    ``text_graph_batches``."""
    ex = _examples(n, seed)
    rows = jtext.attach_synthetic_text([dict(e) for e in ex], seed=seed)
    data = jtext.encode_dataset(rows, jtext.HashingT5Tokenizer(128),
                                block_size=BLOCK, style="t5")
    graphs = {int(e["id"]): e for e in ex}
    kw = dict(graphs_by_id=graphs, subkeys=SUBKEYS,
              graph_budget={"max_nodes": 512, "max_edges": 2048}, pad_id=0,
              build_band_adj=impl in ("fused", "persistent"))
    idx = np.arange(batch - 2)
    return (next(jloop.text_graph_batches(data, idx, batch, **kw)),
            next(text_loop.text_graph_batches(data, idx, batch, **kw)))


def _defect_pair(impl, monkeypatch, gated=False):
    """(JAX DefectModel, its params, port DefectModel, JAX batch, port
    batch); ``impl`` None: CodeT5 alone."""
    if impl in ("fused", "persistent"):
        monkeypatch.setenv("DEEPDFA_FUSED_IMPL", "interpret")
    jcfg, pcfg = _cfgs(dropout_rate=0.0, gated_ffn=gated)
    jg, pg = _graph_cfgs(impl) if impl else (None, None)
    jb, pb = _defect_batch(impl or "segment")
    jm = jt5.DefectModel(jcfg, graph_config=jg)
    jgraphs = jb.graphs if impl else None
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(jb.input_ids),
                     jgraphs)
    pm = t5.DefectModel(pcfg, graph_config=pg, device="cpu")
    pm.load_state_dict(defect_from_flax(params))
    return jm, params, pm, jb, pb


@pytest.mark.parametrize("impl", [None, "segment", "fused", "persistent"])
def test_defect_model_logits_match_jax(impl, monkeypatch):
    jm, params, pm, jb, pb = _defect_pair(impl, monkeypatch)
    want = np.asarray(jm.apply(params, jnp.asarray(jb.input_ids),
                               jb.graphs if impl else None))
    with torch.no_grad():
        got = pm(torch.from_numpy(pb.input_ids),
                 pb.graphs if impl else None).numpy()
    assert got.shape == (8, 2) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    assert pm.pad_token_id == 0


@pytest.mark.parametrize("impl,gated", [(None, False), (None, True),
                                        ("segment", False),
                                        ("persistent", False)])
def test_defect_model_gradients_match_jax(impl, gated, monkeypatch):
    jm, params, pm, jb, pb = _defect_pair(impl, monkeypatch, gated)
    jgraphs = jb.graphs if impl else None

    def loss(p):
        logits = jm.apply(p, jnp.asarray(jb.input_ids), jgraphs)
        return jlinevul.cross_entropy_loss(
            logits, jnp.asarray(jb.labels), jnp.asarray(jb.example_mask))

    want = defect_from_flax(jax.grad(loss)(params))
    out = cross_entropy_loss(
        pm(torch.from_numpy(pb.input_ids), pb.graphs if impl else None),
        torch.from_numpy(pb.labels), torch.from_numpy(pb.example_mask))
    out.backward()
    got = {k: p.grad for k, p in pm.named_parameters()}
    assert got.keys() == want.keys()
    for k, g in got.items():
        w = want[k]
        assert g is not None and torch.isfinite(g).all(), k
        err = float((g - w).abs().max())
        assert err <= GRAD_TOL * float(w.abs().max()) + GRAD_FLOOR, (k, err)


def test_dropout_is_seeded_and_off_in_eval():
    _, pcfg = _cfgs(dropout_rate=0.3)
    model = t5.DefectModel(pcfg, device="cpu", seed=4)
    ids = torch.from_numpy(_ids())

    def run(seed):
        return model(ids, deterministic=False,
                     generator=torch.Generator().manual_seed(seed))

    with torch.no_grad():
        a, b, c = run(0), run(0), run(1)
        e1, e2 = model(ids), model(ids)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(e1, e2) and not torch.equal(a, e1)


def test_decode_and_bf16_are_refused():
    _, pcfg = _cfgs()
    model = t5.T5Model(pcfg, device="cpu")
    ids = torch.from_numpy(_ids())
    enc = model.encode(ids, ids != 0)
    for kw in ({"decode": True}, {"beam_anc": torch.zeros(4, 1, 24)}):
        with pytest.raises(NotImplementedError, match="A5b"):
            model.decode(ids, ids != 0, enc, ids != 0, **kw)
    # bf16 builds and runs (its parity: tests/test_torch_bf16_text.py),
    # f32 parameters and an f32 hidden state; other dtypes are refused.
    bf16 = t5.T5Model(dataclasses.replace(pcfg, dtype="bfloat16"),
                      device="cpu")
    assert all(p.dtype == torch.float32 for p in bf16.parameters())
    with torch.no_grad():
        assert bf16.encode(ids, ids != 0).dtype == torch.float32
    with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
        t5.T5Model(dataclasses.replace(pcfg, dtype="float16"), device="cpu")
    with pytest.raises(ValueError, match="encoder_mode"):
        t5.DefectModel(pcfg, FlowGNNConfig(hidden_dim=4), device="cpu")
    combined_model = t5.DefectModel(pcfg, _graph_cfgs("segment")[1],
                                    device="cpu")
    with pytest.raises(ValueError, match="GraphBatch"):
        combined_model(ids)


def test_init_follows_the_reference_scales():
    """Each tensor's spread is the flax initializer's: normal stds of
    (d_model d_kv)^-1/2 (q), d_model^-1/2 (k, v, wi, the bias table,
    the shared embedding), (H d_kv)^-1/2 (o), d_ff^-1/2 (wo); RMS norm
    weights 1; the classifier lecun-normal with a zero bias."""
    cfg = dataclasses.replace(t5.T5Config.tiny(), d_model=64, d_kv=16,
                              d_ff=256, vocab_size=2048)
    sd = t5.DefectModel(cfg, device="cpu", seed=0).state_dict()
    a = "t5.encoder.block.0.self_attn"
    want = {f"{a}.q.weight": (64 * 16) ** -0.5, f"{a}.k.weight": 64 ** -0.5,
            f"{a}.o.weight": 64 ** -0.5,
            "t5.encoder.block.0.ffn.wi.weight": 64 ** -0.5,
            "t5.decoder.block.1.ffn.wo.weight": 256 ** -0.5,
            "t5.shared.embedding": 64 ** -0.5}
    for k, std in want.items():
        assert abs(float(sd[k].std()) / std - 1) < 0.1, k
    # lecun normal: truncated at 2 sigma of its rescaled normal.
    assert float(sd["classifier.weight"].abs().max()) <= 2 * 64 ** -0.5 / (
        0.87962566103423978)
    assert torch.equal(sd["t5.decoder.final_ln.weight"], torch.ones(64))
    assert torch.equal(sd["classifier.bias"], torch.zeros(2))
    assert sd[f"{a}.relative_attention_bias"].shape == (32, 4)
    assert "t5.encoder.block.1.self_attn.relative_attention_bias" not in sd


# ---------------------------------------------------------------------------
# HuggingFace T5 weights
# ---------------------------------------------------------------------------


def _hf_model(gated, tie=True, seed=0):
    transformers = pytest.importorskip("transformers")
    cfg = t5.T5Config.tiny()
    hf_cfg = transformers.T5Config(
        vocab_size=cfg.vocab_size, d_model=cfg.d_model, d_kv=cfg.d_kv,
        d_ff=cfg.d_ff, num_layers=cfg.num_layers,
        num_decoder_layers=cfg.num_decoder_layers, num_heads=cfg.num_heads,
        dropout_rate=0.0, feed_forward_proj="gated-gelu" if gated else "relu",
        pad_token_id=0, eos_token_id=2, decoder_start_token_id=0,
        tie_word_embeddings=tie)
    torch.manual_seed(seed)
    return transformers.T5ForConditionalGeneration(hf_cfg).eval()


@pytest.mark.parametrize("gated,tie,safe", [(False, True, True),
                                            (True, True, True),
                                            (False, True, False),
                                            (False, False, True)])
def test_load_pretrained_t5_matches_hf(gated, tie, safe, tmp_path):
    """An HF T5 saved with ``save_pretrained`` (safetensors or
    pytorch_model.bin), read through ``load_pretrained``: the decoder's
    last hidden state (what DefectModel pools) within 1e-5 of HF torch's,
    and the config the reference's ``t5_config_from_hf`` derives."""
    from deepdfa_tpu.models.pretrained import t5_config_from_hf as j_config

    hf = _hf_model(gated, tie)
    hf.save_pretrained(str(tmp_path), safe_serialization=safe)
    kind, cfg, params = load_pretrained(str(tmp_path))
    assert kind == "t5"
    assert dataclasses.asdict(cfg) == dataclasses.asdict(j_config(hf.config))
    model = t5.T5Model(dataclasses.replace(cfg), device="cpu")
    model.load_state_dict(params)
    # 16 positions, as tests/test_t5.py: HF's buckets take no 1e-6 in
    # the log, and at distance 16 the two formulas may part.
    ids = _ids(t=16)
    attn = torch.from_numpy((ids != 0).astype(np.int64))
    tids = torch.from_numpy(ids).long()
    with torch.no_grad():
        out = hf(input_ids=tids, attention_mask=attn, labels=tids,
                 decoder_attention_mask=attn, output_hidden_states=True)
        got = model(tids, t5.shift_right(tids, 0), attn_mask=attn.bool(),
                    decoder_mask=attn.bool())
        logits = model.logits(got)
    # The all-pad row is left out: HF masks with the dtype's minimum, the
    # reference with -1e9.
    want = out.decoder_hidden_states[-1]
    np.testing.assert_allclose(got[:-1].numpy(), want[:-1].numpy(),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(logits[:-1].numpy(), out.logits[:-1].numpy(),
                               atol=TOL, rtol=TOL)


def test_t5_hf_keys_round_trip():
    hf = _hf_model(True)
    saved = {k: v for k, v in hf.state_dict().items()
             if k not in ("encoder.embed_tokens.weight",
                          "decoder.embed_tokens.weight", "lm_head.weight")}
    cfg = t5.T5Config.tiny(vocab_size=128)
    cfg = dataclasses.replace(cfg, gated_ffn=True)
    params = t5_from_hf(saved, cfg)
    assert params.keys() == t5.T5Model(cfg, device="cpu").state_dict().keys()
    back = t5_to_hf(params, cfg)
    assert back.keys() == saved.keys()
    for k, v in saved.items():
        assert torch.equal(back[k], v), k


@pytest.mark.parametrize("doc", [
    {"model_type": "t5", "decoder_start_token_id": 0},
    {"model_type": "t5", "decoder_start_token_id": 0, "num_layers": 3,
     "num_decoder_layers": None, "feed_forward_proj": "gated-gelu",
     "tie_word_embeddings": False, "d_model": 64, "eos_token_id": 2},
    {"model_type": "t5", "decoder_start_token_id": 0, "num_layers": 4,
     "num_decoder_layers": 2, "relative_attention_max_distance": 64,
     "dropout_rate": 0.2, "vocab_size": 32100},
])
def test_t5_config_from_hf_matches_the_reference(doc):
    transformers = pytest.importorskip("transformers")
    from deepdfa_tpu.models.pretrained import t5_config_from_hf as j_config

    want = j_config(transformers.T5Config(**{k: v for k, v in doc.items()
                                             if k != "model_type"}))
    assert dataclasses.asdict(t5_config_from_hf(doc)) == dataclasses.asdict(
        want)


@pytest.mark.parametrize("doc,match", [
    ({"feed_forward_proj": "gated-silu", "decoder_start_token_id": 0},
     "feed_forward_proj"),
    ({"feed_forward_proj": "gelu", "decoder_start_token_id": 0},
     "feed_forward_proj"),
    ({}, "decoder_start_token_id"),
])
def test_t5_config_from_hf_refuses_what_it_cannot_compute(doc, match):
    with pytest.raises(ValueError, match=match):
        t5_config_from_hf({"model_type": "t5", **doc})


def test_load_pretrained_t5_from_the_ports_own_writer(tmp_path):
    """A directory written with ``write_safetensors`` and a bare
    ``config.json`` (the card's host has no transformers) reads back
    bit for bit."""
    cfg = dataclasses.replace(t5.T5Config.tiny(), gated_ffn=True)
    model = t5.T5Model(cfg, device="cpu", seed=3)
    write_safetensors(str(tmp_path / "model.safetensors"),
                      t5_to_hf(model.state_dict(), cfg))
    doc = {"model_type": "t5", "vocab_size": 128, "d_model": 32, "d_kv": 8,
           "d_ff": 64, "num_layers": 2, "num_heads": 4,
           "feed_forward_proj": "gated-gelu", "pad_token_id": 0,
           "eos_token_id": 2, "decoder_start_token_id": 0}
    (tmp_path / "config.json").write_text(json.dumps(doc))
    kind, got_cfg, params = load_pretrained(str(tmp_path), dropout_rate=0.0)
    assert kind == "t5" and got_cfg == dataclasses.replace(cfg,
                                                           dropout_rate=0.0)
    for k, v in model.state_dict().items():
        assert torch.equal(params[k], v), k
    assert os.path.getsize(tmp_path / "model.safetensors") > 0
