"""The text models at bf16 (models/transformer.py, models/linevul.py,
models/t5.py, train/text_loop.py, models/infer.py) against the JAX
package's ``EncoderConfig(dtype="bfloat16")`` and
``T5Config(dtype="bfloat16")``.

Inputs are made in numpy from a seed and go through both packages;
parameters are carried across with ``models/convert.py`` and stay f32 in
both (the bf16 models cast them at each Dense). The encoder's head width
is 64, as codebert-base's. Flash pairs with flash (the JAX side's Pallas
kernels in interpret mode), dense with dense, and the trajectory pairs
"auto" with "auto" (JAX blockwise, the port's flash plain versions: both
widen q, k and v and run the softmax in f32). Dropout is off wherever
the two packages are compared.

Tolerances. Logits, hidden states, probabilities and losses within
5e-2 absolute and relative, the reference's own bf16 tolerance
(tests/test_fused_gnn.py). Both packages round to bf16 at the same
points (their forward activations agree to one bf16 step, layer by
layer) but each computes a bf16 product or op in its own order, so a
value may land one bf16 step apart and carry that onward. LineVul's
gradients: within 5e-2 of each tensor's largest entry, plus 1e-3 for
the tensors whose gradient is zero in exact arithmetic and bf16 rounding
noise on both sides (the attention key biases, the pooling gate's bias).
DefectModel's gradients: the same limit for every tensor, with the
port's FFN ReLUs gated by the reference's own pre-activations. Its loss
reads one decoder position a row (the last </s>), so a ReLU unit whose
pre-activation lies within the two packages' pre-activation gap of 0 is
on in one and off in the other, and changes the gradient of every
tensor upstream of it (up to 0.21 of the first decoder block's FFN
input projection's largest entry with the port's own ReLUs). The test
holds the pre-activations themselves within 5e-2, checks that every
unit that flips lies within that gap of 0, and then compares the
gradients given the reference's ReLU decisions. The largest gaps
measured are written beside each test.

The final hidden states of two bf16 computations differ nearly as much
as bf16 from f32, so the 5e-2 limit alone cannot tell a model that
rounds at the reference's points from one that stays f32. The tests
therefore record the dtype of every Dense output and of each attention
output (all bf16), and check that the outputs lie nearer the JAX
package's bf16 result than its f32 one.
"""

import dataclasses
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from deepdfa_tpu.core.config import FeatureSpec as JFeatureSpec
from deepdfa_tpu.core.config import FlowGNNConfig as JFlowGNNConfig
from deepdfa_tpu.core.config import TransformerTrainConfig as JTrainConfig
from deepdfa_tpu.data import text as jtext
from deepdfa_tpu.data.synthetic import synthetic_bigvul as j_synthetic
from deepdfa_tpu.models import infer as jinfer
from deepdfa_tpu.models import linevul as jlinevul
from deepdfa_tpu.models import t5 as jt5
from deepdfa_tpu.models import transformer as jtransformer
from deepdfa_tpu.train import text_loop as jloop
from deepdfa_tpu_torch.core.config import (
    FeatureSpec,
    FlowGNNConfig,
    TransformerTrainConfig,
)
from deepdfa_tpu_torch.data import combined
from deepdfa_tpu_torch.data import text as ptext
from deepdfa_tpu_torch.models import infer as pinfer
from deepdfa_tpu_torch.models import linevul, t5, transformer
from deepdfa_tpu_torch.models.convert import (
    defect_from_flax,
    encoder_from_flax,
    linevul_from_flax,
)
from deepdfa_tpu_torch.ops import attention as A
from deepdfa_tpu_torch.train import text_loop

VOCAB = 512
BLOCK = 48
SUBKEYS = ["api", "datatype", "literal", "operator"]
TOL = 5e-2
GRAD_FLOOR = 1e-3
_DENSE = transformer.dense


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


def _enc(pkg, **kw):
    """Two layers, 128 wide, 2 heads of 64, at bf16."""
    kw = {"dtype": "bfloat16", **kw}
    return dataclasses.replace(
        pkg.EncoderConfig.tiny(vocab_size=VOCAB), hidden_size=128,
        num_heads=2, intermediate_size=256, **kw)


def _t5(pkg, **kw):
    """Two + two layers, 128 wide, 2 heads of 64, at bf16, dropout off."""
    kw = {"dtype": "bfloat16", "dropout_rate": 0.0, **kw}
    return dataclasses.replace(pkg.T5Config.tiny(vocab_size=VOCAB),
                               d_model=128, d_kv=64, d_ff=256, num_heads=2,
                               **kw)


def _gcfg(pkg_flow, pkg_feat, **kw):
    return pkg_flow(feature=pkg_feat(limit_all=30), hidden_dim=4, n_steps=2,
                    encoder_mode=True, **kw)


def _ids(b=4, t=40, seed=0):
    """Token ids with <s> first, padded tails and one all-pad row."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, VOCAB, size=(b, t)).astype(np.int32)
    ids[:, 0] = 0
    for row, n in enumerate(rng.integers(t // 2, t, size=b)):
        ids[row, n:] = 1
    ids[-1] = 1
    return ids


def _examples(n, seed=0):
    ex = j_synthetic(n, JFeatureSpec(limit_all=30), positive_fraction=0.5,
                     seed=seed)
    for i, e in enumerate(ex):
        e["label"] = int(np.asarray(e["vuln"]).max())
        e["id"] = i
    return ex


def _batches(n=12, batch=8, seed=0, style="roberta", build_band=False):
    """One batch (``n`` examples, padded rows) from each package's
    ``text_graph_batches``, and the data and arguments they came from."""
    ex = _examples(n, seed)
    rows = jtext.attach_synthetic_text([dict(e) for e in ex], seed=seed)
    tok = (jtext.HashingT5Tokenizer(VOCAB) if style == "t5"
           else jtext.HashingCodeTokenizer(VOCAB))
    data = jtext.encode_dataset(rows, tok, block_size=BLOCK, style=style)
    kw = dict(graphs_by_id={int(e["id"]): e for e in ex}, subkeys=SUBKEYS,
              graph_budget={"max_nodes": 512, "max_edges": 2048},
              pad_id=0 if style == "t5" else 1, build_band_adj=build_band)
    idx = np.arange(min(n, batch - 2))
    return (next(jloop.text_graph_batches(data, idx, batch, **kw)),
            next(text_loop.text_graph_batches(data, idx, batch, **kw)),
            data, kw)


def _close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all(), what
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL, err_msg=what)
    return float(np.abs(got - want).max())


def _grads_close(got: dict, want: dict) -> float:
    """Each f32 gradient within TOL of its tensor's largest entry plus
    GRAD_FLOOR; returns the largest share of its limit a gap takes."""
    assert got.keys() == want.keys()
    worst = 0.0
    for k, g in got.items():
        w = want[k]
        assert g is not None and g.dtype == torch.float32, k
        assert torch.isfinite(g).all(), k
        gap = float((g - w).abs().max())
        limit = TOL * float(w.abs().max()) + GRAD_FLOOR
        assert gap <= limit, (k, gap, limit)
        worst = max(worst, gap / limit)
    return worst


def _nearer_bf16(got, want, want_f32, what) -> float:
    """``got`` lies nearer the reference's bf16 result than its f32 one
    (by the norm of the difference); returns the ratio of the two."""
    got, want, want_f32 = (np.asarray(x, np.float32)
                           for x in (got, want, want_f32))
    ratio = float(np.linalg.norm(got - want) / np.linalg.norm(got - want_f32))
    assert ratio < 1.0, (what, ratio)
    return ratio


def _record_dense(monkeypatch) -> list:
    """The dtype of every ``dense`` output of the encoder and the T5
    stack (both call it by module name), in call order."""
    seen = []

    def dense(lin, x, dtype):
        y = _DENSE(lin, x, dtype)
        seen.append(y.dtype)
        return y

    monkeypatch.setattr(transformer, "dense", dense)
    monkeypatch.setattr(t5, "dense", dense)
    return seen


def _record_outputs(model, cls) -> tuple:
    """Forward hooks on every ``cls`` module of ``model`` that record the
    dtype of its output (the first item of a tuple)."""
    seen = []

    def hook(m, i, o):
        seen.append((o[0] if isinstance(o, tuple) else o).dtype)

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, cls)]
    assert hooks, cls
    return seen, hooks


# ---------------------------------------------------------------------------
# The encoder and LineVul
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_bf16_encoder_matches_jax(impl, monkeypatch):
    """Hidden states (f32 out of the last LayerNorm in both), every
    Dense and attention output bf16 inside, and the hidden states nearer
    the reference's bf16 ones than its f32 ones. Measured: 1.73e-2
    (dense) and 1.69e-2 (flash) at most; the ratio of the distances
    0.78 (dense) and 0.85 (flash)."""
    jcfg, pcfg = _enc(jtransformer, attention_impl=impl), _enc(
        transformer, attention_impl=impl)
    ids = _ids()
    params = jtransformer.RobertaEncoder(jcfg).init(jax.random.PRNGKey(0),
                                                   jnp.asarray(ids))
    enc = transformer.RobertaEncoder(pcfg, torch.Generator())
    enc.load_state_dict(encoder_from_flax(params))
    want, _ = jtransformer.RobertaEncoder(jcfg).apply(params,
                                                     jnp.asarray(ids))
    want_f32, _ = jtransformer.RobertaEncoder(dataclasses.replace(
        jcfg, dtype="float32")).apply(params, jnp.asarray(ids))
    dense_out = _record_dense(monkeypatch)
    attn_out, hooks = _record_outputs(enc, transformer.SelfAttention)
    try:
        with torch.no_grad():
            got, _ = enc(torch.from_numpy(ids))
    finally:
        for h in hooks:
            h.remove()
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    # Per layer: q, k, v, the attention output, intermediate, output.
    assert dense_out == [torch.bfloat16] * 6 * pcfg.num_layers
    assert attn_out == [torch.bfloat16] * pcfg.num_layers
    _close(got.numpy(), want, "hidden states")
    _nearer_bf16(got.numpy(), want, want_f32, "hidden states")


def _linevul_pair(combined_model, impl="flash", dropout_rate=0.0):
    jg = _gcfg(JFlowGNNConfig, JFeatureSpec) if combined_model else None
    pg = _gcfg(FlowGNNConfig, FeatureSpec) if combined_model else None
    jm = jlinevul.LineVul(_enc(jtransformer, attention_impl=impl,
                               dropout_rate=dropout_rate), jg)
    pm = linevul.LineVul(_enc(transformer, attention_impl=impl,
                              dropout_rate=dropout_rate), pg, device="cpu")
    return jm, pm


@pytest.mark.parametrize("combined_model", [True, False])
def test_bf16_linevul_logits_and_gradients_match_jax(combined_model,
                                                     monkeypatch):
    """Logits (f32: the head carries no dtype) and every parameter's
    gradient against ``jax.grad`` on the same f32 params, through the
    dense impl (the flash pair's gradients at bf16:
    tests/test_torch_bf16_attention.py). Measured:
    logits 5.2e-3 at most; gradients 3.9e-2 of their tensor's largest
    entry (the first layer's FFN output bias), and the exact-zero ones
    (key biases, pooling gate bias) 1.9e-4 absolute."""
    jm, pm = _linevul_pair(combined_model, "dense")
    jb, pb, *_ = _batches()
    jgraphs = jb.graphs if combined_model else None
    params = jm.init({"params": jax.random.PRNGKey(0)},
                     jnp.asarray(jb.input_ids), jgraphs)
    pm.load_state_dict(linevul_from_flax(params))
    assert all(p.dtype == torch.float32 for p in pm.parameters())

    def loss(p):
        logits = jm.apply(p, jnp.asarray(jb.input_ids), jgraphs)
        return jlinevul.cross_entropy_loss(
            logits, jnp.asarray(jb.labels), jnp.asarray(jb.example_mask)), \
            logits

    (_, want), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    dense_out = _record_dense(monkeypatch)
    logits = pm(torch.from_numpy(pb.input_ids),
                pb.graphs if combined_model else None)
    assert logits.dtype == torch.float32 and want.dtype == jnp.float32
    assert dense_out == [torch.bfloat16] * 6 * pm.roberta.cfg.num_layers
    _close(logits.detach().numpy(), want, "logits")
    linevul.cross_entropy_loss(logits, torch.from_numpy(pb.labels),
                               torch.from_numpy(pb.example_mask)).backward()
    _grads_close({k: p.grad for k, p in pm.named_parameters()},
                 linevul_from_flax(jgrads))


def test_bf16_train_trajectory_matches_jax():
    """5 train steps of the combined model at bf16 (dropout off, the
    optimizer on the f32 master parameters): the port's step against
    make_text_train_step, "auto" against "auto". Measured: losses
    1.2e-3 at most."""
    jm, pm = _linevul_pair(True, "auto")
    jb, _, data, kw = _batches(n=48)
    train = np.arange(40)
    cfg_j = JTrainConfig(batch_size=8, max_epochs=1, learning_rate=1e-3,
                         block_size=BLOCK)
    cfg_p = TransformerTrainConfig(batch_size=8, max_epochs=1,
                                   learning_rate=1e-3, block_size=BLOCK)
    steps = 5

    def batches(loop):
        rng = np.random.default_rng(0)
        while True:
            yield from loop.text_graph_batches(data, train, 8,
                                               shuffle_rng=rng, **kw)

    state, tx = jloop.make_text_train_state(jm, jb, cfg_j, steps)
    pm.load_state_dict(linevul_from_flax(state.params))
    jstep = jax.jit(jloop.make_text_train_step(jm, tx, cfg_j))
    want = []
    jbatches = batches(jloop)
    for _ in range(steps):
        b = next(jbatches)
        state, loss, _ = jstep(state, jnp.asarray(b.input_ids),
                               jnp.asarray(b.labels),
                               jnp.asarray(b.example_mask), b.graphs)
        want.append(float(loss))
    opt = text_loop.make_text_optimizer(pm.parameters(), cfg_p)
    step = text_loop.make_text_train_step(pm, opt, cfg_p)
    schedule = text_loop.make_schedule(cfg_p, steps)
    pbatches = batches(text_loop)
    got = [float(step(next(pbatches), schedule(i))[0]) for i in range(steps)]
    _close(got, want, "losses")
    assert all(p.dtype == torch.float32 for p in pm.parameters())
    # The master parameters moved as the JAX package's did.
    moved = linevul_from_flax(state.params)
    for k, p in pm.state_dict().items():
        np.testing.assert_allclose(p.numpy(), moved[k].numpy(), atol=TOL,
                                   rtol=0, err_msg=k)


def test_bf16_fit_text_and_evaluate_text_on_cpu():
    """The flagship configuration's ``fit_text``, ``evaluate_text`` and
    the combined serving forward, at a small size: finite losses, f32
    master parameters that moved, the serving forward's probabilities
    those of the evaluation."""
    tok = ptext.HashingCodeTokenizer(VOCAB)
    data, splits, graphs = combined.load_combined_dataset(
        "synthetic:40", FeatureSpec(limit_all=30), tok, 32,
        graphs="synthetic", seed=1)
    graphs, budget = combined.graph_join_and_budget(list(graphs.values()), 8)
    model = linevul.LineVul(
        _enc(transformer, attention_impl="auto", max_position_embeddings=40),
        _gcfg(FlowGNNConfig, FeatureSpec), device="cpu")
    start = {k: v.clone() for k, v in model.state_dict().items()}
    cfg = TransformerTrainConfig(batch_size=8, block_size=32, max_epochs=1,
                                 learning_rate=1e-3)
    kw = dict(graphs_by_id=graphs, subkeys=SUBKEYS, graph_budget=budget)
    _, history = text_loop.fit_text(model, data, splits, cfg, **kw)
    losses = history["epochs"][0]["step_losses"]
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert all(v.dtype == torch.float32 for v in model.state_dict().values())
    assert not torch.equal(start["roberta.layer.0.attention.query.weight"],
                           model.state_dict()[
                               "roberta.layer.0.attention.query.weight"])
    test = text_loop.evaluate_text(text_loop.make_text_eval_step(model),
                                   data, splits["test"], cfg, pad_id=1, **kw)
    assert np.isfinite(test["loss"]) and len(test["probs"]) == len(
        splits["test"])
    batch = next(text_loop.text_graph_batches(
        data, splits["test"], cfg.eval_batch_size, pad_id=1, **kw))
    probs = pinfer.make_combined_infer(model)(
        torch.from_numpy(batch.input_ids), batch.graphs)
    assert probs.dtype == torch.float32
    m = batch.example_mask
    np.testing.assert_allclose(probs.numpy()[m], test["probs"][:m.sum()],
                               rtol=0, atol=1e-6)


def test_bf16_combined_infer_matches_the_jax_engine_path():
    """The combined serving forward (``make_combined_infer``) on a bf16
    encoder against the JAX package's, on converted params. Measured:
    1.2e-3 at most."""
    jm, pm = _linevul_pair(True, "flash")
    jb, pb, *_ = _batches()
    params = jm.init({"params": jax.random.PRNGKey(3)},
                     jnp.asarray(jb.input_ids), jb.graphs)
    pm.load_state_dict(linevul_from_flax(params))
    want = np.asarray(jinfer.make_combined_infer(jm)(
        params, jnp.asarray(jb.input_ids), jb.graphs))
    got = pinfer.make_combined_infer(pm)(torch.from_numpy(pb.input_ids),
                                         pb.graphs)
    assert got.dtype == torch.float32
    m = pb.example_mask
    _close(got.numpy()[m], want[m], "probabilities")


# ---------------------------------------------------------------------------
# DeepDFA+CodeT5
# ---------------------------------------------------------------------------


def _gated_ffn(names: dict, pre: dict, gate: dict):
    """A ``T5FFN.forward`` (relu, dropout off) that records each FFN's
    pre-activation under its name and, where ``gate`` holds the name,
    keeps the units that are on there instead of those above 0."""

    def forward(self, x, deterministic=True, generator=None):
        name = names[self]
        h = t5.dense(self.wi, x, self.dtype)
        pre[name] = h.detach().float()
        on = gate.get(name)
        h = torch.relu(h) if on is None else torch.where(on, h, 0.0)
        return t5.dense(self.wo, h, self.dtype)

    return forward


@pytest.mark.parametrize("impl", [None, "segment"])
def test_bf16_defect_model_matches_jax(impl, monkeypatch):
    """DefectModel at bf16, alone and combined: logits, the FFN
    pre-activations and gradients (see the module docstring). Measured:
    logits 6.7e-3 at most, 0.40 of their distance to the reference's
    f32 logits; pre-activations 3.1e-2 at most; 0, 17, 30 and 68 of
    98,304 units flip (encoder blocks 0-1, decoder blocks 0-1), each
    within 1.04e-2 of 0; gradients, given the reference's ReLU
    decisions, 0.20 of their limit at most."""
    jcfg, pcfg = _t5(jt5), _t5(t5)
    jg = _gcfg(JFlowGNNConfig, JFeatureSpec) if impl else None
    pg = _gcfg(FlowGNNConfig, FeatureSpec) if impl else None
    jb, pb, *_ = _batches(n=10, style="t5")
    jgraphs = jb.graphs if impl else None
    jm = jt5.DefectModel(jcfg, graph_config=jg)
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(jb.input_ids),
                     jgraphs)
    pm = t5.DefectModel(pcfg, graph_config=pg, device="cpu")
    pm.load_state_dict(defect_from_flax(params))

    def loss(p):
        logits = jm.apply(p, jnp.asarray(jb.input_ids), jgraphs)
        return jlinevul.cross_entropy_loss(
            logits, jnp.asarray(jb.labels), jnp.asarray(jb.example_mask)), \
            logits

    (_, want), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    want_f32 = jt5.DefectModel(dataclasses.replace(jcfg, dtype="float32"),
                               graph_config=jg).apply(
        params, jnp.asarray(jb.input_ids), jgraphs)
    _, inter = jm.apply(params, jnp.asarray(jb.input_ids), jgraphs,
                        capture_intermediates=lambda m, _: m.name == "wi",
                        mutable=["intermediates"])
    ref_pre = {
        f"t5.{path[2].key}.block.{path[3].key.removeprefix('block_')}.ffn":
            torch.from_numpy(np.asarray(v, np.float32))
        for path, v in jax.tree_util.tree_flatten_with_path(inter)[0]}
    args = (torch.from_numpy(pb.input_ids), pb.graphs if impl else None)
    logits = pm(*args)
    assert logits.dtype == torch.float32
    _close(logits.detach().numpy(), want, "logits")
    _nearer_bf16(logits.detach().numpy(), want, want_f32, "logits")

    names = {m: n for n, m in pm.named_modules()
             if isinstance(m, t5.T5FFN)}
    assert sorted(names.values()) == sorted(ref_pre)
    pre, gate = {}, {}
    monkeypatch.setattr(t5.T5FFN, "forward", _gated_ffn(names, pre, gate))
    with torch.no_grad():
        assert torch.equal(pm(*args), logits.detach())  # the same FFN
    for name, r in ref_pre.items():
        p = pre[name]
        _close(p.numpy(), r.numpy(), f"{name} pre-activations")
        flips = (p > 0) != (r > 0)
        assert bool((r[flips].abs() <= (p - r).abs().max()).all()), name
        gate[name] = r > 0
    gated = pm(*args)
    linevul.cross_entropy_loss(gated, torch.from_numpy(pb.labels),
                               torch.from_numpy(pb.example_mask)).backward()
    _grads_close({k: p.grad for k, p in pm.named_parameters()},
                 defect_from_flax(jgrads))


def test_bf16_t5_stack_rounds_where_the_reference_does(monkeypatch):
    """The T5 stack at bf16: the encoder's hidden states within TOL of
    the reference's, f32 out of the final norm, and every projection's
    and attention's output bf16 inside. Measured: 1.5e-2 at most."""
    jcfg, pcfg = _t5(jt5), _t5(t5)
    ids = _ids(t=24) % 128
    ids[:, -1] = 2
    mask = ids != 0
    jmodel = jt5.T5Model(jcfg)
    params = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(ids),
                         jnp.asarray(ids))
    from deepdfa_tpu_torch.models.convert import t5_from_flax

    pm = t5.T5Model(pcfg, device="cpu")
    pm.load_state_dict(t5_from_flax(params))
    want = jmodel.apply(params, jnp.asarray(ids), jnp.asarray(mask),
                        method=jt5.T5Model.encode)
    dense_out = _record_dense(monkeypatch)
    attn_out, hooks = _record_outputs(pm.encoder, t5.T5Attention)
    try:
        with torch.no_grad():
            got = pm.encode(torch.from_numpy(ids), torch.from_numpy(mask))
    finally:
        for h in hooks:
            h.remove()
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    # Per block: q, k, v, o, wi, wo.
    assert dense_out == [torch.bfloat16] * 6 * pcfg.num_layers
    assert attn_out == [torch.bfloat16] * pcfg.num_layers
    _close(got.numpy(), want, "encoder hidden states")


# ---------------------------------------------------------------------------
# Guards
# ---------------------------------------------------------------------------


def test_bf16_params_convert_as_f32_and_dropout_masks_match_f32():
    """The converted params of a bf16 model are f32 (the reference keeps
    f32 params at bf16), so ``models/convert.py`` is unchanged; and a
    bf16 activation sees the f32 activation's dropout mask."""
    jm, pm = _linevul_pair(True)
    jb, *_ = _batches()
    params = jm.init({"params": jax.random.PRNGKey(0)},
                     jnp.asarray(jb.input_ids), jb.graphs)
    assert all(np.asarray(x).dtype == np.float32
               for x in jax.tree_util.tree_leaves(params))
    sd = linevul_from_flax(params)
    assert all(v.dtype == torch.float32 for v in sd.values())
    pm.load_state_dict(sd)
    x = torch.randn(64, 96)
    a = transformer.dropout(x, 0.3, True, torch.Generator().manual_seed(5))
    b = transformer.dropout(x.bfloat16(), 0.3, True,
                            torch.Generator().manual_seed(5))
    assert b.dtype == torch.bfloat16
    assert torch.equal(a == 0, b == 0)


def test_f32_path_is_unchanged_bit_for_bit():
    """At f32 each Dense is the Linear itself and the encoder layer is
    the f32 composition it was, bit for bit."""
    cfg = dataclasses.replace(_enc(transformer, attention_impl="flash"),
                              dtype="float32")
    layer = transformer.EncoderLayer(cfg, torch.Generator().manual_seed(0))
    x = torch.randn(2, 16, 128)
    mask = torch.ones(2, 16, dtype=torch.bool)
    mask[1, 9:] = False
    with torch.no_grad():
        got, _ = layer(x, mask)
        att = layer.attention
        q, k, v = (lin(x).view(2, 16, 2, 64)
                   for lin in (att.query, att.key, att.value))
        o = A.attention(q, k, v, kv_mask=mask, impl="flash").reshape(
            2, 16, 128)
        h = layer.attention_ln(x + layer.attention_output(o))
        ff = layer.output(torch.nn.functional.gelu(layer.intermediate(h),
                                                   approximate="tanh"))
        want = layer.output_ln(h + ff)
    assert torch.equal(got, want)
    lin = torch.nn.Linear(8, 4)
    assert torch.equal(transformer.dense(lin, x[0, :, :8], torch.float32),
                       lin(x[0, :, :8]))
    with pytest.raises(NotImplementedError, match="bfloat16"):
        transformer.compute_dtype("float16")
