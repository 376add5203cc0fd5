"""Training the DeepDFA graph model at bf16 on the persistent lane, the
CLI's default (``FlowGNNConfig(dtype="bfloat16", message_impl=
"persistent")``, the parameters f32 masters), against the JAX package's
bf16 persistent kernel: the K-step backward's plain versions, the
model's gradients, a ``make_train_step`` trajectory, DeepDFA+LineVul with
a bf16 graph encoder, and ``cli fit``/``fit-text`` at bf16.

The same numpy inputs go through both packages; parameters are carried
across with ``models/convert.py``. The JAX side runs as its own tests run
it: the gated-step kernels in the Pallas interpreter (``impl=
"interpret"``, ``DEEPDFA_FUSED_IMPL=interpret``), everything else through
XLA's CPU backend. The port runs its plain versions, which its wrappers
take for CPU tensors, through the persistent kernels' ``autograd.
Function`` (``ops/fused_gnn._PersistentUnroll``: the kernels' K-step VJP),
as the JAX model runs its persistent custom VJP.

Tolerances and measured gaps:

- The K-step VJP's plain version (``persistent_backward_reference`` on
  the f32 masters at bf16, the plain version of
  ``persistent_fwd_hist_kernel_bf16``, ``persistent_bwd_kernel_bf16`` and
  ``step_weight_grad_kernel_bf16``) against ``jax.vjp`` of
  ``persistent_unroll(impl="interpret")`` at K 3, the cases of the one-step
  test (``tests/test_torch_bf16_train.py``): the forward ``h_K`` within
  one bf16 step (rtol 2^-7, atol 1e-6); ``dh`` within one bf16 step of
  the element plus half a step at the tensor's scale (2^-8 of its
  largest entry, chip_smoke.py's rule for a bf16 backward output), each
  weight gradient f32 and within 5e-4 of its tensor's largest entry.
  Each step's VJP lies within one bf16 step of the reference's (the
  one-step test), and an element one step apart moves the earlier
  steps' cancelling sums by a step of their terms. Measured: ``dh`` bit
  for bit in the four cases with bf16 band values or a bandwidth-0 band;
  with f32 band values one element of 512 one bf16 step apart (6.1e-5)
  at bandwidth 1, H 16, and 21 of 1536 apart at bandwidth 2, H 32, four
  of them by more than one step of the element (7.8e-3 at most, 1.4e-3
  of dh's largest entry); the weight gradients within 2.1e-6 of their
  largest entries with bf16 band values, 4.1e-6, 2.4e-5 and 1.7e-4 with
  f32 ones (the last the bandwidth-2 case). The plain version is also
  the port's own scan of the step VJP's plain version, bit for bit (the
  reference's persistent VJP is the scan of its step VJP, bit for bit,
  at bf16).
- FlowGNN's parameter gradients on the persistent lane against the JAX
  model's bf16 gradients: 5e-2 of each tensor's largest entry, and
  nearer them than the JAX model's f32 gradients. Measured: 2.1e-2 (the
  pooling gate's weight), the JAX f32 gradients up to 3.8e-1 away.
- A 20-step ``make_train_step`` trajectory at bf16 on the persistent
  lane against the JAX train step: 5e-2. Measured: 1.1e-3, the loss
  going from 0.715 to 0.637.
- DeepDFA+LineVul with a bf16 graph encoder on the persistent lane (the
  text encoder f32), 3 train steps against the JAX ``fit_text`` step:
  5e-2. Measured: 1.7e-5.
"""

import dataclasses
import importlib
import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from deepdfa_tpu.core.config import DataConfig as JDataConfig
from deepdfa_tpu.core.config import FeatureSpec as JFeatureSpec
from deepdfa_tpu.core.config import FlowGNNConfig as JFlowGNNConfig
from deepdfa_tpu.core.config import TrainConfig as JTrainConfig
from deepdfa_tpu.core.config import TransformerTrainConfig as JTextConfig
from deepdfa_tpu.data import text as jtext
from deepdfa_tpu.data.synthetic import synthetic_bigvul
from deepdfa_tpu.graphs.batch import batch_graphs as jax_batch_graphs
from deepdfa_tpu.graphs.batch import pad_budget_for
from deepdfa_tpu.models import linevul as jlinevul
from deepdfa_tpu.models import transformer as jtransformer
from deepdfa_tpu.models.flowgnn import FlowGNN as JFlowGNN
from deepdfa_tpu.train import loop as jloop
from deepdfa_tpu.train import text_loop as jtext_loop
from deepdfa_tpu_torch import cli
from deepdfa_tpu_torch.core.config import (
    DataConfig,
    FeatureSpec,
    FlowGNNConfig,
    TrainConfig,
    TransformerTrainConfig,
)
from deepdfa_tpu_torch.graphs.batch import batch_graphs
from deepdfa_tpu_torch.models import linevul, transformer
from deepdfa_tpu_torch.models.convert import flowgnn_from_flax, linevul_from_flax
from deepdfa_tpu_torch.models.flowgnn import FlowGNN
from deepdfa_tpu_torch.train import checkpoint as pckpt
from deepdfa_tpu_torch.train import loop, text_loop

jax_band = importlib.import_module("deepdfa_tpu.ops.band_spmm")
jax_fused = importlib.import_module("deepdfa_tpu.ops.fused_gnn")
pt_band = importlib.import_module("deepdfa_tpu_torch.ops.band_spmm")
pt_fused = importlib.import_module("deepdfa_tpu_torch.ops.fused_gnn")

STEP_TOL = dict(rtol=2.0 ** -7, atol=1e-6)
GRAD_REL = 5e-4
TOL = 5e-2
K = 3
LIMITS = dict(limit_all=20, limit_subkeys=20)
SUBKEYS = ["api", "datatype", "literal", "operator"]
BF16 = torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: exact comparisons of plain versions, and the
    first multi-threaded ``torch.exp`` of a process can be off in one
    thread's chunk (``scripts/torch_first_exp_race.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _tree(params, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in params.items()}


def _step_case(tile, n_tiles, spread, hidden, f32_vals, seed=0):
    """Both packages' band adjacencies of one edge list (spread None:
    every edge inside its tile, a bandwidth-0 band), params at the
    model's init scale, a bf16 h and a bf16 output cotangent."""
    rng = np.random.default_rng(seed)
    n = tile * n_tiles
    if spread is None:
        base = (rng.integers(0, n, 4 * n) // tile) * tile
        s, r = base + rng.integers(0, tile, 4 * n), base + rng.integers(
            0, tile, 4 * n)
    else:
        s = rng.integers(0, n, 6 * n)
        r = np.clip(s + rng.integers(-spread, spread + 1, 6 * n), 0, n - 1)
    mask = np.ones(len(s), bool)
    jadj = jax_band.build_band_adjacency(s, r, mask, n, tile=tile)
    padj = pt_band.build_band_adjacency(s, r, mask, n, tile=tile)
    if spread is None:
        jadj = jax_band.BandAdjacency(vals=jadj.vals[1:2], tile=tile,
                                      n_tiles=n_tiles, bandwidth=0)
        padj = dataclasses.replace(padj, vals=padj.vals[1:2].contiguous(),
                                   bandwidth=0)
    if f32_vals:
        jadj = jax_band.cast_band(jadj, jnp.float32)
        padj = dataclasses.replace(padj, vals=padj.vals.float())
    std = hidden ** -0.5
    dense = lambda bias: {
        "kernel": (rng.standard_normal((hidden, hidden)) * std
                   ).astype(np.float32),
        **({"bias": (rng.standard_normal(hidden) * std).astype(np.float32)}
           if bias else {})}
    params = {"edge_linear": dense(True),
              "gru": {name: dense(bias) for name, bias in
                      (("ir", True), ("iz", True), ("in", True),
                       ("hr", False), ("hz", False), ("hn", True))}}
    h, g = (jnp.asarray(rng.standard_normal((n, hidden)).astype(np.float32)
                        ).astype(jnp.bfloat16) for _ in range(2))
    return (jadj, padj, params, h, torch.from_numpy(_f32(h)).bfloat16(), g,
            torch.from_numpy(_f32(g)).bfloat16())


def _packed_grads(dparams):
    """A JAX parameter-tree gradient in the packed layout (dek, deb, dwi,
    dbi, dwh, dbh_n): the recurrent bias's r|z columns are no parameter."""
    g = dparams["gru"]
    cat = lambda names, key: np.concatenate([np.asarray(g[k][key])
                                             for k in names], -1)
    return [np.asarray(dparams["edge_linear"]["kernel"]),
            np.asarray(dparams["edge_linear"]["bias"])[None],
            cat(("ir", "iz", "in"), "kernel"),
            cat(("ir", "iz", "in"), "bias")[None],
            cat(("hr", "hz", "hn"), "kernel"),
            np.asarray(g["hn"]["bias"])[None]]


# ---------------------------------------------------------------------------
# (a) The K-step plain versions against the reference's persistent kernel
# ---------------------------------------------------------------------------

# (tile, tiles, spread, hidden): bandwidth 1, bandwidth 2, bandwidth 0.
CASES = [(8, 4, 2, 16), (16, 3, 20, 32), (8, 4, None, 16)]


@pytest.mark.parametrize("f32_vals", [False, True])
@pytest.mark.parametrize("tile,n_tiles,spread,hidden", CASES)
def test_bf16_persistent_vjp_matches_the_reference_kernel(tile, n_tiles,
                                                          spread, hidden,
                                                          f32_vals):
    jadj, padj, params, jh, ph, jg, pg = _step_case(tile, n_tiles, spread,
                                                    hidden, f32_vals)
    assert padj.bandwidth == {2: 1, 20: 2, None: 0}[spread]
    jp = _tree(params, jnp.asarray)

    @jax.jit
    def unroll_vjp(p, h, g):
        out, vjp = jax.vjp(lambda p, h: jax_fused.persistent_unroll(
            p, h, jadj, K, impl="interpret"), p, h)
        return out, vjp(g)

    want_out, (dparams, want_dh) = unroll_vjp(jp, jh, jg)
    tp = _tree(params, torch.from_numpy)
    p32 = pt_fused.packed_weights(tp)
    got = pt_fused.persistent_backward_reference(None, ph, padj, pg, K,
                                                 packed=p32)
    dh, *dw = got
    assert dh.dtype == BF16 and want_dh.dtype == jnp.bfloat16
    a, b = _f32(dh), _f32(want_dh)
    limit = 2.0 ** -7 * np.abs(b) + 2.0 ** -8 * np.abs(b).max() + 1e-6
    assert (np.abs(a - b) <= limit).all(), np.abs(a - b).max()
    np.testing.assert_allclose(_f32(pt_fused.persistent_reference(
        tp, ph, padj, K)), _f32(want_out), **STEP_TOL)
    packed_dw = list(dw)
    packed_dw[5] = packed_dw[5][:, 2 * hidden:]  # b_hn: r|z zeros no param
    for i, (a, b) in enumerate(zip(packed_dw, _packed_grads(dparams))):
        assert a.dtype == torch.float32 and a.shape == b.shape, i
        gap = np.abs(a.numpy() - b).max() / np.abs(b).max()
        assert gap <= GRAD_REL, (i, gap)
    # The port's own scan of the step VJP's plain version, bit for bit;
    # from params as from the packed masters.
    hist = pt_fused.persistent_hist_reference(None, ph, padj, K, p32)
    g, fold = pg, None
    for s in reversed(range(K)):
        hs = ph if s == 0 else hist[s - 1]
        g, *one = pt_fused.fused_step_backward_reference(None, hs, padj, g,
                                                         p32)
        fold = one if fold is None else [a + b for a, b in zip(fold, one)]
    for a, b, c in zip(got, [g] + fold,
                       pt_fused.persistent_backward_reference(tp, ph, padj,
                                                              pg, K)):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("f32_vals", [False, True])
def test_bf16_hist_and_rows_buffers(f32_vals):
    """The hist sweep's plain version at bf16 is the first K-1 outputs of
    ``persistent_reference`` bit for bit, from params, the f32 masters or
    bf16 packed weights alike; the reverse sweep's row buffers are ``x``
    bf16, ``dp`` and ``dmsg`` f32 (the weight pass's contract), ``dh_0``
    bf16; the CPU wrappers take the plain versions and launch nothing."""
    _, padj, params, _, ph, _, pg = _step_case(16, 3, 20, 32, f32_vals)
    tp = _tree(params, torch.from_numpy)
    k = 4
    pt_fused.reset_launch_counts()
    hist = pt_fused.persistent_hist_reference(tp, ph, padj, k)
    assert hist.dtype == BF16 and hist.shape == (k - 1, 48, 32)
    for j in range(1, k):
        assert torch.equal(hist[j - 1], pt_fused.persistent_reference(
            tp, ph, padj, j))
    for packed in (pt_fused.packed_weights(tp),
                   pt_fused.packed_weights(tp, BF16)):
        assert torch.equal(pt_fused.persistent_hist_reference(
            None, ph, padj, k, packed), hist)
        assert torch.equal(pt_fused.persistent_hist(None, ph, padj, k,
                                                    packed), hist)
    dh, x, dp, dmsg = pt_fused.persistent_bwd_rows(tp, ph, hist, padj, pg, k)
    assert (dh.dtype, x.dtype, dp.dtype, dmsg.dtype) == (
        BF16, BF16, torch.float32, torch.float32)
    assert x.shape == dmsg.shape == (k, 48, 32) and dp.shape == (k, 48, 128)
    assert sum(pt_fused.launch_counts().values()) == 0


def test_f32_k_step_plain_versions_take_packed_weights():
    """The K-step plain versions' ``packed=`` at f32 (the per-step ones
    take it too): the steps from the packed products, the same function
    as from ``params`` to f32 order (1e-5)."""
    _, padj, params, _, ph, _, pg = _step_case(16, 3, 20, 32, False)
    tp = _tree(params, torch.from_numpy)
    h, g = ph.float(), pg.float()
    packed = pt_fused.packed_weights(tp)
    hist = pt_fused.persistent_hist_reference(None, h, padj, K, packed)
    torch.testing.assert_close(hist, pt_fused.persistent_hist_reference(
        tp, h, padj, K), rtol=1e-5, atol=1e-5)
    got = pt_fused.persistent_backward_reference(None, h, padj, g, K,
                                                 packed=packed)
    want = pt_fused.persistent_backward_reference(tp, h, padj, g, K)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a, b, rtol=1e-5,
                                   atol=1e-5 * float(b.abs().max()))


def test_persistent_lane_weight_gradients_reach_the_f32_masters_unrounded():
    """At bf16 the persistent pass's autograd Function takes the f32
    packed weights and rounds them inside, so their f32 gradients arrive
    unrounded: bit for bit the K-step plain backward's, entries bf16
    cannot hold intact, on the model's ``nn.Linear`` parameters too; the
    CPU model runs that Function (the kernels' VJP), not the per-step
    one."""
    _, padj, params, _, ph, _, pg = _step_case(16, 3, 20, 32, False)
    tp = _tree(params, torch.from_numpy)
    packed = [w.clone().requires_grad_()
              for w in pt_fused.packed_weights(tp)]
    h = ph.clone().requires_grad_()
    out = pt_fused.persistent_unroll(None, h, padj, K, packed=packed)
    assert out.dtype == BF16
    assert type(out.grad_fn).__name__ == "_PersistentUnrollBackward"
    out.backward(pg)
    want = pt_fused.persistent_backward_reference(tp, ph, padj, pg, K)
    assert torch.equal(h.grad, want[0])
    for w, grad in zip(packed, want[1:]):
        assert w.grad.dtype == torch.float32
        assert torch.equal(w.grad, grad)
    dwi = packed[2].grad
    assert not torch.equal(dwi, dwi.bfloat16().float())
    # The model: the GRU's input kernels' gradients, not bf16 values.
    _, pb = _batches(seed=2)
    model = FlowGNN(FlowGNNConfig(feature=FeatureSpec(**LIMITS),
                                  hidden_dim=8, n_steps=3,
                                  message_impl="persistent",
                                  dtype="bfloat16"), device="cpu", seed=2)
    model(pb).sum().backward()
    for key in ("ir", "iz", "in"):
        g = model.ggnn_step.gru[key].weight.grad
        assert g.dtype == torch.float32
        assert not torch.equal(g, g.bfloat16().float())


# ---------------------------------------------------------------------------
# (b) FlowGNN on the persistent lane at bf16 against the JAX model
# ---------------------------------------------------------------------------


def _batches(n_graphs=6, seed=0, tile=16):
    graphs = synthetic_bigvul(n_graphs, JFeatureSpec(**LIMITS),
                              positive_fraction=0.5, seed=seed)
    budget = pad_budget_for(graphs, n_graphs)
    max_nodes = -(-budget["max_nodes"] // tile) * tile
    args = (graphs, n_graphs, max_nodes, budget["max_edges"], SUBKEYS)
    kw = dict(tile=tile, build_band_adj=True)
    return (jax_batch_graphs(*args, impl="python", shape_series=None, **kw),
            batch_graphs(*args, **kw))


def test_bf16_persistent_flowgnn_gradients_match_jax(monkeypatch):
    monkeypatch.setenv("DEEPDFA_FUSED_IMPL", "interpret")
    jb, pb = _batches()

    def jax_model(dtype):
        return JFlowGNN(JFlowGNNConfig(feature=JFeatureSpec(**LIMITS),
                                       hidden_dim=8, n_steps=3,
                                       message_impl="persistent",
                                       dtype=dtype))

    jmodel = jax_model("bfloat16")
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jb)
    cot = np.random.default_rng(1).standard_normal(6).astype(np.float32)

    def grads(model):
        g = jax.jit(jax.grad(lambda p: jnp.sum(model.apply(p, jb) * cot)))(
            params)
        return flowgnn_from_flax(jax.tree_util.tree_map(np.asarray, g))

    want, want32 = grads(jmodel), grads(jax_model("float32"))
    cfg = FlowGNNConfig(feature=FeatureSpec(**LIMITS), hidden_dim=8,
                        n_steps=3, message_impl="persistent",
                        dtype="bfloat16")
    model = FlowGNN(cfg, device="cpu")
    model.load_state_dict(flowgnn_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    calls = []
    reference = pt_fused.persistent_backward_reference
    monkeypatch.setattr(pt_fused, "persistent_backward_reference",
                        lambda *a, **kw: calls.append(1) or reference(*a,
                                                                      **kw))
    (model(pb) * torch.from_numpy(cot)).sum().backward()
    assert calls == [1]  # one K-step VJP, not K step VJPs
    floor = TOL * max(float(np.abs(w.numpy()).max()) for w in want.values())
    gaps, gaps32 = {}, {}
    for name, p in model.named_parameters():
        assert p.dtype == p.grad.dtype == torch.float32, name
        a, b, c = p.grad.numpy(), want[name].numpy(), want32[name].numpy()
        if name == "pooling.gate.bias":  # 0 in exact arithmetic
            assert np.abs(a).max() <= floor and np.abs(b).max() <= floor
            continue
        scale = np.abs(b).max()
        gaps[name] = np.abs(a - b).max() / scale
        gaps32[name] = np.abs(c - b).max() / scale
    assert max(gaps.values()) <= TOL, gaps
    assert max(gaps.values()) < max(gaps32.values()), (gaps, gaps32)


# tests/test_torch_train.py's small model and packing.
SMALL = dict(hidden_dim=8, n_steps=4, num_output_layers=2)
DATA = dict(batch_size=16, eval_batch_size=16, max_nodes_per_graph=64,
            max_edges_per_node=4, undersample_factor=1.0)
TRAIN_LIMITS = dict(limit_all=30, limit_subkeys=30)


def test_bf16_persistent_trajectory_matches_jax(monkeypatch):
    """20 steps of ``make_train_step`` at bf16 on the persistent lane from
    the same f32 params on the same batches: per-step losses within 5e-2
    of the JAX train step's; the parameters stay f32."""
    monkeypatch.setenv("DEEPDFA_FUSED_IMPL", "interpret")
    jcfg = JFlowGNNConfig(feature=JFeatureSpec(**TRAIN_LIMITS),
                          message_impl="persistent", dtype="bfloat16",
                          **SMALL)
    pcfg = FlowGNNConfig(feature=FeatureSpec(**TRAIN_LIMITS),
                         message_impl="persistent", dtype="bfloat16", **SMALL)
    ex = synthetic_bigvul(48, JFeatureSpec(**TRAIN_LIMITS),
                          positive_fraction=0.5, seed=1)
    idx = np.arange(len(ex))
    jb = list(jloop._batches(ex, idx, JDataConfig(**DATA), SUBKEYS, 16,
                             build_band_adj=True, build_tile_adj=False,
                             shape_series=None))
    pb = list(loop._batches(ex, idx, DataConfig(**DATA), SUBKEYS, 16,
                            build_band_adj=True, build_tile_adj=False))
    train = dict(learning_rate=2e-3, seed=0)
    jmodel = JFlowGNN(jcfg)
    state, tx = jloop.make_train_state(jmodel, jb[0], JTrainConfig(**train))
    jstep = jax.jit(jloop.make_train_step(jmodel, tx, JTrainConfig(**train)))
    model = FlowGNN(pcfg, device="cpu")
    model.load_state_dict(flowgnn_from_flax(
        jax.tree_util.tree_map(np.asarray, state.params)))
    cfg = TrainConfig(**train)
    step = loop.make_train_step(
        model, loop.make_optimizer(model.parameters(), cfg), cfg)
    want, got = [], []
    for i in range(20):
        state, loss, _ = jstep(state, jb[i % len(jb)])
        want.append(float(loss))
        got.append(float(step(pb[i % len(pb)])[0]))
    diff = np.abs(np.asarray(got) - np.asarray(want))
    assert diff.max() <= TOL, (diff.max(), got, want)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert got[-1] < got[0]


# ---------------------------------------------------------------------------
# (c) DeepDFA+LineVul with a bf16 graph encoder
# ---------------------------------------------------------------------------

VOCAB = 512
BLOCK = 48


def test_bf16_graph_encoder_linevul_trajectory_matches_jax(monkeypatch):
    """3 train steps of DeepDFA+LineVul (2 layers, the text encoder f32,
    dropout off) with the graph encoder at bf16 on the persistent lane,
    against the JAX ``fit_text`` train step: per-step losses within 5e-2.
    The bf16 pooled embedding meets the f32 CLS vector in the head's
    concatenation, which promotes it to f32 in both packages
    (``jnp.concatenate``, ``torch.cat``)."""
    monkeypatch.setenv("DEEPDFA_FUSED_IMPL", "interpret")

    def enc(pkg):
        return dataclasses.replace(
            pkg.EncoderConfig.tiny(vocab_size=VOCAB), hidden_size=128,
            num_heads=2, intermediate_size=256, attention_impl="auto",
            dropout_rate=0.0)

    gkw = dict(hidden_dim=4, n_steps=2, encoder_mode=True,
               message_impl="persistent", dtype="bfloat16")
    jm = jlinevul.LineVul(enc(jtransformer), JFlowGNNConfig(
        feature=JFeatureSpec(limit_all=30), **gkw))
    pm = linevul.LineVul(enc(transformer), FlowGNNConfig(
        feature=FeatureSpec(limit_all=30), **gkw), device="cpu")
    ex = synthetic_bigvul(32, JFeatureSpec(limit_all=30),
                          positive_fraction=0.5, seed=0)
    for i, e in enumerate(ex):
        e["label"] = int(np.asarray(e["vuln"]).max())
        e["id"] = i
    rows = jtext.attach_synthetic_text([dict(e) for e in ex], seed=0)
    data = jtext.encode_dataset(rows, jtext.HashingCodeTokenizer(VOCAB),
                                block_size=BLOCK, style="roberta")
    kw = dict(graphs_by_id={int(e["id"]): e for e in ex}, subkeys=SUBKEYS,
              graph_budget={"max_nodes": 512, "max_edges": 2048}, pad_id=1,
              build_band_adj=True)
    train = np.arange(24)
    steps = 3
    cfg_j = JTextConfig(batch_size=8, max_epochs=1, learning_rate=1e-3,
                        block_size=BLOCK)
    cfg_p = TransformerTrainConfig(batch_size=8, max_epochs=1,
                                   learning_rate=1e-3, block_size=BLOCK)

    def batches(pkg_loop):
        return list(pkg_loop.text_graph_batches(
            data, train, 8, shuffle_rng=np.random.default_rng(0), **kw))

    jbatches, pbatches = batches(jtext_loop), batches(text_loop)
    state, tx = jtext_loop.make_text_train_state(jm, jbatches[0], cfg_j,
                                                 steps)
    pm.load_state_dict(linevul_from_flax(state.params))
    jstep = jax.jit(jtext_loop.make_text_train_step(jm, tx, cfg_j))
    want = []
    for b in jbatches[:steps]:
        state, loss, _ = jstep(state, jnp.asarray(b.input_ids),
                               jnp.asarray(b.labels),
                               jnp.asarray(b.example_mask), b.graphs)
        want.append(float(loss))
    opt = text_loop.make_text_optimizer(pm.parameters(), cfg_p)
    step = text_loop.make_text_train_step(pm, opt, cfg_p)
    schedule = text_loop.make_schedule(cfg_p, steps)
    got = [float(step(b, schedule(i))[0])
           for i, b in enumerate(pbatches[:steps])]
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert all(p.dtype == torch.float32 for p in pm.parameters())
    assert pm.flowgnn.dtype == BF16
    assert pm.roberta.cfg.dtype == "float32"


# ---------------------------------------------------------------------------
# (d) The CLI at bf16 on the default lane
# ---------------------------------------------------------------------------


def _cli_json(argv, capsys):
    cli.main(argv)
    lines = [l for l in capsys.readouterr().out.strip().splitlines()
             if l.startswith("{")]
    return json.loads(lines[-1])


def test_cli_fit_resume_and_test_at_bf16_on_the_default_lane(tmp_path,
                                                             capsys,
                                                             monkeypatch):
    """``cli fit --set model.dtype=bfloat16`` with no lane named (the
    persistent lane, the CLI's default, whose K-step VJP runs once a
    train step): two epochs; one epoch resumed to two repeats them bit
    for bit; ``cli test`` of the snapshot at bf16. Nothing launches on
    the CPU."""
    data = ["--dataset", "synthetic:60", "--device", "cpu", "--batch-size",
            "16", "--set", "model.dtype=bfloat16"]
    calls = []
    reference = pt_fused.persistent_backward_reference
    monkeypatch.setattr(pt_fused, "persistent_backward_reference",
                        lambda *a, **kw: calls.append(1) or reference(*a,
                                                                      **kw))
    runs = {}
    for name, epochs in (("full", ["--max-epochs", "2"]),
                         ("cut", ["--max-epochs", "1"])):
        runs[name] = str(tmp_path / name)
        _cli_json(["fit", *data, *epochs, "--checkpoint-dir", runs[name]],
                  capsys)
    _cli_json(["fit", *data, "--max-epochs", "2", "--resume",
               "--checkpoint-dir", runs["cut"]], capsys)
    hist = {}
    for name, run in runs.items():
        with open(os.path.join(run, "history.json")) as f:
            hist[name] = json.load(f)
    full = [x for e in hist["full"]["epochs"] for x in e["step_losses"]]
    resumed = hist["cut"]["epochs"][-1]["step_losses"]
    assert resumed == full[len(full) - len(resumed):]
    assert all(v == 0 for v in hist["full"]["kernel_launches"].values())
    assert hist["full"]["over_gate_dispatches"] == 0
    steps = sum(len(e["step_losses"]) for h in hist.values()
                for e in h["epochs"])
    assert len(calls) >= steps > 0
    test = [a for a in data if a not in ("--batch-size", "16")]
    report = _cli_json(["test", *test, "--checkpoint-dir", runs["full"]],
                       capsys)
    assert np.isfinite(report["loss"])


@pytest.mark.parametrize("model", ["linevul", "codet5"])
def test_cli_fit_text_with_a_bf16_graph_encoder(tmp_path, capsys, model):
    """``fit-text --graphs synthetic --set model.dtype=bfloat16 --set
    model.message_impl=persistent`` under DeepDFA+LineVul and
    DeepDFA+CodeT5 (``--tiny``): the snapshot records the graph encoder's
    dtype and lane, the text encoder stays f32, and ``test-text`` reads
    the snapshot back to the same test loss."""
    run = str(tmp_path / model)
    result = _cli_json(["fit-text", "--model", model, "--dataset",
                        "synthetic:40", "--graphs", "synthetic", "--tiny",
                        "--block-size", "32", "--batch-size", "8",
                        "--epochs", "1", "--device", "cpu", "--set",
                        "model.dtype=bfloat16", "--set",
                        "model.message_impl=persistent",
                        "--checkpoint-dir", run], capsys)
    assert np.isfinite(result["test"]["loss"])
    with open(os.path.join(run, "model.json")) as f:
        desc = json.load(f)
    assert desc["combined"] and desc["model"] == model
    assert desc["graph_config"]["dtype"] == "bfloat16"
    assert desc["graph_config"]["message_impl"] == "persistent"
    params = pckpt.CheckpointManager(run).restore_params("best")
    assert all(v.dtype == torch.float32 for v in params.values()
               if v.is_floating_point())
    report = _cli_json(["test-text", "--checkpoint-dir", run, "--device",
                        "cpu", "--eval-batch-size", "8"], capsys)
    assert report["loss"] == result["test"]["loss"]
