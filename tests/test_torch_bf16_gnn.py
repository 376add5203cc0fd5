"""The DeepDFA graph model at bf16 (``FlowGNNConfig(dtype="bfloat16")``)
against the JAX package's bf16 model, kernels and serving engine.

The same numpy inputs go through both packages; parameters are carried
across with ``models/convert.py`` and stay f32 in both. The JAX side runs
as its own tests run it: the gated-step kernels in the Pallas interpreter
(``impl="interpret"``, ``DEEPDFA_FUSED_IMPL=interpret`` for the model's
fused and persistent lanes), everything else through XLA's CPU backend.
The port runs its plain versions, which its wrappers take for CPU tensors.

Tolerances and measured gaps:

- The bf16 plain versions of ``fused_step_kernel_bf16`` and
  ``persistent_fwd_kernel_bf16`` against the reference kernel at bf16:
  one step within one bf16 step (rtol 2^-7, atol 1e-6), K steps within
  5e-2. Measured: bit for bit, every case below (bf16 and f32 band
  values, bandwidth 0 and 1-2, K 1 and 3): both round at the kernel's
  points, and XLA computes a bf16 sigmoid as 1 / (1 + exp(-x)) with the
  exponential, the sum and the quotient each rounded, which the port
  copies (``ops/fused_gnn.py:sigmoid_bf16``).
- FlowGNN logits, every lane, against the JAX model at bf16: 5e-2, the
  reference's bf16 tolerance (tests/test_fused_gnn.py). Measured: within
  5e-8, the f32 head's order; the JAX model at f32 lies 6e-4 to 3e-3
  away, and the test holds the port nearer the bf16 result than that.
  The segment lane matches only because the port adds bf16 segment sums
  as XLA's CPU scatter does, one bf16 rounding an add in row order
  (``graphs/segment.py``); an f32 sum rounded once lands 4e-3 off, nearer
  the JAX model's f32 logits than its bf16 ones.
- Served probabilities against the JAX engine: 5e-2; duplicates come
  back from the cache bit for bit.
"""

import dataclasses
import importlib
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from deepdfa_tpu.core.config import FeatureSpec as JFeatureSpec
from deepdfa_tpu.core.config import FlowGNNConfig as JFlowGNNConfig
from deepdfa_tpu.data.synthetic import synthetic_bigvul
from deepdfa_tpu.graphs.batch import batch_graphs as jax_batch_graphs
from deepdfa_tpu.graphs.batch import pad_budget_for
from deepdfa_tpu.models.flowgnn import FlowGNN as JFlowGNN
from deepdfa_tpu.serve import ServeConfig as JServeConfig
from deepdfa_tpu.serve import ServeEngine as JServeEngine
from deepdfa_tpu.serve.engine import random_gnn_params
from deepdfa_tpu_torch import cli
from deepdfa_tpu_torch.core.config import FeatureSpec, FlowGNNConfig
from deepdfa_tpu_torch.graphs import segment as pt_segment
from deepdfa_tpu_torch.graphs.batch import batch_graphs
from deepdfa_tpu_torch.models import flowgnn as pt_flowgnn
from deepdfa_tpu_torch.models.convert import flowgnn_from_flax
from deepdfa_tpu_torch.models.flowgnn import FlowGNN
from deepdfa_tpu_torch.ops import PEAK_BF16, PEAK_F32_SIMT
from deepdfa_tpu_torch.serve import ServeConfig, ServeEngine

# The packages' ops/__init__ re-export functions under the module names,
# so the modules are imported by path.
jax_band = importlib.import_module("deepdfa_tpu.ops.band_spmm")
jax_fused = importlib.import_module("deepdfa_tpu.ops.fused_gnn")
pt_band = importlib.import_module("deepdfa_tpu_torch.ops.band_spmm")
pt_fused = importlib.import_module("deepdfa_tpu_torch.ops.fused_gnn")
pt_tile = importlib.import_module("deepdfa_tpu_torch.ops.tile_spmm")

STEP_TOL = dict(rtol=2.0 ** -7, atol=1e-6)
TOL = 5e-2
LIMITS = dict(limit_all=20, limit_subkeys=20)
SUBKEYS = ["api", "datatype", "literal", "operator"]
TILE = 16
IMPLS = ["segment", "band", "fused", "persistent"]


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


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))


# ---------------------------------------------------------------------------
# (a) The kernels' bf16 plain versions against the reference kernels
# ---------------------------------------------------------------------------


def _params_np(rng, hidden):
    # Init-scale weights (lecun: std 1/sqrt(fan_in)), as the model's.
    std = hidden ** -0.5
    dense = lambda bias: {
        "kernel": (rng.standard_normal((hidden, hidden)) * std
                   ).astype(np.float32),
        **({"bias": (rng.standard_normal(hidden) * std).astype(np.float32)}
           if bias else {})}
    return {"edge_linear": dense(True),
            "gru": {name: dense(bias) for name, bias in
                    (("ir", True), ("iz", True), ("in", True),
                     ("hr", False), ("hz", False), ("hn", True))}}


def _tree(params, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in params.items()}


def _step_case(tile, n_tiles, spread, hidden, f32_vals, seed=0):
    """Both packages' adjacencies of one edge list (spread None: every
    edge inside its tile, re-wrapped as a bandwidth-0 band), params and a
    bf16 h."""
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
    params = _params_np(rng, hidden)
    h = jnp.asarray(rng.standard_normal((n, hidden)).astype(np.float32)
                    ).astype(jnp.bfloat16)
    return jadj, padj, params, h, torch.from_numpy(_f32(h)).bfloat16()


@pytest.mark.parametrize("n_steps", [1, 3])
@pytest.mark.parametrize("f32_vals", [False, True])
@pytest.mark.parametrize("tile,n_tiles,spread,hidden", [
    (8, 4, 2, 16), (16, 3, 20, 32), (8, 4, None, 16)])
def test_bf16_plain_versions_match_the_reference_kernels(
        tile, n_tiles, spread, hidden, f32_vals, n_steps):
    jadj, padj, params, jh, ph = _step_case(tile, n_tiles, spread, hidden,
                                            f32_vals)
    assert padj.bandwidth == (0 if spread is None else jadj.bandwidth)
    jp = _tree(params, jnp.asarray)
    if n_steps == 1:
        want = jax_fused.fused_gate_step(jp, jh, jadj, impl="interpret")
    else:
        want = jax_fused.persistent_unroll(jp, jh, jadj, n_steps,
                                           impl="interpret")
    got = pt_fused.persistent_reference(_tree(params, torch.from_numpy), ph,
                                        padj, n_steps)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    tol = STEP_TOL if n_steps == 1 else dict(rtol=TOL, atol=TOL)
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)
    # Measured: bit for bit (module docstring).
    assert int((_f32(got) != _f32(want)).sum()) == 0


def test_bf16_weights_pack_as_the_reference_packs_them():
    params = _params_np(np.random.default_rng(1), 16)
    want = jax_fused._packed_weights(_tree(params, jnp.asarray),
                                     jnp.bfloat16)
    got = pt_fused.packed_weights(_tree(params, torch.from_numpy),
                                  torch.bfloat16)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        np.testing.assert_array_equal(_f32(a), _f32(b))


@pytest.mark.parametrize("shape", [(2000,), (700, 3)])
def test_bf16_segment_sum_adds_as_xla_does(shape):
    """XLA's CPU scatter adds bf16 segment sums one row at a time in
    bf16; the port's ``segment_sum`` does the same (bit for bit), and the
    f32 sum rounded once differs."""
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 12, shape[0]).astype(np.int32)
    data = rng.standard_normal(shape).astype(np.float32)
    data[rng.random(shape[0]) < 0.3] = 0.0  # zero rows change nothing
    jd = jnp.asarray(data).astype(jnp.bfloat16)
    want = _f32(jax.ops.segment_sum(jd, jnp.asarray(ids), num_segments=12))
    pd = torch.from_numpy(_f32(jd)).bfloat16()
    got = pt_segment.segment_sum(pd, torch.from_numpy(ids), 12)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_f32(got), want)
    once = pt_segment.segment_sum(pd.float(), torch.from_numpy(ids), 12)
    assert not np.array_equal(_f32(once.bfloat16()), want)
    mask = rng.random(shape[0]) < 0.8
    logits = jnp.asarray(data[:, 0] if data.ndim > 1 else data
                         ).astype(jnp.bfloat16)
    want_sm = _f32(importlib.import_module(
        "deepdfa_tpu.graphs.segment").segment_softmax(
            logits, jnp.asarray(ids), 12, mask=jnp.asarray(mask)))
    got_sm = pt_segment.segment_softmax(
        torch.from_numpy(_f32(logits)).bfloat16(), torch.from_numpy(ids),
        12, mask=torch.from_numpy(mask))
    assert got_sm.dtype == torch.bfloat16
    np.testing.assert_array_equal(_f32(got_sm), want_sm)


# ---------------------------------------------------------------------------
# (b) FlowGNN at bf16, every lane the serving engine runs
# ---------------------------------------------------------------------------


def _batches(n_graphs=6, seed=0):
    graphs = synthetic_bigvul(n_graphs, JFeatureSpec(**LIMITS),
                              positive_fraction=0.5, seed=seed)
    budget = pad_budget_for(graphs, n_graphs)
    max_nodes = -(-budget["max_nodes"] // TILE) * TILE
    args = (graphs, n_graphs, max_nodes, budget["max_edges"], SUBKEYS)
    jb = jax_batch_graphs(*args, tile=TILE, build_band_adj=True,
                          impl="python", shape_series=None)
    pb = batch_graphs(*args, tile=TILE, build_band_adj=True)
    return jb, pb


def _jax_model(impl, dtype, **kw):
    return JFlowGNN(JFlowGNNConfig(feature=JFeatureSpec(**LIMITS),
                                   hidden_dim=8, n_steps=3, message_impl=impl,
                                   dtype=dtype, **kw))


def _record_dtypes(monkeypatch):
    """Record the dtype of every Dense output (edge linear, GRU gates,
    pool gate), every GRU gate output and every kernel product of the
    port's bf16 model."""
    seen = {"dense": set(), "gru": set(), "matmul": set()}

    def wrap(module, name, key):
        fn = getattr(module, name)

        def recorded(*a, **k):
            out = fn(*a, **k)
            seen[key].add(out.dtype)
            return out

        monkeypatch.setattr(module, name, recorded)

    wrap(pt_flowgnn, "_dense", "dense")
    wrap(pt_fused, "gru_bf16", "gru")
    wrap(pt_fused, "matmul_bf16", "matmul")
    return seen


@pytest.mark.parametrize("pool_impl", ["auto", "matmul"])
@pytest.mark.parametrize("impl", IMPLS)
def test_bf16_flowgnn_matches_jax(impl, pool_impl, monkeypatch):
    if impl in ("fused", "persistent"):
        # The reference's kernels on the interpreter, as its tests run
        # them (off a TPU its model runs the band composition instead).
        monkeypatch.setenv("DEEPDFA_FUSED_IMPL", "interpret")
    jb, pb = _batches()
    jmodel = _jax_model(impl, "bfloat16", pool_impl=pool_impl)
    params = jmodel.init(jax.random.PRNGKey(0), jb)
    want = _f32(jmodel.apply(params, jb))
    want32 = _f32(_jax_model(impl, "float32", pool_impl=pool_impl).apply(
        params, jb))
    cfg = FlowGNNConfig(feature=FeatureSpec(**LIMITS), hidden_dim=8,
                        n_steps=3, message_impl=impl, dtype="bfloat16",
                        pool_impl=pool_impl)
    model = FlowGNN(cfg, device="cpu")
    model.load_state_dict(flowgnn_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    seen = _record_dtypes(monkeypatch)
    pooled = []
    model.pooling.register_forward_hook(
        lambda mod, args, out: pooled.append(out.dtype))
    with torch.inference_mode():
        got = model.eval()(pb)
    assert got.dtype == torch.float32 and got.shape == want.shape == (6,)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    gap, gap32 = np.abs(got.numpy() - want).max(), np.abs(
        got.numpy() - want32).max()
    assert gap < gap32, (gap, gap32)
    assert seen["dense"] == {torch.bfloat16} and seen["gru"] == {
        torch.bfloat16} and pooled == [torch.bfloat16]
    if impl in ("fused", "persistent"):
        assert seen["matmul"] == {torch.bfloat16}


def test_bf16_encoder_mode_pools_to_bf16_like_jax():
    jb, pb = _batches(seed=1)
    jmodel = _jax_model("persistent", "bfloat16", encoder_mode=True)
    params = jmodel.init(jax.random.PRNGKey(1), jb)
    want = jmodel.apply(params, jb)
    model = FlowGNN(FlowGNNConfig(feature=FeatureSpec(**LIMITS),
                                  hidden_dim=8, n_steps=3,
                                  message_impl="persistent",
                                  dtype="bfloat16", encoder_mode=True),
                    device="cpu")
    model.load_state_dict(flowgnn_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    with torch.inference_mode():
        got = model.eval()(pb)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# (c) The serving engine at bf16
# ---------------------------------------------------------------------------


def _requests():
    graphs = synthetic_bigvul(24, JFeatureSpec(**LIMITS), seed=4)
    for g in graphs:  # clients send no labels
        for key in ("label", "vuln", "df_in", "df_out", "project"):
            g.pop(key)
    return graphs


@pytest.mark.parametrize("impl", ["persistent", "fused"])
def test_bf16_engine_matches_the_jax_engine(impl):
    model_kw = dict(hidden_dim=4, n_steps=2, num_output_layers=2,
                    message_impl=impl, dtype="bfloat16")
    jmodel = JFlowGNN(JFlowGNNConfig(feature=JFeatureSpec(**LIMITS),
                                     **model_kw))
    jcfg = JServeConfig(batch_slots=4)
    params = random_gnn_params(jmodel, jcfg, seed=3)
    jeng = JServeEngine(jmodel, params, config=jcfg)
    model = FlowGNN(FlowGNNConfig(feature=FeatureSpec(**LIMITS), **model_kw),
                    device="cpu")
    model.load_state_dict(flowgnn_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    peng = ServeEngine(model, ServeConfig(batch_slots=4), device="cpu")
    reqs = _requests()
    out = {}
    for name, eng in (("jax", jeng), ("port", peng)):
        first = eng.score_sync(reqs)
        dup = eng.score_sync(reqs[::4])
        out[name] = (first, dup, eng.snapshot())
    (jfirst, _, _), (pfirst, pdup, psnap) = out["jax"], out["port"]
    np.testing.assert_allclose([r["prob"] for r in pfirst],
                               [r["prob"] for r in jfirst], rtol=TOL,
                               atol=TOL)
    assert all(r["cached"] for r in pdup) and psnap["cache_hits"] == 6
    assert [r["prob"] for r in pdup] == [r["prob"] for r in pfirst[::4]]
    assert psnap["failures"] == 0


# ---------------------------------------------------------------------------
# (d) The CLI at bf16 on the CPU
# ---------------------------------------------------------------------------


def _cli_json(argv, capsys):
    cli.main(argv)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_score_and_test_at_bf16(tmp_path, capsys):
    """``test`` of an f32 ``fit`` snapshot at bf16 (the f32 params load
    into the bf16 model) and ``score`` of it at bf16: within 5e-2 of the
    same commands at f32, and not equal to them."""
    run = str(tmp_path / "fit")
    data = ["--dataset", "synthetic:60", "--device", "cpu"]
    _cli_json(["fit", *data, "--max-epochs", "1", "--batch-size", "16",
               "--checkpoint-dir", run], capsys)
    bf16 = ["--set", "model.dtype=bfloat16"]
    t16 = _cli_json(["test", *data, "--checkpoint-dir", run, *bf16], capsys)
    t32 = _cli_json(["test", *data, "--checkpoint-dir", run], capsys)
    assert np.isfinite(t16["loss"]) and abs(t16["loss"] - t32["loss"]) < TOL
    assert t16["loss"] != t32["loss"]
    probs = {}
    for name, extra in (("bf16", bf16), ("f32", [])):
        out = str(tmp_path / f"score_{name}")
        rep = _cli_json(["score", *data, "--checkpoint-dir", run,
                         "--out-dir", out, *extra], capsys)
        assert rep["n_scored"] == 60 and rep["n_errors"] == 0
        assert rep["message_impl"] == "persistent"
        probs[name] = np.loadtxt(rep["out"], delimiter=",", skiprows=1,
                                 usecols=1)
    np.testing.assert_allclose(probs["bf16"], probs["f32"], rtol=TOL,
                               atol=TOL)
    assert not np.array_equal(probs["bf16"], probs["f32"])


# ---------------------------------------------------------------------------
# (e) Guards
# ---------------------------------------------------------------------------


def test_bf16_params_convert_as_f32():
    """A bf16 model's parameters are f32 in both packages, so
    ``models/convert.py`` carries them unchanged."""
    jb, _ = _batches(seed=2)
    params = _jax_model("persistent", "bfloat16").init(
        jax.random.PRNGKey(2), jb)
    assert all(np.asarray(x).dtype == np.float32
               for x in jax.tree_util.tree_leaves(params))
    sd = flowgnn_from_flax(jax.tree_util.tree_map(np.asarray, params))
    assert all(v.dtype == torch.float32 for v in sd.values())
    model = FlowGNN(FlowGNNConfig(feature=FeatureSpec(**LIMITS),
                                  hidden_dim=8, n_steps=3,
                                  message_impl="persistent",
                                  dtype="bfloat16"), device="cpu")
    assert all(v.dtype == torch.float32
               for v in model.state_dict().values())
    with pytest.raises(ValueError, match="dtype"):
        FlowGNNConfig(dtype="float16")


@pytest.mark.parametrize("impl", IMPLS)
def test_f32_path_is_unchanged_bit_for_bit(impl):
    """At f32 the model is the f32 composition it was: each Dense the
    Linear itself, the GRU and pooling in f32 torch ops, bit for bit."""
    _, pb = _batches(seed=3)
    cfg = FlowGNNConfig(feature=FeatureSpec(**LIMITS), hidden_dim=8,
                        n_steps=3, message_impl=impl)
    model = FlowGNN(cfg, device="cpu", seed=3).eval()
    with torch.no_grad():
        got = model(pb)
        h0 = torch.cat([torch.nn.functional.embedding(
            pb.node_feats[k].long(), model.embeds[k].embedding)
            for k in model.subkeys], -1)
        step, g = model.ggnn_step, model.ggnn_step.gru
        h = h0
        for _ in range(cfg.n_steps):
            msg = step.edge_linear(h)
            if impl == "segment":
                gathered = torch.where(pb.edge_mask[:, None],
                                       msg[pb.senders.long()], 0.0)
                agg = torch.zeros_like(msg).index_add_(
                    0, pb.receivers.long(), gathered)
            else:
                agg = pt_band.band_spmm(pb.band_adj, msg)
            if impl in ("fused", "persistent"):
                h = pt_fused.fused_step_reference(step.step_params(), h,
                                                  pb.band_adj)
                continue
            r = torch.sigmoid(g["ir"](agg) + g["hr"](h))
            z = torch.sigmoid(g["iz"](agg) + g["hz"](h))
            n = torch.tanh(g["in"](agg) + r * g["hn"](h))
            h = (1.0 - z) * n + z * h
        feat = torch.cat([h, h0], -1)
        gate = model.pooling.gate(feat)[:, 0]
        w = pt_segment.segment_softmax(gate, pb.node_graph, pb.n_graphs,
                                       mask=pb.node_mask)
        pooled = torch.zeros(pb.n_graphs, feat.shape[1]).index_add_(
            0, pb.node_graph.long(),
            torch.where(pb.node_mask[:, None], feat * w[:, None], 0.0))
        x = pooled
        for i in range(cfg.num_output_layers):
            x = model.head[f"output_{i}"](x)
            if i != cfg.num_output_layers - 1:
                x = torch.relu(x)
    assert got.dtype == torch.float32
    assert torch.equal(got, x[:, 0])


def test_bf16_backward_kernels_refuse_naming_a3b2():
    """No bf16 backward wrapper refuses the dtype any more: the fused
    lane's and the persistent lane's (a persistent pass that needs a
    gradient included) take bf16, so on a bf16 meta tensor (which needs
    no card) each gets past the dtype and stops at the device check
    before it launches anything; so does the tile product."""
    _, padj, params, _, ph = _step_case(8, 4, 2, 16, False)
    tp = _tree(params, lambda a: torch.from_numpy(a).to("meta"))
    h = ph.to("meta")
    adj = padj.to("meta")
    pt_fused.reset_launch_counts()
    assert not hasattr(pt_fused, "refuse_bf16_persistent_training")
    packed = [w.requires_grad_() for w in pt_fused.packed_weights(tp)]
    taken = [
        lambda: pt_fused.persistent_backward(tp, h, adj, h, 3),
        lambda: pt_fused.persistent_hist(tp, h, adj, 3),
        lambda: pt_fused.persistent_bwd_rows(tp, h, h[None], adj, h, 2),
        lambda: pt_fused.persistent_unroll(None, h, adj, 3, packed=packed),
        lambda: pt_fused.fused_step_backward(tp, h, adj, h),
        lambda: pt_fused.fused_step_bwd_rows(tp, h, adj, h),
        lambda: pt_fused.step_weight_grads(h, None, h[None],
                                           h.float()[None].repeat(1, 1, 4),
                                           h.float()[None], 1),
    ]
    for call in taken:
        with pytest.raises(ValueError, match="CUDA tensors, got meta"):
            call()
    assert sum(pt_fused.launch_counts().values()) == 0
    rng = np.random.default_rng(0)
    s = rng.integers(0, 32, 64)
    csr = pt_tile.build_csr_adjacency(s, s, np.ones(64, bool), 32)
    with pytest.raises(ValueError, match="CUDA tensors, got meta"):
        pt_tile.tile_spmm(csr, torch.zeros(32, 16, dtype=torch.bfloat16,
                                           device="meta"))
    assert pt_tile.launch_counts()["tile_spmm_kernel_bf16"] == 0


def test_bf16_gates_plans_and_costs():
    """The bf16 instances' host side: the persistent gate holds three row
    arrays (123 rows at H 128, against 184 at f32), the per-step plan
    takes the bf16 backward's tiles (its tensor-core products), and the
    cost counts h and the weights at 2 bytes and the bf16 x bf16 products
    at the bf16 tensor-core rate."""
    def chain(rows, n):
        s = np.arange(rows - 1)
        return pt_band.build_band_adjacency(s, s + 1, np.ones(rows - 1, bool),
                                            n, tile=128)

    for rows, f32_ok, bf16_ok in ((123, True, True), (124, True, False),
                                  (185, False, False)):
        adj = chain(rows, 256)
        assert pt_fused.persistent_smem_ok(adj, 128) == f32_ok
        assert pt_fused.persistent_smem_ok(adj, 128,
                                           torch.bfloat16) == bf16_ok
    assert pt_fused.persistent_smem_bytes(chain(48, 256), 128, 1,
                                          torch.bfloat16) == 113_088
    for n in (1024, 8192, 16384):
        bwd = pt_fused.step_plan(n, 128, 132, "fused_step_bwd_kernel_bf16")
        bf16 = pt_fused.step_plan(n, 128, 132, "fused_step_kernel_bf16")
        assert bf16 == bwd
        rt = bf16["row_tile"]
        assert pt_fused.step_smem_bytes(
            n, 128, 132, "fused_step_kernel_bf16", 1) == (
                2 * 6 * 16 * 136 * 2 + 8 * rt * 136 + 12 * rt + 28 * 128)
    adj = chain(48, 256)
    c32 = pt_fused.kernel_cost(adj, 128, 5, "persistent_fwd_kernel")
    c16 = pt_fused.kernel_cost(adj, 128, 5, "persistent_fwd_kernel_bf16")
    band = adj.vals.numel() * 2
    assert c16["bytes"] == 2 * 256 * 128 * 2 + band + (7 * 128 * 128
                                                       + 7 * 128) * 2
    dense = 5 * 2.0 * 256 * 128 * 128 * 7
    assert c16["flops_bf16"] == dense + 5 * 2.0 * c16["nnz"] * 128
    assert c16["flops"] == c16["flops_bf16"] + 5 * 20.0 * 256 * 128
    assert PEAK_F32_SIMT[1] < c16["peak_flops"] < PEAK_BF16[1]
    assert c16["nnz"] == c32["nnz"] == 47
    f32_vals = dataclasses.replace(adj, vals=adj.vals.float())
    c = pt_fused.kernel_cost(f32_vals, 128, 1, "fused_step_kernel_bf16")
    assert c["flops_bf16"] == 2.0 * 256 * 128 * 128 * 7
