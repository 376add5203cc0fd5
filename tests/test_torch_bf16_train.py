"""Training the DeepDFA graph model at bf16 (``FlowGNNConfig(dtype=
"bfloat16")``, the parameters f32 masters) against the JAX package's bf16
training: the fused lane's backward kernels' plain versions, the tile
product's, the model's gradients on every trainable lane, a trajectory
of ``make_train_step`` and ``cli fit``.

The same numpy inputs go through both packages; parameters are carried
across with ``models/convert.py``. The JAX side runs as its own tests run
it: the gated-step kernels and the tile product in the Pallas
interpreter (``impl="interpret"``, ``DEEPDFA_FUSED_IMPL=interpret``),
everything else through XLA's CPU backend. The port runs its plain
versions, which its wrappers take for CPU tensors; its fused lane runs
them through the kernels' ``autograd.Function`` (the kernels' VJP), as
the JAX model's fused lane runs its custom VJP.

Tolerances and measured gaps:

- The step VJP's plain version (``fused_step_backward_reference`` at bf16,
  the plain version of ``fused_step_bwd_kernel_bf16`` and
  ``step_weight_grad_kernel_bf16``) against ``jax.vjp`` of
  ``fused_gate_step(impl="interpret")``: ``dh`` within one bf16 step
  (rtol 2^-7, atol 1e-6), each weight gradient within 1e-5 of its
  largest entry. Measured: ``dh`` bit for bit but one element one bf16
  step apart (bf16 band values at bandwidth 1, f32 ones); the weight
  gradients within 3.9e-6 of their largest entries (the f32 sums' order;
  the products of two bf16 values are exact). The reference rounds where
  its ``_bwd_kernel`` rounds, except that its interpreter hands the gate
  cotangents r, z and n before their last rounding: XLA's excess
  precision elides a bf16 value's round trip to f32 (the sigmoid's
  quotient, the tanh). Rounding those three gates first puts the weight
  gradients 2e-3 to 8e-3 of their largest entries away and ``dh`` off in
  most elements; the port's plain version and its kernels follow the
  interpreter (``ops/fused_gnn.py:_bwd_rows_bf16``).
- The tile product at bf16 and its VJP against ``tile_spmm(impl=
  "interpret")``: one bf16 step. Measured: bit for bit.
- FlowGNN's parameter gradients on the segment, band, tile and fused
  lanes against the JAX model's bf16 gradients: 5e-2 of each tensor's
  largest entry (the reference's bf16 tolerance), and nearer them than
  the JAX model's f32 gradients. Measured: within 2.1e-2 on every lane
  (the pooling gate's weight; the GRU kernels 1.1e-2 to 1.7e-2), while
  the JAX model's f32 gradients lie up to 3.8e-1 away. Autograd
  of the bf16 GRU rounds at other points than XLA's autodiff does; the
  segment sum's backward is XLA's gather. The pooling gate's bias has
  a gradient of 0 in exact arithmetic (the softmax does not see it): it
  is held to an absolute floor.
- A 20-step ``make_train_step`` trajectory at bf16 on the fused and tile
  lanes against the JAX train step: 5e-2. Measured: 2.9e-3 on both
  lanes, the loss going from 0.715 to 0.628.
"""

import dataclasses
import importlib
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from deepdfa_tpu.core.config import DataConfig as JDataConfig
from deepdfa_tpu.core.config import FeatureSpec as JFeatureSpec
from deepdfa_tpu.core.config import FlowGNNConfig as JFlowGNNConfig
from deepdfa_tpu.core.config import TrainConfig as JTrainConfig
from deepdfa_tpu.data.synthetic import synthetic_bigvul
from deepdfa_tpu.graphs.batch import batch_graphs as jax_batch_graphs
from deepdfa_tpu.graphs.batch import pad_budget_for
from deepdfa_tpu.models.flowgnn import FlowGNN as JFlowGNN
from deepdfa_tpu.train import loop as jloop
from deepdfa_tpu_torch import cli
from deepdfa_tpu_torch.core.config import (
    DataConfig,
    FeatureSpec,
    FlowGNNConfig,
    TrainConfig,
)
from deepdfa_tpu_torch.graphs.batch import batch_graphs
from deepdfa_tpu_torch.models.convert import flowgnn_from_flax
from deepdfa_tpu_torch.models.flowgnn import FlowGNN
from deepdfa_tpu_torch.train import loop

jax_band = importlib.import_module("deepdfa_tpu.ops.band_spmm")
jax_fused = importlib.import_module("deepdfa_tpu.ops.fused_gnn")
jax_tile = importlib.import_module("deepdfa_tpu.ops.tile_spmm")
pt_band = importlib.import_module("deepdfa_tpu_torch.ops.band_spmm")
pt_fused = importlib.import_module("deepdfa_tpu_torch.ops.fused_gnn")
pt_tile = importlib.import_module("deepdfa_tpu_torch.ops.tile_spmm")

STEP_TOL = dict(rtol=2.0 ** -7, atol=1e-6)
GRAD_REL = 1e-5
TOL = 5e-2
LIMITS = dict(limit_all=20, limit_subkeys=20)
SUBKEYS = ["api", "datatype", "literal", "operator"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread (``tests/test_torch_bf16_gnn.py``'s reason:
    the first multi-threaded ``torch.exp`` of a process)."""
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


def _params_np(rng, hidden):
    std = hidden ** -0.5  # lecun: the model's init scale
    dense = lambda bias: {
        "kernel": (rng.standard_normal((hidden, hidden)) * std
                   ).astype(np.float32),
        **({"bias": (rng.standard_normal(hidden) * std).astype(np.float32)}
           if bias else {})}
    return {"edge_linear": dense(True),
            "gru": {name: dense(bias) for name, bias in
                    (("ir", True), ("iz", True), ("in", True),
                     ("hr", False), ("hz", False), ("hn", True))}}


def _step_case(tile, n_tiles, spread, hidden, f32_vals, seed=0):
    """Both packages' band adjacencies of one edge list (spread None:
    every edge inside its tile, a bandwidth-0 band), params, a bf16 h and
    a bf16 output cotangent."""
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
# (a) The kernels' plain versions against the reference kernels
# ---------------------------------------------------------------------------


CASES = [(8, 4, 2, 16), (16, 3, 20, 32), (8, 4, None, 16)]


@pytest.mark.parametrize("f32_vals", [False, True])
@pytest.mark.parametrize("tile,n_tiles,spread,hidden", CASES)
def test_bf16_step_vjp_matches_the_reference_kernel(tile, n_tiles, spread,
                                                    hidden, f32_vals):
    jadj, padj, params, jh, ph, jg, pg = _step_case(tile, n_tiles, spread,
                                                    hidden, f32_vals)
    jp = _tree(params, jnp.asarray)

    @jax.jit
    def step_vjp(p, h, g):
        return jax.vjp(lambda p, h: jax_fused.fused_gate_step(
            p, h, jadj, impl="interpret"), p, h)[1](g)

    dparams, want_dh = step_vjp(jp, jh, jg)
    got = pt_fused.fused_step_backward_reference(
        _tree(params, torch.from_numpy), ph, padj, pg)
    dh, *dw = got
    assert dh.dtype == torch.bfloat16 and want_dh.dtype == jnp.bfloat16
    np.testing.assert_allclose(_f32(dh), _f32(want_dh), **STEP_TOL)
    dw[5] = dw[5][:, 2 * hidden:]  # b_hn: the packed r|z zeros are no param
    for i, (a, b) in enumerate(zip(dw, _packed_grads(dparams))):
        assert a.dtype == torch.float32 and a.shape == b.shape, i
        gap = np.abs(a.numpy() - b).max() / np.abs(b).max()
        assert gap <= GRAD_REL, (i, gap)


@pytest.mark.parametrize("f32_vals", [False, True])
def test_bf16_row_buffers_and_the_weight_pass(f32_vals):
    """The row buffers' contract: ``x`` bf16, ``dp`` and ``dmsg`` f32 and
    unrounded (the bias gradients sum them as they are), the weight pass
    rounding ``dp`` (and ``dmsg`` when the messages are bf16) on load;
    the K-step VJP's plain version is the scan of the step VJP's, the
    weight pass's K steps the fold of one-step calls, bit for bit."""
    _, padj, params, _, ph, _, pg = _step_case(16, 3, 20, 32, f32_vals)
    tp = _tree(params, torch.from_numpy)
    dh, x, dp, dmsg = pt_fused.fused_step_bwd_rows_reference(tp, ph, padj, pg)
    assert (dh.dtype, x.dtype, dp.dtype, dmsg.dtype) == (
        torch.bfloat16, torch.bfloat16, torch.float32, torch.float32)
    assert not torch.equal(dp, dp.bfloat16().float())
    mdt = pt_fused.msg_dtype(padj, torch.bfloat16)
    assert mdt == (torch.float32 if f32_vals else torch.bfloat16)
    grads = pt_fused.step_weight_grad_reference(ph, None, x[None], dp[None],
                                                dmsg[None], 1, mdt)
    assert torch.equal(grads[3], dp[:, :96].sum(0, keepdim=True))
    assert torch.equal(grads[1], dmsg.sum(0, keepdim=True))
    k = 3
    full = pt_fused.persistent_backward_reference(tp, ph, padj, pg, k)
    hist = pt_fused.persistent_hist_reference(tp, ph, padj, k)
    g, fold = pg, None
    for s in reversed(range(k)):
        hs = ph if s == 0 else hist[s - 1]
        g, *one = pt_fused.fused_step_backward_reference(tp, hs, padj, g)
        fold = one if fold is None else [a + b for a, b in zip(fold, one)]
    for a, b in zip(full, [g] + fold):
        assert torch.equal(a, b)


def _tile_case(seed, n=48, hidden=16, tile=8, heavy=False):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n - 8, 3 * n)
    r = rng.integers(0, n - 8, 3 * n)  # the last 8 rows: no edge
    if heavy:  # a multiplicity of 300: f32 values in the reference's tiles
        s, r = np.concatenate([s, np.zeros(300, int)]), np.concatenate(
            [r, np.ones(300, int)])
    mask = np.ones(len(s), bool)
    return (jax_tile.build_tile_adjacency(s, r, mask, n, tile=tile),
            pt_tile.build_csr_adjacency(s, r, mask, n),
            *(jnp.asarray(rng.standard_normal((n, hidden)).astype(np.float32)
                          ).astype(jnp.bfloat16) for _ in range(2)))


@pytest.mark.parametrize("heavy", [False, True])
def test_bf16_tile_product_and_vjp_match_the_reference_kernel(heavy):
    jadj, padj, msg, cot = _tile_case(3, heavy=heavy)
    assert (jadj.vals.dtype == jnp.float32) == heavy
    want, vjp = jax.vjp(lambda m: jax_tile.tile_spmm(jadj, m, "interpret"),
                        msg)
    (want_grad,) = vjp(cot)
    m = torch.from_numpy(_f32(msg)).bfloat16().requires_grad_()
    got = pt_tile.tile_spmm(padj, m)
    got.backward(torch.from_numpy(_f32(cot)).bfloat16())
    assert got.dtype == m.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), **STEP_TOL)
    np.testing.assert_allclose(_f32(m.grad), _f32(want_grad), **STEP_TOL)
    assert pt_tile.launch_counts() == dict.fromkeys(pt_tile.KERNELS, 0)


# ---------------------------------------------------------------------------
# (b) FlowGNN at bf16: gradients and the f32 masters
# ---------------------------------------------------------------------------


def _batches(n_graphs=6, seed=0, tile=16):
    graphs = synthetic_bigvul(n_graphs, JFeatureSpec(**LIMITS),
                              positive_fraction=0.5, seed=seed)
    budget = pad_budget_for(graphs, n_graphs)
    max_nodes = -(-budget["max_nodes"] // tile) * tile
    args = (graphs, n_graphs, max_nodes, budget["max_edges"], SUBKEYS)
    kw = dict(tile=tile, build_band_adj=True, build_tile_adj=True)
    return (jax_batch_graphs(*args, impl="python", shape_series=None, **kw),
            batch_graphs(*args, **kw))


def _jax_model(impl, dtype):
    return JFlowGNN(JFlowGNNConfig(feature=JFeatureSpec(**LIMITS),
                                   hidden_dim=8, n_steps=3, message_impl=impl,
                                   dtype=dtype))


@pytest.mark.parametrize("impl", ["segment", "band", "tile", "fused"])
def test_bf16_flowgnn_gradients_match_jax(impl, monkeypatch):
    if impl == "fused":
        monkeypatch.setenv("DEEPDFA_FUSED_IMPL", "interpret")
    jb, pb = _batches()
    jmodel = _jax_model(impl, "bfloat16")
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jb)
    cot = np.random.default_rng(1).standard_normal(6).astype(np.float32)

    def grads(model):
        g = jax.jit(jax.grad(lambda p: jnp.sum(model.apply(p, jb) * cot)))(
            params)
        return flowgnn_from_flax(jax.tree_util.tree_map(np.asarray, g))

    want, want32 = grads(jmodel), grads(_jax_model(impl, "float32"))
    cfg = FlowGNNConfig(feature=FeatureSpec(**LIMITS), hidden_dim=8,
                        n_steps=3, message_impl=impl, dtype="bfloat16")
    model = FlowGNN(cfg, device="cpu")
    model.load_state_dict(flowgnn_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    (model(pb) * torch.from_numpy(cot)).sum().backward()
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


def test_fused_lane_weight_gradients_reach_the_f32_masters_unrounded():
    """At bf16 the fused step's autograd Function takes the f32 packed
    weights and rounds them inside, so their f32 gradients (the
    reference's ``_unpack_grads``) arrive unrounded: entries bf16 cannot
    hold arrive intact, bit for bit the plain backward's, on the model's
    ``nn.Linear`` parameters too."""
    _, padj, params, _, ph, _, pg = _step_case(16, 3, 20, 32, False)
    tp = _tree(params, torch.from_numpy)
    packed = [w.clone().requires_grad_()
              for w in pt_fused.packed_weights(tp)]
    out = pt_fused.fused_gate_step(None, ph, padj, packed=packed)
    assert out.dtype == torch.bfloat16
    out.backward(pg)
    want = pt_fused.fused_step_backward_reference(tp, ph, padj, pg)[1:]
    for w, grad in zip(packed, want):
        assert w.grad.dtype == torch.float32
        assert torch.equal(w.grad, grad)
    dwi = packed[2].grad
    assert not torch.equal(dwi, dwi.bfloat16().float())
    # The model: the GRU's input kernels' gradients, not bf16 values.
    _, pb = _batches(seed=2)
    model = FlowGNN(FlowGNNConfig(feature=FeatureSpec(**LIMITS),
                                  hidden_dim=8, n_steps=3,
                                  message_impl="fused", dtype="bfloat16"),
                    device="cpu", seed=2)
    model(pb).sum().backward()
    for key in ("ir", "iz", "in"):
        g = model.ggnn_step.gru[key].weight.grad
        assert g.dtype == torch.float32
        assert not torch.equal(g, g.bfloat16().float())


# ---------------------------------------------------------------------------
# (c) make_train_step and cli fit at bf16
# ---------------------------------------------------------------------------

# tests/test_torch_train.py's small model and packing.
SMALL = dict(hidden_dim=8, n_steps=4, num_output_layers=2)
DATA = dict(batch_size=16, eval_batch_size=16, max_nodes_per_graph=64,
            max_edges_per_node=4, undersample_factor=1.0)
TRAIN_LIMITS = dict(limit_all=30, limit_subkeys=30)


@pytest.mark.parametrize("impl", ["fused", "tile"])
def test_bf16_trajectory_matches_jax(impl, monkeypatch):
    """20 steps of ``make_train_step`` at bf16 from the same f32 params
    on the same batches: per-step losses within 5e-2 of the JAX train
    step's; the parameters stay f32."""
    if impl == "fused":
        monkeypatch.setenv("DEEPDFA_FUSED_IMPL", "interpret")
    jcfg = JFlowGNNConfig(feature=JFeatureSpec(**TRAIN_LIMITS),
                          message_impl=impl, dtype="bfloat16", **SMALL)
    pcfg = FlowGNNConfig(feature=FeatureSpec(**TRAIN_LIMITS),
                         message_impl=impl, dtype="bfloat16", **SMALL)
    ex = synthetic_bigvul(160, JFeatureSpec(**TRAIN_LIMITS),
                          positive_fraction=0.5, seed=1)
    idx = np.arange(len(ex))
    band, tile = pcfg.uses_band_adj, pcfg.uses_tile_adj
    jb = list(jloop._batches(ex, idx, JDataConfig(**DATA), SUBKEYS, 16,
                             build_band_adj=band, build_tile_adj=tile,
                             shape_series=None))
    pb = list(loop._batches(ex, idx, DataConfig(**DATA), SUBKEYS, 16,
                            build_band_adj=band, build_tile_adj=tile))
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


def _cli_json(argv, capsys):
    cli.main(argv)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_fit_resume_and_test_at_bf16(tmp_path, capsys):
    """``cli fit --set model.dtype=bfloat16`` on the fused lane: two
    epochs; one epoch resumed to two repeats them bit for bit; ``cli
    test`` of the snapshot at bf16. Nothing launches on the CPU."""
    data = ["--dataset", "synthetic:60", "--device", "cpu", "--batch-size",
            "16", "--set", "model.dtype=bfloat16", "--set",
            "model.message_impl=fused"]
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
        with open(f"{run}/history.json") as f:
            hist[name] = json.load(f)
    full = [x for e in hist["full"]["epochs"] for x in e["step_losses"]]
    resumed = hist["cut"]["epochs"][-1]["step_losses"]
    assert resumed == full[len(full) - len(resumed):]
    assert all(v == 0 for v in hist["full"]["kernel_launches"].values())
    test = [a for a in data if a not in ("--batch-size", "16")]
    report = _cli_json(["test", *test, "--checkpoint-dir", runs["full"]],
                       capsys)
    assert np.isfinite(report["loss"])
