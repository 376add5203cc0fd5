"""The port's tile message path (deepdfa_tpu_torch/ops/tile_spmm.py and
the batches, model, loops and CLI around it) against the JAX package.

Inputs are made once with numpy and go through both packages. The port
carries A and A^T as nonzero lists; turned into the reference's dense
tile layout (``tile_layout``) they equal the JAX package's tiles byte
for byte. The JAX product runs as its own tests run it on the CPU: the
Pallas kernel in interpret mode, or ``_spmm_xla``; the port's wrapper
takes its plain version for CPU tensors. Tolerances: the host layouts
and the batches byte for byte; the product, its VJP and the model within
1e-5 (f32 sums of a few products in another order).
"""

import importlib
import json
import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from deepdfa_tpu.core.config import FeatureSpec as JFeatureSpec
from deepdfa_tpu.core.config import FlowGNNConfig as JFlowGNNConfig
from deepdfa_tpu.data import text as jtext
from deepdfa_tpu.graphs import batch as jax_batch
from deepdfa_tpu.models.flowgnn import FlowGNN as JFlowGNN
from deepdfa_tpu.train import text_loop as jtext_loop
from deepdfa_tpu_torch.core.config import FeatureSpec, FlowGNNConfig
from deepdfa_tpu_torch.data.synthetic import synthetic_bigvul
from deepdfa_tpu_torch.graphs import batch as pt_batch
from deepdfa_tpu_torch.models.convert import flowgnn_from_flax
from deepdfa_tpu_torch.models.flowgnn import FlowGNN
from deepdfa_tpu_torch.ops import tile_spmm as T
from deepdfa_tpu_torch.train import text_loop

# deepdfa_tpu.ops re-exports a function named tile_spmm over the module.
J = importlib.import_module("deepdfa_tpu.ops.tile_spmm")

TOL = dict(rtol=1e-5, atol=1e-5)
SUBKEYS = ["api", "datatype", "literal", "operator"]
LIMITS = dict(limit_all=20, limit_subkeys=20)
FIELDS = ("vals", "rows", "cols", "t_vals", "t_rows", "t_cols")


def _np(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _same_adjacency(got, want):
    for name in FIELDS:
        a, b = _np(getattr(got, name)), _np(getattr(want, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name
    assert got.tile == want.tile and got.n_row_tiles == want.n_row_tiles


def _random_edges(rng, n_nodes, n_edges, tile):
    """As tests/test_tile_spmm.py: random edges plus masked pad slots."""
    max_nodes = tile * max(1, -(-n_nodes // tile))
    n_pad = n_edges // 3
    s = np.concatenate([rng.integers(0, n_nodes, n_edges),
                        np.zeros(n_pad, np.int64)])
    r = np.concatenate([rng.integers(0, n_nodes, n_edges),
                        np.zeros(n_pad, np.int64)])
    mask = np.concatenate([np.ones(n_edges, bool), np.zeros(n_pad, bool)])
    return s, r, mask, max_nodes


def _edge_cases():
    rng = np.random.default_rng(0)
    dup = (np.array([0, 0, 0, 3, 3]), np.array([2, 2, 0, 3, 3]),
           np.ones(5, bool), 8)
    heavy = (np.zeros(300, np.int64), np.ones(300, np.int64),
             np.ones(300, bool), 8)
    empty = (np.zeros(4, np.int64), np.zeros(4, np.int64),
             np.zeros(4, bool), 64)
    return {
        "random_tile8": (*_random_edges(rng, 40, 120, 8), 8, None),
        "random_tile16": (*_random_edges(rng, 100, 400, 16), 16, None),
        "duplicate_and_self_edges": (*dup, 8, None),
        "multiplicity_300_f32": (*heavy, 8, None),
        "no_edges_fillers_only": (*empty, 8, None),
        "explicit_pad_nz": (*_random_edges(rng, 30, 90, 8), 8, 64),
    }


CASES = _edge_cases()


@pytest.mark.parametrize("case", sorted(CASES))
def test_build_tile_adjacency_is_byte_equal(case):
    s, r, mask, max_nodes, tile, pad_nz = CASES[case]
    want = J.build_tile_adjacency(s, r, mask, max_nodes, tile=tile,
                                  pad_nz=pad_nz)
    lists = T.build_csr_adjacency(s, r, mask, max_nodes)
    got = T.tile_layout(lists, tile, pad_nz)
    _same_adjacency(got, want)
    _same_adjacency(T.build_tile_adjacency(s, r, mask, max_nodes, tile=tile,
                                           pad_nz=pad_nz), want)
    if case == "multiplicity_300_f32":
        assert got.vals.dtype == torch.float32
    else:
        assert got.vals.dtype == torch.bfloat16
    # The lists: int32 pointers over every row, f32 multiplicities.
    for ptr, src, val in ((lists.ptr, lists.src, lists.val),
                          (lists.t_ptr, lists.t_src, lists.t_val)):
        assert ptr.dtype == src.dtype == torch.int32
        assert val.dtype == torch.float32
        assert ptr.shape == (max_nodes + 1,) and int(ptr[0]) == 0
        assert int(ptr[-1]) == src.shape[0] == val.shape[0]
        assert bool((ptr[1:] >= ptr[:-1]).all())


@pytest.mark.parametrize("case", sorted(CASES))
def test_csr_lists_hold_each_edge_once(case):
    """Each distinct (receiver, sender) pair is one nonzero holding its
    multiplicity, senders ascending within a row; A^T holds the same
    nonzeros by sender."""
    s, r, mask, max_nodes, _, _ = CASES[case]
    dense = np.zeros((max_nodes, max_nodes))
    np.add.at(dense, (np.asarray(r)[mask], np.asarray(s)[mask]), 1.0)
    adj = T.build_csr_adjacency(s, r, mask, max_nodes)
    for lists, want in ((adj, dense), (adj.transposed(), dense.T)):
        rows = lists.row_ids().numpy()
        src = lists.src.numpy()
        got = np.zeros_like(want)
        got[rows, src] = lists.val.numpy()
        np.testing.assert_array_equal(got, want)
        assert lists.nnz == int(np.count_nonzero(want))
        # Ascending senders within a row: (row, src) keys strictly rise.
        keys = rows.astype(np.int64) * max_nodes + src
        assert bool(np.all(np.diff(keys) > 0))


def test_dense_tiles_budget_and_refusals_match_jax():
    s, r, mask, max_nodes, tile, _ = CASES["random_tile16"]
    sm, rm = s[mask].astype(np.int64), r[mask].astype(np.int64)
    n_tiles = max_nodes // tile
    budget = J.tile_nz_budget(sm, rm, max_nodes, tile)
    assert T.tile_nz_budget(sm, rm, max_nodes, tile) == budget
    data = np.ones(len(sm), np.float32)
    want = J._dense_tiles(rm, sm, data, tile, n_tiles, budget)
    got = T._dense_tiles(rm, sm, data, tile, n_tiles, budget)
    for a, b in zip(got[:3], want):
        assert _np(a).dtype == b.dtype and _np(a).tobytes() == b.tobytes()
    with pytest.raises(ValueError, match="tile budget 4 < "):
        T._dense_tiles(rm, sm, data, tile, n_tiles, 4)
    with pytest.raises(ValueError, match="tile budget 4 < "):
        J._dense_tiles(rm, sm, data, tile, n_tiles, 4)
    for mod in (T, J):
        with pytest.raises(ValueError, match="not a multiple of tile"):
            mod.build_tile_adjacency(s, r, mask, 100, tile=16)
    assert T.tile_vals_dtype(sm, rm) == torch.bfloat16
    assert T.tile_vals_dtype([], []) == torch.bfloat16


def test_pad_and_cast_tiles_match_jax():
    s, r, mask, max_nodes, tile, _ = CASES["random_tile8"]
    want = J.build_tile_adjacency(s, r, mask, max_nodes, tile=tile)
    got = T.build_tile_adjacency(s, r, mask, max_nodes, tile=tile)
    n = int(got.vals.shape[0])
    assert T.pad_tiles(got, n) is got
    grown = T.pad_tiles(got, 2 * n)
    _same_adjacency(grown, J.pad_tiles(want, 2 * n))
    assert bool((grown.rows[1:] >= grown.rows[:-1]).all())
    assert not grown.vals[n:].any() and not grown.t_vals[n:].any()
    for mod, adj in ((T, got), (J, want)):
        with pytest.raises(ValueError, match=f"pad budget {n - 1} < {n}"):
            mod.pad_tiles(adj, n - 1)
    _same_adjacency(T.cast_tiles(got, torch.float32),
                    J.cast_tiles(want, jnp.float32))
    back = T.cast_tiles(T.cast_tiles(got, torch.float32), torch.bfloat16)
    _same_adjacency(back, want)


# ---------------------------------------------------------------------------
# The product and its VJP
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["xla", "interpret"])
@pytest.mark.parametrize("case,h", [("random_tile8", 16),
                                    ("random_tile16", 32),
                                    ("duplicate_and_self_edges", 4),
                                    ("no_edges_fillers_only", 8),
                                    ("explicit_pad_nz", 16)])
def test_tile_spmm_and_vjp_match_jax(impl, case, h):
    s, r, mask, max_nodes, tile, pad_nz = CASES[case]
    jadj = J.build_tile_adjacency(s, r, mask, max_nodes, tile=tile,
                                  pad_nz=pad_nz)
    padj = T.build_csr_adjacency(s, r, mask, max_nodes)
    rng = np.random.default_rng(3)
    msg = rng.standard_normal((max_nodes, h)).astype(np.float32)
    cot = rng.standard_normal((max_nodes, h)).astype(np.float32)
    want, vjp = jax.vjp(lambda m: J.tile_spmm(jadj, m, impl),
                        jnp.asarray(msg))
    (want_grad,) = vjp(jnp.asarray(cot))
    m = torch.from_numpy(msg).requires_grad_()
    got = T.tile_spmm(padj, m)
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(m.grad.numpy(), np.asarray(want_grad), **TOL)
    # The CPU ran the plain version: nothing launched.
    assert T.launch_counts() == dict.fromkeys(T.KERNELS, 0)


def test_f32_vals_are_not_downcast_for_bf16_messages():
    """The upcast-only rule: a multiplicity of 300 keeps f32 values, and
    bf16 messages are upcast, never the values downcast (as
    tests/test_tile_spmm.py holds the reference)."""
    s, r, mask, max_nodes, tile, _ = CASES["multiplicity_300_f32"]
    jadj = J.build_tile_adjacency(s, r, mask, max_nodes, tile=tile)
    padj = T.build_csr_adjacency(s, r, mask, max_nodes)
    assert padj.val.dtype == torch.float32
    assert T.tile_layout(padj, tile).vals.dtype == torch.float32
    got = T.tile_spmm(padj, torch.ones((8, 4), dtype=torch.bfloat16))
    assert got.dtype == torch.bfloat16
    want = np.asarray(J.tile_spmm(jadj, jnp.ones((8, 4), jnp.bfloat16),
                                  "xla").astype(jnp.float32))
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert got[1].float().tolist() == [300.0] * 4


def test_kernel_cost_counts_what_the_product_needs():
    # Edges 0->2 twice, 0->0, 3->3 twice and 9->1 over 16 nodes: the
    # nonzeros A[0,0], A[1,9], A[2,0] (2) and A[3,3] (2).
    s = np.array([0, 0, 0, 3, 3, 9])
    r = np.array([2, 2, 0, 3, 3, 1])
    adj = T.build_csr_adjacency(s, r, np.ones(6, bool), 16)
    cost = T.kernel_cost(adj, hidden=32, tile=8)
    assert cost["nnz"] == 4
    assert cost["flops"] == cost["executed_flops"] == 2.0 * 4 * 32
    # Each nonzero's sender and value (8 bytes), 17 row pointers, the
    # three distinct sender rows of msg (0, 3, 9) and all 16 rows of out.
    assert cost["sender_rows"] == 3
    assert cost["bytes"] == 4 * 8 + 17 * 4 + 3 * 32 * 4 + 16 * 32 * 4
    assert cost["peak_flops"] == 67e12
    # The reference layout at tile 8: edge tiles (0, 0) and (0, 1), a
    # filler for row tile 1, one pad tile up to the budget of 4.
    assert (cost["edge_tiles"], cost["filler_tiles"],
            cost["pad_tiles"]) == (2, 1, 1)
    # A^T: the same nonzeros by sender; its rows 0-3 read msg rows 0, 1,
    # 2 and 3 (the receivers), and both row tiles hold an edge tile.
    tcost = T.kernel_cost(adj, hidden=32, transposed=True, tile=8)
    assert tcost["flops"] == cost["flops"] and tcost["sender_rows"] == 4
    assert tcost["bytes"] == 4 * 8 + 17 * 4 + 4 * 32 * 4 + 16 * 32 * 4
    assert (tcost["edge_tiles"], tcost["filler_tiles"],
            tcost["pad_tiles"]) == (2, 0, 2)
    # Edges 0->1 and 1->2 among 24 nodes: two nonzeros, two sender rows;
    # one edge tile and two fillers at tile 8, which cost nothing.
    small = T.build_csr_adjacency(np.array([0, 1]), np.array([1, 2]),
                                  np.ones(2, bool), 24)
    scost = T.kernel_cost(small, hidden=32, tile=8)
    assert scost["flops"] == 2.0 * 2 * 32 and scost["sender_rows"] == 2
    assert scost["bytes"] == 2 * 8 + 25 * 4 + 2 * 32 * 4 + 24 * 32 * 4
    assert (scost["edge_tiles"], scost["filler_tiles"]) == (1, 2)
    # The tile counts are the built layout's.
    for lists, transposed in ((adj, False), (adj, True), (small, False)):
        c = T.kernel_cost(lists, hidden=32, transposed=transposed, tile=8)
        lay = T.tile_layout(lists, 8)
        vals = lay.t_vals if transposed else lay.vals
        edge = int((vals.reshape(vals.shape[0], -1) != 0).any(1).sum())
        assert c["edge_tiles"] == edge
        assert c["edge_tiles"] + c["filler_tiles"] + c["pad_tiles"] == \
            vals.shape[0]


# ---------------------------------------------------------------------------
# Batches
# ---------------------------------------------------------------------------


def test_batch_iterator_tile_batches_match_jax():
    ex = synthetic_bigvul(50, FeatureSpec(**LIMITS), positive_fraction=0.5,
                          seed=3)
    args = (ex, 16, 1024, 4096, SUBKEYS)
    want = list(jax_batch.batch_iterator(*args, build_tile_adj=True,
                                         shape_series=None))
    got = list(pt_batch.batch_iterator(*args, build_tile_adj=True))
    assert len(got) == len(want) > 2
    for gb, jb in zip(got, want):
        assert gb.band_adj is None
        _same_adjacency(T.tile_layout(gb.tile_adj), jb.tile_adj)
        for name in ("senders", "receivers", "node_mask", "edge_mask"):
            assert _np(getattr(gb, name)).tobytes() == _np(
                getattr(jb, name)).tobytes()
    moved = got[0].to("cpu")
    assert moved.tile_adj is not got[0].tile_adj
    assert torch.equal(moved.tile_adj.ptr, got[0].tile_adj.ptr)
    # A pinned budget: the port pads the built batch with pad_tiles,
    # byte for byte the reference's batch built with tile_pad_nz.
    one = pt_batch.batch_graphs(ex[:4], 4, 256, 1024, SUBKEYS,
                                build_tile_adj=True)
    pinned = jax_batch.batch_graphs(ex[:4], 4, 256, 1024, SUBKEYS,
                                    build_tile_adj=True, tile_pad_nz=32)
    padded = T.pad_tiles(T.tile_layout(one.tile_adj), 32)
    assert padded.vals.shape[0] == 32
    _same_adjacency(padded, pinned.tile_adj)
    _same_adjacency(T.tile_layout(one.tile_adj, pad_nz=32), pinned.tile_adj)


def test_text_graph_batches_tile_match_jax():
    """Missing and over-budget graphs masked, the shuffle: the tile
    adjacencies byte for byte."""
    ex = synthetic_bigvul(21, FeatureSpec(limit_all=30),
                          positive_fraction=0.5, seed=1)
    for i, e in enumerate(ex):
        e["label"] = int(np.asarray(e["vuln"]).max())
        e["id"] = i
    rows = jtext.attach_synthetic_text([dict(e) for e in ex], seed=0)
    data = jtext.encode_dataset(rows, jtext.HashingCodeTokenizer(512),
                                block_size=64)
    graphs = {int(e["id"]): e for e in ex if int(e["id"]) % 5 != 3}
    kw = dict(graphs_by_id=graphs, subkeys=SUBKEYS,
              graph_budget={"max_nodes": 160, "max_edges": 640},
              build_tile_adj=True)
    want = list(jtext_loop.text_graph_batches(
        data, np.arange(21), 8, shuffle_rng=np.random.default_rng(4), **kw))
    got = list(text_loop.text_graph_batches(
        data, np.arange(21), 8, shuffle_rng=np.random.default_rng(4), **kw))
    assert len(got) == len(want) == 3
    assert sum(b.n_missing for b in got) > 4
    for gb, jb in zip(got, want):
        assert gb.n_missing == jb.n_missing
        assert _np(gb.graphs.node_graph).tobytes() == _np(
            jb.graphs.node_graph).tobytes()
        _same_adjacency(T.tile_layout(gb.graphs.tile_adj),
                        jb.graphs.tile_adj)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


def _tile_batches(n_graphs=6, seed=0, tile=16):
    graphs = synthetic_bigvul(n_graphs, FeatureSpec(**LIMITS),
                              positive_fraction=0.5, seed=seed)
    budget = pt_batch.pad_budget_for(graphs, n_graphs)
    max_nodes = T.align_to_tile(budget["max_nodes"], tile)
    args = (graphs, n_graphs, max_nodes, budget["max_edges"], SUBKEYS)
    jb = jax_batch.batch_graphs(*args, tile=tile, build_tile_adj=True,
                                impl="python", shape_series=None)
    pb = pt_batch.batch_graphs(*args, tile=tile, build_tile_adj=True)
    assert pb.tile_adj.n_rows > tile
    _same_adjacency(T.tile_layout(pb.tile_adj, tile), jb.tile_adj)
    return jb, pb


@pytest.mark.parametrize("encoder_mode", [False, True])
def test_tile_flowgnn_matches_jax(encoder_mode):
    """Logits, and the pooled graph embedding in encoder mode, of the
    JAX tile model and the port's on converted params (the tile model's
    tree is the segment model's: ``flowgnn_from_flax`` carries it)."""
    base = dict(hidden_dim=8, n_steps=3, message_impl="tile",
                encoder_mode=encoder_mode)
    jcfg = JFlowGNNConfig(feature=JFeatureSpec(**LIMITS), **base)
    pcfg = FlowGNNConfig(feature=FeatureSpec(**LIMITS), **base)
    jb, pb = _tile_batches(seed=int(encoder_mode))
    jmodel = JFlowGNN(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), jb)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jmodel.apply(params, jb))
    model = FlowGNN(pcfg, device="cpu")
    model.load_state_dict(flowgnn_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    with torch.inference_mode():
        got = model(pb).numpy()
    assert got.shape == want.shape == ((6, 64) if encoder_mode else (6,))
    np.testing.assert_allclose(got, want, **TOL)


def test_tile_model_matches_the_segment_model():
    """The port's tile model against its own segment model on the same
    weights: logits within 1e-5, and every parameter gradient (the
    counterpart of tests/test_tile_spmm.py:80)."""
    cfg = dict(feature=FeatureSpec(**LIMITS), hidden_dim=8)
    seg = FlowGNN(FlowGNNConfig(message_impl="segment", **cfg), device="cpu",
                  seed=0)
    tile = FlowGNN(FlowGNNConfig(message_impl="tile", **cfg), device="cpu")
    tile.load_state_dict(seg.state_dict())
    _, pb = _tile_batches(n_graphs=16, seed=3)

    def run(model):
        model.zero_grad(set_to_none=True)
        out = model(pb)
        (out ** 2).sum().backward()
        return out.detach(), {k: p.grad for k, p in model.named_parameters()}

    out_seg, g_seg = run(seg)
    out_tile, g_tile = run(tile)
    torch.testing.assert_close(out_tile, out_seg, **TOL)
    for name, g in g_seg.items():
        torch.testing.assert_close(g_tile[name], g, rtol=1e-4, atol=1e-5)


def test_tile_model_refuses_a_batch_without_tiles():
    model = FlowGNN(FlowGNNConfig(feature=FeatureSpec(**LIMITS),
                                  hidden_dim=8, message_impl="tile"),
                    device="cpu")
    ex = synthetic_bigvul(2, FeatureSpec(**LIMITS), seed=0)
    batch = pt_batch.batch_graphs(ex, 2, 128, 512, SUBKEYS)
    with pytest.raises(ValueError, match=re.escape(
            "message_impl='tile' needs batch_graphs(build_tile_adj=True)")):
        model(batch)
    jb = jax_batch.batch_graphs(ex, 2, 128, 512, SUBKEYS, impl="python",
                                shape_series=None)
    jmodel = JFlowGNN(JFlowGNNConfig(feature=JFeatureSpec(**LIMITS),
                                     hidden_dim=8, message_impl="tile"))
    with pytest.raises(ValueError, match=re.escape(
            "message_impl='tile' needs batch_graphs(build_tile_adj=True)")):
        jmodel.init(jax.random.PRNGKey(0), jb)


# ---------------------------------------------------------------------------
# CLI and serving
# ---------------------------------------------------------------------------


def test_cli_fit_tile_writes_history(tmp_path, capsys):
    from deepdfa_tpu_torch import cli

    out = tmp_path / "fit"
    cli.main(["fit", "--dataset", "synthetic:48", "--device", "cpu",
              "--max-epochs", "1", "--batch-size", "16", "--message-impl",
              "tile", "--out-dir", str(out)])
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    history = json.loads((out / "history.json").read_text())
    assert history["best_epoch"] == result["best_epoch"] == 0
    assert np.isfinite(history["epochs"][0]["train_loss"])
    assert history["kernel_launches"]["tile_spmm_kernel"] == 0  # the CPU


def test_cli_fit_text_sets_the_graph_encoder(tmp_path, capsys):
    from deepdfa_tpu_torch import cli

    out = tmp_path / "run"
    assert cli.main([
        "fit-text", "--dataset", "synthetic:40", "--graphs", "synthetic",
        "--tiny", "--block-size", "32", "--epochs", "1", "--batch-size",
        "8", "--device", "cpu", "--set", "model.message_impl=tile", "--set",
        "model.n_steps=2", "--out-dir", str(out)]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "f1" in result["test"]
    desc = json.loads((out / "model.json").read_text())
    assert desc["graph_config"]["message_impl"] == "tile"
    assert desc["graph_config"]["n_steps"] == 2
    assert desc["graph_config"]["encoder_mode"]
    history = json.loads((out / "history.json").read_text())
    assert history["graph_kernel_launches"]["tile_spmm_kernel"] == 0
    assert np.isfinite(history["epochs"][0]["train_loss"])


@pytest.mark.parametrize("item,match", [
    ("train.max_epochs=1", "only configures the graph encoder"),
    ("data.batch_size=4", "only configures the graph encoder"),
    ("model.=1", "section.key=value"),
    ("model.bogus=1", "unknown model option 'bogus'"),
])
def test_cli_fit_text_set_refusals(tmp_path, item, match):
    from deepdfa_tpu_torch import cli

    with pytest.raises(ValueError, match=re.escape(match)):
        cli.main(["fit-text", "--tiny", "--device", "cpu", "--set", item,
                  "--out-dir", str(tmp_path / "run")])


def test_set_coerces_like_the_reference():
    from deepdfa_tpu.cli import _coerce as jcoerce
    from deepdfa_tpu_torch import cli
    from deepdfa_tpu_torch.core.config import _coerce, build_configs

    items = ["model.hidden_dim=16", "model.remat_steps=no",
             "model.message_impl=tile", "model.dtype=float32"]
    cli._model_items_only(items)
    cfg = build_configs([], items)["model"]
    got = {k: getattr(cfg, k) for k in ("hidden_dim", "remat_steps",
                                        "message_impl", "dtype")}
    assert got == {"hidden_dim": 16, "remat_steps": False,
                   "message_impl": "tile", "dtype": "float32"}
    for value, ftype in (("16", "int"), ("yes", "bool"), ("0.5", "float"),
                         ("tile", "str")):
        assert _coerce(value, ftype) == jcoerce(value, ftype)


def test_serving_refuses_tile_as_the_reference_does():
    from deepdfa_tpu.serve.engine import ServeEngine as JServeEngine
    from deepdfa_tpu_torch.serve import ServeEngine

    with pytest.raises(ValueError) as jerr:
        JServeEngine(JFlowGNN(JFlowGNNConfig(message_impl="tile",
                                             hidden_dim=8)), None)
    with pytest.raises(ValueError) as perr:
        ServeEngine(FlowGNN(FlowGNNConfig(message_impl="tile", hidden_dim=8),
                            device="cpu"), device="cpu")
    # The same refusal, less the reference's note on its compiled shapes.
    want = re.sub(r" \(pinned bandwidth\)| — .*$", "", str(jerr.value))
    assert str(perr.value) == want
    assert "got 'tile'" in want
