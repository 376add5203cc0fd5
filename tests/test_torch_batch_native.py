"""Dense-slot packing and the C++ batcher of the port against the JAX
package: ``slot_nodes_for`` value for value; slot batches (with and
without the dataflow bits) and the band values over them byte for byte;
the native and python batchers byte for byte against each other and the
JAX batcher, overflow messages word for word; and a failed native build
raises instead of falling back."""


import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from deepdfa_tpu.core.config import FeatureSpec as JFeatureSpec
from deepdfa_tpu.core.config import subkeys_for
from deepdfa_tpu.data.synthetic import synthetic_bigvul as jax_synthetic
from deepdfa_tpu.graphs import batch as jbatch
from deepdfa_tpu_torch import native
from deepdfa_tpu_torch.core.config import FeatureSpec
from deepdfa_tpu_torch.data.synthetic import synthetic_bigvul
from deepdfa_tpu_torch.graphs import batch as pbatch
from deepdfa_tpu_torch.ops.tile_spmm import DEFAULT_TILE, align_to_tile

SUBKEYS = list(subkeys_for(JFeatureSpec()))
ARRAYS = ("node_vuln", "senders", "receivers", "node_graph", "node_mask",
          "edge_mask", "graph_mask", "graph_ids")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the first ``torch.exp`` of a process that
    splits across threads (MKL's ``vmsExp``, more than 2048 elements)
    can come back with a relative error near 1e-4 in one thread's chunk
    (``scripts/torch_first_exp_race.py``), and the fits below compare
    their losses exactly."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bytes(x):
    """numpy of a jax or torch array; bf16 band values as 16-bit words."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _assert_same_batch(got, want, dataflow=False):
    names = ARRAYS + (("node_df_in", "node_df_out") if dataflow else ())
    for name in names:
        g, w = _bytes(getattr(got, name)), _bytes(getattr(want, name))
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert g.tobytes() == w.tobytes(), name
    for k in SUBKEYS:
        g, w = _bytes(got.node_feats[k]), _bytes(want.node_feats[k])
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), k
    if want.band_adj is not None:
        assert _bytes(got.band_adj.vals).tobytes() == \
            _bytes(want.band_adj.vals).tobytes()
        for name in ("tile", "n_tiles", "bandwidth"):
            assert getattr(got.band_adj, name) == \
                getattr(want.band_adj, name)


def _graphs(n, seed, **kw):
    return (jax_synthetic(n, JFeatureSpec(), seed=seed, **kw),
            synthetic_bigvul(n, FeatureSpec(), seed=seed, **kw))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("n,tile", [(1, None), (8, 128), (40, 64),
                                    (256, 128)])
def test_slot_nodes_for_matches_jax(seed, n, tile):
    jg, pg = _graphs(n, seed)
    for minimum in (1, 16):
        assert pbatch.slot_nodes_for(pg, minimum=minimum, tile=tile) == \
            jbatch.slot_nodes_for(jg, minimum=minimum, tile=tile)
    assert pbatch.slot_nodes_for([]) == jbatch.slot_nodes_for([])
    with pytest.raises(ValueError, match="power of two"):
        pbatch.slot_nodes_for(pg, tile=96)


@pytest.mark.parametrize("dataflow", [False, True])
@pytest.mark.parametrize("band", [False, True])
@pytest.mark.parametrize("n_graphs,seed", [(4, 0), (16, 1), (64, 2)])
def test_slot_batches_match_jax(dataflow, band, n_graphs, seed):
    jg, pg = _graphs(n_graphs, seed)
    slot = pbatch.slot_nodes_for(pg, tile=DEFAULT_TILE)
    max_nodes = align_to_tile(n_graphs * slot)
    max_edges = jbatch.pad_budget_for(jg, n_graphs)["max_edges"]
    kw = dict(build_band_adj=band, with_dataflow=dataflow, slot_nodes=slot)
    want = jbatch.batch_graphs(jg, n_graphs, max_nodes, max_edges, SUBKEYS,
                               shape_series=None, **kw)
    got = pbatch.batch_graphs(pg, n_graphs, max_nodes, max_edges, SUBKEYS,
                              **kw)
    _assert_same_batch(got, want, dataflow)
    # Slot gi starts at gi * slot: the dataflow bits sit with the features.
    starts = _bytes(got.node_graph)[np.arange(n_graphs) * slot]
    assert starts.tolist() == list(range(n_graphs))


@pytest.mark.parametrize("dataflow", [False, True])
def test_slot_iterator_matches_jax(dataflow):
    jg, pg = _graphs(60, 3)
    slot = pbatch.slot_nodes_for(pg)
    # 4 slots a batch and a tight edge budget: the iterator spills on
    # either.
    args = (4, 4 * slot, 400, SUBKEYS)
    want = list(jbatch.batch_iterator(jg, *args, slot_nodes=slot,
                                      with_dataflow=dataflow,
                                      shape_series=None))
    got = list(pbatch.batch_iterator(pg, *args, slot_nodes=slot,
                                     with_dataflow=dataflow))
    assert len(got) == len(want) >= 15
    for g, w in zip(got, want):
        _assert_same_batch(g, w, dataflow)


def test_slot_packing_refusals_match_jax():
    jg, pg = _graphs(4, 5, min_nodes=20, max_nodes=30)
    for args, kw in (((4, 64, 512, SUBKEYS), dict(slot_nodes=32)),
                     ((4, 256, 512, SUBKEYS), dict(slot_nodes=16)),
                     ((4, 256, 512, SUBKEYS), dict(slot_nodes=0))):
        with pytest.raises(ValueError) as jerr:
            jbatch.batch_graphs(jg, *args, shape_series=None, **kw)
        with pytest.raises(ValueError) as perr:
            pbatch.batch_graphs(pg, *args, **kw)
        assert str(perr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="no native batcher path"):
        pbatch.batch_graphs(pg, 4, 256, 512, SUBKEYS, slot_nodes=32,
                            impl="native")
    with pytest.raises(ValueError) as jerr:
        list(jbatch.batch_iterator(jg, 4, 256, 512, SUBKEYS, slot_nodes=16,
                                   shape_series=None))
    with pytest.raises(ValueError) as perr:
        list(pbatch.batch_iterator(pg, 4, 256, 512, SUBKEYS, slot_nodes=16))
    assert str(perr.value) == str(jerr.value)


@pytest.mark.parametrize("self_loops", [True, False])
@pytest.mark.parametrize("n_graphs,seed", [(1, 0), (16, 1), (256, 2)])
def test_native_python_and_jax_batches_are_equal(self_loops, n_graphs, seed):
    jg, pg = _graphs(n_graphs, seed)
    budget = jbatch.pad_budget_for(jg, n_graphs)
    args = (n_graphs, budget["max_nodes"], budget["max_edges"], SUBKEYS)
    want = jbatch.batch_graphs(jg, *args, add_self_loops=self_loops,
                               shape_series=None)
    batches = {impl: pbatch.batch_graphs(pg, *args,
                                         add_self_loops=self_loops,
                                         impl=impl)
               for impl in ("native", "python", "auto")}
    for impl, got in batches.items():
        _assert_same_batch(got, want)
    # Fewer graphs than slots, an empty batch, the band on top.
    args = (n_graphs, align_to_tile(budget["max_nodes"]),
            budget["max_edges"], SUBKEYS)
    for graphs, jgraphs in ((pg[: n_graphs // 2], jg[: n_graphs // 2]),
                            ([], [])):
        want = jbatch.batch_graphs(jgraphs, *args, shape_series=None,
                                   build_band_adj=True, impl="python")
        for impl in ("native", "python"):
            _assert_same_batch(pbatch.batch_graphs(
                graphs, *args, build_band_adj=True, impl=impl), want)


@pytest.mark.parametrize("nodes,edges", [(40, 4096), (4096, 60)])
def test_overflow_messages_match(nodes, edges):
    jg, pg = _graphs(8, 4)
    with pytest.raises(ValueError) as jerr:
        jbatch.batch_graphs(jg, 8, nodes, edges, SUBKEYS, impl="python",
                            shape_series=None)
    for impl in ("native", "python"):
        with pytest.raises(ValueError) as perr:
            pbatch.batch_graphs(pg, 8, nodes, edges, SUBKEYS, impl=impl)
        assert str(perr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="unknown impl"):
        pbatch.batch_graphs(pg, 8, 4096, 4096, SUBKEYS, impl="cuda")


def test_fill_batch_matches_the_jax_native_batcher():
    jnative = pytest.importorskip("deepdfa_tpu.native")
    jg, pg = _graphs(32, 6)
    args = (32, 2048, 8192, SUBKEYS, True)
    got = native.fill_batch(pg, *args)
    want = jnative.fill_batch(jg, *args)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("cxx", ["false", "/nonexistent/c++"])
def test_a_failed_build_raises_and_nothing_falls_back(tmp_path, monkeypatch,
                                                      cxx):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setenv("CXX", cxx)
    _, pg = _graphs(2, 0)
    for impl in ("auto", "native"):
        with pytest.raises(RuntimeError, match="native batcher build failed"):
            pbatch.batch_graphs(pg, 2, 256, 1024, SUBKEYS, impl=impl)
    # The python loop is still there when asked for by name.
    assert pbatch.batch_graphs(pg, 2, 256, 1024, SUBKEYS,
                               impl="python").graph_mask.all()


def test_fit_is_the_same_on_either_batcher(monkeypatch):
    import functools

    from deepdfa_tpu_torch.core.config import (
        DataConfig,
        FlowGNNConfig,
        TrainConfig,
    )
    from deepdfa_tpu_torch.data.splits import make_splits
    from deepdfa_tpu_torch.models.flowgnn import FlowGNN
    from deepdfa_tpu_torch.train import loop

    feat = FeatureSpec(limit_all=20, limit_subkeys=20)
    examples = synthetic_bigvul(48, feat, positive_fraction=0.5, seed=2)
    for i, ex in enumerate(examples):
        ex["id"] = i
    splits = make_splits(examples, mode="random", seed=0)
    losses = {}
    for impl in ("native", "python"):
        # fit's batches come from loop.batch_iterator; pin its batcher.
        monkeypatch.setattr(loop, "batch_iterator", functools.partial(
            pbatch.batch_iterator, impl=impl))
        model = FlowGNN(FlowGNNConfig(feature=feat, hidden_dim=8, n_steps=2),
                        device="cpu", seed=0)
        _, history = loop.fit(model, examples, splits,
                              TrainConfig(max_epochs=2, checkpoint_dir=None),
                              DataConfig(batch_size=8))
        losses[impl] = [r["step_losses"] for r in history["epochs"]]
    assert losses["native"] == losses["python"]
