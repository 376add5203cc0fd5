"""The port's data, batching and serve-config helpers against the JAX
reference: synthetic graphs and packed batches byte for byte, bucket
rules value for value."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from deepdfa_tpu.core.config import FeatureSpec as JFeatureSpec
from deepdfa_tpu.core.config import subkeys_for
from deepdfa_tpu.data.synthetic import synthetic_bigvul as jax_synthetic
from deepdfa_tpu.graphs import batch as jax_batch
from deepdfa_tpu.serve.config import ServeConfig as JServeConfig
from deepdfa_tpu_torch.core.config import FeatureSpec
from deepdfa_tpu_torch.data.synthetic import synthetic_bigvul
from deepdfa_tpu_torch.graphs import batch as pt_batch
from deepdfa_tpu_torch.serve.config import ServeConfig

SUBKEYS = list(subkeys_for(JFeatureSpec()))


def _np(x):
    """numpy view of a jax or torch array; bf16 as its raw 16-bit words."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _assert_bytes_equal(got, want, what):
    g, w = _np(got), _np(want)
    assert g.dtype == w.dtype, (what, g.dtype, w.dtype)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    assert g.tobytes() == w.tobytes(), what


@pytest.mark.parametrize("seed,limit", [(0, 1000), (3, 20)])
def test_synthetic_bigvul_is_byte_equal(seed, limit):
    spec = dict(limit_all=limit, limit_subkeys=limit)
    want = jax_synthetic(24, JFeatureSpec(**spec), seed=seed)
    got = synthetic_bigvul(24, FeatureSpec(**spec), seed=seed)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key, value in w.items():
            if key == "feats":
                assert sorted(g["feats"]) == sorted(value)
                for k in value:
                    _assert_bytes_equal(g["feats"][k], value[k], k)
            elif isinstance(value, np.ndarray):
                _assert_bytes_equal(g[key], value, key)
            else:
                assert g[key] == value and type(g[key]) is type(value), key


@pytest.mark.parametrize("slots", [1, 2, 4, 8, 16])
def test_batch_graphs_is_byte_equal_at_serving_buckets(slots):
    graphs = jax_synthetic(slots, JFeatureSpec(), seed=slots)
    budget = JServeConfig().budget_for(slots, tile=128)
    assert ServeConfig().budget_for(slots, tile=128) == budget
    want = jax_batch.batch_graphs(
        graphs, slots, budget["max_nodes"], budget["max_edges"], SUBKEYS,
        build_band_adj=True, band_bandwidth=1, impl="python",
        shape_series=None)
    got = pt_batch.batch_graphs(
        synthetic_bigvul(slots, FeatureSpec(), seed=slots), slots,
        budget["max_nodes"], budget["max_edges"], SUBKEYS,
        build_band_adj=True, band_bandwidth=1)
    for k in SUBKEYS:
        _assert_bytes_equal(got.node_feats[k], want.node_feats[k], k)
    for name in ("node_vuln", "senders", "receivers", "node_graph",
                 "node_mask", "edge_mask", "graph_mask", "graph_ids"):
        _assert_bytes_equal(getattr(got, name), getattr(want, name), name)
    _assert_bytes_equal(got.band_adj.vals, want.band_adj.vals, "band vals")
    for name in ("tile", "n_tiles", "bandwidth"):
        assert getattr(got.band_adj, name) == getattr(want.band_adj, name)
    assert (got.n_graphs, got.max_nodes, got.max_edges) == (
        want.n_graphs, want.max_nodes, want.max_edges)


def test_batch_graphs_without_band_and_pad_budget_match():
    graphs = synthetic_bigvul(40, FeatureSpec(), seed=9)
    for n_graphs in (4, 16):
        budget = pt_batch.pad_budget_for(graphs, n_graphs)
        assert budget == jax_batch.pad_budget_for(graphs, n_graphs)
    budget = pt_batch.pad_budget_for(graphs[:8], 8)
    want = jax_batch.batch_graphs(graphs[:8], 8, budget["max_nodes"],
                                  budget["max_edges"], SUBKEYS, impl="python",
                                  shape_series=None)
    got = pt_batch.batch_graphs(graphs[:8], 8, budget["max_nodes"],
                                budget["max_edges"], SUBKEYS)
    assert got.band_adj is None
    _assert_bytes_equal(got.senders, want.senders, "senders")
    _assert_bytes_equal(got.node_graph, want.node_graph, "node_graph")


def test_batch_graphs_rejects_what_the_reference_rejects():
    from deepdfa_tpu_torch.contracts.schema import ContractError

    g = dict(synthetic_bigvul(1, FeatureSpec(), seed=0)[0])
    g["senders"] = np.array(g["senders"]) + 1000
    with pytest.raises(ContractError) as e:
        pt_batch.batch_graphs([g], 1, 64, 256, SUBKEYS)
    assert e.value.reason == "dangling_endpoint"
    with pytest.raises(ValueError, match="overflows budget"):
        pt_batch.batch_graphs(synthetic_bigvul(2, FeatureSpec(), seed=0),
                              2, 16, 512, SUBKEYS)


@pytest.mark.parametrize("n,maximum,minimum", [
    (1, None, 16), (17, None, 16), (3, 16, 1), (16, 16, 1), (20, 16, 1),
    (5000, None, 16), (2 ** 21 + 1, None, 16), (0, 4, 1)])
def test_select_bucket_matches(n, maximum, minimum):
    assert (pt_batch.select_bucket(n, maximum, minimum)
            == jax_batch.select_bucket(n, maximum, minimum))


@pytest.mark.parametrize("batch_slots", [1, 3, 16])
def test_serve_config_buckets_and_budgets_match(batch_slots):
    j, p = JServeConfig(batch_slots=batch_slots), ServeConfig(
        batch_slots=batch_slots)
    assert p.slot_buckets == j.slot_buckets
    for n in range(1, batch_slots + 1):
        assert p.bucket_for(n) == j.bucket_for(n)
    for slots in j.slot_buckets:
        for tile in (None, 128):
            assert p.budget_for(slots, tile=tile) == j.budget_for(
                slots, tile=tile)
    for n, e in ((64, 256), (65, 65), (10, 41), (10, 40)):
        assert p.admission_caps(n, e) == j.admission_caps(n, e)
