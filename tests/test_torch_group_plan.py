"""The host's plan for the persistent gated-step kernels: closed row
groups, the shared memory each kernel's blocks need, and how many blocks
of a thread-block cluster share a group, at the shapes the port runs
(the serving bucket and the first training batch of ``fit``) and on
random edge sets. CPU only: the plan is host ints."""

import dataclasses

import numpy as np
import pytest
import torch

from deepdfa_tpu_torch.core.config import (
    DataConfig,
    FlowGNNConfig,
    TrainConfig,
)
from deepdfa_tpu_torch.data.combined import load_graph_source
from deepdfa_tpu_torch.data.sampling import epoch_indices
from deepdfa_tpu_torch.data.splits import make_splits
from deepdfa_tpu_torch.data.synthetic import synthetic_bigvul
from deepdfa_tpu_torch.graphs.batch import batch_graphs
from deepdfa_tpu_torch.models.flowgnn import FlowGNN
from deepdfa_tpu_torch.ops import band_spmm, fused_gnn
from deepdfa_tpu_torch.serve import ServeConfig
from deepdfa_tpu_torch.serve.engine import bucket_batch
from deepdfa_tpu_torch.train import loop

H100_SMS = 132
BUDGET = fused_gnn.PERSISTENT_SMEM_BUDGET_BYTES


def _closed_and_covering(cuts, s, r, n):
    assert cuts[0] == 0 and cuts[-1] == n and np.all(np.diff(cuts) > 0)
    group = np.searchsorted(cuts, np.arange(n), side="right") - 1
    assert np.array_equal(group[s], group[r])  # no edge crosses a cut


def _random_graphs(rng, n):
    """Contiguous graphs of 1-60 nodes (chains plus random edges inside
    each) filling most of n rows; the rest are padding rows."""
    s, r, off = [], [], 0
    while True:
        size = int(rng.integers(1, 61))
        if off + size > n - 8:
            return np.asarray(s, np.int64), np.asarray(r, np.int64)
        s += list(range(off, off + size - 1))
        r += list(range(off + 1, off + size))
        extra = rng.integers(off, off + size, (2, size // 3 + 1))
        s += list(extra[0])
        r += list(extra[1])
        off += size


@pytest.mark.parametrize("target", [16, 32, 64])
@pytest.mark.parametrize("seed", [0, 1])
def test_groups_close_and_cover_for_each_target(seed, target):
    rng = np.random.default_rng(seed)
    n = 1024
    s, r = _random_graphs(rng, n)
    cuts = band_spmm.closed_row_groups(s, r, n, target)
    _closed_and_covering(cuts, s, r, n)
    # Unstructured edges (any sender, any receiver) still close: the cuts
    # fall only where no edge spans them.
    s2 = rng.integers(0, n, 40)
    r2 = rng.integers(0, n, 40)
    _closed_and_covering(band_spmm.closed_row_groups(s2, r2, n, target), s2,
                         r2, n)


def _plan(adj, hidden=128):
    return dict(
        groups=adj.row_groups.numel() - 1, max_rows=adj.max_group_rows,
        cluster=fused_gnn.persistent_cluster_size(adj, hidden, H100_SMS),
        fwd=fused_gnn.persistent_smem_bytes(adj, hidden),
        bwd=fused_gnn.persistent_bwd_smem_bytes(adj, hidden))


def _fit_first_batch(model, n_examples=2600):
    """The first band batch of ``cli fit --dataset synthetic:2600``'s first
    epoch at the default configs (256 graph slots, N 16384)."""
    seed = TrainConfig().seed
    examples = load_graph_source(f"synthetic:{n_examples}",
                                 model.config.feature, seed=seed)
    train = make_splits(examples, mode="random", seed=seed)["train"]
    idx = epoch_indices([examples[i]["label"] for i in train], 0,
                        seed=DataConfig().seed)
    return next(iter(loop._batches(
        examples, train[idx], DataConfig(), list(model.subkeys),
        DataConfig().batch_size, build_band_adj=True)))


def test_plan_at_the_serving_and_training_shapes():
    model = FlowGNN(FlowGNNConfig(message_impl="persistent"), device="cpu",
                    seed=0)
    graphs = synthetic_bigvul(16, model.config.feature, seed=0)
    config = ServeConfig()
    budget = config.budget_for(16, tile=128)
    own = batch_graphs(graphs, 16, budget["max_nodes"], budget["max_edges"],
                       list(model.subkeys), build_band_adj=True,
                       band_bandwidth=config.band_bandwidth).band_adj
    training = _fit_first_batch(model).band_adj
    # Groups of up to 48 rows at both shapes; a block's row arrays and
    # weight stages at 48 rows: 87,744 bytes forward (113,088 with the
    # cluster's third array), 113,088 backward: two blocks an SM.
    assert _plan(own) == dict(groups=34, max_rows=48, cluster=2,
                              fwd=87_744, bwd=113_088)
    assert _plan(training) == dict(groups=523, max_rows=48, cluster=1,
                                   fwd=87_744, bwd=113_088)
    assert fused_gnn.persistent_smem_bytes(own, 128, 2) == 113_088
    # As the engine packs the serving bucket: its cut points padded to the
    # bucket's bound, 63 groups of up to 64 rows whatever the graphs, so
    # every batch of it has one grid (126 blocks in clusters of 2) and one
    # shared-memory size (138,496 bytes with the cluster's third array:
    # one block an SM).
    serving = bucket_batch(config, graphs, 16, list(model.subkeys),
                           band=True).band_adj
    assert _plan(serving) == dict(groups=63, max_rows=64, cluster=2,
                                  fwd=104_704, bwd=138_496)
    assert fused_gnn.persistent_smem_bytes(serving, 128, 2) == 138_496
    assert np.array_equal(serving.row_groups.numpy()[:35],
                          own.row_groups.numpy())
    for adj in (own, serving, training):
        assert fused_gnn.persistent_smem_ok(adj, 128)
        assert fused_gnn.persistent_bwd_smem_ok(adj, 128)


def test_shared_memory_over_the_budget():
    # One 600-node graph is one group: over both gates. 184 rows are the
    # forward's limit at H 128, 123 the backward's.
    def chain(rows, n):
        c = np.arange(rows)
        return band_spmm.build_band_adjacency(c[:-1], c[1:],
                                              np.ones(rows - 1, bool), n)

    big = chain(600, 640)
    assert fused_gnn.persistent_smem_bytes(big, 128) > BUDGET
    assert fused_gnn.persistent_bwd_smem_bytes(big, 128) > BUDGET
    assert fused_gnn.persistent_smem_bytes(chain(184, 256), 128) <= BUDGET
    assert fused_gnn.persistent_smem_bytes(chain(185, 256), 128) > BUDGET
    assert fused_gnn.persistent_bwd_smem_bytes(chain(123, 128), 128) <= BUDGET
    assert fused_gnn.persistent_bwd_smem_bytes(chain(124, 128), 128) > BUDGET


@pytest.mark.parametrize("n_groups,rows,hidden,want", [
    (523, 32, 128, 1),   # the training batch: the groups fill the card
    (132, 32, 128, 1),
    (34, 48, 128, 2),    # the serving bucket
    (66, 32, 128, 2),    # 2 x 66 = 132 blocks: one an SM
    (67, 32, 128, 1),    # 134 blocks > 132
    (1, 112, 128, 2),    # one group
    (1, 123, 128, 2),    # the cluster's three row arrays at their limit
    (1, 124, 128, 1),    # ... and over it
    (10, 32, 64, 2),     # 64 columns: 2 slices of 32
    (10, 32, 32, 1),     # 32 columns: no slice
])
def test_cluster_size(n_groups, rows, hidden, want):
    cuts = torch.arange(n_groups + 1, dtype=torch.int32) * rows
    adj = band_spmm.BandAdjacency(
        vals=torch.zeros(3, 1, 1, 1), row_groups=cuts, max_group_rows=rows)
    assert fused_gnn.persistent_cluster_size(adj, hidden, H100_SMS) == want
    # None on a card the groups already fill.
    assert fused_gnn.persistent_cluster_size(
        dataclasses.replace(adj), hidden, n_groups) == 1
