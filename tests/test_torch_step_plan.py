"""The host's plan for the per-step gated-step kernels
(``fused_step_kernel``, ``fused_step_bwd_kernel``): the row tile a block
owns, the blocks of a cluster that share it, the k rows of a gate slab,
the grid and the shared memory a block needs, at the shapes the port runs
(the serving bucket, the flagship batch, the first training batch of
``fit``) on an H100 SXM's 132 SMs, and across widths, row counts and SM
counts. The CUDA launchers plan the same on the host with the device's SM
count (``csrc/fused_gnn.cu:step_fwd_plan``,
``csrc/fused_gnn_bwd.cu:step_bwd_plan``); a card test and chip_smoke.py
hold them, shared memory included, to this one. CPU only: the plan is
host ints."""

import numpy as np
import pytest

from deepdfa_tpu_torch.core.config import (
    DataConfig,
    FlowGNNConfig,
    TrainConfig,
)
from deepdfa_tpu_torch.data.combined import load_graph_source
from deepdfa_tpu_torch.data.sampling import epoch_indices
from deepdfa_tpu_torch.data.splits import make_splits
from deepdfa_tpu_torch.data.synthetic import synthetic_bigvul
from deepdfa_tpu_torch.graphs.batch import batch_graphs, pad_budget_for
from deepdfa_tpu_torch.models.flowgnn import FlowGNN
from deepdfa_tpu_torch.ops import band_spmm, fused_gnn
from deepdfa_tpu_torch.ops.tile_spmm import DEFAULT_TILE, align_to_tile
from deepdfa_tpu_torch.serve import ServeConfig
from deepdfa_tpu_torch.serve.engine import bucket_batch
from deepdfa_tpu_torch.train import loop

BUDGET = fused_gnn.PERSISTENT_SMEM_BUDGET_BYTES
FWD, BWD = "fused_step_kernel", "fused_step_bwd_kernel"
H100_SMS = 132


def _model():
    return FlowGNN(FlowGNNConfig(message_impl="persistent"), device="cpu",
                   seed=0)


def _serving(model):
    graphs = synthetic_bigvul(16, model.config.feature, seed=0)
    return bucket_batch(ServeConfig(), graphs, 16, list(model.subkeys),
                        band=True).band_adj


def _flagship(model):
    # 256 synthetic graphs packed as the JAX package's flagship example
    # batch (chip_smoke.py's flagship shape).
    graphs = synthetic_bigvul(256, model.config.feature,
                              positive_fraction=0.5, seed=0)
    budget = pad_budget_for(graphs, 256)
    return batch_graphs(graphs, 256, align_to_tile(budget["max_nodes"]),
                        budget["max_edges"], list(model.subkeys),
                        tile=DEFAULT_TILE, build_band_adj=True).band_adj


def _training(model):
    # The first band batch of `cli fit --dataset synthetic:2600`.
    seed = TrainConfig().seed
    examples = load_graph_source("synthetic:2600", model.config.feature,
                                 seed=seed)
    train = make_splits(examples, mode="random", seed=seed)["train"]
    idx = epoch_indices([examples[i]["label"] for i in train], 0,
                        seed=DataConfig().seed)
    return next(iter(loop._batches(
        examples, train[idx], DataConfig(), list(model.subkeys),
        DataConfig().batch_size, build_band_adj=True))).band_adj


def _plans(adj, hidden=128, sms=H100_SMS):
    n = adj.n_tiles * adj.tile
    return (n, fused_gnn.step_plan(n, hidden, sms, FWD),
            fused_gnn.step_plan(n, hidden, sms, BWD),
            fused_gnn.step_smem_bytes(n, hidden, sms, FWD),
            fused_gnn.step_smem_bytes(n, hidden, sms, BWD, 0),
            fused_gnn.step_smem_bytes(n, hidden, sms, BWD, 1))


@pytest.mark.parametrize("shape,want", [
    # The serving bucket: 64 tiles of 16 rows, a 2-block cluster each
    # (128 blocks, two an SM); the backward's 64 tiles of 16 rows.
    ("serving", (1024, dict(row_tile=16, cluster=2, slab_rows=8,
                            blocks=128, wide=False),
                 dict(row_tile=16, cluster=1, slab_rows=4, blocks=64,
                      wide=False), 99_136, 62_272, 53_824)),
    # The flagship batch: 128 wide tiles of 64 rows, one block an SM;
    # the backward's 256 tiles of 32 rows, two an SM.
    ("flagship", (8192, dict(row_tile=64, cluster=1, slab_rows=16,
                             blocks=128, wide=True),
                  dict(row_tile=32, cluster=1, slab_rows=4, blocks=256,
                       wide=False), 215_296, 87_680, 70_784)),
    # The training batch: 256 wide tiles; the backward's 512.
    ("training", (16384, dict(row_tile=64, cluster=1, slab_rows=16,
                              blocks=256, wide=True),
                  dict(row_tile=32, cluster=1, slab_rows=4, blocks=512,
                       wide=False), 215_296, 87_680, 70_784)),
])
def test_plan_at_the_serving_flagship_and_training_shapes(shape, want):
    model = _model()
    adj = {"serving": _serving, "flagship": _flagship,
           "training": _training}[shape](model)
    assert _plans(adj) == want


def test_plan_ignores_the_graphs():
    # Two batches of the same rows, one graph against 40-row graphs: the
    # same tiles and shared memory (no gate, nothing sized by a group).
    def chain(sizes, n):
        s, r, off = [], [], 0
        for size in sizes:
            s += list(range(off, off + size - 1))
            r += list(range(off + 1, off + size))
            off += size
        return band_spmm.build_band_adjacency(
            np.asarray(s), np.asarray(r), np.ones(len(s), bool), n)

    one, many = chain([600], 640), chain([40] * 15, 640)
    assert one.max_group_rows == 600 and many.max_group_rows == 40
    assert not fused_gnn.persistent_smem_ok(one, 128)
    assert _plans(one) == _plans(many)


@pytest.mark.parametrize("sms", [H100_SMS, 114])
@pytest.mark.parametrize("hidden", [128, 100, 72, 64, 36, 32, 8])
@pytest.mark.parametrize("n_rows", [16, 640, 1024, 3000, 4096, 4224, 8192,
                                    16384, 40_000])
def test_plan_covers_the_rows_within_the_budget(n_rows, hidden, sms):
    hp = fused_gnn.persistent_row_stride(hidden) - 4
    for kernel in (FWD, BWD):
        p = fused_gnn.step_plan(n_rows, hidden, sms, kernel)
        tiles = -(-n_rows // p["row_tile"])
        assert p["blocks"] == tiles * p["cluster"]
        assert (tiles - 1) * p["row_tile"] < n_rows <= tiles * p["row_tile"]
        assert hidden % p["slab_rows"] == 0
        passes = (0, 1) if kernel == BWD else (0,)
        for bwd_pass in passes:
            smem = fused_gnn.step_smem_bytes(n_rows, hidden, sms, kernel,
                                             bwd_pass)
            assert smem <= BUDGET
            if not p["wide"]:  # two blocks an SM
                assert 2 * smem <= 228 * 1024 - 2 * 1024
    p = fused_gnn.step_plan(n_rows, hidden, sms, FWD)
    # Clusters of 16-row tiles only where 32-row tiles leave SMs idle and
    # each block of the pair keeps 32 columns; the wide products at
    # hp = 128 otherwise.
    few = -(-n_rows // 32) < sms
    assert p["cluster"] == (2 if few and hp >= 64 else 1)
    assert p["wide"] == (p["cluster"] == 1 and hp == 128)
    assert p["row_tile"] == (16 if p["cluster"] == 2
                             else fused_gnn.STEP_WIDE_TILE)
    assert fused_gnn.step_plan(n_rows, hidden, sms, BWD)["row_tile"] == (
        16 if few else 32)


def test_plan_names_only_the_per_step_kernels():
    with pytest.raises(ValueError, match="per-step"):
        fused_gnn.step_plan(1024, 128, H100_SMS, "persistent_fwd_kernel")


BWD16 = "fused_step_bwd_kernel_bf16"


@pytest.mark.parametrize("shape,want", [
    # The bf16 backward takes the f32 backward's tiles, its weight stage
    # 16 k rows of the gate's six slabs (26,112 bytes at H 128); its
    # three passes hold h (the messages' pass), the cotangent and either
    # h, x and the messages or the dp rows (the gate's), dx and dmsg
    # (A^T's), rows at a stride of 136 elements.
    ("serving", (16, 64, (30_464, 52_288, 43_584))),
    ("flagship", (32, 256, (34_816, 78_464, 61_056))),
    ("training", (32, 512, (34_816, 78_464, 61_056))),
])
def test_bf16_backward_plan_and_shared_memory(shape, want):
    adj = {"serving": _serving, "flagship": _flagship,
           "training": _training}[shape](_model())
    n = adj.n_tiles * adj.tile
    row_tile, blocks, smem = want
    plan = fused_gnn.step_plan(n, 128, H100_SMS, BWD16)
    assert plan == dict(fused_gnn.step_plan(n, 128, H100_SMS, BWD),
                        row_tile=row_tile, blocks=blocks, slab_rows=16)
    got = tuple(fused_gnn.step_smem_bytes(n, 128, H100_SMS, BWD16, p)
                for p in range(3))
    assert got == smem and max(got) <= BUDGET
