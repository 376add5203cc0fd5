"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a CUDA device (decided in the
fixture, never at import). On a machine with the card::

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_cuda.py -q -m cuda

This file imports nothing of JAX, so it also runs where JAX is absent.
It covers what ``chip_smoke.py`` does not: f32 band values (a multiplicity
that is not bf16-exact), wider bands, odd shapes, the over-gate dispatch
and the refusals.
"""

import dataclasses

import numpy as np
import pytest
import torch

from deepdfa_tpu_torch.core.config import FeatureSpec, FlowGNNConfig
from deepdfa_tpu_torch.data.synthetic import synthetic_bigvul
from deepdfa_tpu_torch.graphs.batch import batch_graphs
from deepdfa_tpu_torch.models.flowgnn import FlowGNN
from deepdfa_tpu_torch.ops import fused_gnn
from deepdfa_tpu_torch.ops.band_spmm import build_band_adjacency

pytestmark = pytest.mark.cuda
STEP_TOL = dict(rtol=1e-5, atol=1e-5)
UNROLL_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _params(hidden, dev, seed=0):
    # Weights at the model's init scale (lecun: std 1/sqrt(fan_in)), so
    # pre-activations keep the magnitudes the served model sees and the
    # comparison reads f32 rounding order at those magnitudes.
    g = torch.Generator().manual_seed(seed)
    std = hidden ** -0.5
    dense = lambda bias: {
        "kernel": (torch.randn(hidden, hidden, generator=g) * std).to(dev),
        **({"bias": (torch.randn(hidden, generator=g) * std).to(dev)}
           if bias else {})}
    return {"edge_linear": dense(True),
            "gru": {n: dense(b) for n, b in (
                ("ir", True), ("iz", True), ("in", True),
                ("hr", False), ("hz", False), ("hn", True))}}


def _graph_adj(sizes, n, tile, seed=0, bandwidth=None):
    """Contiguous graphs (chains, a few extra edges, self loops)."""
    rng = np.random.default_rng(seed)
    s, r, off = [], [], 0
    for size in sizes:
        s += list(range(off, off + size - 1)) + list(range(off, off + size))
        r += list(range(off + 1, off + size)) + list(range(off, off + size))
        s += list(rng.integers(off, off + size, 3))
        r += list(rng.integers(off, off + size, 3))
        off += size
    return build_band_adjacency(s, r, np.ones(len(s), bool), n, tile=tile,
                                bandwidth=bandwidth)


@pytest.mark.parametrize("sizes,n,tile,hidden,f32_vals,bandwidth", [
    ([40] * 16, 1024, 128, 128, False, None),  # the serving shape
    ([40] * 16, 1024, 128, 128, True, None),   # f32 band values
    ([300, 200, 48], 640, 128, 64, False, 2),  # graphs over a tile, B = 2
    ([30, 20, 9], 64, 16, 32, False, 4),       # small tiles, a pinned band
])
def test_kernels_match_plain_versions(cuda, sizes, n, tile, hidden, f32_vals,
                                      bandwidth):
    adj = _graph_adj(sizes, n, tile, bandwidth=bandwidth).to(cuda)
    assert adj.vals.dtype == torch.bfloat16
    if f32_vals:
        # The values a multiplicity over 256 forces to f32, kept small so
        # the comparison reads the load path, not f32 rounding at large
        # magnitudes.
        adj = dataclasses.replace(adj, vals=adj.vals.float())
    params = _params(hidden, cuda)
    h = torch.randn(n, hidden, device=cuda)
    step = fused_gnn.fused_gate_step(params, h, adj)
    torch.testing.assert_close(step, fused_gnn.fused_step_reference(
        params, h, adj), **STEP_TOL)
    if fused_gnn.persistent_smem_ok(adj, hidden):
        unroll = fused_gnn.persistent_unroll(params, h, adj, 5)
        torch.testing.assert_close(unroll, fused_gnn.persistent_reference(
            params, h, adj, 5), **UNROLL_TOL)


def test_launch_counts_move_only_on_launch(cuda):
    adj = _graph_adj([40] * 4, 256, 128).to(cuda)
    params = _params(128, cuda)
    h = torch.randn(256, 128, device=cuda)
    fused_gnn.reset_launch_counts()
    fused_gnn.fused_step_reference(params, h, adj)
    fused_gnn.persistent_reference(params, h, adj, 3)
    assert fused_gnn.launch_counts() == {"fused_step_kernel": 0,
                                         "persistent_fwd_kernel": 0}
    fused_gnn.fused_gate_step(params, h, adj)
    fused_gnn.persistent_unroll(params, h, adj, 3)
    torch.cuda.synchronize()
    assert fused_gnn.launch_counts() == {"fused_step_kernel": 1,
                                         "persistent_fwd_kernel": 1}


def test_over_gate_batch_runs_the_fused_kernel_per_step(cuda):
    # One 600-node graph: its row group needs ~617 KB of shared memory.
    feature = FeatureSpec(limit_all=20, limit_subkeys=20)
    graph = synthetic_bigvul(1, feature, seed=0, min_nodes=600,
                             max_nodes=600)
    cfg = FlowGNNConfig(feature=feature, message_impl="persistent")
    subkeys = ["api", "datatype", "literal", "operator"]
    batch = batch_graphs(graph, 1, 640, 2048, subkeys,
                         build_band_adj=True).to(cuda)
    assert not fused_gnn.persistent_smem_ok(batch.band_adj, 128)
    model = FlowGNN(cfg, device=cuda, seed=0).eval()
    fused_gnn.reset_launch_counts()
    with torch.inference_mode():
        got = model(batch)
    assert model.over_gate_dispatches == 1
    assert fused_gnn.launch_counts() == {"fused_step_kernel": cfg.n_steps,
                                         "persistent_fwd_kernel": 0}
    cpu = FlowGNN(cfg, device="cpu").eval()
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    with torch.inference_mode():
        want = cpu(batch.to("cpu"))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="shared memory"):
        fused_gnn.persistent_unroll(model.ggnn_step.step_params(),
                                    torch.zeros(640, 128, device=cuda),
                                    batch.band_adj, 5)


def test_refusals(cuda):
    adj = _graph_adj([40] * 4, 256, 128).to(cuda)
    params = _params(128, cuda)
    h = torch.randn(256, 128, device=cuda)
    with pytest.raises(NotImplementedError, match="bf16"):
        fused_gnn.fused_gate_step(params, h.bfloat16(), adj)
    with pytest.raises(ValueError, match="rows"):
        fused_gnn.fused_gate_step(params, h[:128], adj)
    with pytest.raises(ValueError, match="hidden"):
        fused_gnn.fused_gate_step(_params(130, cuda),
                                  torch.randn(256, 130, device=cuda), adj)
    with pytest.raises(ValueError, match="float32 on"):
        fused_gnn.fused_gate_step(_params(128, "cpu"), h, adj)
    with pytest.raises(NotImplementedError, match="bf16"):
        FlowGNN(FlowGNNConfig(dtype="bfloat16"), device=cuda)
