"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a CUDA device (decided in the
fixture, never at import). On a machine with the card::

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_cuda.py -q -m cuda

This file imports nothing of JAX, so it also runs where JAX is absent.
It covers what ``chip_smoke.py`` does not: f32 band values (a multiplicity
that is not bf16-exact), wider bands, odd shapes, the over-gate dispatch
and the refusals, for the forward kernels and the backward ones; and
that ``loss.backward()`` through FlowGNN on the card gives the CPU
model's parameter gradients in both kernel lanes.
"""

import dataclasses

import numpy as np
import pytest
import torch

from deepdfa_tpu_torch.core.config import FeatureSpec, FlowGNNConfig
from deepdfa_tpu_torch.data.synthetic import synthetic_bigvul
from deepdfa_tpu_torch.graphs.batch import batch_graphs, pad_budget_for
from deepdfa_tpu_torch.models.flowgnn import FlowGNN
from deepdfa_tpu_torch.ops import fused_gnn
from deepdfa_tpu_torch.ops.band_spmm import build_band_adjacency
from deepdfa_tpu_torch.ops.tile import align_to_tile

pytestmark = pytest.mark.cuda
STEP_TOL = dict(rtol=1e-5, atol=1e-5)
UNROLL_TOL = dict(rtol=1e-4, atol=1e-4)
# Weight gradients sum over every row: |kernel - plain| <= GRAD_TOL *
# max|plain| per tensor (chip_smoke.py's rule).
GRAD_TOL = 1e-4
SUBKEYS = ["api", "datatype", "literal", "operator"]
ALL_KERNELS = ("fused_step_kernel", "persistent_fwd_kernel",
               "fused_step_bwd_kernel", "persistent_fwd_hist_kernel",
               "persistent_bwd_kernel", "step_weight_grad_kernel")


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
    fused_gnn.fused_step_backward_reference(params, h, adj, h)
    fused_gnn.persistent_backward_reference(params, h, adj, h, 3)
    assert fused_gnn.launch_counts() == dict.fromkeys(ALL_KERNELS, 0)
    fused_gnn.fused_gate_step(params, h, adj)
    fused_gnn.persistent_unroll(params, h, adj, 3)
    fused_gnn.fused_step_backward(params, h, adj, h)
    fused_gnn.persistent_backward(params, h, adj, h, 3)
    torch.cuda.synchronize()
    # The step VJP launches the step backward and the weight gradients;
    # the K-step VJP the recompute sweep, the reverse sweep and the
    # weight gradients.
    assert fused_gnn.launch_counts() == {
        "fused_step_kernel": 1, "persistent_fwd_kernel": 1,
        "fused_step_bwd_kernel": 1, "persistent_fwd_hist_kernel": 1,
        "persistent_bwd_kernel": 1, "step_weight_grad_kernel": 2}


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
    counts = fused_gnn.launch_counts()
    assert counts["fused_step_kernel"] == cfg.n_steps
    assert sum(counts.values()) == cfg.n_steps
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


# ---------------------------------------------------------------------------
# The backward kernels
# ---------------------------------------------------------------------------


def _grads_close(got, want):
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.isfinite(a).all()
        rel = ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
        assert rel <= GRAD_TOL, rel


@pytest.mark.parametrize("sizes,n,tile,hidden,f32_vals,bandwidth", [
    ([40] * 16, 1024, 128, 128, False, None),  # B = 1
    ([40] * 16, 1024, 128, 128, True, None),   # f32 band values
    ([40] * 16, 1024, 128, 128, False, 2),     # B = 2
    ([48, 30, 20, 9], 128, 16, 32, False, 4),  # tile 16, B = 4
    ([60, 33], 128, 16, 64, False, 2),         # hidden 64
])
def test_backward_kernels_match_plain_versions(cuda, sizes, n, tile, hidden,
                                               f32_vals, bandwidth):
    adj = _graph_adj(sizes, n, tile, bandwidth=bandwidth).to(cuda)
    if f32_vals:
        adj = dataclasses.replace(adj, vals=adj.vals.float())
    params = _params(hidden, cuda, seed=1)
    h = torch.randn(n, hidden, device=cuda)
    g = torch.randn(n, hidden, device=cuda)
    rows = fused_gnn.fused_step_bwd_rows(params, h, adj, g)
    want = fused_gnn.fused_step_bwd_rows_reference(params, h, adj, g)
    for a, b in zip(rows, want):
        torch.testing.assert_close(a, b, **STEP_TOL)
    _grads_close(fused_gnn.fused_step_backward(params, h, adj, g)[1:],
                 fused_gnn.fused_step_backward_reference(params, h, adj,
                                                         g)[1:])
    assert fused_gnn.persistent_bwd_smem_ok(adj, hidden)
    k = 5
    hist = fused_gnn.persistent_hist(params, h, adj, k)
    torch.testing.assert_close(hist, fused_gnn.persistent_hist_reference(
        params, h, adj, k), **UNROLL_TOL)
    for step in range(1, k):  # the forward's own values, bit for bit
        assert torch.equal(hist[step - 1], fused_gnn.persistent_unroll(
            params, h, adj, step))
    got = fused_gnn.persistent_bwd_rows(params, h, hist, adj, g, k)
    want = fused_gnn.persistent_bwd_rows_reference(params, h, hist, adj, g, k)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **UNROLL_TOL)
    # Bit for bit the scan of the step backward, weight gradients folded
    # from step K-1 down to 0.
    gs, total = g, None
    for s in reversed(range(k)):
        gs, *dw = fused_gnn.fused_step_backward(
            params, (h if s == 0 else hist[s - 1]).contiguous(), adj, gs)
        total = dw if total is None else [a + b for a, b in zip(total, dw)]
    vjp = fused_gnn.persistent_backward(params, h, adj, g, k)
    assert torch.equal(vjp[0], gs)
    assert all(torch.equal(a, b) for a, b in zip(vjp[1:], total))
    _grads_close(vjp[1:], fused_gnn.persistent_backward_reference(
        params, h, adj, g, k)[1:])


def _flowgnn_grads(model, batch):
    from deepdfa_tpu_torch.train.loop import _labels_for, bce_with_logits

    model.zero_grad(set_to_none=True)
    labels, mask = _labels_for(model, batch)
    bce_with_logits(model(batch), labels, mask).backward()
    return {k: p.grad for k, p in model.named_parameters()}


def _grad_parity(cfg, batch, cuda):
    model = FlowGNN(cfg, device=cuda, seed=0)
    cpu = FlowGNN(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    fused_gnn.reset_launch_counts()
    got = _flowgnn_grads(model, batch.to(cuda))
    torch.cuda.synchronize()
    counts = fused_gnn.launch_counts()
    want = _flowgnn_grads(cpu, batch)
    assert got.keys() == want.keys()
    for name, g in got.items():
        assert g is not None, name  # every weight gets a gradient
        w = want[name]
        # f32 order (kernels, atomics in the embedding and segment
        # scatters on the card) over five steps: 1e-4 of the tensor's
        # largest entry, plus 1e-6 for gradients that are zero in exact
        # arithmetic and rounding noise in f32 (the pooling gate's bias:
        # a softmax over a graph's nodes does not see a shift).
        err = (g.cpu() - w).abs().max().item()
        assert err <= 1e-4 * w.abs().max().item() + 1e-6, (name, err)
    return model, counts


@pytest.mark.parametrize("impl", ["fused", "persistent"])
def test_flowgnn_backward_matches_cpu(cuda, impl):
    feature = FeatureSpec(limit_all=20, limit_subkeys=20)
    cfg = FlowGNNConfig(feature=feature, message_impl=impl)
    graphs = synthetic_bigvul(24, feature, positive_fraction=0.5, seed=3)
    budget = pad_budget_for(graphs, 24)
    batch = batch_graphs(graphs, 24, align_to_tile(budget["max_nodes"]),
                         budget["max_edges"], SUBKEYS, build_band_adj=True)
    model, counts = _grad_parity(cfg, batch, cuda)
    k = cfg.n_steps
    if impl == "fused":
        want = {"fused_step_kernel": k, "fused_step_bwd_kernel": k,
                "step_weight_grad_kernel": k}
    else:
        want = {"persistent_fwd_kernel": 1, "persistent_fwd_hist_kernel": 1,
                "persistent_bwd_kernel": 1, "step_weight_grad_kernel": 1}
    assert counts == {**dict.fromkeys(ALL_KERNELS, 0), **want}
    assert model.over_gate_dispatches == 0


@pytest.mark.parametrize("nodes,max_nodes", [(150, 256), (600, 640)])
def test_over_backward_gate_trains_through_the_fused_step(cuda, nodes,
                                                         max_nodes):
    # 150 rows pass the forward gate and fail the backward's; 600 fail
    # both. A training pass runs the fused step forward and backward K
    # times, counted; serving the 150-row batch keeps the persistent
    # kernel.
    feature = FeatureSpec(limit_all=20, limit_subkeys=20)
    graph = synthetic_bigvul(1, feature, seed=0, min_nodes=nodes,
                             max_nodes=nodes)
    cfg = FlowGNNConfig(feature=feature, message_impl="persistent")
    batch = batch_graphs(graph, 1, max_nodes, 4 * max_nodes, SUBKEYS,
                         build_band_adj=True)
    assert not fused_gnn.persistent_bwd_smem_ok(batch.band_adj, 128)
    model, counts = _grad_parity(cfg, batch, cuda)
    k = cfg.n_steps
    assert model.over_gate_dispatches == 1
    assert counts == {**dict.fromkeys(ALL_KERNELS, 0),
                      "fused_step_kernel": k, "fused_step_bwd_kernel": k,
                      "step_weight_grad_kernel": k}
    fused_gnn.reset_launch_counts()
    with torch.inference_mode():
        model(batch.to(cuda))
    serve_persistent = fused_gnn.persistent_smem_ok(batch.band_adj, 128)
    assert serve_persistent == (nodes == 150)
    assert fused_gnn.launch_counts()["persistent_fwd_kernel"] == int(
        serve_persistent)
    with pytest.raises(ValueError, match="shared memory"):
        params = model.ggnn_step.step_params()
        fused_gnn.persistent_unroll(
            params, torch.zeros(max_nodes, 128, device=cuda,
                                requires_grad=True),
            batch.band_adj.to(cuda), k)


def test_backward_refusals(cuda):
    adj = _graph_adj([40] * 4, 256, 128).to(cuda)
    params = _params(128, cuda)
    h = torch.randn(256, 128, device=cuda)
    with pytest.raises(ValueError, match="cotangent"):
        fused_gnn.fused_step_bwd_rows(params, h, adj, h[:128])
    with pytest.raises(ValueError, match="hist"):
        fused_gnn.persistent_bwd_rows(params, h, h[None], adj, h, 3)
    with pytest.raises(ValueError, match="x must be"):
        fused_gnn.step_weight_grads(h, None, h[None, :128], h[None],
                                    h[None], 1)
