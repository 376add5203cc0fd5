"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a CUDA device (decided in the
fixture, never at import). On a machine with the card::

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_cuda.py -q -m cuda

This file imports nothing of JAX, so it also runs where JAX is absent.
It covers what ``chip_smoke.py`` does not: f32 band values (a multiplicity
that is not bf16-exact), wider bands, odd shapes, the over-gate dispatch
and the refusals, for the forward kernels and the backward ones; that
the persistent pair equals the scan of the per-step kernels bit for bit
(the serving bucket's 2-block clusters, a one-group batch's 2-block
cluster, groups over a tile, H 32) and repeats its bits, with the
occupancy of the instance each launch runs; and that
``loss.backward()`` through FlowGNN on the card gives the CPU model's
parameter gradients in every kernel lane. The tile product is
held to its plain version over A and A^T at H 32, 128 and 30 (not a
multiple of 4), with rows no edge reaches, an edgeless batch, a
multiplicity of 300 and entries past ``ptr[N]`` that must change
nothing. The flash forward, the fused flash backward and the two-pass
pair are held to their plain versions and to each
other, with whole key tiles of padding (also inside a row), and to their
own bits across two launches; the GNN weight pass likewise, with row
counts that are no multiple of its slab or split, 1 and 5 steps, and the
fold of one-step calls bit for bit; and a FlowGNN backward on the card
repeats its bits (the matmul pooling). A trainer state saved from the
card restores on the CPU, and a train step with the graph encoder frozen
launches its forward kernel only. A train step of each dataflow label
style gives the CPU's loss and gradients, and HF weights written to disk
load onto the card bit for bit. A DeepDFA+CodeT5 train step gives the
CPU's loss and gradients in the persistent and the fused graph lanes.
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
from deepdfa_tpu_torch.ops import tile_spmm as T
from deepdfa_tpu_torch.ops.band_spmm import build_band_adjacency
from deepdfa_tpu_torch.ops.tile_spmm import align_to_tile
from deepdfa_tpu_torch.serve import ServeConfig
from deepdfa_tpu_torch.serve.engine import bucket_batch

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


def _persistent_case(case):
    """(band adjacency, hidden) of one persistent-kernel case."""
    if case == "serving":
        # The serving bucket: 16 synthetic graphs in 1024 rows, 34 groups.
        graphs = synthetic_bigvul(16, FlowGNNConfig().feature, seed=0)
        return bucket_batch(ServeConfig(), graphs, 16, SUBKEYS,
                            band=True).band_adj, 128
    sizes, n, tile, hidden, bandwidth = {
        # Groups over a tile, several passes each; 300 rows at H 64 pass
        # the forward's gate, not the backward's.
        "over_a_tile": ([300, 200, 48], 640, 128, 64, 2),
        "over_a_tile_bwd": ([200, 150, 48], 512, 128, 64, 2),
        "h32": ([30, 20, 9], 64, 16, 32, 4),
        # One graph over every row: one group, so a 2-block cluster.
        "one_group": ([112], 112, 16, 128, None),
        # The training batch's size: 16384 rows of 8-60-row graphs, the
        # per-step forward's wide 64-row tiles (which cut graphs).
        "training": (list(np.random.default_rng(7).integers(8, 61, 420)),
                     16384, 128, 128, None),
    }[case]
    return _graph_adj(sizes, n, tile, bandwidth=bandwidth), hidden


@pytest.mark.parametrize("case", ["serving", "over_a_tile",
                                  "over_a_tile_bwd", "h32", "one_group",
                                  "training"])
def test_persistent_kernels_equal_the_per_step_scan(cuda, case):
    # The persistent pair's claim: persistent_fwd_kernel is K launches of
    # fused_step_kernel, its hist instance the states between them, and
    # persistent_bwd_kernel the reverse scan of fused_step_bwd_kernel, bit
    # for bit; each kernel repeats its own bits launch to launch.
    adj, hidden = _persistent_case(case)
    adj = adj.to(cuda)
    groups = adj.row_groups.numel() - 1
    assert {"serving": groups == 34, "one_group": groups == 1}.get(case, True)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    # 2-block clusters where the groups are fewer than the SMs and the
    # cluster's three row arrays fit (300 rows at H 64 do not; H 32 has
    # no two slices of 32 columns).
    assert fused_gnn.persistent_cluster_size(adj, hidden, sms) == (
        1 if case in ("over_a_tile", "h32", "training") else 2)
    bwd = fused_gnn.persistent_bwd_smem_ok(adj, hidden)
    assert fused_gnn.persistent_smem_ok(adj, hidden)
    assert bwd == (case != "over_a_tile")
    n, k = adj.n_tiles * adj.tile, 5
    params = _params(hidden, cuda, seed=2)
    gen = torch.Generator().manual_seed(3)
    h = torch.randn(n, hidden, generator=gen).to(cuda)
    g = torch.randn(n, hidden, generator=gen).to(cuda)
    states = [h]
    for _ in range(k):
        states.append(fused_gnn.fused_gate_step(params, states[-1], adj))
    fused_gnn.reset_launch_counts()
    out = fused_gnn.persistent_unroll(params, h, adj, k)
    assert torch.equal(out, states[k])
    assert torch.equal(fused_gnn.persistent_unroll(params, h, adj, k), out)
    torch.testing.assert_close(out, fused_gnn.persistent_reference(
        params, h, adj, k), **UNROLL_TOL)
    hist = fused_gnn.persistent_hist(params, h, adj, k)
    assert torch.equal(hist, torch.stack(states[1:k]))
    assert torch.equal(fused_gnn.persistent_hist(params, h, adj, k), hist)
    if not bwd:
        return
    rows = fused_gnn.persistent_bwd_rows(params, h, hist, adj, g, k)
    gs, scan = g, [None] * k
    for s in reversed(range(k)):
        gs, *scan[s] = fused_gnn.fused_step_bwd_rows(params, states[s], adj,
                                                     gs)
    want = [gs] + [torch.stack([c[j] for c in scan]) for j in range(3)]
    assert all(torch.equal(a, b) for a, b in zip(rows, want))
    again = fused_gnn.persistent_bwd_rows(params, h, hist, adj, g, k)
    assert all(torch.equal(a, b) for a, b in zip(again, rows))
    torch.cuda.synchronize()
    assert fused_gnn.launch_counts() == {
        **dict.fromkeys(ALL_KERNELS, 0), "persistent_fwd_kernel": 2,
        "persistent_fwd_hist_kernel": 2, "persistent_bwd_kernel": 2,
        "fused_step_bwd_kernel": k}


@pytest.mark.parametrize("case,cluster,blocks", [
    ("serving", 1, 2), ("serving", 2, 2), ("one_group", 2, 1)])
def test_persistent_occupancy_of_the_launched_instance(cuda, case, cluster,
                                                       blocks):
    # 87,744 bytes (one block a group) or 113,088 (a cluster's third row
    # array) at 48-row groups: two blocks an SM; 214,720 at 112 rows: one.
    adj, hidden = _persistent_case(case)
    occ = fused_gnn.persistent_occupancy(adj.to(cuda), hidden,
                                         "persistent_fwd_kernel", cluster)
    assert occ["blocks_per_sm"] == blocks
    if cluster == 1:
        assert occ["active_clusters"] is None
    else:  # every group's cluster resident at once
        assert occ["active_clusters"] >= adj.row_groups.numel() - 1
    assert fused_gnn.persistent_occupancy(
        adj.to(cuda), hidden, "persistent_bwd_kernel") == dict(
            blocks_per_sm=2 if case == "serving" else 1,
            active_clusters=None)


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


def test_flowgnn_backward_repeats_its_bits(cuda):
    # Every sum of the persistent lane's backward owns one order: the
    # kernels', the matmul pooling's ("auto" on CUDA; the segment form's
    # index_add_ adds with atomics, and a training run on the card took
    # another loss trajectory from time to time).
    feature = FeatureSpec(limit_all=20, limit_subkeys=20)
    cfg = FlowGNNConfig(feature=feature, message_impl="persistent")
    graphs = synthetic_bigvul(64, feature, positive_fraction=0.5, seed=5)
    budget = pad_budget_for(graphs, 64)
    batch = batch_graphs(graphs, 64, align_to_tile(budget["max_nodes"]),
                         budget["max_edges"], SUBKEYS,
                         build_band_adj=True).to(cuda)
    model = FlowGNN(cfg, device=cuda, seed=5)
    assert model.pooling.impl == "auto"
    first = {k: g.clone() for k, g in _flowgnn_grads(model, batch).items()}
    for _ in range(3):
        again = _flowgnn_grads(model, batch)
        assert all(torch.equal(again[k], g) for k, g in first.items())


@pytest.mark.parametrize("nodes,max_nodes", [(150, 256), (600, 640),
                                             (5000, 5120)])
def test_over_backward_gate_trains_through_the_fused_step(cuda, nodes,
                                                         max_nodes):
    # 150 rows pass the forward gate and fail the backward's; 600 and
    # 5000 fail both. A training pass runs the fused step forward and
    # backward K times, counted (at 5120 rows the forward's wide 64-row
    # tiles, the backward's 32-row ones; at 256 and 640 rows the
    # forward's 2-block clusters); serving the 150-row batch keeps the
    # persistent kernel.
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


def _step_case(sizes, n, tile, hidden, f32_vals, bandwidth, cuda):
    if sizes:
        adj = _graph_adj(sizes, n, tile, bandwidth=bandwidth)
    else:  # a batch of only padding rows: no edge at all
        adj = build_band_adjacency([], [], np.zeros(0, bool), n, tile=tile,
                                   bandwidth=bandwidth)
    adj = adj.to(cuda)
    if f32_vals:
        adj = dataclasses.replace(adj, vals=adj.vals.float())
    return adj


@pytest.mark.parametrize("sizes,n,tile,hidden,f32_vals,bandwidth,plan", [
    # 1000 rows: 2-block clusters over 16-row tiles, the last one short.
    ([40] * 24, 1000, 8, 128, False, None, (16, 2, False)),
    ([40] * 24, 1000, 8, 128, True, None, (16, 2, False)),
    ([40] * 24, 1000, 8, 36, False, None, (16, 2, False)),
    # 4400 rows: the wide 64-row tiles (H 128: slabs of 16; H 72: of
    # 4), the 4 x 4 ones at H 64 and 36, the last tile short.
    ([40] * 108, 4400, 16, 128, False, None, (64, 1, True)),
    ([40] * 108, 4400, 16, 128, True, None, (64, 1, True)),
    ([40] * 108, 4400, 16, 72, False, None, (64, 1, True)),
    ([40] * 108, 4400, 16, 64, False, None, (64, 1, False)),
    ([40] * 108, 4400, 16, 36, True, None, (64, 1, False)),
    # Bandwidth 1 and 2 at tile 128 (full tiles).
    ([60] * 74, 4480, 128, 128, False, 1, (64, 1, True)),
    ([60] * 74, 4480, 128, 128, False, 2, (64, 1, True)),
    ([60] * 15, 1024, 128, 128, True, 2, (16, 2, False)),
    # Only padding rows.
    ([], 4480, 128, 128, False, None, (64, 1, True)),
    ([], 1024, 128, 64, False, None, (16, 2, False)),
    # Band windows over a warp's staging share (f32 at B 16 and B 32)
    # and 4-row tiles (8 bytes a bf16 tile row): the band read where it
    # lies in device memory, one value a lane.
    ([60] * 15, 1024, 128, 128, True, 16, (16, 2, False)),
    ([60] * 74, 4480, 128, 128, True, 32, (64, 1, True)),
    ([40] * 24, 1000, 4, 128, False, None, (16, 2, False)),
])
def test_per_step_pair_on_ragged_tiles_widths_and_bands(
        cuda, sizes, n, tile, hidden, f32_vals, bandwidth, plan):
    # fused_step_kernel and fused_step_bwd_kernel against their plain
    # versions, each twice on the same inputs for the same bits, one
    # launch counted a call, the geometry the libraries report being the
    # host's plan.
    adj = _step_case(sizes, n, tile, hidden, f32_vals, bandwidth, cuda)
    assert adj.n_tiles * adj.tile == n
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    want = fused_gnn.step_plan(n, hidden, sms)
    assert (want["row_tile"], want["cluster"], want["wide"]) == plan
    for kernel in ("fused_step_kernel", "fused_step_bwd_kernel"):
        geo = fused_gnn.step_geometry(adj, hidden, kernel)
        plan_k = fused_gnn.step_plan(n, hidden, sms, kernel)
        assert geo["sms"] == sms
        assert {k: geo[k] for k in ("row_tile", "cluster", "slab_rows",
                                    "blocks")} == {
            k: plan_k[k] for k in ("row_tile", "cluster", "slab_rows",
                                   "blocks")}
        assert geo["smem_bytes"] == fused_gnn.step_smem_bytes(
            n, hidden, sms, kernel, 0)
        assert geo["blocks_per_sm"] == (1 if plan_k["wide"] else 2)
        if kernel == "fused_step_bwd_kernel":
            assert geo["smem_bytes_pass1"] == fused_gnn.step_smem_bytes(
                n, hidden, sms, kernel, 1)
            assert geo["blocks_per_sm_pass1"] >= 2
    params = _params(hidden, cuda, seed=4)
    gen = torch.Generator().manual_seed(5)
    h = torch.randn(n, hidden, generator=gen).to(cuda)
    g = torch.randn(n, hidden, generator=gen).to(cuda)
    fused_gnn.reset_launch_counts()
    out = fused_gnn.fused_gate_step(params, h, adj)
    assert torch.equal(fused_gnn.fused_gate_step(params, h, adj), out)
    rows = fused_gnn.fused_step_bwd_rows(params, h, adj, g)
    again = fused_gnn.fused_step_bwd_rows(params, h, adj, g)
    torch.cuda.synchronize()
    assert fused_gnn.launch_counts() == {
        **dict.fromkeys(ALL_KERNELS, 0), "fused_step_kernel": 2,
        "fused_step_bwd_kernel": 2}
    assert all(torch.equal(a, b) for a, b in zip(again, rows))
    torch.testing.assert_close(out, fused_gnn.fused_step_reference(
        params, h, adj), **STEP_TOL)
    for a, b in zip(rows, fused_gnn.fused_step_bwd_rows_reference(
            params, h, adj, g)):
        torch.testing.assert_close(a, b, **STEP_TOL)


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


# ---------------------------------------------------------------------------
# The tile SpMM kernel
# ---------------------------------------------------------------------------


def _tile_lists(sizes, n, seed=0):
    """Contiguous graphs as ``_graph_adj`` builds them, as the tile path's
    nonzero lists. Rows past the graphs are reached by no edge."""
    rng = np.random.default_rng(seed)
    s, r, off = [], [], 0
    for size in sizes:
        s += list(range(off, off + size - 1)) + list(range(off, off + size))
        r += list(range(off + 1, off + size)) + list(range(off, off + size))
        s += list(rng.integers(off, off + size, 3))
        r += list(rng.integers(off, off + size, 3))
        off += size
    return T.build_csr_adjacency(s, r, np.ones(len(s), bool), n), off


def _poisoned(adj):
    """The same lists with 64 more entries past ptr[N] in each direction,
    each a NaN multiplicity on sender 0: any read of them shows in the
    output."""
    def grow(src, val):
        return (torch.cat([src, torch.zeros(64, dtype=src.dtype,
                                            device=src.device)]),
                torch.cat([val, torch.full((64,), float("nan"),
                                           device=val.device)]))

    (src, val), (t_src, t_val) = grow(adj.src, adj.val), grow(adj.t_src,
                                                              adj.t_val)
    return dataclasses.replace(adj, src=src, val=val, t_src=t_src,
                               t_val=t_val)


@pytest.mark.parametrize("n,sizes", [
    (256, [40, 30, 25, 9]),        # rows 104.. reached by no edge
    (1024, [200, 150, 90, 60]),    # rows 500..
])
@pytest.mark.parametrize("hidden", [32, 128, 30])  # 30: the one-float path
def test_tile_spmm_kernel_matches_plain_version(cuda, n, sizes, hidden):
    adj, used = _tile_lists(sizes, n)
    adj = adj.to(cuda)
    msg = torch.randn(n, hidden, device=cuda)
    T.reset_launch_counts()
    got = T.tile_spmm(adj, msg)
    torch.cuda.synchronize()
    assert T.launch_counts() == {"tile_spmm_kernel": 1}
    torch.testing.assert_close(got, T.tile_spmm_reference(adj, msg),
                               **STEP_TOL)
    assert not got[used:].any()  # rows no edge reaches
    # A^T, the backward's launch, against its plain version.
    at = adj.transposed()
    torch.testing.assert_close(T.tile_spmm(at, msg),
                               T.tile_spmm_reference(at, msg), **STEP_TOL)
    # The kernel reads nothing past ptr[N]: entries there change nothing,
    # bit for bit (the plain version multiplies every entry).
    bad = _poisoned(adj)
    assert torch.equal(T.tile_spmm(bad, msg), got)
    assert torch.equal(T.tile_spmm(bad.transposed(), msg),
                       T.tile_spmm(at, msg))
    # The autograd backward (the same kernel over A^T) against the CPU's.
    g = torch.randn_like(msg)
    m = msg.clone().requires_grad_()
    T.tile_spmm(adj, m).backward(g)
    mc = msg.cpu().requires_grad_()
    T.tile_spmm(adj.to("cpu"), mc).backward(g.cpu())
    torch.testing.assert_close(m.grad.cpu(), mc.grad, **STEP_TOL)
    assert T.launch_counts() == {"tile_spmm_kernel": 7}


def test_tile_spmm_kernel_fillers_only_and_heavy_multiplicity(cuda):
    # An edgeless batch: no nonzero, every row written as zeros.
    empty = T.build_csr_adjacency([0], [0], np.zeros(1, bool), 64).to(cuda)
    assert empty.nnz == 0 and not empty.ptr.any()
    msg = torch.randn(64, 40, device=cuda)
    assert torch.equal(T.tile_spmm(empty, msg), torch.zeros_like(msg))
    assert torch.equal(T.tile_spmm(empty.transposed(), msg),
                       torch.zeros_like(msg))
    # A multiplicity of 300: one nonzero holding 300, exact in f32.
    heavy = T.build_csr_adjacency(np.zeros(300, np.int64),
                                  np.ones(300, np.int64),
                                  np.ones(300, bool), 16).to(cuda)
    assert heavy.nnz == 1 and heavy.val.tolist() == [300.0]
    out = T.tile_spmm(heavy, torch.ones(16, 4, device=cuda))
    assert out[1].tolist() == [300.0] * 4 and not out[2:].any()
    assert not out[0].any()
    back = T.tile_spmm(heavy.transposed(), torch.ones(16, 4, device=cuda))
    assert back[0].tolist() == [300.0] * 4 and not back[1:].any()


def test_tile_spmm_refusals(cuda):
    adj, _ = _tile_lists([40, 30], 128)
    on_card = adj.to(cuda)
    msg = torch.randn(128, 32, device=cuda)
    with pytest.raises(NotImplementedError, match="bf16"):
        T.tile_spmm(on_card, msg.bfloat16())
    with pytest.raises(ValueError, match="does not match"):
        T.tile_spmm(on_card, msg[:64])
    with pytest.raises(ValueError, match="ptr must be"):
        T.tile_spmm(adj, msg)  # the lists on the CPU
    with pytest.raises(ValueError, match="contiguous msg"):
        T.tile_spmm(on_card, torch.randn(32, 128, device=cuda).T)
    with pytest.raises(ValueError, match="src must be"):
        T.tile_spmm(dataclasses.replace(on_card, src=on_card.src.long()),
                    msg)
    with pytest.raises(ValueError, match="val must be"):
        T.tile_spmm(dataclasses.replace(on_card, val=on_card.val[:-1]), msg)


def test_tile_flowgnn_backward_matches_cpu(cuda):
    feature = FeatureSpec(limit_all=20, limit_subkeys=20)
    cfg = FlowGNNConfig(feature=feature, message_impl="tile")
    graphs = synthetic_bigvul(24, feature, positive_fraction=0.5, seed=3)
    budget = pad_budget_for(graphs, 24)
    batch = batch_graphs(graphs, 24, align_to_tile(budget["max_nodes"]),
                         budget["max_edges"], SUBKEYS, build_tile_adj=True)
    T.reset_launch_counts()
    _, counts = _grad_parity(cfg, batch, cuda)
    assert counts == dict.fromkeys(ALL_KERNELS, 0)
    # Each gated step: one launch forward, one over A^T backward.
    assert T.launch_counts() == {"tile_spmm_kernel": 2 * cfg.n_steps}


# ---------------------------------------------------------------------------
# The flash-attention kernels
# ---------------------------------------------------------------------------

# Forward against the plain version: f32 in another summation order
# (64-key tiles against 512-key blocks). Gradients sum over every key
# (dq) or query (dk, dv) of a (batch, head): 1e-4 relative, 1e-5 absolute.
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
ATTN_GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
# Every instance the launch counts name: the f32 kernels and their bf16
# instances (``*_bf16``).
FLASH_KERNELS = tuple(name + suffix for suffix in ("", "_bf16") for name in (
    "flash_fwd_kernel", "flash_bwd_fused_kernel", "flash_bwd_dq_kernel",
    "flash_bwd_dkv_kernel"))


def _attn_inputs(b, t, h, d, dev, seed=0, all_pad_row=True):
    """q, k, v at the init scale the encoder gives them, a mask with
    padded tails (and one all-pad row), a cotangent."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((b, t, h, d)).astype(
        np.float32)).to(dev) for _ in range(4))
    lengths = rng.integers(t // 2, t + 1, size=b)
    if all_pad_row:
        lengths[-1] = 0
    mask = torch.from_numpy(np.arange(t)[None, :] < lengths[:, None]).to(dev)
    return q, k, v, mask, g


@pytest.mark.parametrize("b,t,h,d,causal", [
    (2, 64, 2, 64, False), (3, 100, 2, 64, False), (3, 100, 2, 64, True),
    (2, 200, 3, 64, False), (2, 130, 2, 64, True), (2, 512, 2, 64, False)])
def test_flash_kernels_match_plain_versions(cuda, b, t, h, d, causal):
    from deepdfa_tpu_torch.ops import attention as A

    q, k, v, mask, g = _attn_inputs(b, t, h, d, cuda)
    o, lse = A.flash_fwd(q, k, v, mask, causal)
    o_ref, lse_ref = A.flash_fwd_reference(q, k, v, mask, causal)
    torch.testing.assert_close(o, o_ref, **FWD_TOL)
    torch.testing.assert_close(lse, lse_ref, **FWD_TOL)
    assert torch.all(o[-1] == 0)  # the all-pad row: O = 0, not NaN
    delta = A.flash_delta(o_ref, g)
    args = (q, k, v, mask, g, lse_ref, delta, causal)
    want = A.flash_bwd_fused_reference(*args)
    dq = A.flash_bwd_dq(*args)
    dk, dv = A.flash_bwd_dkv(*args)
    for got, ref in zip((dq, dk, dv), want):
        torch.testing.assert_close(got, ref, **ATTN_GRAD_TOL)
    if A.flash_fused_bwd_ok(t, d):
        fused = A.flash_bwd_fused(*args)
        for got, ref in zip(fused, want):
            torch.testing.assert_close(got, ref, **ATTN_GRAD_TOL)
        # Fused against two-pass, kernel against kernel.
        for a, c in zip(fused, (dq, dk, dv)):
            torch.testing.assert_close(a, c, **ATTN_GRAD_TOL)
    assert all(torch.all(x[-1] == 0) for x in (dq, dk, dv))


def test_flash_gate_picks_fused_at_512_and_two_pass_at_4096(cuda):
    from deepdfa_tpu_torch.ops import attention as A

    assert A.flash_fused_bwd_ok(512, 64)
    assert not A.flash_fused_bwd_ok(4096, 64)
    for t, want in ((512, {"flash_fwd_kernel": 1,
                           "flash_bwd_fused_kernel": 1}),
                    (4096, {"flash_fwd_kernel": 1, "flash_bwd_dq_kernel": 1,
                            "flash_bwd_dkv_kernel": 1})):
        q, k, v, mask, g = _attn_inputs(1, t, 1, 64, cuda, all_pad_row=False)
        q.requires_grad_()
        A.reset_launch_counts()
        out = A.flash_attention(q, k, v, mask)
        (out * g).sum().backward()
        torch.cuda.synchronize()
        assert A.launch_counts() == {**dict.fromkeys(FLASH_KERNELS, 0),
                                     **want}
        assert A.flash_backward.two_pass_dispatches == int(t == 4096)
        # The plain versions launch nothing.
        A.reset_launch_counts()
        A.flash_fwd_reference(q.detach(), k, v, mask)
        assert sum(A.launch_counts().values()) == 0


@pytest.mark.parametrize("t,lengths,causal", [
    (512, [70, 0, 300], False),   # key tiles 2-7, all, 5-7 of a row dead
    (200, [10, 130, 0], True),    # ragged T, causal
])
def test_fused_backward_skips_dead_key_tiles_and_repeats_its_bits(
        cuda, t, lengths, causal):
    from deepdfa_tpu_torch.ops import attention as A

    b, h, d = len(lengths), 2, 64
    q, k, v, _, g = _attn_inputs(b, t, h, d, cuda)
    mask = torch.arange(t, device=cuda)[None, :] < torch.tensor(
        lengths, device=cuda)[:, None]
    o, lse = A.flash_fwd_reference(q, k, v, mask, causal)
    args = (q, k, v, mask, g, lse, A.flash_delta(o, g), causal)
    A.reset_launch_counts()
    fused = A.flash_bwd_fused(*args)
    again = A.flash_bwd_fused(*args)
    torch.cuda.synchronize()
    assert A.launch_counts()["flash_bwd_fused_kernel"] == 2
    for a, c in zip(fused, again):  # no atomics: the same bits
        assert torch.equal(a, c)
    want = A.flash_bwd_fused_reference(*args)
    pair = (A.flash_bwd_dq(*args), *A.flash_bwd_dkv(*args))
    for a, w, p in zip(fused, want, pair):
        torch.testing.assert_close(a, w, **ATTN_GRAD_TOL)
        torch.testing.assert_close(a, p, **ATTN_GRAD_TOL)
    # A key tile with no real key: its dk and dv are exactly 0; a row
    # with no real key at all has zero gradients everywhere.
    for row, n in enumerate(lengths):
        first_dead = -(-n // 64) * 64
        for x in fused[1:]:
            assert not x[row, first_dead:].any()
        if n == 0:
            assert not any(x[row].any() for x in fused)
    cost = A.kernel_cost(mask, t, h, d, "flash_bwd_fused_kernel", causal)
    nk = -(-t // 64)
    assert cost["dead_key_tiles"] == h * sum(nk - -(-n // 64)
                                             for n in lengths)


@pytest.mark.parametrize("t,lengths,causal,hole", [
    (512, [70, 0, 300], False, None),  # key tiles 2-7, all, 5-7 of a row dead
    (200, [10, 130, 0], True, None),   # ragged T, causal
    # T 4096, as the long-context path runs it; padding inside a row (keys
    # 64-1599 of row 0), not only at its tail.
    (4096, [4096, 2100], False, (64, 1600)),
    (4096, [3000, 0], True, (128, 256)),
])
def test_two_pass_pair_skips_dead_key_tiles_and_repeats_its_bits(
        cuda, t, lengths, causal, hole):
    from deepdfa_tpu_torch.ops import attention as A

    b, h, d = len(lengths), 2, 64
    q, k, v, _, g = _attn_inputs(b, t, h, d, cuda)
    keep = np.arange(t)[None, :] < np.asarray(lengths)[:, None]
    if hole is not None:
        keep[0, hole[0]:hole[1]] = False
    mask = torch.from_numpy(keep).to(cuda)
    o, lse = A.flash_fwd_reference(q, k, v, mask, causal)
    args = (q, k, v, mask, g, lse, A.flash_delta(o, g), causal)
    A.reset_launch_counts()
    pair = (A.flash_bwd_dq(*args), *A.flash_bwd_dkv(*args))
    again = (A.flash_bwd_dq(*args), *A.flash_bwd_dkv(*args))
    torch.cuda.synchronize()
    assert A.launch_counts()["flash_bwd_dq_kernel"] == 2
    assert A.launch_counts()["flash_bwd_dkv_kernel"] == 2
    for a, c in zip(pair, again):  # no atomics: the same bits
        assert torch.equal(a, c)
    want = (A.flash_bwd_dq_reference(*args), *A.flash_bwd_dkv_reference(*args))
    for a, w in zip(pair, want):
        torch.testing.assert_close(a, w, **ATTN_GRAD_TOL)
    if A.flash_fused_bwd_ok(t, d):
        for a, f in zip(pair, A.flash_bwd_fused(*args)):
            torch.testing.assert_close(a, f, **ATTN_GRAD_TOL)
    # A padded key has P = dS = 0: its dk and dv are exactly 0, so a key
    # tile with no real key is all zeros; a row with no real key at all
    # has zero gradients everywhere.
    pad = torch.from_numpy(~keep).to(cuda)
    for x in pair[1:]:
        assert not x[pad].any()
    for row, n in enumerate(lengths):
        if n == 0:
            assert not any(x[row].any() for x in pair)
    nk = -(-t // 64)
    tiles = np.zeros((b, nk * 64), bool)
    tiles[:, :t] = keep
    dead = h * int((~tiles.reshape(b, nk, 64).any(2)).sum())
    for name in ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel"):
        assert A.kernel_cost(mask, t, h, d, name, causal)[
            "dead_key_tiles"] == dead


@pytest.mark.parametrize("t,lengths,causal,hole", [
    # Key tiles 1-4 of row 0 hold no real key (padding inside the row, not
    # only at its tail); row 1 is all padding; row 2 has a padded tail.
    (512, [512, 0, 300], False, (64, 320)),
    (200, [10, 130, 0], True, None),      # ragged T, causal, all-pad row
    (300, [300, 257], True, (100, 200)),  # ragged T, causal, a hole
    # Causal with the first two key tiles dead: query rows 0-127 see no
    # real key at all and end at O = 0, lse = log(1e-30).
    (256, [256, 256], True, (0, 128)),
    (4096, [4096, 2100], False, (64, 1600)),
])
def test_forward_skips_dead_key_tiles_and_repeats_its_bits(
        cuda, t, lengths, causal, hole):
    from deepdfa_tpu_torch.ops import attention as A

    b, h, d = len(lengths), 2, 64
    q, k, v, _, _ = _attn_inputs(b, t, h, d, cuda)
    keep = np.arange(t)[None, :] < np.asarray(lengths)[:, None]
    if hole is not None:
        keep[0, hole[0]:hole[1]] = False
    mask = torch.from_numpy(keep).to(cuda)
    A.reset_launch_counts()
    o, lse = A.flash_fwd(q, k, v, mask, causal)
    again = A.flash_fwd(q, k, v, mask, causal)
    torch.cuda.synchronize()
    assert A.launch_counts()["flash_fwd_kernel"] == 2
    # No atomics, one owner an output: the same bits on a second launch.
    assert torch.equal(o, again[0]) and torch.equal(lse, again[1])
    o_ref, lse_ref = A.flash_fwd_reference(q, k, v, mask, causal)
    torch.testing.assert_close(o, o_ref, **FWD_TOL)
    torch.testing.assert_close(lse, lse_ref, **FWD_TOL)
    # A query row that sees no real key: O exactly 0, lse = log(1e-30).
    seen = np.cumsum(keep, 1) if causal else keep.sum(1, keepdims=True)
    blind = torch.from_numpy(np.broadcast_to(seen == 0, (b, t)).copy())
    assert not o[blind.to(cuda)].any()
    floor = torch.log(torch.tensor(1e-30)).item()
    assert torch.all(lse.transpose(1, 2)[blind.to(cuda)] == floor)
    nk = -(-t // 64)
    tiles = np.zeros((b, nk * 64), bool)
    tiles[:, :t] = keep
    assert A.kernel_cost(mask, t, h, d, "flash_fwd_kernel", causal)[
        "dead_key_tiles"] == h * int((~tiles.reshape(b, nk, 64).any(2)).sum())


@pytest.mark.parametrize("n,hidden", [
    (1000, 128),   # 64-row splits, the last of 40 rows (not a slab multiple)
    (16384, 128),  # the training batch: 19 splits of 864 rows
    (333, 64),     # a 13-row last split
    (100, 30),     # a width that is not a multiple of 4 (4-byte copies)
])
def test_weight_pass_ragged_rows_steps_and_the_fold(cuda, n, hidden):
    k = 5
    rng = np.random.default_rng(3)

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(cuda)

    h0, hist = rand(n, hidden), rand(k - 1, n, hidden)
    x, dp, dmsg = rand(k, n, hidden), rand(k, n, 4 * hidden), rand(k, n,
                                                                    hidden)
    assert n % fused_gnn.wgrad_rows_per_split(n, hidden)
    for steps in (1, k):
        args = (h0, hist[:steps - 1] if steps > 1 else None, x[:steps],
                dp[:steps], dmsg[:steps], steps)
        got = fused_gnn.step_weight_grads(*args)
        again = fused_gnn.step_weight_grads(*args)
        assert all(torch.equal(a, c) for a, c in zip(got, again))
        _grads_close(got, fused_gnn.step_weight_grad_reference(*args))
    # The K-step call is bit for bit the fold of K one-step calls, added
    # from step K-1 down to 0 (what autograd does over the fused lane).
    fold = None
    for s in reversed(range(k)):
        hs = (h0 if s == 0 else hist[s - 1]).contiguous()
        one = fused_gnn.step_weight_grads(hs, None, x[s:s + 1], dp[s:s + 1],
                                          dmsg[s:s + 1], 1)
        fold = one if fold is None else tuple(a + b for a, b in zip(fold,
                                                                    one))
    assert all(torch.equal(a, b) for a, b in zip(got, fold))


def test_flash_refusals(cuda):
    from deepdfa_tpu_torch.ops import attention as A

    q, k, v, mask, g = _attn_inputs(2, 64, 2, 64, cuda)
    # bf16 runs (its instance: test_flash_bf16_instances_*); another
    # dtype, or q, k and v of two dtypes, is refused.
    o, lse = A.flash_fwd(q.bfloat16(), k.bfloat16(), v.bfloat16(), mask)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
        A.flash_fwd(q.half(), k.half(), v.half(), mask)
    with pytest.raises(ValueError, match="want torch.bfloat16"):
        A.flash_fwd(q.bfloat16(), k, v, mask)
    with pytest.raises(ValueError, match="head width"):
        A.flash_fwd(q[..., :8].contiguous(), k[..., :8].contiguous(),
                    v[..., :8].contiguous(), mask)
    with pytest.raises(ValueError, match="contiguous"):
        A.flash_fwd(q.transpose(1, 2), k, v, mask)
    with pytest.raises(ValueError, match="kv_mask"):
        A.flash_fwd(q, k, v, mask.int())
    lse = torch.zeros(2, 2, 4096, device=cuda)
    big = torch.zeros(2, 4096, 2, 64, device=cuda)
    with pytest.raises(ValueError, match="two-pass"):
        A.flash_bwd_fused(big, big, big, None, big, lse, lse)


def test_linevul_gradients_match_cpu(cuda):
    """loss.backward() through DeepDFA+LineVul on the card (flash kernels,
    D 64, a length that is not a tile multiple, a padded row) gives the
    CPU model's parameter gradients for the same weights."""
    from deepdfa_tpu_torch.data.combined import (
        graph_join_and_budget,
        load_combined_dataset,
    )
    from deepdfa_tpu_torch.data.text import HashingCodeTokenizer
    from deepdfa_tpu_torch.models.linevul import LineVul, cross_entropy_loss
    from deepdfa_tpu_torch.models.transformer import EncoderConfig
    from deepdfa_tpu_torch.ops import attention as A
    from deepdfa_tpu_torch.train.text_loop import text_graph_batches

    enc = EncoderConfig(vocab_size=512, hidden_size=128, num_layers=2,
                        num_heads=2, intermediate_size=256,
                        max_position_embeddings=130, dropout_rate=0.0,
                        attention_impl="auto")
    feature = FeatureSpec(limit_all=20, limit_subkeys=20)
    gcfg = FlowGNNConfig(feature=feature, hidden_dim=8, n_steps=2,
                         encoder_mode=True)
    data, _, graphs = load_combined_dataset(
        "synthetic:7", feature, HashingCodeTokenizer(512), 100,
        graphs="synthetic")
    graphs, budget = graph_join_and_budget(list(graphs.values()), 8)
    batch = next(text_graph_batches(data, np.arange(7), 8, graphs, SUBKEYS,
                                    budget))
    gpu = LineVul(enc, gcfg, device=cuda, seed=0)
    cpu = LineVul(enc, gcfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})

    def grads(model, dev):
        ids, labels, mask = (torch.from_numpy(x).to(dev) for x in (
            batch.input_ids, batch.labels, batch.example_mask))
        model.zero_grad(set_to_none=True)
        logits = model(ids, batch.graphs.to(dev))
        cross_entropy_loss(logits, labels, mask).backward()
        return {k: p.grad for k, p in model.named_parameters()}

    A.reset_launch_counts()
    got = grads(gpu, cuda)
    torch.cuda.synchronize()
    assert A.launch_counts() == {**dict.fromkeys(FLASH_KERNELS, 0),
                                 "flash_fwd_kernel": 2,
                                 "flash_bwd_fused_kernel": 2}
    want = grads(cpu, "cpu")
    assert got.keys() == want.keys()
    for name, g in got.items():
        w = want[name]
        assert g is not None and torch.isfinite(g).all(), name
        # As FlowGNN's rule above: 1e-4 of the tensor's largest entry.
        err = (g.cpu() - w).abs().max().item()
        assert err <= 1e-4 * w.abs().max().item() + 1e-6, (name, err)


def test_snapshot_written_on_the_card_restores_on_the_cpu(cuda, tmp_path):
    """A trainer state saved from the card (model and AdamW state as CUDA
    tensors) restores on the CPU and on the card, the same bits."""
    from deepdfa_tpu_torch.train import checkpoint as C
    from deepdfa_tpu_torch.train.loop import TrainState

    model = FlowGNN(FlowGNNConfig(feature=FeatureSpec(limit_all=20,
                                                      limit_subkeys=20),
                                  hidden_dim=8), device=cuda, seed=0)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    m = C.CheckpointManager(str(tmp_path))
    m.save_last(TrainState(1, model.state_dict(), opt.state_dict()), 0)
    for dev in ("cpu", cuda):
        got = C.CheckpointManager(str(tmp_path)).restore("last",
                                                         map_location=dev)
        assert got["step"] == 1
        for k, v in model.state_dict().items():
            assert got["params"][k].device.type == torch.device(dev).type
            assert torch.equal(got["params"][k].cpu(), v.cpu()), k
        for i, p in enumerate(model.parameters()):
            for k in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(got["opt_state"]["state"][i][k].cpu(),
                                   opt.state[p][k].cpu())


def test_frozen_graph_encoder_launches_no_backward_kernel(cuda):
    """A train step of DeepDFA+LineVul with the persistent graph encoder
    frozen (``fit_text(freeze_submodules=("flowgnn",))``): the encoder
    runs ``persistent_fwd_kernel`` once and no GNN backward kernel, gets
    no gradient and does not move; the text side trains."""
    from deepdfa_tpu_torch.core.config import TransformerTrainConfig
    from deepdfa_tpu_torch.data.combined import (
        graph_join_and_budget,
        load_combined_dataset,
    )
    from deepdfa_tpu_torch.data.text import HashingCodeTokenizer
    from deepdfa_tpu_torch.models.linevul import LineVul
    from deepdfa_tpu_torch.models.transformer import EncoderConfig
    from deepdfa_tpu_torch.train import text_loop

    enc = EncoderConfig(vocab_size=512, hidden_size=128, num_layers=2,
                        num_heads=2, intermediate_size=256,
                        max_position_embeddings=130, attention_impl="auto")
    feature = FeatureSpec(limit_all=20, limit_subkeys=20)
    gcfg = FlowGNNConfig(feature=feature, hidden_dim=8, n_steps=2,
                         encoder_mode=True, message_impl="persistent")
    data, _, graphs = load_combined_dataset(
        "synthetic:7", feature, HashingCodeTokenizer(512), 100,
        graphs="synthetic")
    graphs, budget = graph_join_and_budget(list(graphs.values()), 8)
    batch = next(text_loop.text_graph_batches(
        data, np.arange(7), 8, graphs, SUBKEYS, budget, build_band_adj=True))
    model = LineVul(enc, gcfg, device=cuda, seed=0)
    model.flowgnn.requires_grad_(False)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    cfg = TransformerTrainConfig(batch_size=8, block_size=100)
    step = text_loop.make_text_train_step(
        model, text_loop.make_text_optimizer(model.parameters(), cfg), cfg,
        torch.Generator().manual_seed(0))
    fused_gnn.reset_launch_counts()
    step(batch, 1e-3)
    torch.cuda.synchronize()
    assert fused_gnn.launch_counts() == {**dict.fromkeys(ALL_KERNELS, 0),
                                         "persistent_fwd_kernel": 1}
    for k, p in model.named_parameters():
        if k.startswith("flowgnn."):
            assert p.grad is None and torch.equal(p, before[k]), k
    assert not torch.equal(model.state_dict()["classifier.dense.weight"],
                           before["classifier.dense.weight"])


@pytest.mark.parametrize("style", ["dataflow_solution_in",
                                   "dataflow_solution_out"])
def test_dataflow_label_step_matches_cpu(cuda, style):
    """One train step of each dataflow label style in the persistent
    lane: the card's loss and parameter gradients against the CPU's from
    the same weights and batch."""
    from deepdfa_tpu_torch.core.config import TrainConfig
    from deepdfa_tpu_torch.train import loop

    feature = FeatureSpec(limit_all=20, limit_subkeys=20)
    cfg = FlowGNNConfig(feature=feature, label_style=style,
                        message_impl="persistent")
    ex = synthetic_bigvul(32, feature, positive_fraction=0.5, seed=3)
    budget = pad_budget_for(ex, 32)
    batch = batch_graphs(ex, 32, align_to_tile(budget["max_nodes"]),
                         budget["max_edges"], SUBKEYS, build_band_adj=True,
                         with_dataflow=True)
    train = TrainConfig(learning_rate=1e-3)
    out = {}
    for dev in ("cpu", cuda):
        model = FlowGNN(cfg, device=dev, seed=0)
        step = loop.make_train_step(
            model, loop.make_optimizer(model.parameters(), train), train)
        fused_gnn.reset_launch_counts()
        loss, _ = step(batch.to(dev))
        grads = {k: p.grad.detach().cpu() for k, p in
                 model.named_parameters()}
        out[str(dev)] = (float(loss), grads, fused_gnn.launch_counts())
    (lc, gc, _), (lg, gg, launches) = out["cpu"], out[str(cuda)]
    assert abs(lg - lc) <= STEP_TOL["atol"], (lg, lc)
    for k, want in gc.items():
        floor = GRAD_TOL * max(float(want.abs().max()), 1e-6)
        assert float((gg[k] - want).abs().max()) <= floor, k
    assert launches["persistent_fwd_hist_kernel"] == 1
    assert launches["persistent_bwd_kernel"] == 1


def test_load_pretrained_onto_the_card(cuda, tmp_path):
    """An HF directory written with the port's own writer (the card's
    host has no transformers) loads onto the card bit for bit, and the
    encoder there gives the CPU's output."""
    import json

    from deepdfa_tpu_torch.models.convert import roberta_to_hf
    from deepdfa_tpu_torch.models.pretrained import (
        load_pretrained,
        write_safetensors,
    )
    from deepdfa_tpu_torch.models.transformer import (
        EncoderConfig,
        RobertaEncoder,
    )

    cfg = EncoderConfig(vocab_size=300, hidden_size=128, num_layers=2,
                        num_heads=2, intermediate_size=256,
                        max_position_embeddings=70, gelu_approximate=False,
                        attention_impl="auto")
    src = RobertaEncoder(cfg, torch.Generator().manual_seed(4))
    write_safetensors(str(tmp_path / "model.safetensors"),
                      roberta_to_hf(src.state_dict()))
    (tmp_path / "config.json").write_text(json.dumps({
        "model_type": "roberta", "vocab_size": 300, "hidden_size": 128,
        "num_hidden_layers": 2, "num_attention_heads": 2,
        "intermediate_size": 256, "max_position_embeddings": 70,
        "type_vocab_size": 1, "pad_token_id": 1, "layer_norm_eps": 1e-5,
        "hidden_act": "gelu", "hidden_dropout_prob": 0.0}))
    kind, got_cfg, params = load_pretrained(str(tmp_path), map_location=cuda,
                                            attention_impl="auto")
    assert kind == "roberta"
    for k, v in src.state_dict().items():
        assert params[k].device.type == "cuda"
        assert torch.equal(params[k].cpu(), v), k
    ids = torch.randint(3, 300, (2, 64), generator=torch.Generator(
    ).manual_seed(0))
    ids[1, 40:] = 1
    outs = []
    for dev in ("cpu", cuda):
        enc = RobertaEncoder(got_cfg, torch.Generator()).to(dev)
        enc.load_state_dict(params)
        with torch.no_grad():
            outs.append(enc(ids.to(dev))[0].cpu())
    keep = ids != 1
    torch.testing.assert_close(outs[1][keep], outs[0][keep], **STEP_TOL)


def test_text_train_step_repeats_its_bits(cuda):
    """Three train steps of the text encoder from the same weights, batch
    and dropout seeds give the same parameters bit for bit: no update of
    the step sums with atomics (the token-type row's gradient was one,
    scripts/torch_text_determinism.py)."""
    from deepdfa_tpu_torch.core.config import TransformerTrainConfig
    from deepdfa_tpu_torch.data.combined import load_combined_dataset
    from deepdfa_tpu_torch.data.text import HashingCodeTokenizer
    from deepdfa_tpu_torch.models.linevul import LineVul
    from deepdfa_tpu_torch.models.transformer import EncoderConfig
    from deepdfa_tpu_torch.train import text_loop

    enc = EncoderConfig(vocab_size=512, hidden_size=128, num_layers=2,
                        num_heads=2, intermediate_size=256,
                        max_position_embeddings=130, attention_impl="auto")
    data, _, _ = load_combined_dataset(
        "synthetic:16", FeatureSpec(limit_all=20), HashingCodeTokenizer(512),
        128)
    batch = next(text_loop.text_graph_batches(data, np.arange(16), 16))
    cfg = TransformerTrainConfig(batch_size=16, block_size=128)
    states = []
    for _ in range(3):
        model = LineVul(enc, device=cuda, seed=0)
        step = text_loop.make_text_train_step(
            model, text_loop.make_text_optimizer(model.parameters(), cfg),
            cfg, torch.Generator().manual_seed(0))
        for _ in range(2):
            step(batch, 1e-3)
        states.append({k: v.cpu() for k, v in model.state_dict().items()})
    for other in states[1:]:
        for k, v in states[0].items():
            assert torch.equal(other[k], v), k


@pytest.mark.parametrize("impl", ["persistent", "fused"])
def test_codet5_combined_train_step_matches_cpu(cuda, impl):
    """A train step of DeepDFA+CodeT5 (``DefectModel``: the T5 stack in
    plain torch over head width 64, the graph encoder's ``impl`` kernels
    forward and backward) on the card against the CPU model of the same
    weights: the loss within 1e-5, every parameter gradient within 1e-4
    of its largest entry (+ 1e-6), the lane's GNN kernels launched, and
    the update finite."""
    from deepdfa_tpu_torch.core.config import TransformerTrainConfig
    from deepdfa_tpu_torch.data.combined import (
        graph_join_and_budget,
        load_combined_dataset,
    )
    from deepdfa_tpu_torch.data.text import HashingT5Tokenizer
    from deepdfa_tpu_torch.models.linevul import cross_entropy_loss
    from deepdfa_tpu_torch.models.t5 import DefectModel, T5Config
    from deepdfa_tpu_torch.train import text_loop

    cfg = T5Config(vocab_size=512, d_model=128, d_kv=64, d_ff=256,
                   num_layers=2, num_decoder_layers=2, num_heads=2,
                   dropout_rate=0.0)
    feature = FeatureSpec(limit_all=20, limit_subkeys=20)
    gcfg = FlowGNNConfig(feature=feature, hidden_dim=8, n_steps=2,
                         encoder_mode=True, message_impl=impl)
    data, _, graphs = load_combined_dataset(
        "synthetic:7", feature, HashingT5Tokenizer(512), 100, style="t5",
        graphs="synthetic")
    graphs, budget = graph_join_and_budget(list(graphs.values()), 8)
    batch = next(text_loop.text_graph_batches(
        data, np.arange(7), 8, graphs, SUBKEYS, budget, pad_id=0,
        build_band_adj=True))
    gpu = DefectModel(cfg, gcfg, device=cuda, seed=0)
    cpu = DefectModel(cfg, gcfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})

    def loss_and_grads(model, dev):
        ids, labels, mask, g = text_loop._on_device(batch, dev)
        model.zero_grad(set_to_none=True)
        loss = cross_entropy_loss(model(ids, g), labels, mask)
        loss.backward()
        return float(loss), {k: p.grad for k, p in model.named_parameters()}

    fused_gnn.reset_launch_counts()
    got_loss, got = loss_and_grads(gpu, cuda)
    torch.cuda.synchronize()
    counts = fused_gnn.launch_counts()
    want_loss, want = loss_and_grads(cpu, "cpu")
    assert abs(got_loss - want_loss) <= 1e-5
    assert got.keys() == want.keys()
    for name, g in got.items():
        w = want[name]
        assert g is not None and torch.isfinite(g).all(), name
        err = (g.cpu() - w).abs().max().item()
        assert err <= 1e-4 * w.abs().max().item() + 1e-6, (name, err)
    k = gcfg.n_steps
    if impl == "fused":
        lane = {"fused_step_kernel": k, "fused_step_bwd_kernel": k,
                "step_weight_grad_kernel": k}
    else:
        lane = {"persistent_fwd_kernel": 1, "persistent_fwd_hist_kernel": 1,
                "persistent_bwd_kernel": 1, "step_weight_grad_kernel": 1}
    assert counts == {**dict.fromkeys(ALL_KERNELS, 0), **lane}
    tcfg = TransformerTrainConfig(batch_size=8, block_size=100)
    step = text_loop.make_text_train_step(
        gpu, text_loop.make_text_optimizer(gpu.parameters(), tcfg), tcfg,
        torch.Generator().manual_seed(0))
    loss, _ = step(batch, 1e-3)
    assert abs(float(loss) - want_loss) <= 1e-5
    assert all(torch.isfinite(p).all() for p in gpu.parameters())


# ---------------------------------------------------------------------------
# The flash kernels' bf16 instances and the text models at bf16
# ---------------------------------------------------------------------------

# A bf16 output against its plain version: both compute in f32 (in
# another order) and round once to bf16, so they land within a bf16 step
# of each other, plus the f32 order gap of the f32 kernels (1e-5).
BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-5)


def _bf16_inputs(b, t, h, d, dev):
    q, k, v, mask, g = _attn_inputs(b, t, h, d, dev)
    return q.bfloat16(), k.bfloat16(), v.bfloat16(), mask, g.bfloat16()


def _close_bf16(got, want, tol):
    assert got.dtype == want.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("b,t,h,d,causal", [
    (2, 64, 2, 64, False), (3, 100, 2, 64, True), (2, 200, 3, 64, False),
    (2, 512, 2, 64, False), (1, 4096, 2, 64, False)])
def test_flash_bf16_instances_match_plain_versions(cuda, b, t, h, d,
                                                   causal):
    """Each bf16 instance against its plain version (bf16 in, f32
    inside, bf16 out); only the bf16 instances launch."""
    from deepdfa_tpu_torch.ops import attention as A

    q, k, v, mask, g = _bf16_inputs(b, t, h, d, cuda)
    A.reset_launch_counts()
    o, lse = A.flash_fwd(q, k, v, mask, causal)
    o_ref, lse_ref = A.flash_fwd_reference(q, k, v, mask, causal)
    _close_bf16(o, o_ref, BF16_TOL)
    torch.testing.assert_close(lse, lse_ref, **FWD_TOL)
    assert torch.all(o[-1] == 0)
    delta = A.flash_delta(o_ref, g)
    args = (q, k, v, mask, g, lse_ref, delta, causal)
    want = A.flash_bwd_fused_reference(*args)
    dq = A.flash_bwd_dq(*args)
    dk, dv = A.flash_bwd_dkv(*args)
    for got, ref in zip((dq, dk, dv), want):
        _close_bf16(got, ref, BF16_TOL)
    launched = {"flash_fwd_kernel_bf16": 1, "flash_bwd_dq_kernel_bf16": 1,
                "flash_bwd_dkv_kernel_bf16": 1}
    if A.flash_fused_bwd_ok(t, d):
        for got, ref in zip(A.flash_bwd_fused(*args), want):
            _close_bf16(got, ref, BF16_TOL)
        launched["flash_bwd_fused_kernel_bf16"] = 1
    torch.cuda.synchronize()
    assert A.launch_counts() == {**dict.fromkeys(FLASH_KERNELS, 0),
                                 **launched}
    assert all(torch.all(x[-1] == 0) for x in (dq, dk, dv))
    for x in (dk, dv):  # padded keys: P = dS = 0
        assert not x[~mask].any()


@pytest.mark.parametrize("t,lengths,causal", [
    (512, [70, 0, 300], False),   # dead key tiles in two rows, one all-pad
    (200, [10, 130, 0], True),    # ragged T, causal
    (4096, [3000, 100], False),   # the two-pass pair
])
def test_flash_bf16_instances_are_the_f32_kernels_rounded(cuda, t, lengths,
                                                          causal):
    """The identity the bf16 design keeps: each bf16 instance gives bit
    for bit the f32 kernel's output on the widened inputs, rounded once
    to bf16 (lse bit for bit), so it skips the same dead key tiles; and
    two launches give the same bits."""
    from deepdfa_tpu_torch.ops import attention as A

    b, h, d = len(lengths), 2, 64
    q, k, v, _, g = _bf16_inputs(b, t, h, d, cuda)
    mask = torch.arange(t, device=cuda)[None, :] < torch.tensor(
        lengths, device=cuda)[:, None]
    wide = lambda *xs: [x.float() for x in xs]  # noqa: E731
    o, lse = A.flash_fwd(q, k, v, mask, causal)
    o32, lse32 = A.flash_fwd(*wide(q, k, v), mask, causal)
    assert torch.equal(o, o32.bfloat16()) and torch.equal(lse, lse32)
    again = A.flash_fwd(q, k, v, mask, causal)
    assert torch.equal(again[0], o) and torch.equal(again[1], lse)
    delta = A.flash_delta(o, g)
    args = (q, k, v, mask, g, lse, delta, causal)
    args32 = (*wide(q, k, v), mask, g.float(), lse, delta, causal)
    fns = [A.flash_bwd_dq, A.flash_bwd_dkv]
    if A.flash_fused_bwd_ok(t, d):
        fns.append(A.flash_bwd_fused)
    for fn in fns:
        got, want, rep = fn(*args), fn(*args32), fn(*args)
        got, want, rep = ([x] if torch.is_tensor(x) else list(x)
                          for x in (got, want, rep))
        for a, w, r in zip(got, want, rep):
            assert a.dtype == torch.bfloat16
            assert torch.equal(a, w.bfloat16()), fn.__name__
            assert torch.equal(a, r), fn.__name__
    dead = A.kernel_cost(mask, t, h, d, "flash_fwd_kernel_bf16", causal)[
        "dead_key_tiles"]
    assert dead == A.kernel_cost(mask, t, h, d, "flash_fwd_kernel", causal)[
        "dead_key_tiles"] > 0


def _text_step_states(make_model, batch, cfg, cuda, runs=2, steps=2):
    from deepdfa_tpu_torch.train import text_loop

    states = []
    for _ in range(runs):
        model = make_model()
        step = text_loop.make_text_train_step(
            model, text_loop.make_text_optimizer(model.parameters(), cfg),
            cfg, torch.Generator().manual_seed(0))
        for _ in range(steps):
            step(batch, 1e-3)
        states.append({k: v.cpu() for k, v in model.state_dict().items()})
    return states


def test_bf16_text_train_step_repeats_its_bits(cuda):
    """Two train steps of a bf16 LineVul encoder (dropout on) from the
    same weights, batch and seeds, twice: the same f32 master parameters
    bit for bit; the bf16 flash instances launched and no f32 one."""
    from deepdfa_tpu_torch.core.config import TransformerTrainConfig
    from deepdfa_tpu_torch.data.combined import load_combined_dataset
    from deepdfa_tpu_torch.data.text import HashingCodeTokenizer
    from deepdfa_tpu_torch.models.linevul import LineVul
    from deepdfa_tpu_torch.models.transformer import EncoderConfig
    from deepdfa_tpu_torch.ops import attention as A
    from deepdfa_tpu_torch.train import text_loop

    enc = EncoderConfig(vocab_size=512, hidden_size=128, num_layers=2,
                        num_heads=2, intermediate_size=256,
                        max_position_embeddings=130, attention_impl="auto",
                        dtype="bfloat16")
    data, _, _ = load_combined_dataset(
        "synthetic:16", FeatureSpec(limit_all=20), HashingCodeTokenizer(512),
        128)
    batch = next(text_loop.text_graph_batches(data, np.arange(16), 16))
    cfg = TransformerTrainConfig(batch_size=16, block_size=128)
    A.reset_launch_counts()
    states = _text_step_states(lambda: LineVul(enc, device=cuda, seed=0),
                               batch, cfg, cuda)
    counts = A.launch_counts()
    assert counts == {**dict.fromkeys(FLASH_KERNELS, 0),
                      "flash_fwd_kernel_bf16": 2 * 2 * 2,
                      "flash_bwd_fused_kernel_bf16": 2 * 2 * 2}
    for k, v in states[0].items():
        assert v.dtype == torch.float32, k
        assert torch.equal(states[1][k], v), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_codet5_train_step_repeats_its_bits(cuda, dtype):
    """Two train steps of DeepDFA+CodeT5 (dropout on, the persistent
    graph encoder) at the step's token count (16 rows of 512, most of
    them pad 0), twice from the same weights, batch and seeds: the same
    parameters bit for bit. The position bias table's gradient is a
    fixed-order sum (models/t5.py); the shared embedding's backward
    repeats its bits as it is."""
    from deepdfa_tpu_torch.core.config import TransformerTrainConfig
    from deepdfa_tpu_torch.data.combined import (
        graph_join_and_budget,
        load_combined_dataset,
    )
    from deepdfa_tpu_torch.data.text import HashingT5Tokenizer
    from deepdfa_tpu_torch.models.t5 import DefectModel, T5Config
    from deepdfa_tpu_torch.train import text_loop

    cfg = T5Config(d_model=128, d_kv=64, d_ff=256, num_layers=2,
                   num_decoder_layers=2, num_heads=2, dtype=dtype)
    feature = FeatureSpec(limit_all=20, limit_subkeys=20)
    gcfg = FlowGNNConfig(feature=feature, hidden_dim=8, n_steps=2,
                         encoder_mode=True, message_impl="persistent")
    data, _, graphs = load_combined_dataset(
        "synthetic:16", feature, HashingT5Tokenizer(cfg.vocab_size), 512,
        style="t5", graphs="synthetic")
    graphs, budget = graph_join_and_budget(list(graphs.values()), 16)
    batch = next(text_loop.text_graph_batches(
        data, np.arange(16), 16, graphs, SUBKEYS, budget, pad_id=0,
        build_band_adj=True))
    assert (batch.input_ids == 0).mean() > 0.5
    tcfg = TransformerTrainConfig(batch_size=16, block_size=512)
    states = _text_step_states(
        lambda: DefectModel(cfg, gcfg, device=cuda, seed=0), batch, tcfg,
        cuda)
    for k, v in states[0].items():
        assert torch.equal(states[1][k], v), k
