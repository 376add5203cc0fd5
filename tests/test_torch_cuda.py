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
The GNN forward kernels' bf16 instances are held to their plain versions
with bf16 and f32 band values at the serving, flagship and training
shapes, the persistent one bit for bit the scan of the per-step one;
their launch geometry to the host plan; a batch over the bf16 persistent
gate serves through the per-step instance; and the bf16 model on the card
to the CPU's. The fused lane's backward instances and the tile product's
bf16 instance are held to their plain versions (the weight pass's K steps
bit for bit the fold of one-step calls, each repeating its bits), their
geometry to the host plan, and a bf16 ``fit`` on the fused and tile lanes
to the CPU's losses. The bf16 weight pass (bf16 tensor-core products) is
held to its plain version at H 36, 100 and 128 with row counts off its
slab and split, bf16 and f32 messages, 1 and 5 steps, the fold bit for
bit, its instances' geometry to the host's mirror; the bf16 tile product
bit for bit to its plain version on the CPU at H 36, 100 and 128, with
msg off a 16-byte boundary and rows of more than 32 nonzeros. The
persistent lane's backward instances are held bit for bit to the scans
of the per-step ones at the serving and
training shapes, with bf16 and f32 band values, the K-step VJP to the
step VJP's scan in all seven outputs; a batch over their gate trains
through the per-step instances, and a bf16 ``fit`` on the persistent
lane gives the CPU's losses. A 2-replica serving fleet on the one card
answers with the single engine's bits on the persistent and fused lanes
at f32 and bf16, and after a threaded HTTP run on its two pump threads
the kernel's launch count is exactly its flushes'. Serving replays CUDA
graphs: on every lane and dtype (and the combined lane) a replay answers
a full and then a partial batch with the eager forward's bits and N
replays move the launch counts by N eager forwards'; a replica captures
its buckets at its first flushes while another's thread serves; the
ordered segment sum is bit for bit its plain version at in-degrees up to
1000 in both its modes (ids sorted, or a plan), and a CUDA graph of
either replays its eager bits; and the persistent forward on a serving bucket's padded cut points
gives the unpadded batch's bits. Under a telemetry run a replayed flush
is a fenced ``serve.flush`` span and each capture a fenced
``serve.compile`` span, nothing is captured after warmup, the
probabilities are the same bits with telemetry on and off, and a fence
asked for during a capture raises.
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
               "persistent_bwd_kernel", "step_weight_grad_kernel",
               "fused_step_kernel_bf16", "persistent_fwd_kernel_bf16",
               "fused_step_bwd_kernel_bf16", "step_weight_grad_kernel_bf16",
               "persistent_fwd_hist_kernel_bf16",
               "persistent_bwd_kernel_bf16")


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
        **dict.fromkeys(ALL_KERNELS, 0),
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
    with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
        fused_gnn.fused_gate_step(params, h.half(), adj)
    # f32 h takes f32 weights; bf16 h bf16 ones or the f32 masters,
    # rounded at launch (the model packs the masters), the same bits.
    p32 = fused_gnn.packed_weights(params)
    p16 = fused_gnn.packed_weights(params, torch.bfloat16)
    with pytest.raises(ValueError, match="float32 on"):
        fused_gnn.fused_gate_step(None, h, adj, packed=p16)
    assert torch.equal(
        fused_gnn.fused_gate_step(None, h.bfloat16(), adj, packed=p32),
        fused_gnn.fused_gate_step(None, h.bfloat16(), adj, packed=p16))
    with pytest.raises(ValueError, match="rows"):
        fused_gnn.fused_gate_step(params, h[:128], adj)
    with pytest.raises(ValueError, match="hidden"):
        fused_gnn.fused_gate_step(_params(130, cuda),
                                  torch.randn(256, 130, device=cuda), adj)
    with pytest.raises(ValueError, match="float32 on"):
        fused_gnn.fused_gate_step(_params(128, "cpu"), h, adj)
    # FlowGNN at bf16 builds on the card, its parameters f32.
    model = FlowGNN(FlowGNNConfig(dtype="bfloat16"), device=cuda)
    assert {p.dtype for p in model.parameters()} == {torch.float32}


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


def _serving_adj(graphs, padded=True, config=None):
    """The 16-slot serving bucket's band: as the engine packs it
    (``bucket_batch``, the cut points padded to the bucket's bound) or
    with the batch's own cut points."""
    config = config or ServeConfig()
    if padded:
        return bucket_batch(config, graphs, 16, SUBKEYS, band=True).band_adj
    budget = config.budget_for(16, tile=128)
    return batch_graphs(graphs, 16, budget["max_nodes"], budget["max_edges"],
                        SUBKEYS, build_band_adj=True,
                        band_bandwidth=config.band_bandwidth).band_adj


def _persistent_case(case):
    """(band adjacency, hidden) of one persistent-kernel case."""
    if case in ("serving", "serving_padded"):
        # The serving bucket: 16 synthetic graphs in 1024 rows, 34 groups;
        # as the engine packs it, their cut points padded to the bucket's
        # static 63 groups of up to 64 rows.
        graphs = synthetic_bigvul(16, FlowGNNConfig().feature, seed=0)
        return _serving_adj(graphs, padded=case == "serving_padded"), 128
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


@pytest.mark.parametrize("case", ["serving", "serving_padded",
                                  "over_a_tile", "over_a_tile_bwd", "h32",
                                  "one_group", "training"])
def test_persistent_kernels_equal_the_per_step_scan(cuda, case):
    # The persistent pair's claim: persistent_fwd_kernel is K launches of
    # fused_step_kernel, its hist instance the states between them, and
    # persistent_bwd_kernel the reverse scan of fused_step_bwd_kernel, bit
    # for bit; each kernel repeats its own bits launch to launch.
    adj, hidden = _persistent_case(case)
    adj = adj.to(cuda)
    groups = adj.row_groups.numel() - 1
    assert {"serving": groups == 34, "serving_padded": groups == 63,
            "one_group": groups == 1}.get(case, True)
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
    assert T.launch_counts() == {"tile_spmm_kernel": 1,
                                 "tile_spmm_kernel_bf16": 0}
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
    assert T.launch_counts() == {"tile_spmm_kernel": 7,
                                 "tile_spmm_kernel_bf16": 0}


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
    with pytest.raises(NotImplementedError, match="float32 messages"):
        T.tile_spmm(on_card, msg.half())
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
    assert T.launch_counts() == {"tile_spmm_kernel": 2 * cfg.n_steps,
                                 "tile_spmm_kernel_bf16": 0}


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
# The same past T 512, where a gradient sums up to 4096 tensor-core
# products with real keys: the f32 order gap grows to chip_smoke's
# ATTN_BF16_GRAD_TOL (at T 4096 with lengths [3000, 100] the f32 pair is
# up to 9.2e-5 from a float64 evaluation in dk and dv, the f32 plain
# version 1.1e-5; its bf16 design rounded missed BF16_TOL at 3 elements).
BF16_LONG_TOL = dict(rtol=2.0 ** -7, atol=1e-4)


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
    (4096, [3000, 100], False),   # the forward only: two-pass backward
])
def test_flash_bf16_instances_are_the_f32_kernels_rounded(cuda, t, lengths,
                                                          causal):
    """The bf16 forward and fused backward (bf16 mma.sync, P and dS split
    three ways, dq partials over 128-key blocks) against the f32 kernels
    on the widened inputs, rounded once to bf16: (a) o, dq, dk and dv
    each element within one bf16 step or 1e-5, lse within FWD_TOL; (b) as
    a mean over each output, no further from a float64 evaluation of the
    reference's formulas than 1.02 times the f32 kernels' rounded result;
    (c) two launches give the same bits, the same dead key tiles are
    skipped, padded keys get zero dk and dv and the all-pad row zeros."""
    from deepdfa_tpu_torch.ops import attention as A

    b, h, d = len(lengths), 2, 64
    q, k, v, _, g = _bf16_inputs(b, t, h, d, cuda)
    mask = torch.arange(t, device=cuda)[None, :] < torch.tensor(
        lengths, device=cuda)[:, None]
    wide = lambda *xs: [x.float() for x in xs]  # noqa: E731
    o, lse = A.flash_fwd(q, k, v, mask, causal)
    o32, lse32 = A.flash_fwd(*wide(q, k, v), mask, causal)
    torch.testing.assert_close(lse, lse32, **FWD_TOL)
    again = A.flash_fwd(q, k, v, mask, causal)
    assert torch.equal(again[0], o) and torch.equal(again[1], lse)
    delta = A.flash_delta(o, g)
    args = (q, k, v, mask, g, lse, delta, causal)
    got, rounded = [o], [o32.bfloat16()]
    if A.flash_fused_bwd_ok(t, d):
        grads = A.flash_bwd_fused(*args)
        rep = A.flash_bwd_fused(*args)
        assert all(torch.equal(a, r) for a, r in zip(grads, rep))
        got += list(grads)
        rounded += [x.bfloat16() for x in A.flash_bwd_fused(
            *wide(q, k, v), mask, g.float(), lse, delta, causal)]
    f64 = _pair_f64(q, k, v, mask, g, lse, delta, causal)
    seen = mask[:, None, :].expand(b, t, t)
    if causal:
        seen = seen & torch.ones(t, t, dtype=torch.bool, device=cuda).tril()
    o64 = torch.zeros(q.shape, dtype=torch.float64, device=cuda)
    for bi in range(b):
        for hi in range(h):
            s = (q[bi, :, hi].double() / d ** 0.5) @ k[bi, :, hi].double().T
            w = torch.softmax(torch.where(seen[bi], s, -torch.inf), -1)
            o64[bi, :, hi] = torch.nan_to_num(w) @ v[bi, :, hi].double()
    for name, x, r, ref in zip(("o", "dq", "dk", "dv"), got, rounded,
                               [o64, *f64]):
        assert x.dtype == torch.bfloat16
        gap = (x.float() - r.float()).abs()
        over = (_bf16_ulps_apart(x, r) > 1) & (gap > 1e-5)
        assert not over.any(), (name, int(over.sum()), float(gap.max()))
        err = (x.double() - ref).abs().mean()
        err_f32 = (r.double() - ref).abs().mean()
        assert err <= 1.02 * err_f32, (name, float(err), float(err_f32))
        if lengths[-1] == 0:
            assert torch.all(x[-1] == 0), name
    for x in got[2:]:  # padded keys: P = dS = 0
        assert not x[~mask].any()
    dead = A.kernel_cost(mask, t, h, d, "flash_fwd_kernel_bf16", causal)[
        "dead_key_tiles"]
    assert dead == A.kernel_cost(mask, t, h, d, "flash_fwd_kernel", causal)[
        "dead_key_tiles"] > 0


def _bf16_ulps_apart(a, b):
    """Elementwise distance of two bf16 tensors in bf16 steps (the bit
    patterns in order; +0 and -0 one value)."""
    def ordered(x):
        i = x.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)

    return (ordered(a) - ordered(b)).abs()


def _pair_f64(q, k, v, mask, g, lse, delta, causal):
    """dq, dk and dv of the reference's formulas in float64, one (batch,
    head) at a time: P = exp(S - lse) on the keys each query may see,
    dS = P (dO V^T - delta)."""
    b, t, h, d = q.shape
    scale = 1.0 / d ** 0.5
    out = [torch.zeros(q.shape, dtype=torch.float64, device=q.device)
           for _ in range(3)]
    seen = mask[:, None, :].expand(b, t, t)
    if causal:
        seen = seen & torch.ones(t, t, dtype=torch.bool,
                                 device=q.device).tril()
    for bi in range(b):
        for hi in range(h):
            qd, kd, vd, gd = (x[bi, :, hi].double() for x in (q, k, v, g))
            p = torch.where(seen[bi], torch.exp(
                (qd * scale) @ kd.T - lse[bi, hi].double()[:, None]), 0.0)
            ds = p * (gd @ vd.T - delta[bi, hi].double()[:, None])
            for x, r in zip(out, (scale * ds @ kd, scale * ds.T @ qd,
                                  p.T @ gd)):
                x[bi, :, hi] = r
    return out


@pytest.mark.parametrize("t,lengths,causal", [
    (512, [70, 0, 300], False),   # dead key tiles in two rows, one all-pad
    (200, [10, 130, 0], True),    # ragged T, causal
    (4096, [3000, 100], False),   # the two-pass pair's gate
    (1000, [1000, 450], True),    # causal over many tiles, ragged T
])
def test_flash_bf16_pair_within_an_ulp_of_the_f32_kernels(cuda, t, lengths,
                                                          causal):
    """The bf16 two-pass pair (bf16 mma.sync, P and dS split three ways)
    against the f32 kernels on the widened inputs, rounded once to bf16:
    (a) each element within one bf16 step or 1e-5; (b) as a mean over
    each of dq, dk and dv, no further from a float64 evaluation of the
    reference's formulas than 1.02 times the f32 kernels' rounded result;
    (c) within BF16_TOL of the plain versions (BF16_LONG_TOL past
    T 512); (d) two launches give the same bits, the same dead key tiles
    are skipped, padded keys get zero dk and dv and the all-pad row
    zeros."""
    from deepdfa_tpu_torch.ops import attention as A

    b, h, d = len(lengths), 2, 64
    q, k, v, _, g = _bf16_inputs(b, t, h, d, cuda)
    mask = torch.arange(t, device=cuda)[None, :] < torch.tensor(
        lengths, device=cuda)[:, None]
    o, lse = A.flash_fwd(q, k, v, mask, causal)
    delta = A.flash_delta(o, g)
    args = (q, k, v, mask, g, lse, delta, causal)
    wide = (q.float(), k.float(), v.float(), mask, g.float(), lse, delta,
            causal)
    A.reset_launch_counts()
    got = [A.flash_bwd_dq(*args), *A.flash_bwd_dkv(*args)]
    torch.cuda.synchronize()
    assert A.launch_counts() == {**dict.fromkeys(FLASH_KERNELS, 0),
                                 "flash_bwd_dq_kernel_bf16": 1,
                                 "flash_bwd_dkv_kernel_bf16": 1}
    rounded = [x.bfloat16() for x in (A.flash_bwd_dq(*wide),
                                      *A.flash_bwd_dkv(*wide))]
    plain = [A.flash_bwd_dq_reference(*args),
             *A.flash_bwd_dkv_reference(*args)]
    f64 = _pair_f64(q, k, v, mask, g, lse, delta, causal)
    for name, x, r, w, ref in zip(("dq", "dk", "dv"), got, rounded, plain,
                                  f64):
        assert x.dtype == torch.bfloat16
        gap = (x.float() - r.float()).abs()
        over = (_bf16_ulps_apart(x, r) > 1) & (gap > 1e-5)
        assert not over.any(), (name, int(over.sum()), float(gap.max()))
        err = (x.double() - ref).abs().mean()
        err_f32 = (r.double() - ref).abs().mean()
        assert err <= 1.02 * err_f32, (name, float(err), float(err_f32))
        _close_bf16(x, w, BF16_TOL if t <= 512 else BF16_LONG_TOL)
    again = [A.flash_bwd_dq(*args), *A.flash_bwd_dkv(*args)]
    assert all(torch.equal(a, x) for a, x in zip(again, got))
    for x in got[1:]:  # padded keys: P = dS = 0
        assert not x[~mask].any()
    for x in got:
        if lengths[-1] == 0:
            assert torch.all(x[-1] == 0)
    for kernel in ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel"):
        assert A.kernel_cost(mask, t, h, d, kernel + "_bf16", causal)[
            "dead_key_tiles"] == A.kernel_cost(mask, t, h, d, kernel,
                                               causal)["dead_key_tiles"]


def test_flash_bf16_pair_profile_files_each_kernel_once(cuda):
    """chip_smoke's profile tally files the bf16 flash kernels, each its
    own __global__, under their own names (no doubled _bf16), one launch
    each a call, and nothing under an f32 name: the pair's at T 4096, the
    forward's and the fused backward's with its dq sum at T 512."""
    import os
    import sys

    from deepdfa_tpu_torch.ops import attention as A

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke

    q, k, v, _, g = _bf16_inputs(2, 4096, 2, 64, cuda)
    mask = torch.arange(4096, device=cuda)[None, :] < torch.tensor(
        [3000, 100], device=cuda)[:, None]
    o, lse = A.flash_fwd(q, k, v, mask)
    tally = chip_smoke._device_profile(
        lambda: A.flash_backward(q, k, v, mask, o, lse, g), 2)["port_kernels"]
    assert set(tally) == {"flash_bwd_dq_kernel_bf16",
                          "flash_bwd_dkv_kernel_bf16"}, tally
    for entry in tally.values():
        assert entry["calls"] == 1, tally
    q, k, v, _, g = _bf16_inputs(2, 512, 2, 64, cuda)
    mask = torch.arange(512, device=cuda)[None, :] < torch.tensor(
        [400, 70], device=cuda)[:, None]
    tally = chip_smoke._device_profile(
        lambda: A.flash_fwd(q, k, v, mask), 2)["port_kernels"]
    assert set(tally) == {"flash_fwd_kernel_bf16"}, tally
    o, lse = A.flash_fwd(q, k, v, mask)
    tally = chip_smoke._device_profile(
        lambda: A.flash_backward(q, k, v, mask, o, lse, g), 2)["port_kernels"]
    assert set(tally) == {"flash_bwd_fused_kernel_bf16",
                          "flash_dq_sum_kernel_bf16"}, tally
    for entry in tally.values():
        assert entry["calls"] == 1, tally


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



# ---------------------------------------------------------------------------
# The GNN forward kernels' bf16 instances (FlowGNN(dtype="bfloat16"))
# ---------------------------------------------------------------------------

# A bf16 instance against its plain version: both round at the reference
# kernel's points and sum in f32 in another order, so an element may land
# one bf16 step apart (rtol 2^-7) and carry it onward over K steps (the
# CPU tests' bf16 tolerance, 5e-2). Measured on an H100: no element
# differs at any shape below (PERF.md).
GNN_BF16_STEP_TOL = dict(rtol=2.0 ** -7, atol=1e-6)
GNN_BF16_UNROLL_TOL = dict(rtol=5e-2, atol=5e-2)


def _bf16_case(case, cuda):
    """(band adjacency on the card, hidden) of a bf16 case: the serving
    bucket (N 1024), the flagship batch (N 8192), the training batch's
    size (N 16384), graphs over a tile at H 64 and small tiles at H 32."""
    if case == "flagship":
        graphs = synthetic_bigvul(256, FlowGNNConfig().feature,
                                  positive_fraction=0.5, seed=0)
        budget = pad_budget_for(graphs, 256)
        batch = batch_graphs(graphs, 256, align_to_tile(budget["max_nodes"]),
                             budget["max_edges"], SUBKEYS,
                             build_band_adj=True)
        return batch.band_adj.to(cuda), 128
    adj, hidden = _persistent_case(case)
    return adj.to(cuda), hidden


@pytest.mark.parametrize("f32_vals", [False, True])
@pytest.mark.parametrize("case", ["serving", "flagship", "training",
                                  "over_a_tile_bwd", "h32"])
def test_bf16_instances_match_plain_and_equal_the_scan(cuda, case,
                                                        f32_vals):
    """Each bf16 instance against its plain version; the persistent one
    bit for bit the scan of the per-step one, and each repeats its bits;
    bf16 in and out; only the bf16 instances launch."""
    adj, hidden = _bf16_case(case, cuda)
    if f32_vals:
        adj = dataclasses.replace(adj, vals=adj.vals.float())
    n, k = adj.n_tiles * adj.tile, 5
    params = _params(hidden, cuda, seed=4)
    h = torch.randn(n, hidden, generator=torch.Generator().manual_seed(5)
                    ).to(cuda).bfloat16()
    fused_gnn.reset_launch_counts()
    step = fused_gnn.fused_gate_step(params, h, adj)
    assert step.dtype == torch.bfloat16
    torch.testing.assert_close(step.float(), fused_gnn.fused_step_reference(
        params, h, adj).float(), **GNN_BF16_STEP_TOL)
    assert torch.equal(fused_gnn.fused_gate_step(params, h, adj), step)
    scan = h
    for _ in range(k):
        scan = fused_gnn.fused_gate_step(params, scan, adj)
    assert fused_gnn.persistent_smem_ok(adj, hidden, torch.bfloat16)
    out = fused_gnn.persistent_unroll(params, h, adj, k)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, scan)
    assert torch.equal(fused_gnn.persistent_unroll(params, h, adj, k), out)
    torch.testing.assert_close(out.float(), fused_gnn.persistent_reference(
        params, h, adj, k).float(), **GNN_BF16_UNROLL_TOL)
    torch.cuda.synchronize()
    assert fused_gnn.launch_counts() == {
        **dict.fromkeys(ALL_KERNELS, 0), "fused_step_kernel_bf16": 2 + k,
        "persistent_fwd_kernel_bf16": 2}


def test_bf16_geometry_and_occupancy_follow_the_host_plan(cuda):
    """The bf16 per-step instance's two passes take the plan
    ``step_plan`` mirrors on this card, the gate pass two blocks an SM;
    the persistent instance runs one block a group (no cluster) and
    reports its occupancy and shared memory, as
    ``persistent_fwd_bf16_smem_bytes`` mirrors it: one block an SM, as
    it is built (255 registers)."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    name = "fused_step_kernel_bf16"
    for case in ("serving", "flagship", "training"):
        adj, hidden = _bf16_case(case, cuda)
        n = adj.n_tiles * adj.tile
        geo = fused_gnn.step_geometry(adj, hidden, name)
        plan = fused_gnn.step_plan(n, hidden, geo["sms"], name)
        for key in ("row_tile", "cluster", "slab_rows", "blocks"):
            assert geo[key] == plan[key], (case, key)
        for p, key in ((0, "smem_bytes"), (1, "smem_bytes_pass1")):
            assert geo[key] == fused_gnn.step_smem_bytes(n, hidden,
                                                         geo["sms"], name, p)
        assert geo["blocks_per_sm"] >= 2 and geo["blocks_per_sm_pass1"] == 2
        assert fused_gnn.persistent_cluster_size(adj, hidden, sms,
                                                 torch.bfloat16) == 1
        for kernel in ("persistent_fwd_kernel_bf16",
                       "persistent_fwd_hist_kernel_bf16"):
            occ = fused_gnn.persistent_occupancy(adj, hidden, kernel)
            smem = fused_gnn.persistent_fwd_bf16_smem_bytes(adj, hidden)
            assert occ["smem_bytes"] == smem, (case, kernel)
            assert occ["blocks_per_sm"] == 1, (case, kernel)
            assert occ["active_clusters"] is None


def test_bf16_over_gate_batch_serves_through_the_fused_instance(cuda):
    """A batch whose group fits the f32 persistent gate (184 rows at
    H 128) but not the bf16 one (123 rows: the bf16 instance holds its
    messages apart) serves through fused_step_kernel_bf16 per step, and
    gives the CPU model's logits."""
    feature = FeatureSpec(limit_all=20, limit_subkeys=20)
    graph = synthetic_bigvul(1, feature, seed=0, min_nodes=150,
                             max_nodes=150)
    cfg = FlowGNNConfig(feature=feature, message_impl="persistent",
                        dtype="bfloat16")
    batch = batch_graphs(graph, 1, 256, 1024, SUBKEYS,
                         build_band_adj=True).to(cuda)
    assert fused_gnn.persistent_smem_ok(batch.band_adj, 128)
    assert not fused_gnn.persistent_smem_ok(batch.band_adj, 128,
                                            torch.bfloat16)
    model = FlowGNN(cfg, device=cuda, seed=0).eval()
    fused_gnn.reset_launch_counts()
    with torch.inference_mode():
        got = model(batch)
    torch.cuda.synchronize()
    assert model.over_gate_dispatches == 1
    assert fused_gnn.launch_counts() == {
        **dict.fromkeys(ALL_KERNELS, 0), "fused_step_kernel_bf16": cfg.n_steps}
    cpu = FlowGNN(cfg, device="cpu").eval()
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    with torch.inference_mode():
        want = cpu(batch.to("cpu"))
    torch.testing.assert_close(got.cpu(), want, **GNN_BF16_UNROLL_TOL)


@pytest.mark.parametrize("f32_vals", [False, True])
@pytest.mark.parametrize("sizes,n,tile,hidden", [
    ([40, 33, 20], 128, 64, 36),   # H 36: k and the columns padded to 48
    ([60, 50, 18], 128, 64, 100),  # H 100: padded to 112
    ([123, 5], 256, 128, 128),     # the largest group the bf16 gate admits
])
def test_bf16_forward_mma_off_the_tile_and_at_the_gate(cuda, sizes, n, tile,
                                                       hidden, f32_vals):
    """The tensor-core forward at widths off the mma tile (k and the
    product columns padded with zeros) and at the largest group the
    unchanged bf16 gate admits (123 rows at H 128; 124 refused): the
    per-step instance within a bf16 step of its plain version, the sweep
    bit for bit its scan and within 5e-2 of its plain version, the hist
    sweep bit for bit the scan's states, each kernel repeating its bits;
    only the bf16 instances launch."""
    adj = _graph_adj(sizes, n, tile).to(cuda)
    if f32_vals:
        adj = dataclasses.replace(adj, vals=adj.vals.float())
    assert adj.max_group_rows == max(sizes)
    assert fused_gnn.persistent_smem_ok(adj, hidden, torch.bfloat16)
    if hidden == 128:
        assert not fused_gnn.persistent_smem_ok(
            _graph_adj([124, 5], n, tile), hidden, torch.bfloat16)
    k = 5
    params = _params(hidden, cuda, seed=6)
    h = torch.randn(n, hidden, generator=torch.Generator().manual_seed(7)
                    ).to(cuda).bfloat16()
    fused_gnn.reset_launch_counts()
    step = fused_gnn.fused_gate_step(params, h, adj)
    torch.testing.assert_close(step.float(), fused_gnn.fused_step_reference(
        params, h, adj).float(), **GNN_BF16_STEP_TOL)
    assert torch.equal(fused_gnn.fused_gate_step(params, h, adj), step)
    states = [h]
    for _ in range(k):
        states.append(fused_gnn.fused_gate_step(params, states[-1], adj))
    out = fused_gnn.persistent_unroll(params, h, adj, k)
    assert torch.equal(out, states[-1])
    assert torch.equal(fused_gnn.persistent_unroll(params, h, adj, k), out)
    torch.testing.assert_close(out.float(), fused_gnn.persistent_reference(
        params, h, adj, k).float(), **GNN_BF16_UNROLL_TOL)
    hist = fused_gnn.persistent_hist(params, h, adj, k)
    assert torch.equal(hist, torch.stack(states[1:k]))
    assert torch.equal(fused_gnn.persistent_hist(params, h, adj, k), hist)
    torch.cuda.synchronize()
    assert fused_gnn.launch_counts() == {
        **dict.fromkeys(ALL_KERNELS, 0), "fused_step_kernel_bf16": 2 + k,
        "persistent_fwd_kernel_bf16": 2,
        "persistent_fwd_hist_kernel_bf16": 2}


@pytest.mark.parametrize("impl", ["persistent", "fused"])
def test_bf16_flowgnn_serves_the_cpu_logits(cuda, impl):
    """The bf16 model on the card (the bf16 instances, the matmul
    pooling) against the same model on the CPU (the plain versions, the
    segment pooling) at the serving bucket; then a training pass at bf16
    on the card: each lane's backward runs its bf16 instances (the
    persistent lane's once each: the hist sweep, the reverse sweep and
    the weight pass over the K steps)."""
    cfg = FlowGNNConfig(message_impl=impl, dtype="bfloat16")
    graphs = synthetic_bigvul(16, cfg.feature, seed=1)
    batch = bucket_batch(ServeConfig(), graphs, 16, SUBKEYS, band=True)
    model = FlowGNN(cfg, device=cuda, seed=2).eval()
    fused_gnn.reset_launch_counts()
    with torch.inference_mode():
        got = model(batch.to(cuda))
    torch.cuda.synchronize()
    name = ("persistent_fwd_kernel_bf16" if impl == "persistent"
            else "fused_step_kernel_bf16")
    assert fused_gnn.launch_counts() == {
        **dict.fromkeys(ALL_KERNELS, 0),
        name: 1 if impl == "persistent" else cfg.n_steps}
    cpu = FlowGNN(cfg, device="cpu").eval()
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    with torch.inference_mode():
        want = cpu(batch)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got.cpu(), want, **GNN_BF16_UNROLL_TOL)
    fused_gnn.reset_launch_counts()
    model.train()(batch.to(cuda)).sum().backward()
    torch.cuda.synchronize()
    counts = fused_gnn.launch_counts()
    if impl == "persistent":
        assert counts == {**dict.fromkeys(ALL_KERNELS, 0),
                          **dict.fromkeys((
                              "persistent_fwd_kernel_bf16",
                              "persistent_fwd_hist_kernel_bf16",
                              "persistent_bwd_kernel_bf16",
                              "step_weight_grad_kernel_bf16"), 1)}
    else:
        assert counts["fused_step_bwd_kernel_bf16"] == cfg.n_steps
        assert counts["step_weight_grad_kernel_bf16"] == cfg.n_steps
        assert counts["fused_step_bwd_kernel"] == counts[
            "step_weight_grad_kernel"] == 0
    assert all(p.grad.dtype == torch.float32 and bool(
        torch.isfinite(p.grad).all()) for p in model.parameters())


# ---------------------------------------------------------------------------
# The bf16 backward instances (training at bf16: the fused and tile lanes)
# ---------------------------------------------------------------------------

# A bf16 backward output against its plain version (chip_smoke's rule): a
# rounded intermediate may land one bf16 step apart, which moves a later
# sum by one step of its term: one bf16 step of the element plus half a
# step at the tensor's scale.
def _close_bf16_bwd(got, want, rtol=2.0 ** -7, scale=2.0 ** -8):
    assert got.dtype == want.dtype and got.shape == want.shape
    g, w = got.float(), want.float()
    assert bool(torch.isfinite(g).all())
    limit = rtol * w.abs() + scale * w.abs().max()
    assert bool(((g - w).abs() <= limit).all()), float((g - w).abs().max())


@pytest.mark.parametrize("f32_vals", [False, True])
@pytest.mark.parametrize("case", ["serving", "training", "over_a_tile_bwd",
                                  "h32"])
def test_bf16_backward_instances_match_plain_versions(cuda, case, f32_vals):
    """``fused_step_bwd_kernel_bf16`` and ``step_weight_grad_kernel_bf16``
    against their plain versions: ``dh`` and ``x`` bf16, ``dp`` and
    ``dmsg`` f32; the weight pass over 3 steps bit for bit the fold of
    one-step calls and its own second launch; the f32 masters' gradients
    f32; only the bf16 instances launch."""
    adj, hidden = _bf16_case(case, cuda)
    if f32_vals:
        adj = dataclasses.replace(adj, vals=adj.vals.float())
    n, k = adj.n_tiles * adj.tile, 3
    mdt = fused_gnn.msg_dtype(adj, torch.bfloat16)
    p32 = fused_gnn.packed_weights(_params(hidden, cuda, seed=6))
    gen = torch.Generator().manual_seed(7)
    h, g = (torch.randn(n, hidden, generator=gen).to(cuda).bfloat16()
            for _ in range(2))
    fused_gnn.reset_launch_counts()
    got = fused_gnn.fused_step_bwd_rows(None, h, adj, g, p32)
    assert [t.dtype for t in got] == [torch.bfloat16, torch.bfloat16,
                                      torch.float32, torch.float32]
    for a, b in zip(got, fused_gnn.fused_step_bwd_rows_reference(
            None, h, adj, g, p32)):
        _close_bf16_bwd(a, b)
    for a, b in zip(fused_gnn.fused_step_bwd_rows(None, h, adj, g, p32),
                    got):
        assert torch.equal(a, b)
    states = [h]
    for _ in range(k - 1):
        states.append(fused_gnn.fused_gate_step(None, states[-1], adj,
                                                packed=p32))
    hist = torch.stack(states[1:]).contiguous()
    rows, gs = [None] * k, g
    for s in reversed(range(k)):
        gs, *rows[s] = fused_gnn.fused_step_bwd_rows(None, states[s], adj, gs,
                                                     p32)
    x, dp, dmsg = (torch.stack([r[j] for r in rows]).contiguous()
                   for j in range(3))
    grads = fused_gnn.step_weight_grads(h, hist, x, dp, dmsg, k, mdt)
    want = fused_gnn.step_weight_grad_reference(h, hist, x, dp, dmsg, k, mdt)
    for a, b in zip(grads, want):
        assert a.dtype == torch.float32
        assert float((a - b).abs().max()) <= GRAD_TOL * float(b.abs().max())
    fold = None
    for s in reversed(range(k)):
        one = fused_gnn.step_weight_grads(states[s].contiguous(), None,
                                          x[s:s + 1], dp[s:s + 1],
                                          dmsg[s:s + 1], 1, mdt)
        fold = one if fold is None else [a + b for a, b in zip(fold, one)]
    again = fused_gnn.step_weight_grads(h, hist, x, dp, dmsg, k, mdt)
    for a, b, c in zip(grads, fold, again):
        assert torch.equal(a, b) and torch.equal(a, c)
    torch.cuda.synchronize()
    assert fused_gnn.launch_counts() == {
        **dict.fromkeys(ALL_KERNELS, 0), "fused_step_kernel_bf16": k - 1,
        "fused_step_bwd_kernel_bf16": 2 + k,
        "step_weight_grad_kernel_bf16": 2 + k}


def test_bf16_backward_geometry_follows_the_host_plan(cuda):
    """The bf16 backward instance's three passes take the plan
    ``step_plan`` mirrors on this card, with ``step_smem_bytes``'s shared
    memory; the gate pass holds two blocks an SM (its products on the
    bf16 tensor cores, at most 128 registers a thread), the others at
    least two."""
    name = "fused_step_bwd_kernel_bf16"
    for case in ("serving", "flagship", "training"):
        adj, hidden = _bf16_case(case, cuda)
        n = adj.n_tiles * adj.tile
        geo = fused_gnn.step_geometry(adj, hidden, name)
        plan = fused_gnn.step_plan(n, hidden, geo["sms"], name)
        for key in ("row_tile", "slab_rows", "blocks"):
            assert geo[key] == plan[key], (case, key)
        for p, key in ((0, "smem_bytes"), (1, "smem_bytes_pass1"),
                       (2, "smem_bytes_pass2")):
            assert geo[key] == fused_gnn.step_smem_bytes(n, hidden,
                                                         geo["sms"], name, p)
        assert geo["blocks_per_sm_pass1"] == 2, case
        assert geo["blocks_per_sm"] >= 2 and geo["blocks_per_sm_pass2"] >= 2


@pytest.mark.parametrize("n,sizes", [(1024, [40] * 20), (16384, [60] * 250)])
@pytest.mark.parametrize("hidden", [32, 128, 30])  # 30: one value a lane
def test_tile_spmm_bf16_instance_matches_plain_version(cuda, n, sizes,
                                                       hidden):
    """``tile_spmm_kernel_bf16`` over A and A^T against its plain version
    (f32 sums rounded once: bit for bit but for sums that land on a
    rounding boundary in another order), its bits twice, a multiplicity
    of 300 (f32, not bf16-exact) taken as the reference's upcast does."""
    adj, _ = _tile_lists(sizes, n)
    adj = adj.to(cuda)
    msg = torch.randn(n, hidden, generator=torch.Generator().manual_seed(1)
                      ).to(cuda).bfloat16()
    T.reset_launch_counts()
    for a in (adj, adj.transposed()):
        got = T.tile_spmm(a, msg)
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got.float(), T.tile_spmm_reference(
            a, msg).float(), **GNN_BF16_STEP_TOL)
        assert torch.equal(T.tile_spmm(a, msg), got)
    heavy = T.build_csr_adjacency(np.zeros(300, np.int64),
                                  np.ones(300, np.int64),
                                  np.ones(300, bool), 16).to(cuda)
    one = T.tile_spmm(heavy, torch.ones(16, 4, device=cuda).bfloat16())
    assert one[1].float().tolist() == [300.0] * 4 and not one[2:].any()
    torch.cuda.synchronize()
    assert T.launch_counts() == {"tile_spmm_kernel": 0,
                                 "tile_spmm_kernel_bf16": 5}


@pytest.mark.parametrize("f32_msg", [False, True])
@pytest.mark.parametrize("n,hidden", [
    (1000, 36),    # 108 columns of dW_i: ragged tiles; 4-byte copies
    (1000, 100),   # 300 columns in three tiles, the last ragged
    (16456, 128),  # the training width, splits of 928, the last 680 rows
])
def test_bf16_weight_pass_ragged_widths_rows_and_the_fold(cuda, n, hidden,
                                                          f32_msg):
    """``step_weight_grad_kernel_bf16`` (bf16 ``mma.sync``; f32 messages:
    dmsg split three ways) on seeded cotangents against its plain version
    within ``GRAD_TOL``, at 1 and 5 steps, row counts that are no multiple
    of a slab or a split; the 5-step call bit for bit the fold of 5
    one-step calls and its own second launch; only the bf16 instance
    launches."""
    k = 5
    mdt = torch.float32 if f32_msg else torch.bfloat16
    rng = np.random.default_rng(11)

    def rand(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).to(cuda)

    h0, hist = rand(n, hidden).bfloat16(), rand(k - 1, n, hidden).bfloat16()
    x = rand(k, n, hidden).bfloat16()
    dp, dmsg = rand(k, n, 4 * hidden, scale=1e-2), rand(k, n, hidden)
    rows = fused_gnn.wgrad_bf16_rows_per_split(n, hidden)
    assert n % fused_gnn.WGRAD_BF16_SLAB_ROWS and n % rows
    fused_gnn.reset_launch_counts()
    for steps in (1, k):
        args = (h0, hist[:steps - 1] if steps > 1 else None, x[:steps],
                dp[:steps], dmsg[:steps], steps, mdt)
        got = fused_gnn.step_weight_grads(*args)
        assert all(torch.equal(a, c)
                   for a, c in zip(got, fused_gnn.step_weight_grads(*args)))
        _grads_close(got, fused_gnn.step_weight_grad_reference(*args))
    fold = None
    for s in reversed(range(k)):
        hs = (h0 if s == 0 else hist[s - 1]).contiguous()
        one = fused_gnn.step_weight_grads(hs, None, x[s:s + 1], dp[s:s + 1],
                                          dmsg[s:s + 1], 1, mdt)
        fold = one if fold is None else tuple(a + b for a, b in zip(fold,
                                                                    one))
    assert all(torch.equal(a, b) for a, b in zip(got, fold))
    torch.cuda.synchronize()
    assert fused_gnn.launch_counts() == {
        **dict.fromkeys(ALL_KERNELS, 0),
        "step_weight_grad_kernel_bf16": 4 + k}


def test_bf16_weight_pass_geometry_follows_the_mirror(cuda):
    """The library's bf16 weight-pass instances (bf16 and f32 messages)
    hold ``WGRAD_BF16_BLOCKS`` blocks an SM with the shared memory
    ``wgrad_bf16_smem_bytes`` mirrors."""
    for round_msg in (True, False):
        geo = fused_gnn.wgrad_bf16_geometry(round_msg)
        assert geo == dict(
            blocks_per_sm=fused_gnn.WGRAD_BF16_BLOCKS,
            smem_bytes=fused_gnn.wgrad_bf16_smem_bytes(round_msg),
            slab_rows=fused_gnn.WGRAD_BF16_SLAB_ROWS,
            stages=(fused_gnn.WGRAD_BF16_STAGES if round_msg
                    else fused_gnn.WGRAD_BF16_SPLIT_STAGES)), round_msg


@pytest.mark.parametrize("hidden", [36, 100, 128])
def test_tile_spmm_bf16_widths_alignment_and_long_rows(cuda, hidden):
    """``tile_spmm_kernel_bf16`` bit for bit its plain version (on the CPU:
    the sums in list order) over A and A^T: 16-byte lanes (H 128), 8-byte
    and one-value lanes (H 36 and 100, and msg at an offset of 4 or 1
    values from a 16-byte boundary), a hub row of 70 senders and a sender
    of 40 receivers (more than a lane group's pairs at once), repeated
    edges."""
    n = 640
    adj, _ = _tile_lists([120, 200, 90, 150], n, seed=4)
    rng = np.random.default_rng(5)
    hub_s = np.concatenate([rng.choice(n, 70, replace=False), [7] * 40,
                            rng.integers(0, n, 30)])
    hub_r = np.concatenate([[300] * 70, rng.choice(n, 40, replace=False),
                            rng.integers(0, n, 30)])
    s = np.concatenate([adj.src.numpy(), hub_s])
    r = np.concatenate([adj.row_ids().numpy(), hub_r])
    lists = T.build_csr_adjacency(s, r, np.ones(len(s), bool), n)
    assert int((lists.ptr[1:] - lists.ptr[:-1]).max()) > 32
    assert int((lists.t_ptr[1:] - lists.t_ptr[:-1]).max()) > 32
    card = lists.to(cuda)
    flat = torch.from_numpy(rng.standard_normal(n * hidden + 8).astype(
        np.float32)).bfloat16()
    T.reset_launch_counts()
    for offset in (0, 4, 1):
        msg_cpu = flat[offset:offset + n * hidden].view(n, hidden)
        msg = flat.to(cuda)[offset:offset + n * hidden].view(n, hidden)
        for a, a_cpu in ((card, lists), (card.transposed(),
                                         lists.transposed())):
            got = T.tile_spmm(a, msg)
            assert got.dtype == torch.bfloat16
            assert torch.equal(got.cpu(), T.tile_spmm_reference(a_cpu,
                                                                msg_cpu))
            assert torch.equal(T.tile_spmm(a, msg), got)
    torch.cuda.synchronize()
    assert T.launch_counts() == {"tile_spmm_kernel": 0,
                                 "tile_spmm_kernel_bf16": 12}


@pytest.mark.parametrize("impl", ["fused", "tile", "persistent"])
def test_bf16_fit_matches_cpu(cuda, impl):
    """``loop.fit`` at bf16 for one epoch on the card against the same
    weights and batches on the CPU: per-step losses within 5e-2 (the
    reference's bf16 tolerance; the card pools by matmul, the CPU by
    bf16 segment sums); the bf16 instances launch, their f32 kernels do
    not; the parameters stay f32."""
    from deepdfa_tpu_torch.core.config import DataConfig, TrainConfig
    from deepdfa_tpu_torch.data.splits import make_splits
    from deepdfa_tpu_torch.ops import launch_counts, reset_launch_counts
    from deepdfa_tpu_torch.train import loop

    feature = FeatureSpec(limit_all=20, limit_subkeys=20)
    cfg = FlowGNNConfig(feature=feature, message_impl=impl,
                        dtype="bfloat16")
    examples = synthetic_bigvul(160, feature, positive_fraction=0.5, seed=3)
    splits = make_splits(examples, "random", seed=0)
    tcfg = TrainConfig(max_epochs=1, learning_rate=2e-3)
    dcfg = DataConfig(batch_size=32, eval_batch_size=32)
    model = FlowGNN(cfg, device=cuda, seed=4)
    cpu = FlowGNN(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    reset_launch_counts()
    _, hist = loop.fit(model, examples, splits, tcfg, dcfg)
    torch.cuda.synchronize()
    counts = launch_counts()
    _, cpu_hist = loop.fit(cpu, examples, splits, tcfg, dcfg)
    got = [x for e in hist["epochs"] for x in e["step_losses"]]
    want = [x for e in cpu_hist["epochs"] for x in e["step_losses"]]
    assert len(got) == len(want) >= 3
    np.testing.assert_allclose(got, want, rtol=5e-2, atol=5e-2)
    names = {"fused": ("fused_step_kernel_bf16",
                       "fused_step_bwd_kernel_bf16",
                       "step_weight_grad_kernel_bf16"),
             "tile": ("tile_spmm_kernel_bf16",),
             "persistent": ("persistent_fwd_kernel_bf16",
                            "persistent_fwd_hist_kernel_bf16",
                            "persistent_bwd_kernel_bf16",
                            "step_weight_grad_kernel_bf16")}[impl]
    assert all(counts[k] > 0 for k in names)
    # No f32 GNN or tile kernel: the bf16 instances replace them. The
    # pooling's per-graph sums are f32 at either dtype: one launch of
    # segment_sum_kernel a validation batch (no gradient flows there).
    val_batches = sum(1 for _ in loop._batches(
        examples, splits["val"], dcfg, SUBKEYS, dcfg.eval_batch_size,
        build_band_adj=cfg.uses_band_adj, build_tile_adj=cfg.uses_tile_adj))
    assert counts["segment_sum_kernel"] == val_batches > 0
    assert all(v == 0 for k, v in counts.items()
               if not k.endswith("_bf16") and k != "segment_sum_kernel")
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert model.over_gate_dispatches == 0


# ---------------------------------------------------------------------------
# The persistent lane's backward at bf16 (training the default lane)
# ---------------------------------------------------------------------------


# A K-step bf16 sweep's output against its plain version: a value one
# bf16 step apart carries onward over the steps (the CPU tests' bf16
# tolerance, 5e-2 of the element and of the tensor's scale).
SWEEP_TOL = dict(rtol=5e-2, scale=5e-2)


@pytest.mark.parametrize("f32_vals", [False, True])
@pytest.mark.parametrize("case", ["serving", "training"])
def test_bf16_persistent_backward_equals_the_per_step_scan(cuda, case,
                                                           f32_vals):
    """``persistent_fwd_hist_kernel_bf16``: h_1..h_{K-1} bit for bit the
    scan of ``fused_step_kernel_bf16`` and the first K-1 outputs of
    ``persistent_fwd_kernel_bf16``; ``persistent_bwd_kernel_bf16``: dh_0
    and each step's x, dp and dmsg bit for bit the reverse scan of
    ``fused_step_bwd_kernel_bf16``; ``persistent_backward`` at bf16 bit
    for bit ``fused_step_backward``'s scan in all seven outputs (the
    weight pass over K steps the fold of one-step calls); each near its
    plain version and repeating its bits."""
    adj, hidden = _bf16_case(case, cuda)
    if f32_vals:
        adj = dataclasses.replace(adj, vals=adj.vals.float())
    n, k = adj.n_tiles * adj.tile, 5
    bf16 = torch.bfloat16
    assert fused_gnn.persistent_bwd_smem_ok(adj, hidden, bf16)
    p32 = fused_gnn.packed_weights(_params(hidden, cuda, seed=8))
    gen = torch.Generator().manual_seed(9)
    h, g = (torch.randn(n, hidden, generator=gen).to(cuda).bfloat16()
            for _ in range(2))
    fused_gnn.reset_launch_counts()
    hist = fused_gnn.persistent_hist(None, h, adj, k, p32)
    assert hist.dtype == bf16 and hist.shape == (k - 1, n, hidden)
    states = [h]
    for _ in range(k - 1):
        states.append(fused_gnn.fused_gate_step(None, states[-1], adj,
                                                packed=p32))
    assert torch.equal(hist, torch.stack(states[1:]))
    for j in range(1, k):
        assert torch.equal(hist[j - 1], fused_gnn.persistent_unroll(
            None, h, adj, j, packed=p32))
    assert torch.equal(fused_gnn.persistent_hist(None, h, adj, k, p32), hist)
    _close_bf16_bwd(hist, fused_gnn.persistent_hist_reference(
        None, h, adj, k, p32), **SWEEP_TOL)
    rows = fused_gnn.persistent_bwd_rows(None, h, hist, adj, g, k, p32)
    assert [t.dtype for t in rows] == [bf16, bf16, torch.float32,
                                       torch.float32]
    gs, scan = g, [None] * k
    for s in reversed(range(k)):
        gs, *scan[s] = fused_gnn.fused_step_bwd_rows(None, states[s], adj,
                                                     gs, p32)
    assert torch.equal(rows[0], gs)
    for j in range(3):
        assert torch.equal(rows[1 + j], torch.stack([c[j] for c in scan]))
    for a, b in zip(fused_gnn.persistent_bwd_rows(None, h, hist, adj, g, k,
                                                  p32), rows):
        assert torch.equal(a, b)
    for a, b in zip(rows, fused_gnn.persistent_bwd_rows_reference(
            None, h, hist, adj, g, k, p32)):
        _close_bf16_bwd(a, b, **SWEEP_TOL)
    full = fused_gnn.persistent_backward(None, h, adj, g, k, packed=p32)
    gs, fold = g, None
    for s in reversed(range(k)):
        gs, *one = fused_gnn.fused_step_backward(None, states[s], adj, gs,
                                                 packed=p32)
        fold = one if fold is None else [a + b for a, b in zip(fold, one)]
    assert [t.dtype for t in full] == [bf16] + [torch.float32] * 6
    for a, b in zip(full, [gs] + fold):
        assert torch.equal(a, b)
    torch.cuda.synchronize()
    assert fused_gnn.launch_counts() == {
        **dict.fromkeys(ALL_KERNELS, 0),
        "persistent_fwd_hist_kernel_bf16": 3,
        "persistent_fwd_kernel_bf16": k - 1,
        "fused_step_kernel_bf16": k - 1,
        "persistent_bwd_kernel_bf16": 3,
        "fused_step_bwd_kernel_bf16": 2 * k,
        "step_weight_grad_kernel_bf16": 1 + k}


@pytest.mark.parametrize("hidden", [36, 100])
def test_bf16_backward_pair_at_widths_off_the_mma_tile(cuda, hidden):
    """Widths that are no multiple of 16 (the tensor-core products pad k
    and the columns with zeros) nor of 8 (the weights copy in 8-byte
    pieces): ``fused_step_bwd_kernel_bf16`` within the one-step rule of
    its plain version, ``persistent_bwd_kernel_bf16`` bit for bit the
    reverse scan of it and within the sweep rule of its plain version,
    at bf16 and f32 band values."""
    for f32_vals in (False, True):
        adj = _graph_adj([30, 20, 9], 64, 16, bandwidth=4).to(cuda)
        if f32_vals:
            adj = dataclasses.replace(adj, vals=adj.vals.float())
        n, k = adj.n_tiles * adj.tile, 3
        p32 = fused_gnn.packed_weights(_params(hidden, cuda, seed=10))
        gen = torch.Generator().manual_seed(11)
        h, g = (torch.randn(n, hidden, generator=gen).to(cuda).bfloat16()
                for _ in range(2))
        for a, b in zip(fused_gnn.fused_step_bwd_rows(None, h, adj, g, p32),
                        fused_gnn.fused_step_bwd_rows_reference(
                            None, h, adj, g, p32)):
            _close_bf16_bwd(a, b)
        states = [h]
        for _ in range(k - 1):
            states.append(fused_gnn.fused_gate_step(None, states[-1], adj,
                                                    packed=p32))
        hist = torch.stack(states[1:]).contiguous()
        rows = fused_gnn.persistent_bwd_rows(None, h, hist, adj, g, k, p32)
        gs, scan = g, [None] * k
        for s in reversed(range(k)):
            gs, *scan[s] = fused_gnn.fused_step_bwd_rows(None, states[s],
                                                         adj, gs, p32)
        assert torch.equal(rows[0], gs)
        for j in range(3):
            assert torch.equal(rows[1 + j],
                               torch.stack([c[j] for c in scan]))
        for a, b in zip(rows, fused_gnn.persistent_bwd_rows_reference(
                None, h, hist, adj, g, k, p32)):
            _close_bf16_bwd(a, b, **SWEEP_TOL)


def test_bf16_persistent_backward_occupancy(cuda):
    """The bf16 sweeps' launched instances report their occupancy: the
    hist sweep as the bf16 forward (one block a group), the reverse sweep
    two blocks an SM where its shared memory
    lets it (groups of up to 48 rows at H 128; the training case's 60-row
    groups one), that memory as ``persistent_bwd_bf16_smem_bytes``
    mirrors it, within the gate's count of four f32 row arrays."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for case in ("serving", "training"):
        adj, hidden = _bf16_case(case, cuda)
        assert fused_gnn.persistent_cluster_size(adj, hidden, sms,
                                                 torch.bfloat16) == 1
        occ = fused_gnn.persistent_occupancy(
            adj, hidden, "persistent_fwd_hist_kernel_bf16")
        assert occ["blocks_per_sm"] >= 1
        assert occ["smem_bytes"] == fused_gnn.persistent_fwd_bf16_smem_bytes(
            adj, hidden)
        occ = fused_gnn.persistent_occupancy(adj, hidden,
                                             "persistent_bwd_kernel_bf16")
        two = 2 * (occ["smem_bytes"] + 1024) <= 228 * 1024
        assert occ["blocks_per_sm"] == (2 if two else 1), case
        assert occ["smem_bytes"] == fused_gnn.persistent_bwd_bf16_smem_bytes(
            adj, hidden) <= fused_gnn.persistent_bwd_smem_bytes(
                adj, hidden, torch.bfloat16)


def test_bf16_over_bwd_gate_batch_trains_through_the_per_step_instances(
        cuda):
    """A group of 110 rows fits the bf16 forward gate (123 rows) and the
    f32 backward gate (123) but not the bf16 backward gate (92: four row
    arrays): a training pass at bf16 runs the per-step bf16 instances K
    times (``over_gate_dispatches`` 1), and its parameter gradients are
    the CPU model's."""
    feature = FeatureSpec(limit_all=20, limit_subkeys=20)
    graph = synthetic_bigvul(1, feature, seed=0, min_nodes=110,
                             max_nodes=110)
    cfg = FlowGNNConfig(feature=feature, message_impl="persistent",
                        dtype="bfloat16")
    batch = batch_graphs(graph, 1, 256, 1024, SUBKEYS,
                         build_band_adj=True).to(cuda)
    adj = batch.band_adj
    assert fused_gnn.persistent_smem_ok(adj, 128, torch.bfloat16)
    assert fused_gnn.persistent_bwd_smem_ok(adj, 128)
    assert not fused_gnn.persistent_bwd_smem_ok(adj, 128, torch.bfloat16)
    model = FlowGNN(cfg, device=cuda, seed=0)
    cpu = FlowGNN(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    fused_gnn.reset_launch_counts()
    model(batch).sum().backward()
    torch.cuda.synchronize()
    assert model.over_gate_dispatches == 1
    assert fused_gnn.launch_counts() == {
        **dict.fromkeys(ALL_KERNELS, 0),
        **dict.fromkeys(("fused_step_kernel_bf16",
                         "fused_step_bwd_kernel_bf16",
                         "step_weight_grad_kernel_bf16"), cfg.n_steps)}
    cpu(batch.to("cpu")).sum().backward()
    for (name, p), q in zip(model.named_parameters(), cpu.parameters()):
        if name == "pooling.gate.bias":  # 0 in exact arithmetic
            continue
        gap = float((p.grad.cpu() - q.grad).abs().max())
        assert gap <= 5e-2 * float(q.grad.abs().max()), (name, gap)


# ---------------------------------------------------------------------------
# The serving fleet on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["persistent", "fused"])
def test_fleet_on_one_card_equals_one_engine(cuda, impl, dtype):
    """Two replicas on the one card (sharing its model) answer 96
    requests with the single engine's bits, both replicas flushing and
    nothing compiled after warmup."""
    from deepdfa_tpu_torch.serve import ServeEngine, ServeFleet

    cfg = FlowGNNConfig(message_impl=impl, dtype=dtype)
    model = FlowGNN(cfg, device=cuda, seed=4)
    config = ServeConfig(batch_slots=8)
    graphs = synthetic_bigvul(96, cfg.feature, seed=6)
    single = ServeEngine(model, config, device=cuda)
    single.warmup()
    want = [r["prob"] for r in single.score_sync(graphs)]
    fleet = ServeFleet.build(model, config, n_replicas=2, devices=[cuda])
    fleet.warmup()
    got = [r["prob"] for r in fleet.score_sync(graphs)]
    assert got == want
    assert all(r.engine.model is model for r in fleet.replicas)
    assert all(r.engine.stats.batches for r in fleet.replicas)
    assert fleet.compiles_after_warmup == 0


def test_fleet_http_pump_threads_count_every_launch(cuda):
    """Two pump threads launching on one card: after a threaded HTTP run
    the persistent kernel's count is exactly the flushes' launches (one
    a flush), none lost between the threads."""
    import json
    import threading
    import urllib.request

    from deepdfa_tpu_torch.ops import launch_counts, reset_launch_counts
    from deepdfa_tpu_torch.serve import ServeFleet
    from deepdfa_tpu_torch.serve.http import ServeHTTPServer

    cfg = FlowGNNConfig(message_impl="persistent")
    model = FlowGNN(cfg, device=cuda, seed=5)
    fleet = ServeFleet.build(model, ServeConfig(batch_slots=4,
                                                deadline_ms=20.0),
                             n_replicas=2, devices=[cuda])
    fleet.warmup()
    server = ServeHTTPServer(("127.0.0.1", 0), fleet)
    server.start_pump()
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    graphs = synthetic_bigvul(192, cfg.feature, seed=7)
    answers = []

    def client(part):
        for g in part:
            doc = {"functions": [{"graph": {
                "num_nodes": int(g["num_nodes"]),
                "senders": np.asarray(g["senders"]).tolist(),
                "receivers": np.asarray(g["receivers"]).tolist(),
                "feats": {k: np.asarray(v).tolist()
                          for k, v in g["feats"].items()}}}]}
            req = urllib.request.Request(
                f"{base}/score", data=json.dumps(doc).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as resp:
                answers.append(json.loads(resp.read())["results"][0])

    try:
        reset_launch_counts()
        clients = [threading.Thread(target=client, args=(graphs[i::12],))
                   for i in range(12)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=120)
        assert not any(c.is_alive() for c in clients)
        torch.cuda.synchronize()
        launches = launch_counts()
        snap = fleet.snapshot()
    finally:
        server.shutdown()
        server.server_close()
    assert len(answers) == 192 and all("prob" in a for a in answers)
    assert all(m["batches"] for m in snap["replicas"].values())
    assert launches["persistent_fwd_kernel"] + model.over_gate_dispatches \
        == snap["batches"] > 0
    # The pooling's per-graph sums, one launch a flush
    # (segment_sum_kernel), and no other kernel.
    assert launches["segment_sum_kernel"] == snap["batches"]
    assert sum(launches.values()) == launches["persistent_fwd_kernel"] \
        + launches["segment_sum_kernel"]


# ---------------------------------------------------------------------------
# Serving as captured CUDA graphs
# ---------------------------------------------------------------------------


def _serve_engine(cuda, impl, dtype, slots=16, lane="gnn", seed=8):
    """A warmed engine on the card at the published FlowGNN width (the
    combined lane: a 2-layer, 128-wide encoder over 128 tokens)."""
    from deepdfa_tpu_torch.data.text import HashingCodeTokenizer
    from deepdfa_tpu_torch.models.linevul import LineVul
    from deepdfa_tpu_torch.models.transformer import EncoderConfig
    from deepdfa_tpu_torch.serve import ServeEngine

    cfg = FlowGNNConfig(message_impl=impl, dtype=dtype)
    model = FlowGNN(cfg, device=cuda, seed=seed)
    kw = {}
    config = ServeConfig(batch_slots=slots)
    if lane == "combined":
        enc = EncoderConfig(vocab_size=512, hidden_size=128, num_layers=2,
                            num_heads=2, intermediate_size=256,
                            max_position_embeddings=130, dropout_rate=0.0)
        kw = dict(combined_model=LineVul(
            enc, dataclasses.replace(cfg, encoder_mode=True), device=cuda,
            seed=seed), tokenizer=HashingCodeTokenizer(512))
        config = ServeConfig(batch_slots=slots, block_size=128)
    engine = ServeEngine(model, config, device=cuda, **kw)
    assert engine.warmup() == len(engine.warm_buckets())
    return engine


def _eager_flush(engine, lane, graphs, slots, ids):
    """The lane's forward op by op on a fresh device copy of the packed
    batch: the host probabilities a replay must equal bit for bit."""
    gb, ids_t = engine._pack(lane, graphs, slots, ids)
    with engine._on_stream():
        return engine._forward(
            lane, gb.to(engine.device),
            None if ids_t is None else ids_t.to(engine.device)).cpu()


def _flush_inputs(engine, lane, n, seed):
    from deepdfa_tpu_torch.data.text import encode_function

    graphs = [engine._normalize_graph(g) for g in synthetic_bigvul(
        n, engine.model.config.feature, seed=seed)]
    ids = []
    if lane == "combined":
        ids = [encode_function(f"int f_{i}(char *p) {{ return p[{i}]; }}",
                               engine.tokenizer, engine.config.block_size)
               for i in range(n)]
    return graphs, ids


@pytest.mark.parametrize("lane,impl,dtype", [
    ("gnn", impl, dtype) for impl in ("persistent", "fused", "band",
                                      "segment")
    for dtype in ("float32", "bfloat16")] + [
    ("combined", "persistent", "float32")])
def test_replay_equals_the_eager_forward_and_counts_its_launches(
        cuda, lane, impl, dtype):
    """Every (lane, bucket) pair is captured once at warmup; a replay
    answers a full batch, and then a partial one in the same bucket, with
    the eager forward's bits; N replays move each launch count by N
    times the eager forward's; nothing is captured after warmup."""
    from deepdfa_tpu_torch.ops import launch_counts, reset_launch_counts

    engine = _serve_engine(cuda, impl, dtype, lane=lane)
    assert engine.graphs_captured == len(engine.warm_buckets())
    assert engine.graph_pool_bytes > 0
    for slots, n_full, n_part in ((16, 16, 3), (4, 4, 1), (1, 1, 1)):
        full = _flush_inputs(engine, lane, n_full, seed=slots)
        part = _flush_inputs(engine, lane, n_part, seed=slots + 100)
        for graphs, ids in (full, part):
            got = engine.forward(lane, graphs, slots, ids)
            want = _eager_flush(engine, lane, graphs, slots, ids)
            assert torch.equal(got, want), (slots, len(graphs))
    graphs, ids = _flush_inputs(engine, lane, 16, seed=5)
    torch.cuda.synchronize()
    reset_launch_counts()
    over0 = engine.model.over_gate_dispatches
    _eager_flush(engine, lane, graphs, 16, ids)
    eager = launch_counts()
    assert any(eager.values())
    reset_launch_counts()
    for _ in range(20):
        engine.forward(lane, graphs, 16, ids)
    assert launch_counts() == {k: 20 * v for k, v in eager.items()}
    assert engine.model.over_gate_dispatches == over0
    assert engine.compiles_after_warmup == 0


def test_a_replica_captures_a_missing_bucket_while_another_serves(cuda):
    """Two replicas on the one card: r1 captures its pairs at its first
    flushes, on its own stream, while r0's thread flushes on its own; both
    answer with one engine's bits."""
    import threading

    from deepdfa_tpu_torch.serve import ServeEngine, ServeFleet

    cfg = FlowGNNConfig(message_impl="persistent")
    model = FlowGNN(cfg, device=cuda, seed=4)
    config = ServeConfig(batch_slots=8)
    graphs = synthetic_bigvul(160, cfg.feature, seed=9)
    single = ServeEngine(model, config, device=cuda)
    single.warmup()
    want = [r["prob"] for r in single.score_sync(graphs)]
    fleet = ServeFleet.build(model, config, n_replicas=2, devices=[cuda])
    r0, r1 = (r.engine for r in fleet.replicas)
    r0.warmup()
    got0 = []

    def serve_r0():
        for g in graphs[:80]:
            got0.append(r0.submit(g))
            r0.pump()
        r0.drain()

    thread = threading.Thread(target=serve_r0)
    thread.start()
    got1 = r1.score_sync(graphs[80:])
    thread.join(timeout=300)
    assert not thread.is_alive()
    assert r1.graphs_captured >= 1 and r1.stats.compiles >= 1
    assert r0.compiles_after_warmup == 0
    assert [h.result["prob"] for h in got0] + [r["prob"] for r in got1] \
        == want


def _segment_case(degrees, masked, shuffle, rng):
    """ids of ``len(degrees)`` buckets and the mask: in bucket order with
    7 masked padding rows (id 0) after them, or all shuffled with a fifth
    of the rows masked; without a mask, no padding."""
    ids = np.repeat(np.arange(len(degrees)), degrees)
    if masked:
        ids = np.concatenate([ids, np.zeros(7, ids.dtype)])
    live = np.arange(len(ids)) < len(ids) - (7 if masked else 0)
    if shuffle:
        perm = rng.permutation(len(ids))
        ids, live = ids[perm], live[perm] & (rng.random(len(ids)) > 0.2)
    return (torch.from_numpy(ids.astype(np.int32)),
            torch.from_numpy(live) if masked else None)


def _segment_rows(n, width, dtype, rng, mask, cuda):
    """The operands of one call on the card: widths 1, 3 and 128 (f32 and
    bf16 16-byte lanes), 129 (one column a lane), "offset" (128 columns
    from a base 4 or 2 bytes past 16-byte alignment: one column a lane)
    and "merged" (the pooling's 256 + 1 in one launch); masked rows
    zero."""
    widths = {"merged": (256, 1), "offset": (128,)}.get(width, (width,))
    parts = []
    for w in widths:
        shape = (n,) if w == 1 else (n, w)
        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                             ).to(dtype)
        if mask is not None:
            x = torch.where(mask if w == 1 else mask[:, None], x, 0.0)
        x = x.to(cuda)
        if width == "offset":
            buf = torch.empty(x.numel() + 1, dtype=dtype, device=cuda)
            x = buf[1:].view(x.shape).copy_(x)
            assert x.is_contiguous() and x.data_ptr() % 16 != 0
        parts.append(x)
    return tuple(parts)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("degrees", [(0, 1, 5), (64, 0, 300), (1,) * 40,
                                     (2, 3, 1000, 7), (0, 1, 2, 3, 1) * 120])
def test_segment_sum_kernel_equals_its_plain_version(cuda, dtype, degrees):
    """``segment_sum_kernel`` (bf16: ``_bf16``) bit for bit its plain
    version, the level loop, at in-degrees from 0 to 1000, one launch a
    call, in both modes: sorted (rows in bucket order, masked padding
    after them: the ids searched as they are) and a plan (rows shuffled,
    masked rows anywhere), at widths 1, 3 and 128, 129, an unaligned base
    and the pooling's merged pair; every lane kind the launcher chose is
    one the case expects (narrow lanes for a few buckets, wide ones for
    the 600, one column a lane where a width or base is not aligned)."""
    from deepdfa_tpu_torch.graphs import segment

    rng = np.random.default_rng(sum(degrees))
    n_seg = len(degrees)
    name = ("segment_sum_kernel_bf16" if dtype == torch.bfloat16
            else "segment_sum_kernel")
    lanes = set()
    for shuffle in (False, True):
        for masked in (False, True):
            ids, mask = _segment_case(degrees, masked, shuffle, rng)
            plan = lambda ids, mask: segment.segment_sum_plan(
                ids, n_seg, mask, indices_are_sorted=not shuffle)
            on_card = plan(ids.to(cuda),
                           None if mask is None else mask.to(cuda))
            for width in (1, 3, 128, 129, "offset", "merged"):
                parts = _segment_rows(len(ids), width, dtype, rng, mask,
                                      cuda)
                want = segment.segment_sum_rows(
                    tuple(x.cpu() for x in parts), plan(ids, mask))
                segment.reset_launch_counts()
                got = segment.segment_sum_rows(parts, on_card)
                torch.cuda.synchronize()
                assert segment.launch_counts()[name] == 1
                for g, w in zip(got, want):
                    assert torch.equal(g.cpu(), w), (shuffle, masked, width)
                kinds = segment.segment_sum_lanes(parts, got)
                assert kinds == _segment_lanes(parts, n_seg), width
                lanes.update(kinds)
    # Every lane kind the cases reach: 16-byte lanes only at 600 buckets,
    # where bf16's even widths all take them; one column a lane for
    # bf16's odd widths and unaligned base (an f32 column is a 4-byte
    # lane of its own).
    assert ("wide" in lanes) == (n_seg >= 512)
    assert ("narrow" in lanes) == (n_seg < 512 or dtype == torch.float32)
    assert ("scalar" in lanes) == (dtype == torch.bfloat16)


def _segment_lanes(parts, n_seg):
    """The lane kind the launcher should give each operand (the outputs
    are fresh, so aligned): 16-byte lanes where the width and base fit
    them and the call has 512 or more such warps, else 4-byte lanes where
    they fit (f32: always), else one column a lane."""
    kinds = []
    for x in parts:
        elem = x.element_size()
        cols = x.numel() // x.shape[0]
        fits = lambda vec: cols % vec == 0 and x.data_ptr() % (vec * elem) == 0
        wide = 16 // elem
        kinds.append("wide" if fits(wide) and n_seg * -(-cols // (32 * wide))
                     >= 512 else "narrow" if fits(4 // elem) else "scalar")
    return tuple(kinds)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["sorted", "plan"])
def test_segment_sum_kernel_replays_its_eager_bits_in_a_cuda_graph(
        cuda, dtype, mode):
    """A CUDA graph captured over one call (the pooling's merged pair over
    a serving batch's node_graph in sorted mode; the segment lane's
    aggregate over its receivers with the plan built inside the capture)
    replays the eager call's bits, on the captured rows and after new rows
    are copied into them."""
    from deepdfa_tpu_torch.graphs import segment

    graphs = synthetic_bigvul(16, FlowGNNConfig().feature, seed=21)
    gb = bucket_batch(ServeConfig(), graphs, 16, SUBKEYS, band=True).to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(5)
    if mode == "sorted":
        assert gb.node_graph_sorted
        plan = lambda: segment.segment_sum_plan(
            gb.node_graph, gb.n_graphs, gb.node_mask,
            indices_are_sorted=True)
        shapes = ((gb.max_nodes, 256), (gb.max_nodes,))
    else:
        plan = lambda: segment.segment_sum_plan(
            gb.receivers, gb.max_nodes, gb.edge_mask)
        shapes = ((gb.max_edges, 128),)
    rows = [torch.randn(s, generator=gen, device=cuda).to(dtype)
            for s in shapes]
    fresh = [torch.randn(s, generator=gen, device=cuda).to(dtype)
             for s in shapes]
    call = lambda: segment.segment_sum_rows(tuple(rows), plan())
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        call()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    for step in range(2):
        graph.replay()
        torch.cuda.synchronize()
        want = call()
        for o, w in zip(out, want):
            assert torch.equal(o, w), step
        for r, f in zip(rows, fresh):
            r.copy_(f)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_segment_lane_builds_one_plan_a_forward_on_the_card(
        cuda, dtype, monkeypatch):
    """FlowGNN's segment lane on the card builds the receivers' plan once
    a forward and hands it to every step: the logits and every
    parameter's gradient equal those of a plan built in each step's call,
    bit for bit."""
    from deepdfa_tpu_torch.graphs import segment
    from deepdfa_tpu_torch.models import flowgnn as pt_flowgnn

    cfg = FlowGNNConfig(message_impl="segment", dtype=dtype)
    graphs = synthetic_bigvul(16, cfg.feature, seed=23)
    gb = batch_graphs(graphs, 16, 2048, 8192, SUBKEYS).to(cuda)
    plans = []
    real_plan = segment.segment_sum_plan

    def counted(*args, **kw):
        plans.append(args[0])
        return real_plan(*args, **kw)

    def run():
        model = FlowGNN(cfg, device=cuda, seed=4)
        logits = model(gb)
        logits.sum().backward()
        return logits.detach(), {n: p.grad.clone()
                                 for n, p in model.named_parameters()
                                 if p.grad is not None}

    monkeypatch.setattr(segment, "segment_sum_plan", counted)
    monkeypatch.setattr(pt_flowgnn, "segment_sum_plan", counted)
    once = run()
    n_once = sum(p is gb.receivers for p in plans)
    monkeypatch.setattr(pt_flowgnn, "segment_sum_plan",
                        lambda *a, **k: None)
    per_call = run()
    n_per_call = sum(p is gb.receivers for p in plans) - n_once
    assert (n_once, n_per_call) == (1, cfg.n_steps)
    assert torch.equal(once[0], per_call[0])
    assert once[1].keys() == per_call[1].keys() and once[1]
    for name, g in once[1].items():
        assert torch.equal(g, per_call[1][name]), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_persistent_forward_on_the_padded_geometry_equals_unpadded(cuda,
                                                                   dtype):
    """The serving bucket's padded cut points (63 groups, the trailing
    ones empty, every block sized for 64 rows) give the unpadded batch's
    bits, in ``persistent_unroll`` and in the served FlowGNN."""
    graphs = synthetic_bigvul(16, FlowGNNConfig().feature, seed=12)
    padded = _serving_adj(graphs).to(cuda)
    plain = _serving_adj(graphs, padded=False).to(cuda)
    assert padded.row_groups.numel() - 1 == 63 > plain.row_groups.numel() - 1
    params = _params(128, cuda, seed=6)
    h = torch.randn(plain.n_tiles * plain.tile, 128,
                    generator=torch.Generator().manual_seed(7)).to(cuda)
    if dtype == torch.bfloat16:
        h = h.to(dtype)
    with torch.inference_mode():
        got = fused_gnn.persistent_unroll(params, h, padded, 5)
        want = fused_gnn.persistent_unroll(params, h, plain, 5)
    assert torch.equal(got, want)
    cfg = FlowGNNConfig(message_impl="persistent",
                        dtype="bfloat16" if dtype == torch.bfloat16
                        else "float32")
    model = FlowGNN(cfg, device=cuda, seed=3).eval()
    batch = bucket_batch(ServeConfig(), graphs, 16, SUBKEYS, band=True)
    with torch.inference_mode():
        a = model(batch.to(cuda))
        b = model(dataclasses.replace(batch, band_adj=plain).to(cuda))
    assert torch.equal(a, b)


def _telemetry_events(run_dir):
    import json
    import os

    with open(os.path.join(run_dir, "telemetry", "events.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def test_a_replayed_flush_is_a_fenced_serve_flush_span(cuda, tmp_path):
    """Under a telemetry run, each flush of a warmed engine (the captured
    graph replayed) is a ``serve.flush`` span fenced by the host copy of
    its probabilities, and each capture a ``serve.compile`` span fenced
    on a CUDA event after ``capture_end``; no capture after warmup."""
    from deepdfa_tpu_torch import telemetry

    with telemetry.run_scope(str(tmp_path)):
        engine = _serve_engine(cuda, "persistent", "float32")
        graphs = synthetic_bigvul(40, engine.model.config.feature, seed=21)
        results = engine.score_sync(graphs)
    assert all("prob" in r for r in results)
    assert engine.compiles_after_warmup == 0
    events = _telemetry_events(str(tmp_path))
    flushes = [e for e in events if e["name"] == "serve.flush"]
    compiles = [e for e in events if e["name"] == "serve.compile"]
    assert len(flushes) == engine.stats.batches >= 3
    assert len(compiles) == engine.graphs_captured == len(
        engine.warm_buckets())
    for span in flushes + compiles:
        assert span["fenced"] and 0 <= span["host_ms"] <= span["dur_ms"]
        assert "error" not in span
    assert [f["attrs"]["ordinal"] for f in flushes] == list(
        range(len(flushes)))
    assert sum(f["attrs"]["n"] for f in flushes) == 40
    assert sum(1 for e in events if e["name"] == "serve.request") == 40


@pytest.mark.parametrize("impl,dtype", [("persistent", "float32"),
                                        ("fused", "bfloat16")])
def test_probabilities_are_bit_for_bit_with_telemetry_on_and_off(
        cuda, tmp_path, impl, dtype):
    from deepdfa_tpu_torch import telemetry

    graphs = synthetic_bigvul(48, FlowGNNConfig().feature, seed=22)
    probs = {}
    for mode in ("off", "on"):
        telemetry.set_enabled(mode == "on")
        try:
            with telemetry.run_scope(str(tmp_path / mode)):
                engine = _serve_engine(cuda, impl, dtype, seed=5)
                probs[mode] = [r["prob"] for r in engine.score_sync(graphs)]
                assert engine.compiles_after_warmup == 0
        finally:
            telemetry.set_enabled(None)
    assert probs["on"] == probs["off"]
    assert not (tmp_path / "off" / "telemetry").exists()
    assert (tmp_path / "on" / "telemetry" / "events.jsonl").exists()


def test_a_fence_asked_for_during_a_capture_raises(cuda):
    """A fence records a CUDA event and waits on it: in a capture that
    would break the graph, so it raises, and the capture is abandoned;
    after capture_end the same fence waits on the stream's work."""
    from deepdfa_tpu_torch import telemetry
    from deepdfa_tpu_torch.telemetry.spans import FenceError

    x = torch.ones(1024, device=cuda)
    stream = torch.cuda.Stream()
    graph = torch.cuda.CUDAGraph()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            y = x * 2
            with pytest.raises(FenceError, match="capturing"):
                with telemetry.span("inside") as sp:
                    sp.fence(y)
        finally:
            graph.capture_end()
        graph.replay()
        with telemetry.span("after") as sp:
            sp.fence(y)
    assert sp.host_s is not None and sp.host_s <= sp.dur_s
    assert torch.equal(y, x * 2)


def test_no_capture_after_warmup_with_a_run_active(cuda, tmp_path):
    """A bursty trace through a warmed engine with a telemetry run: every
    pair was captured at warmup (the compile spans), none after."""
    from deepdfa_tpu_torch import telemetry
    from deepdfa_tpu_torch.serve.replay import bursty_trace, replay

    with telemetry.run_scope(str(tmp_path)):
        engine = _serve_engine(cuda, "persistent", "float32", slots=16)
        from deepdfa_tpu_torch.serve.replay import VirtualClock

        clock = VirtualClock()
        engine._clock = clock
        captured = engine.graphs_captured
        out = replay(engine, bursty_trace(
            120, engine.model.config.feature, seed=1), clock)
    assert out["metrics"]["completed"] == 120
    assert engine.compiles_after_warmup == 0
    assert engine.graphs_captured == captured
    events = _telemetry_events(str(tmp_path))
    warm = [i for i, e in enumerate(events)
            if e["name"] == "serve.warmup_done"]
    assert len(warm) == 1
    assert not [e for e in events[warm[0]:] if e["name"] == "serve.compile"]


def test_healthz_reports_the_cards_bytes_after_a_cpu_sample_telemetry_off(
        cuda, monkeypatch):
    """``/healthz`` on a card's server carries the allocator's bytes in
    use and peak, read through the memory sampler when it is asked: a
    sample of a CPU device earlier in the process and
    ``DEEPDFA_TELEMETRY=0`` take nothing away."""
    import json
    import threading
    import urllib.request

    from deepdfa_tpu_torch import telemetry
    from deepdfa_tpu_torch.serve.http import ServeHTTPServer
    from deepdfa_tpu_torch.telemetry.memory import SAMPLER

    assert SAMPLER.sample(torch.device("cpu")) is None
    monkeypatch.setenv("DEEPDFA_TELEMETRY", "0")
    telemetry.set_enabled(None)
    try:
        engine = _serve_engine(cuda, "persistent", "float32", slots=4)
        server = ServeHTTPServer(("127.0.0.1", 0), engine)
        server.start_pump()
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            url = f"http://127.0.0.1:{server.server_address[1]}/healthz"
            with urllib.request.urlopen(url, timeout=30) as resp:
                health = json.loads(resp.read())
        finally:
            server.shutdown()
            server.server_close()
    finally:
        monkeypatch.delenv("DEEPDFA_TELEMETRY")
        telemetry.set_enabled(None)
    assert 0 < health["device_bytes_in_use"] <= \
        health["device_peak_bytes_in_use"]
    assert health["device_peak_bytes_in_use"] <= \
        torch.cuda.max_memory_allocated(cuda)
