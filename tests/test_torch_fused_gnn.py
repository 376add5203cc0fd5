"""The port's gated-step module (deepdfa_tpu_torch/ops/fused_gnn.py)
against the JAX reference (deepdfa_tpu/ops/fused_gnn.py).

The same numpy inputs go through both packages. The JAX kernels run as
the JAX package's own tests run them on the CPU: the Pallas interpreter
(``impl="interpret"``) and the XLA composition (``impl="xla"``). The
port runs its plain versions, which is what its wrappers take for CPU
tensors. f32 throughout; 1e-5 is the tolerance of
tests/test_fused_gnn.py (one accumulation-order difference), for a step
and its VJP; the K-step VJP compounds it and is held to 1e-4.
"""

import importlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

# The packages' ops/__init__ re-export functions under the module names,
# so the modules are imported by path.
jax_band = importlib.import_module("deepdfa_tpu.ops.band_spmm")
jax_fused = importlib.import_module("deepdfa_tpu.ops.fused_gnn")
pt_band = importlib.import_module("deepdfa_tpu_torch.ops.band_spmm")
pt_fused = importlib.import_module("deepdfa_tpu_torch.ops.fused_gnn")

TOL = dict(rtol=1e-5, atol=1e-5)
BAND_CASES = [(8, 4, 2, 16), (8, 6, 20, 8), (16, 3, 1, 32)]


def _params_np(rng, hidden):
    dense = lambda bias: {
        "kernel": (rng.standard_normal((hidden, hidden)) * 0.2
                   ).astype(np.float32),
        **({"bias": (rng.standard_normal(hidden) * 0.2).astype(np.float32)}
           if bias else {})}
    return {"edge_linear": dense(True),
            "gru": {name: dense(bias) for name, bias in
                    (("ir", True), ("iz", True), ("in", True),
                     ("hr", False), ("hz", False), ("hn", True))}}


def _tree(params, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in params.items()}


def _edges(rng, tile, n_tiles, spread):
    # The edge fixture of tests/test_fused_gnn.py (_band_fixture).
    n = tile * n_tiles
    s = rng.integers(0, n, 6 * n)
    r = np.clip(s + rng.integers(-spread, spread + 1, 6 * n), 0, n - 1)
    return s, r, n


def _case(tile, n_tiles, spread, hidden, seed=0):
    rng = np.random.default_rng(seed)
    s, r, n = _edges(rng, tile, n_tiles, spread)
    mask = np.ones(len(s), bool)
    jadj = jax_band.build_band_adjacency(s, r, mask, n, tile=tile)
    padj = pt_band.build_band_adjacency(s, r, mask, n, tile=tile)
    params = _params_np(rng, hidden)
    h = rng.standard_normal((n, hidden)).astype(np.float32)
    return jadj, padj, params, h


@pytest.mark.parametrize("impl", ["interpret", "xla"])
@pytest.mark.parametrize("tile,n_tiles,spread,hidden", BAND_CASES)
def test_fused_step_matches_jax(tile, n_tiles, spread, hidden, impl):
    jadj, padj, params, h = _case(tile, n_tiles, spread, hidden)
    want = jax_fused.fused_gate_step(_tree(params, jnp.asarray),
                                     jnp.asarray(h), jadj, impl=impl)
    got = pt_fused.fused_step_reference(_tree(params, torch.from_numpy),
                                        torch.from_numpy(h), padj)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("tile,n_tiles,spread,hidden", BAND_CASES[::2])
def test_persistent_matches_jax_interpret(tile, n_tiles, spread, hidden):
    jadj, padj, params, h = _case(tile, n_tiles, spread, hidden, seed=5)
    want = jax_fused.persistent_unroll(_tree(params, jnp.asarray),
                                       jnp.asarray(h), jadj, n_steps=3,
                                       impl="interpret")
    got = pt_fused.persistent_reference(_tree(params, torch.from_numpy),
                                        torch.from_numpy(h), padj, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_packed_weight_layout_matches_jax():
    rng = np.random.default_rng(1)
    params = _params_np(rng, 16)
    want = jax_fused._packed_weights(_tree(params, jnp.asarray), jnp.float32)
    got = pt_fused.packed_weights(_tree(params, torch.from_numpy))
    for name, w, g in zip(("ek", "eb", "wi", "bi", "wh", "bh"), want, got):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    # r|z|n order on the output axis; the recurrent bias is [0, 0, b_hn].
    wh, bh = got[4], got[5]
    np.testing.assert_array_equal(wh[:, 16:32].numpy(),
                                  params["gru"]["hz"]["kernel"])
    np.testing.assert_array_equal(bh[0, :32].numpy(), np.zeros(32))
    np.testing.assert_array_equal(bh[0, 32:].numpy(),
                                  params["gru"]["hn"]["bias"])


@pytest.mark.parametrize("vals_dtype,dt", [
    ("bfloat16", "float32"), ("float32", "bfloat16"),
    ("bfloat16", "bfloat16"), ("float32", "float32")])
def test_vals_upcast_only_rule_matches_jax(vals_dtype, dt):
    vals = np.ones((3, 2, 4, 4), np.float32)
    jadj = jax_band.BandAdjacency(vals=jnp.asarray(vals, vals_dtype), tile=4,
                                  n_tiles=2, bandwidth=1)
    padj = pt_band.BandAdjacency(
        vals=torch.from_numpy(vals).to(getattr(torch, vals_dtype)), tile=4,
        n_tiles=2, bandwidth=1)
    jv, jdt = jax_fused._vals_compute(jadj, jnp.dtype(dt))
    pv, pdt = pt_band.vals_compute(padj, getattr(torch, dt))
    assert str(pdt).split(".")[-1] == jnp.dtype(jdt).name
    assert str(pv.dtype).split(".")[-1] == jv.dtype.name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_band_spmm_matches_jax(dtype):
    rng = np.random.default_rng(2)
    s, r, n = _edges(rng, 8, 5, 12)
    mask = np.ones(len(s), bool)
    jadj = jax_band.build_band_adjacency(s, r, mask, n, tile=8)
    padj = pt_band.build_band_adjacency(s, r, mask, n, tile=8)
    msg = rng.standard_normal((n, 16)).astype(np.float32)
    want = jax_band.band_spmm(jadj, jnp.asarray(msg, dtype))
    got = pt_band.band_spmm(padj, torch.from_numpy(msg).to(
        getattr(torch, dtype)))
    tol = TOL if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def test_cpu_wrappers_take_plain_version_and_count_nothing():
    _, padj, params, h = _case(8, 4, 2, 16)
    tp, th = _tree(params, torch.from_numpy), torch.from_numpy(h)
    g = torch.from_numpy(np.random.default_rng(9).standard_normal(
        h.shape).astype(np.float32))
    pt_fused.reset_launch_counts()
    step = pt_fused.fused_gate_step(tp, th, padj)
    unroll = pt_fused.persistent_unroll(tp, th, padj, 3)
    assert torch.equal(step, pt_fused.fused_step_reference(tp, th, padj))
    assert torch.equal(unroll, pt_fused.persistent_reference(tp, th, padj, 3))
    pairs = [
        (pt_fused.fused_step_backward(tp, th, padj, g),
         pt_fused.fused_step_backward_reference(tp, th, padj, g)),
        (pt_fused.persistent_backward(tp, th, padj, g, 3),
         pt_fused.persistent_backward_reference(tp, th, padj, g, 3)),
        ([pt_fused.persistent_hist(tp, th, padj, 3)],
         [pt_fused.persistent_hist_reference(tp, th, padj, 3)]),
    ]
    for got, want in pairs:
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert pt_fused.launch_counts() == dict.fromkeys(
        ("fused_step_kernel", "persistent_fwd_kernel",
         "fused_step_bwd_kernel", "persistent_fwd_hist_kernel",
         "persistent_bwd_kernel", "step_weight_grad_kernel",
         "fused_step_kernel_bf16", "persistent_fwd_kernel_bf16",
         "fused_step_bwd_kernel_bf16", "step_weight_grad_kernel_bf16",
         "persistent_fwd_hist_kernel_bf16", "persistent_bwd_kernel_bf16"), 0)


def test_non_cpu_tensor_never_takes_the_plain_version():
    # A tensor that is not on the CPU goes to the kernel path, which
    # raises for anything it cannot launch: here a meta tensor, which
    # needs no card. Nothing is counted.
    _, padj, params, h = _case(8, 4, 2, 16)
    tp = _tree(params, lambda a: torch.from_numpy(a).to("meta"))
    th = torch.from_numpy(h).to("meta")
    adj = padj.to("meta")
    pt_fused.reset_launch_counts()
    calls = [
        lambda: pt_fused.fused_gate_step(tp, th, adj),
        lambda: pt_fused.persistent_unroll(tp, th, adj, 3),
        lambda: pt_fused.fused_step_backward(tp, th, adj, th),
        lambda: pt_fused.persistent_backward(tp, th, adj, th, 3),
        lambda: pt_fused.persistent_hist(tp, th, adj, 3),
        lambda: pt_fused.step_weight_grads(th, None, th[None], th[None],
                                           th[None], 1),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="CPU tensors .* or CUDA"):
            call()
    assert sum(pt_fused.launch_counts().values()) == 0


def test_asking_for_cuda_without_cuda_raises(monkeypatch):
    from deepdfa_tpu_torch.core.config import FeatureSpec, FlowGNNConfig
    from deepdfa_tpu_torch.models.flowgnn import FlowGNN

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = FlowGNNConfig(feature=FeatureSpec(limit_all=20, limit_subkeys=20),
                        hidden_dim=4, message_impl="persistent")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FlowGNN(cfg)  # the default device is cuda
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FlowGNN(cfg, device="cuda:0")


def _graph_edges(rng, sizes):
    """Graphs packed contiguously (as batch_graphs packs them), each a
    chain plus a few random in-graph edges and self loops."""
    s, r, off = [], [], 0
    for n in sizes:
        s += list(range(off, off + n - 1)) + list(range(off, off + n))
        r += list(range(off + 1, off + n)) + list(range(off, off + n))
        a = rng.integers(off, off + n, max(1, n // 8))
        b = rng.integers(off, off + n, max(1, n // 8))
        s += list(a)
        r += list(b)
        off += n
    return np.asarray(s), np.asarray(r), off


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_row_groups_are_closed_under_the_edges(seed):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(8, 49, 20)
    s, r, used = _graph_edges(rng, sizes)
    n = 1024
    cuts = pt_band.closed_row_groups(s, r, n)
    assert cuts[0] == 0 and cuts[-1] == n and np.all(np.diff(cuts) > 0)
    group = np.searchsorted(cuts, np.arange(n), side="right") - 1
    assert np.array_equal(group[s], group[r])  # no edge crosses a cut
    # Groups are whole graphs: a graph larger than the target is one
    # group, and no group outgrows its target but by one graph.
    assert np.diff(cuts).max() <= max(pt_band.PERSISTENT_GROUP_ROWS,
                                      int(sizes.max()))
    # The same cut points ride the adjacency built from a padded edge
    # list (masked slots ignored), with the largest group's size.
    pad = 64
    s_pad = np.concatenate([s, np.zeros(pad, np.int64)])
    r_pad = np.concatenate([r, np.full(pad, n - 1, np.int64)])
    mask = np.arange(len(s_pad)) < len(s)
    adj = pt_band.build_band_adjacency(s_pad, r_pad, mask, n)
    assert np.array_equal(adj.row_groups.numpy(), cuts)
    assert adj.row_groups.dtype == torch.int32
    assert adj.max_group_rows == int(np.diff(cuts).max())


def test_row_groups_of_unstructured_edges_still_close():
    rng = np.random.default_rng(4)
    s, r, n = _edges(rng, 8, 6, 20)
    cuts = pt_band.closed_row_groups(s, r, n)
    group = np.searchsorted(cuts, np.arange(n), side="right") - 1
    assert np.array_equal(group[s], group[r])


def test_persistent_shared_memory_gate():
    rng = np.random.default_rng(3)
    s, r, _ = _graph_edges(rng, [40] * 16)
    adj = pt_band.build_band_adjacency(s, r, np.ones(len(s), bool), 1024)
    assert pt_fused.persistent_smem_ok(adj, 128)
    # Three weight-slab stages of 4 k rows of [w_i | w_h], then h and the
    # aggregate at a row stride of 132 floats, then the row sums.
    assert (pt_fused.persistent_smem_bytes(adj, 128)
            == 4 * (3 * 4 * 6 * 128 + 2 * adj.max_group_rows * 132
                    + adj.max_group_rows))
    # One component over 184 rows cannot stay in a block's 227 KB.
    chain = np.arange(600)
    big = pt_band.build_band_adjacency(chain[:-1], chain[1:],
                                       np.ones(599, bool), 640)
    assert big.max_group_rows == 600
    assert not pt_fused.persistent_smem_ok(big, 128)
    no_groups = pt_band.BandAdjacency(vals=adj.vals, tile=adj.tile,
                                      n_tiles=adj.n_tiles, bandwidth=1)
    assert not pt_fused.persistent_smem_ok(no_groups, 128)


# ---------------------------------------------------------------------------
# The backward: the port's plain VJPs against jax.grad of the JAX kernels
# ---------------------------------------------------------------------------


def _jax_packed_grads(grads):
    """The JAX gradient tree in the port's packed layout (the hidden-side
    r/z bias slots of ``bh`` are not parameters and come back as 0)."""
    return [np.asarray(w) for w in jax_fused._packed_weights(grads,
                                                             jnp.float32)]


def _assert_vjp(got, want_h, want_params, hidden, tol):
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want_h), **tol)
    names = ("dek", "deb", "dwi", "dbi", "dwh", "dbh")
    for name, g, w in zip(names, got[1:], _jax_packed_grads(want_params)):
        g = g.numpy()
        if name == "dbh":  # only b_hn is a parameter
            g, w = g[:, 2 * hidden:], w[:, 2 * hidden:]
        np.testing.assert_allclose(g, w, err_msg=name, **tol)


def _vjp_case(tile, n_tiles, spread, hidden, seed):
    jadj, padj, params, h = _case(tile, n_tiles, spread, hidden, seed=seed)
    cot = np.random.default_rng(seed + 100).standard_normal(
        h.shape).astype(np.float32)
    return jadj, padj, params, h, cot


@pytest.mark.parametrize("impl", ["interpret", "xla"])
@pytest.mark.parametrize("tile,n_tiles,spread,hidden", BAND_CASES)
def test_step_vjp_matches_jax_grad(tile, n_tiles, spread, hidden, impl):
    jadj, padj, params, h, cot = _vjp_case(tile, n_tiles, spread, hidden, 3)
    want_p, want_h = jax.grad(
        lambda p, x: jnp.vdot(jax_fused.fused_gate_step(p, x, jadj,
                                                        impl=impl), cot),
        argnums=(0, 1))(_tree(params, jnp.asarray), jnp.asarray(h))
    got = pt_fused.fused_step_backward_reference(
        _tree(params, torch.from_numpy), torch.from_numpy(h), padj,
        torch.from_numpy(cot))
    _assert_vjp(got, want_h, want_p, hidden, TOL)


@pytest.mark.parametrize("impl", ["interpret", "xla"])
@pytest.mark.parametrize("tile,n_tiles,spread,hidden", BAND_CASES[::2])
def test_unroll_vjp_matches_jax_grad(tile, n_tiles, spread, hidden, impl):
    jadj, padj, params, h, cot = _vjp_case(tile, n_tiles, spread, hidden, 4)
    want_p, want_h = jax.grad(
        lambda p, x: jnp.vdot(jax_fused.persistent_unroll(
            p, x, jadj, n_steps=3, impl=impl), cot),
        argnums=(0, 1))(_tree(params, jnp.asarray), jnp.asarray(h))
    got = pt_fused.persistent_backward_reference(
        _tree(params, torch.from_numpy), torch.from_numpy(h), padj,
        torch.from_numpy(cot), 3)
    _assert_vjp(got, want_h, want_p, hidden, dict(rtol=1e-4, atol=1e-4))


@pytest.mark.parametrize("n_steps", [1, 2, 4])
def test_plain_vjps_match_autograd(n_steps):
    # The closed-form VJPs against torch.autograd through the plain
    # forward, the leaf gradients packed as the kernels pack weights.
    _, padj, params, h = _case(8, 5, 12, 8, seed=6)
    tp = _tree(params, lambda a: torch.from_numpy(a).requires_grad_())
    th = torch.from_numpy(h).requires_grad_()
    g = torch.from_numpy(np.random.default_rng(7).standard_normal(
        h.shape).astype(np.float32))
    out = pt_fused.persistent_reference(tp, th, padj, n_steps)
    (out * g).sum().backward()
    want = (th.grad, *pt_fused.packed_weights(_tree(tp, lambda t: t.grad)))
    got = (pt_fused.fused_step_backward_reference(tp, th.detach(), padj, g)
           if n_steps == 1 else pt_fused.persistent_backward_reference(
               tp, th.detach(), padj, g, n_steps))
    for a, b in zip(got[:-1], want[:-1]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    # bh's r|z slots are zeros, not parameters: only b_hn carries a grad.
    torch.testing.assert_close(got[-1][:, 16:], want[-1][:, 16:],
                               rtol=1e-5, atol=1e-5)


def test_persistent_vjp_is_the_fold_of_step_vjps():
    # persistent_backward_reference = the reverse loop of the step VJP
    # over the hist, weight gradients added from step K-1 down to 0.
    _, padj, params, h = _case(8, 4, 2, 16, seed=2)
    tp, th = _tree(params, torch.from_numpy), torch.from_numpy(h)
    g = torch.from_numpy(np.random.default_rng(1).standard_normal(
        h.shape).astype(np.float32))
    hist = pt_fused.persistent_hist_reference(tp, th, padj, 4)
    assert tuple(hist.shape) == (3,) + tuple(th.shape)
    gs, total = g, None
    for s in reversed(range(4)):
        gs, *dw = pt_fused.fused_step_backward_reference(
            tp, th if s == 0 else hist[s - 1], padj, gs)
        total = dw if total is None else [a + b for a, b in zip(total, dw)]
    got = pt_fused.persistent_backward_reference(tp, th, padj, g, 4)
    assert torch.equal(got[0], gs)
    for a, b in zip(got[1:], total):
        assert torch.equal(a, b)
    assert pt_fused.persistent_hist_reference(tp, th, padj, 1).shape[0] == 0


@pytest.mark.parametrize("bandwidth,n_tiles", [(1, 4), (2, 5), (4, 3)])
def test_band_transpose_vals_matches_jax(bandwidth, n_tiles):
    rng = np.random.default_rng(bandwidth)
    vals = rng.standard_normal((2 * bandwidth + 1, n_tiles, 8, 8)).astype(
        np.float32)
    want = jax_fused.band_transpose_vals(jnp.asarray(vals), bandwidth,
                                         n_tiles)
    got = pt_band.band_transpose_vals(torch.from_numpy(vals), bandwidth,
                                      n_tiles)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_transposed_band_aggregates_a_transpose():
    rng = np.random.default_rng(5)
    s, r, n = _edges(rng, 8, 5, 12)
    adj = pt_band.build_band_adjacency(s, r, np.ones(len(s), bool), n, tile=8)
    dense = np.zeros((n, n), np.float32)
    np.add.at(dense, (r, s), 1.0)
    x = rng.standard_normal((n, 4)).astype(np.float32)
    got = pt_band.band_spmm(pt_band.transpose_band(adj), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), dense.T @ x, rtol=1e-5,
                               atol=1e-5)


def test_band_keeps_its_transpose():
    rng = np.random.default_rng(6)
    s, r, n = _edges(rng, 8, 5, 12)
    adj = pt_band.build_band_adjacency(s, r, np.ones(len(s), bool), n, tile=8)
    tv = adj.transpose_vals()
    assert torch.equal(tv, pt_band.band_transpose_vals(adj.vals,
                                                       adj.bandwidth,
                                                       adj.n_tiles))
    # Built once: every backward over the batch reads the same A^T.
    assert adj.transpose_vals() is tv
    assert pt_band.transpose_band(adj).vals is tv
    # A copy on another device builds its own.
    assert adj.to("cpu").transpose_vals() is not tv


def test_persistent_backward_shared_memory_gate():
    rng = np.random.default_rng(3)
    s, r, _ = _graph_edges(rng, [40] * 16)
    adj = pt_band.build_band_adjacency(s, r, np.ones(len(s), bool), 1024)
    assert pt_fused.persistent_bwd_smem_ok(adj, 128)
    # The forward's stages, then three row arrays (the cotangent, h then
    # dx, the aggregate then x then dmsg), then the row sums.
    assert (pt_fused.persistent_bwd_smem_bytes(adj, 128)
            == 4 * (3 * 4 * 6 * 128 + 3 * adj.max_group_rows * 132
                    + adj.max_group_rows))
    # 150 rows fit the forward's two row arrays, not the backward's
    # three: a training batch runs the fused step instead.
    chain = np.arange(150)
    mid = pt_band.build_band_adjacency(chain[:-1], chain[1:],
                                       np.ones(149, bool), 256)
    assert mid.max_group_rows == 150
    assert pt_fused.persistent_smem_ok(mid, 128)
    assert not pt_fused.persistent_bwd_smem_ok(mid, 128)
    no_groups = pt_band.BandAdjacency(vals=adj.vals, tile=adj.tile,
                                      n_tiles=adj.n_tiles, bandwidth=1)
    assert not pt_fused.persistent_bwd_smem_ok(no_groups, 128)


def test_kernel_cost_counts_each_kernel():
    rng = np.random.default_rng(3)
    s, r, _ = _graph_edges(rng, [40] * 16)
    adj = pt_band.build_band_adjacency(s, r, np.ones(len(s), bool), 1024)
    n, hid, k = 1024, 128, 5
    fwd = pt_fused.kernel_cost(adj, hid, k)
    # k launches of fused_step_kernel do the persistent kernel's work and
    # move its bytes (h in and out, the band, the weights) k times.
    persist = pt_fused.kernel_cost(adj, hid, k, "persistent_fwd_kernel")
    assert fwd == dict(persist, bytes=k * persist["bytes"])
    nnz = fwd["nnz"]
    assert nnz == int(np.count_nonzero(adj.vals.float().numpy()))
    step = (2.0 * n * hid * hid + 12.0 * n * hid * hid + 2.0 * nnz * hid
            + 10.0 * n * hid)
    assert fwd["flops"] == k * step
    hist = pt_fused.kernel_cost(adj, hid, k, "persistent_fwd_hist_kernel")
    assert hist["flops"] == (k - 1) * step
    bwd = pt_fused.kernel_cost(adj, hid, k, "persistent_bwd_kernel")
    one = pt_fused.kernel_cost(adj, hid, 1, "fused_step_bwd_kernel")
    assert bwd["flops"] == k * one["flops"] > 2 * k * step
    wg = pt_fused.kernel_cost(adj, hid, k, "step_weight_grad_kernel")
    assert wg["flops"] == k * (14.0 * n * hid * hid + 7.0 * n * hid)
    # The whole VJP: the recompute sweep, K step backwards, K weight
    # contractions; its bytes only what it must move.
    assert fwd["bwd_flops"] == (k - 1) * step + bwd["flops"] + wg["flops"]
    assert fwd["bwd_bytes"] < bwd["bytes"]
    with pytest.raises(ValueError, match="unknown kernel"):
        pt_fused.kernel_cost(adj, hid, k, "nope")
