"""The bf16 gated-step forward on the bf16 tensor cores
(``fused_step_kernel_bf16``, ``persistent_fwd_kernel_bf16`` and its hist
instance, ``csrc/fused_gnn.cu`` on ``csrc/gnn_bf16_mma.cuh``), checked on
the CPU.

The kernels cannot run here, so this file emulates their arithmetic in
plain PyTorch and holds the emulation to the JAX package's bf16 forward
kernels (``_fwd_kernel``, ``_persist_fwd_kernel``) in the Pallas
interpreter, as ``tests/test_torch_bf16_gnn.py`` runs them: every dense
product multiplies two bf16 values and sums in f32 16-deep k-slices in
ascending order (one ``mma.sync`` each; a k block that is no multiple of
16 is padded with zeros, which adds nothing), except that a sum rounded to
bf16 that lies near a rounding midpoint is taken from the reference's
order (one f32 FMA chain over k), and with f32 band values every message
is; each message rounded before the aggregate when the band values are
bf16 (f32 messages otherwise), the aggregate rounded to x, the gate's six
sums apart, each rounded before its bias, then the reference's gate op for
op. Limits: one step within a bf16 step of the element (rtol 2^-7, atol
1e-6: the card's ``GNN_BF16_STEP_TOL``), K steps within 5e-2
(``GNN_BF16_UNROLL_TOL``). The emulated sweep is the emulated scan bit for
bit, as the kernels' is, and every rounded sum rounds as the chain's.

Also the host mirrors the kernels' launches rely on: the bf16 forward
gate ``persistent_smem_ok`` unchanged (three f32 row arrays: 123 rows at
H 128), the sweep's own shared memory within the budget for every group
the gate admits, and the per-step instance's plan and shared memory as
its source's formula gives them.
"""

import dataclasses
import importlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

jax_band = importlib.import_module("deepdfa_tpu.ops.band_spmm")
jax_fused = importlib.import_module("deepdfa_tpu.ops.fused_gnn")
pt_band = importlib.import_module("deepdfa_tpu_torch.ops.band_spmm")
pt_fused = importlib.import_module("deepdfa_tpu_torch.ops.fused_gnn")

BF16 = torch.bfloat16
BUDGET = pt_fused.PERSISTENT_SMEM_BUDGET_BYTES
STEP_TOL = dict(rtol=2.0 ** -7, atol=1e-6)
UNROLL_TOL = dict(rtol=5e-2, atol=5e-2)
# csrc/fused_gnn.cu:kNear: a rounded sum within 16 * 2^-24 ||a|| ||b|| of a
# bf16 rounding midpoint is taken from the reference's chain.
K_NEAR = 16.0 * 2.0 ** -24


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread (``tests/test_torch_bf16_gnn.py``'s reason:
    the first multi-threaded ``torch.exp`` of a process)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _case(hidden, f32_vals, seed=0, tile=16, n_tiles=3, spread=20):
    """Both packages' band adjacencies of one edge list, params at the
    model's init scale and a bf16 h."""
    rng = np.random.default_rng(seed)
    n = tile * n_tiles
    s = rng.integers(0, n, 6 * n)
    r = np.clip(s + rng.integers(-spread, spread + 1, 6 * n), 0, n - 1)
    mask = np.ones(len(s), bool)
    jadj = jax_band.build_band_adjacency(s, r, mask, n, tile=tile)
    padj = pt_band.build_band_adjacency(s, r, mask, n, tile=tile)
    if f32_vals:
        jadj = jax_band.cast_band(jadj, jnp.float32)
        padj = dataclasses.replace(padj, vals=padj.vals.float())
    std = hidden ** -0.5
    dense = lambda bias: {
        "kernel": (rng.standard_normal((hidden, hidden)) * std
                   ).astype(np.float32),
        **({"bias": (rng.standard_normal(hidden) * std).astype(np.float32)}
           if bias else {})}
    params = {"edge_linear": dense(True),
              "gru": {name: dense(bias) for name, bias in
                      (("ir", True), ("iz", True), ("in", True),
                       ("hr", False), ("hz", False), ("hn", True))}}
    h = jnp.asarray(rng.standard_normal((n, hidden)).astype(np.float32)
                    ).astype(jnp.bfloat16)
    return jadj, padj, params, h, torch.from_numpy(_f32(h)).to(BF16)


def _tree(params, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in params.items()}


# ---------------------------------------------------------------------------
# The kernels' arithmetic in plain PyTorch
# ---------------------------------------------------------------------------


def _mm(a, b):
    """``a @ b`` of bf16 values (f32 tensors) as ``gnnmma::product`` sums
    it: the k space padded to a multiple of 16 with zeros, 16-deep slices
    in ascending order, each slice's f32 sum added into one f32
    accumulator that starts at 0."""
    k = a.shape[1]
    kp = -(-k // 16) * 16
    a = torch.nn.functional.pad(a, (0, kp - k))
    b = torch.nn.functional.pad(b, (0, 0, 0, kp - k))
    acc = torch.zeros(a.shape[0], b.shape[1])
    for k0 in range(0, kp, 16):
        acc = acc + a[:, k0:k0 + 16] @ b[k0:k0 + 16]
    return acc


def _chain(a, b):
    """``a @ b`` of bf16 values as the reference's order sums it (the f32
    kernels', cuBLAS's for the plain versions on the card, the kernels'
    ``chain_dot``): one f32 FMA chain over k ascending from 0 (a product
    of two bf16 values is exact in f32, so each add rounds once, as an
    FMA)."""
    acc = torch.zeros(a.shape[0], b.shape[1])
    for k in range(a.shape[1]):
        acc = acc + a[:, k:k + 1] * b[k:k + 1]
    return acc


def _rounded_sum(a, b):
    """A sum that the step rounds to bf16, as the kernels take it: the
    16-deep slices' sum (:func:`_mm`), or the chain's where a rounding
    midpoint lies within ``kNear ||a|| ||b||`` of it
    (``csrc/fused_gnn.cu``: ``near_midpoint``, ``chain_dot``). Also the
    mask of the sums taken from the chain."""
    rnd = pt_fused.round_bf16
    v = _mm(a, b)
    e = (K_NEAR * torch.linalg.vector_norm(a, dim=1)[:, None]
         * torch.linalg.vector_norm(b, dim=0)[None])
    near = rnd(v - e) != rnd(v + e)
    return torch.where(near, _chain(a, b), v), near


def _emulated_step(packed, h, adj, groups=None):
    """One step as ``fused_step_kernel_bf16`` computes it: the messages
    (bf16 band values: :func:`_rounded_sum`, then ``edge_msg_bf16``'s
    rounding and rounded bias add; f32: the chain, then the bias), the
    aggregate rounded to x, the six gate sums apart (:func:`_rounded_sum`
    of each block), each rounded, its bias added and rounded, then the
    reference's bf16 gate op for op (``gate_out_bf16``). ``groups``
    (row cut points): the dense products taken one closed row group at a
    time, as ``persistent_fwd_kernel_bf16``'s blocks take them."""
    hid = h.shape[1]
    rnd = pt_fused.round_bf16
    ek, eb, wi, bi, wh, bh = (w.to(BF16).float() for w in packed)
    cuts = list(groups) if groups is not None else [0, h.shape[0]]

    def by_group(fn, a, w):
        return torch.cat([fn(a[g0:g1], w) for g0, g1 in zip(cuts[:-1],
                                                             cuts[1:])])

    rounded = lambda a, w: by_group(lambda x, y: _rounded_sum(x, y)[0], a, w)
    hf = h.float()
    if pt_fused.msg_dtype(adj, BF16) == BF16:
        msg = rnd(rnd(rounded(hf, ek)) + eb).to(BF16)
    else:
        msg = by_group(_chain, hf, ek) + eb
    x = pt_band.band_spmm(adj, msg).to(BF16)
    blocks = lambda w, a: torch.cat([
        rounded(a, w[:, j * hid:(j + 1) * hid]) for j in range(3)], dim=1)
    gi = rnd(rnd(blocks(wi, x.float())) + bi).to(BF16)
    gh = rnd(rnd(blocks(wh, hf)) + bh).to(BF16)
    return pt_fused.gru_bf16(gi, gh, h)


def _emulated_sweep(packed, h, adj, n_steps, hist=False):
    """The persistent kernel: the step on each closed row group's rows
    (``adj.row_groups``) ``n_steps`` times; ``hist``: the states after
    each step, as the kHist instance writes them."""
    states = []
    for _ in range(n_steps):
        h = _emulated_step(packed, h, adj, adj.row_groups.tolist())
        states.append(h)
    return torch.stack(states) if hist else h


# (hidden, f32 band values): H 32, H 36 (no multiple of 16: the kernels pad
# k and the rows' columns with zeros) and H 128 (the model's width), bf16
# and f32 messages; one step against _fwd_kernel, three against
# _persist_fwd_kernel.
CASES = [(h, f) for h in (32, 36, 128) for f in (False, True)]


@pytest.mark.parametrize("hidden,f32_vals", CASES)
def test_emulated_step_matches_the_reference_kernel(hidden, f32_vals):
    jadj, padj, params, jh, ph = _case(hidden, f32_vals)
    want = jax_fused.fused_gate_step(_tree(params, jnp.asarray), jh, jadj,
                                     impl="interpret")
    packed = pt_fused.packed_weights(_tree(params, torch.from_numpy))
    got = _emulated_step(packed, ph, padj)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), **STEP_TOL)
    # The plain version (the same rounding points, sums in another order):
    # the card's rule too.
    plain = pt_fused.fused_step_reference(_tree(params, torch.from_numpy),
                                          ph, padj)
    np.testing.assert_allclose(_f32(got), _f32(plain), **STEP_TOL)


@pytest.mark.parametrize("hidden,f32_vals", CASES)
def test_emulated_sweep_matches_the_reference_kernel(hidden, f32_vals):
    jadj, padj, params, jh, ph = _case(hidden, f32_vals, seed=1)
    steps = 3
    want = jax_fused.persistent_unroll(_tree(params, jnp.asarray), jh, jadj,
                                       steps, impl="interpret")
    packed = pt_fused.packed_weights(_tree(params, torch.from_numpy))
    got = _emulated_sweep(packed, ph, padj, steps)
    assert got.dtype == BF16
    np.testing.assert_allclose(_f32(got), _f32(want), **UNROLL_TOL)
    np.testing.assert_allclose(
        _f32(got), _f32(pt_fused.persistent_reference(
            _tree(params, torch.from_numpy), ph, padj, steps)), **UNROLL_TOL)


@pytest.mark.parametrize("hidden", [32, 36, 128])
def test_near_midpoint_sums_round_as_the_chain(hidden):
    """The exactness rule: every gate and message sum of a step rounds to
    bf16 as the reference's chain does, the 16-deep slices' sum where no
    midpoint is near and the chain where one is; and the chain is needed
    for few sums (under 4 %), while the slices' sum alone rounds some
    elsewhere (so the rule is what makes them agree)."""
    _, padj, params, _, ph = _case(hidden, False, seed=3, n_tiles=8)
    ek, eb, wi, bi, wh, bh = (
        w.to(BF16).float()
        for w in pt_fused.packed_weights(_tree(params, torch.from_numpy)))
    rnd = pt_fused.round_bf16
    hf = ph.float()
    x = pt_band.band_spmm(padj, rnd(rnd(_chain(hf, ek)) + eb).to(BF16)
                          ).float()
    flips = near_total = total = 0
    for a, w in ((hf, ek), (x, wi), (hf, wh)):
        got, near = _rounded_sum(a, w)
        want = _chain(a, w)
        assert torch.equal(rnd(got), rnd(want))
        flips += int((rnd(_mm(a, w)) != rnd(want)).sum())
        near_total += int(near.sum())
        total += near.numel()
    assert near_total < 0.04 * total
    assert flips > 0 or hidden < 128


@pytest.mark.parametrize("hidden,f32_vals", [(36, False), (128, True)])
def test_emulated_sweep_is_the_emulated_scan(hidden, f32_vals):
    """The sweep's and the hist instance's bits are the per-step scan's:
    a closed group's rows through the step one group at a time (each
    product element depends on its own row; the norms are a row's and a
    column's) give what the step over all rows gives, and the hist sweep
    writes the states the scan passes through."""
    rng = np.random.default_rng(2)
    sizes, s, r, off = [20, 15, 30, 13, 18], [], [], 0
    for size in sizes:  # chains with a few extra edges, whole graphs
        s += list(range(off, off + size - 1)) + list(rng.integers(
            off, off + size, 4))
        r += list(range(off + 1, off + size)) + list(rng.integers(
            off, off + size, 4))
        off += size
    padj = pt_band.build_band_adjacency(np.array(s), np.array(r),
                                        np.ones(len(s), bool), 128, tile=32)
    if f32_vals:
        padj = dataclasses.replace(padj, vals=padj.vals.float())
    assert len(padj.row_groups) > 3
    _, _, params, _, _ = _case(hidden, f32_vals, seed=2)
    packed = pt_fused.packed_weights(_tree(params, torch.from_numpy))
    ph = torch.from_numpy(rng.standard_normal((128, hidden)).astype(
        np.float32)).to(BF16)
    steps = 4
    scan = [ph]
    for _ in range(steps):
        scan.append(_emulated_step(packed, scan[-1], padj))
    assert torch.equal(_emulated_sweep(packed, ph, padj, steps), scan[-1])
    assert torch.equal(_emulated_sweep(packed, ph, padj, steps - 1,
                                       hist=True), torch.stack(scan[1:-1]))


# ---------------------------------------------------------------------------
# The host mirrors of the launches
# ---------------------------------------------------------------------------


def _chain_band(rows):
    """A band whose largest closed group is a chain of ``rows`` rows."""
    s = np.arange(rows - 1)
    n = -(-max(rows, 512) // 128) * 128
    return pt_band.build_band_adjacency(s, s + 1, np.ones(rows - 1, bool),
                                        n, tile=128)


def _sweep_smem(rows, hidden):
    """``csrc/fused_gnn.cu:persistent_fwd_bf16_smem`` written out: the
    forward's ring (two stages of the gate's six [16, hp + 8] bf16 slabs),
    then h and x (bf16) and the messages (f32-sized) of the group padded
    to 16 rows at a row stride of hp + 8, the row sums and x's and h's row
    norms, the weights' 7H column norms (f32)."""
    hp = -(-hidden // 16) * 16
    ld = hp + 8
    rp = -(-rows // 16) * 16
    return 2 * 6 * 16 * ld * 2 + 8 * rp * ld + 12 * rp + 28 * hidden


@pytest.mark.parametrize("hidden", [128, 124, 100, 96, 64, 36, 32, 4])
def test_bf16_forward_gate_unchanged_and_the_sweep_fits(hidden):
    """``persistent_smem_ok`` at bf16 counts three f32 row arrays at the
    persistent kernels' stride with three stages of four k rows, as
    before the tensor-core sweep: 123 rows at H 128 admitted, 124
    refused; every admitted group fits the sweep's own shared memory (the
    largest at each width is the one that counts)."""
    hp = pt_fused.persistent_row_stride(hidden) - 4
    gate = lambda rows: 4 * (3 * 4 * 6 * hp + 3 * rows * (hp + 4) + rows)
    largest = max(r for r in range(1, 600) if gate(r) <= BUDGET)
    if hidden == 128:
        assert largest == 123
    assert pt_fused.GNN_BF16_FWD_RING_STAGES == 2
    for rows in (48, 123, 124, largest, largest + 1):
        adj = _chain_band(rows)
        assert adj.max_group_rows == rows
        ok = pt_fused.persistent_smem_ok(adj, hidden, BF16)
        assert ok == (rows <= largest)
        assert pt_fused.persistent_smem_bytes(adj, hidden, 1, BF16) == (
            gate(rows))
        assert pt_fused.persistent_fwd_bf16_smem_bytes(adj, hidden) == (
            _sweep_smem(rows, hidden))
        if ok:
            assert _sweep_smem(rows, hidden) <= BUDGET
    assert _sweep_smem(48, 128) == 108_608
    assert _sweep_smem(123, 128) == 196_608


def test_bf16_forward_runs_one_block_a_group():
    """No cluster for the bf16 sweeps at any batch: the serving bucket's
    34 groups of up to 48 rows, where the f32 kernel takes 2-block
    clusters, get one block each."""
    cuts = torch.arange(35, dtype=torch.int32) * 30
    adj = pt_band.BandAdjacency(vals=torch.zeros(3, 1, 1, 1),
                                row_groups=cuts, max_group_rows=30)
    assert pt_fused.persistent_cluster_size(adj, 128, 132) == 2
    assert pt_fused.persistent_cluster_size(adj, 128, 132, BF16) == 1


def _step_smem(rt, hidden, fwd_pass):
    """``csrc/fused_gnn.cu:step_bf16_smem`` written out: the forward's ring
    (two stages), then pass 0: h as a bf16 tile and its row norms (f32);
    pass 1: h and x (bf16), the messages (f32-sized), the row sums and x's
    and h's row norms; then the weights' 7H column norms (f32)."""
    hp = -(-hidden // 16) * 16
    ld = hp + 8
    ring = 2 * 6 * 16 * ld * 2
    return ring + (rt * ld * 2 + 4 * rt if fwd_pass == 0
                   else rt * ld * 8 + 12 * rt) + 28 * hidden


@pytest.mark.parametrize("hidden", [128, 100, 36, 32])
@pytest.mark.parametrize("n_rows", [1024, 8192, 16384])  # serving, flagship,
def test_bf16_forward_step_plan_and_shared_memory(n_rows, hidden):  # train
    """``step_plan``/``step_smem_bytes`` of ``fused_step_kernel_bf16`` at
    the serving, flagship and training row counts: the bf16 backward's
    row tiles (16 rows at serving, where 32-row tiles leave SMs idle), no
    cluster, the ring's 16 k rows, and each pass's shared memory as the
    kernel's formula gives it, two blocks an SM on an H100."""
    kernel = "fused_step_kernel_bf16"
    plan = pt_fused.step_plan(n_rows, hidden, 132, kernel)
    rt = 16 if n_rows == 1024 else 32
    assert plan == dict(row_tile=rt, cluster=1, slab_rows=16,
                        blocks=-(-n_rows // rt), wide=False)
    assert plan == pt_fused.step_plan(n_rows, hidden, 132,
                                      "fused_step_bwd_kernel_bf16")
    for p in range(2):
        smem = pt_fused.step_smem_bytes(n_rows, hidden, 132, kernel, p)
        assert smem == _step_smem(rt, hidden, p)
        assert 2 * (smem + 1024) <= 228 * 1024
