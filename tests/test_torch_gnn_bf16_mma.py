"""The bf16 gated-step backward on the bf16 tensor cores
(``fused_step_bwd_kernel_bf16``, ``persistent_bwd_kernel_bf16``,
``csrc/gnn_bf16_mma.cuh``), checked on the CPU.

The kernels cannot run here, so this file emulates their arithmetic in
plain PyTorch and holds the emulation to the JAX package's bf16 backward
kernels (``_bwd_kernel``, ``_persist_bwd_kernel``) in the Pallas
interpreter, as ``tests/test_torch_bf16_train.py`` and
``tests/test_torch_bf16_persistent_train.py`` run them: every dense
product multiplies two bf16 values and sums in f32 16-deep k-slices in
ascending order (one ``mma.sync`` each; a k block that is no multiple of
16 is padded with zeros, which adds nothing), the gate's six sums apart,
``dp`` rounded to bf16 as it is loaded, and with f32 band values (f32
messages) ``dmsg W_e^T`` as ``split_bf16x3``'s three parts, the smallest
first. Limits: one step's ``dh`` and weight gradients within one bf16
step of the element plus half a step at the tensor's scale (the card's
``_close_bf16_bwd`` rule); a K-step sweep's within 5e-2 (its
``SWEEP_TOL``).

Also the host mirrors the kernels' launches rely on: the bf16 backward
gate ``persistent_bwd_smem_ok`` unchanged (four f32 row arrays: 92 rows
at H 128), the sweep's own shared memory within every admitted group's
budget, and the per-step instance's plan and shared memory as its
source's formula gives them.
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
from deepdfa_tpu_torch.ops.attention import split_bf16x3

BF16 = torch.bfloat16
BUDGET = pt_fused.PERSISTENT_SMEM_BUDGET_BYTES
STEP_RULE = (2.0 ** -7, 2.0 ** -8)  # one bf16 step + half a step at scale
SWEEP_RULE = (5e-2, 5e-2)


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


def _close(got, want, rule):
    rtol, scale = rule
    a, b = _f32(got), _f32(want)
    assert a.shape == b.shape and np.isfinite(a).all()
    limit = rtol * np.abs(b) + scale * np.abs(b).max() + 1e-6
    assert (np.abs(a - b) <= limit).all(), float(np.abs(a - b).max())


def _case(hidden, f32_vals, seed=0, tile=16, n_tiles=3, spread=20):
    """Both packages' band adjacencies of one edge list (bandwidth 2),
    params at the model's init scale, a bf16 h and a bf16 cotangent."""
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
    h, g = (jnp.asarray(rng.standard_normal((n, hidden)).astype(np.float32)
                        ).astype(jnp.bfloat16) for _ in range(2))
    return (jadj, padj, params, h, torch.from_numpy(_f32(h)).to(BF16), g,
            torch.from_numpy(_f32(g)).to(BF16))


def _tree(params, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in params.items()}


def _packed_grads(dparams):
    """A JAX parameter-tree gradient in the packed layout (dek, deb, dwi,
    dbi, dwh, dbh_n)."""
    g = dparams["gru"]
    cat = lambda names, key: np.concatenate([np.asarray(g[k][key])
                                             for k in names], -1)
    return [np.asarray(dparams["edge_linear"]["kernel"]),
            np.asarray(dparams["edge_linear"]["bias"])[None],
            cat(("ir", "iz", "in"), "kernel"),
            cat(("ir", "iz", "in"), "bias")[None],
            cat(("hr", "hz", "hn"), "kernel"),
            np.asarray(g["hn"]["bias"])[None]]


# ---------------------------------------------------------------------------
# The kernels' arithmetic in plain PyTorch
# ---------------------------------------------------------------------------


def _mm(a_parts, b, hid, blocks=1):
    """``a @ b`` as the kernels sum it: ``a_parts`` the A operand's bf16
    parts (one, or ``split_bf16x3``'s three, smallest last), f32 values;
    per k block of ``hid`` rows (``blocks`` of them), 16-deep slices in
    ascending order, each part's slice an f32 sum added into one f32
    accumulator, the smallest part first."""
    acc = torch.zeros(a_parts[0].shape[0], b.shape[1])
    for blk in range(blocks):
        for k0 in range(0, hid, 16):
            sl = slice(blk * hid + k0, blk * hid + min(k0 + 16, hid))
            for part in reversed(a_parts):
                acc = acc + part[:, sl] @ b[sl]
    return acc


def _emulated_rows(packed, h, adj, g):
    """One step's ``(dh, x, dp, dmsg)`` as ``fused_step_bwd_kernel_bf16``
    computes them: ``_bwd_rows_bf16``'s rounding points and gate
    cotangents, each dense product by :func:`_mm`."""
    hid = h.shape[1]
    rnd = pt_fused.round_bf16
    round_msg = pt_fused.msg_dtype(adj, BF16) == BF16
    ek, eb, wi, bi, wh, bh = (w.to(BF16).float() for w in packed)
    hf, gf = h.float(), g.float()
    acc = _mm([hf], ek, hid)
    msg = rnd(rnd(acc) + eb).to(BF16) if round_msg else acc + eb
    x = pt_band.band_spmm(adj, msg).to(BF16)
    gi = rnd(rnd(_mm([x.float()], wi, hid)) + bi)
    gh = rnd(rnd(_mm([hf], wh, hid)) + bh)
    r = pt_fused._sigmoid_unrounded((gi[:, :hid] + gh[:, :hid]).to(BF16))
    z = pt_fused._sigmoid_unrounded(
        (gi[:, hid:2 * hid] + gh[:, hid:2 * hid]).to(BF16))
    pre_hn = gh[:, 2 * hid:]
    n = torch.tanh(rnd(gi[:, 2 * hid:] + rnd(rnd(r) * pre_hn)))
    dz = gf * (hf - n)
    dn = gf * (1.0 - z)
    dhc = gf * z
    dpre_n = dn * (1.0 - n * n)
    dpre_hn = dpre_n * r
    dpre_r = dpre_n * pre_hn * r * (1.0 - r)
    dpre_z = dz * z * (1.0 - z)
    dp = torch.cat([dpre_r, dpre_z, dpre_n, dpre_hn], dim=1)
    dpi_c, dph_c = pt_fused._dpre_operands(dp, hid)
    dx = _mm([dpi_c], wi.T, hid, 3)
    dhl = dhc + _mm([dph_c], wh.T, hid, 3)
    if round_msg:
        dx = rnd(dx)
    dmsg = pt_band.band_spmm(pt_band.transpose_band(adj), dx)
    parts = ([rnd(dmsg)] if round_msg
             else [p.float() for p in split_bf16x3(dmsg)])
    dh = (dhl + _mm(parts, ek.T, hid)).to(BF16)
    return dh, x, dp, dmsg


def _emulated_backward(packed, h0, adj, g, n_steps):
    """The K-step VJP as the kernels compute it: the hist (the bf16
    forward instances' plain version), the reverse scan of
    :func:`_emulated_rows`, the weight pass's plain version."""
    hist = pt_fused.persistent_hist_reference(None, h0, adj, n_steps,
                                              packed)
    xs, dps, dmsgs = [None] * n_steps, [None] * n_steps, [None] * n_steps
    for s in reversed(range(n_steps)):
        hs = h0 if s == 0 else hist[s - 1]
        g, xs[s], dps[s], dmsgs[s] = _emulated_rows(packed, hs, adj, g)
    return (g, *pt_fused.step_weight_grad_reference(
        h0, hist, torch.stack(xs), torch.stack(dps), torch.stack(dmsgs),
        n_steps, pt_fused.msg_dtype(adj, BF16)))


# (hidden, f32 band values, steps): H 32 and H 36 (no multiple of 16: the
# kernels pad k and the rows' columns with zeros), bf16 and f32 messages;
# one step against _bwd_kernel, a sweep against _persist_bwd_kernel.
CASES = [(32, False, 1), (36, True, 1), (36, False, 3), (32, True, 2)]


@pytest.mark.parametrize("hidden,f32_vals,steps", CASES)
def test_emulated_kernels_match_the_reference_backward(hidden, f32_vals,
                                                       steps):
    jadj, padj, params, jh, ph, jg, pg = _case(hidden, f32_vals)
    jp = _tree(params, jnp.asarray)

    @jax.jit
    def vjp(p, h, g):
        if steps == 1:
            fn = lambda p, h: jax_fused.fused_gate_step(p, h, jadj,
                                                        impl="interpret")
        else:
            fn = lambda p, h: jax_fused.persistent_unroll(
                p, h, jadj, steps, impl="interpret")
        return jax.vjp(fn, p, h)[1](g)

    dparams, want_dh = vjp(jp, jh, jg)
    packed = pt_fused.packed_weights(_tree(params, torch.from_numpy))
    got = _emulated_backward(packed, ph, padj, pg, steps)
    rule = STEP_RULE if steps == 1 else SWEEP_RULE
    # Against the plain version (the same rounding points, sums in another
    # order): the card's rule.
    for a, b in zip(got, pt_fused.persistent_backward_reference(
            None, ph, padj, pg, steps, packed)):
        assert a.dtype == b.dtype
        _close(a, b, rule)
    dh, *dw = got
    assert dh.dtype == BF16
    _close(dh, want_dh, rule)
    dw[5] = dw[5][:, 2 * hidden:]  # b_hn: the packed r|z zeros are no param
    for a, b in zip(dw, _packed_grads(dparams)):
        assert a.dtype == torch.float32
        _close(a, b, rule)


def test_emulated_split_is_the_f32_product():
    """With f32 messages the kernels' three bf16 parts of dmsg against
    W_e^T's bf16 values give the f32 product (each part's product exact,
    the parts summing to dmsg): within f32 rounding of the plain
    version's ``dmsg @ W_e^T``."""
    rng = np.random.default_rng(3)
    dmsg = torch.from_numpy(rng.standard_normal((48, 36)).astype(np.float32))
    ekT = torch.from_numpy(rng.standard_normal((36, 36)).astype(np.float32)
                           ).to(BF16).float()
    parts = [p.float() for p in split_bf16x3(dmsg)]
    assert torch.equal(parts[0] + parts[1] + parts[2], dmsg)
    got = _mm(parts, ekT, 36)
    want = (dmsg.double() @ ekT.double()).float()
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    # One part alone (dmsg rounded to bf16, the bf16 messages' operand)
    # would not be.
    one = _mm(parts[:1], ekT, 36)
    assert float((one - want).abs().max()) > 1e-3 * float(want.abs().max())


# ---------------------------------------------------------------------------
# The host mirrors of the launches
# ---------------------------------------------------------------------------


def _chain(rows):
    """A band whose largest closed group is a chain of ``rows`` rows."""
    s = np.arange(rows - 1)
    return pt_band.build_band_adjacency(s, s + 1, np.ones(rows - 1, bool),
                                        512, tile=128)


@pytest.mark.parametrize("hidden", [128, 124, 96, 64, 36, 32, 4])
def test_bf16_backward_gate_unchanged_and_the_sweep_fits(hidden):
    """``persistent_bwd_smem_ok`` at bf16 counts four f32 row arrays at
    the persistent kernels' stride with three stages of four k rows, as
    before the tensor-core sweep: 92 rows at H 128 admitted, 93 refused;
    every admitted group fits the sweep's own shared memory too (the
    largest at each width is the one that counts)."""
    hp = pt_fused.persistent_row_stride(hidden) - 4
    gate = lambda rows: 4 * (3 * 4 * 6 * hp + 4 * rows * (hp + 4) + rows)
    largest = max(r for r in range(1, 400) if gate(r) <= BUDGET)
    if hidden == 128:
        assert largest == 92
    for rows in (48, 92, 93, largest, largest + 1):
        adj = _chain(rows)
        assert adj.max_group_rows == rows
        ok = pt_fused.persistent_bwd_smem_ok(adj, hidden, BF16)
        assert ok == (rows <= largest)
        assert pt_fused.persistent_bwd_smem_bytes(adj, hidden, BF16) == (
            gate(rows))
        if ok:
            assert pt_fused.persistent_bwd_bf16_smem_bytes(adj,
                                                           hidden) <= BUDGET
    assert pt_fused.persistent_bwd_bf16_smem_bytes(_chain(48), 128) == (
        111_808)  # two blocks an SM
    assert pt_fused.persistent_bwd_bf16_smem_bytes(_chain(92), 128) == (
        183_168)


def _step_bf16_smem(rt, hidden, bwd_pass):
    """``csrc/fused_gnn_bwd.cu:step_bwd_bf16_smem`` written out: the
    weight stage (one, six [16, hp + 8] bf16 slabs), then pass 0:
    h as a bf16 tile; pass 1: the f32 cotangent, then the larger of h, x
    (bf16) and the messages (f32-sized) and the dp rows (a pass of
    ``16 * (8 // ceil(hp / 32))`` rows at most, [4 hp + 8] bf16), the row
    sums; pass 2: dx (f32-sized), dmsg (f32), the row sums."""
    hp = -(-hidden // 16) * 16
    ld = hp + 8
    ring = 6 * 16 * ld * 2
    if bwd_pass == 0:
        return ring + rt * ld * 2
    if bwd_pass == 2:
        return ring + rt * ld * 8 + 4 * rt
    dp_rows = min(-(-rt // 16) * 16, 16 * (8 // -(-hp // 32)))
    return (ring + rt * ld * 4 + max(rt * ld * 8, dp_rows * (4 * hp + 8) * 2)
            + 4 * rt)


@pytest.mark.parametrize("hidden", [128, 36, 32])
@pytest.mark.parametrize("n_rows", [1024, 8192, 16384])  # serving, flagship,
def test_bf16_backward_step_plan_and_shared_memory(n_rows, hidden):  # train
    """``step_plan``/``step_smem_bytes`` of ``fused_step_bwd_kernel_bf16``
    at the serving, flagship and training row counts: the f32 backward's
    row tiles (16 rows at serving, where 32-row tiles leave SMs idle),
    the ring's 16 k rows, and each pass's shared memory as the kernel's
    formula gives it, two blocks an SM on an H100."""
    kernel = "fused_step_bwd_kernel_bf16"
    plan = pt_fused.step_plan(n_rows, hidden, 132, kernel)
    rt = 16 if n_rows == 1024 else 32
    assert plan == dict(row_tile=rt, cluster=1, slab_rows=16,
                        blocks=-(-n_rows // rt), wide=False)
    for p in range(3):
        smem = pt_fused.step_smem_bytes(n_rows, hidden, 132, kernel, p)
        assert smem == _step_bf16_smem(rt, hidden, p)
        assert 2 * (smem + 1024) <= 228 * 1024
