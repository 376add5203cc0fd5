"""The bf16 weight pass on the bf16 tensor cores
(``step_weight_grad_kernel_bf16``, ``csrc/fused_gnn_bwd.cu``), checked on
the CPU.

The kernel cannot run here, so this file emulates its arithmetic in plain
PyTorch and holds the emulation to the JAX package's bf16 weight
gradients: ``jax.vjp`` of ``fused_gate_step`` (one step) and of
``persistent_unroll`` (K steps) with the kernels in the Pallas
interpreter, as ``tests/test_torch_bf16_train.py`` and
``tests/test_torch_bf16_persistent_train.py`` run them. The kernel's
arithmetic: each gradient ``L^T R`` multiplies bf16 values (``x`` or
``h``, and ``dpre`` rounded to bf16, ``dmsg`` rounded when the messages
are bf16) and sums in f32 16-deep row slices in ascending order within a
split, one ``mma.sync`` each; with f32 messages ``dmsg`` is split three
ways (``split_bf16x3``) and each slice adds the smallest part first; the
splits are added in order into each step's sum and the steps from K-1
down to 0; the bias gradients sum the unrounded f32 columns. Limits, the
bf16 training tests' own: each gradient within 1e-5 of its largest entry
for one step (``GRAD_REL``) and 5e-4 for K steps (``GRAD_REL_K``: a
cotangent one bf16 step apart in a later step moves the earlier steps'
sums, as ``tests/test_torch_bf16_persistent_train.py`` measures); the
emulation within 1e-5 of the plain version on the same cotangents.

Also the host mirrors the launch relies on: the bf16 instance's splits,
from the row count and width alone (so a one-step and a K-step call cut
the rows alike), filling the card's resident blocks; its shared memory
within a block's 227 KB and its blocks an SM within the SM's 228 KB; the
mirrors equal to the source's constants.
"""

import dataclasses
import importlib
import inspect
import os
import re

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
GRAD_REL = 1e-5
GRAD_REL_K = 5e-4
K = 3
SOURCE = os.path.join(os.path.dirname(pt_fused.__file__), os.pardir, "csrc",
                      "fused_gnn_bwd.cu")
BLOCK_SMEM = pt_fused.PERSISTENT_SMEM_BUDGET_BYTES  # 227 KB a block
SM_SMEM = 233_472  # 228 KB an SM, of which each block reserves 1 KB


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


def _tree(params, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in params.items()}


def _case(hidden, f32_vals, seed=0, tile=16, n_tiles=3, spread=20):
    """Both packages' band adjacencies of one edge list, params at the
    model's init scale, a bf16 h and a bf16 cotangent."""
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
# The kernel's arithmetic in plain PyTorch
# ---------------------------------------------------------------------------


def _split_sum(lhs, r_parts, r0, r1):
    """One split's ``lhs^T R`` over rows [r0, r1) as the kernel's
    accumulators take it: 16-deep row slices in ascending order, each
    part's slice an f32 sum of exact bf16 x bf16 products added into one
    f32 accumulator, the smallest part first."""
    acc = torch.zeros(lhs.shape[1], r_parts[0].shape[1])
    for k0 in range(r0, r1, 16):
        sl = slice(k0, min(k0 + 16, r1))
        for part in reversed(r_parts):
            acc = acc + lhs[sl].T @ part[sl]
    return acc


def _emulated(h0, hist, x, dp, dmsg, n_steps, mdt, rows_per_split):
    """``step_weight_grad_kernel_bf16``'s ``(dek, deb, dwi, dbi, dwh,
    dbh)`` over splits of ``rows_per_split`` rows."""
    n, hid = h0.shape
    total = None
    for s in reversed(range(n_steps)):
        hs = (h0 if s == 0 else hist[s - 1]).float()
        dpi = dp[s][:, :3 * hid]
        dph = torch.cat([dp[s][:, :2 * hid], dp[s][:, 3 * hid:]], dim=1)
        msg_parts = ([dmsg[s].bfloat16().float()] if mdt == BF16 else
                     [p.float() for p in split_bf16x3(dmsg[s])])
        step = []
        for lhs, r, parts in ((hs, dmsg[s], msg_parts),
                              (x[s].float(), dpi, [dpi.bfloat16().float()]),
                              (hs, dph, [dph.bfloat16().float()])):
            w = torch.zeros(hid, r.shape[1])
            bias = torch.zeros(1, r.shape[1])
            for r0 in range(0, n, rows_per_split):
                r1 = min(n, r0 + rows_per_split)
                w = w + _split_sum(lhs, parts, r0, r1)
                bias = bias + r[r0:r1].sum(0, keepdim=True)
            step += [w, bias]
        total = step if total is None else [t + u for t, u in
                                            zip(total, step)]
    return total


def _near_jax(got, dparams, limit=GRAD_REL):
    got = list(got)
    got[5] = got[5][:, -got[0].shape[0]:]  # b_hn: the r|z zeros no param
    for i, (a, b) in enumerate(zip(got, _packed_grads(dparams))):
        assert a.dtype == torch.float32 and a.shape == b.shape, i
        gap = np.abs(a.numpy() - b).max() / np.abs(b).max()
        assert gap <= limit, (i, gap)


# ---------------------------------------------------------------------------
# The emulation against the reference kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("f32_vals", [False, True])
@pytest.mark.parametrize("rows_per_split", [32, 64])
def test_emulated_step_weight_pass_matches_the_reference_kernel(
        rows_per_split, f32_vals):
    """One step: ``jax.vjp`` of ``fused_gate_step(impl="interpret")``'s
    parameter gradients against the kernel's sums over the port's per-row
    cotangents (``fused_step_bwd_rows_reference``), on the bf16 training
    tests' case (48 rows, H 32), over two splits (the second of 16 rows)
    or one that ends inside a slab."""
    jadj, padj, params, jh, ph, jg, pg = _case(32, f32_vals)
    jp = _tree(params, jnp.asarray)

    @jax.jit
    def step_vjp(p, h, g):
        return jax.vjp(lambda p, h: jax_fused.fused_gate_step(
            p, h, jadj, impl="interpret"), p, h)[1](g)

    dparams, _ = step_vjp(jp, jh, jg)
    _, x, dp, dmsg = pt_fused.fused_step_bwd_rows_reference(
        _tree(params, torch.from_numpy), ph, padj, pg)
    mdt = pt_fused.msg_dtype(padj, BF16)
    _near_jax(_emulated(ph, None, x[None], dp[None], dmsg[None], 1, mdt,
                        rows_per_split), dparams)


@pytest.mark.parametrize("f32_vals", [False, True])
@pytest.mark.parametrize("hidden", [36, 100])
def test_emulated_weight_pass_off_the_tile_matches_the_plain_version(
        hidden, f32_vals):
    """At widths whose output tiles have ragged edges (H 36: 108 columns of
    dW_i; H 100: 300 in three tiles), K steps over the plain reverse
    sweep's cotangents: the emulated sums within ``GRAD_REL`` of the
    plain version's (``step_weight_grad_reference``), which sums the same
    exact products in another order. (Against the interpreter these
    widths put a cotangent a bf16 rounding apart: a dpre or dmsg element
    on the other side of a rounding midpoint moves the plain version and
    the emulation alike past ``GRAD_REL``: a property of the per-row
    cotangents, not of the weight pass.)"""
    _, padj, params, _, ph, _, pg = _case(hidden, f32_vals, seed=2)
    p32 = pt_fused.packed_weights(_tree(params, torch.from_numpy))
    hist = pt_fused.persistent_hist_reference(None, ph, padj, K, p32)
    _, x, dp, dmsg = pt_fused.persistent_bwd_rows_reference(
        None, ph, hist, padj, pg, K, p32)
    mdt = pt_fused.msg_dtype(padj, BF16)
    got = _emulated(ph, hist, x, dp, dmsg, K, mdt, 32)
    for a, b in zip(got, pt_fused.step_weight_grad_reference(
            ph, hist, x, dp, dmsg, K, mdt)):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= GRAD_REL * float(b.abs().max())


@pytest.mark.parametrize("f32_vals", [False, True])
def test_emulated_k_step_weight_pass_matches_the_reference_kernel(f32_vals):
    """K steps: ``jax.vjp`` of ``persistent_unroll(impl="interpret")``
    against the kernel's sums over the reverse sweep's cotangents
    (``persistent_bwd_rows_reference`` on ``persistent_hist_reference``'s
    states), the steps folded from K-1 down to 0; and the K-step sums bit
    for bit the fold of K one-step sums, as a K-step launch is the fold of
    K one-step launches."""
    jadj, padj, params, jh, ph, jg, pg = _case(32, f32_vals)
    jp = _tree(params, jnp.asarray)

    # Traced as tests/test_torch_bf16_persistent_train.py traces it (the
    # output beside the VJP): XLA's fusion decides where the interpreter
    # elides a bf16 round trip.
    @jax.jit
    def unroll_vjp(p, h, g):
        out, vjp = jax.vjp(lambda p, h: jax_fused.persistent_unroll(
            p, h, jadj, K, impl="interpret"), p, h)
        return out, vjp(g)

    _, (dparams, _) = unroll_vjp(jp, jh, jg)
    p32 = pt_fused.packed_weights(_tree(params, torch.from_numpy))
    hist = pt_fused.persistent_hist_reference(None, ph, padj, K, p32)
    _, x, dp, dmsg = pt_fused.persistent_bwd_rows_reference(
        None, ph, hist, padj, pg, K, p32)
    mdt = pt_fused.msg_dtype(padj, BF16)
    rows = pt_fused.wgrad_bf16_rows_per_split(ph.shape[0], 32)
    got = _emulated(ph, hist, x, dp, dmsg, K, mdt, rows)
    _near_jax(got, dparams, GRAD_REL_K)
    fold = None
    for s in reversed(range(K)):
        hs = ph if s == 0 else hist[s - 1]
        one = _emulated(hs, None, x[s:s + 1], dp[s:s + 1], dmsg[s:s + 1], 1,
                        mdt, rows)
        fold = one if fold is None else [a + b for a, b in zip(fold, one)]
    for a, b in zip(got, fold):
        assert torch.equal(a, b)
    # The plain version sums in another order: as near as to the JAX one.
    for a, b in zip(got, pt_fused.step_weight_grad_reference(
            ph, hist, x, dp, dmsg, K, mdt)):
        assert float((a - b).abs().max()) <= GRAD_REL * float(b.abs().max())


def test_split_parts_are_exact_and_the_rounding_is_nearest_even():
    """The operands the kernel builds from f32 ``dmsg``: three bf16 parts
    whose sum is the value (each product with a bf16 value exact in f32);
    ``dpre`` rounded to nearest even, as ``round_bf16`` rounds it."""
    rng = np.random.default_rng(5)
    v = torch.from_numpy(rng.standard_normal((64, 36)).astype(np.float32)
                         * np.float32(3e-3))
    p1, p2, p3 = split_bf16x3(v)
    assert torch.equal(p1.double() + p2.double() + p3.double(), v.double())
    assert torch.equal(pt_fused.round_bf16(v), v.bfloat16().float())


# ---------------------------------------------------------------------------
# The host mirrors of the launch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,hidden,rows,splits", [
    (16384, 128, 928, 18),  # the training batch: 7 tiles, 126 blocks a step
    (1000, 128, 64, 16),
    (333, 64, 32, 11),      # 5 tiles; a slab is the floor
    (100, 36, 32, 4),       # 3 tiles
    (16384, 64, 640, 26),   # 5 tiles: 130 blocks a step
])
def test_bf16_splits_follow_rows_and_width(n, hidden, rows, splits):
    """The bf16 instance's splits: from the row count and width alone
    (the function takes no step count, so a one-step and a K-step call cut
    the rows alike and the K-step sums are the fold of one-step ones),
    whole slabs, and as many as one step's tiles can take within one
    block an SM (a one-step call one wave, not one and a block; a K-step
    call's steps fill the second block an SM)."""
    assert list(inspect.signature(
        pt_fused.wgrad_bf16_rows_per_split).parameters) == ["n_rows",
                                                            "hidden"]
    got = pt_fused.wgrad_bf16_rows_per_split(n, hidden)
    assert got == rows and -(-n // got) == splits
    assert got % pt_fused.WGRAD_BF16_SLAB_ROWS == 0
    tiles = pt_fused._wgrad_tiles(hidden)
    fill = pt_fused.WGRAD_BF16_FILL_BLOCKS
    # The smallest whole-slab split that keeps a step within the fill.
    assert splits * tiles <= fill
    slab = pt_fused.WGRAD_BF16_SLAB_ROWS
    if got > slab:
        assert -(-n // (got - slab)) * tiles > fill
    # One block an SM on 132 SMs, of the two an SM holds.
    assert fill == 132 and pt_fused.WGRAD_BF16_BLOCKS == 2
    # The f32 kernel keeps its own.
    if (n, hidden) == (16384, 128):
        assert pt_fused.wgrad_rows_per_split(n, hidden) == 864


def _source_constant(name: str) -> int:
    with open(SOURCE) as f:
        return int(re.search(rf"^constexpr int {name} = (\d+);", f.read(),
                             re.M).group(1))


@pytest.mark.parametrize("round_msg", [True, False])
def test_bf16_weight_pass_shared_memory_fits(round_msg):
    """The mirrors equal the source's constants; the instance a launch
    runs (three R parts a slab with f32 messages) fits a block's 227 KB,
    and its blocks an SM fit the SM's 228 KB with 1 KB reserved each."""
    for mirror, const in (("WGRAD_BF16_SLAB_ROWS", "kW16Slab"),
                          ("WGRAD_BF16_STAGES", "kW16Stages"),
                          ("WGRAD_BF16_SPLIT_STAGES", "kW16SplitStages"),
                          ("WGRAD_BF16_BLOCKS", "kW16Blocks")):
        assert getattr(pt_fused, mirror) == _source_constant(const), mirror
    smem = pt_fused.wgrad_bf16_smem_bytes(round_msg)
    stages = (pt_fused.WGRAD_BF16_STAGES if round_msg
              else pt_fused.WGRAD_BF16_SPLIT_STAGES)
    slab, parts = pt_fused.WGRAD_BF16_SLAB_ROWS, 1 if round_msg else 3
    # f32 R and bf16 L (272-byte rows) a stage, two bf16 R slabs of parts.
    assert smem == stages * slab * (128 * 4 + 136 * 2) + 2 * parts * slab * 272
    assert smem <= BLOCK_SMEM
    assert pt_fused.WGRAD_BF16_BLOCKS * (smem + 1024) <= SM_SMEM
    assert smem == {True: 92_672, False: 102_400}[round_msg]
