"""The arithmetic of the bf16 flash forward and fused backward kernels
(``flash_fwd_kernel_bf16``, ``flash_bwd_fused_kernel_bf16`` with
``flash_dq_sum_kernel_bf16``), emulated here in plain PyTorch, against the
JAX package's bf16 flash attention and its VJP (the Pallas kernels in
interpret mode, as ``tests/test_torch_bf16_attention.py`` runs them).

The kernels have no CPU mode; the emulation follows their design step by
step, 64 keys a step: products of two bf16 inputs summed in f32 (exact
products), ``scale`` applied to the f32 sums, the online softmax, every
product with P or dS taken as three products of its bf16 parts
(``split_bf16x3``), the smallest first, and dq as partials over 128-key
blocks (``FUSED_KEY_ROWS``) summed in block order. Contract, as on the
card against the f32 kernels rounded: each output within one bf16 step
or 1e-5 of the reference's, lse within 1e-5, and the mean absolute error
against a float64 evaluation of the reference's formulas at most 1.02
times the reference's. Also: the backward's shape gate is the one it was,
and each instance's wrapper allocates the partial bytes
``fused_bwd_partial_bytes`` counts for it.
"""

import math
import os
import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from deepdfa_tpu.ops import attention as JA
from deepdfa_tpu_torch.ops import attention as A

ATOL = 1e-5
F64_RATIO = 1.02
LSE_TOL = dict(rtol=1e-5, atol=1e-5)
KEYS_A_STEP = 64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread (see tests/test_torch_bf16_attention.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(b=2, t=200, h=2, d=64, seed=0):
    """q, k, v and a cotangent as bf16 tensors (one all-pad row) and the
    same values as bf16 JAX arrays."""
    rng = np.random.default_rng(seed)
    pt = [torch.from_numpy(rng.standard_normal((b, t, h, d)).astype(
        np.float32)).bfloat16() for _ in range(4)]
    lengths = rng.integers(t // 2, t + 1, size=b)
    lengths[-1] = 0
    mask = np.arange(t)[None, :] < lengths[:, None]
    jx = [jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in pt]
    return pt, jx, mask


def _seen(mask, tq, causal):
    """[B, Tq, Tk]: the keys each query may see."""
    seen = mask[:, None, :].expand(mask.shape[0], tq, mask.shape[1])
    if causal:
        seen = seen & torch.ones(tq, mask.shape[1], dtype=torch.bool).tril()
    return seen


def _split_mm(eq, x, y):
    """``einsum(eq, x, y)`` for an f32 ``x`` against a bf16-exact ``y``:
    x's three bf16 parts, three f32 products, the smallest first."""
    acc = None
    for part in reversed(A.split_bf16x3(x)):
        term = torch.einsum(eq, part.float(), y)
        acc = term if acc is None else acc + term
    return acc


def _emulate_fwd(q, k, v, mask, causal):
    """The forward kernel's arithmetic: (o bf16, lse f32 [B, H, Tq])."""
    b, tq, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf = q.float(), k.float(), v.float()
    seen = _seen(mask, tq, causal)[:, None]  # [B, 1, Tq, Tk]
    m = torch.full((b, h, tq), A.NEG_INF)
    l = torch.zeros(b, h, tq)
    o = torch.zeros(b, h, tq, d)
    for k0 in range(0, k.shape[1], KEYS_A_STEP):
        sl = slice(k0, k0 + KEYS_A_STEP)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kf[:, sl]) * scale
        s = torch.where(seen[..., sl], s, A.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        shift = torch.where(m_new <= A.NEG_INF / 2, 0.0, m_new)
        corr = torch.exp(torch.where(m <= A.NEG_INF / 2, A.NEG_INF, m)
                         - shift)
        p = torch.where(s <= A.NEG_INF / 2, 0.0,
                        torch.exp(s - shift[..., None]))
        l = l * corr + p.sum(-1)
        o = o * corr[..., None] + _split_mm("bhqk,bkhd->bhqd", p, vf[:, sl])
        m = m_new
    lc = torch.clamp(l, min=1e-30)
    lse = torch.where(m <= A.NEG_INF / 2, 0.0, m) + torch.log(lc)
    return (o / lc[..., None]).transpose(1, 2).bfloat16(), lse


def _emulate_bwd(q, k, v, mask, do, lse, delta, causal):
    """The fused backward's arithmetic and its dq sum: (dq, dk, dv)
    bf16."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    seen = _seen(mask, tq, causal)[:, None]
    block = A.FUSED_KEY_ROWS[torch.bfloat16]
    parts = [torch.zeros(b, h, tq, d) for _ in range(-(-tk // block))]
    dks, dvs = [], []
    for k0 in range(0, tk, KEYS_A_STEP):
        sl = slice(k0, k0 + KEYS_A_STEP)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kf[:, sl]) * scale
        p = torch.where(seen[..., sl], torch.exp(s - lse[..., None]), 0.0)
        dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf[:, sl])
        ds = p * (dp - delta[..., None])
        dvs.append(_split_mm("bhqk,bqhd->bkhd", p, dof))
        dks.append(_split_mm("bhqk,bqhd->bkhd", ds, qf) * scale)
        parts[k0 // block] = parts[k0 // block] + _split_mm(
            "bhqk,bkhd->bhqd", ds, kf[:, sl])
    dq = torch.zeros(b, h, tq, d)
    for part in parts:
        dq = dq + part
    return ((dq * scale).transpose(1, 2).bfloat16(),
            torch.cat(dks, 1).bfloat16(), torch.cat(dvs, 1).bfloat16())


def _f64(q, k, v, mask, do, lse, delta, causal):
    """o, dq, dk and dv of the reference's formulas in float64 (the
    backward's P from ``lse``, dS = P (dO V^T - delta))."""
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d)
    qd, kd, vd, dod = (x.double() for x in (q, k, v, do))
    seen = _seen(mask, q.shape[1], causal)[:, None]
    s = torch.einsum("bqhd,bkhd->bhqk", qd, kd) * scale
    w = torch.softmax(torch.where(seen, s, -torch.inf), -1)
    w = torch.nan_to_num(w)  # the all-pad row: no key, o = 0
    o = torch.einsum("bhqk,bkhd->bqhd", w, vd)
    p = torch.where(seen, torch.exp(s - lse.double()[..., None]), 0.0)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", dod, vd)
              - delta.double()[..., None])
    return (o, scale * torch.einsum("bhqk,bkhd->bqhd", ds, kd),
            scale * torch.einsum("bhqk,bqhd->bkhd", ds, qd),
            torch.einsum("bhqk,bqhd->bkhd", p, dod))


def _ulps_apart(a, b):
    def ordered(x):
        i = x.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)

    return (ordered(a) - ordered(b)).abs()


def _within_a_step(name, got, want):
    gap = (got.float() - want.float()).abs()
    over = (_ulps_apart(got, want) > 1) & (gap > ATOL)
    assert not over.any(), (name, int(over.sum()), float(gap.max()))


def _torch(x):
    return torch.from_numpy(np.array(jnp.asarray(x).astype(jnp.float32)))


@pytest.mark.parametrize("causal", [False, True])
def test_emulated_bf16_kernels_match_the_jax_flash_attention(causal):
    """The forward's and the fused backward's emulated arithmetic against
    JAX's bf16 flash attention and its VJP at B 2, T 200, H 2, D 64 (one
    all-pad row): within a bf16 step or 1e-5, lse within 1e-5, and the
    float64 mean errors at most 1.02 times JAX's; the port's plain
    versions within a step of the emulation."""
    (q, k, v, g), jx, mask = _inputs()
    m = torch.from_numpy(mask)
    t = q.shape[1]
    jm = jnp.asarray(mask)
    want_o, want_lse = JA._flash_forward(*jx[:3], jm, causal, t, t, True)

    def f(q_, k_, v_):
        out = JA.flash_attention(q_, k_, v_, kv_mask=jm, causal=causal)
        return (out.astype(jnp.float32) * jx[3].astype(jnp.float32)).sum()

    want_grads = jax.grad(f, argnums=(0, 1, 2))(*jx[:3])
    want = [_torch(want_o).bfloat16(),
            *(_torch(x).bfloat16() for x in want_grads)]
    b, h = q.shape[0], q.shape[2]
    want_lse = _torch(want_lse).reshape(b, h, t)

    o, lse = _emulate_fwd(q, k, v, m, causal)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), **LSE_TOL)
    # The backward from JAX's forward (its o and lse), as its VJP runs.
    delta = A.flash_delta(want[0], g)
    got = [o, *_emulate_bwd(q, k, v, m, g, want_lse, delta, causal)]
    ref = _f64(q, k, v, m, g, want_lse, delta, causal)
    plain_o, plain_lse = A.flash_fwd(q, k, v, m, causal)
    plain = [plain_o, *A.flash_bwd_fused(q, k, v, m, g, want_lse, delta,
                                         causal)]
    for name, x, w, r, p in zip(("o", "dq", "dk", "dv"), got, want, ref,
                                plain):
        assert x.dtype == torch.bfloat16
        _within_a_step(name, x, w)
        _within_a_step(name + " plain", p, x)
        err, err_jax = ((y.double() - r).abs().mean() for y in (x, w))
        assert err <= F64_RATIO * err_jax, (name, float(err), float(err_jax))
        assert not x[-1].any(), name  # the all-pad row
    for x in got[2:]:  # padded keys: P = dS = 0
        assert not x[~m].any()
    torch.testing.assert_close(plain_lse, lse, **LSE_TOL)


#: (Tq, Tk) over the edges of the gate's 64-key tiles and its 1 MiB.
GATE_GRID = [(tq, tk) for tq in (1, 64, 200, 511, 512, 513, 1024, 4096)
             for tk in (1, 63, 64, 65, 448, 512, 513, 576, 4096)]


def test_fused_backward_gate_is_unchanged():
    """The backward's gate counts the f32 kernel's 64-key tiles for every
    instance: the fused path where one (batch, head)'s partials stay
    within 1 MiB, as before the bf16 kernel's 128-key blocks."""
    assert A.FUSED_BWD_PARTIAL_BYTES == 1 << 20
    for tq, tk in GATE_GRID:
        for d in (64, 32):
            ok = 4 * -(-tk // 64) * tq * d <= 1 << 20
            assert A.flash_fused_bwd_ok(tq, d, tk) == ok, (tq, tk, d)
    assert A.flash_fused_bwd_ok(512, 64) and not A.flash_fused_bwd_ok(4096,
                                                                      64)


def test_fused_backward_partials_by_instance():
    """Each instance's wrapper allocates the partial bytes
    ``fused_bwd_partial_bytes`` counts for its key blocks: the f32
    kernel's are the gate's, the bf16 kernel's 128-key blocks at most
    that (half at T 512); and the bf16 kernel's source builds the key
    blocks ``FUSED_KEY_ROWS`` names (the wrapper checks the built
    library too)."""
    b, h, d = 3, 2, 64
    for tq, tk in GATE_GRID:
        gate = b * h * A.fused_bwd_partial_bytes(tq, d, tk)
        for dtype, rows in A.FUSED_KEY_ROWS.items():
            q = torch.empty(b, tq, h, d, dtype=dtype)
            shape = A.fused_bwd_partials_shape(q, tk)
            assert shape[1:] == (b, tq, h, d)
            got = 4 * math.prod(shape)
            assert got == b * h * A.fused_bwd_partial_bytes(tq, d, tk, rows)
            assert got == gate if dtype == torch.float32 else got <= gate
    q = torch.empty(16, 512, 12, 64, dtype=torch.bfloat16)
    assert 2 * 4 * math.prod(A.fused_bwd_partials_shape(q, 512)) == (
        16 * 12 * A.fused_bwd_partial_bytes(512, 64))
    src = os.path.join(os.path.dirname(A.__file__), "..", "csrc",
                       "flash_bwd_fused.cu")
    with open(src) as f:
        warps = int(re.search(r"^constexpr int FKW = (\d+);", f.read(),
                              re.M).group(1))
    assert 16 * warps == A.FUSED_KEY_ROWS[torch.bfloat16]
