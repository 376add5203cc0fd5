"""The port's attention (deepdfa_tpu_torch/ops/attention.py) against the
JAX package's.

Inputs are made once in numpy from a seed and go through both packages.
The JAX flash path runs its Pallas kernels in interpret mode on the CPU
(as tests/test_attention.py runs them) and its two-pass backward with
``_FUSED_BWD_MAX_BYTES`` at 0; the port runs its kernels' plain
versions, which its wrappers take for CPU tensors, through the same
``torch.autograd.Function`` the card uses.

Tolerances: the forward within 1e-5, gradients within 1e-4 (the JAX
package's own bound for its flash gradients, tests/test_attention.py).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from deepdfa_tpu.ops import attention as JA
from deepdfa_tpu_torch.ops import attention as A

FWD_TOL = 1e-5
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread. The tier-1 run shares the cores among several
    workers, and these shapes gain nothing from more. And the first
    ``torch.exp`` of a process that splits across threads (more than 2048
    elements; MKL's ``vmsExp``, here fed the masked scores at NEG_INF) can
    come back with a relative error near 1e-4 in one thread's chunk: a
    race in MKL's first use, seen in a few percent of fresh processes at
    two threads and never at one (``scripts/torch_first_exp_race.py``).
    Run in one thread, the plain versions give the same bits every call."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(b=3, t=32, h=2, d=8, seed=0):
    """q, k, v, a cotangent g and a kv mask with padded tails and one
    all-pad row, as numpy."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((b, t, h, d)).astype(np.float32)
                  for _ in range(4))
    lengths = rng.integers(t // 2, t + 1, size=b)
    lengths[-1] = 0
    mask = np.arange(t)[None, :] < lengths[:, None]
    return q, k, v, g, mask


def _jax_flash_grads(q, k, v, g, mask, causal):
    def f(q, k, v):
        out = JA.flash_attention(q, k, v, kv_mask=jnp.asarray(mask),
                                 causal=causal)
        return (out * jnp.asarray(g)).sum()

    return [np.asarray(x) for x in jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


def _port_flash_grads(q, k, v, g, mask, causal):
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = A.flash_attention(qt, kt, vt, torch.from_numpy(mask), causal)
    (out * torch.from_numpy(g)).sum().backward()
    return out.detach().numpy(), [x.grad.numpy() for x in (qt, kt, vt)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t", [32, 37])  # 37: not a multiple of any tile
def test_flash_forward_matches_jax(causal, t):
    q, k, v, _, mask = _inputs(t=t)
    want = np.asarray(JA.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        kv_mask=jnp.asarray(mask), causal=causal))
    o, lse = A.flash_fwd(*(torch.from_numpy(x) for x in (q, k, v, mask)),
                         causal=causal)
    np.testing.assert_allclose(o.numpy(), want, atol=FWD_TOL, rtol=FWD_TOL)
    assert np.all(o.numpy()[-1] == 0)  # the all-pad row: zeros, not NaN
    # lse = shift + log(l): the all-pad row sits at log(1e-30).
    np.testing.assert_allclose(lse.numpy()[-1], np.log(1e-30), rtol=1e-6)
    assert A.launch_counts() == dict.fromkeys(A.KERNELS, 0)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_gradients_match_jax_fused(causal):
    q, k, v, g, mask = _inputs(t=37)
    assert A.flash_fused_bwd_ok(37, 8)
    want = _jax_flash_grads(q, k, v, g, mask, causal)
    before = A.flash_backward.two_pass_dispatches
    _, got = _port_flash_grads(q, k, v, g, mask, causal)
    assert A.flash_backward.two_pass_dispatches == before
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=GRAD_TOL, rtol=GRAD_TOL)
        assert np.all(a[-1] == 0)  # the all-pad row's gradients


@pytest.mark.parametrize("causal", [False, True])
def test_flash_two_pass_gradients_match_jax(monkeypatch, causal):
    q, k, v, g, mask = _inputs(t=32)
    monkeypatch.setattr(JA, "_FUSED_BWD_MAX_BYTES", 0)
    want = _jax_flash_grads(q, k, v, g, mask, causal)
    monkeypatch.setattr(A, "flash_fused_bwd_ok", lambda tq, d, tk: False)
    before = A.flash_backward.two_pass_dispatches
    _, got = _port_flash_grads(q, k, v, g, mask, causal)
    assert A.flash_backward.two_pass_dispatches == before + 1
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=GRAD_TOL, rtol=GRAD_TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t", [40, 600])  # 600: two key blocks of 512
def test_plain_fused_backward_equals_plain_two_pass(causal, t):
    q, k, v, g, mask = (torch.from_numpy(x) for x in _inputs(b=2, t=t, d=16))
    o, lse = A.flash_fwd_reference(q, k, v, mask, causal)
    delta = A.flash_delta(o, g)
    args = (q, k, v, mask, g, lse, delta, causal)
    fused = A.flash_bwd_fused_reference(*args)
    two_pass = (A.flash_bwd_dq_reference(*args),
                *A.flash_bwd_dkv_reference(*args))
    for a, b in zip(fused, two_pass):
        assert torch.equal(a, b)  # the same tile math, the same order
    # ... and the VJP autograd takes through the dense composition.
    qt, kt, vt = (x.clone().requires_grad_() for x in (q, k, v))
    out = A.dense_attention(qt, kt, vt, mask, causal)
    keep = mask.any(1)  # dense gives all-pad rows uniform weights
    (out[keep] * g[keep]).sum().backward()
    for a, b in zip(fused, (qt.grad, kt.grad, vt.grad)):
        torch.testing.assert_close(a[keep], b[keep], atol=GRAD_TOL,
                                   rtol=GRAD_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_dense_and_blockwise_match_jax(causal):
    q, k, v, _, mask = _inputs(t=48)
    jq, jk, jv, jm = (jnp.asarray(x) for x in (q, k, v, mask))
    pq, pk, pv, pm = (torch.from_numpy(x) for x in (q, k, v, mask))
    out, w = A.dense_attention(pq, pk, pv, pm, causal, return_weights=True)
    jout, jw = JA.dense_attention(jq, jk, jv, kv_mask=jm, causal=causal,
                                  return_weights=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=FWD_TOL)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=FWD_TOL)
    for block in (16, 24, 64):
        got = A.blockwise_attention(pq, pk, pv, pm, causal, block_size=block)
        want = JA.blockwise_attention(jq, jk, jv, kv_mask=jm, causal=causal,
                                      block_size=block)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=FWD_TOL)


@pytest.mark.parametrize("impl", ["dense", "blockwise", "flash", "auto"])
def test_attention_dispatch(impl):
    q, k, v, _, mask = (torch.from_numpy(x) for x in _inputs(t=16))
    keep = mask.any(1)
    out = A.attention(q, k, v, mask, impl=impl)
    ref = A.dense_attention(q, k, v, mask)
    torch.testing.assert_close(out[keep], ref[keep], atol=FWD_TOL,
                               rtol=FWD_TOL)
    with pytest.raises(ValueError, match="unknown attention impl"):
        A.attention(q, k, v, mask, impl="ring")


def test_fused_backward_gate():
    # One (batch, head)'s f32 dq partials, a [T, 64] plane for each of the
    # 8 key tiles at T 512: 1 MiB, the limit.
    assert A.fused_bwd_partial_bytes(512, 64) == 8 * 512 * 64 * 4 == 1 << 20
    assert A.flash_fused_bwd_ok(512, 64)
    assert not A.flash_fused_bwd_ok(513, 64)  # 9 key tiles
    assert not A.flash_fused_bwd_ok(4096, 64)
    assert A.flash_fused_bwd_ok(1024, 16)
    assert not A.flash_fused_bwd_ok(512, 128)
    # Cross lengths: Tk sets the key tiles, Tq the plane.
    assert A.fused_bwd_partial_bytes(100, 64, tk=600) == 10 * 100 * 64 * 4
    assert A.flash_fused_bwd_ok(256, 64, tk=1024)
    assert not A.flash_fused_bwd_ok(512, 64, tk=520)


def test_kernel_cost_counts_the_products():
    b, h, t, d = 16, 12, 512, 64
    unit = b * h * t * t * d
    full = torch.ones(b, t, dtype=torch.bool)
    for name, ops in (("flash_fwd_kernel", 4), ("flash_bwd_fused_kernel", 10),
                      ("flash_bwd_dq_kernel", 6),
                      ("flash_bwd_dkv_kernel", 8)):
        cost = A.kernel_cost(full, t, h, d, name)
        assert cost["flops"] == cost["executed_flops"] == ops * unit
    plane = 4 * b * t * h * d
    fwd = A.kernel_cost(full, t, h, d, "flash_fwd_kernel")["bytes"]
    assert fwd == 4 * plane + b * t + 4 * b * h * t
    with pytest.raises(ValueError, match="unknown kernel"):
        A.kernel_cost(full, t, h, d, "nope")

    # Only the pairs the masks leave count: row 0 has 3 real keys of 100,
    # row 1 none (its queries see nothing and read nothing); the kernel
    # runs row 0's first key tile, the only one holding a real key, whole
    # for each of two query tiles.
    t = 100
    mask = torch.zeros(2, t, dtype=torch.bool)
    mask[0, :3] = True
    cost = A.kernel_cost(mask, t, 1, d, "flash_fwd_kernel")
    assert cost["flops"] == 4 * d * t * 3
    assert cost["executed_flops"] == 4 * d * 2 * 64 * 64
    assert cost["dead_key_tiles"] == 3
    row = 4 * d
    assert cost["bytes"] == (t * row + 2 * 3 * row + 2 * t
                             + 2 * t * (row + 4))
    # Causal: query i sees the real keys at or before it, 1 + 2 + 3 * 98.
    # Every kernel skips key tiles with no real key: of the four
    # (row, key tile) pairs only row 0's first tile holds one, and it meets
    # both query tiles, causal or not (no query tile comes before it).
    causal = A.kernel_cost(mask, t, 1, d, "flash_bwd_dq_kernel", causal=True)
    assert causal["flops"] == 6 * d * (1 + 2 + 3 * 98)
    assert causal["executed_flops"] == 6 * d * 2 * 64 * 64
    assert causal["dead_key_tiles"] == 3
    assert causal["peak_flops"] == pytest.approx(495e12 / 3)
    assert A.kernel_cost(mask, t, 1, d, "flash_fwd_kernel")[
        "peak_flops"] == pytest.approx(495e12 / 3)
    for name, ops in (("flash_bwd_fused_kernel", 10),
                      ("flash_bwd_dkv_kernel", 8)):
        cost = A.kernel_cost(mask, t, 1, d, name)
        assert cost["flops"] == ops * d * t * 3
        assert cost["executed_flops"] == ops * d * 2 * 64 * 64
        assert cost["dead_key_tiles"] == 3
        assert cost["peak_flops"] == pytest.approx(495e12 / 3)
        assert A.kernel_cost(mask, t, 1, d, name, causal=True)[
            "executed_flops"] == cost["executed_flops"]
