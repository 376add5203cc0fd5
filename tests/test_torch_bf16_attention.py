"""The port's attention at bf16 (deepdfa_tpu_torch/ops/attention.py)
against the JAX package's.

The same bf16 inputs (made in numpy from a seed, rounded to bf16 once)
go through both packages, each impl against the same impl: at bf16 the
reference's dense path and its flash and blockwise paths round in
different places, so flash pairs with flash (the Pallas kernels in
interpret mode), blockwise with blockwise and dense with dense. The
port's wrappers take their kernels' plain versions for CPU tensors.

Tolerances: outputs and gradients within one bf16 ulp of the reference's
(rtol 2^-7, the spacing of bf16 in [1, 2), atol 1e-6): both compute in
f32 and round once to bf16, so f32 order can move a value to the next
bf16 number and no further. lse (f32) within 1e-6.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from deepdfa_tpu.ops import attention as JA
from deepdfa_tpu_torch.ops import attention as A

BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-6)
LSE_TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the first multi-threaded ``torch.exp`` of a
    process can be off in one thread's chunk (MKL's first use,
    ``scripts/torch_first_exp_race.py``), and these shapes gain nothing
    from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(b=3, t=37, h=2, d=8, seed=0):
    """q, k, v and a cotangent g as bf16 torch tensors, the same values
    as bf16 JAX arrays, and a kv mask with padded tails and one all-pad
    row."""
    rng = np.random.default_rng(seed)
    pt = [torch.from_numpy(rng.standard_normal((b, t, h, d)).astype(
        np.float32)).bfloat16() for _ in range(4)]
    lengths = rng.integers(t // 2, t + 1, size=b)
    lengths[-1] = 0
    mask = np.arange(t)[None, :] < lengths[:, None]
    jx = [jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in pt]
    return pt, jx, mask


def _f32(x):
    """A bf16 array or tensor as f32 numpy (exact)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


_JAX = {"flash": lambda q, k, v, m, c: JA.flash_attention(
            q, k, v, kv_mask=m, causal=c),
        "blockwise": lambda q, k, v, m, c: JA.blockwise_attention(
            q, k, v, kv_mask=m, causal=c, block_size=16),
        "dense": lambda q, k, v, m, c: JA.dense_attention(
            q, k, v, kv_mask=m, causal=c)}
_PORT = {"flash": lambda q, k, v, m, c: A.flash_attention(q, k, v, m, c),
         "blockwise": lambda q, k, v, m, c: A.blockwise_attention(
             q, k, v, m, c, block_size=16),
         "dense": lambda q, k, v, m, c: A.dense_attention(q, k, v, m, c)}


def _jax_run(impl, jx, mask, causal):
    q, k, v, g = jx
    jm = jnp.asarray(mask)

    def f(q, k, v):
        out = _JAX[impl](q, k, v, jm, causal)
        return (out.astype(jnp.float32) * g.astype(jnp.float32)).sum(), out

    (_, out), grads = jax.value_and_grad(f, argnums=(0, 1, 2),
                                         has_aux=True)(q, k, v)
    return out, grads


def _port_run(impl, pt, mask, causal):
    q, k, v, g = pt
    qt, kt, vt = (x.clone().requires_grad_() for x in (q, k, v))
    out = _PORT[impl](qt, kt, vt, torch.from_numpy(mask), causal)
    (out.float() * g.float()).sum().backward()
    return out, (qt.grad, kt.grad, vt.grad)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("impl", ["flash", "blockwise", "dense"])
def test_bf16_attention_matches_jax(impl, causal):
    """Forward and the three gradients at bf16, each impl against the
    JAX package's same impl (flash: the fused backward on both sides)."""
    pt, jx, mask = _inputs()
    want, want_grads = _jax_run(impl, jx, mask, causal)
    before = A.flash_backward.two_pass_dispatches
    got, got_grads = _port_run(impl, pt, mask, causal)
    assert A.flash_backward.two_pass_dispatches == before
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), **BF16_TOL)
    for name, a, b in zip("qkv", got_grads, want_grads):
        assert a.dtype == torch.bfloat16 and b.dtype == jnp.bfloat16, name
        np.testing.assert_allclose(_f32(a), _f32(b), **BF16_TOL,
                                   err_msg=f"d{name}")
    if impl != "dense":  # dense gives an all-pad row uniform weights
        assert not _f32(got)[-1].any()
        assert not any(_f32(a)[-1].any() for a in got_grads)


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_flash_two_pass_gradients_match_jax(monkeypatch, causal):
    pt, jx, mask = _inputs(t=32)
    monkeypatch.setattr(JA, "_FUSED_BWD_MAX_BYTES", 0)
    want, want_grads = _jax_run("flash", jx, mask, causal)
    monkeypatch.setattr(A, "flash_fused_bwd_ok", lambda tq, d, tk: False)
    before = A.flash_backward.two_pass_dispatches
    got, got_grads = _port_run("flash", pt, mask, causal)
    assert A.flash_backward.two_pass_dispatches == before + 1
    np.testing.assert_allclose(_f32(got), _f32(want), **BF16_TOL)
    for a, b in zip(got_grads, want_grads):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(_f32(a), _f32(b), **BF16_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_flash_lse_matches_the_pallas_kernel(causal):
    (q, k, v, _), jx, mask = _inputs()
    t = q.shape[1]
    want_o, want_lse = JA._flash_forward(*jx[:3], jnp.asarray(mask), causal,
                                         t, t, True)
    o, lse = A.flash_fwd(q, k, v, torch.from_numpy(mask), causal)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    np.testing.assert_allclose(_f32(o), _f32(want_o), **BF16_TOL)
    b, h = q.shape[0], q.shape[2]
    np.testing.assert_allclose(
        lse.numpy(), np.asarray(want_lse).reshape(b, h, t), **LSE_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_plain_versions_round_the_f32_results_once(causal):
    """The identity the card's bf16 instances keep, on their plain
    versions: every bf16 output is the f32 computation on the widened
    inputs, rounded once; lse and delta stay f32."""
    (q, k, v, g), _, mask = _inputs(t=40, d=16)
    m = torch.from_numpy(mask)
    o, lse = A.flash_fwd_reference(q, k, v, m, causal)
    o32, lse32 = A.flash_fwd_reference(q.float(), k.float(), v.float(), m,
                                       causal)
    assert o.dtype == torch.bfloat16 and torch.equal(o, o32.bfloat16())
    assert torch.equal(lse, lse32)
    delta = A.flash_delta(o, g)
    assert delta.dtype == torch.float32
    assert torch.equal(delta, A.flash_delta(o.float(), g.float()))
    args = (q, k, v, m, g, lse, delta, causal)
    wide = (q.float(), k.float(), v.float(), m, g.float(), lse, delta,
            causal)
    outs = (*A.flash_bwd_fused_reference(*args), A.flash_bwd_dq_reference(
        *args), *A.flash_bwd_dkv_reference(*args))
    outs32 = (*A.flash_bwd_fused_reference(*wide),
              A.flash_bwd_dq_reference(*wide),
              *A.flash_bwd_dkv_reference(*wide))
    for a, b in zip(outs, outs32):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b.bfloat16())


def test_bf16_instances_are_counted_and_costed_apart():
    names = ("flash_fwd_kernel", "flash_bwd_fused_kernel",
             "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")
    assert set(A.KERNELS) == {n + s for n in names for s in ("", "_bf16")}
    assert set(A.launch_counts()) == set(A.KERNELS)
    (q, k, v, _), _, mask = _inputs(t=64, h=2, d=64)
    m = torch.from_numpy(mask)
    A.reset_launch_counts()
    A.flash_fwd(q, k, v, m)  # CPU tensors: the plain version, no launch
    assert A.launch_counts() == dict.fromkeys(A.KERNELS, 0)
    for name in names:
        f32 = A.kernel_cost(m, 64, 2, 64, name)
        bf = A.kernel_cost(m, 64, 2, 64, name + "_bf16")
        assert bf["flops"] == f32["flops"]
        assert bf["executed_flops"] == f32["executed_flops"]
        # The products of two bf16 inputs (QK^T, dO V^T) at the bf16
        # tensor-core rate, those with an f32 operand (P or dS, split
        # into three bf16 parts) at a third of it.
        n, nb = {"flash_fwd_kernel": (2, 1), "flash_bwd_fused_kernel": (5, 2),
                 "flash_bwd_dq_kernel": (3, 2),
                 "flash_bwd_dkv_kernel": (4, 2)}[name]
        assert f32["flops_bf16"] == 0.0
        assert bf["flops_bf16"] == pytest.approx(bf["flops"] * nb / n)
        seconds = bf["flops_bf16"] / 989e12 + (bf["flops"]
                                               - bf["flops_bf16"]) / (
                                                   989e12 / 3)
        assert bf["flops"] / bf["peak_flops"] == pytest.approx(seconds)
        assert f32["peak_flops"] == 165e12
        # Only the [H, D] rows shrink to 2 bytes an element: the mask's
        # bytes and lse's and delta's 4 a row stay.
        assert f32["bytes"] / 2 < bf["bytes"] < f32["bytes"]
