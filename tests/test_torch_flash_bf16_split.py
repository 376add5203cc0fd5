"""The three-way bf16 split the bf16 two-pass flash kernels run on P and
dS (``ops/attention.py:split_bf16x3``, in registers in
``csrc/bf16_mma.cuh``), and the bound that follows from it
(``kernel_cost``). No card needed.

An f32 value splits into three bf16 parts that sum back to it exactly,
and each part's product with a bf16 value is exact in f32, so three bf16
tensor-core products give an f32 operand's product with a bf16 one at
f32 accuracy: the bf16 flash instances' f32-operand products are bound
by a third of the bf16 rate (``PEAK_BF16X3``), their f32 instances by
3xTF32's."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from deepdfa_tpu_torch.ops import PEAK_3XTF32, PEAK_BF16, PEAK_BF16X3
from deepdfa_tpu_torch.ops import attention as A

FLASH = ("flash_fwd_kernel", "flash_bwd_fused_kernel", "flash_bwd_dq_kernel",
         "flash_bwd_dkv_kernel")
# Products of a [T, T] by [T, D] shape each flash kernel does, and of
# those the products of two bf16 inputs (S and dP).
PRODUCTS = {"flash_fwd_kernel": (2, 1), "flash_bwd_fused_kernel": (5, 2),
            "flash_bwd_dq_kernel": (3, 2), "flash_bwd_dkv_kernel": (4, 2)}


def _f32_values(seed, n=100_000, lo=-100, hi=100):
    """f32 values of random sign and mantissa bits, exponents uniform in
    [lo, hi]: every bit of the 24 in play."""
    rng = np.random.default_rng(seed)
    mant = rng.integers(0, 1 << 23, n, dtype=np.uint32)
    exp = rng.integers(lo + 127, hi + 128, n, dtype=np.uint32)
    sign = rng.integers(0, 2, n, dtype=np.uint32)
    bits = (sign << 31) | (exp << 23) | mant
    return torch.from_numpy(bits.view(np.float32))


def _exact_sum(parts):
    return sum(p.double() for p in parts)


@pytest.mark.parametrize("seed", range(4))
def test_three_parts_sum_to_x_exactly(seed):
    x = _f32_values(seed)
    parts = A.split_bf16x3(x)
    assert all(p.dtype == torch.bfloat16 for p in parts)
    assert torch.equal(_exact_sum(parts), x.double())
    # Each part is the nearest bf16 to what the earlier ones leave.
    x1, x2, _ = parts
    assert torch.equal(x1, x.bfloat16())
    assert torch.equal(x2, (x - x1.float()).bfloat16())


@settings(max_examples=300, deadline=None)
@given(st.floats(min_value=2.0 ** -100, max_value=2.0 ** 100, width=32),
       st.booleans())
def test_three_parts_sum_to_any_x(value, negative):
    x = torch.tensor([-value if negative else value], dtype=torch.float32)
    assert torch.equal(_exact_sum(A.split_bf16x3(x)), x.double())


def test_two_parts_are_not_enough():
    """The third part carries bits: P and dS in bf16 pairs would not be
    exact (the reason the kernels take three products, not two)."""
    rng = np.random.default_rng(0)
    p = torch.from_numpy(np.exp(-rng.exponential(3.0, 100_000)).astype(
        np.float32))
    x1, x2, x3 = A.split_bf16x3(p)
    assert not torch.equal(x1.double() + x2.double(), p.double())
    assert bool((x3 != 0).any())


@pytest.mark.parametrize("seed", range(3))
def test_part_products_with_bf16_values_are_exact_in_f32(seed):
    # Exponents in [-50, 50]: every product, part by part, stays normal.
    x = _f32_values(seed, lo=-50, hi=50)
    b = _f32_values(seed + 10, lo=-50, hi=50).bfloat16()
    for part in A.split_bf16x3(x):
        f32 = part.float() * b.float()
        assert torch.equal(f32.double(), part.double() * b.double())
    assert torch.equal(sum(p.double() * b.double()
                           for p in A.split_bf16x3(x)),
                       x.double() * b.double())


@pytest.mark.parametrize("k,scale", [(16, 1.0), (64, 1e-3), (512, 1.0)])
def test_split_product_is_the_f32_product(k, scale):
    """X B for X f32 (P- and dS-like) and B bf16: the three parts' bf16
    x bf16 products summed in f32, the smallest part first, equal the
    float64 product rounded to f32 within f32 summation order (k terms,
    each step at most half an f32 step of the running sum of |terms|)."""
    rng = np.random.default_rng(k)
    x = torch.from_numpy((rng.standard_normal((32, k)) * scale).astype(
        np.float32))
    b = torch.from_numpy(rng.standard_normal((k, 24)).astype(
        np.float32)).bfloat16()
    x1, x2, x3 = A.split_bf16x3(x)
    got = torch.zeros(32, 24, dtype=torch.float32)
    for part in (x3, x2, x1):
        got = got + part.float() @ b.float()
    want = (x.double() @ b.double()).float()
    bound = (3 * k + 2) * 2.0 ** -24 * (x.double().abs()
                                        @ b.double().abs())
    assert bool(((got.double() - want.double()).abs() <= bound).all())


@pytest.mark.parametrize("kernel", FLASH)
def test_bf16_flash_instances_name_the_split_peak(kernel):
    """The bf16 instances: S and dP at the bf16 rate, the products with
    P or dS at a third of it; the f32 instances at 3xTF32's rate."""
    mask = torch.ones(2, 100, dtype=torch.bool)
    f32 = A.kernel_cost(mask, 100, 3, 64, kernel)
    bf = A.kernel_cost(mask, 100, 3, 64, kernel + "_bf16")
    assert (f32["peak"], f32["peak_flops"]) == PEAK_3XTF32
    assert PEAK_BF16X3[0] in bf["peak"] and PEAK_3XTF32[0] not in bf["peak"]
    assert bf["peak"].startswith(PEAK_BF16[0])
    assert PEAK_BF16X3[1] == pytest.approx(989e12 / 3)
    n, nb = PRODUCTS[kernel]
    assert bf["peak_flops"] == pytest.approx(
        n / (nb / PEAK_BF16[1] + (n - nb) / PEAK_BF16X3[1]))


@pytest.mark.parametrize("kernel,ratio", [
    # the old bound divided the f32-operand products by 3xTF32's rate
    ("flash_bwd_dq_kernel", (2 / 989 + 3 / 989) / (2 / 989 + 3 / 495)),
    ("flash_bwd_dkv_kernel", (2 / 989 + 6 / 989) / (2 / 989 + 6 / 495)),
    ("flash_fwd_kernel", (1 / 989 + 3 / 989) / (1 / 989 + 3 / 495)),
    ("flash_bwd_fused_kernel", (2 / 989 + 9 / 989) / (2 / 989 + 9 / 495)),
])
def test_bf16_bounds_by_the_formula(kernel, ratio):
    """Each bf16 instance's operations bound: the products of two bf16
    inputs over 989 TFLOP/s plus the rest over 989/3; a fixed fraction of
    the old bound (the rest over 495/3), on any mask."""
    rng = np.random.default_rng(1)
    t, h, d = 300, 2, 64
    mask = torch.from_numpy(np.arange(t)[None, :]
                            < rng.integers(1, t + 1, (3, 1)))
    cost = A.kernel_cost(mask, t, h, d, kernel + "_bf16")
    n, nb = PRODUCTS[kernel]
    assert cost["flops_bf16"] == pytest.approx(cost["flops"] * nb / n)
    seconds = (cost["flops_bf16"] / PEAK_BF16[1]
               + (cost["flops"] - cost["flops_bf16"]) / PEAK_BF16X3[1])
    assert cost["flops"] / cost["peak_flops"] == pytest.approx(seconds)
    old = (cost["flops_bf16"] / PEAK_BF16[1]
           + (cost["flops"] - cost["flops_bf16"]) / PEAK_3XTF32[1])
    assert seconds / old == pytest.approx(ratio)
