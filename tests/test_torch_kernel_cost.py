"""What the port's kernel costs name: the peak each kernel's operations
bound divides by, and the work it does on a given mask. No card needed.

The flash forward and the GNN weight pass run their products as 3xTF32
on the tensor cores; the forward skips key tiles with no real key, as the
backward kernels do. The weight pass cuts its rows by the row count and
width alone."""

import numpy as np
import pytest
import torch

from deepdfa_tpu_torch.ops import (PEAK_3XTF32, PEAK_BF16, PEAK_BF16X3,
                                   PEAK_BYTES_PER_S, PEAK_F32_SIMT)
from deepdfa_tpu_torch.ops import attention as A
from deepdfa_tpu_torch.ops import fused_gnn
from deepdfa_tpu_torch.ops.band_spmm import build_band_adjacency

FLASH = ("flash_fwd_kernel", "flash_bwd_fused_kernel", "flash_bwd_dq_kernel",
         "flash_bwd_dkv_kernel")
# Products of a [T, T] by [T, D] shape each flash kernel does.
PRODUCTS = {"flash_fwd_kernel": 2, "flash_bwd_fused_kernel": 5,
            "flash_bwd_dq_kernel": 3, "flash_bwd_dkv_kernel": 4}


def _mask(t, lengths, hole=None):
    keep = np.arange(t)[None, :] < np.asarray(lengths)[:, None]
    if hole is not None:
        keep[0, hole[0]:hole[1]] = False
    return torch.from_numpy(keep)


def _tiles(t, causal):
    """(query tile, key tile) pairs a kernel runs with every key real:
    causal ones wholly above the diagonal skipped."""
    n = -(-t // 64)
    return sum(1 for qt in range(n) for kt in range(n)
               if not causal or kt <= qt)


@pytest.mark.parametrize("kernel", FLASH)
def test_every_flash_kernel_names_the_3xtf32_peak(kernel):
    cost = A.kernel_cost(torch.ones(2, 100, dtype=torch.bool), 100, 3, 64,
                         kernel)
    assert cost["peak"] == PEAK_3XTF32[0]
    assert cost["peak_flops"] == pytest.approx(495e12 / 3)


@pytest.mark.parametrize("kernel", FLASH)
@pytest.mark.parametrize("t,lengths,hole,causal,dead", [
    (512, [300], None, False, 3),            # a tail: key tiles 5-7
    (512, [512], (64, 320), False, 4),       # inside a row: tiles 1-4
    (256, [256, 0], None, False, 4),         # an all-pad row
    (200, [200, 70], (0, 128), True, 4),     # causal; ragged T; a hole
    (130, [130], None, False, 0),            # ragged T, nothing dead
])
def test_executed_flops_drop_by_exactly_the_dead_tiles(kernel, t, lengths,
                                                       hole, causal, dead):
    h, d = 3, 64
    mask = _mask(t, lengths, hole)
    cost = A.kernel_cost(mask, t, h, d, kernel, causal)
    assert cost["dead_key_tiles"] == h * dead
    unit = 2.0 * PRODUCTS[kernel] * h * d * 64 * 64
    full = len(lengths) * _tiles(t, causal)
    # Each dead key tile takes out the query tiles it meets: all of them,
    # or (causal) those at or after it.
    nq = -(-t // 64)
    padded = np.zeros((len(lengths), nq * 64), bool)
    padded[:, :t] = mask.numpy()
    gone = sum(nq - kt if causal else nq
               for row in padded.reshape(len(lengths), nq, 64)
               for kt, tile in enumerate(row) if not tile.any())
    assert cost["executed_flops"] == unit * (full - gone)
    whole = A.kernel_cost(torch.ones(len(lengths), t, dtype=torch.bool), t,
                          h, d, kernel, causal)
    assert whole["executed_flops"] == unit * full
    assert whole["dead_key_tiles"] == 0


def test_forward_runs_no_tile_of_an_all_pad_batch():
    cost = A.kernel_cost(torch.zeros(2, 300, dtype=torch.bool), 300, 2, 64,
                         "flash_fwd_kernel")
    assert cost["flops"] == cost["executed_flops"] == 0
    assert cost["dead_key_tiles"] == 2 * 2 * 5


def _band(n=256, tile=64):
    rng = np.random.default_rng(0)
    s = rng.integers(0, n, 400)
    r = np.clip(s + rng.integers(-20, 20, 400), 0, n - 1)
    return build_band_adjacency(s, r, np.ones(400, bool), n, tile=tile)


@pytest.mark.parametrize("kernel", fused_gnn.KERNELS)
def test_gnn_peaks_by_kernel(kernel):
    cost = fused_gnn.kernel_cost(_band(), 32, 5, kernel=kernel)
    if kernel.endswith("_bf16"):
        # The bf16 x bf16 products at the bf16 rate, the rest at f32
        # SIMT's: one rate between the two.
        assert cost["peak"].startswith(PEAK_BF16[0])
        assert PEAK_F32_SIMT[1] < cost["peak_flops"] < PEAK_BF16[1]
        return
    want = (PEAK_3XTF32 if kernel == "step_weight_grad_kernel"
            else PEAK_F32_SIMT)
    assert (cost["peak"], cost["peak_flops"]) == want


@pytest.mark.parametrize("n,hidden,rows,splits", [
    (16384, 128, 864, 19),  # the training batch: 7 tiles, 19 splits
    (1000, 128, 64, 16),
    (333, 64, 32, 11),      # 5 tiles, 27 wanted; a slab is the floor
    (100, 30, 32, 4),
    (16384, 256, 3296, 5),  # 28 tiles (two a side), 5 splits
])
def test_weight_pass_splits_follow_rows_and_width(n, hidden, rows, splits):
    got = fused_gnn.wgrad_rows_per_split(n, hidden)
    assert got == rows and -(-n // got) == splits
    assert got % fused_gnn.WGRAD_SLAB_ROWS == 0


@pytest.mark.parametrize("n,tile,hidden", [(256, 64, 32), (1024, 128, 128)])
def test_fused_step_bytes_count_every_launch(n, tile, hidden):
    # K launches of fused_step_kernel move h in and out, the band and the
    # weights K times; the persistent kernel's one launch moves them once.
    # Both do K steps of operations; at the published width (H 128) they
    # stay bound by them.
    adj = _band(n, tile)
    one = fused_gnn.kernel_cost(adj, hidden, 1)
    five = fused_gnn.kernel_cost(adj, hidden, 5)
    assert five["flops"] == 5 * one["flops"]
    assert five["bytes"] == 5 * one["bytes"]
    p1 = fused_gnn.kernel_cost(adj, hidden, 1, "persistent_fwd_kernel")
    p5 = fused_gnn.kernel_cost(adj, hidden, 5, "persistent_fwd_kernel")
    assert p1 == one
    assert p5["bytes"] == one["bytes"] and p5["flops"] == five["flops"]
    for cost in (one, five, p5) if hidden == 128 else ():
        assert (cost["flops"] / cost["peak_flops"]
                > cost["bytes"] / PEAK_BYTES_PER_S)


@pytest.mark.parametrize("f32_vals", [False, True])
def test_bf16_backward_costs_bytes_and_rates(f32_vals):
    """The fused lane's bf16 backward instances: bf16 arrays at 2 bytes
    an element (dp and dmsg f32), the products of two bf16 values at the
    bf16 tensor-core rate and the rest at its own: with f32 band values
    (f32 messages) A^T dx leaves the bf16 rate for the f32 SIMT one,
    dmsg W_e^T and the weight pass's h^T dmsg for a third of the bf16 rate
    (the kernels split f32 dmsg into three bf16 parts)."""
    import dataclasses

    adj = _band(256, 64)
    if f32_vals:
        adj = dataclasses.replace(adj, vals=adj.vals.float())
    n, h, k = 256, 32, 5
    nnz = int(torch.count_nonzero(adj.vals))
    band = adj.vals.numel() * adj.vals.element_size()
    plane = 2.0 * n * h
    edge, gate, sparse = 2.0 * n * h * h, 12.0 * n * h * h, 2.0 * nnz * h
    bwd = fused_gnn.kernel_cost(adj, h, 1, "fused_step_bwd_kernel_bf16")
    assert bwd["bytes"] == (14 * plane + 2 * band
                            + (7 * h * h + 7 * h) * 2 + 7 * h * h * 2)
    msg = 0.0 if f32_vals else 2 * sparse + edge
    assert bwd["flops_bf16"] == edge + 2 * gate + msg
    assert bwd["flops"] == edge + 2 * gate + 2 * sparse + edge + 50.0 * n * h
    seconds = (bwd["flops_bf16"] / PEAK_BF16[1]
               + (edge if f32_vals else 0.0) / PEAK_BF16X3[1]
               + ((2 * sparse if f32_vals else 0.0) + 50.0 * n * h)
               / PEAK_F32_SIMT[1])
    assert bwd["peak_flops"] == pytest.approx(bwd["flops"] / seconds)
    assert (PEAK_BF16X3[0] in bwd["peak"]) == f32_vals
    wgrad = fused_gnn.kernel_cost(adj, h, k, "step_weight_grad_kernel_bf16")
    assert wgrad["bytes"] == k * 12 * plane + (7 * h * h + 7 * h) * 4
    assert wgrad["flops_bf16"] == k * (gate + (0.0 if f32_vals else edge))
    assert wgrad["flops"] == k * (gate + edge + 7.0 * n * h)
    seconds = (wgrad["flops_bf16"] / PEAK_BF16[1]
               + (k * edge if f32_vals else 0.0) / PEAK_BF16X3[1]
               + k * 7.0 * n * h / PEAK_F32_SIMT[1])
    assert wgrad["peak_flops"] == pytest.approx(wgrad["flops"] / seconds)
    assert (PEAK_BF16X3[0] in wgrad["peak"]) == f32_vals
    assert PEAK_3XTF32[0] not in wgrad["peak"]
    for cost in (bwd, wgrad):
        assert cost["peak"].startswith(PEAK_BF16[0])


@pytest.mark.parametrize("f32_vals", [False, True])
def test_bf16_persistent_costs_bytes_and_rates(f32_vals):
    """The persistent lane's bf16 instances: the hist sweep does K - 1
    forward steps with h_0 in and K - 1 bf16 planes out; the reverse
    sweep does K of ``fused_step_bwd_kernel_bf16``'s steps with h_0, the
    K - 1 hist planes and g in, dh out, each step's x (bf16), dp and dmsg
    (f32) out, A, A^T and the weights once; the products of two bf16
    values at the bf16 rate, the rest at its own."""
    import dataclasses

    adj = _band(256, 64)
    if f32_vals:
        adj = dataclasses.replace(adj, vals=adj.vals.float())
    n, h, k = 256, 32, 5
    band = adj.vals.numel() * adj.vals.element_size()
    weights = (7 * h * h + 7 * h) * 2
    plane = 2.0 * n * h
    fwd = fused_gnn.kernel_cost(adj, h, 1, "persistent_fwd_kernel_bf16")
    hist = fused_gnn.kernel_cost(adj, h, k, "persistent_fwd_hist_kernel_bf16")
    assert hist["bytes"] == k * plane + band + weights
    assert hist["flops"] == (k - 1) * fwd["flops"]
    assert hist["flops_bf16"] == (k - 1) * fwd["flops_bf16"]
    one = fused_gnn.kernel_cost(adj, h, 1, "fused_step_bwd_kernel_bf16")
    bwd = fused_gnn.kernel_cost(adj, h, k, "persistent_bwd_kernel_bf16")
    fixed = 2 * band + weights + 7 * h * h * 2
    assert bwd["bytes"] == (k + 2) * plane + k * 11 * plane + fixed
    assert one["bytes"] == 14 * plane + fixed
    assert bwd["flops"] == k * one["flops"]
    assert bwd["flops_bf16"] == k * one["flops_bf16"]
    for cost in (hist, bwd):
        assert cost["peak_flops"] == pytest.approx(
            fwd["peak_flops"] if cost is hist else one["peak_flops"])
        assert cost["peak"].startswith(PEAK_BF16[0])
        assert (PEAK_F32_SIMT[0] in cost["peak"])


def test_bf16_tile_cost_bytes_and_rate():
    """``tile_spmm_kernel_bf16``: msg's sender rows and the output at 2
    bytes an element, the lists as at f32; bf16-exact multiplicities make
    the products bf16 x bf16 (the bf16 tensor-core rate), a multiplicity
    of 300 keeps them f32 (the reference upcasts msg)."""
    from deepdfa_tpu_torch.ops import tile_spmm as T

    s = np.array([0, 1, 2, 3, 3])
    r = np.array([1, 2, 3, 0, 0])
    adj = T.build_csr_adjacency(s, r, np.ones(5, bool), 8)
    f32 = T.kernel_cost(adj, 16, tile=8)
    bf16 = T.kernel_cost(adj, 16, tile=8, dtype=torch.bfloat16)
    lists = 8.0 * adj.nnz + 4.0 * adj.ptr.numel()
    assert f32["bytes"] - lists == 2 * (bf16["bytes"] - lists)
    assert bf16["flops"] == f32["flops"] == 2.0 * adj.nnz * 16
    assert (bf16["peak"], bf16["peak_flops"]) == PEAK_BF16
    assert (f32["peak"], f32["peak_flops"]) == PEAK_F32_SIMT
    heavy = T.build_csr_adjacency(np.zeros(300, np.int64),
                                  np.ones(300, np.int64), np.ones(300, bool),
                                  8)
    assert T.kernel_cost(heavy, 16, tile=8,
                         dtype=torch.bfloat16)["peak"] == PEAK_F32_SIMT[0]
