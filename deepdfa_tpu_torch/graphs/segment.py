"""Segment ops (port of ``deepdfa_tpu/graphs/segment.py``): masked
per-segment sums and softmax with ``index_add_`` and ``scatter_reduce``,
and the dense assignment matrix that turns a masked segment sum into a
matmul.

bf16 data: the reference's ``jax.ops.segment_sum`` on bf16 data adds on
XLA's CPU backend one update at a time, in update order, rounding the
running sum to bf16 after each add (its scatter's combiner runs in bf16;
an f32 sum rounded once differs from it by several bf16 steps on a
pooled graph of a few hundred nodes). :func:`segment_sum` adds bf16 data
the same way, in row order, one pass over the rows of each rank within
their segment; its backward is XLA's transpose, a gather of each row's
bucket gradient. :func:`segment_softmax` on bf16 logits rounds each op to
bf16, as the reference's does.

On the card :func:`segment_sum` is a hand kernel (``csrc/segment_sum.cu``,
``segment_sum_kernel`` and ``segment_sum_kernel_bf16``): each bucket's
rows in row order, one thread a (bucket, column), the running sum in the
data's dtype (bf16: rounded after each add). Its index plan
(:func:`segment_sum_plan`: the rows ordered by bucket by a stable device
sort, the buckets' offsets from a ``scatter_add_`` of ones and a
``cumsum``) reads nothing back to the host, so a CUDA graph captures it;
and its sums take one order whatever the threads do, where
``index_add_``'s atomics take the order the threads arrive in. It
replaces no Pallas kernel: the reference leaves ``jax.ops.segment_sum``
to XLA. It is bound by the bytes it reads (each row once).
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from deepdfa_tpu_torch.ops import count_launch

#: The kernels of this module, by name (``launch_counts``).
KERNELS = ("segment_sum_kernel", "segment_sum_kernel_bf16")


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sum rows of ``data`` into ``num_segments`` buckets. Callers zero
    padded rows first (padded ids point at slot 0); ``mask`` (False on
    those rows) also leaves them out of every bucket
    (:func:`_bucket_ids`). bf16 data: the running sum of each bucket
    rounds to bf16 after each row, in row order. CUDA data (f32 or bf16):
    :func:`segment_sum_rows`, the kernel."""
    ids = _bucket_ids(segment_ids, num_segments, mask)
    if data.is_cuda or data.dtype == torch.bfloat16:
        return _SegmentSum.apply(data, ids, num_segments)
    rows = num_segments if mask is None else num_segments + 1
    out = torch.zeros((rows,) + tuple(data.shape[1:]), dtype=data.dtype,
                      device=data.device).index_add_(0, ids, data)
    return out[:num_segments]


def _bucket_ids(segment_ids: torch.Tensor, num_segments: int,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The ids as int64; with ``mask``, rows where it is False take the
    id ``num_segments``, which names no bucket: the plan sorts them last
    and no bucket's chain of adds walks them (a batch's padded edges all
    point at node 0)."""
    ids = segment_ids.long()
    if mask is None:
        return ids
    return torch.where(mask, ids, num_segments)


def segment_sum_plan(segment_ids: torch.Tensor, num_segments: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's index plan, on the ids' device with no host read:
    ``order``, the row indices sorted by bucket (stable, so row order
    within a bucket; rows of id ``num_segments`` last), and ``offsets``
    [num_segments + 1], where bucket ``s`` owns
    ``order[offsets[s]:offsets[s + 1]]`` (int64 both)."""
    ids = segment_ids.long()
    order = torch.argsort(ids, stable=True)
    counts = torch.zeros(num_segments + 1, dtype=torch.long,
                         device=ids.device).scatter_add_(
        0, ids, torch.ones_like(ids))
    offsets = torch.cat([counts.new_zeros(1),
                         torch.cumsum(counts[:num_segments], 0)])
    return order, offsets


def segment_sum_rows(data: torch.Tensor, segment_ids: torch.Tensor,
                     num_segments: int,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Each bucket's rows added in row order, the running sum in the
    data's dtype (f32 or bf16); ``mask`` as :func:`segment_sum`'s. CUDA
    tensors: ``segment_sum_kernel`` (bf16: ``segment_sum_kernel_bf16``)
    over :func:`segment_sum_plan`, or an exception; CPU tensors: the plain
    version, :func:`_segment_sum_ordered`. No gradient
    (:func:`segment_sum` carries it)."""
    segment_ids = _bucket_ids(segment_ids, num_segments, mask)
    if not data.is_cuda:
        return _segment_sum_ordered(data, segment_ids, num_segments)
    if data.dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(
            f"segment_sum_kernel takes float32 or bfloat16 data, got "
            f"{data.dtype}")
    if segment_ids.device != data.device or segment_ids.shape[:1] != \
            data.shape[:1]:
        raise ValueError(
            f"segment ids {tuple(segment_ids.shape)} on "
            f"{segment_ids.device} do not match data {tuple(data.shape)} on "
            f"{data.device}")
    from deepdfa_tpu_torch.ops import _build

    data = data.contiguous()
    cols = math.prod(data.shape[1:])
    out = torch.empty((num_segments,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    order, offsets = segment_sum_plan(segment_ids, num_segments)
    bf16 = data.dtype == torch.bfloat16
    with torch.cuda.device(data.device):
        stream = ctypes.c_void_p(
            torch.cuda.current_stream(data.device).cuda_stream)
        err = _build.load("segment_sum").segment_sum_launch(
            ctypes.c_void_p(data.data_ptr()),
            ctypes.c_void_p(order.data_ptr()),
            ctypes.c_void_p(offsets.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), num_segments, cols, int(bf16),
            stream)
    if err != 0:
        raise RuntimeError(f"segment_sum_kernel launch failed: cudaError_t "
                           f"{err}")
    count_launch(segment_sum_rows, "launches_bf16" if bf16 else "launches")
    return out


segment_sum_rows.launches = segment_sum_rows.launches_bf16 = 0


def _segment_sum_ordered(data: torch.Tensor, segment_ids: torch.Tensor,
                         num_segments: int) -> torch.Tensor:
    """Segment sums with one rounding an add at the data's dtype, rows in
    order (the kernels' plain version, on any device). Level j adds each
    bucket's j-th row (ranks by row order), so a bucket's adds run in its
    rows' order; all-zero rows change no sum (the running sum starts at +0
    and x + 0 = x) and are left out, which drops the padding that callers
    zero."""
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    ids = segment_ids.long()
    keep = (data != 0).reshape(data.shape[0], -1).any(1) & (
        ids < num_segments)
    rows = torch.nonzero(keep)[:, 0]
    if rows.numel() == 0:
        return out
    ids = ids[rows]
    counts = torch.bincount(ids, minlength=num_segments)
    order = torch.argsort(ids, stable=True)
    rank = torch.empty_like(order)
    rank[order] = (torch.arange(order.numel(), device=ids.device)
                   - (torch.cumsum(counts, 0) - counts)[ids[order]])
    level = torch.argsort(rank, stable=True)  # rows by rank, then row order
    per_level = torch.bincount(rank).tolist()
    start = 0
    for n in per_level:
        pick = level[start:start + n]
        start += n
        dst = ids[pick]  # distinct buckets within a level
        out[dst] = out[dst] + data[rows[pick]]
    return out


class _SegmentSum(torch.autograd.Function):
    """:func:`segment_sum_rows` with XLA's transpose of a segment sum as
    its backward: each row's gradient is its bucket's, gathered (exact at
    any dtype). Autograd of the forward's level loop would gather the
    same values but give the all-zero rows the loop leaves out none.
    Rows of id ``num_segments`` (masked) are in no bucket: zero
    gradient."""

    @staticmethod
    def forward(ctx, data, segment_ids, num_segments):
        ctx.save_for_backward(segment_ids)
        return segment_sum_rows(data, segment_ids, num_segments)

    @staticmethod
    def backward(ctx, g):
        (segment_ids,) = ctx.saved_tensors
        g = torch.cat([g, g.new_zeros((1,) + tuple(g.shape[1:]))])
        return g[segment_ids], None, None


def launch_counts() -> Dict[str, int]:
    return {"segment_sum_kernel": segment_sum_rows.launches,
            "segment_sum_kernel_bf16": segment_sum_rows.launches_bf16}


def reset_launch_counts() -> None:
    segment_sum_rows.launches = segment_sum_rows.launches_bf16 = 0


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Per-segment max; empty segments come back as -inf."""
    out = torch.full((num_segments,) + tuple(data.shape[1:]), -torch.inf,
                     dtype=data.dtype, device=data.device)
    return out.scatter_reduce(0, segment_ids.long(), data, "amax",
                              include_self=True)


def segment_onehot(segment_ids: torch.Tensor, num_segments: int,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dense f32 assignment matrix ``M`` [num_segments, n]: ``M @ x`` is
    the masked ``segment_sum(x)`` as one matmul, whose backward is a
    matmul too. Structural: it carries no gradient."""
    m = segment_ids.long()[None, :] == torch.arange(
        num_segments, device=segment_ids.device)[:, None]
    if mask is not None:
        m = m & mask[None, :]
    return m.to(torch.float32)


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Numerically stable softmax within each segment; masked rows get
    zero weight. bf16 logits: each op rounds to bf16, the denominators
    sum in f32 (:func:`segment_sum`)."""
    if mask is not None:
        logits = torch.where(mask, logits, -torch.inf)
    seg_max = segment_max(logits, segment_ids, num_segments)
    seg_max = torch.where(torch.isneginf(seg_max), 0.0, seg_max)
    ids = segment_ids.long()
    exp = torch.exp(logits - seg_max[ids])
    if mask is not None:
        exp = torch.where(mask, exp, 0.0)
    denom = segment_sum(exp, segment_ids, num_segments)
    denom = torch.where(denom > 0, denom, 1.0)
    return exp / denom[ids]
