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
"""

from __future__ import annotations

from typing import Optional

import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Sum rows of ``data`` into ``num_segments`` buckets. Callers zero
    padded rows first (padded ids point at slot 0). bf16 data: the running
    sum of each bucket rounds to bf16 after each row, in row order."""
    if data.dtype == torch.bfloat16:
        return _SegmentSumBf16.apply(data, segment_ids, num_segments)
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    return out.index_add_(0, segment_ids.long(), data)


def _segment_sum_bf16(data: torch.Tensor, segment_ids: torch.Tensor,
                      num_segments: int) -> torch.Tensor:
    """bf16 segment sums with one rounding an add, rows in order. Level j
    adds each bucket's j-th row (ranks by row order), so a bucket's adds
    run in its rows' order; all-zero rows change no sum (the running sum
    starts at +0 and x + 0 = x) and are left out, which drops the padding
    that callers zero."""
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    keep = (data != 0).reshape(data.shape[0], -1).any(1)
    rows = torch.nonzero(keep)[:, 0]
    if rows.numel() == 0:
        return out
    ids = segment_ids.long()[rows]
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


class _SegmentSumBf16(torch.autograd.Function):
    """:func:`_segment_sum_bf16` with XLA's transpose of a segment sum as
    its backward: each row's gradient is its bucket's, gathered (exact at
    any dtype). Autograd of the forward's level loop would gather the
    same values but give the all-zero rows the loop leaves out none."""

    @staticmethod
    def forward(ctx, data, segment_ids, num_segments):
        ctx.save_for_backward(segment_ids)
        return _segment_sum_bf16(data, segment_ids, num_segments)

    @staticmethod
    def backward(ctx, g):
        (segment_ids,) = ctx.saved_tensors
        return g[segment_ids.long()], None, None


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
