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
rows in row order, the running sum in the data's dtype (bf16: rounded
after each add), one warp a (bucket, column slab). It finds each
bucket's rows in sorted keys by a search of its own, so it takes no
offsets. Its :class:`SegmentPlan` is the ids themselves where the
caller says that, keyed, they are non-decreasing
(``indices_are_sorted``, the reference's ``jax.ops.segment_sum`` flag:
the pooling's ``node_graph``), and otherwise one stable sort of the
int32 keys (the segment lane builds one a forward). Neither reads
anything back to the host, so a CUDA graph captures the call; and its
sums take one order whatever the threads do, where ``index_add_``'s
atomics take the order the threads arrive in. It replaces no Pallas
kernel: the reference leaves ``jax.ops.segment_sum`` to XLA. Its bound
is the bytes it reads (each kept row once); at the shapes the port gives
it, a launch costs more.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch

from deepdfa_tpu_torch.ops import count_launch

#: The kernels of this module, by name (``launch_counts``).
KERNELS = ("segment_sum_kernel", "segment_sum_kernel_bf16")

Rows = Union[torch.Tensor, Tuple[torch.Tensor, ...]]

#: ``segment_sum_lanes``' names of the kernel's lane kinds.
LANE_KINDS = ("scalar", "narrow", "wide")


class SegmentPlan(NamedTuple):
    """How the kernel finds each bucket's rows: ids on their device,
    built with no host read (:func:`segment_sum_plan`). ``ids``: the ids
    in row order (int32), keyed by ``mask`` where it is given (a row where
    it is False is in no bucket: its key is ``num_segments``), already
    keyed where it is None. ``order`` None: the keyed ids are
    non-decreasing (the caller's word), and ``keys`` is ``ids``, searched
    as it is. Else ``keys`` is the keyed ids sorted by one stable sort,
    ``order`` (int64) the rows in that order, and ``mask`` None: bucket
    ``s`` owns ``order[k]`` for the ``k`` where ``keys[k] == s``, in row
    order."""

    ids: torch.Tensor
    keys: torch.Tensor
    order: Optional[torch.Tensor]
    mask: Optional[torch.Tensor]
    num_segments: int

    def keyed(self) -> torch.Tensor:
        """The keyed ids in row order (what the plain version and the
        backward read)."""
        return _bucket_ids(self.ids, self.num_segments, self.mask)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int,
                mask: Optional[torch.Tensor] = None,
                plan: Optional[SegmentPlan] = None) -> torch.Tensor:
    """Sum rows of ``data`` into ``num_segments`` buckets. Callers zero
    padded rows first (padded ids point at slot 0); ``mask`` (False on
    those rows) also leaves them out of every bucket
    (:func:`_bucket_ids`). bf16 data: the running sum of each bucket
    rounds to bf16 after each row, in row order. ``plan``: the plan of
    these ids and mask, when the caller reuses one; CUDA data (f32 or
    bf16) is summed by :func:`segment_sum_rows`, the kernel, over it or
    over a plan of its own."""
    if data.is_cuda:
        if plan is None:
            plan = segment_sum_plan(segment_ids, num_segments, mask)
        return _SegmentSum.apply(data, plan.keyed(), num_segments, plan)
    ids = (plan.keyed() if plan is not None
           else _bucket_ids(segment_ids, num_segments, mask))
    if data.dtype == torch.bfloat16:
        return _SegmentSum.apply(data, ids, num_segments, None)
    out = torch.zeros((num_segments + 1,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device).index_add_(
        0, ids, data)
    return out[:num_segments]


def _bucket_ids(segment_ids: torch.Tensor, num_segments: int,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The ids as int32; with ``mask``, rows where it is False take the
    id ``num_segments``, which names no bucket: a plan sorts them last and
    no bucket's chain of adds walks them (a batch's padded edges all
    point at node 0)."""
    ids = segment_ids.int()
    if mask is None:
        return ids
    return torch.where(mask, ids, num_segments)


def segment_sum_plan(segment_ids: torch.Tensor, num_segments: int,
                     mask: Optional[torch.Tensor] = None, *,
                     indices_are_sorted: bool = False) -> SegmentPlan:
    """The kernel's :class:`SegmentPlan` of ``segment_ids`` and ``mask``,
    on the ids' device with no host read. ``indices_are_sorted`` (the
    reference's ``jax.ops.segment_sum`` flag): the caller's word that the
    keyed ids are non-decreasing, and the plan is the ids and the mask as
    they are (no op for int32 ids and a bool mask); else the keying and
    one stable sort of the int32 keys."""
    if indices_are_sorted:
        ids = segment_ids.int().contiguous()
        mask = None if mask is None else mask.bool().contiguous()
        return SegmentPlan(ids, ids, None, mask, num_segments)
    ids = _bucket_ids(segment_ids, num_segments, mask)
    keys, order = torch.sort(ids, stable=True)
    return SegmentPlan(ids, keys, order, None, num_segments)


def segment_sum_rows(data: Rows, plan: SegmentPlan) -> Rows:
    """Each bucket's rows added in row order, the running sum in the
    data's dtype (f32 or bf16), the buckets' rows found by ``plan``
    (:func:`segment_sum_plan`). ``data`` is a tensor, or a tuple of up to
    two tensors with the same rows and dtype summed by the same plan in
    one launch (a tuple back). CUDA tensors: ``segment_sum_kernel``
    (bf16: ``segment_sum_kernel_bf16``), one launch, or an exception; CPU
    tensors: the plain version, :func:`_segment_sum_ordered`, which
    checks a sorted plan's ids (ValueError where they decrease). No
    gradient (:func:`segment_sum` carries it)."""
    parts = tuple(data) if isinstance(data, (tuple, list)) else (data,)
    n_seg = plan.num_segments
    if not parts[0].is_cuda:
        keyed = plan.keyed()
        if plan.order is None and bool((keyed[1:] < keyed[:-1]).any()):
            raise ValueError(
                "a sorted plan's keyed segment ids (masked rows keyed to "
                "num_segments) decrease")
        out = tuple(_segment_sum_ordered(x, keyed, n_seg) for x in parts)
        return out if isinstance(data, (tuple, list)) else out[0]
    dtype = parts[0].dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(
            f"segment_sum_kernel takes float32 or bfloat16 data, got "
            f"{dtype}")
    if len(parts) > 2:
        raise NotImplementedError(
            f"segment_sum_kernel sums up to 2 operands a launch, got "
            f"{len(parts)}")
    n = parts[0].shape[0]
    for x in parts:
        if x.dtype != dtype or x.device != parts[0].device or \
                x.shape[:1] != (n,):
            raise ValueError(
                f"segment_sum_rows operands {[tuple(p.shape) for p in parts]}"
                f" of {[p.dtype for p in parts]} differ in rows, dtype or "
                f"device")
    if plan.keys.device != parts[0].device or plan.keys.shape != (n,):
        raise ValueError(
            f"segment ids {tuple(plan.keys.shape)} on {plan.keys.device} do "
            f"not match data {tuple(parts[0].shape)} on {parts[0].device}")
    from deepdfa_tpu_torch.ops import _build

    parts = tuple(x.contiguous() for x in parts)
    outs = tuple(torch.empty((n_seg,) + tuple(x.shape[1:]), dtype=dtype,
                             device=x.device) for x in parts)
    bf16 = dtype == torch.bfloat16
    with torch.cuda.device(parts[0].device):
        err = _build.load("segment_sum").segment_sum_launch(
            plan.keys.data_ptr(),
            None if plan.mask is None else plan.mask.data_ptr(),
            None if plan.order is None else plan.order.data_ptr(), n,
            *_operand_args(parts, outs), n_seg, int(bf16),
            torch.cuda.current_stream(parts[0].device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"segment_sum_kernel launch failed: cudaError_t "
                           f"{err}")
    count_launch(segment_sum_rows, "launches_bf16" if bf16 else "launches")
    return outs if isinstance(data, (tuple, list)) else outs[0]


segment_sum_rows.launches = segment_sum_rows.launches_bf16 = 0


def _operand_args(parts: Tuple[torch.Tensor, ...],
                  outs: Tuple[torch.Tensor, ...]) -> list:
    """(data, out, cols) of each of the kernel's two operands, the second
    (None, None, 0) where the call has one."""
    args = []
    for x, o in zip(parts, outs):
        args += [x.data_ptr(), o.data_ptr(), math.prod(x.shape[1:])]
    return args + [None, None, 0] * (2 - len(parts))


def segment_sum_lanes(data: Rows, out: Rows) -> Tuple[str, ...]:
    """The lane kind (``LANE_KINDS``) of each operand of a kernel call
    that summed ``data`` (CUDA tensors, contiguous) into ``out``: what the
    launcher chose from their widths, alignment and bucket count."""
    from deepdfa_tpu_torch.ops import _build

    parts = tuple(data) if isinstance(data, (tuple, list)) else (data,)
    outs = tuple(out) if isinstance(out, (tuple, list)) else (out,)
    lanes = (ctypes.c_int * 2)()
    err = _build.load("segment_sum").segment_sum_lanes(
        *_operand_args(parts, outs), outs[0].shape[0],
        int(parts[0].dtype == torch.bfloat16), lanes)
    if err != 0:
        raise RuntimeError(f"segment_sum_lanes failed: cudaError_t {err}")
    return tuple(LANE_KINDS[k] for k in lanes[:len(parts)])


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
    """The segment sum with XLA's transpose of a segment sum as its
    backward: each row's gradient is its bucket's, gathered by the keyed
    ids (exact at any dtype; no plan needed). The forward is
    :func:`segment_sum_rows` over ``plan``, or (CPU, no plan) the plain
    version. Autograd of the forward's level loop would gather the same
    values but give the all-zero rows the loop leaves out none. Rows of
    id ``num_segments`` (masked) are in no bucket: zero gradient."""

    @staticmethod
    def forward(ctx, data, ids, num_segments, plan):
        ctx.save_for_backward(ids)
        if plan is None:
            return _segment_sum_ordered(data, ids, num_segments)
        return segment_sum_rows(data, plan)

    @staticmethod
    def backward(ctx, g):
        (segment_ids,) = ctx.saved_tensors
        g = torch.cat([g, g.new_zeros((1,) + tuple(g.shape[1:]))])
        return g[segment_ids], None, None, None


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
