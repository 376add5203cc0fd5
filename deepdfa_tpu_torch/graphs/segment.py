"""Segment ops (port of ``deepdfa_tpu/graphs/segment.py``): masked
per-segment sums and softmax with ``index_add_`` and ``scatter_reduce``,
and the dense assignment matrix that turns a masked segment sum into a
matmul.
"""

from __future__ import annotations

from typing import Optional

import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Sum rows of ``data`` into ``num_segments`` buckets. Callers zero
    padded rows first (padded ids point at slot 0)."""
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    return out.index_add_(0, segment_ids.long(), data)


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
    zero weight."""
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
