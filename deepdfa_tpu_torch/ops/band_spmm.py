"""Block-banded dense adjacency (port of ``deepdfa_tpu/ops/band_spmm.py``).

Batched graphs are contiguous node ranges and CFG edges never cross
graphs, so every nonzero tile of the batched adjacency sits within
``bandwidth`` tiles of the diagonal. The adjacency is stored as its 2B+1
block diagonals: ``vals[i, t]`` is the tile-row-t block whose senders
live in tile ``t + (i - B)``. :func:`band_spmm` aggregates with 2B+1
batched matmuls; it is plain XLA in the reference and stays plain torch
here.

The same fact gives the persistent CUDA kernel its work split: the host
cuts the rows into ranges that no edge crosses (:func:`closed_row_groups`)
so one thread block can own a range and keep its hidden state on chip
across all gated steps.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from deepdfa_tpu_torch.ops.tile import DEFAULT_TILE, _round_up_pow2, tile_vals_dtype

#: Rows a persistent-kernel row group aims for. A group is made of whole
#: closed components (graphs, or single padding rows), so a graph larger
#: than this becomes a group of its own. Small groups mean many thread
#: blocks: the serving bucket (1024 rows) splits into ~30 of them.
PERSISTENT_GROUP_ROWS = 32


@dataclasses.dataclass
class BandAdjacency:
    """The 2B+1 block diagonals of a batched-graph adjacency.

    vals : [2B+1, n_tiles, tile, tile]; ``vals[i, t, r, c]`` = multiplicity
           of edge (sender s, receiver r') with r' = t*tile + r and
           s = (t + i - B)*tile + c.
    row_groups : int32 [G+1] cut points ``0 = c_0 < ... < c_G = n_rows``;
           no edge joins two groups (``closed_row_groups``). None when the
           adjacency was not built from an edge list.
    max_group_rows : the largest ``c_{g+1} - c_g`` (host int, so the
           kernel's shared-memory gate needs no device read).

    :meth:`transpose_vals` builds A^T's block diagonals at first use and
    keeps them, so every backward over one batch reads the same A^T.
    """

    vals: torch.Tensor
    tile: int = DEFAULT_TILE
    n_tiles: int = 0
    bandwidth: int = 1
    row_groups: Optional[torch.Tensor] = None
    max_group_rows: int = 0
    _tvals: Optional[torch.Tensor] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    def to(self, device: Union[str, torch.device]) -> "BandAdjacency":
        return dataclasses.replace(
            self, vals=self.vals.to(device),
            row_groups=(None if self.row_groups is None
                        else self.row_groups.to(device)))

    def transpose_vals(self) -> torch.Tensor:
        """:func:`band_transpose_vals` of this band, built once."""
        if self._tvals is None:
            self._tvals = band_transpose_vals(self.vals, self.bandwidth,
                                              self.n_tiles)
        return self._tvals


def _bucket_bandwidth(b: int) -> int:
    return _round_up_pow2(max(b, 1))


def band_width_for(senders: np.ndarray, receivers: np.ndarray,
                   tile: int = DEFAULT_TILE) -> int:
    """The (pow2-bucketed) bandwidth these real edges need."""
    s = np.asarray(senders, np.int64)
    r = np.asarray(receivers, np.int64)
    if len(s) == 0:
        return 1
    return _bucket_bandwidth(int(np.abs(s // tile - r // tile).max()))


def closed_row_groups(senders: np.ndarray, receivers: np.ndarray,
                      n_rows: int,
                      target_rows: int = PERSISTENT_GROUP_ROWS) -> np.ndarray:
    """Cut ``[0, n_rows)`` into row ranges closed under the edges.

    A boundary ``b`` (between rows b-1 and b) is a valid cut when no edge
    has one endpoint below it and one at or above it. Groups are packed
    greedily: each extends to the furthest valid cut within
    ``target_rows``, or to the nearest valid cut beyond when one closed
    component alone is larger. Returns int32 cut points ``[0, ..., n]``.
    """
    s = np.asarray(senders, np.int64)
    r = np.asarray(receivers, np.int64)
    cover = np.zeros(n_rows + 2, np.int64)
    if len(s):
        lo, hi = np.minimum(s, r), np.maximum(s, r)
        np.add.at(cover, lo + 1, 1)
        np.add.at(cover, hi + 1, -1)
    crossed = np.cumsum(cover)[: n_rows + 1]
    cuts = np.flatnonzero(crossed == 0)  # always holds 0 and n_rows
    out = [0]
    while out[-1] < n_rows:
        start = out[-1]
        i = np.searchsorted(cuts, start + target_rows, side="right") - 1
        if cuts[i] <= start:
            i = np.searchsorted(cuts, start, side="right")
        out.append(int(cuts[i]))
    return np.asarray(out, np.int32)


def build_band_adjacency(
    senders: np.ndarray,
    receivers: np.ndarray,
    edge_mask: np.ndarray,
    max_nodes: int,
    tile: int = DEFAULT_TILE,
    bandwidth: Optional[int] = None,
) -> BandAdjacency:
    """Host-side: scatter edge multiplicities into the block diagonals
    (bf16 when every multiplicity is exact, as the reference), and cut
    the rows into closed groups for the persistent kernel."""
    if max_nodes % tile:
        raise ValueError(f"max_nodes {max_nodes} not a multiple of tile {tile}")
    n_tiles = max_nodes // tile
    mask = np.asarray(edge_mask, bool)
    s = np.asarray(senders)[mask].astype(np.int64)
    r = np.asarray(receivers)[mask].astype(np.int64)

    need = band_width_for(s, r, tile)
    bw = need if bandwidth is None else int(bandwidth)
    if bw < need:
        raise ValueError(f"bandwidth {bw} < required {need} for these edges")

    vals = np.zeros((2 * bw + 1, n_tiles, tile, tile), np.float32)
    if len(s):
        diag = (s // tile) - (r // tile) + bw
        np.add.at(vals, (diag, r // tile, r % tile, s % tile), 1.0)
    groups = closed_row_groups(s, r, max_nodes)
    return BandAdjacency(
        vals=torch.from_numpy(vals).to(tile_vals_dtype(s, r)),
        tile=tile,
        n_tiles=n_tiles,
        bandwidth=bw,
        row_groups=torch.from_numpy(groups),
        max_group_rows=int(np.diff(groups).max()),
    )


def vals_compute(adj: BandAdjacency, dt: torch.dtype
                 ) -> Tuple[torch.Tensor, torch.dtype]:
    """(vals, message dtype) under the upcast-only rule: f32 adjacency
    values (a multiplicity not bf16-exact) force f32 messages; otherwise
    the adjacency rides the model dtype. (The CUDA kernels read bf16 or
    f32 values as they are and upcast them in registers.)"""
    vals = adj.vals
    if vals.dtype == torch.float32 and dt != torch.float32:
        return vals, torch.float32
    return vals.to(dt), dt


def band_transpose_vals(vals: torch.Tensor, bandwidth: int,
                        n_tiles: int) -> torch.Tensor:
    """The block-band form of A^T from the block-band form of A:
    ``t_vals[e, c] = vals[2B-e, c+e-B]^T``, zero where the source row tile
    falls outside the batch (the reference's ``band_transpose_vals``,
    plain torch as it is plain XLA there). A row group closed under the
    edges stays closed under A^T."""
    w = 2 * bandwidth + 1
    outs = []
    for e in range(w):
        shift = e - bandwidth
        padded = F.pad(vals[w - 1 - e], (0, 0, 0, 0, bandwidth, bandwidth))
        sl = padded[shift + bandwidth: shift + bandwidth + n_tiles]
        outs.append(sl.transpose(1, 2))
    return torch.stack(outs).contiguous()


def transpose_band(adj: BandAdjacency) -> BandAdjacency:
    """A^T as a BandAdjacency (same tiles, bandwidth and row groups)."""
    return dataclasses.replace(adj, vals=adj.transpose_vals())


def band_spmm(adj: BandAdjacency, msg: torch.Tensor) -> torch.Tensor:
    """``agg = A @ msg`` over the block diagonals: one batched matmul
    ``[T, t, t] x [T, t, H]`` per diagonal, shifted sender tiles from a
    zero-padded slice (out-of-range senders contribute nothing), f32
    accumulation, the upcast-only dtype rule (:func:`vals_compute`)."""
    t, bw, n_tiles = adj.tile, adj.bandwidth, adj.n_tiles
    h = msg.shape[1]
    vals, mdt = vals_compute(adj, msg.dtype)
    m = msg.to(mdt).reshape(n_tiles, t, h)
    mp = F.pad(m, (0, 0, 0, 0, bw, bw))
    out = torch.zeros((n_tiles, t, h), dtype=torch.float32, device=msg.device)
    for i in range(2 * bw + 1):
        out = out + torch.bmm(vals[i].float(), mp[i:i + n_tiles].float())
    return out.reshape(n_tiles * t, h).to(msg.dtype)
