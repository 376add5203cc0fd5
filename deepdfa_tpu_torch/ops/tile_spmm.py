"""Block-sparse tile SpMM (port of ``deepdfa_tpu/ops/tile_spmm.py``).

Batched graphs are contiguous node ranges and CFG edges never cross
graphs, so the batched adjacency is block-sparse: aggregation is
``agg = A @ msg`` with A stored as a row-sorted list of dense
``tile x tile`` blocks (:class:`TileAdjacency`), and its transpose for
the VJP, built on the host by :func:`build_tile_adjacency` exactly as the
reference builds them (the same tiles, filler and pad tiles, bf16/f32
choice).

The product runs a hand-written CUDA kernel (``csrc/tile_spmm.cu``; its
header note says what bounds it and how it is laid out) with its plain
PyTorch version here:

- :func:`tile_spmm` launches ``tile_spmm_kernel``: one block per (row
  tile, 64-column chunk of H) walks its row's tiles; replaces the TPU
  kernel ``_spmm_kernel``. Plain version :func:`tile_spmm_reference`
  (the reference's ``_spmm_xla``: gather, ``torch.bmm`` in f32,
  ``index_add_`` by row tile).
- :class:`_TileSpmm` differentiates it in ``msg``, as the reference's
  ``custom_vjp``: ``d msg = A^T @ g`` by the same kernel over the
  transposed tiles. The adjacency gets no gradient.

The kernel walks each row tile's run ``[row_ptr[r], row_ptr[r + 1])``.
``row_ptr`` is the port's own addition to the reference's six arrays,
computed over the built tiles (those with an edge, and one zero filler
for each row tile no edge reaches), so the zero pad tiles that bring the
list up to its power-of-two budget, all on the last row tile, lie
outside every run: the kernel never multiplies them. The plain version
multiplies every tile.

Dispatch: the wrapper takes the plain version only for a tensor on the
CPU. For a CUDA tensor it launches the kernel or raises. It counts its
launches in ``tile_spmm.launches`` (:func:`launch_counts`), bumped where
the kernel is launched and nowhere else.

Not ported here (several GPUs): ``stack_tile_adjacencies``,
``tile_spmm_sharded`` and ``combine_tile_stats``.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

# The tile edge batching callers align node budgets to
# (:func:`align_to_tile`).
DEFAULT_TILE = 128
#: The largest tile the CUDA kernel takes (its shared-memory staging).
MAX_KERNEL_TILE = 128


def align_to_tile(n: int, tile: int = DEFAULT_TILE) -> int:
    return -(-n // tile) * tile


def _round_up_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def tile_vals_dtype(senders: np.ndarray, receivers: np.ndarray) -> torch.dtype:
    """Adjacency values are edge multiplicities: bf16 when every
    multiplicity is exactly representable (<= 256), else f32."""
    s = np.asarray(senders, np.int64)
    r = np.asarray(receivers, np.int64)
    if len(s) == 0:
        return torch.bfloat16
    key = r * (int(s.max()) + 1) + s
    _, counts = np.unique(key, return_counts=True)
    return torch.bfloat16 if counts.max() <= 256 else torch.float32


@dataclasses.dataclass
class TileAdjacency:
    """Sorted block-sparse adjacency plus its transpose (for the VJP).

    vals    : [n_nz, tile, tile] bf16 or f32, sorted by ``rows``;
              ``vals[k][i, j]`` = multiplicity of edge (sender s,
              receiver r) with r = rows[k]*tile + i, s = cols[k]*tile + j.
    rows    : int32 [n_nz] non-decreasing receiver tile indices; every
              row tile appears at least once (filler zero tiles).
    cols    : int32 [n_nz] sender tile indices.
    t_vals/t_rows/t_cols : the transposed adjacency in the same layout.
    row_ptr : int32 [n_row_tiles + 1]; row tile r's built tiles are
              ``[row_ptr[r], row_ptr[r + 1])``. Pad tiles (at and after
              ``row_ptr[-1]``) lie outside every row's range.
    t_row_ptr : the same for the transposed lists.
    """

    vals: torch.Tensor
    rows: torch.Tensor
    cols: torch.Tensor
    t_vals: torch.Tensor
    t_rows: torch.Tensor
    t_cols: torch.Tensor
    row_ptr: torch.Tensor
    t_row_ptr: torch.Tensor
    tile: int = DEFAULT_TILE
    n_row_tiles: int = 0

    def to(self, device: Union[str, torch.device]) -> "TileAdjacency":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})

    def transposed(self) -> "TileAdjacency":
        """A^T: the transposed lists in the forward's places."""
        return dataclasses.replace(
            self, vals=self.t_vals, rows=self.t_rows, cols=self.t_cols,
            t_vals=self.vals, t_rows=self.rows, t_cols=self.cols,
            row_ptr=self.t_row_ptr, t_row_ptr=self.row_ptr)


def _dense_tiles(rows: np.ndarray, cols: np.ndarray, data: np.ndarray,
                 tile: int, n_tiles: int, pad_nz: int,
                 dtype: torch.dtype = torch.float32
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """Group COO entries into sorted dense tiles with full row coverage,
    padded to ``pad_nz`` tiles: the reference's ``_dense_tiles``, byte
    for byte (``vals`` in ``dtype``, f32 there; ``rows``/``cols``
    int32), vectorised, plus the built tiles' ``row_ptr``.

    The reference's order: each row tile's edge tiles by column tile, a
    zero filler tile (col = row) for each row tile no edge reaches, then
    zero pad tiles on the last row tile. A row tile holds either edge
    tiles or its filler, so sorting the (row, col) keys of both gives
    that order."""
    r, c = np.asarray(rows, np.int64), np.asarray(cols, np.int64)
    edge_keys, slot = np.unique((r // tile) * n_tiles + c // tile,
                                return_inverse=True)
    covered = np.zeros(n_tiles, bool)
    covered[edge_keys // n_tiles] = True
    fillers = np.flatnonzero(~covered).astype(np.int64)
    keys = np.concatenate([edge_keys, fillers * n_tiles + fillers])
    order = np.argsort(keys, kind="stable")
    n_nz = len(keys)
    if pad_nz < n_nz:
        raise ValueError(f"tile budget {pad_nz} < {n_nz} nonzero tiles")
    pos = np.empty(n_nz, np.int64)  # sorted position of each tile
    pos[order] = np.arange(n_nz)
    # Sum each (tile, i, j) entry's data, then write the sums into zeros
    # of the final dtype (integer multiplicities are exact in f64, f32
    # and, up to 256, bf16).
    flat = (pos[slot.reshape(-1)] * tile + r % tile) * tile + c % tile
    entries, which = np.unique(flat, return_inverse=True)
    sums = np.bincount(which.reshape(-1), minlength=len(entries),
                       weights=np.asarray(data, np.float64))
    vals = torch.zeros((pad_nz, tile, tile), dtype=dtype)
    vals.view(-1)[torch.from_numpy(entries)] = torch.from_numpy(sums).to(
        dtype)
    out_rows = np.full(pad_nz, n_tiles - 1, np.int32)
    out_cols = np.full(pad_nz, n_tiles - 1, np.int32)
    out_rows[:n_nz] = keys[order] // n_tiles
    out_cols[:n_nz] = keys[order] % n_tiles
    row_ptr = np.searchsorted(out_rows[:n_nz], np.arange(n_tiles + 1))
    t = torch.from_numpy
    return vals, t(out_rows), t(out_cols), t(row_ptr.astype(np.int32))


def tile_nz_budget(senders: np.ndarray, receivers: np.ndarray,
                   max_nodes: int, tile: int = DEFAULT_TILE) -> int:
    """The pow2 tile budget :func:`build_tile_adjacency` picks for these
    (real) edges, without building any dense tiles."""
    n_tiles = max_nodes // tile
    s = np.asarray(senders, np.int64)
    r = np.asarray(receivers, np.int64)
    nz = len(np.unique((r // tile) * n_tiles + (s // tile)))
    nz = max(nz, n_tiles)
    return _round_up_pow2(nz + n_tiles)


def build_tile_adjacency(senders: np.ndarray, receivers: np.ndarray,
                         edge_mask: np.ndarray, max_nodes: int,
                         tile: int = DEFAULT_TILE,
                         pad_nz: Optional[int] = None) -> TileAdjacency:
    """Host-side: the sorted dense-tile adjacency of one batch and its
    transpose, ``A[r, s] += 1`` for each real edge (s, r). ``pad_nz``
    fixes the tile count; the default rounds to the next power of two
    (:func:`tile_nz_budget`). Values are bf16 when every multiplicity is
    exact there (:func:`tile_vals_dtype`), else f32."""
    if max_nodes % tile:
        raise ValueError(f"max_nodes {max_nodes} not a multiple of tile {tile}")
    n_tiles = max_nodes // tile
    mask = np.asarray(edge_mask)
    s = np.asarray(senders)[mask].astype(np.int64)
    r = np.asarray(receivers)[mask].astype(np.int64)
    data = np.ones(len(s), np.float32)
    if pad_nz is None:
        pad_nz = tile_nz_budget(s, r, max_nodes, tile)
    dt = tile_vals_dtype(s, r)
    vals, rows, cols, row_ptr = _dense_tiles(r, s, data, tile, n_tiles,
                                             pad_nz, dt)
    # A^T[s, r] = A[r, s]: swapping each edge's roles builds it directly.
    t_vals, t_rows, t_cols, t_row_ptr = _dense_tiles(s, r, data, tile,
                                                     n_tiles, pad_nz, dt)
    return TileAdjacency(
        vals=vals, rows=rows, cols=cols, t_vals=t_vals, t_rows=t_rows,
        t_cols=t_cols, row_ptr=row_ptr, t_row_ptr=t_row_ptr, tile=tile,
        n_row_tiles=n_tiles)


def cast_tiles(adj: TileAdjacency, dtype: torch.dtype) -> TileAdjacency:
    return dataclasses.replace(adj, vals=adj.vals.to(dtype),
                               t_vals=adj.t_vals.to(dtype))


def pad_tiles(adj: TileAdjacency, pad_nz: int) -> TileAdjacency:
    """Pad the tile lists to a larger budget with inert zero tiles on the
    last row tile (``rows`` stays sorted); ``row_ptr`` is unchanged, so
    the new tiles lie outside every row's range."""
    n_nz = int(adj.vals.shape[0])
    if pad_nz == n_nz:
        return adj
    if pad_nz < n_nz:
        raise ValueError(f"pad budget {pad_nz} < {n_nz} existing tiles")
    pad = pad_nz - n_nz
    last = adj.n_row_tiles - 1

    def pv(v):
        return torch.cat([v, v.new_zeros((pad,) + tuple(v.shape[1:]))])

    def pi(ix):
        return torch.cat([ix, torch.full((pad,), last, dtype=ix.dtype,
                                         device=ix.device)])

    return dataclasses.replace(
        adj, vals=pv(adj.vals), rows=pi(adj.rows), cols=pi(adj.cols),
        t_vals=pv(adj.t_vals), t_rows=pi(adj.t_rows), t_cols=pi(adj.t_cols))


# ---------------------------------------------------------------------------
# The product
# ---------------------------------------------------------------------------


def tile_spmm_reference(adj: TileAdjacency, msg: torch.Tensor) -> torch.Tensor:
    """Plain version of ``tile_spmm_kernel`` (the reference's
    ``_spmm_xla``): gather the sender row tiles, multiply every tile in
    f32 with ``torch.bmm``, add into the row tiles with ``index_add_``.
    Upcast-only dtype rule: f32 values upcast ``msg``; ``msg`` is never
    downcast. The output takes ``msg``'s dtype."""
    t, n = adj.tile, adj.n_row_tiles
    msg_tiles = msg.reshape(n, t, -1)[adj.cols.long()]
    vals = adj.vals
    if not (vals.dtype == torch.float32 and msg.dtype != torch.float32):
        vals = vals.to(msg.dtype)
    prod = torch.bmm(vals.float(), msg_tiles.float())
    out = torch.zeros((n, t, msg.shape[1]), dtype=torch.float32,
                      device=msg.device)
    out.index_add_(0, adj.rows.long(), prod)
    return out.reshape(n * t, -1).to(msg.dtype)


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _check_cuda(adj: TileAdjacency, msg: torch.Tensor) -> None:
    """Raise on what the kernel does not take: a CUDA f32 ``msg``
    ``[n_row_tiles * tile, H]``, contiguous; bf16 or f32 tiles
    ``[n_nz, tile, tile]`` with tile <= MAX_KERNEL_TILE, int32 ``cols``
    and ``row_ptr``, all contiguous on ``msg``'s device."""
    if not msg.is_cuda:
        raise ValueError(f"tile_spmm_kernel takes CPU tensors (plain "
                         f"version) or CUDA tensors, got {msg.device}")
    if msg.dtype != torch.float32:
        raise NotImplementedError(
            f"tile_spmm_kernel takes float32 messages, got {msg.dtype}: "
            "bf16 kernels are not ported yet")
    t, n = adj.tile, adj.n_row_tiles
    if not 1 <= t <= MAX_KERNEL_TILE:
        raise ValueError(f"tile {t}: the kernel takes 1..{MAX_KERNEL_TILE}")
    if msg.dim() != 2 or msg.shape[0] != n * t or msg.shape[1] < 1:
        raise ValueError(f"msg {tuple(msg.shape)} does not match "
                         f"[n_row_tiles * tile = {n * t}, H]")
    n_nz = adj.vals.shape[0]
    for name, x, shape, dtypes in (
            ("vals", adj.vals, (n_nz, t, t), (torch.bfloat16, torch.float32)),
            ("cols", adj.cols, (n_nz,), (torch.int32,)),
            ("row_ptr", adj.row_ptr, (n + 1,), (torch.int32,))):
        if (tuple(x.shape) != shape or x.dtype not in dtypes
                or x.device != msg.device or not x.is_contiguous()):
            raise ValueError(
                f"tile_spmm_kernel: {name} must be contiguous "
                f"{'/'.join(str(d) for d in dtypes)} {list(shape)} on "
                f"{msg.device}, got {x.dtype} {list(x.shape)} on {x.device}")
    if not msg.is_contiguous():
        raise ValueError("tile_spmm_kernel takes a contiguous msg")


def tile_spmm(adj: TileAdjacency, msg: torch.Tensor) -> torch.Tensor:
    """``agg = A @ msg`` over the block-sparse tiles; differentiable in
    ``msg`` through :class:`_TileSpmm` when a gradient is needed. CPU
    tensors: :func:`tile_spmm_reference`. CUDA tensors:
    ``tile_spmm_kernel``, or an exception."""
    if torch.is_grad_enabled() and msg.requires_grad:
        return _TileSpmm.apply(msg, adj)
    if msg.device.type == "cpu":
        return tile_spmm_reference(adj, msg)
    _check_cuda(adj, msg)
    from deepdfa_tpu_torch.ops import _build

    out = torch.empty_like(msg)
    with torch.cuda.device(msg.device):
        stream = ctypes.c_void_p(
            torch.cuda.current_stream(msg.device).cuda_stream)
        err = _build.load("tile_spmm").tile_spmm_launch(
            _ptr(adj.vals), int(adj.vals.dtype == torch.bfloat16),
            _ptr(adj.row_ptr), _ptr(adj.cols), _ptr(msg), _ptr(out),
            adj.n_row_tiles, adj.tile, msg.shape[1], stream)
    if err != 0:
        raise RuntimeError(f"tile_spmm_kernel launch failed: cudaError_t "
                           f"{err}")
    tile_spmm.launches += 1
    return out


tile_spmm.launches = 0


class _TileSpmm(torch.autograd.Function):
    """:func:`tile_spmm` forward; backward ``d msg = A^T @ g`` through the
    same wrapper over the transposed tiles (the reference's
    ``_spmm_bwd``). The adjacency gets no gradient."""

    @staticmethod
    def forward(ctx, msg, adj):
        ctx.adj = adj
        return tile_spmm(adj, msg)

    @staticmethod
    def backward(ctx, g):
        return tile_spmm(ctx.adj.transposed(), g.contiguous()), None


KERNELS = ("tile_spmm_kernel",)


def launch_counts() -> Dict[str, int]:
    """Kernel name -> launches so far."""
    return {"tile_spmm_kernel": tile_spmm.launches}


def reset_launch_counts() -> None:
    tile_spmm.launches = 0


# ---------------------------------------------------------------------------
# Operations and bytes
# ---------------------------------------------------------------------------


def kernel_cost(adj: TileAdjacency, hidden: int,
                transposed: bool = False) -> Dict[str, float]:
    """Operations and compulsory bytes of one ``tile_spmm_kernel`` call
    (over A, or over A^T when ``transposed``) with f32 ``msg`` ``[N,
    hidden]``, as the sparse product needs them on this data:

    - ``flops``: 2 operations a multiply-add, ``2 * E * hidden`` for the
      E nonzeros of A (distinct edges; a repeated edge is one nonzero
      with its multiplicity).
    - ``bytes``: each input read once, the output written once: the
      values of the tiles that hold an edge, in their dtype, with their
      ``rows`` and ``cols`` entries and ``row_ptr``; of ``msg`` only the
      sender row tiles those tiles point to (distinct ``cols``),
      ``tile * hidden * 4`` each; ``out``, ``N * hidden * 4``, since every
      row is written.
    - ``executed_flops``: ``2 * tile^2 * hidden`` for each tile the
      kernel multiplies (the built tiles: edge tiles and fillers).

    Also the tile counts: ``edge_tiles``, ``filler_tiles``, ``pad_tiles``.
    """
    a = adj.transposed() if transposed else adj
    t = a.tile
    n_built = int(a.row_ptr[-1])
    built = a.vals[:n_built].reshape(n_built, -1)
    nnz = int(torch.count_nonzero(built))
    has_edge = (built != 0).any(dim=1)
    edge_tiles = int(has_edge.sum())
    sender_tiles = int(torch.unique(a.cols[:n_built][has_edge]).numel())
    n = a.n_row_tiles * t
    index_bytes = (2.0 * edge_tiles * a.rows.element_size()
                   + a.row_ptr.numel() * a.row_ptr.element_size())
    return {
        "flops": 2.0 * nnz * hidden,
        "bytes": (edge_tiles * t * t * a.vals.element_size() + index_bytes
                  + sender_tiles * t * hidden * 4.0 + n * hidden * 4.0),
        "executed_flops": 2.0 * t * t * hidden * n_built,
        "nnz": nnz,
        "edge_tiles": edge_tiles,
        "sender_tiles": sender_tiles,
        "filler_tiles": n_built - edge_tiles,
        "pad_tiles": int(a.vals.shape[0]) - n_built,
    }
