"""Sparse message aggregation of the tile path (port of
``deepdfa_tpu/ops/tile_spmm.py``).

Batched graphs are contiguous node ranges and CFG edges never cross
graphs. The tile message path aggregates ``agg = A @ msg``, with
``A[r, s]`` the multiplicity of the real edge (s, r), and differentiates
it as ``d msg = A^T @ g``. The reference stores A as a row-sorted list
of dense ``tile x tile`` blocks for the TPU's matrix unit; on the card
the product walks the nonzeros instead:

- :class:`CsrAdjacency` holds A and A^T as node-level, receiver-major
  nonzero lists (``ptr``, ``src``, ``val``), built vectorised on the host
  by :func:`build_csr_adjacency` from a batch's masked edges. This is what
  ``GraphBatch.tile_adj`` carries to the card: about 8 bytes a nonzero
  and 4 a row, instead of two dense tile lists.
- :class:`TileAdjacency` is the reference's dense layout, the same six
  arrays byte for byte (tiles, fillers for row tiles no edge reaches, the
  power-of-two pad budget, the bf16/f32 choice), built from the nonzero
  lists by :func:`tile_layout` (or from edges by
  :func:`build_tile_adjacency`) only where a caller asks for it: the
  tests against the JAX package. :func:`kernel_cost` counts its tiles
  without building them.

The product runs a hand-written CUDA kernel (``csrc/tile_spmm.cu``; its
header note says what bounds it and how it is laid out) with its plain
PyTorch version here:

- :func:`tile_spmm` launches ``tile_spmm_kernel``: one warp a receiver
  row walks the row's nonzeros in list order; replaces the TPU kernel
  ``_spmm_kernel``. Plain version :func:`tile_spmm_reference` (gather,
  scale, ``index_add_`` in f32). A bf16 ``msg``
  (``FlowGNN(dtype="bfloat16")`` training) launches
  ``tile_spmm_kernel_bf16``, the same walk at ``dt = bfloat16`` with a
  group of 16-byte lanes a row (H 128: two rows a warp): f32 sums in
  list order rounded once to bf16, as the plain version computes them
  on the CPU, bit for bit.
- :class:`_TileSpmm` differentiates it in ``msg``, as the reference's
  ``custom_vjp``: ``d msg = A^T @ g`` by the same kernel over the
  transposed lists (:meth:`CsrAdjacency.transposed`). The adjacency gets
  no gradient.

Dispatch: the wrapper takes the plain version only for a tensor on the
CPU. For a CUDA tensor it launches the kernel or raises. It counts its
launches in ``tile_spmm.launches`` (``launches_bf16`` for the bf16
instance; :func:`launch_counts`), bumped under ``ops.count_launch``'s
lock where the kernel is launched and nowhere else.

Not ported here (several GPUs): ``stack_tile_adjacencies``,
``tile_spmm_sharded`` and ``combine_tile_stats``.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from deepdfa_tpu_torch.ops import PEAK_BF16, PEAK_F32_SIMT, count_launch

# The tile edge batching callers align node budgets to
# (:func:`align_to_tile`), and the reference layout's tile.
DEFAULT_TILE = 128


def align_to_tile(n: int, tile: int = DEFAULT_TILE) -> int:
    return -(-n // tile) * tile


def _round_up_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


# ---------------------------------------------------------------------------
# The nonzero lists the kernel takes
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CsrAdjacency:
    """A and A^T as receiver-major nonzero lists.

    ptr   : int32 [n_rows + 1]; row r's nonzeros are ``[ptr[r], ptr[r + 1])``.
    src   : int32 [nnz] the sender of each nonzero, ascending within a row.
    val   : f32 [nnz] its multiplicity (exact for every count).
    t_ptr/t_src/t_val : A^T in the same form (rows are senders, ``t_src``
            the receivers).
    """

    ptr: torch.Tensor
    src: torch.Tensor
    val: torch.Tensor
    t_ptr: torch.Tensor
    t_src: torch.Tensor
    t_val: torch.Tensor
    n_rows: int = 0

    @property
    def nnz(self) -> int:
        return int(self.src.shape[0])

    def to(self, device: Union[str, torch.device]) -> "CsrAdjacency":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})

    def transposed(self) -> "CsrAdjacency":
        """A^T: the transposed lists in the forward's places."""
        return dataclasses.replace(
            self, ptr=self.t_ptr, src=self.t_src, val=self.t_val,
            t_ptr=self.ptr, t_src=self.src, t_val=self.val)

    def row_ids(self) -> torch.Tensor:
        """The receiver row of each nonzero, int64 [nnz]."""
        counts = (self.ptr[1:] - self.ptr[:-1]).long()
        return torch.repeat_interleave(
            torch.arange(self.n_rows, device=self.ptr.device), counts)


def _csr_lists(rows: np.ndarray, cols: np.ndarray, n: int
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(ptr, src, val) of the (row, col) pairs: each distinct pair once,
    sorted by row then column, with its count."""
    keys, counts = np.unique(rows * n + cols, return_counts=True)
    ptr = np.searchsorted(keys // n, np.arange(n + 1))
    return (ptr.astype(np.int32), (keys % n).astype(np.int32),
            counts.astype(np.float32))


def build_csr_adjacency(senders: np.ndarray, receivers: np.ndarray,
                        edge_mask: np.ndarray, max_nodes: int
                        ) -> CsrAdjacency:
    """Host-side: ``A[r, s] += 1`` for each real edge (s, r) of one batch,
    and its transpose, as nonzero lists (vectorised: one sort each)."""
    mask = np.asarray(edge_mask, bool)
    s = np.asarray(senders)[mask].astype(np.int64)
    r = np.asarray(receivers)[mask].astype(np.int64)
    t = torch.from_numpy
    a = [t(x) for x in _csr_lists(r, s, max_nodes)]
    at = [t(x) for x in _csr_lists(s, r, max_nodes)]
    return CsrAdjacency(ptr=a[0], src=a[1], val=a[2], t_ptr=at[0],
                        t_src=at[1], t_val=at[2], n_rows=max_nodes)


# ---------------------------------------------------------------------------
# The reference's dense tile layout
# ---------------------------------------------------------------------------


def _multiplicity_dtype(counts: np.ndarray) -> torch.dtype:
    """bf16 when every multiplicity is exactly representable there
    (<= 256), else f32."""
    return (torch.bfloat16 if not len(counts) or counts.max() <= 256
            else torch.float32)


def tile_vals_dtype(senders: np.ndarray, receivers: np.ndarray) -> torch.dtype:
    """The dtype of the reference layout's values for these (real) edges:
    their multiplicities' :func:`_multiplicity_dtype`."""
    s = np.asarray(senders, np.int64)
    r = np.asarray(receivers, np.int64)
    if len(s) == 0:
        return torch.bfloat16
    key = r * (int(s.max()) + 1) + s
    return _multiplicity_dtype(np.unique(key, return_counts=True)[1])


@dataclasses.dataclass
class TileAdjacency:
    """The reference's sorted block-sparse adjacency plus its transpose.

    vals    : [n_nz, tile, tile] bf16 or f32, sorted by ``rows``;
              ``vals[k][i, j]`` = multiplicity of edge (sender s,
              receiver r) with r = rows[k]*tile + i, s = cols[k]*tile + j.
    rows    : int32 [n_nz] non-decreasing receiver tile indices; every
              row tile appears at least once (filler zero tiles).
    cols    : int32 [n_nz] sender tile indices.
    t_vals/t_rows/t_cols : the transposed adjacency in the same layout.
    """

    vals: torch.Tensor
    rows: torch.Tensor
    cols: torch.Tensor
    t_vals: torch.Tensor
    t_rows: torch.Tensor
    t_cols: torch.Tensor
    tile: int = DEFAULT_TILE
    n_row_tiles: int = 0


def _dense_tiles(rows: np.ndarray, cols: np.ndarray, data: np.ndarray,
                 tile: int, n_tiles: int, pad_nz: int,
                 dtype: torch.dtype = torch.float32
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Group COO entries into sorted dense tiles with full row coverage,
    padded to ``pad_nz`` tiles: the reference's ``_dense_tiles``, byte
    for byte (``vals`` in ``dtype``, f32 there; ``rows``/``cols``
    int32), vectorised.

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
    return vals, torch.from_numpy(out_rows), torch.from_numpy(out_cols)


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


def _check_tile(n_rows: int, tile: int) -> int:
    if n_rows % tile:
        raise ValueError(f"max_nodes {n_rows} not a multiple of tile {tile}")
    return n_rows // tile


def tile_layout(adj: CsrAdjacency, tile: int = DEFAULT_TILE,
                pad_nz: Optional[int] = None) -> TileAdjacency:
    """The reference's dense tile lists of these nonzeros, byte for byte
    what its ``build_tile_adjacency`` gives for the same edges. ``pad_nz``
    fixes the tile count; the default rounds to the next power of two
    (:func:`tile_nz_budget`). Values are bf16 when every multiplicity is
    exact there, else f32."""
    n_tiles = _check_tile(adj.n_rows, tile)
    host = adj.to("cpu")
    r, s = host.row_ids().numpy(), host.src.numpy().astype(np.int64)
    counts = host.val.numpy()
    if pad_nz is None:
        pad_nz = tile_nz_budget(s, r, adj.n_rows, tile)
    dt = _multiplicity_dtype(counts)
    vals, rows, cols = _dense_tiles(r, s, counts, tile, n_tiles, pad_nz, dt)
    # A^T[s, r] = A[r, s]: the transposed lists hold the same nonzeros.
    t_vals, t_rows, t_cols = _dense_tiles(
        host.transposed().row_ids().numpy(),
        host.t_src.numpy().astype(np.int64), host.t_val.numpy(), tile,
        n_tiles, pad_nz, dt)
    return TileAdjacency(vals=vals, rows=rows, cols=cols, t_vals=t_vals,
                         t_rows=t_rows, t_cols=t_cols, tile=tile,
                         n_row_tiles=n_tiles)


def build_tile_adjacency(senders: np.ndarray, receivers: np.ndarray,
                         edge_mask: np.ndarray, max_nodes: int,
                         tile: int = DEFAULT_TILE,
                         pad_nz: Optional[int] = None) -> TileAdjacency:
    """The reference's ``build_tile_adjacency``: the nonzero lists of
    these edges (:func:`build_csr_adjacency`) in the dense tile layout
    (:func:`tile_layout`)."""
    _check_tile(max_nodes, tile)
    return tile_layout(build_csr_adjacency(senders, receivers, edge_mask,
                                           max_nodes), tile, pad_nz)


def cast_tiles(adj: TileAdjacency, dtype: torch.dtype) -> TileAdjacency:
    return dataclasses.replace(adj, vals=adj.vals.to(dtype),
                               t_vals=adj.t_vals.to(dtype))


def pad_tiles(adj: TileAdjacency, pad_nz: int) -> TileAdjacency:
    """Pad the tile lists to a larger budget with inert zero tiles on the
    last row tile (``rows`` stays sorted)."""
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


def tile_spmm_reference(adj: CsrAdjacency, msg: torch.Tensor) -> torch.Tensor:
    """Plain version of ``tile_spmm_kernel``: gather each nonzero's sender
    row, scale it by the multiplicity and add it into its receiver row
    with ``index_add_``, in f32. Upcast-only dtype rule: the f32
    multiplicities upcast ``msg``, which is never downcast; the output
    takes ``msg``'s dtype."""
    terms = adj.val[:, None] * msg[adj.src.long()].float()
    out = torch.zeros((adj.n_rows, msg.shape[1]), dtype=torch.float32,
                      device=msg.device)
    out.index_add_(0, adj.row_ids(), terms)
    return out.to(msg.dtype)


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _check_cuda(adj: CsrAdjacency, msg: torch.Tensor) -> None:
    """Raise on what the kernel does not take: a CUDA f32 or bf16 ``msg``
    ``[n_rows, H]``, contiguous; int32 ``ptr`` ``[n_rows + 1]``, int32
    ``src`` and f32 ``val`` of one length, all contiguous on ``msg``'s
    device."""
    if not msg.is_cuda:
        raise ValueError(f"tile_spmm_kernel takes CPU tensors (plain "
                         f"version) or CUDA tensors, got {msg.device}")
    if msg.dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(
            f"tile_spmm_kernel takes float32 messages (bfloat16 ones: "
            f"tile_spmm_kernel_bf16), got {msg.dtype}")
    n = adj.n_rows
    if msg.dim() != 2 or msg.shape[0] != n or msg.shape[1] < 1:
        raise ValueError(f"msg {tuple(msg.shape)} does not match "
                         f"[n_rows = {n}, H]")
    nnz = adj.src.shape[0]
    for name, x, shape, dtype in (("ptr", adj.ptr, (n + 1,), torch.int32),
                                  ("src", adj.src, (nnz,), torch.int32),
                                  ("val", adj.val, (nnz,), torch.float32)):
        if (tuple(x.shape) != shape or x.dtype != dtype
                or x.device != msg.device or not x.is_contiguous()):
            raise ValueError(
                f"tile_spmm_kernel: {name} must be contiguous {dtype} "
                f"{list(shape)} on {msg.device}, got {x.dtype} "
                f"{list(x.shape)} on {x.device}")
    if not msg.is_contiguous():
        raise ValueError("tile_spmm_kernel takes a contiguous msg")


def tile_spmm(adj: CsrAdjacency, msg: torch.Tensor) -> torch.Tensor:
    """``agg = A @ msg`` over the nonzero lists; differentiable in ``msg``
    through :class:`_TileSpmm` when a gradient is needed. CPU tensors:
    :func:`tile_spmm_reference`. CUDA tensors: ``tile_spmm_kernel``, for
    bf16 ``msg`` ``tile_spmm_kernel_bf16`` (f32 sums rounded once to
    bf16), or an exception."""
    if torch.is_grad_enabled() and msg.requires_grad:
        return _TileSpmm.apply(msg, adj)
    if msg.device.type == "cpu":
        return tile_spmm_reference(adj, msg)
    _check_cuda(adj, msg)
    from deepdfa_tpu_torch.ops import _build

    bf16 = msg.dtype == torch.bfloat16
    out = torch.empty_like(msg)
    with torch.cuda.device(msg.device):
        stream = ctypes.c_void_p(
            torch.cuda.current_stream(msg.device).cuda_stream)
        lib = _build.load("tile_spmm")
        launch = lib.tile_spmm_bf16_launch if bf16 else lib.tile_spmm_launch
        err = launch(_ptr(adj.ptr), _ptr(adj.src), _ptr(adj.val), _ptr(msg),
                     _ptr(out), adj.n_rows, msg.shape[1], stream)
    name = "tile_spmm_kernel_bf16" if bf16 else "tile_spmm_kernel"
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")
    if bf16:
        count_launch(tile_spmm, "launches_bf16")
    else:
        count_launch(tile_spmm)
    return out


tile_spmm.launches = tile_spmm.launches_bf16 = 0


class _TileSpmm(torch.autograd.Function):
    """:func:`tile_spmm` forward; backward ``d msg = A^T @ g`` through the
    same wrapper over the transposed lists (the reference's ``_spmm_bwd``).
    The adjacency gets no gradient."""

    @staticmethod
    def forward(ctx, msg, adj):
        ctx.adj = adj
        return tile_spmm(adj, msg)

    @staticmethod
    def backward(ctx, g):
        return tile_spmm(ctx.adj.transposed(), g.contiguous()), None


KERNELS = ("tile_spmm_kernel", "tile_spmm_kernel_bf16")


def launch_counts() -> Dict[str, int]:
    """Kernel name -> launches so far."""
    return {"tile_spmm_kernel": tile_spmm.launches,
            "tile_spmm_kernel_bf16": tile_spmm.launches_bf16}


def reset_launch_counts() -> None:
    tile_spmm.launches = tile_spmm.launches_bf16 = 0


# ---------------------------------------------------------------------------
# Operations and bytes
# ---------------------------------------------------------------------------


def kernel_cost(adj: CsrAdjacency, hidden: int, transposed: bool = False,
                tile: int = DEFAULT_TILE,
                dtype: torch.dtype = torch.float32) -> Dict[str, float]:
    """Operations and compulsory bytes of one ``tile_spmm_kernel`` call
    (over A, or over A^T when ``transposed``) with f32 ``msg`` ``[N,
    hidden]`` (``dtype`` bf16: ``tile_spmm_kernel_bf16``, msg and out at
    2 bytes an element, and, where the reference keeps its values bf16
    (every multiplicity <= 256), a product of two bf16 values at the bf16
    tensor-core rate), as the sparse product needs them on this data,
    whatever stores A:

    - ``flops``: 2 operations a multiply-add, ``2 * E * hidden`` for the
      E nonzeros (distinct edges; a repeated edge is one nonzero with its
      multiplicity). ``executed_flops``: the same, since the kernel does
      one FMA a nonzero and column.
    - ``bytes``: each input read once, the output written once: each
      nonzero's sender index and value (4 + 4 bytes), the row pointers,
      the distinct sender rows of ``msg`` (``sender_rows``, ``hidden * 4``
      each) and ``out``, ``N * hidden * 4``, since every row is written.
    - ``peak_flops``/``peak``: the rate the operations bound divides by
      (f32 FMAs on the CUDA cores).

    Also the tile counts the reference's layout at ``tile`` would have
    (:func:`tile_layout`), counted without building it: ``edge_tiles``,
    ``filler_tiles`` (row tiles no edge reaches), ``pad_tiles`` (up to
    the power-of-two budget)."""
    a = (adj.transposed() if transposed else adj).to("cpu")
    n, nnz = a.n_rows, a.nnz
    src = a.src.long()
    sender_rows = int(torch.unique(src).numel())
    n_tiles = n // tile
    tile_keys = torch.unique(a.row_ids() // tile * n_tiles + src // tile)
    edge_tiles = int(tile_keys.numel())
    covered = int(torch.unique(tile_keys // n_tiles).numel())
    filler_tiles = n_tiles - covered
    budget = _round_up_pow2(max(edge_tiles, n_tiles) + n_tiles)
    flops = 2.0 * nnz * hidden
    item = torch.empty((), dtype=dtype).element_size()
    peak = PEAK_F32_SIMT
    if (dtype == torch.bfloat16
            and _multiplicity_dtype(a.val.numpy()) == torch.bfloat16):
        peak = PEAK_BF16
    return {
        "flops": flops,
        "bytes": (8.0 * nnz + 4.0 * a.ptr.numel()
                  + item * sender_rows * hidden + item * n * hidden),
        "executed_flops": flops,
        "peak": peak[0],
        "peak_flops": peak[1],
        "nnz": nnz,
        "sender_rows": sender_rows,
        "edge_tiles": edge_tiles,
        "filler_tiles": filler_tiles,
        "pad_tiles": budget - edge_tiles - filler_tiles,
    }
