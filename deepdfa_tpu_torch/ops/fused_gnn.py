"""The fused FlowGNN gated step (port of ``deepdfa_tpu/ops/fused_gnn.py``).

Hand-written CUDA kernels (``csrc/fused_gnn.cu``, ``csrc/fused_gnn_bwd.cu``;
their header notes say what bounds them and how they are laid out), each
with its plain PyTorch version here:

- :func:`fused_gate_step` launches ``fused_step_kernel`` — one step
  ``h' = GRU(A @ (h W_e + b_e), h)``; replaces the TPU kernel
  ``_fwd_kernel``. Plain version :func:`fused_step_reference`.
- :func:`persistent_unroll` launches ``persistent_fwd_kernel`` — all
  ``n_steps`` shared-weight steps in one launch with ``h`` in shared
  memory; replaces ``_persist_fwd_kernel``. Plain version
  :func:`persistent_reference`.
- :func:`fused_step_bwd_rows` launches ``fused_step_bwd_kernel`` — one
  step's backward down to ``dh`` and the per-row cotangents the weight
  gradients contract; with :func:`step_weight_grads` it replaces
  ``_bwd_kernel``. Plain version :func:`fused_step_bwd_rows_reference`.
- :func:`persistent_hist` launches ``persistent_fwd_hist_kernel`` — the
  backward's recompute sweep ``h_1..h_{K-1}`` (``_persist_fwd_kernel``
  with ``emit_hist``). Plain version :func:`persistent_hist_reference`.
- :func:`persistent_bwd_rows` launches ``persistent_bwd_kernel`` — the
  reverse sweep over all steps with the cotangent in shared memory;
  replaces ``_persist_bwd_kernel``. Plain version
  :func:`persistent_bwd_rows_reference`.
- :func:`step_weight_grads` launches ``step_weight_grad_kernel`` — the six
  packed weight gradients from the per-row cotangents (3xTF32 products on
  the tensor cores), in a fixed order (steps folded K-1 down to 0). Plain
  version :func:`step_weight_grad_reference`.

:func:`fused_step_backward` and :func:`persistent_backward` compose the
backward kernels into the step VJP and the K-step VJP (plain versions
:func:`fused_step_backward_reference`, :func:`persistent_backward_reference`).
On CUDA, a call that needs a gradient goes through a
``torch.autograd.Function`` (:class:`_FusedStep`, :class:`_PersistentUnroll`)
that saves only the packed weights, ``h_0`` and the adjacency, as the
reference's custom VJPs do; autograd through :func:`packed_weights` maps
the packed gradients back to each ``nn.Linear``.

Dispatch: a wrapper takes its plain version only for tensors on the CPU.
For a CUDA tensor it launches its kernel or raises — there is no
fallback and no switch that puts the plain version on the card. Each
wrapper counts its launches in a plain integer attribute
(``fused_gate_step.launches`` and so on; :func:`launch_counts`), bumped
where the kernel is launched and nowhere else.

``params`` is the step's parameter tree in the reference's layout:
``{"edge_linear": {"kernel": [H_in, H], "bias": [H]}, "gru": {"ir",
"iz", "in": {kernel, bias}, "hr", "hz": {kernel}, "hn": {kernel,
bias}}}`` with ``[in, out]`` kernels (``x @ kernel``); the plain
versions take it. ``packed`` is :func:`packed_weights` of it: on CUDA a
wrapper given ``packed`` launches with it and does not read ``params``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

from deepdfa_tpu_torch.ops import PEAK_3XTF32, PEAK_F32_SIMT
from deepdfa_tpu_torch.ops.band_spmm import (
    BandAdjacency,
    band_spmm,
    transpose_band,
)

#: Dynamic shared memory one H100 block may opt into (227 KB). The
#: persistent kernels hold their row group's rows there.
PERSISTENT_SMEM_BUDGET_BYTES = 232_448

#: The kernels' row arrays hold at most 128 columns (H rounded up to 32,
#: 64 or 128).
MAX_HIDDEN = 128

#: step_weight_grad_kernel's first pass: rows a slab (the split sizes are
#: multiples of it), output columns a tile, and the SMs one step's blocks
#: should fill (an H100 SXM has 132).
WGRAD_SLAB_ROWS = 32
WGRAD_TILE = 128
WGRAD_FILL_SMS = 132


def wgrad_rows_per_split(n_rows: int, hidden: int) -> int:
    """Rows a block of ``step_weight_grad_kernel``'s first pass sums: as
    many splits as one step's output tiles need to fill
    ``WGRAD_FILL_SMS`` SMs, each a multiple of ``WGRAD_SLAB_ROWS`` rows.
    It depends on the row count and width alone (never on the number of
    steps), so a K-step call sums each step exactly as a one-step call
    does. The training batch (N = 16384, H = 128): 7 tiles, 19 splits of
    864 rows."""
    tiles_a = -(-hidden // WGRAD_TILE)  # output tiles a side: x^T . and h^T .
    tiles = tiles_a * (2 * -(-3 * hidden // WGRAD_TILE) + tiles_a)
    splits = -(-WGRAD_FILL_SMS // tiles)
    rows = -(-n_rows // splits)
    return max(WGRAD_SLAB_ROWS, -(-rows // WGRAD_SLAB_ROWS) * WGRAD_SLAB_ROWS)


def _dense(p: Mapping, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    y = x @ p["kernel"].to(dt)
    if "bias" in p:
        y = y + p["bias"].to(dt)
    return y


def fused_step_reference(params: Mapping, h: torch.Tensor,
                         adj: BandAdjacency) -> torch.Tensor:
    """Plain PyTorch version of ``fused_step_kernel``: edge message ->
    ``band_spmm`` aggregate -> GRU gate, in ``h``'s dtype."""
    dt = h.dtype
    msg = _dense(params["edge_linear"], h, dt)
    agg = band_spmm(adj, msg)
    g = params["gru"]
    x = agg.to(dt)
    r = torch.sigmoid(_dense(g["ir"], x, dt) + _dense(g["hr"], h, dt))
    z = torch.sigmoid(_dense(g["iz"], x, dt) + _dense(g["hz"], h, dt))
    n = torch.tanh(_dense(g["in"], x, dt) + r * _dense(g["hn"], h, dt))
    return (1.0 - z) * n + z * h


def persistent_reference(params: Mapping, h: torch.Tensor,
                         adj: BandAdjacency, n_steps: int) -> torch.Tensor:
    """Plain PyTorch version of ``persistent_fwd_kernel``: ``n_steps``
    applications of :func:`fused_step_reference` with shared weights."""
    for _ in range(n_steps):
        h = fused_step_reference(params, h, adj)
    return h


def packed_weights(params: Mapping) -> Tuple[torch.Tensor, ...]:
    """(ek, eb, wi, bi, wh, bh) in f32, the kernels' weight layout: the
    edge weights, and the r|z|n gate kernels concatenated on the output
    axis ([H, 3H]); the recurrent bias packs ``[0, 0, b_hn]`` (flax's GRU
    has no hidden-side r/z bias). Biases are ``[1, n]`` rows, as in the
    reference."""
    dt = torch.float32
    g = params["gru"]
    hidden = g["ir"]["kernel"].shape[0]
    ek = params["edge_linear"]["kernel"].to(dt)
    eb = params["edge_linear"]["bias"].to(dt).reshape(1, -1)
    wi = torch.cat([g["ir"]["kernel"], g["iz"]["kernel"], g["in"]["kernel"]],
                   dim=1).to(dt)
    bi = torch.cat([g["ir"]["bias"], g["iz"]["bias"], g["in"]["bias"]]
                   ).to(dt).reshape(1, -1)
    wh = torch.cat([g["hr"]["kernel"], g["hz"]["kernel"], g["hn"]["kernel"]],
                   dim=1).to(dt)
    zeros = torch.zeros(2 * hidden, dtype=dt, device=wh.device)
    bh = torch.cat([zeros, g["hn"]["bias"].to(dt)]).reshape(1, -1)
    return ek, eb, wi, bi, wh, bh


#: The persistent kernels' weight-slab stages (``kStages`` in
#: ``csrc/group_step.cuh``), each ``kGateRows`` k rows of ``[w_i | w_h]``.
PERSISTENT_STAGES = 3
PERSISTENT_SLAB_ROWS = 4


def persistent_row_stride(hidden: int) -> int:
    """Floats a row of the persistent kernels' shared row arrays: the
    hidden width rounded up to 32, 64 or 128 (whole warps of 4-column
    groups) plus 4, so 4 consecutive rows fall on distinct banks."""
    return (32 if hidden <= 32 else 64 if hidden <= 64 else 128) + 4


def _persistent_smem(adj: BandAdjacency, hidden: int, row_arrays: int) -> int:
    hp = persistent_row_stride(hidden) - 4
    stages = PERSISTENT_STAGES * PERSISTENT_SLAB_ROWS * 6 * hp
    rows = adj.max_group_rows
    return 4 * (stages + row_arrays * rows * persistent_row_stride(hidden)
                + rows)


def persistent_smem_bytes(adj: BandAdjacency, hidden: int,
                          cluster: int = 1) -> int:
    """Shared memory of ``persistent_fwd_kernel``'s blocks (every block
    gets the largest group's): the weight-slab stages, the group's
    resident h and its aggregate (x) at :func:`persistent_row_stride`, a
    third such array (x apart from the aggregate) when ``cluster`` blocks
    share a group, one row sum a row. 87,744 bytes for groups of 48 rows
    at H 128 (two blocks an SM)."""
    return _persistent_smem(adj, hidden, 2 if cluster == 1 else 3)


def persistent_smem_ok(adj: BandAdjacency, hidden: int) -> bool:
    """The persistent kernel's eligibility gate (replaces the
    reference's 12 MiB VMEM budget): the adjacency carries closed row
    groups and the largest fits a block's shared memory (184 rows at
    H 128). Over the gate the model runs ``fused_step_kernel``
    ``n_steps`` times instead."""
    return (adj.row_groups is not None
            and persistent_smem_bytes(adj, hidden)
            <= PERSISTENT_SMEM_BUDGET_BYTES)


#: Blocks of a thread-block cluster that share a row group where the
#: groups are fewer than the SMs.
PERSISTENT_CLUSTER = 2


def persistent_cluster_size(adj: BandAdjacency, hidden: int,
                            sms: int) -> int:
    """Blocks of ``persistent_fwd_kernel`` a row group gets on a card with
    ``sms`` SMs: :data:`PERSISTENT_CLUSTER` where those blocks still fit
    one to an SM, each owning a slice of at least 32 product columns, with
    the three row arrays in shared memory; else 1. The serving bucket (34
    groups of up to 48 rows, H 128, 132 SMs) gets 2, the training batch
    (523 groups) 1. Host ints only: no device read."""
    n_groups = adj.row_groups.numel() - 1
    hp = persistent_row_stride(hidden) - 4
    cs = PERSISTENT_CLUSTER
    if (n_groups * cs <= sms and hp // cs >= 32
            and persistent_smem_bytes(adj, hidden, cs)
            <= PERSISTENT_SMEM_BUDGET_BYTES):
        return cs
    return 1


def persistent_bwd_smem_bytes(adj: BandAdjacency, hidden: int) -> int:
    """Shared memory of ``persistent_bwd_kernel``'s blocks: the weight-slab
    stages, the group's resident cotangent, h (then dx) and the aggregate
    (then x, then dmsg), one row sum a row. 113,088 bytes for groups of
    48 rows at H 128: two blocks an SM."""
    return _persistent_smem(adj, hidden, 3)


def persistent_bwd_smem_ok(adj: BandAdjacency, hidden: int) -> bool:
    """The persistent backward's gate, as :func:`persistent_smem_ok` with
    three row arrays (123 rows at H 128). A training batch over it runs
    the fused step forward and backward ``n_steps`` times."""
    return (adj.row_groups is not None
            and persistent_bwd_smem_bytes(adj, hidden)
            <= PERSISTENT_SMEM_BUDGET_BYTES)


def persistent_occupancy(adj: BandAdjacency, hidden: int,
                         kernel: str = "persistent_fwd_kernel",
                         cluster: int = 1) -> dict:
    """The CUDA occupancy query (registers, shared memory, threads) for the
    instance of ``persistent_fwd_kernel`` (its hist instance is the same
    code) or ``persistent_bwd_kernel`` that a launch at this adjacency's
    largest group runs, ``cluster`` blocks a group (the forward only):
    ``blocks_per_sm``, the blocks one SM holds, and ``active_clusters``,
    the clusters the card holds at once (None for cluster 1)."""
    from deepdfa_tpu_torch.ops import _build

    bf16 = int(adj.vals.dtype == torch.bfloat16)
    blocks, clusters = ctypes.c_int(0), ctypes.c_int(0)
    if kernel == "persistent_fwd_kernel":
        err = _build.load("fused_gnn").persistent_fwd_occupancy(
            bf16, adj.max_group_rows, hidden, cluster, ctypes.byref(blocks),
            ctypes.byref(clusters))
    elif kernel == "persistent_bwd_kernel" and cluster == 1:
        err = _build.load("fused_gnn_bwd").persistent_bwd_occupancy(
            bf16, adj.max_group_rows, hidden, ctypes.byref(blocks))
    else:
        raise ValueError(f"no occupancy query for {kernel} in clusters of "
                         f"{cluster}")
    _raise_on_error(err, f"{kernel} occupancy")
    return dict(blocks_per_sm=blocks.value,
                active_clusters=clusters.value if cluster > 1 else None)


#: Rows of a per-step forward tile where 32-row tiles fill the SMs
#: (``kWideTile`` in ``csrc/group_step.cuh``: one pass of the wide
#: products' 8 rows a thread at H > 64).
STEP_WIDE_TILE = 64


def step_plan(n_rows: int, hidden: int, sms: int,
              kernel: str = "fused_step_kernel") -> dict:
    """How a per-step launch on a card of ``sms`` SMs cuts ``n_rows`` rows
    into fixed row tiles, a block (or a 2-block cluster) a tile for one
    step: no closed groups, so no gate, and a tile's shared memory never
    grows with a graph. The CUDA launchers plan the same on the host with
    the device's SM count (``csrc/fused_gnn.cu:step_fwd_plan``,
    ``csrc/fused_gnn_bwd.cu:step_bwd_plan``); :func:`step_geometry` reads
    theirs back.

    ``fused_step_kernel``: where 32-row tiles make ``sms`` blocks, tiles
    of :data:`STEP_WIDE_TILE` rows, one block each, with the wide products
    (8 rows a thread, one block an SM; gate slabs of 16 k rows where 16
    divides ``hidden``, else 4) at ``hidden`` > 64 (``wide``), else the
    4 x 4 ones (slabs of 4); else (the serving bucket) 2-block clusters
    over 16-row tiles that split the product columns (while the padded
    width leaves each block 32; slabs of 8 k rows where 8 divides
    ``hidden``, else 4: two blocks an SM either way).
    ``fused_step_bwd_kernel``: 32-row tiles, 16 where those are fewer
    than ``sms`` blocks, slabs of 4, no clusters. Returns ``row_tile``,
    ``cluster``, ``slab_rows``, ``blocks`` (each pass's grid) and
    ``wide``. Host ints only."""
    cdiv = lambda a, b: -(-a // b)
    hp = persistent_row_stride(hidden) - 4
    wide = False
    if kernel == "fused_step_kernel":
        if cdiv(n_rows, 32) >= sms or hp // 2 < 32:
            cs, rt, wide = 1, STEP_WIDE_TILE, hp == 128
            gr = 16 if wide and hidden % 16 == 0 else 4
        else:
            cs, rt, gr = 2, 16, 8 if hidden % 8 == 0 else 4
    elif kernel == "fused_step_bwd_kernel":
        cs, gr = 1, PERSISTENT_SLAB_ROWS
        rt = 16 if cdiv(n_rows, 32) < sms else 32
    else:
        raise ValueError(f"no per-step plan for {kernel}")
    return dict(row_tile=rt, cluster=cs, slab_rows=gr,
                blocks=cdiv(n_rows, rt) * cs, wide=wide)


def step_smem_bytes(n_rows: int, hidden: int, sms: int,
                    kernel: str = "fused_step_kernel", bwd_pass: int = 0
                    ) -> int:
    """Dynamic shared memory of a per-step block (``csrc``'s
    ``step_fwd_smem`` / ``step_bwd_smem``, which :func:`step_geometry`
    reports): the weight-slab stages, then row arrays of the tile at
    :func:`persistent_row_stride` (the forward: h and the aggregate, and x
    apart from it in a cluster; the backward's pass 0: the cotangent, h
    and the aggregate; pass 1: dx and dmsg), one row sum a row. Bounded by
    the tile, never by a graph."""
    p = step_plan(n_rows, hidden, sms, kernel)
    ld = persistent_row_stride(hidden)
    stages = PERSISTENT_STAGES * p["slab_rows"] * 6 * (ld - 4)
    if kernel == "fused_step_kernel":
        arrays = 3 if p["cluster"] > 1 else 2
    else:
        arrays = 3 if bwd_pass == 0 else 2
    return 4 * (stages + arrays * p["row_tile"] * ld + p["row_tile"])


def step_geometry(adj: BandAdjacency, hidden: int,
                  kernel: str = "fused_step_kernel") -> dict:
    """The launch geometry the CUDA launcher of a per-step kernel picks at
    this adjacency: :func:`step_plan`'s keys as the library reports them,
    ``blocks_per_sm``, the CUDA occupancy query of the instance that
    launches, ``smem_bytes``, its blocks' dynamic shared memory (for the
    backward, of pass 0, and ``blocks_per_sm_pass1``, ``smem_bytes_pass1``)
    and ``sms``, the device's SM count the plan filled."""
    from deepdfa_tpu_torch.ops import _build

    bf16 = int(adj.vals.dtype == torch.bfloat16)
    n = adj.n_tiles * adj.tile
    if kernel == "fused_step_kernel":
        keys = ("row_tile", "cluster", "slab_rows", "blocks",
                "blocks_per_sm", "smem_bytes", "sms")
        geometry = _build.load("fused_gnn").fused_step_geometry
    elif kernel == "fused_step_bwd_kernel":
        keys = ("row_tile", "slab_rows", "blocks", "blocks_per_sm",
                "blocks_per_sm_pass1", "smem_bytes", "smem_bytes_pass1",
                "sms")
        geometry = _build.load("fused_gnn_bwd").fused_step_bwd_geometry
    else:
        raise ValueError(f"no per-step geometry for {kernel}")
    out = [ctypes.c_int(0) for _ in keys]
    err = geometry(bf16, n, hidden, *(ctypes.byref(v) for v in out))
    _raise_on_error(err, f"{kernel} geometry")
    geo = {k: v.value for k, v in zip(keys, out)}
    geo.setdefault("cluster", 1)
    return geo


def _check_cuda_inputs(h: torch.Tensor, adj: BandAdjacency) -> None:
    if not h.is_cuda:
        raise ValueError(f"the gated-step kernels take CPU tensors (plain "
                         f"version) or CUDA tensors, got {h.device}")
    if h.dtype != torch.float32:
        raise NotImplementedError(
            f"the CUDA gated-step kernels take float32 h, got {h.dtype}: "
            "their bf16 instances come with ROADMAP A3b")
    n, hidden = h.shape
    if hidden > MAX_HIDDEN or hidden % 4:
        raise ValueError(f"hidden {hidden}: the kernels take hidden <= "
                         f"{MAX_HIDDEN} and a multiple of 4")
    vals = adj.vals
    w = 2 * adj.bandwidth + 1
    if tuple(vals.shape) != (w, adj.n_tiles, adj.tile, adj.tile):
        raise ValueError(
            f"band vals {tuple(vals.shape)} do not match "
            f"[2B+1={w}, T={adj.n_tiles}, t={adj.tile}, t={adj.tile}]")
    if n != adj.n_tiles * adj.tile:
        raise ValueError(f"h has {n} rows, the band {adj.n_tiles * adj.tile}")
    if vals.device != h.device or vals.dtype not in (torch.bfloat16,
                                                     torch.float32):
        raise ValueError(f"band vals must be bf16/f32 on {h.device}, got "
                         f"{vals.dtype} on {vals.device}")
    if not (h.is_contiguous() and vals.is_contiguous()):
        raise ValueError("the kernels take contiguous h and band vals")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _launch_args(params: Mapping, h: torch.Tensor, adj: BandAdjacency,
                 packed: Optional[Sequence[torch.Tensor]],
                 library: str = "fused_gnn"):
    from deepdfa_tpu_torch.ops import _build

    if packed is None:
        packed = packed_weights(params)
    weights = [w.detach().contiguous() for w in packed]
    if any(w.device != h.device or w.dtype != torch.float32
           for w in weights):
        raise ValueError(f"step weights must be float32 on {h.device}")
    stream = ctypes.c_void_p(torch.cuda.current_stream(h.device).cuda_stream)
    bf16 = int(adj.vals.dtype == torch.bfloat16)
    return _build.load(library), weights, bf16, stream


def _check_like(t: torch.Tensor, h: torch.Tensor, name: str) -> torch.Tensor:
    if t.shape != h.shape or t.dtype != h.dtype or t.device != h.device:
        raise ValueError(f"{name} must match h ({tuple(h.shape)}, {h.dtype}, "
                         f"{h.device}), got {tuple(t.shape)}, {t.dtype}, "
                         f"{t.device}")
    return t.contiguous()


def _row_groups(adj: BandAdjacency, h: torch.Tensor) -> torch.Tensor:
    groups = adj.row_groups.contiguous()  # held until the launch is queued
    if groups.device != h.device or groups.dtype != torch.int32:
        raise ValueError("row_groups must be int32 on the device of h")
    return groups


def _raise_on_error(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError_t {err}")




# ---------------------------------------------------------------------------
# Plain versions of the backward
# ---------------------------------------------------------------------------


def _packed(params: Optional[Mapping],
            packed: Optional[Sequence[torch.Tensor]]) -> Tuple:
    return tuple(packed) if packed is not None else packed_weights(params)


def fused_step_bwd_rows_reference(params: Mapping, h: torch.Tensor,
                                  adj: BandAdjacency, g: torch.Tensor):
    """Plain version of ``fused_step_bwd_kernel``: one step's cotangents,
    the math of the reference's ``_bwd_kernel`` in torch ops. Returns
    ``(dh, x, dp, dmsg)``: the input cotangent, the edge aggregate ``x``
    the gate saw, ``dp = [dpre_r | dpre_z | dpre_n | dpre_hn]`` ([N, 4H])
    and ``dmsg = A^T dx``."""
    ek, eb, wi, bi, wh, bh = packed_weights(params)
    hid = h.shape[1]
    x = band_spmm(adj, h @ ek + eb)
    gi = x @ wi + bi
    gh = h @ wh + bh
    r = torch.sigmoid(gi[:, :hid] + gh[:, :hid])
    z = torch.sigmoid(gi[:, hid:2 * hid] + gh[:, hid:2 * hid])
    pre_hn = gh[:, 2 * hid:]
    n = torch.tanh(gi[:, 2 * hid:] + r * pre_hn)
    dz = g * (h - n)
    dn = g * (1.0 - z)
    dhc = g * z
    dpre_n = dn * (1.0 - n * n)
    dpre_hn = dpre_n * r
    dpre_r = dpre_n * pre_hn * r * (1.0 - r)
    dpre_z = dz * z * (1.0 - z)
    dpre_i = torch.cat([dpre_r, dpre_z, dpre_n], dim=1)
    dpre_h = torch.cat([dpre_r, dpre_z, dpre_hn], dim=1)
    dx = dpre_i @ wi.T
    dhl = dhc + dpre_h @ wh.T
    dmsg = band_spmm(transpose_band(adj), dx)
    dh = dhl + dmsg @ ek.T
    return dh, x, torch.cat([dpre_i, dpre_hn], dim=1), dmsg


def step_weight_grad_reference(h0: torch.Tensor, hist: torch.Tensor,
                               x: torch.Tensor, dp: torch.Tensor,
                               dmsg: torch.Tensor, n_steps: int):
    """Plain version of ``step_weight_grad_kernel``: the packed weight
    gradients ``(dek, deb, dwi, dbi, dwh, dbh)`` of ``n_steps`` steps from
    their per-row cotangents (``x``, ``dp``, ``dmsg`` stacked by step;
    step s's input is ``h0`` for s = 0 and ``hist[s-1]`` after), each
    step's sums added into the totals from step K-1 down to 0 (the scan
    VJP's order). Biases are ``[1, n]`` rows."""
    hid = h0.shape[1]
    totals = None
    for s in reversed(range(n_steps)):
        hs = h0 if s == 0 else hist[s - 1]
        dpi = dp[s][:, :3 * hid]
        dph = torch.cat([dp[s][:, :2 * hid], dp[s][:, 3 * hid:]], dim=1)
        step = (hs.T @ dmsg[s], dmsg[s].sum(0, keepdim=True),
                x[s].T @ dpi, dpi.sum(0, keepdim=True),
                hs.T @ dph, dph.sum(0, keepdim=True))
        totals = step if totals is None else tuple(
            t + u for t, u in zip(totals, step))
    return totals


def fused_step_backward_reference(params: Mapping, h: torch.Tensor,
                                  adj: BandAdjacency, g: torch.Tensor):
    """The step VJP in plain torch: ``(dh, dek, deb, dwi, dbi, dwh, dbh)``,
    the gradients in the packed layout of :func:`packed_weights`."""
    dh, x, dp, dmsg = fused_step_bwd_rows_reference(params, h, adj, g)
    return (dh, *step_weight_grad_reference(h, None, x[None], dp[None],
                                            dmsg[None], 1))


def persistent_hist_reference(params: Mapping, h: torch.Tensor,
                              adj: BandAdjacency, n_steps: int
                              ) -> torch.Tensor:
    """Plain version of ``persistent_fwd_hist_kernel``: ``h_1..h_{K-1}``
    of ``n_steps = K`` steps, stacked ``[K-1, N, H]``."""
    hs = []
    for _ in range(n_steps - 1):
        h = fused_step_reference(params, h, adj)
        hs.append(h)
    if not hs:
        return h.new_zeros((0,) + tuple(h.shape))
    return torch.stack(hs)


def persistent_bwd_rows_reference(params: Mapping, h0: torch.Tensor,
                                  hist: torch.Tensor, adj: BandAdjacency,
                                  g: torch.Tensor, n_steps: int):
    """Plain version of ``persistent_bwd_kernel``: the reverse loop of
    :func:`fused_step_bwd_rows_reference` over steps K-1..0. Returns
    ``(dh_0, x, dp, dmsg)`` with the per-row cotangents stacked by step."""
    xs, dps, dmsgs = [None] * n_steps, [None] * n_steps, [None] * n_steps
    for s in reversed(range(n_steps)):
        hs = h0 if s == 0 else hist[s - 1]
        g, xs[s], dps[s], dmsgs[s] = fused_step_bwd_rows_reference(
            params, hs, adj, g)
    return g, torch.stack(xs), torch.stack(dps), torch.stack(dmsgs)


def persistent_backward_reference(params: Mapping, h0: torch.Tensor,
                                  adj: BandAdjacency, g: torch.Tensor,
                                  n_steps: int):
    """The K-step VJP in plain torch: the hist, the reverse loop of the
    step VJP, each step's weight gradients folded into the totals in
    descending step order. ``(dh_0, dek, deb, dwi, dbi, dwh, dbh)``."""
    hist = persistent_hist_reference(params, h0, adj, n_steps)
    dh, x, dp, dmsg = persistent_bwd_rows_reference(params, h0, hist, adj, g,
                                                    n_steps)
    return (dh, *step_weight_grad_reference(h0, hist, x, dp, dmsg, n_steps))


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def needs_grad(h: torch.Tensor, packed: Sequence[torch.Tensor]) -> bool:
    """Whether autograd will need the gradient of a gated step on ``h``
    with these (packed) weights: the backward kernels and their gate
    then apply."""
    return torch.is_grad_enabled() and (
        h.requires_grad or any(w.requires_grad for w in packed))


def _fused_step_launch(h: torch.Tensor, adj: BandAdjacency,
                       packed: Sequence[torch.Tensor]) -> torch.Tensor:
    with torch.cuda.device(h.device):
        lib, (ek, eb, wi, bi, wh, bh), bf16, stream = _launch_args(
            None, h, adj, packed)
        out = torch.empty_like(h)
        n, hidden = h.shape
        err = lib.fused_step_launch(
            _ptr(h), _ptr(adj.vals), bf16, _ptr(ek), _ptr(eb), _ptr(wi),
            _ptr(bi), _ptr(wh), _ptr(bh), _ptr(out), n, hidden, adj.tile,
            adj.n_tiles, adj.bandwidth, stream)
        _raise_on_error(err, "fused_step_kernel")
    fused_gate_step.launches += 1
    return out


def _persistent_launch(h: torch.Tensor, adj: BandAdjacency,
                       packed: Sequence[torch.Tensor], n_steps: int,
                       hist: bool = False) -> torch.Tensor:
    """``persistent_fwd_kernel`` (h_K), or with ``hist`` its emit-hist
    instance running ``n_steps - 1`` steps (``[K-1, N, H]``)."""
    groups = _row_groups(adj, h)
    with torch.cuda.device(h.device):
        lib, (ek, eb, wi, bi, wh, bh), bf16, stream = _launch_args(
            None, h, adj, packed)
        hidden = h.shape[1]
        if hist:
            out = torch.empty((n_steps - 1,) + tuple(h.shape),
                              dtype=h.dtype, device=h.device)
            fn, steps, name = (lib.persistent_fwd_hist_launch, n_steps - 1,
                               "persistent_fwd_hist_kernel")
        else:
            out = torch.empty_like(h)
            fn, steps, name = (lib.persistent_fwd_launch, n_steps,
                               "persistent_fwd_kernel")
        cluster = persistent_cluster_size(
            adj, hidden,
            torch.cuda.get_device_properties(h.device).multi_processor_count)
        err = fn(_ptr(h), _ptr(adj.vals), bf16, _ptr(ek), _ptr(eb), _ptr(wi),
                 _ptr(bi), _ptr(wh), _ptr(bh), _ptr(groups),
                 groups.numel() - 1, adj.max_group_rows, steps, cluster,
                 _ptr(out), hidden, adj.tile, adj.n_tiles, adj.bandwidth,
                 stream)
        _raise_on_error(err, name)
    return out


def _transposed(weights: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    ek, _, wi, _, wh, _ = weights
    return wi.t().contiguous(), wh.t().contiguous(), ek.t().contiguous()


class _FusedStep(torch.autograd.Function):
    """``fused_step_kernel`` forward, ``fused_step_bwd_kernel`` and
    ``step_weight_grad_kernel`` backward. Differentiable in ``h`` and the
    six packed weights; saves only those and the adjacency."""

    @staticmethod
    def forward(ctx, adj, h, *packed):
        ctx.adj = adj
        ctx.save_for_backward(h, *packed)
        return _fused_step_launch(h, adj, packed)

    @staticmethod
    def backward(ctx, g):
        h, *packed = ctx.saved_tensors
        dh, *dw = fused_step_backward(None, h, ctx.adj, g.contiguous(),
                                      packed=packed)
        return (None, dh, *dw)


class _PersistentUnroll(torch.autograd.Function):
    """``persistent_fwd_kernel`` forward; backward
    ``persistent_fwd_hist_kernel``, ``persistent_bwd_kernel`` and
    ``step_weight_grad_kernel``. Saves only ``h_0``, the packed weights
    and the adjacency."""

    @staticmethod
    def forward(ctx, adj, n_steps, h, *packed):
        ctx.adj, ctx.n_steps = adj, n_steps
        ctx.save_for_backward(h, *packed)
        out = _persistent_launch(h, adj, packed, n_steps)
        persistent_unroll.launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        h, *packed = ctx.saved_tensors
        dh, *dw = persistent_backward(None, h, ctx.adj, g.contiguous(),
                                      ctx.n_steps, packed=packed)
        return (None, None, dh, *dw)


def fused_gate_step(params: Optional[Mapping], h: torch.Tensor,
                    adj: BandAdjacency,
                    packed: Optional[Sequence[torch.Tensor]] = None
                    ) -> torch.Tensor:
    """One gated graph step ``h' = GRU(A @ (h W_e + b_e), h)``.

    CPU tensors: :func:`fused_step_reference` (autograd differentiates
    it). CUDA tensors: ``fused_step_kernel`` (f32 h and weights, bf16 or
    f32 band values), through :class:`_FusedStep` when a gradient is
    needed, or an exception. ``packed``: :func:`packed_weights` of
    ``params``, when the caller packs once for several steps.
    """
    if h.device.type == "cpu":
        return fused_step_reference(params, h, adj)
    _check_cuda_inputs(h, adj)
    packed = _packed(params, packed)
    if needs_grad(h, packed):
        return _FusedStep.apply(adj, h, *packed)
    return _fused_step_launch(h, adj, packed)


fused_gate_step.launches = 0


def persistent_unroll(params: Optional[Mapping], h: torch.Tensor,
                      adj: BandAdjacency, n_steps: int,
                      packed: Optional[Sequence[torch.Tensor]] = None
                      ) -> torch.Tensor:
    """``n_steps`` shared-weight gated steps.

    CPU tensors: :func:`persistent_reference`. CUDA tensors: one
    ``persistent_fwd_kernel`` launch, through :class:`_PersistentUnroll`
    when a gradient is needed. The adjacency's closed row groups must pass
    :func:`persistent_smem_ok`, and :func:`persistent_bwd_smem_ok` when a
    gradient is needed — callers check the gate and run
    :func:`fused_gate_step` per step when it fails (the model does); here
    a failed gate raises. ``packed`` as in :func:`fused_gate_step`.
    """
    if n_steps < 1:
        raise ValueError(f"persistent_unroll needs n_steps >= 1, "
                         f"got {n_steps}")
    if h.device.type == "cpu":
        return persistent_reference(params, h, adj, n_steps)
    _check_cuda_inputs(h, adj)
    packed = _packed(params, packed)
    grad = needs_grad(h, packed)
    hidden = h.shape[1]
    if not persistent_smem_ok(adj, hidden) or (
            grad and not persistent_bwd_smem_ok(adj, hidden)):
        need = (persistent_bwd_smem_bytes if grad
                else persistent_smem_bytes)(adj, hidden)
        raise ValueError(
            f"row groups need {need} B of shared memory > "
            f"{PERSISTENT_SMEM_BUDGET_BYTES} (or the band has no row "
            "groups): dispatch per step through fused_gate_step")
    if grad:
        return _PersistentUnroll.apply(adj, n_steps, h, *packed)
    out = _persistent_launch(h, adj, packed, n_steps)
    persistent_unroll.launches += 1
    return out


persistent_unroll.launches = 0


def fused_step_bwd_rows(params: Optional[Mapping], h: torch.Tensor,
                        adj: BandAdjacency, g: torch.Tensor,
                        packed: Optional[Sequence[torch.Tensor]] = None):
    """One step's backward down to ``(dh, x, dp, dmsg)`` (see
    :func:`fused_step_bwd_rows_reference`). CUDA tensors:
    ``fused_step_bwd_kernel`` (two passes, one count), reading A^T from
    :meth:`BandAdjacency.transpose_vals`."""
    if h.device.type == "cpu":
        return fused_step_bwd_rows_reference(params, h, adj, g)
    _check_cuda_inputs(h, adj)
    g = _check_like(g, h, "the output cotangent")
    tv = adj.transpose_vals()
    with torch.cuda.device(h.device):
        lib, weights, bf16, stream = _launch_args(params, h, adj, packed,
                                                  "fused_gnn_bwd")
        ek, eb, wi, bi, wh, bh = weights
        wiT, whT, ekT = _transposed(weights)
        n, hidden = h.shape
        x, dx, dhl, dmsg, dh = (torch.empty_like(h) for _ in range(5))
        dp = torch.empty((n, 4 * hidden), dtype=h.dtype, device=h.device)
        err = lib.fused_step_bwd_launch(
            _ptr(h), _ptr(adj.vals), _ptr(tv), bf16, _ptr(g), _ptr(ek),
            _ptr(eb), _ptr(wi), _ptr(bi), _ptr(wh), _ptr(bh), _ptr(wiT),
            _ptr(whT), _ptr(ekT), _ptr(x), _ptr(dp), _ptr(dx), _ptr(dhl),
            _ptr(dmsg), _ptr(dh), n, hidden, adj.tile, adj.n_tiles,
            adj.bandwidth, stream)
        _raise_on_error(err, "fused_step_bwd_kernel")
    fused_step_bwd_rows.launches += 1
    return dh, x, dp, dmsg


fused_step_bwd_rows.launches = 0


def step_weight_grads(h0: torch.Tensor, hist: Optional[torch.Tensor],
                      x: torch.Tensor, dp: torch.Tensor, dmsg: torch.Tensor,
                      n_steps: int):
    """The packed weight gradients ``(dek, deb, dwi, dbi, dwh, dbh)`` of
    ``n_steps`` steps (see :func:`step_weight_grad_reference`). CUDA
    tensors: ``step_weight_grad_kernel``."""
    if h0.device.type == "cpu":
        return step_weight_grad_reference(h0, hist, x, dp, dmsg, n_steps)
    if not h0.is_cuda:
        raise ValueError(f"the gated-step kernels take CPU tensors (plain "
                         f"version) or CUDA tensors, got {h0.device}")
    n, hidden = h0.shape
    want = {"x": (x, (n_steps, n, hidden)), "dp": (dp, (n_steps, n,
                                                        4 * hidden)),
            "dmsg": (dmsg, (n_steps, n, hidden))}
    if n_steps > 1:
        want["hist"] = (hist, (n_steps - 1, n, hidden))
    for name, (t, shape) in want.items():
        if (tuple(t.shape) != shape or t.dtype != torch.float32
                or t.device != h0.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 {shape} on "
                             f"{h0.device}")
    if h0.dtype != torch.float32 or not h0.is_contiguous():
        raise ValueError("h0 must be contiguous float32")
    from deepdfa_tpu_torch.ops import _build

    with torch.cuda.device(h0.device):
        lib = _build.load("fused_gnn_bwd")
        f32 = dict(dtype=torch.float32, device=h0.device)
        dek = torch.empty((hidden, hidden), **f32)
        dwi = torch.empty((hidden, 3 * hidden), **f32)
        dwh = torch.empty((hidden, 3 * hidden), **f32)
        deb = torch.empty((1, hidden), **f32)
        dbi = torch.empty((1, 3 * hidden), **f32)
        dbh = torch.empty((1, 3 * hidden), **f32)
        rows_per_split = wgrad_rows_per_split(n, hidden)
        splits = -(-n // rows_per_split)
        partial = torch.empty(
            splits * n_steps * (7 * hidden * hidden + 7 * hidden), **f32)
        stream = ctypes.c_void_p(
            torch.cuda.current_stream(h0.device).cuda_stream)
        err = lib.step_weight_grad_launch(
            _ptr(h0), ctypes.c_void_p(hist.data_ptr() if n_steps > 1 else 0),
            _ptr(x), _ptr(dp), _ptr(dmsg), n, hidden, n_steps,
            rows_per_split, _ptr(partial), _ptr(dek), _ptr(deb),
            _ptr(dwi), _ptr(dbi), _ptr(dwh), _ptr(dbh), stream)
        _raise_on_error(err, "step_weight_grad_kernel")
    step_weight_grads.launches += 1
    return dek, deb, dwi, dbi, dwh, dbh


step_weight_grads.launches = 0


def fused_step_backward(params: Optional[Mapping], h: torch.Tensor,
                        adj: BandAdjacency, g: torch.Tensor,
                        packed: Optional[Sequence[torch.Tensor]] = None):
    """The step VJP ``(dh, dek, deb, dwi, dbi, dwh, dbh)``: CPU tensors
    :func:`fused_step_backward_reference`; CUDA tensors
    ``fused_step_bwd_kernel`` then ``step_weight_grad_kernel``."""
    if h.device.type == "cpu":
        return fused_step_backward_reference(params, h, adj, g)
    dh, x, dp, dmsg = fused_step_bwd_rows(params, h, adj, g, packed)
    return (dh, *step_weight_grads(h.contiguous(), None, x[None], dp[None],
                                   dmsg[None], 1))


def persistent_hist(params: Optional[Mapping], h: torch.Tensor,
                    adj: BandAdjacency, n_steps: int,
                    packed: Optional[Sequence[torch.Tensor]] = None
                    ) -> torch.Tensor:
    """``h_1..h_{K-1}`` of ``n_steps = K`` steps, ``[K-1, N, H]``. CUDA
    tensors: ``persistent_fwd_hist_kernel`` (nothing to launch for K = 1;
    the forward gate :func:`persistent_smem_ok` applies)."""
    if h.device.type == "cpu":
        return persistent_hist_reference(params, h, adj, n_steps)
    _check_cuda_inputs(h, adj)
    if n_steps < 2:
        return h.new_empty((0,) + tuple(h.shape))
    if not persistent_smem_ok(adj, h.shape[1]):
        raise ValueError("row groups over the persistent kernel's shared "
                         "memory gate")
    out = _persistent_launch(h, adj, _packed(params, packed), n_steps,
                             hist=True)
    persistent_hist.launches += 1
    return out


persistent_hist.launches = 0


def persistent_bwd_rows(params: Optional[Mapping], h0: torch.Tensor,
                        hist: torch.Tensor, adj: BandAdjacency,
                        g: torch.Tensor, n_steps: int,
                        packed: Optional[Sequence[torch.Tensor]] = None):
    """The reverse sweep ``(dh_0, x, dp, dmsg)`` of ``n_steps`` steps (see
    :func:`persistent_bwd_rows_reference`). CUDA tensors: one
    ``persistent_bwd_kernel`` launch, which needs
    :func:`persistent_bwd_smem_ok` (a failed gate raises)."""
    if h0.device.type == "cpu":
        return persistent_bwd_rows_reference(params, h0, hist, adj, g,
                                             n_steps)
    _check_cuda_inputs(h0, adj)
    g = _check_like(g, h0, "the output cotangent")
    n, hidden = h0.shape
    if not persistent_bwd_smem_ok(adj, hidden):
        raise ValueError(
            f"row groups need {persistent_bwd_smem_bytes(adj, hidden)} B of "
            f"shared memory > {PERSISTENT_SMEM_BUDGET_BYTES} (or the band "
            "has no row groups): run fused_step_backward per step")
    if n_steps > 1 and (tuple(hist.shape) != (n_steps - 1, n, hidden)
                        or not hist.is_contiguous()):
        raise ValueError(f"hist must be contiguous [{n_steps - 1}, {n}, "
                         f"{hidden}]")
    groups = _row_groups(adj, h0)
    tv = adj.transpose_vals()
    with torch.cuda.device(h0.device):
        lib, weights, bf16, stream = _launch_args(params, h0, adj, packed,
                                                  "fused_gnn_bwd")
        ek, eb, wi, bi, wh, bh = weights
        wiT, whT, ekT = _transposed(weights)
        f32 = dict(dtype=torch.float32, device=h0.device)
        x = torch.empty((n_steps, n, hidden), **f32)
        dmsg = torch.empty((n_steps, n, hidden), **f32)
        dp = torch.empty((n_steps, n, 4 * hidden), **f32)
        dh = torch.empty_like(h0)
        hist_ptr = ctypes.c_void_p(hist.data_ptr() if n_steps > 1 else 0)
        err = lib.persistent_bwd_launch(
            _ptr(h0), hist_ptr, _ptr(adj.vals), _ptr(tv), bf16, _ptr(g),
            _ptr(ek), _ptr(eb), _ptr(wi), _ptr(bi), _ptr(wh), _ptr(bh),
            _ptr(wiT), _ptr(whT), _ptr(ekT), _ptr(groups),
            groups.numel() - 1, adj.max_group_rows, n_steps, _ptr(x),
            _ptr(dp), _ptr(dmsg), _ptr(dh), hidden, adj.tile, adj.n_tiles,
            adj.bandwidth, stream)
        _raise_on_error(err, "persistent_bwd_kernel")
    persistent_bwd_rows.launches += 1
    return dh, x, dp, dmsg


persistent_bwd_rows.launches = 0


def persistent_backward(params: Optional[Mapping], h0: torch.Tensor,
                        adj: BandAdjacency, g: torch.Tensor, n_steps: int,
                        packed: Optional[Sequence[torch.Tensor]] = None):
    """The K-step VJP ``(dh_0, dek, deb, dwi, dbi, dwh, dbh)``: CPU tensors
    :func:`persistent_backward_reference`; CUDA tensors the recompute
    sweep, the reverse sweep and the weight gradients, three launches."""
    if h0.device.type == "cpu":
        return persistent_backward_reference(params, h0, adj, g, n_steps)
    packed = _packed(params, packed)
    hist = persistent_hist(None, h0, adj, n_steps, packed=packed)
    dh, x, dp, dmsg = persistent_bwd_rows(None, h0, hist, adj, g, n_steps,
                                          packed=packed)
    return (dh, *step_weight_grads(h0.contiguous(), hist, x, dp, dmsg,
                                   n_steps))


_COUNTED = {
    "fused_step_kernel": fused_gate_step,
    "persistent_fwd_kernel": persistent_unroll,
    "fused_step_bwd_kernel": fused_step_bwd_rows,
    "persistent_fwd_hist_kernel": persistent_hist,
    "persistent_bwd_kernel": persistent_bwd_rows,
    "step_weight_grad_kernel": step_weight_grads,
}


def launch_counts() -> Dict[str, int]:
    """Kernel name -> launches so far."""
    return {name: fn.launches for name, fn in _COUNTED.items()}


def reset_launch_counts() -> None:
    for fn in _COUNTED.values():
        fn.launches = 0


# ---------------------------------------------------------------------------
# Operations and bytes
# ---------------------------------------------------------------------------


def _step_flops(n: int, hidden: int, nnz: int) -> float:
    """One forward step: the dense f32 products ``(A h) W_e`` and the two
    packed gate products (2 a multiply-add), ``2 H`` for each stored
    adjacency nonzero, ~10 elementwise operations a gate element."""
    return (2.0 * n * hidden * hidden + 2.0 * 2.0 * n * hidden * 3 * hidden
            + 2.0 * nnz * hidden + 10.0 * n * hidden)


def _step_bwd_flops(n: int, hidden: int, nnz: int) -> float:
    """One step's backward down to the per-row cotangents: the forward
    recomputed, ``dx`` and ``dhl`` (two packed [N, 3H] x [3H, H]
    products), ``A^T dx`` over the stored nonzeros, ``dmsg W_e^T`` and
    ~30 elementwise operations a gate element."""
    return (_step_flops(n, hidden, nnz)
            + 2.0 * 2.0 * n * 3 * hidden * hidden + 2.0 * nnz * hidden
            + 2.0 * n * hidden * hidden + 30.0 * n * hidden)


KERNELS = tuple(_COUNTED)


def kernel_cost(adj: BandAdjacency, hidden: int, n_steps: int = 1,
                kernel: str = "fused_step_kernel") -> Dict[str, float]:
    """Operations and compulsory bytes of one ``kernel`` call covering
    ``n_steps`` gated steps on these inputs, each input read once and
    each output written once (the nonzeros the kernels skip zeros by, so
    this run's data sets the sparse terms). f32 h and weights.

    - ``fused_step_kernel``/``persistent_fwd_kernel``: ``n_steps``
      forward steps; ``h`` in and out, the band and the packed weights,
      once for the persistent kernel's one launch and ``n_steps`` times
      for the ``n_steps`` launches of the fused kernel.
    - ``persistent_fwd_hist_kernel``: ``n_steps - 1`` steps; ``h_0`` in,
      ``K-1`` planes of hist out.
    - ``fused_step_bwd_kernel``: one step's backward (``n_steps`` is
      ignored); ``h`` and ``g`` in, A and A^T, the weights and their
      transposes, ``dh``, ``x``, ``dmsg`` and ``dp`` (4H) out.
    - ``persistent_bwd_kernel``: ``n_steps`` of those; ``h_0``, hist and
      ``g`` in, ``dh`` and each step's ``x``, ``dp``, ``dmsg`` out.
    - ``step_weight_grad_kernel``: the three contractions ``x^T dpre_i``,
      ``h^T dpre_h``, ``h^T dmsg`` and the bias sums over every row of
      ``n_steps`` steps; each step's ``h``, ``x``, ``dp``, ``dmsg`` in,
      the gradients out.

    ``peak_flops``/``peak``: the rate the operations bound divides by:
    the f32 work of 3xTF32 products on the tensor cores for
    ``step_weight_grad_kernel``, f32 FMAs on the CUDA cores for the
    others. Also ``bwd_flops``/``bwd_bytes``: the
    whole ``n_steps``-step VJP, as
    the reference's ``fused_step_cost`` counts its ``bwd_*``, with only
    its compulsory traffic (h_0 and g in, dh_0 out, A and A^T, the
    weights in and the f32 gradients out).
    """
    n = adj.n_tiles * adj.tile
    nnz = int(torch.count_nonzero(adj.vals))
    plane = 4.0 * n * hidden
    band = float(adj.vals.numel() * adj.vals.element_size())
    weights = (7.0 * hidden * hidden + 7.0 * hidden) * 4
    fwd = _step_flops(n, hidden, nnz)
    bwd = _step_bwd_flops(n, hidden, nnz)
    wgrad = 2.0 * n * hidden * 7 * hidden + 7.0 * n * hidden
    cotangents = 6 * plane  # x, dmsg and the 4H dp of one step
    if kernel == "fused_step_kernel":
        flops, nbytes = n_steps * fwd, n_steps * (2 * plane + band + weights)
    elif kernel == "persistent_fwd_kernel":
        flops, nbytes = n_steps * fwd, 2 * plane + band + weights
    elif kernel == "persistent_fwd_hist_kernel":
        flops = (n_steps - 1) * fwd
        nbytes = plane * n_steps + band + weights
    elif kernel == "fused_step_bwd_kernel":
        flops = bwd
        nbytes = (3 * plane + cotangents + 2 * band
                  + weights + 7.0 * hidden * hidden * 4)
    elif kernel == "persistent_bwd_kernel":
        flops = n_steps * bwd
        nbytes = ((n_steps + 2) * plane + n_steps * cotangents + 2 * band
                  + weights + 7.0 * hidden * hidden * 4)
    elif kernel == "step_weight_grad_kernel":
        flops = n_steps * wgrad
        nbytes = n_steps * (plane + cotangents) + weights
    else:
        raise ValueError(f"unknown kernel {kernel!r}; one of {KERNELS}")
    peak = (PEAK_3XTF32 if kernel == "step_weight_grad_kernel"
            else PEAK_F32_SIMT)
    return {
        "flops": flops,
        "bytes": nbytes,
        "peak": peak[0],
        "peak_flops": peak[1],
        "nnz": nnz,
        "bwd_flops": n_steps * (bwd + wgrad) + (n_steps - 1) * fwd,
        "bwd_bytes": 3 * plane + 2 * band + 2 * weights,
    }
