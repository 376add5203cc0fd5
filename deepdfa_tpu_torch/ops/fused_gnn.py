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

At bf16 ``h`` (``FlowGNN(dtype="bfloat16")``) :func:`fused_gate_step`
launches ``fused_step_kernel_bf16`` and :func:`persistent_unroll`
``persistent_fwd_kernel_bf16``, the same TPU kernels at ``dt =
bfloat16``: they round where the reference's kernel rounds (the plain
versions, :func:`fused_step_reference` and :func:`persistent_reference`
on bf16 ``h``, with it), counted apart (``launches_bf16``), their
products on the bf16 tensor cores (``csrc/gnn_bf16_mma.cuh``). The fused
lane's backward has its bf16 instances too: :func:`fused_step_bwd_rows`
launches ``fused_step_bwd_kernel_bf16`` and :func:`step_weight_grads`
``step_weight_grad_kernel_bf16`` (bf16 tensor-core products on its own
splits, :func:`wgrad_bf16_rows_per_split`; plain versions, the same
functions on bf16 ``h``: :func:`_bwd_rows_bf16`), and so does the
persistent lane's:
:func:`persistent_hist` launches ``persistent_fwd_hist_kernel_bf16`` and
:func:`persistent_bwd_rows` ``persistent_bwd_kernel_bf16`` (plain
versions, :func:`persistent_hist_reference` and
:func:`persistent_bwd_rows_reference` on bf16 ``h``), each bit for bit
the scan of its per-step instance.

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
under ``ops.count_launch``'s lock where the kernel is launched and
nowhere else.

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

from deepdfa_tpu_torch.ops import (PEAK_3XTF32, PEAK_BF16, PEAK_BF16X3,
                                   PEAK_F32_SIMT, count_launch)
from deepdfa_tpu_torch.ops.band_spmm import (
    BandAdjacency,
    band_spmm,
    transpose_band,
    vals_compute,
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
    splits = -(-WGRAD_FILL_SMS // _wgrad_tiles(hidden))
    rows = -(-n_rows // splits)
    return max(WGRAD_SLAB_ROWS, -(-rows // WGRAD_SLAB_ROWS) * WGRAD_SLAB_ROWS)


#: step_weight_grad_kernel_bf16's layout, mirrors of ``kW16Slab``,
#: ``kW16Stages``, ``kW16SplitStages`` and ``kW16Blocks`` in
#: ``csrc/fused_gnn_bwd.cu``: rows a slab (two 16-deep k-slices), the
#: ``cp.async`` ring's slab stages (f32 messages: three bf16 parts of
#: dmsg a slab, in fewer stages), blocks an SM; and the blocks one step's
#: tiles may take: one an SM of an H100 SXM (a K-step call's steps fill
#: the second).
WGRAD_BF16_SLAB_ROWS = 32
WGRAD_BF16_STAGES = 3
WGRAD_BF16_SPLIT_STAGES = 2
WGRAD_BF16_BLOCKS = 2
WGRAD_BF16_FILL_BLOCKS = WGRAD_FILL_SMS


def _wgrad_tiles(hidden: int) -> int:
    """Output tiles of one step's weight pass: ``x^T dpre_i``, ``h^T
    dpre_h`` ([H, 3H] each) and ``h^T dmsg`` ([H, H]) in
    ``WGRAD_TILE``-wide tiles."""
    tiles_a = -(-hidden // WGRAD_TILE)
    return tiles_a * (2 * -(-3 * hidden // WGRAD_TILE) + tiles_a)


def wgrad_bf16_rows_per_split(n_rows: int, hidden: int) -> int:
    """Rows a block of ``step_weight_grad_kernel_bf16`` sums: as many
    splits as one step's output tiles can take without passing
    ``WGRAD_BF16_FILL_BLOCKS`` resident blocks (so a step's blocks are
    one wave, not one and a block), each a multiple of
    ``WGRAD_BF16_SLAB_ROWS`` rows; from the row count and width alone, so
    a K-step call sums each step exactly as a one-step call does. The
    training batch (N 16384, H 128): 7 tiles, 18 splits of 928 rows, 126
    blocks a step."""
    splits = max(1, WGRAD_BF16_FILL_BLOCKS // _wgrad_tiles(hidden))
    rows = -(-n_rows // splits)
    slab = WGRAD_BF16_SLAB_ROWS
    return max(slab, -(-rows // slab) * slab)


def wgrad_bf16_smem_bytes(round_msg: bool) -> int:
    """Dynamic shared memory of the ``step_weight_grad_kernel_bf16``
    instance a launch runs (``wgrad_bf16_smem`` in the source): the ring's
    f32 R and bf16 L slab stages, two bf16 R slabs of one part (bf16
    messages: dmsg rounded) or three (f32 messages: dmsg split)."""
    stages = WGRAD_BF16_STAGES if round_msg else WGRAD_BF16_SPLIT_STAGES
    parts = 1 if round_msg else 3
    ld = WGRAD_TILE + 8  # a bf16 slab row, padded
    slab = WGRAD_BF16_SLAB_ROWS
    return (stages * slab * (WGRAD_TILE * 4 + ld * 2)
            + 2 * parts * slab * ld * 2)


def _dense(p: Mapping, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    y = x @ p["kernel"].to(dt)
    if "bias" in p:
        y = y + p["bias"].to(dt)
    return y


# ---------------------------------------------------------------------------
# bf16: the reference kernel's rounding points
# ---------------------------------------------------------------------------
#
# At dt = bfloat16 the reference's _fwd_kernel rounds inside the step: the
# packed weights to bf16 first; the message h·W_e (f32 sums) to bf16 and
# its bias add in bf16 when the band values are bf16 (the message dtype
# mdt, vals_compute), else the message stays f32; the aggregate (f32 sums)
# to bf16; each gate product to bf16 and its bias add in bf16; then every
# elementwise op of the GRU gate in bf16. The plain versions below hold
# bf16 tensors, take each product and sum in f32 (a product of two bf16
# values is exact in f32) and round where the kernel rounds; a torch
# elementwise op on bf16 tensors computes in f32 and rounds its result
# (round to nearest even), one rounding an op as in the kernel. The CUDA
# bf16 instances round at the same points.


def matmul_bf16(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` of bf16 tensors: f32 products and sums, rounded once."""
    return (x.float() @ w.float()).to(torch.bfloat16)


def sigmoid_bf16(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` of a bf16 tensor as XLA computes it:
    ``1 / (1 + exp(-x))``, the exponential, the sum and the quotient each
    rounded to bf16 (one rounding of the f32 sigmoid would differ in
    about a third of the elements)."""
    return 1.0 / (1.0 + torch.exp(-x))


def gru_bf16(gi: torch.Tensor, gh: torch.Tensor,
             hc: torch.Tensor) -> torch.Tensor:
    """The GRU gate on bf16 tensors: ``gi``/``gh`` the [N, 3H] input and
    recurrent pre-activations (r|z|n, biases added), ``hc`` the carry;
    each op rounds to bf16, as flax's ``GRUCell(dtype=bfloat16)`` and the
    reference kernel's gate compute it."""
    hid = hc.shape[1]
    r = sigmoid_bf16(gi[:, :hid] + gh[:, :hid])
    z = sigmoid_bf16(gi[:, hid:2 * hid] + gh[:, hid:2 * hid])
    n = torch.tanh(gi[:, 2 * hid:] + r * gh[:, 2 * hid:])
    return (1.0 - z) * n + z * hc


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """An f32 tensor's values rounded to bf16 (nearest even), kept f32."""
    return t.bfloat16().float()


def _gates_bf16(packed: Sequence[torch.Tensor], h: torch.Tensor,
                adj: BandAdjacency):
    """The aggregate ``x`` and the gate pre-activations ``gi``, ``gh`` of
    one step at bf16, at the reference kernel's rounding points. The
    packed weights are rounded to bf16 here (a no-op on bf16 ones)."""
    ek, eb, wi, bi, wh, bh = (w.to(torch.bfloat16) for w in packed)
    if msg_dtype(adj, torch.bfloat16) == torch.bfloat16:
        msg = matmul_bf16(h, ek) + eb
    else:  # f32 band values: f32 messages
        msg = h.float() @ ek.float() + eb.float()
    x = band_spmm(adj, msg).to(torch.bfloat16)
    return x, matmul_bf16(x, wi) + bi, matmul_bf16(h, wh) + bh


def _step_bf16(packed: Sequence[torch.Tensor], h: torch.Tensor,
               adj: BandAdjacency) -> torch.Tensor:
    """One step at bf16 from packed weights (bf16, or the f32 masters,
    rounded), at the reference kernel's rounding points; bf16 ``h`` in
    and out."""
    _, gi, gh = _gates_bf16(packed, h, adj)
    return gru_bf16(gi, gh, h)


def fused_step_reference(params: Mapping, h: torch.Tensor,
                         adj: BandAdjacency) -> torch.Tensor:
    """Plain PyTorch version of ``fused_step_kernel``: edge message ->
    ``band_spmm`` aggregate -> GRU gate, in ``h``'s dtype. bf16 ``h``:
    the plain version of ``fused_step_kernel_bf16``, rounding where the
    reference kernel rounds (weights packed at bf16)."""
    dt = h.dtype
    if dt == torch.bfloat16:
        return _step_bf16(packed_weights(params, dt), h, adj)
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
    """Plain PyTorch version of ``persistent_fwd_kernel`` (and, for bf16
    ``h``, of ``persistent_fwd_kernel_bf16``): ``n_steps`` applications
    of :func:`fused_step_reference` with shared weights."""
    for _ in range(n_steps):
        h = fused_step_reference(params, h, adj)
    return h


def packed_weights(params: Mapping, dtype: torch.dtype = torch.float32
                   ) -> Tuple[torch.Tensor, ...]:
    """(ek, eb, wi, bi, wh, bh) at ``dtype`` (the model's: f32, or bf16
    rounded from the f32 parameters, as the reference's
    ``_packed_weights(params, dt)``), the kernels' weight layout: the
    edge weights, and the r|z|n gate kernels concatenated on the output
    axis ([H, 3H]); the recurrent bias packs ``[0, 0, b_hn]`` (flax's GRU
    has no hidden-side r/z bias). Biases are ``[1, n]`` rows, as in the
    reference."""
    g = params["gru"]
    hidden = g["ir"]["kernel"].shape[0]
    ek = params["edge_linear"]["kernel"].to(dtype)
    eb = params["edge_linear"]["bias"].to(dtype).reshape(1, -1)
    wi = torch.cat([g["ir"]["kernel"], g["iz"]["kernel"], g["in"]["kernel"]],
                   dim=1).to(dtype)
    bi = torch.cat([g["ir"]["bias"], g["iz"]["bias"], g["in"]["bias"]]
                   ).to(dtype).reshape(1, -1)
    wh = torch.cat([g["hr"]["kernel"], g["hz"]["kernel"], g["hn"]["kernel"]],
                   dim=1).to(dtype)
    zeros = torch.zeros(2 * hidden, dtype=dtype, device=wh.device)
    bh = torch.cat([zeros, g["hn"]["bias"].to(dtype)]).reshape(1, -1)
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
                          cluster: int = 1,
                          dtype: torch.dtype = torch.float32) -> int:
    """Shared memory of ``persistent_fwd_kernel``'s blocks (every block
    gets the largest group's): the weight-slab stages, the group's
    resident h and its aggregate (x) at :func:`persistent_row_stride`, a
    third such array (x apart from the aggregate) when ``cluster`` blocks
    share a group, one row sum a row. 87,744 bytes for groups of 48 rows
    at H 128 (two blocks an SM). ``dtype`` bf16: the count the bf16
    forward's gate keeps, three such arrays at any cluster size (113,088
    bytes at 48 rows), so the same batches take the sweep as before its
    tensor-core layout, which needs less
    (:func:`persistent_fwd_bf16_smem_bytes`)."""
    three = cluster > 1 or dtype == torch.bfloat16
    return _persistent_smem(adj, hidden, 3 if three else 2)


def persistent_smem_ok(adj: BandAdjacency, hidden: int,
                       dtype: torch.dtype = torch.float32) -> bool:
    """The persistent kernel's eligibility gate (replaces the
    reference's 12 MiB VMEM budget): the adjacency carries closed row
    groups and the largest fits a block's shared memory (184 rows at
    H 128; 123 for the bf16 instance). Over the gate the model runs
    ``fused_step_kernel`` (bf16: ``fused_step_kernel_bf16``) ``n_steps``
    times instead."""
    return (adj.row_groups is not None
            and persistent_smem_bytes(adj, hidden, 1, dtype)
            <= PERSISTENT_SMEM_BUDGET_BYTES)


#: Blocks of a thread-block cluster that share a row group where the
#: groups are fewer than the SMs.
PERSISTENT_CLUSTER = 2


def persistent_cluster_size(adj: BandAdjacency, hidden: int, sms: int,
                            dtype: torch.dtype = torch.float32) -> int:
    """Blocks of ``persistent_fwd_kernel`` a row group gets on a card with
    ``sms`` SMs: :data:`PERSISTENT_CLUSTER` where those blocks still fit
    one to an SM, each owning a slice of at least 32 product columns, with
    the three row arrays in shared memory; else 1. The serving bucket (34
    groups of up to 48 rows, H 128, 132 SMs) gets 2, the training batch
    (523 groups) 1. ``dtype`` bf16: ``persistent_fwd_kernel_bf16`` and its
    hist instance, one block a group at any batch (1). Host ints only: no
    device read."""
    if dtype == torch.bfloat16:
        return 1
    n_groups = adj.row_groups.numel() - 1
    hp = persistent_row_stride(hidden) - 4
    cs = PERSISTENT_CLUSTER
    if (n_groups * cs <= sms and hp // cs >= 32
            and persistent_smem_bytes(adj, hidden, cs)
            <= PERSISTENT_SMEM_BUDGET_BYTES):
        return cs
    return 1


def persistent_bwd_smem_bytes(adj: BandAdjacency, hidden: int,
                              dtype: torch.dtype = torch.float32) -> int:
    """Shared memory of ``persistent_bwd_kernel``'s blocks: the weight-slab
    stages, the group's resident cotangent, h (then dx) and the aggregate
    (then x, then dmsg), one row sum a row. 113,088 bytes for groups of
    48 rows at H 128: two blocks an SM. ``dtype`` bf16: the count the
    bf16 backward's gate keeps, four such arrays (138,432 bytes at 48
    rows), so the same batches take the sweep as before its tensor-core
    layout, which needs less (:func:`persistent_bwd_bf16_smem_bytes`)."""
    return _persistent_smem(adj, hidden,
                            4 if dtype == torch.bfloat16 else 3)


def persistent_bwd_smem_ok(adj: BandAdjacency, hidden: int,
                           dtype: torch.dtype = torch.float32) -> bool:
    """The persistent backward's gate, as :func:`persistent_smem_ok` with
    three row arrays (123 rows at H 128; the bf16 instance's four, 92
    rows). A training batch over it runs the fused step forward and
    backward (at bf16 their bf16 instances) ``n_steps`` times."""
    return (adj.row_groups is not None
            and persistent_bwd_smem_bytes(adj, hidden, dtype)
            <= PERSISTENT_SMEM_BUDGET_BYTES)


#: The bf16 backward instances' layout (``csrc/gnn_bf16_mma.cuh``): the
#: weight stages (one: ``scripts/torch_gnn_bwd_bf16_layouts.py`` timed
#: two), each the gate's six slabs of :data:`GNN_BF16_SLAB_ROWS` k rows
#: (``kRingStages``, ``kKS``); a warp's item, 16 rows by
#: :data:`GNN_BF16_ITEM_COLS` output columns (``kNC``). The bf16 forward
#: instances' weight stages (``kFwdRingStages`` in ``csrc/fused_gnn.cu``;
#: ``scripts/torch_gnn_fwd_bf16_layouts.py`` times other counts).
GNN_BF16_RING_STAGES = 1
GNN_BF16_SLAB_ROWS = 16
GNN_BF16_ITEM_COLS = 32
GNN_BF16_FWD_RING_STAGES = 2


def _bf16_ring_bytes(hidden: int, stages: int) -> int:
    """Bytes of a weight ring of ``stages`` stages of the gate's six [16,
    hp + 8] bf16 slabs (hp: ``hidden`` rounded up to 16)."""
    return stages * 6 * GNN_BF16_SLAB_ROWS * (-(-hidden // 16) * 16 + 8) * 2


def _bf16_bwd_layout(hidden: int, rows: int) -> Tuple[int, int, int]:
    """(elements of ``rows`` rows of a row tile, the weight ring's bytes,
    the dp tile's bytes) of the bf16 backward instances: row tiles at a
    stride of hp + 8 elements (hp: ``hidden`` rounded up to 16), the
    ring's stages of six [16, hp + 8] bf16 slabs, the dp tile [rows of a
    pass, 4 hp + 8] bf16 (a pass: the 8 warps over the row tiles' column
    items)."""
    hp = -(-hidden // 16) * 16
    ld = hp + 8
    ring = _bf16_ring_bytes(hidden, GNN_BF16_RING_STAGES)
    pass_rows = 16 * (8 // -(-hp // GNN_BF16_ITEM_COLS))
    dp = min(-(-rows // 16) * 16, pass_rows) * (4 * hp + 8) * 2
    return rows * ld, ring, dp


def persistent_bwd_bf16_smem_bytes(adj: BandAdjacency, hidden: int) -> int:
    """Shared memory of ``persistent_bwd_kernel_bf16``'s blocks
    (``csrc/fused_gnn_bwd.cu:persistent_bwd_bf16_smem``; the library's
    figure comes back from :func:`persistent_occupancy`): the weight ring,
    the cotangent (f32), one region that holds h and x (bf16) and the
    messages (sized f32) until the gate is done, then dx (sized f32)
    beside the dp rows or dmsg (f32), and the row sums, for the largest
    group padded to 16 rows. 111,808 bytes at 48 rows (two blocks an
    SM), 183,168 at 92 (H 128). The gate stays
    :func:`persistent_bwd_smem_ok`'s count, which this never exceeds."""
    rp = -(-adj.max_group_rows // 16) * 16
    rows, ring, dp = _bf16_bwd_layout(hidden, rp)
    return (ring + 4 * rows + max(8 * rows, 4 * rows + max(dp, 4 * rows))
            + 4 * rp)


def persistent_fwd_bf16_smem_bytes(adj: BandAdjacency, hidden: int) -> int:
    """Shared memory of ``persistent_fwd_kernel_bf16``'s blocks (and its
    hist instance's; ``csrc/fused_gnn.cu:persistent_fwd_bf16_smem``, the
    library's figure comes back from :func:`persistent_occupancy`): the
    forward's weight ring (:data:`GNN_BF16_FWD_RING_STAGES`), then h and x
    (bf16) and the messages (sized f32) at a row stride of hp + 8, for
    the largest group padded to 16 rows, and the row sums and x's and h's
    row norms. 105,024 bytes at 48 rows (two blocks an SM), 193,024 at
    the 123 rows the gate admits (H 128). The gate
    stays :func:`persistent_smem_ok`'s count, which this never exceeds."""
    rp = -(-adj.max_group_rows // 16) * 16
    ld = -(-hidden // 16) * 16 + 8
    return (_bf16_ring_bytes(hidden, GNN_BF16_FWD_RING_STAGES)
            + 8 * rp * ld + 12 * rp + 28 * hidden)


def persistent_occupancy(adj: BandAdjacency, hidden: int,
                         kernel: str = "persistent_fwd_kernel",
                         cluster: int = 1) -> dict:
    """The CUDA occupancy query (registers, shared memory, threads) for the
    instance of ``persistent_fwd_kernel`` (its hist instance is the same
    code), ``persistent_fwd_kernel_bf16``,
    ``persistent_fwd_hist_kernel_bf16`` (its kHist instance),
    ``persistent_bwd_kernel`` or ``persistent_bwd_kernel_bf16`` that a
    launch at this adjacency's largest group runs, ``cluster`` blocks a
    group (the forwards only): ``blocks_per_sm``, the blocks one SM
    holds, ``active_clusters``, the clusters the card holds at once
    (None for cluster 1), and, for the bf16 instances,
    ``smem_bytes``, their blocks' dynamic shared memory as the library
    sizes it (the bf16 forwards run one block a group: cluster 1)."""
    from deepdfa_tpu_torch.ops import _build

    bf16 = int(adj.vals.dtype == torch.bfloat16)
    blocks, clusters, smem = ctypes.c_int(0), ctypes.c_int(0), None
    if kernel == "persistent_fwd_kernel":
        err = _build.load("fused_gnn").persistent_fwd_occupancy(
            bf16, adj.max_group_rows, hidden, cluster, ctypes.byref(blocks),
            ctypes.byref(clusters))
    elif kernel in ("persistent_fwd_kernel_bf16",
                    "persistent_fwd_hist_kernel_bf16") and cluster == 1:
        smem = ctypes.c_int(0)
        err = _build.load("fused_gnn").persistent_fwd_bf16_occupancy(
            bf16, adj.max_group_rows, hidden,
            int(kernel == "persistent_fwd_hist_kernel_bf16"),
            ctypes.byref(blocks), ctypes.byref(smem))
    elif kernel == "persistent_bwd_kernel" and cluster == 1:
        err = _build.load("fused_gnn_bwd").persistent_bwd_occupancy(
            bf16, adj.max_group_rows, hidden, ctypes.byref(blocks))
    elif kernel == "persistent_bwd_kernel_bf16" and cluster == 1:
        smem = ctypes.c_int(0)
        err = _build.load("fused_gnn_bwd").persistent_bwd_bf16_occupancy(
            bf16, adj.max_group_rows, hidden, ctypes.byref(blocks),
            ctypes.byref(smem))
    else:
        raise ValueError(f"no occupancy query for {kernel} in clusters of "
                         f"{cluster}")
    _raise_on_error(err, f"{kernel} occupancy")
    out = dict(blocks_per_sm=blocks.value,
               active_clusters=clusters.value if cluster > 1 else None)
    if smem is not None:
        out["smem_bytes"] = smem.value
    return out


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
    ``fused_step_bwd_kernel``, ``fused_step_bwd_kernel_bf16`` and
    ``fused_step_kernel_bf16``: 32-row tiles, 16 where those are fewer
    than ``sms`` blocks, no clusters; slabs of 4 k rows (the bf16
    instances: their weight ring's stages of :data:`GNN_BF16_SLAB_ROWS` k
    rows of the gate's slabs). Returns
    ``row_tile``, ``cluster``, ``slab_rows``, ``blocks`` (each pass's
    grid) and ``wide``. Host ints only."""
    cdiv = lambda a, b: -(-a // b)
    hp = persistent_row_stride(hidden) - 4
    wide = False
    if kernel == "fused_step_kernel":
        if cdiv(n_rows, 32) >= sms or hp // 2 < 32:
            cs, rt, wide = 1, STEP_WIDE_TILE, hp == 128
            gr = 16 if wide and hidden % 16 == 0 else 4
        else:
            cs, rt, gr = 2, 16, 8 if hidden % 8 == 0 else 4
    elif kernel in ("fused_step_bwd_kernel", "fused_step_bwd_kernel_bf16",
                    "fused_step_kernel_bf16"):
        cs, gr = 1, PERSISTENT_SLAB_ROWS
        if kernel.endswith("_bf16"):
            gr = GNN_BF16_SLAB_ROWS
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
    and the aggregate; pass 1: dx and dmsg), one row sum a row. The bf16
    forward (``csrc/fused_gnn.cu:step_bf16_smem``): its weight ring
    (:data:`GNN_BF16_FWD_RING_STAGES`), then its pass 0: h (bf16) and its
    row norms; pass 1: h and x (bf16), the messages (sized f32), one row
    sum and x's and h's norms a row. The bf16
    backward (``csrc/fused_gnn_bwd.cu:step_bwd_bf16_smem``): its weight
    ring, then its pass 0: h (bf16); pass 1: the cotangent (f32), then h
    and x (bf16) and the messages (sized f32), or the dp rows once the
    gate is done, whichever is larger; pass 2: dx (sized f32) and dmsg;
    row tiles at a stride of hp + 8 elements; one row sum a row but in
    pass 0. Bounded by the tile, never by a graph. ``bwd_pass`` names the
    pass of a two- or three-pass kernel."""
    p = step_plan(n_rows, hidden, sms, kernel)
    if kernel == "fused_step_kernel_bf16":
        rt = p["row_tile"]
        rows = rt * (-(-hidden // 16) * 16 + 8)
        return (_bf16_ring_bytes(hidden, GNN_BF16_FWD_RING_STAGES)
                + (2 * rows + 4 * rt if bwd_pass == 0
                   else 8 * rows + 12 * rt) + 28 * hidden)
    if kernel == "fused_step_bwd_kernel_bf16":
        rt = p["row_tile"]
        rows, ring, dp = _bf16_bwd_layout(hidden, rt)
        return ring + (2 * rows, 4 * rows + max(8 * rows, dp) + 4 * rt,
                       8 * rows + 4 * rt)[bwd_pass]
    ld = persistent_row_stride(hidden)
    stages = PERSISTENT_STAGES * p["slab_rows"] * 6 * (ld - 4)
    sums = p["row_tile"]
    if kernel == "fused_step_kernel":
        arrays = 3 if p["cluster"] > 1 else 2
    else:
        arrays = 3 if bwd_pass == 0 else 2
    return 4 * (stages + arrays * p["row_tile"] * ld + sums)


def step_geometry(adj: BandAdjacency, hidden: int,
                  kernel: str = "fused_step_kernel") -> dict:
    """The launch geometry the CUDA launcher of a per-step kernel picks at
    this adjacency: :func:`step_plan`'s keys as the library reports them,
    ``blocks_per_sm``, the CUDA occupancy query of the instance that
    launches, ``smem_bytes``, its blocks' dynamic shared memory (for the
    two-pass kernels, of pass 0, and ``blocks_per_sm_pass1``,
    ``smem_bytes_pass1``; the three-pass bf16 backward also
    ``*_pass2``) and ``sms``, the device's SM count the plan filled."""
    from deepdfa_tpu_torch.ops import _build

    bf16 = int(adj.vals.dtype == torch.bfloat16)
    n = adj.n_tiles * adj.tile
    if kernel == "fused_step_kernel":
        keys = ("row_tile", "cluster", "slab_rows", "blocks",
                "blocks_per_sm", "smem_bytes", "sms")
        geometry = _build.load("fused_gnn").fused_step_geometry
    elif kernel == "fused_step_kernel_bf16":
        keys = ("row_tile", "cluster", "slab_rows", "blocks",
                "blocks_per_sm", "blocks_per_sm_pass1", "smem_bytes",
                "smem_bytes_pass1", "sms")
        geometry = _build.load("fused_gnn").fused_step_bf16_geometry
    elif kernel == "fused_step_bwd_kernel":
        keys = ("row_tile", "slab_rows", "blocks", "blocks_per_sm",
                "blocks_per_sm_pass1", "smem_bytes", "smem_bytes_pass1",
                "sms")
        geometry = _build.load("fused_gnn_bwd").fused_step_bwd_geometry
    elif kernel == "fused_step_bwd_kernel_bf16":
        keys = ("row_tile", "slab_rows", "blocks", "blocks_per_sm",
                "blocks_per_sm_pass1", "blocks_per_sm_pass2", "smem_bytes",
                "smem_bytes_pass1", "smem_bytes_pass2", "sms")
        geometry = _build.load("fused_gnn_bwd").fused_step_bwd_bf16_geometry
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
    if h.dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(
            f"the CUDA gated-step kernels take float32 or bfloat16 h, got "
            f"{h.dtype}")
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
    if any(w.device != h.device or w.dtype not in (h.dtype, torch.float32)
           for w in packed):
        raise ValueError(f"step weights must be {h.dtype} on {h.device}, "
                         "as h (or, at bf16 h, the f32 masters)")
    # The f32 kernels read f32 weights; the bf16 instances read the
    # matrices (ek, wi, wh) as bf16 (the f32 masters rounded once a call)
    # and the biases as f32 arrays of bf16 values.
    weights = [w.detach().to(h.dtype) for w in packed]
    bf16_matrices = h.dtype == torch.bfloat16
    weights = [(w if bf16_matrices and i % 2 == 0 else w.float()).contiguous()
               for i, w in enumerate(weights)]
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
            packed: Optional[Sequence[torch.Tensor]],
            dtype: torch.dtype = torch.float32) -> Tuple:
    return (tuple(packed) if packed is not None
            else packed_weights(params, dtype))


def msg_dtype(adj: BandAdjacency, dtype: torch.dtype) -> torch.dtype:
    """The message dtype ``mdt`` of a step at ``dtype`` on this band:
    ``dtype``, or f32 for f32 band values (the upcast-only rule,
    :func:`vals_compute`)."""
    return vals_compute(adj, dtype)[1]


def fused_step_bwd_rows_reference(params: Optional[Mapping], h: torch.Tensor,
                                  adj: BandAdjacency, g: torch.Tensor,
                                  packed: Optional[Sequence[torch.Tensor]]
                                  = None):
    """Plain version of ``fused_step_bwd_kernel``: one step's cotangents,
    the math of the reference's ``_bwd_kernel`` in torch ops. Returns
    ``(dh, x, dp, dmsg)``: the input cotangent, the edge aggregate ``x``
    the gate saw, ``dp = [dpre_r | dpre_z | dpre_n | dpre_hn]`` ([N, 4H])
    and ``dmsg = A^T dx``. bf16 ``h``: the plain version of
    ``fused_step_bwd_kernel_bf16`` (:func:`_bwd_rows_bf16`)."""
    packed = _packed(params, packed)
    if h.dtype == torch.bfloat16:
        return _bwd_rows_bf16(packed, h, adj, g)
    ek, _, wi, _, wh, _ = packed
    hid = h.shape[1]
    x, gi, gh = _gates_f32(packed, h, adj)
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


def _gates_f32(packed: Sequence[torch.Tensor], h: torch.Tensor,
               adj: BandAdjacency):
    """The aggregate ``x`` and the gate pre-activations ``gi``, ``gh`` of
    one f32 step from packed weights."""
    ek, eb, wi, bi, wh, bh = packed
    x = band_spmm(adj, h @ ek + eb)
    return x, x @ wi + bi, h @ wh + bh


def _plain_step(params: Optional[Mapping], h: torch.Tensor,
                adj: BandAdjacency,
                packed: Optional[Sequence[torch.Tensor]]) -> torch.Tensor:
    """One step of the plain versions: :func:`fused_step_reference` of
    ``params``, or from ``packed`` weights (bf16 ``h``: :func:`_step_bf16`,
    the f32 masters rounded inside; f32: the packed products)."""
    if packed is None:
        return fused_step_reference(params, h, adj)
    if h.dtype == torch.bfloat16:
        return _step_bf16(packed, h, adj)
    hid = h.shape[1]
    _, gi, gh = _gates_f32(packed, h, adj)
    r = torch.sigmoid(gi[:, :hid] + gh[:, :hid])
    z = torch.sigmoid(gi[:, hid:2 * hid] + gh[:, hid:2 * hid])
    n = torch.tanh(gi[:, 2 * hid:] + r * gh[:, 2 * hid:])
    return (1.0 - z) * n + z * h


def _bwd_rows_bf16(packed: Sequence[torch.Tensor], h: torch.Tensor,
                   adj: BandAdjacency, g: torch.Tensor):
    """One step's cotangents at bf16, rounding where the reference's
    ``_bwd_kernel`` rounds at ``dt = bfloat16``: the forward recomputed
    as :func:`_step_bf16` (``x`` rounded); the gate cotangents in f32
    from the gates as the reference's backward sees them where its tests
    run it (the Pallas interpreter on XLA's CPU backend, whose excess
    precision elides a bf16 value's round trip to f32): r and z the
    sigmoid's f32 quotient, n the f32 tanh of its bf16 argument, pre_hn,
    g and h bf16; ``dpre_i``/``dpre_h`` rounded to bf16 for the
    products ``dx = dpre_i W_i^T`` and ``dhl = dhc + dpre_h W_h^T``; ``dx``
    rounded to the message dtype ``mdt`` before ``A^T``; ``dmsg`` summed
    in f32, rounded to ``mdt`` for ``dh = round_bf16(dhl + dmsg W_e^T)``.
    The row buffers: ``x`` bf16; ``dp`` and ``dmsg`` f32, unrounded (the
    weight pass rounds its product operands on load, and sums the bias
    gradients unrounded)."""
    bf16 = torch.bfloat16
    hid = h.shape[1]
    round_msg = msg_dtype(adj, bf16) == bf16
    ek, _, wi, _, wh, _ = (w.to(bf16).float() for w in packed)
    x, gi, gh = _gates_bf16(packed, h, adj)
    r = _sigmoid_unrounded(gi[:, :hid] + gh[:, :hid])
    z = _sigmoid_unrounded(gi[:, hid:2 * hid] + gh[:, hid:2 * hid])
    pre_hn = gh[:, 2 * hid:]
    n = torch.tanh((gi[:, 2 * hid:] + r.bfloat16() * pre_hn).float())
    g, h, pre_hn = g.float(), h.float(), pre_hn.float()
    dz = g * (h - n)
    dn = g * (1.0 - z)
    dhc = g * z
    dpre_n = dn * (1.0 - n * n)
    dpre_hn = dpre_n * r
    dpre_r = dpre_n * pre_hn * r * (1.0 - r)
    dpre_z = dz * z * (1.0 - z)
    dp = torch.cat([dpre_r, dpre_z, dpre_n, dpre_hn], dim=1)
    dpi_c, dph_c = _dpre_operands(dp, hid)
    dx = dpi_c @ wi.T
    dhl = dhc + dph_c @ wh.T
    if round_msg:
        dx = round_bf16(dx)
    dmsg = band_spmm(transpose_band(adj), dx)
    dmsg_c = round_bf16(dmsg) if round_msg else dmsg
    dh = (dhl + dmsg_c @ ek.T).to(bf16)
    return dh, x, dp, dmsg


def _sigmoid_unrounded(x: torch.Tensor) -> torch.Tensor:
    """:func:`sigmoid_bf16` of bf16 ``x`` without its last rounding: the
    exponential and the sum rounded to bf16, the quotient f32."""
    return 1.0 / (1.0 + torch.exp(-x)).float()


def _dpre_operands(dp: torch.Tensor, hid: int):
    """``dpre_i`` and ``dpre_h`` ([N, 3H] each) of one step's ``dp``,
    rounded to bf16 (kept f32): the bf16 products' operands."""
    dpi = dp[:, :3 * hid]
    dph = torch.cat([dp[:, :2 * hid], dp[:, 3 * hid:]], dim=1)
    return round_bf16(dpi), round_bf16(dph)


def step_weight_grad_reference(h0: torch.Tensor, hist: torch.Tensor,
                               x: torch.Tensor, dp: torch.Tensor,
                               dmsg: torch.Tensor, n_steps: int,
                               mdt: Optional[torch.dtype] = None):
    """Plain version of ``step_weight_grad_kernel``: the packed weight
    gradients ``(dek, deb, dwi, dbi, dwh, dbh)`` of ``n_steps`` steps from
    their per-row cotangents (``x``, ``dp``, ``dmsg`` stacked by step;
    step s's input is ``h0`` for s = 0 and ``hist[s-1]`` after), each
    step's sums added into the totals from step K-1 down to 0 (the scan
    VJP's order). Biases are ``[1, n]`` rows, all f32.

    bf16 ``h0`` (and ``hist``, ``x``; ``dp``, ``dmsg`` f32): the plain
    version of ``step_weight_grad_kernel_bf16``, as the reference's
    ``_bwd_kernel`` accumulates at bf16: ``dpre_i``/``dpre_h`` rounded to
    bf16 for ``dW_i = x^T dpre_i`` and ``dW_h = h^T dpre_h``, ``dmsg``
    rounded to the message dtype ``mdt`` (default ``h0``'s; f32 for f32
    band values) for ``dW_e = h^T dmsg``; f32 sums; the bias gradients
    sum the unrounded f32 cotangents."""
    hid = h0.shape[1]
    bf16 = h0.dtype == torch.bfloat16
    round_msg = bf16 and (mdt or h0.dtype) == torch.bfloat16
    totals = None
    for s in reversed(range(n_steps)):
        hs = (h0 if s == 0 else hist[s - 1]).float()
        dpi = dp[s][:, :3 * hid]
        dph = torch.cat([dp[s][:, :2 * hid], dp[s][:, 3 * hid:]], dim=1)
        dpi_c, dph_c = _dpre_operands(dp[s], hid) if bf16 else (dpi, dph)
        dmsg_c = round_bf16(dmsg[s]) if round_msg else dmsg[s]
        step = (hs.T @ dmsg_c, dmsg[s].sum(0, keepdim=True),
                x[s].float().T @ dpi_c, dpi.sum(0, keepdim=True),
                hs.T @ dph_c, dph.sum(0, keepdim=True))
        totals = step if totals is None else tuple(
            t + u for t, u in zip(totals, step))
    return totals


def fused_step_backward_reference(params: Optional[Mapping],
                                  h: torch.Tensor, adj: BandAdjacency,
                                  g: torch.Tensor,
                                  packed: Optional[Sequence[torch.Tensor]]
                                  = None):
    """The step VJP in plain torch: ``(dh, dek, deb, dwi, dbi, dwh, dbh)``,
    the gradients in the packed layout of :func:`packed_weights`, f32 at
    either dtype (the reference's ``_unpack_grads``: never rounded to the
    step's dtype)."""
    dh, x, dp, dmsg = fused_step_bwd_rows_reference(params, h, adj, g,
                                                    packed)
    return (dh, *step_weight_grad_reference(h, None, x[None], dp[None],
                                            dmsg[None], 1,
                                            msg_dtype(adj, h.dtype)))


def persistent_hist_reference(params: Optional[Mapping], h: torch.Tensor,
                              adj: BandAdjacency, n_steps: int,
                              packed: Optional[Sequence[torch.Tensor]] = None
                              ) -> torch.Tensor:
    """Plain version of ``persistent_fwd_hist_kernel`` (bf16 ``h``: of
    ``persistent_fwd_hist_kernel_bf16``): ``h_1..h_{K-1}`` of ``n_steps =
    K`` steps, stacked ``[K-1, N, H]``, in ``h``'s dtype. ``packed``: the
    steps from packed weights (:func:`_plain_step`; at bf16 the f32
    masters, rounded inside)."""
    hs = []
    for _ in range(n_steps - 1):
        h = _plain_step(params, h, adj, packed)
        hs.append(h)
    if not hs:
        return h.new_zeros((0,) + tuple(h.shape))
    return torch.stack(hs)


def persistent_bwd_rows_reference(params: Optional[Mapping],
                                  h0: torch.Tensor, hist: torch.Tensor,
                                  adj: BandAdjacency, g: torch.Tensor,
                                  n_steps: int,
                                  packed: Optional[Sequence[torch.Tensor]]
                                  = None):
    """Plain version of ``persistent_bwd_kernel`` (bf16 ``h0``, ``hist``
    and ``g``: of ``persistent_bwd_kernel_bf16``): the reverse loop of
    :func:`fused_step_bwd_rows_reference` over steps K-1..0. Returns
    ``(dh_0, x, dp, dmsg)`` with the per-row cotangents stacked by step
    (at bf16 ``dh_0`` and ``x`` bf16, ``dp`` and ``dmsg`` f32)."""
    xs, dps, dmsgs = [None] * n_steps, [None] * n_steps, [None] * n_steps
    for s in reversed(range(n_steps)):
        hs = h0 if s == 0 else hist[s - 1]
        g, xs[s], dps[s], dmsgs[s] = fused_step_bwd_rows_reference(
            params, hs, adj, g, packed)
    return g, torch.stack(xs), torch.stack(dps), torch.stack(dmsgs)


def persistent_backward_reference(params: Optional[Mapping],
                                  h0: torch.Tensor, adj: BandAdjacency,
                                  g: torch.Tensor, n_steps: int,
                                  packed: Optional[Sequence[torch.Tensor]]
                                  = None):
    """The K-step VJP in plain torch: the hist, the reverse loop of the
    step VJP, each step's weight gradients folded into the totals in
    descending step order. ``(dh_0, dek, deb, dwi, dbi, dwh, dbh)``, the
    weight gradients f32 at either dtype. At bf16 the scan of
    :func:`fused_step_backward_reference` bit for bit, as the reference's
    persistent VJP is the scan of its step VJP."""
    hist = persistent_hist_reference(params, h0, adj, n_steps, packed)
    dh, x, dp, dmsg = persistent_bwd_rows_reference(params, h0, hist, adj, g,
                                                    n_steps, packed)
    return (dh, *step_weight_grad_reference(h0, hist, x, dp, dmsg, n_steps,
                                            msg_dtype(adj, h0.dtype)))


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
    """``fused_step_kernel``, or for bf16 ``h`` ``fused_step_kernel_bf16``
    (the weights' prep and two passes, one count), whose messages cross
    device memory at the message dtype (a tile's halo belongs to other
    blocks)."""
    if h.dtype == torch.bfloat16:
        out = _bf16_fwd_launch(h, adj, packed, 1, "fused_step_kernel_bf16")
        count_launch(fused_gate_step, "launches_bf16")
        return out
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
    count_launch(fused_gate_step)
    return out


def _bf16_fwd_launch(h: torch.Tensor, adj: BandAdjacency,
                     packed: Sequence[torch.Tensor], n_steps: int,
                     name: str) -> torch.Tensor:
    """One call of a bf16 forward instance (``name``:
    ``fused_step_kernel_bf16``, one step; ``persistent_fwd_kernel_bf16``,
    ``n_steps`` steps, h_K; ``persistent_fwd_hist_kernel_bf16``,
    ``n_steps - 1`` steps, their states ``[K-1, N, H]``), its weights'
    prep first: the packed weights go in as they are (the f32 masters, or
    bf16 ones), and the kernel rounds, lays out and transposes them once
    a call. Counts nothing: the callers count."""
    if any(w.device != h.device for w in packed):
        raise ValueError(f"step weights must be on {h.device}, as h")
    dt = (packed[0].dtype if all(w.dtype == packed[0].dtype for w in packed)
          else torch.float32)
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the bf16 step's weights must be f32 or bf16, got "
                         f"{dt}")
    from deepdfa_tpu_torch.ops import _build

    n, hidden = h.shape
    with torch.cuda.device(h.device):
        lib = _build.load("fused_gnn")
        weights = [w.detach().to(dt).contiguous() for w in packed]
        stream = ctypes.c_void_p(
            torch.cuda.current_stream(h.device).cuda_stream)
        ws = torch.empty(14 * hidden * hidden, dtype=torch.bfloat16,
                         device=h.device)
        fs = torch.empty(14 * hidden, dtype=torch.float32, device=h.device)
        common = (_ptr(h), _ptr(adj.vals),
                  int(adj.vals.dtype == torch.bfloat16),
                  *map(_ptr, weights), int(dt == torch.bfloat16), _ptr(ws),
                  _ptr(fs))
        if name == "fused_step_kernel_bf16":
            msg = torch.empty((n, hidden),
                              dtype=msg_dtype(adj, torch.bfloat16),
                              device=h.device)
            out = torch.empty_like(h)
            err = lib.fused_step_bf16_launch(
                *common, _ptr(msg), _ptr(out), n, hidden, adj.tile,
                adj.n_tiles, adj.bandwidth, stream)
        else:
            hist = name == "persistent_fwd_hist_kernel_bf16"
            groups = _row_groups(adj, h)
            out = (torch.empty((n_steps - 1, n, hidden), dtype=h.dtype,
                               device=h.device) if hist
                   else torch.empty_like(h))
            err = lib.persistent_fwd_bf16_launch(
                *common, _ptr(groups), groups.numel() - 1,
                adj.max_group_rows, n_steps - hist, 1, int(hist), _ptr(out),
                hidden, adj.tile, adj.n_tiles, adj.bandwidth, stream)
        _raise_on_error(err, name)
    return out


def _persistent_launch(h: torch.Tensor, adj: BandAdjacency,
                       packed: Sequence[torch.Tensor], n_steps: int,
                       hist: bool = False) -> torch.Tensor:
    """``persistent_fwd_kernel`` (h_K; ``persistent_fwd_kernel_bf16`` for
    bf16 ``h``), or with ``hist`` its emit-hist instance
    (``persistent_fwd_hist_kernel``, ``persistent_fwd_hist_kernel_bf16``)
    running ``n_steps - 1`` steps (``[K-1, N, H]``)."""
    if h.dtype == torch.bfloat16:
        return _bf16_fwd_launch(
            h, adj, packed, n_steps,
            "persistent_fwd_hist_kernel_bf16" if hist
            else "persistent_fwd_kernel_bf16")
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


def _fused_step_run(h: torch.Tensor, adj: BandAdjacency,
                    packed: Sequence[torch.Tensor]) -> torch.Tensor:
    """One step on packed weights: the kernel for a CUDA ``h``; for a CPU
    one (bf16 only: :class:`_FusedStep` on the CPU) its plain version."""
    if h.device.type == "cpu":
        return _step_bf16(packed, h, adj)
    return _fused_step_launch(h, adj, packed)


class _FusedStep(torch.autograd.Function):
    """``fused_step_kernel`` forward, ``fused_step_bwd_kernel`` and
    ``step_weight_grad_kernel`` backward; at bf16 ``h`` their bf16
    instances. Differentiable in ``h`` and the six packed weights; saves
    only those and the adjacency. At bf16 the packed weights are the f32
    masters, rounded to bf16 inside the forward and the backward, so
    their f32 gradients reach the masters unrounded, as the reference's
    custom VJP returns them (``_unpack_grads``): autograd casts a
    gradient to its input's dtype, and bf16 inputs would round them. On
    the CPU (bf16 only) the plain versions run in the kernels' place, so
    the CPU model follows the kernels' VJP and not autograd of the
    forward, which rounds at other points."""

    @staticmethod
    def forward(ctx, adj, h, *packed):
        ctx.adj = adj
        ctx.save_for_backward(h, *packed)
        return _fused_step_run(h, adj, packed)

    @staticmethod
    def backward(ctx, g):
        h, *packed = ctx.saved_tensors
        dh, *dw = fused_step_backward(None, h, ctx.adj, g.contiguous(),
                                      packed=packed)
        return (None, dh, *dw)


def _persistent_run(h: torch.Tensor, adj: BandAdjacency,
                    packed: Sequence[torch.Tensor],
                    n_steps: int) -> torch.Tensor:
    """``n_steps`` steps on packed weights: the kernel for a CUDA ``h``;
    for a CPU one (bf16 only) the plain version, :func:`_step_bf16`
    ``n_steps`` times."""
    if h.device.type == "cpu":
        for _ in range(n_steps):
            h = _step_bf16(packed, h, adj)
        return h
    return _persistent_unroll_launch(h, adj, packed, n_steps)


class _PersistentUnroll(torch.autograd.Function):
    """``persistent_fwd_kernel`` forward; backward
    ``persistent_fwd_hist_kernel``, ``persistent_bwd_kernel`` and
    ``step_weight_grad_kernel``; at bf16 ``h`` their bf16 instances.
    Saves only ``h_0``, the packed weights and the adjacency. At bf16 the
    packed weights are the f32 masters, rounded inside, so their f32
    gradients reach the masters unrounded (as :class:`_FusedStep`'s). On
    the CPU (bf16 only) the plain versions run in the kernels' place: the
    K-step VJP in plain torch, the scan of :class:`_FusedStep`'s."""

    @staticmethod
    def forward(ctx, adj, n_steps, h, *packed):
        ctx.adj, ctx.n_steps = adj, n_steps
        ctx.save_for_backward(h, *packed)
        return _persistent_run(h, adj, packed, n_steps)

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

    CPU tensors: :func:`fused_step_reference` at f32 (autograd
    differentiates it); at bf16 its plain version, through
    :class:`_FusedStep` when a gradient is needed (the kernels' VJP in
    plain torch). CUDA tensors: ``fused_step_kernel`` (f32 h and weights,
    bf16 or f32 band values) or, for bf16 ``h``,
    ``fused_step_kernel_bf16``, through :class:`_FusedStep` when a
    gradient is needed, or an exception. ``packed``:
    :func:`packed_weights` of ``params``, when the caller packs once for
    several steps: f32, or at bf16 ``h`` the f32 masters (rounded inside;
    their gradients stay f32) or bf16 ones.
    """
    bf16 = h.dtype == torch.bfloat16
    if h.device.type == "cpu" and not bf16:
        return fused_step_reference(params, h, adj)
    if h.device.type != "cpu":
        _check_cuda_inputs(h, adj)
    packed = _packed(params, packed)
    if needs_grad(h, packed):
        return _FusedStep.apply(adj, h, *packed)
    return _fused_step_run(h, adj, packed)


fused_gate_step.launches = fused_gate_step.launches_bf16 = 0


def _persistent_unroll_launch(h: torch.Tensor, adj: BandAdjacency,
                              packed: Sequence[torch.Tensor],
                              n_steps: int) -> torch.Tensor:
    out = _persistent_launch(h, adj, packed, n_steps)
    if h.dtype == torch.bfloat16:
        count_launch(persistent_unroll, "launches_bf16")
    else:
        count_launch(persistent_unroll)
    return out


def persistent_unroll(params: Optional[Mapping], h: torch.Tensor,
                      adj: BandAdjacency, n_steps: int,
                      packed: Optional[Sequence[torch.Tensor]] = None
                      ) -> torch.Tensor:
    """``n_steps`` shared-weight gated steps.

    CPU tensors: :func:`persistent_reference` at f32 (autograd
    differentiates it); at bf16 its plain version, through
    :class:`_PersistentUnroll` when a gradient is needed (the kernels'
    K-step VJP in plain torch). CUDA tensors: one
    ``persistent_fwd_kernel`` launch (``persistent_fwd_kernel_bf16`` for
    bf16 ``h``), through :class:`_PersistentUnroll` when a gradient is
    needed. The adjacency's closed row groups must pass
    :func:`persistent_smem_ok`, and :func:`persistent_bwd_smem_ok` when a
    gradient is needed (each at ``h``'s dtype) — callers check the gate
    and run :func:`fused_gate_step` per step when it fails (the model
    does); here a failed gate raises. ``packed`` as in
    :func:`fused_gate_step`.
    """
    if n_steps < 1:
        raise ValueError(f"persistent_unroll needs n_steps >= 1, "
                         f"got {n_steps}")
    bf16 = h.dtype == torch.bfloat16
    if h.device.type == "cpu" and not bf16:
        return persistent_reference(params, h, adj, n_steps)
    if h.device.type != "cpu":
        _check_cuda_inputs(h, adj)
    packed = _packed(params, packed)
    grad = needs_grad(h, packed)
    if h.device.type == "cpu":
        if grad:
            return _PersistentUnroll.apply(adj, n_steps, h, *packed)
        return _persistent_run(h, adj, packed, n_steps)
    hidden = h.shape[1]
    if not persistent_smem_ok(adj, hidden, h.dtype) or (
            grad and not persistent_bwd_smem_ok(adj, hidden, h.dtype)):
        need = (persistent_bwd_smem_bytes(adj, hidden, h.dtype) if grad
                else persistent_smem_bytes(adj, hidden, 1, h.dtype))
        raise ValueError(
            f"row groups need {need} B of shared memory > "
            f"{PERSISTENT_SMEM_BUDGET_BYTES} (or the band has no row "
            "groups): dispatch per step through fused_gate_step")
    if grad:
        return _PersistentUnroll.apply(adj, n_steps, h, *packed)
    return _persistent_unroll_launch(h, adj, packed, n_steps)


persistent_unroll.launches = persistent_unroll.launches_bf16 = 0


def fused_step_bwd_rows(params: Optional[Mapping], h: torch.Tensor,
                        adj: BandAdjacency, g: torch.Tensor,
                        packed: Optional[Sequence[torch.Tensor]] = None):
    """One step's backward down to ``(dh, x, dp, dmsg)`` (see
    :func:`fused_step_bwd_rows_reference`). CUDA tensors:
    ``fused_step_bwd_kernel`` (two passes, one count), reading A^T from
    :meth:`BandAdjacency.transpose_vals`; for bf16 ``h`` and ``g``
    ``fused_step_bwd_kernel_bf16`` (three passes, one count, its products
    on the bf16 tensor cores): ``dh`` and ``x`` bf16, ``dp`` and ``dmsg``
    f32."""
    if h.device.type == "cpu":
        return fused_step_bwd_rows_reference(params, h, adj, g, packed)
    _check_cuda_inputs(h, adj)
    g = _check_like(g, h, "the output cotangent")
    tv = adj.transpose_vals()
    bf16_h = h.dtype == torch.bfloat16
    with torch.cuda.device(h.device):
        lib, weights, bf16, stream = _launch_args(
            params, h, adj, packed, "fused_gnn_bwd")
        ek, eb, wi, bi, wh, bh = weights
        wiT, whT, ekT = _transposed(weights)
        n, hidden = h.shape
        f32 = dict(dtype=torch.float32, device=h.device)
        x, dh = torch.empty_like(h), torch.empty_like(h)
        dhl, dmsg = (torch.empty((n, hidden), **f32) for _ in range(2))
        dp = torch.empty((n, 4 * hidden), **f32)
        common = (_ptr(g), _ptr(ek), _ptr(eb), _ptr(wi), _ptr(bi), _ptr(wh),
                  _ptr(bh), _ptr(wiT), _ptr(whT), _ptr(ekT))
        if bf16_h:
            # The messages and dx cross device memory at the message
            # dtype (a tile's halo belongs to other blocks).
            mdt = dict(dtype=msg_dtype(adj, torch.bfloat16), device=h.device)
            msg, dx = (torch.empty((n, hidden), **mdt) for _ in range(2))
            err = lib.fused_step_bwd_bf16_launch(
                _ptr(h), _ptr(adj.vals), _ptr(tv), bf16, *common, _ptr(msg),
                _ptr(x), _ptr(dp), _ptr(dx), _ptr(dhl), _ptr(dmsg), _ptr(dh),
                n, hidden, adj.tile, adj.n_tiles, adj.bandwidth, stream)
            _raise_on_error(err, "fused_step_bwd_kernel_bf16")
        else:
            dx = torch.empty((n, hidden), **f32)
            err = lib.fused_step_bwd_launch(
                _ptr(h), _ptr(adj.vals), _ptr(tv), bf16, *common, _ptr(x),
                _ptr(dp), _ptr(dx), _ptr(dhl), _ptr(dmsg), _ptr(dh), n,
                hidden, adj.tile, adj.n_tiles, adj.bandwidth, stream)
            _raise_on_error(err, "fused_step_bwd_kernel")
    if bf16_h:
        count_launch(fused_step_bwd_rows, "launches_bf16")
    else:
        count_launch(fused_step_bwd_rows)
    return dh, x, dp, dmsg


fused_step_bwd_rows.launches = fused_step_bwd_rows.launches_bf16 = 0


def step_weight_grads(h0: torch.Tensor, hist: Optional[torch.Tensor],
                      x: torch.Tensor, dp: torch.Tensor, dmsg: torch.Tensor,
                      n_steps: int, mdt: Optional[torch.dtype] = None):
    """The packed weight gradients ``(dek, deb, dwi, dbi, dwh, dbh)`` of
    ``n_steps`` steps (see :func:`step_weight_grad_reference`), f32. CUDA
    tensors: ``step_weight_grad_kernel``; for bf16 ``h0`` (``hist`` and
    ``x`` bf16, ``dp`` and ``dmsg`` f32) ``step_weight_grad_kernel_bf16``,
    which rounds ``dp``, and ``dmsg`` when the message dtype ``mdt`` is
    bf16, to its product operands on load (f32 messages: splits ``dmsg``
    three ways), on the splits of :func:`wgrad_bf16_rows_per_split`."""
    if h0.device.type == "cpu":
        return step_weight_grad_reference(h0, hist, x, dp, dmsg, n_steps, mdt)
    if not h0.is_cuda:
        raise ValueError(f"the gated-step kernels take CPU tensors (plain "
                         f"version) or CUDA tensors, got {h0.device}")
    n, hidden = h0.shape
    rows = h0.dtype  # h0, hist and x: f32, or bf16 for the bf16 instance
    if rows not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(f"step_weight_grad_kernel takes f32 or "
                                  f"bf16 rows, got {rows}")
    want = {"x": (x, (n_steps, n, hidden), rows),
            "dp": (dp, (n_steps, n, 4 * hidden), torch.float32),
            "dmsg": (dmsg, (n_steps, n, hidden), torch.float32)}
    if n_steps > 1:
        want["hist"] = (hist, (n_steps - 1, n, hidden), rows)
    for name, (t, shape, dtype) in want.items():
        if (tuple(t.shape) != shape or t.dtype != dtype
                or t.device != h0.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous {dtype} {shape} on "
                             f"{h0.device}")
    if not h0.is_contiguous():
        raise ValueError("h0 must be contiguous")
    from deepdfa_tpu_torch.ops import _build

    bf16 = rows == torch.bfloat16
    with torch.cuda.device(h0.device):
        lib = _build.load("fused_gnn_bwd")
        f32 = dict(dtype=torch.float32, device=h0.device)
        dek = torch.empty((hidden, hidden), **f32)
        dwi = torch.empty((hidden, 3 * hidden), **f32)
        dwh = torch.empty((hidden, 3 * hidden), **f32)
        deb = torch.empty((1, hidden), **f32)
        dbi = torch.empty((1, 3 * hidden), **f32)
        dbh = torch.empty((1, 3 * hidden), **f32)
        rows_per_split = (wgrad_bf16_rows_per_split if bf16
                          else wgrad_rows_per_split)(n, hidden)
        splits = -(-n // rows_per_split)
        partial = torch.empty(
            splits * n_steps * (7 * hidden * hidden + 7 * hidden), **f32)
        stream = ctypes.c_void_p(
            torch.cuda.current_stream(h0.device).cuda_stream)
        args = (_ptr(h0), ctypes.c_void_p(hist.data_ptr() if n_steps > 1
                                          else 0),
                _ptr(x), _ptr(dp), _ptr(dmsg))
        tail = (n, hidden, n_steps, rows_per_split, _ptr(partial), _ptr(dek),
                _ptr(deb), _ptr(dwi), _ptr(dbi), _ptr(dwh), _ptr(dbh), stream)
        if bf16:
            round_msg = int((mdt or rows) == torch.bfloat16)
            err = lib.step_weight_grad_bf16_launch(*args, round_msg, *tail)
            _raise_on_error(err, "step_weight_grad_kernel_bf16")
        else:
            err = lib.step_weight_grad_launch(*args, *tail)
            _raise_on_error(err, "step_weight_grad_kernel")
    if bf16:
        count_launch(step_weight_grads, "launches_bf16")
    else:
        count_launch(step_weight_grads)
    return dek, deb, dwi, dbi, dwh, dbh


step_weight_grads.launches = step_weight_grads.launches_bf16 = 0


def wgrad_bf16_geometry(round_msg: bool) -> Dict[str, int]:
    """The ``step_weight_grad_kernel_bf16`` instance a launch with
    ``round_msg`` runs, as the library built for the current card has it:
    ``blocks_per_sm`` (the occupancy query), ``smem_bytes`` (held to
    :func:`wgrad_bf16_smem_bytes`), ``slab_rows`` and ``stages``."""
    from deepdfa_tpu_torch.ops import _build

    outs = [ctypes.c_int(0) for _ in range(4)]
    err = _build.load("fused_gnn_bwd").step_weight_grad_bf16_geometry(
        int(round_msg), *(ctypes.byref(o) for o in outs))
    _raise_on_error(err, "step_weight_grad_bf16_geometry")
    return dict(zip(("blocks_per_sm", "smem_bytes", "slab_rows", "stages"),
                    (o.value for o in outs)))


def fused_step_backward(params: Optional[Mapping], h: torch.Tensor,
                        adj: BandAdjacency, g: torch.Tensor,
                        packed: Optional[Sequence[torch.Tensor]] = None):
    """The step VJP ``(dh, dek, deb, dwi, dbi, dwh, dbh)``: CPU tensors
    :func:`fused_step_backward_reference`; CUDA tensors
    ``fused_step_bwd_kernel`` then ``step_weight_grad_kernel`` (bf16
    ``h``: their bf16 instances). The weight gradients are f32."""
    if h.device.type == "cpu":
        return fused_step_backward_reference(params, h, adj, g, packed)
    dh, x, dp, dmsg = fused_step_bwd_rows(params, h, adj, g, packed)
    return (dh, *step_weight_grads(h.contiguous(), None, x[None], dp[None],
                                   dmsg[None], 1, msg_dtype(adj, h.dtype)))


def persistent_hist(params: Optional[Mapping], h: torch.Tensor,
                    adj: BandAdjacency, n_steps: int,
                    packed: Optional[Sequence[torch.Tensor]] = None
                    ) -> torch.Tensor:
    """``h_1..h_{K-1}`` of ``n_steps = K`` steps, ``[K-1, N, H]``. CUDA
    tensors: ``persistent_fwd_hist_kernel``, for bf16 ``h``
    ``persistent_fwd_hist_kernel_bf16`` (nothing to launch for K = 1; the
    forward gate :func:`persistent_smem_ok` at ``h``'s dtype applies)."""
    if h.device.type == "cpu":
        return persistent_hist_reference(params, h, adj, n_steps, packed)
    _check_cuda_inputs(h, adj)
    if n_steps < 2:
        return h.new_empty((0,) + tuple(h.shape))
    if not persistent_smem_ok(adj, h.shape[1], h.dtype):
        raise ValueError("row groups over the persistent kernel's shared "
                         "memory gate")
    out = _persistent_launch(h, adj, _packed(params, packed), n_steps,
                             hist=True)
    if h.dtype == torch.bfloat16:
        count_launch(persistent_hist, "launches_bf16")
    else:
        count_launch(persistent_hist)
    return out


persistent_hist.launches = persistent_hist.launches_bf16 = 0


def persistent_bwd_rows(params: Optional[Mapping], h0: torch.Tensor,
                        hist: torch.Tensor, adj: BandAdjacency,
                        g: torch.Tensor, n_steps: int,
                        packed: Optional[Sequence[torch.Tensor]] = None):
    """The reverse sweep ``(dh_0, x, dp, dmsg)`` of ``n_steps`` steps (see
    :func:`persistent_bwd_rows_reference`). CUDA tensors: one
    ``persistent_bwd_kernel`` launch, for bf16 ``h0``, ``hist`` and ``g``
    one ``persistent_bwd_kernel_bf16`` launch (its products on the bf16
    tensor cores; ``dh_0`` and ``x`` bf16, ``dp`` and ``dmsg`` f32); each
    needs :func:`persistent_bwd_smem_ok` at its dtype (a failed gate
    raises)."""
    if h0.device.type == "cpu":
        return persistent_bwd_rows_reference(params, h0, hist, adj, g,
                                             n_steps, packed)
    _check_cuda_inputs(h0, adj)
    g = _check_like(g, h0, "the output cotangent")
    n, hidden = h0.shape
    bf16_h = h0.dtype == torch.bfloat16
    if not persistent_bwd_smem_ok(adj, hidden, h0.dtype):
        need = persistent_bwd_smem_bytes(adj, hidden, h0.dtype)
        raise ValueError(
            f"row groups need {need} B of shared memory > "
            f"{PERSISTENT_SMEM_BUDGET_BYTES} (or the band has no row "
            "groups): run fused_step_backward per step")
    if n_steps > 1 and (tuple(hist.shape) != (n_steps - 1, n, hidden)
                        or hist.dtype != h0.dtype
                        or not hist.is_contiguous()):
        raise ValueError(f"hist must be contiguous {h0.dtype} "
                         f"[{n_steps - 1}, {n}, {hidden}]")
    groups = _row_groups(adj, h0)
    tv = adj.transpose_vals()
    with torch.cuda.device(h0.device):
        lib, weights, bf16, stream = _launch_args(
            params, h0, adj, packed, "fused_gnn_bwd")
        ek, eb, wi, bi, wh, bh = weights
        wiT, whT, ekT = _transposed(weights)
        f32 = dict(dtype=torch.float32, device=h0.device)
        # x at the rows' dtype (the weight pass reads bf16 x at bf16).
        x = torch.empty((n_steps, n, hidden), dtype=h0.dtype,
                        device=h0.device)
        dmsg = torch.empty((n_steps, n, hidden), **f32)
        dp = torch.empty((n_steps, n, 4 * hidden), **f32)
        dh = torch.empty_like(h0)
        hist_ptr = ctypes.c_void_p(hist.data_ptr() if n_steps > 1 else 0)
        fn, name = ((lib.persistent_bwd_bf16_launch,
                     "persistent_bwd_kernel_bf16") if bf16_h else
                    (lib.persistent_bwd_launch, "persistent_bwd_kernel"))
        err = fn(
            _ptr(h0), hist_ptr, _ptr(adj.vals), _ptr(tv), bf16, _ptr(g),
            _ptr(ek), _ptr(eb), _ptr(wi), _ptr(bi), _ptr(wh), _ptr(bh),
            _ptr(wiT), _ptr(whT), _ptr(ekT), _ptr(groups),
            groups.numel() - 1, adj.max_group_rows, n_steps, _ptr(x),
            _ptr(dp), _ptr(dmsg), _ptr(dh), hidden, adj.tile, adj.n_tiles,
            adj.bandwidth, stream)
        _raise_on_error(err, name)
    if bf16_h:
        count_launch(persistent_bwd_rows, "launches_bf16")
    else:
        count_launch(persistent_bwd_rows)
    return dh, x, dp, dmsg


persistent_bwd_rows.launches = persistent_bwd_rows.launches_bf16 = 0


def persistent_backward(params: Optional[Mapping], h0: torch.Tensor,
                        adj: BandAdjacency, g: torch.Tensor, n_steps: int,
                        packed: Optional[Sequence[torch.Tensor]] = None):
    """The K-step VJP ``(dh_0, dek, deb, dwi, dbi, dwh, dbh)``: CPU tensors
    :func:`persistent_backward_reference`; CUDA tensors the recompute
    sweep, the reverse sweep and the weight gradients, three launches
    (bf16 ``h0``: their bf16 instances, the weight pass at the band's
    message dtype). The weight gradients are f32."""
    if h0.device.type == "cpu":
        return persistent_backward_reference(params, h0, adj, g, n_steps,
                                             packed)
    packed = _packed(params, packed)
    hist = persistent_hist(None, h0, adj, n_steps, packed=packed)
    dh, x, dp, dmsg = persistent_bwd_rows(None, h0, hist, adj, g, n_steps,
                                          packed=packed)
    return (dh, *step_weight_grads(h0.contiguous(), hist, x, dp, dmsg,
                                   n_steps, msg_dtype(adj, h0.dtype)))


#: Kernel (instance) name -> (wrapper, the attribute counting it).
_COUNTED = {
    "fused_step_kernel": (fused_gate_step, "launches"),
    "persistent_fwd_kernel": (persistent_unroll, "launches"),
    "fused_step_bwd_kernel": (fused_step_bwd_rows, "launches"),
    "persistent_fwd_hist_kernel": (persistent_hist, "launches"),
    "persistent_bwd_kernel": (persistent_bwd_rows, "launches"),
    "step_weight_grad_kernel": (step_weight_grads, "launches"),
    "fused_step_kernel_bf16": (fused_gate_step, "launches_bf16"),
    "persistent_fwd_kernel_bf16": (persistent_unroll, "launches_bf16"),
    "fused_step_bwd_kernel_bf16": (fused_step_bwd_rows, "launches_bf16"),
    "step_weight_grad_kernel_bf16": (step_weight_grads, "launches_bf16"),
    "persistent_fwd_hist_kernel_bf16": (persistent_hist, "launches_bf16"),
    "persistent_bwd_kernel_bf16": (persistent_bwd_rows, "launches_bf16"),
}


def launch_counts() -> Dict[str, int]:
    """Kernel name -> launches so far."""
    return {name: getattr(fn, attr) for name, (fn, attr) in _COUNTED.items()}


def reset_launch_counts() -> None:
    for fn, attr in _COUNTED.values():
        setattr(fn, attr, 0)


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


def _rated(parts, nbytes: float, nnz: int) -> Dict[str, float]:
    """A cost of operations done at several peak rates: ``parts`` is
    ``[(operations, (name, rate)), ...]``; ``peak_flops`` is the one rate
    that gives the sum of the parts' times; ``flops_bf16`` the operations
    at the bf16 tensor-core rate."""
    flops = sum(f for f, _ in parts)
    seconds = sum(f / peak[1] for f, peak in parts)
    names = []
    for _, peak in parts:
        if peak[0] not in names:
            names.append(peak[0])
    what = {PEAK_BF16[0]: "bf16 x bf16 products",
            PEAK_BF16X3[0]: "the products of f32 dmsg, split three ways"}
    return {
        "flops": flops,
        "flops_bf16": sum(f for f, peak in parts if peak == PEAK_BF16),
        "bytes": nbytes,
        "peak": ", ".join(f"{n} ({what.get(n, 'the rest')})" for n in names),
        "peak_flops": flops / seconds,
        "nnz": nnz,
    }


def _bf16_step_cost(adj: BandAdjacency, hidden: int, n_steps: int,
                    kernel: str, nnz: int) -> Dict[str, float]:
    """:func:`kernel_cost` of a bf16 instance: ``h``, ``g``, ``dh`` and
    ``x`` and the packed weights at 2 bytes, the band as stored, ``dp``
    and ``dmsg`` f32. The products of two bf16 values at the dense bf16
    tensor-core rate, the rate of the bf16 ``mma.sync`` every instance
    runs its dense products on (the forward's h W_e, x W_i, h W_h, and A
    msg when the band values are bf16, which the kernels aggregate with
    f32 FMAs; the forward's near-midpoint chains recompute about 1.5 % of
    its sums, work the function does not need and the cost leaves out;
    the backward's dpre_i W_i^T, dpre_h W_h^T,
    and A^T dx and dmsg W_e^T when the messages are bf16; the weight
    pass's x^T dpre_i, h^T dpre_h, and h^T dmsg when the messages are
    bf16), the rest at its own rate: the backward's dmsg W_e^T with f32
    messages at the bf16 rate over three (``PEAK_BF16X3``: dmsg split into
    three bf16 parts, as the kernels run it); the other f32-message terms
    and ~20 elementwise operations a gate element forward, ~30 backward
    (the reference's bf16 gate, op for op), at the f32 SIMT rate; the
    weight pass's h^T dmsg with f32 messages at ``PEAK_BF16X3`` (dmsg split
    three ways, as the kernel runs it) and its bias sums at the f32 SIMT
    rate."""
    n = adj.n_tiles * adj.tile
    plane = 2.0 * n * hidden  # a bf16 [N, H] array
    band = float(adj.vals.numel() * adj.vals.element_size())
    weights = (7.0 * hidden * hidden + 7.0 * hidden) * 2
    sparse = 2.0 * nnz * hidden
    edge = 2.0 * n * hidden * hidden  # [N, H] x [H, H]
    gate = 2.0 * 2.0 * n * hidden * 3 * hidden  # two [N, H] x [H, 3H]
    bf16_msg = adj.vals.dtype == torch.bfloat16
    msg_rate = PEAK_BF16 if bf16_msg else PEAK_F32_SIMT
    fwd = [(edge + gate, PEAK_BF16), (sparse, msg_rate),
           (20.0 * n * hidden, PEAK_F32_SIMT)]
    # The backward's dmsg_c W_e^T: with f32 messages dmsg is split into
    # three bf16 parts (three exact bf16 products, PEAK_BF16X3).
    if kernel in ("fused_step_kernel_bf16", "persistent_fwd_kernel_bf16"):
        launches = n_steps if kernel == "fused_step_kernel_bf16" else 1
        return _rated([(n_steps * f, r) for f, r in fwd],
                      2 * plane * launches + (band + weights) * launches,
                      nnz)
    if kernel == "persistent_fwd_hist_kernel_bf16":
        # K - 1 steps: h_0 in, K - 1 planes of hist out.
        return _rated([((n_steps - 1) * f, r) for f, r in fwd],
                      n_steps * plane + band + weights, nnz)
    bwd = fwd + [(gate, PEAK_BF16), (sparse, msg_rate),
                 (edge, PEAK_BF16 if bf16_msg else PEAK_BF16X3),
                 (30.0 * n * hidden, PEAK_F32_SIMT)]
    # A and A^T; the weights and their transposes.
    fixed = 2 * band + weights + 7.0 * hidden * hidden * 2
    if kernel == "fused_step_bwd_kernel_bf16":
        # h, g in; dh, x out (bf16); dp (4H) and dmsg out (f32).
        return _rated(bwd, 4 * plane + 5 * 2 * plane + fixed, nnz)
    if kernel == "persistent_bwd_kernel_bf16":
        # h_0, the K - 1 hist planes and g in, dh out (bf16); each step's
        # x (bf16), dp and dmsg (f32) out.
        return _rated([(n_steps * f, r) for f, r in bwd],
                      (n_steps + 2) * plane
                      + n_steps * (plane + 5 * 2 * plane) + fixed, nnz)
    # step_weight_grad_kernel_bf16: h, x (bf16), dp, dmsg (f32) in a step,
    # the f32 gradients out.
    parts = [(n_steps * 2 * 2.0 * n * hidden * 3 * hidden, PEAK_BF16),
             (n_steps * edge, PEAK_BF16 if bf16_msg else PEAK_BF16X3),
             (n_steps * 7.0 * n * hidden, PEAK_F32_SIMT)]
    nbytes = (n_steps * (2 * plane + 5 * 2 * plane)
              + (7.0 * hidden * hidden + 7.0 * hidden) * 4)
    return _rated(parts, nbytes, nnz)


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

    - ``fused_step_kernel_bf16``/``persistent_fwd_kernel_bf16``,
      ``persistent_fwd_hist_kernel_bf16``, ``fused_step_bwd_kernel_bf16``,
      ``persistent_bwd_kernel_bf16``, ``step_weight_grad_kernel_bf16``:
      as their f32 kernels, at bf16 (:func:`_bf16_step_cost`: 2 bytes a
      bf16 element, the products of two bf16 values at the bf16 rate and
      the rest at its own, ``flops_bf16``).

    ``peak_flops``/``peak``: the rate the operations bound divides by:
    the f32 work of 3xTF32 products on the tensor cores for
    ``step_weight_grad_kernel``, f32 FMAs on the CUDA cores for the
    other f32 kernels. Also ``bwd_flops``/``bwd_bytes``: the
    whole ``n_steps``-step VJP, as
    the reference's ``fused_step_cost`` counts its ``bwd_*``, with only
    its compulsory traffic (h_0 and g in, dh_0 out, A and A^T, the
    weights in and the f32 gradients out).
    """
    n = adj.n_tiles * adj.tile
    nnz = int(torch.count_nonzero(adj.vals))
    if kernel.endswith("_bf16"):
        if kernel not in KERNELS:
            raise ValueError(f"unknown kernel {kernel!r}; one of {KERNELS}")
        return _bf16_step_cost(adj, hidden, n_steps, kernel, nnz)
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
