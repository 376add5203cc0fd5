"""The fused FlowGNN gated step (port of ``deepdfa_tpu/ops/fused_gnn.py``,
forward only).

Two hand-written CUDA kernels (``csrc/fused_gnn.cu``, whose header note
says what bounds them and how they are laid out) and their plain
PyTorch versions:

- :func:`fused_gate_step` launches ``fused_step_kernel`` — one step
  ``h' = GRU(A @ (h W_e + b_e), h)``; it replaces the TPU kernel
  ``_fwd_kernel``. Plain version: :func:`fused_step_reference`, the
  reference's ``fused_reference`` op for op.
- :func:`persistent_unroll` launches ``persistent_fwd_kernel`` — all
  ``n_steps`` shared-weight steps in one launch with ``h`` in shared
  memory; it replaces ``_persist_fwd_kernel``. Plain version:
  :func:`persistent_reference`, ``n_steps`` iterations of the step.

Dispatch: a wrapper takes its plain version only for tensors on the CPU.
For a CUDA tensor it launches its kernel or raises — there is no
fallback and no switch that puts the plain version on the card. Each
wrapper counts its launches in a plain integer attribute
(``fused_gate_step.launches``, ``persistent_unroll.launches``), bumped
where the kernel is launched and nowhere else.

``params`` is the step's parameter tree in the reference's layout:
``{"edge_linear": {"kernel": [H_in, H], "bias": [H]}, "gru": {"ir",
"iz", "in": {kernel, bias}, "hr", "hz": {kernel}, "hn": {kernel,
bias}}}`` with ``[in, out]`` kernels (``x @ kernel``).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

from deepdfa_tpu_torch.ops.band_spmm import BandAdjacency, band_spmm

#: Dynamic shared memory one H100 block may opt into (227 KB). The
#: persistent kernel holds its row group's h and aggregate there.
PERSISTENT_SMEM_BUDGET_BYTES = 232_448

#: The kernels map one thread to one hidden column.
MAX_HIDDEN = 128


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


def persistent_smem_bytes(adj: BandAdjacency, hidden: int) -> int:
    """Shared memory of ``persistent_fwd_kernel``'s largest block: the
    group's resident h and aggregate (f32) plus one row sum a row."""
    return adj.max_group_rows * (2 * hidden + 1) * 4


def persistent_smem_ok(adj: BandAdjacency, hidden: int) -> bool:
    """The persistent kernel's eligibility gate (replaces the
    reference's 12 MiB VMEM budget): the adjacency carries closed row
    groups and the largest fits a block's shared memory. Over the gate
    the model runs ``fused_step_kernel`` ``n_steps`` times instead."""
    return (adj.row_groups is not None
            and persistent_smem_bytes(adj, hidden)
            <= PERSISTENT_SMEM_BUDGET_BYTES)


def _check_cuda_inputs(h: torch.Tensor, adj: BandAdjacency) -> None:
    if not h.is_cuda:
        raise ValueError(f"the gated-step kernels take CPU tensors (plain "
                         f"version) or CUDA tensors, got {h.device}")
    if h.dtype != torch.float32:
        raise NotImplementedError(
            f"the CUDA gated-step kernels take float32 h, got {h.dtype}: "
            "bf16 kernels are not ported yet")
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
                 packed: Optional[Sequence[torch.Tensor]]):
    from deepdfa_tpu_torch.ops import _build

    if packed is None:
        packed = packed_weights(params)
    weights = [w.contiguous() for w in packed]
    if any(w.device != h.device or w.dtype != torch.float32
           for w in weights):
        raise ValueError(f"step weights must be float32 on {h.device}")
    stream = ctypes.c_void_p(torch.cuda.current_stream(h.device).cuda_stream)
    bf16 = int(adj.vals.dtype == torch.bfloat16)
    return _build.load("fused_gnn"), weights, bf16, stream


def _raise_on_error(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError_t {err}")


def fused_gate_step(params: Mapping, h: torch.Tensor, adj: BandAdjacency,
                    packed: Optional[Sequence[torch.Tensor]] = None
                    ) -> torch.Tensor:
    """One gated graph step ``h' = GRU(A @ (h W_e + b_e), h)``.

    CPU tensors: :func:`fused_step_reference`. CUDA tensors:
    ``fused_step_kernel`` (f32 h and weights, bf16 or f32 band values),
    or an exception. ``packed``: :func:`packed_weights` of ``params``,
    when the caller packs once for several steps.
    """
    if h.device.type == "cpu":
        return fused_step_reference(params, h, adj)
    _check_cuda_inputs(h, adj)
    with torch.cuda.device(h.device):
        lib, (ek, eb, wi, bi, wh, bh), bf16, stream = _launch_args(
            params, h, adj, packed)
        out = torch.empty_like(h)
        n, hidden = h.shape
        err = lib.fused_step_launch(
            _ptr(h), _ptr(adj.vals), bf16, _ptr(ek), _ptr(eb), _ptr(wi),
            _ptr(bi), _ptr(wh), _ptr(bh), _ptr(out), n, hidden, adj.tile,
            adj.n_tiles, adj.bandwidth, stream)
        _raise_on_error(err, "fused_step_kernel")
    fused_gate_step.launches += 1
    return out


fused_gate_step.launches = 0


def persistent_unroll(params: Mapping, h: torch.Tensor, adj: BandAdjacency,
                      n_steps: int,
                      packed: Optional[Sequence[torch.Tensor]] = None
                      ) -> torch.Tensor:
    """``n_steps`` shared-weight gated steps.

    CPU tensors: :func:`persistent_reference`. CUDA tensors: one
    ``persistent_fwd_kernel`` launch, which needs the adjacency's closed
    row groups to pass :func:`persistent_smem_ok` — callers check the gate
    and run :func:`fused_gate_step` per step when it fails (the model
    does); here a failed gate raises. ``packed`` as in
    :func:`fused_gate_step`.
    """
    if n_steps < 1:
        raise ValueError(f"persistent_unroll needs n_steps >= 1, "
                         f"got {n_steps}")
    if h.device.type == "cpu":
        return persistent_reference(params, h, adj, n_steps)
    _check_cuda_inputs(h, adj)
    if not persistent_smem_ok(adj, h.shape[1]):
        raise ValueError(
            f"row groups need {persistent_smem_bytes(adj, h.shape[1])} B of "
            f"shared memory > {PERSISTENT_SMEM_BUDGET_BYTES} (or the band "
            "has no row groups): dispatch per step through fused_gate_step")
    groups = adj.row_groups.contiguous()  # held until the launch is queued
    if groups.device != h.device or groups.dtype != torch.int32:
        raise ValueError("row_groups must be int32 on the device of h")
    with torch.cuda.device(h.device):
        lib, (ek, eb, wi, bi, wh, bh), bf16, stream = _launch_args(
            params, h, adj, packed)
        out = torch.empty_like(h)
        hidden = h.shape[1]
        err = lib.persistent_fwd_launch(
            _ptr(h), _ptr(adj.vals), bf16, _ptr(ek), _ptr(eb), _ptr(wi),
            _ptr(bi), _ptr(wh), _ptr(bh), _ptr(groups),
            groups.numel() - 1, adj.max_group_rows, n_steps, _ptr(out),
            hidden, adj.tile, adj.n_tiles, adj.bandwidth, stream)
        _raise_on_error(err, "persistent_fwd_kernel")
    persistent_unroll.launches += 1
    return out


persistent_unroll.launches = 0


def launch_counts() -> Dict[str, int]:
    """Kernel name -> launches so far."""
    return {"fused_step_kernel": fused_gate_step.launches,
            "persistent_fwd_kernel": persistent_unroll.launches}


def reset_launch_counts() -> None:
    fused_gate_step.launches = 0
    persistent_unroll.launches = 0


def kernel_cost(adj: BandAdjacency, hidden: int,
                n_steps: int = 1) -> Dict[str, float]:
    """Operations and compulsory bytes of ``n_steps`` gated steps on these
    inputs, as one launch of the persistent kernel does them (``n_steps``
    launches of the fused kernel move the bytes ``n_steps`` times).

    FLOPs: per row the dense f32 products ``(A h) W_e`` and the two packed
    gate products (2 a multiply-add), ``2 H`` for each stored adjacency
    nonzero (the aggregate skips zeros, so this run's data sets it) and
    ~10 elementwise operations a gate element. Bytes: ``h`` in and ``h'``
    out, the band values and the packed weights, each once.
    """
    n = adj.n_tiles * adj.tile
    nnz = int(torch.count_nonzero(adj.vals))
    step_flops = (2.0 * n * hidden * hidden
                  + 2.0 * 2.0 * n * hidden * 3 * hidden
                  + 2.0 * nnz * hidden + 10.0 * n * hidden)
    return {
        "flops": n_steps * step_flops,
        "bytes": (2.0 * 4 * n * hidden
                  + adj.vals.numel() * adj.vals.element_size()
                  + (7.0 * hidden * hidden + 7.0 * hidden) * 4),
        "nnz": nnz,
    }
