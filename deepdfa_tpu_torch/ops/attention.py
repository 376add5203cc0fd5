"""Exact softmax attention (port of ``deepdfa_tpu/ops/attention.py``).

Layouts as in the reference: q ``[B, Tq, H, D]``, k/v ``[B, Tk, H, D]``,
kv_mask ``[B, Tk]`` (True = real token). Causal masking compares
positions ``i >= j``. (The reference's global-position offsets and its
resumable streaming state serve ring attention, which waits for the
several-GPU slice.)

Plain compositions, on any device: :func:`dense_attention` (O(T^2),
optionally returning the weights) and :func:`blockwise_attention`, the
streaming softmax over key blocks (:class:`AttnState`,
:func:`update_state`, :func:`finalize_state`).

Flash attention runs hand-written CUDA kernels (``csrc/flash_attn.cu``
and ``csrc/flash_bwd_fused.cu``; their header notes say what bounds them
and how they are laid out), each with its plain PyTorch version here:

- :func:`flash_fwd` launches ``flash_fwd_kernel``: O and the row
  logsumexp (the products as 3xTF32 on the tensor cores, the key tiles
  with no real key skipped); replaces the TPU kernel ``_flash_kernel``.
  Plain version :func:`flash_fwd_reference`.
- :func:`flash_bwd_fused` launches ``flash_bwd_fused_kernel``: dq, dk and
  dv in one pass (one block a key tile, the products as 3xTF32 on the
  tensor cores, the key tiles' dq partials then summed in a fixed order by
  its second step, ``flash_dq_sum_kernel``); replaces
  ``_flash_bwd_fused_kernel``. Plain version
  :func:`flash_bwd_fused_reference`.
- :func:`flash_bwd_dq` launches ``flash_bwd_dq_kernel`` and
  :func:`flash_bwd_dkv` ``flash_bwd_dkv_kernel``, the two-pass backward
  (the products as 3xTF32 on the tensor cores, the key tiles with no real
  key skipped); they replace ``_flash_bwd_dq_kernel`` and
  ``_flash_bwd_dkv_kernel``. Plain versions
  :func:`flash_bwd_dq_reference`, :func:`flash_bwd_dkv_reference`.

:func:`flash_attention` differentiates through :class:`_FlashAttention`,
which saves ``q, k, v, mask, o, lse`` as the reference's ``_flash_fwd``
does; its backward, :func:`flash_backward`, computes
``delta = rowsum(dO * O)`` outside the kernels and picks the fused
kernel or the two-pass pair by a shape gate, :func:`flash_fused_bwd_ok`:
the fused kernel's f32 dq partials for one (batch, head), one
``[Tq, D]`` plane a key tile, must stay within 1 MiB (T 512 at D 64
does; T 4096 would need 64 MiB). Two-pass dispatches are
counted in ``flash_backward.two_pass_dispatches``. The reference's
``_FUSED_BWD_MAX_BYTES``, ``_pick_block_h``/``_confirmed_block_h`` (TPU
VMEM heuristics) and ``_pick_block``'s blockwise fallback for lengths it
cannot tile have no counterpart: the kernels mask their ragged edge, so
every length runs through them.

Dtypes. Every kernel has an f32 instance and a bf16 one (``*_bf16`` in
:func:`launch_counts`), as the reference's Pallas kernels are generic over
the input dtype: q, k, v and dO in bf16, every score, probability and
sum in f32, lse and delta f32, and o, dq, dk and dv written in bf16. A
bf16 instance gives bit for bit the f32 kernel's result on the widened
inputs, rounded once to bf16. The plain versions widen and compute in
f32 and cast at the same points.

Dispatch: a wrapper takes its plain version only for tensors on the CPU.
For a CUDA tensor it launches its kernel (the instance of the inputs'
dtype) or raises: no fallback, no switch that puts the plain version on
the card. Each wrapper counts its launches in plain integer attributes,
``launches`` for the f32 instance and ``launches_bf16`` for the bf16 one
(``flash_fwd.launches`` and so on; :func:`launch_counts`), bumped where
the kernel is launched and nowhere else. ``impl="auto"`` means
``"flash"`` on every device: the kernels on the card, their plain
versions (the blockwise composition) on the CPU.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from deepdfa_tpu_torch.ops import PEAK_3XTF32, PEAK_BF16

NEG_INF = -1e30

#: The head width the CUDA kernels are built for (codebert-base and
#: unixcoder-base: 768 / 12 heads).
KERNEL_HEAD_DIM = 64
#: The kernels' query and key tile (rows).
TILE = 64
#: The fused backward's dq partials for one (batch, head) at most: T 512
#: at D 64 (192 MiB of scratch at B 16, H 12). They grow as T^2: T 4096
#: would need 64 MiB a (batch, head), 6 GiB at B 8, H 12.
FUSED_BWD_PARTIAL_BYTES = 1 << 20
#: Key block of the plain versions' streaming softmax (the reference's
#: blockwise default).
PLAIN_BLOCK = 512


# ---------------------------------------------------------------------------
# Plain compositions
# ---------------------------------------------------------------------------


class AttnState(NamedTuple):
    """Streaming softmax accumulator; merges associatively across KV
    chunks. o: [B, Tq, H, D] un-normalized output, m: [B, H, Tq] running
    row max, l: [B, H, Tq] running denominator (all f32)."""

    o: torch.Tensor
    m: torch.Tensor
    l: torch.Tensor


def init_state(batch: int, tq: int, heads: int, dim: int,
               device=None) -> AttnState:
    return AttnState(
        o=torch.zeros((batch, tq, heads, dim), dtype=torch.float32,
                      device=device),
        m=torch.full((batch, heads, tq), NEG_INF, dtype=torch.float32,
                     device=device),
        l=torch.zeros((batch, heads, tq), dtype=torch.float32,
                      device=device))


def _masked_scores(qs: torch.Tensor, k: torch.Tensor,
                   kv_mask: Optional[torch.Tensor], causal: bool,
                   kv_offset: int = 0) -> torch.Tensor:
    """s = qs k^T as [B, H, Tq, Tk] (f32), padding and causal masks at
    NEG_INF; ``qs`` is pre-scaled, ``k`` starts at key ``kv_offset``."""
    s = torch.einsum("bqhd,bkhd->bhqk", qs, k.float())
    if kv_mask is not None:
        s = torch.where(kv_mask[:, None, None, :], s, NEG_INF)
    if causal:
        qpos = torch.arange(qs.shape[1], device=s.device)
        kpos = kv_offset + torch.arange(k.shape[1], device=s.device)
        s = torch.where(qpos[:, None] >= kpos[None, :], s, NEG_INF)
    return s


def update_state(state: AttnState, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, kv_mask: Optional[torch.Tensor],
                 causal: bool, kv_offset: int = 0) -> AttnState:
    """Fold one KV chunk, starting at key ``kv_offset``, into the
    streaming state; ``q`` pre-scaled by 1/sqrt(D)."""
    s = _masked_scores(q.float(), k, kv_mask, causal, kv_offset)
    m_new = torch.maximum(state.m, s.amax(dim=-1))
    # Fully masked rows keep m == NEG_INF; pin the shift to 0 there so the
    # exp stays finite.
    shift = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
    p = torch.exp(s - shift[..., None])
    if kv_mask is not None:
        p = torch.where(kv_mask[:, None, None, :], p, 0.0)
    corr = torch.exp(torch.where(state.m <= NEG_INF / 2, NEG_INF, state.m)
                     - shift)
    l = state.l * corr + p.sum(dim=-1)
    o = state.o * corr.transpose(1, 2)[..., None] + torch.einsum(
        "bhqk,bkhd->bqhd", p, v.float())
    return AttnState(o=o, m=m_new, l=l)


def finalize_state(state: AttnState,
                   dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    l = state.l.transpose(1, 2)[..., None]
    out = state.o / torch.clamp(l, min=1e-30)
    return out.to(dtype) if dtype is not None else out


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_mask: Optional[torch.Tensor] = None,
                        causal: bool = False, block_size: int = PLAIN_BLOCK,
                        return_state: bool = False):
    """Exact attention over KV chunks of ``block_size``: O(Tq * block)
    live memory instead of O(Tq * Tk); differentiable by autograd.
    ``return_state``: the un-normalized :class:`AttnState` instead."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    qs = q.float() / math.sqrt(d)
    state = init_state(b, tq, h, d, device=q.device)
    block = min(block_size, tk)
    for start in range(0, tk, block):
        mask_i = None if kv_mask is None else kv_mask[:, start:start + block]
        state = update_state(state, qs, k[:, start:start + block],
                             v[:, start:start + block], mask_i, causal,
                             start)
    if return_state:
        return state
    return finalize_state(state, dtype=q.dtype)


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_mask: Optional[torch.Tensor] = None,
                    causal: bool = False, return_weights: bool = False):
    """Reference O(T^2) attention; the weights are [B, H, Tq, Tk]."""
    d = q.shape[-1]
    s = _masked_scores(q.float() / math.sqrt(d), k, kv_mask, causal)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", w, v.float()).to(q.dtype)
    return (out, w) if return_weights else out


# ---------------------------------------------------------------------------
# Plain versions of the kernels
# ---------------------------------------------------------------------------


def flash_fwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_mask: Optional[torch.Tensor] = None,
                        causal: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``flash_fwd_kernel``: ``(o [B, Tq, H, D] in q's
    dtype, lse [B, H, Tq] f32)`` by the streaming softmax over key blocks
    of ``PLAIN_BLOCK`` (never a [B, H, Tq, Tk] tensor).
    ``lse = shift + log(max(l, 1e-30))``; a fully masked row gives
    ``o = 0`` and ``lse = log(1e-30)``."""
    state = blockwise_attention(q, k, v, kv_mask, causal, return_state=True)
    lc = torch.clamp(state.l, min=1e-30)
    lse = torch.where(state.m <= NEG_INF / 2, 0.0, state.m) + torch.log(lc)
    o = state.o / lc.transpose(1, 2)[..., None]
    return o.to(q.dtype), lse


def flash_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``delta = rowsum(dO * O)`` as [B, H, Tq] f32, computed outside the
    kernels (the reference's ``_flash_backward``, ``:573``)."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def _tile_grads_reference(qs, k, v, kv_mask, do, lse, delta, causal,
                          kv_offset):
    """The backward's tile step on one key block: P rebuilt from the saved
    logsumexp, ``dS = P (dO V^T - delta)``. Returns (P, dS) as
    [B, H, Tq, Tk_block]."""
    s = _masked_scores(qs, k, kv_mask, causal, kv_offset)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - delta[..., None])


def _key_blocks(k, v, kv_mask):
    tk = k.shape[1]
    for start in range(0, tk, PLAIN_BLOCK):
        sl = slice(start, start + PLAIN_BLOCK)
        yield (start, k[:, sl], v[:, sl],
               None if kv_mask is None else kv_mask[:, sl])


def flash_bwd_dq_reference(q, k, v, kv_mask, do, lse, delta,
                           causal: bool = False) -> torch.Tensor:
    """Plain version of ``flash_bwd_dq_kernel``:
    ``dq = scale * sum_j dS K`` over key blocks."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qs = q.float() * scale
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for start, kb, vb, mb in _key_blocks(k, v, kv_mask):
        _, ds = _tile_grads_reference(qs, kb, vb, mb, do, lse, delta, causal,
                                      start)
        dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, kb.float())
    return (dq * scale).to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, kv_mask, do, lse, delta,
                            causal: bool = False
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``flash_bwd_dkv_kernel``: ``dv = sum_i P^T dO``
    and ``dk = sum_i dS^T (scale Q)``, block by key block."""
    qs = q.float() / math.sqrt(q.shape[-1])
    dks, dvs = [], []
    for start, kb, vb, mb in _key_blocks(k, v, kv_mask):
        p, ds = _tile_grads_reference(qs, kb, vb, mb, do, lse, delta, causal,
                                      start)
        dvs.append(torch.einsum("bhqk,bqhd->bkhd", p, do.float()))
        dks.append(torch.einsum("bhqk,bqhd->bkhd", ds, qs))
    return torch.cat(dks, 1).to(k.dtype), torch.cat(dvs, 1).to(v.dtype)


def flash_bwd_fused_reference(q, k, v, kv_mask, do, lse, delta,
                              causal: bool = False):
    """Plain version of ``flash_bwd_fused_kernel``: dq, dk and dv from one
    walk over the key blocks (each block's P and dS computed once)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qs = q.float() * scale
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for start, kb, vb, mb in _key_blocks(k, v, kv_mask):
        p, ds = _tile_grads_reference(qs, kb, vb, mb, do, lse, delta, causal,
                                      start)
        dvs.append(torch.einsum("bhqk,bqhd->bkhd", p, do.float()))
        dks.append(torch.einsum("bhqk,bqhd->bkhd", ds, qs))
        dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, kb.float())
    return ((dq * scale).to(q.dtype), torch.cat(dks, 1).to(k.dtype),
            torch.cat(dvs, 1).to(v.dtype))


# ---------------------------------------------------------------------------
# The backward's shape gate
# ---------------------------------------------------------------------------


def fused_bwd_partial_bytes(tq: int, d: int, tk: Optional[int] = None
                             ) -> int:
    """The f32 dq partials ``flash_bwd_fused_kernel`` writes for one
    (batch, head): a ``[Tq, D]`` plane for each of the ``ceil(Tk / 64)``
    key tiles (``Tk`` defaults to ``Tq``)."""
    tk = tq if tk is None else tk
    return 4 * -(-tk // TILE) * tq * d


def flash_fused_bwd_ok(tq: int, d: int, tk: Optional[int] = None) -> bool:
    """The backward's gate (replaces the reference's
    ``_FUSED_BWD_MAX_BYTES``, which is sized to the TPU's VMEM): the fused
    kernel where one (batch, head)'s dq partials stay within
    ``FUSED_BWD_PARTIAL_BYTES`` (T <= 512 at D 64); the two-pass pair,
    which needs no partials, otherwise."""
    return fused_bwd_partial_bytes(tq, d, tk) <= FUSED_BWD_PARTIAL_BYTES


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _raise_on_error(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError_t {err}")


def _ones_mask(kv_mask: Optional[torch.Tensor],
               k: torch.Tensor) -> torch.Tensor:
    if kv_mask is not None:
        return kv_mask
    return torch.ones(k.shape[:2], dtype=torch.bool, device=k.device)


#: The input dtypes the kernels have an instance for, and the suffix of
#: each instance's C function and launch-count key.
INSTANCES = {torch.float32: "", torch.bfloat16: "_bf16"}


def _check_cuda(kernel: str, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor, kv_mask: torch.Tensor,
                rows: Tuple[Tuple[str, torch.Tensor, tuple, bool], ...] = ()
                ) -> None:
    """Raise on what the kernels do not take: CUDA tensors on one device,
    f32 or bf16 [B, T, H, D] with D = KERNEL_HEAD_DIM, q, k and v of one
    dtype, contiguous and 16-byte aligned (the tiles load 16 bytes at a
    time), a bool [B, Tk] mask; ``rows``: further (name, tensor, shape,
    in q's dtype or else f32) inputs."""
    if not q.is_cuda:
        raise ValueError(f"{kernel} takes CPU tensors (plain version) or "
                         f"CUDA tensors, got {q.device}")
    if q.dim() != 4:
        raise ValueError(f"{kernel}: q must be [B, Tq, H, D], got "
                         f"{tuple(q.shape)}")
    b, _, h, d = q.shape
    tk = k.shape[1]
    if d != KERNEL_HEAD_DIM:
        raise ValueError(f"{kernel}: head width {d}; the kernels take "
                         f"{KERNEL_HEAD_DIM} (use impl='dense' or "
                         "'blockwise' for other widths)")
    if q.dtype not in INSTANCES:
        raise NotImplementedError(
            f"{kernel}: q is {q.dtype}; the CUDA kernels take float32 or "
            "bfloat16")
    tensors = (("q", q, tuple(q.shape), True), ("k", k, (b, tk, h, d), True),
               ("v", v, (b, tk, h, d), True)) + tuple(rows)
    for name, t, shape, like_q in tensors:
        want = q.dtype if like_q else torch.float32
        if t.dtype != want:
            raise ValueError(f"{kernel}: {name} is {t.dtype}, want {want} "
                             f"(q is {q.dtype})")
        if tuple(t.shape) != shape or t.device != q.device:
            raise ValueError(f"{kernel}: {name} {tuple(t.shape)} on "
                             f"{t.device}, want {shape} on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{kernel}: {name} must be contiguous and "
                             "16-byte aligned")
    if (kv_mask.dtype != torch.bool or tuple(kv_mask.shape) != (b, tk)
            or kv_mask.device != q.device or not kv_mask.is_contiguous()):
        raise ValueError(f"{kernel}: kv_mask must be a contiguous bool "
                         f"[{b}, {tk}] on {q.device}, got {kv_mask.dtype} "
                         f"{tuple(kv_mask.shape)} on {kv_mask.device}")


def _launcher(q: torch.Tensor, fn: str, name: str = "flash_attn"):
    """The C launch function ``fn`` of the instance for q's dtype, and the
    current stream."""
    from deepdfa_tpu_torch.ops import _build

    stream = ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream)
    lib = _build.load(name)
    return getattr(lib, fn.replace("_launch",
                                   INSTANCES[q.dtype] + "_launch")), stream


def _count(wrapper, q: torch.Tensor) -> None:
    """One launch of ``wrapper``'s kernel, on the count of q's instance."""
    attr = "launches" + INSTANCES[q.dtype]
    setattr(wrapper, attr, getattr(wrapper, attr) + 1)


def _dims(q: torch.Tensor, k: torch.Tensor, causal: bool) -> tuple:
    b, tq, h, d = q.shape
    return (b, h, tq, k.shape[1], int(causal),
            ctypes.c_float(1.0 / math.sqrt(d)))


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              kv_mask: Optional[torch.Tensor] = None, causal: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)`` of exact attention. CPU tensors:
    :func:`flash_fwd_reference`. CUDA tensors: ``flash_fwd_kernel``, or
    an exception."""
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, kv_mask, causal)
    mask = _ones_mask(kv_mask, k)
    _check_cuda("flash_fwd_kernel", q, k, v, mask)
    b, tq, h, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        launch, stream = _launcher(q, "flash_fwd_launch")
        err = launch(_ptr(q), _ptr(k), _ptr(v), _ptr(mask), _ptr(o),
                     _ptr(lse), *_dims(q, k, causal), stream)
        _raise_on_error(err, "flash_fwd_kernel")
    _count(flash_fwd, q)
    return o, lse


flash_fwd.launches = flash_fwd.launches_bf16 = 0


def _bwd_rows(q: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
              delta: torch.Tensor) -> tuple:
    b, tq, h, _ = q.shape
    return (("do", do, tuple(q.shape), True), ("lse", lse, (b, h, tq), False),
            ("delta", delta, (b, h, tq), False))


def flash_bwd_fused(q, k, v, kv_mask, do, lse, delta, causal: bool = False):
    """``(dq, dk, dv)`` in one pass. CPU tensors:
    :func:`flash_bwd_fused_reference`. CUDA tensors:
    ``flash_bwd_fused_kernel`` and its dq sum where
    :func:`flash_fused_bwd_ok` holds (raises otherwise:
    :func:`flash_backward` checks the gate)."""
    if q.device.type == "cpu":
        return flash_bwd_fused_reference(q, k, v, kv_mask, do, lse, delta,
                                         causal)
    mask = _ones_mask(kv_mask, k)
    _check_cuda("flash_bwd_fused_kernel", q, k, v, mask,
                _bwd_rows(q, do, lse, delta))
    b, tq, h, d = q.shape
    tk = k.shape[1]
    if not flash_fused_bwd_ok(tq, d, tk):
        raise ValueError(
            f"flash_bwd_fused_kernel: Tq {tq}, Tk {tk}, D {d} needs "
            f"{fused_bwd_partial_bytes(tq, d, tk)} B of dq partials a "
            f"(batch, head) > {FUSED_BWD_PARTIAL_BYTES}: use the two-pass "
            "kernels")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    part = torch.empty((-(-tk // TILE), b, tq, h, d), dtype=torch.float32,
                       device=q.device)
    with torch.cuda.device(q.device):
        launch, stream = _launcher(q, "flash_bwd_fused_launch",
                                   "flash_bwd_fused")
        err = launch(_ptr(q), _ptr(k), _ptr(v), _ptr(mask), _ptr(do),
                     _ptr(lse), _ptr(delta), _ptr(part), _ptr(dq), _ptr(dk),
                     _ptr(dv), *_dims(q, k, causal), stream)
        _raise_on_error(err, "flash_bwd_fused_kernel")
    _count(flash_bwd_fused, q)
    return dq, dk, dv


flash_bwd_fused.launches = flash_bwd_fused.launches_bf16 = 0


def flash_bwd_dq(q, k, v, kv_mask, do, lse, delta,
                 causal: bool = False) -> torch.Tensor:
    """dq of the two-pass backward. CPU tensors:
    :func:`flash_bwd_dq_reference`. CUDA tensors: ``flash_bwd_dq_kernel``,
    or an exception."""
    if q.device.type == "cpu":
        return flash_bwd_dq_reference(q, k, v, kv_mask, do, lse, delta,
                                      causal)
    mask = _ones_mask(kv_mask, k)
    _check_cuda("flash_bwd_dq_kernel", q, k, v, mask,
                _bwd_rows(q, do, lse, delta))
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        launch, stream = _launcher(q, "flash_bwd_dq_launch")
        err = launch(_ptr(q), _ptr(k), _ptr(v), _ptr(mask), _ptr(do),
                     _ptr(lse), _ptr(delta), _ptr(dq), *_dims(q, k, causal),
                     stream)
        _raise_on_error(err, "flash_bwd_dq_kernel")
    _count(flash_bwd_dq, q)
    return dq


flash_bwd_dq.launches = flash_bwd_dq.launches_bf16 = 0


def flash_bwd_dkv(q, k, v, kv_mask, do, lse, delta,
                  causal: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) of the two-pass backward. CPU tensors:
    :func:`flash_bwd_dkv_reference`. CUDA tensors:
    ``flash_bwd_dkv_kernel``, or an exception."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_reference(q, k, v, kv_mask, do, lse, delta,
                                       causal)
    mask = _ones_mask(kv_mask, k)
    _check_cuda("flash_bwd_dkv_kernel", q, k, v, mask,
                _bwd_rows(q, do, lse, delta))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        launch, stream = _launcher(q, "flash_bwd_dkv_launch")
        err = launch(_ptr(q), _ptr(k), _ptr(v), _ptr(mask), _ptr(do),
                     _ptr(lse), _ptr(delta), _ptr(dk), _ptr(dv),
                     *_dims(q, k, causal), stream)
        _raise_on_error(err, "flash_bwd_dkv_kernel")
    _count(flash_bwd_dkv, q)
    return dk, dv


flash_bwd_dkv.launches = flash_bwd_dkv.launches_bf16 = 0


def flash_backward(q, k, v, kv_mask, o, lse, do, causal: bool = False):
    """The attention VJP ``(dq, dk, dv)``: ``delta`` outside the kernels,
    then the fused kernel where :func:`flash_fused_bwd_ok` holds, the dq
    and dk/dv pair otherwise (counted in ``two_pass_dispatches``)."""
    delta = flash_delta(o, do)
    if flash_fused_bwd_ok(q.shape[1], q.shape[3], k.shape[1]):
        return flash_bwd_fused(q, k, v, kv_mask, do, lse, delta, causal)
    flash_backward.two_pass_dispatches += 1
    dq = flash_bwd_dq(q, k, v, kv_mask, do, lse, delta, causal)
    dk, dv = flash_bwd_dkv(q, k, v, kv_mask, do, lse, delta, causal)
    return dq, dk, dv


flash_backward.two_pass_dispatches = 0


class _FlashAttention(torch.autograd.Function):
    """:func:`flash_fwd` forward, :func:`flash_backward` backward. Saves
    ``q, k, v, mask, o, lse``: no [T, T] residual. The gradients come in
    the inputs' dtype."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal):
        o, lse = flash_fwd(q, k, v, kv_mask, causal)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, kv_mask, o, lse)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_mask, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, kv_mask, o, lse, g.contiguous(),
                                    ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_mask: Optional[torch.Tensor] = None,
                    causal: bool = False) -> torch.Tensor:
    """Exact attention through the flash kernels (their plain versions on
    the CPU); differentiable through :class:`_FlashAttention` when a
    gradient is needed."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, _ones_mask(kv_mask, k), causal)
    return flash_fwd(q, k, v, kv_mask, causal)[0]


def attention(q, k, v, kv_mask=None, causal: bool = False,
              impl: str = "auto", **kw):
    """Dispatch: ``"dense"`` | ``"blockwise"`` | ``"flash"`` | ``"auto"``
    (= ``"flash"``: the kernels on the card, their plain versions on the
    CPU)."""
    if impl in ("auto", "flash"):
        return flash_attention(q, k, v, kv_mask=kv_mask, causal=causal, **kw)
    if impl == "dense":
        return dense_attention(q, k, v, kv_mask=kv_mask, causal=causal, **kw)
    if impl == "blockwise":
        return blockwise_attention(q, k, v, kv_mask=kv_mask, causal=causal,
                                   **kw)
    raise ValueError(f"unknown attention impl {impl!r}")


_WRAPPERS = {
    "flash_fwd_kernel": flash_fwd,
    "flash_bwd_fused_kernel": flash_bwd_fused,
    "flash_bwd_dq_kernel": flash_bwd_dq,
    "flash_bwd_dkv_kernel": flash_bwd_dkv,
}
#: Kernel instance name -> (wrapper, its count attribute): the f32
#: instances under the kernels' names, the bf16 ones with ``_bf16``.
_COUNTED = {name + suffix: (fn, "launches" + suffix)
            for suffix in INSTANCES.values()
            for name, fn in _WRAPPERS.items()}
KERNELS = tuple(_COUNTED)


def launch_counts() -> Dict[str, int]:
    """Kernel instance name -> launches so far."""
    return {name: getattr(fn, attr) for name, (fn, attr) in _COUNTED.items()}


def reset_launch_counts() -> None:
    for fn, attr in _COUNTED.values():
        setattr(fn, attr, 0)
    flash_backward.two_pass_dispatches = 0


# ---------------------------------------------------------------------------
# Operations and bytes
# ---------------------------------------------------------------------------

#: Products of a [T, T] by [T, D] shape each kernel does (2 operations a
#: multiply-add): S and PV forward; S, dP, dV, dK, dQ fused; S, dP, dQ
#: and S, dP, dV, dK for the two-pass pair (the reference's bench counts
#: those 7 products).
_PRODUCTS = {"flash_fwd_kernel": 2, "flash_bwd_fused_kernel": 5,
             "flash_bwd_dq_kernel": 3, "flash_bwd_dkv_kernel": 4}
#: Of those, the products whose two operands are both inputs (S = QK^T
#: and dP = dO V^T): at bf16 both operands are bf16 and the product is
#: exact in f32. The others have an f32 operand (P or dS).
_INPUT_PRODUCTS = {"flash_fwd_kernel": 1, "flash_bwd_fused_kernel": 2,
                   "flash_bwd_dq_kernel": 2, "flash_bwd_dkv_kernel": 2}


def kernel_cost(kv_mask: torch.Tensor, tq: int, h: int, d: int,
                kernel: str, causal: bool = False) -> Dict[str, float]:
    """Operations and compulsory bytes of one ``kernel`` call on [B, T,
    H, D] inputs with this ``kv_mask`` ([B, Tk], True = token), as the
    function needs them on this data; ``kernel`` names an instance
    (``KERNELS``: a ``_bf16`` one moves q, k, v, dO, o, dq, dk and dv at 2
    bytes an element, lse and delta at 4):

    - ``flops``: 2 operations a multiply-add of each product, over the
      (query, key) pairs that survive the masks: every query row against
      the real keys it may see (causal: at or before it). Padded keys,
      all-pad rows and the causal triangle's far side cost nothing.
    - ``bytes``: each input read once and each output written once. The
      forward reads q of the live query rows (those that see a key), k
      and v of the real keys they see and the mask, and writes o and lse
      for every row; each backward kernel reads q, dO, lse and delta of
      the live rows, k and v of the seen keys and the mask, and writes
      its gradients for every row.
    - ``executed_flops``: the operations the kernel does, whole 64 x 64
      tiles and masked scores included. Every kernel skips the causal
      tiles wholly above the diagonal and the key tiles with no real key
      (``dead_key_tiles``, counted over batch rows and heads).
    - ``peak_flops``/``peak``: the rate the operations bound divides by.
      f32: the f32 work of the 3xTF32 products on the tensor cores. bf16:
      the products of two bf16 inputs (``_INPUT_PRODUCTS``) at the dense
      bf16 tensor-core rate and those with an f32 operand at the 3xTF32
      rate, as one rate over all the products (``flops`` over the sum of
      the two times); ``flops_bf16`` counts the first kind."""
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}; one of {KERNELS}")
    bf16 = kernel.endswith("_bf16")
    esize = 2.0 if bf16 else 4.0
    kernel = kernel.removesuffix("_bf16")
    mask = kv_mask.detach().to("cpu", torch.bool)
    b, tk = mask.shape
    if causal:
        # seen[b, i]: real keys j <= i; key j is seen iff j < tq.
        seen = torch.cumsum(mask.long(), 1)[:, :tq]
        if tq > tk:
            seen = torch.cat([seen, seen[:, -1:].expand(b, tq - tk)], 1)
        keys = int(mask[:, :tq].sum())
    else:
        seen = mask.long().sum(1, keepdim=True).expand(b, tq)
        keys = int(mask.sum())
    pairs = int(seen.sum())
    live = int((seen > 0).sum())
    unit = 2.0 * _PRODUCTS[kernel] * h * d
    nq, nk = -(-tq // TILE), -(-tk // TILE)
    # Query tiles that meet key tile kt (causal: those not before it), and
    # which (batch row, key tile) pairs hold a real key.
    meets = torch.tensor([nq - min(kt, nq) if causal else nq
                          for kt in range(nk)])
    padded = torch.zeros(b, nk * TILE, dtype=torch.bool)
    padded[:, :tk] = mask
    live_tiles = padded.reshape(b, nk, TILE).any(2)
    tiles = int((live_tiles * meets).sum())
    row = esize * h * d  # one [H, D] row of q, k, v, dO or an output
    mask_bytes, rowvec = 1.0 * b * tk, 4.0 * h
    if kernel == "flash_fwd_kernel":
        nbytes = (live * row + 2 * keys * row + mask_bytes
                  + b * tq * (row + rowvec))
    else:
        reads = 2 * live * (row + rowvec) + 2 * keys * row + mask_bytes
        writes = {"flash_bwd_fused_kernel": b * tq * row + 2 * b * tk * row,
                  "flash_bwd_dq_kernel": b * tq * row,
                  "flash_bwd_dkv_kernel": 2 * b * tk * row}[kernel]
        nbytes = reads + writes
    peak, flops_bf16 = PEAK_3XTF32, 0.0
    if bf16:
        n, nb = _PRODUCTS[kernel], _INPUT_PRODUCTS[kernel]
        flops_bf16 = unit * pairs * nb / n
        peak = (f"{PEAK_BF16[0]} ({nb} of {n} products), {PEAK_3XTF32[0]} "
                f"({n - nb})",
                n / (nb / PEAK_BF16[1] + (n - nb) / PEAK_3XTF32[1]))
    return {"flops": unit * pairs, "flops_bf16": flops_bf16,
            "bytes": nbytes, "executed_flops": unit * tiles * TILE * TILE,
            "dead_key_tiles": h * int((~live_tiles).sum()),
            "peak": peak[0], "peak_flops": peak[1]}
