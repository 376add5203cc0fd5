"""Tile-layout host helpers (the host side of
``deepdfa_tpu/ops/tile_spmm.py``; its block-sparse kernel is not ported
yet)."""

from __future__ import annotations

import numpy as np
import torch

DEFAULT_TILE = 128


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
