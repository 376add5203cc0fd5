"""Serving configuration (port of the graph and combined lanes' part of
``deepdfa_tpu/serve/config.py``).

Every batch shape the engine runs derives from this config alone: slot
counts round up the power-of-two ladder (``select_bucket``), node and
edge budgets scale per slot, the band bandwidth is pinned and the
combined lane's token rows are ``block_size`` long. The gen lane's
geometry, fleet geometry and adaptive flush are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from deepdfa_tpu_torch.graphs.batch import select_bucket


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    # Micro-batch geometry; per-request caps make the bucket budgets
    # exact (any `s` admitted requests fit the s-slot bucket).
    batch_slots: int = 16
    max_nodes_per_graph: int = 64
    max_edges_per_node: int = 4
    # Flush when a lane holds batch_slots requests, or when its oldest
    # request has spent flush_fraction of its deadline waiting.
    deadline_ms: float = 100.0
    flush_fraction: float = 0.5
    queue_capacity: int = 256
    cache_capacity: int = 4096
    # Combined-lane text geometry (must match the checkpoint's block_size).
    block_size: int = 512
    latency_window: int = 8192
    # Pinned block-band width (1 covers any packing of <= 128-node graphs).
    band_bandwidth: int = 1

    def __post_init__(self):
        if self.batch_slots < 1:
            raise ValueError("batch_slots must be >= 1")
        if not 0.0 < self.flush_fraction <= 1.0:
            raise ValueError("flush_fraction must be in (0, 1]")
        if self.queue_capacity < self.batch_slots:
            raise ValueError(
                "queue_capacity below batch_slots could never fill a bucket")

    @property
    def slot_buckets(self) -> List[int]:
        """Every micro-batch slot count the engine may emit (ascending)."""
        out: List[int] = []
        s = 1
        while s < self.batch_slots:
            out.append(s)
            s *= 2
        out.append(self.batch_slots)
        return out

    def bucket_for(self, n_requests: int) -> int:
        return select_bucket(n_requests, maximum=self.batch_slots, minimum=1)

    def budget_for(self, slots: int,
                   tile: Optional[int] = None) -> Dict[str, int]:
        """Padded node/edge budgets of the ``slots``-slot bucket; ``tile``
        aligns the node budget up to a tile multiple (band layouts)."""
        max_nodes = select_bucket(slots * self.max_nodes_per_graph)
        if tile:
            max_nodes = -(-max_nodes // tile) * tile
        return {
            "n_graphs": slots,
            "max_nodes": max_nodes,
            "max_edges": select_bucket(max_nodes * self.max_edges_per_node),
        }

    def admission_caps(self, num_nodes: int, num_edges: int) -> Optional[str]:
        """None when a graph fits one slot, else the rejection reason
        (``num_edges`` counts self loops)."""
        if num_nodes > self.max_nodes_per_graph:
            return (f"graph has {num_nodes} nodes > per-request cap "
                    f"{self.max_nodes_per_graph}")
        if num_edges > num_nodes * self.max_edges_per_node:
            return (f"graph has {num_edges} edges (incl. self loops) > "
                    f"per-request cap {num_nodes * self.max_edges_per_node}")
        return None
