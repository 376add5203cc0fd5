"""Serving configuration (port of the graph and combined lanes' part of
``deepdfa_tpu/serve/config.py``).

Every batch shape the engine runs derives from this config alone: slot
counts round up the power-of-two ladder (``select_bucket``), node and
edge budgets scale per slot, the band bandwidth is pinned and the
combined lane's token rows are ``block_size`` long. ``replicas`` sizes
the serving fleet (``serve/fleet.py``) and the ``adaptive_*`` fields
drive each replica's flush policy (``serve/policy.py``). The gen lane's
geometry is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from deepdfa_tpu_torch.graphs.batch import select_bucket
from deepdfa_tpu_torch.ops.band_spmm import closed_group_bound

# The replica ids a fleet may use, fixed in code: every per-replica name
# (a /metrics section, a pump thread) comes from this tuple, never from
# runtime state. A wider fleet is a code change.
REPLICA_IDS = ("r0", "r1", "r2", "r3", "r4", "r5", "r6", "r7")
MAX_REPLICAS = len(REPLICA_IDS)


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
    # Engine replicas behind the fleet's router, each on its own shard of
    # the devices with its own batcher and pump thread.
    replicas: int = 1
    # Adaptive flush: each replica's policy moves its batcher's deadline
    # fraction and fill threshold from its own p99 and occupancy, within
    # [flush_fraction_min, flush_fraction_max], one adaptive_step after
    # adaptive_patience consecutive signals, at most once an
    # adaptive_interval_s of engine clock.
    adaptive_flush: bool = False
    flush_fraction_min: float = 0.1
    flush_fraction_max: float = 0.9
    adaptive_interval_s: float = 0.25
    adaptive_step: float = 0.1
    adaptive_patience: int = 2
    adaptive_target_p99_frac: float = 0.8  # p99 target, share of deadline

    def __post_init__(self):
        if self.batch_slots < 1:
            raise ValueError("batch_slots must be >= 1")
        if not 0.0 < self.flush_fraction <= 1.0:
            raise ValueError("flush_fraction must be in (0, 1]")
        if self.queue_capacity < self.batch_slots:
            raise ValueError(
                "queue_capacity below batch_slots could never fill a bucket")
        if not 1 <= self.replicas <= MAX_REPLICAS:
            raise ValueError(
                f"replicas must be in [1, {MAX_REPLICAS}] (the replica ids "
                "are fixed in REPLICA_IDS; grow it to go wider)")
        if not (0.0 < self.flush_fraction_min
                <= self.flush_fraction_max <= 1.0):
            raise ValueError(
                "need 0 < flush_fraction_min <= flush_fraction_max <= 1")
        if self.adaptive_patience < 1:
            raise ValueError("adaptive_patience must be >= 1")

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

    def group_bound(self, slots: int, tile: int) -> Dict[str, int]:
        """The ``slots``-slot band bucket's static row-group geometry:
        ``groups``, the closed row groups any admitted mix of graphs cuts
        its ``max_nodes`` rows into at most, and ``rows``, its largest
        group at most (``ops.band_spmm.closed_group_bound``: graphs pack
        contiguously and no CFG edge crosses two, so a component holds at
        most ``max_nodes_per_graph`` rows). A pure function of (slots,
        ``max_nodes_per_graph``, tile)."""
        n_rows = self.budget_for(slots, tile=tile)["max_nodes"]
        groups, rows = closed_group_bound(n_rows, self.max_nodes_per_graph)
        return {"groups": groups, "rows": rows}

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
