"""The serving fleet's device shards (port of ``replica_device_shards``
in ``deepdfa_tpu/parallel/mesh.py``)."""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import torch


def replica_device_shards(n_replicas: int,
                          devices: Optional[Sequence[Any]] = None
                          ) -> List[List[Any]]:
    """Partition ``devices`` into one shard per serving replica: replica
    ``i`` owns ``shards[i]`` and runs on ``shards[i][0]``.

    Contiguous blocks; a count that does not divide spreads the remainder
    over the first shards, so every device belongs to exactly one
    replica. With fewer devices than replicas the assignment is
    round-robin (on one card every replica shares it). ``devices``
    defaults to the visible CUDA devices; with none visible and none
    given it raises: a fleet never moves to the CPU unasked.
    """
    if n_replicas < 1:
        raise ValueError("n_replicas must be >= 1")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device for the fleet's replicas; pass "
                "devices=[torch.device('cpu')] to run the plain PyTorch "
                "versions")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if not devices:
        raise ValueError("no devices to assign replicas to")
    if len(devices) >= n_replicas:
        per, rem = divmod(len(devices), n_replicas)
        shards, start = [], 0
        for i in range(n_replicas):
            width = per + (1 if i < rem else 0)
            shards.append(devices[start:start + width])
            start += width
        return shards
    return [[devices[i % len(devices)]] for i in range(n_replicas)]
