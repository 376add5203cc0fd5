"""Live device memory telemetry (port of ``DeviceMemorySampler`` and
``SAMPLER`` from ``deepdfa_tpu/telemetry/memory.py``).

:class:`DeviceMemorySampler` polls the caching allocator's
``torch.cuda.memory_stats`` of one card and publishes the
``device_bytes_in_use`` / ``device_peak_bytes_in_use`` gauges in the
shared registry (so the serve ``/metrics`` exposition and ``/healthz``
carry them) with a ``memory.sample`` event. A CPU device has no such
stats: the sampler returns None there. The reference's compiled-program
footprint (``compiled_memory``, ``record_compiled``) reads XLA's memory
analysis and has no counterpart here.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

# The sample's keys, from torch.cuda.memory_stats: the reference's two
# (bytes_in_use, peak_bytes_in_use) and the allocator's reserve.
_STATS = {
    "allocated_bytes.all.current": "bytes_in_use",
    "allocated_bytes.all.peak": "peak_bytes_in_use",
    "reserved_bytes.all.current": "bytes_reserved",
    "reserved_bytes.all.peak": "peak_bytes_reserved",
    "num_alloc_retries": "num_alloc_retries",
    "num_ooms": "num_ooms",
}


def _read(device) -> Optional[Dict[str, int]]:
    """``device``'s allocator stats under the sample's keys; None for a
    CPU device, without CUDA, or before this process touched the card
    (reading would create a context)."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available() \
            or not torch.cuda.is_initialized():
        return None
    stats = torch.cuda.memory_stats(dev)
    return {key: int(stats[name]) for name, key in _STATS.items()
            if name in stats}


class DeviceMemorySampler:
    """``torch.cuda.memory_stats`` poller.

    ``sample(device)`` reads the card's allocator stats, sets the
    ``device_bytes_in_use`` / ``device_peak_bytes_in_use`` gauges, and
    emits a ``memory.sample`` event (a no-op without a run). Returns the
    stats dict, or None when the device has none (the CPU, or a card this
    process has not touched yet). Each call decides that anew, so a CPU
    read never turns sampling off for a card. It has no rate limit of its
    own: its callers (the serve pump's observation tick, ``/healthz``)
    keep their own pace.
    """

    def sample(self, device=None) -> Optional[Dict[str, Any]]:
        from deepdfa_tpu_torch import telemetry

        out = _read(device)
        if not out:
            return None
        telemetry.REGISTRY.gauge("device_bytes_in_use").set(
            out["bytes_in_use"])
        telemetry.REGISTRY.gauge("device_peak_bytes_in_use").set(
            out["peak_bytes_in_use"])
        telemetry.event("memory.sample", **out)
        return out


#: The process sampler (every serve pump and ``/healthz`` share it).
SAMPLER = DeviceMemorySampler()
