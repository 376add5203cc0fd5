"""Message-passing ops: host-side adjacency construction, the band SpMM
and the fused GNN step kernels (``fused_gnn``), the tile SpMM
(``tile_spmm``) and the flash-attention kernels (``attention``).

:func:`launch_counts` and :func:`reset_launch_counts` cover every kernel
of the port, by kernel name. A CUDA graph's capture launches nothing:
under :func:`recording_launches` the counts a thread would add go to a
record instead, and :func:`add_launches` adds that record on every
replay of the graph, so the counts go on counting launches on the card."""

import contextlib
import threading
from typing import Dict, Iterator, Mapping, Tuple

#: The peak rates a kernel's operations bound divides by, as (name,
#: operations a second): NVIDIA's H100 SXM data sheet at the full 700 W.
#: f32 FMAs on the CUDA cores; and f32 work done as 3xTF32 on the tensor
#: cores (each product split into TF32 high and low parts, three TF32
#: products summed in f32: a third of the 495 TFLOP/s TF32 rate); and
#: a product of two bf16 operands with f32 sums on the tensor cores
#: (dense bf16, 989 TFLOP/s); and a product of an f32 operand with a bf16
#: one, exact, as three bf16 products (the f32 operand split into three
#: bf16 parts: a third of the bf16 rate).
PEAK_F32_SIMT = ("f32 SIMT FMA, 67 TFLOP/s", 67e12)
PEAK_3XTF32 = ("3xTF32 tensor cores, 495/3 TFLOP/s", 495e12 / 3)
PEAK_BF16 = ("bf16 tensor cores, 989 TFLOP/s", 989e12)
PEAK_BF16X3 = ("f32 x bf16 as three bf16 products, 989/3 TFLOP/s",
               989e12 / 3)
#: The card's memory rate the bytes bound divides by (HBM3, 3.35 TB/s).
PEAK_BYTES_PER_S = 3.35e12


# Serializes the launch counts' read-modify-writes: a fleet launches from
# one pump thread a replica, and a bare ``+= 1`` from two threads can
# lose an increment.
_COUNT_LOCK = threading.Lock()
# The thread's record while it captures a CUDA graph (recording_launches).
_RECORD = threading.local()


def count_launch(wrapper, attr: str = "launches") -> None:
    """Add one launch to ``wrapper``'s ``attr`` count, under the lock
    (taken after the launch, never around it); inside
    :func:`recording_launches` on this thread, to its record instead."""
    record = getattr(_RECORD, "counts", None)
    if record is not None:
        key = (wrapper, attr)
        record[key] = record.get(key, 0) + 1
        return
    with _COUNT_LOCK:
        setattr(wrapper, attr, getattr(wrapper, attr) + 1)


@contextlib.contextmanager
def recording_launches() -> Iterator[Dict[Tuple[object, str], int]]:
    """Within the block, this thread's :func:`count_launch` calls add to
    the yielded record ((wrapper, attr) -> launches) and to no count:
    what a CUDA graph capture queues, which runs on its replays. Other
    threads count as before."""
    if getattr(_RECORD, "counts", None) is not None:
        raise RuntimeError("recording_launches does not nest")
    _RECORD.counts = {}
    try:
        yield _RECORD.counts
    finally:
        _RECORD.counts = None


def add_launches(record: Mapping[Tuple[object, str], int]) -> None:
    """Add a :func:`recording_launches` record to the counts (one replay
    of the captured graph), under the lock."""
    with _COUNT_LOCK:
        for (wrapper, attr), n in record.items():
            setattr(wrapper, attr, getattr(wrapper, attr) + n)


def _counted_modules():
    from deepdfa_tpu_torch.graphs import segment
    from deepdfa_tpu_torch.ops import attention, fused_gnn, tile_spmm

    return fused_gnn, tile_spmm, attention, segment


def launch_counts() -> Dict[str, int]:
    """Kernel name -> launches since the last :func:`reset_launch_counts`,
    for every kernel module of the port."""
    counts: Dict[str, int] = {}
    for module in _counted_modules():
        counts.update(module.launch_counts())
    return counts


def reset_launch_counts() -> None:
    """Every kernel's launch count to 0."""
    for module in _counted_modules():
        module.reset_launch_counts()
