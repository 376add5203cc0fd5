"""Message-passing ops: host-side adjacency construction, the band SpMM
and the fused GNN step kernels (``fused_gnn``), the tile SpMM
(``tile_spmm``) and the flash-attention kernels (``attention``).

:func:`launch_counts` and :func:`reset_launch_counts` cover every kernel
of the port, by kernel name."""

from typing import Dict


def _counted_modules():
    from deepdfa_tpu_torch.ops import attention, fused_gnn, tile_spmm

    return fused_gnn, tile_spmm, attention


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
