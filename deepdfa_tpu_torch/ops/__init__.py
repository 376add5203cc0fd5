"""Message-passing ops: host-side adjacency construction, the band SpMM
and the fused GNN step kernels (``fused_gnn``), the tile SpMM
(``tile_spmm``) and the flash-attention kernels (``attention``).

:func:`launch_counts` and :func:`reset_launch_counts` cover every kernel
of the port, by kernel name."""

from typing import Dict

#: The peak rates a kernel's operations bound divides by, as (name,
#: operations a second): NVIDIA's H100 SXM data sheet at the full 700 W.
#: f32 FMAs on the CUDA cores; and f32 work done as 3xTF32 on the tensor
#: cores (each product split into TF32 high and low parts, three TF32
#: products summed in f32: a third of the 495 TFLOP/s TF32 rate); and
#: a product of two bf16 operands with f32 sums on the tensor cores
#: (dense bf16, 989 TFLOP/s).
PEAK_F32_SIMT = ("f32 SIMT FMA, 67 TFLOP/s", 67e12)
PEAK_3XTF32 = ("3xTF32 tensor cores, 495/3 TFLOP/s", 495e12 / 3)
PEAK_BF16 = ("bf16 tensor cores, 989 TFLOP/s", 989e12)
#: The card's memory rate the bytes bound divides by (HBM3, 3.35 TB/s).
PEAK_BYTES_PER_S = 3.35e12


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
