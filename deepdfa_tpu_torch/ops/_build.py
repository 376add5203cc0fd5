"""Build and load the port's CUDA kernels.

Each source under ``deepdfa_tpu_torch/csrc/`` compiles with ``nvcc``
into a shared library with a plain C interface, loaded with ``ctypes``
(no PyTorch headers, so a build takes seconds, not minutes). The build
happens at first use, from the sources in the checkout only, into
``deepdfa_tpu_torch/_build/`` (git-ignored); a library is named by a
hash of its source, the headers it includes and the flags, so an edited
source rebuilds and an unchanged one loads as is. Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "_build")

#: library name -> source path, relative to the package.
SOURCES: Dict[str, str] = {
    "fused_gnn": os.path.join("csrc", "fused_gnn.cu"),
    "fused_gnn_bwd": os.path.join("csrc", "fused_gnn_bwd.cu"),
    "flash_attn": os.path.join("csrc", "flash_attn.cu"),
    "flash_bwd_fused": os.path.join("csrc", "flash_bwd_fused.cu"),
    "tile_spmm": os.path.join("csrc", "tile_spmm.cu"),
}
#: library name -> the headers its source includes; their text joins
#: that library's hash (and no other's, so editing one header rebuilds
#: only the libraries that include it).
HEADERS: Dict[str, Tuple[str, ...]] = {
    "fused_gnn": (os.path.join("csrc", "gated_step.cuh"),
                  os.path.join("csrc", "group_step.cuh")),
    "fused_gnn_bwd": (os.path.join("csrc", "gated_step.cuh"),
                      os.path.join("csrc", "group_step.cuh"),
                      os.path.join("csrc", "tf32_mma.cuh")),
    "flash_attn": (os.path.join("csrc", "tf32_mma.cuh"),),
    "flash_bwd_fused": (os.path.join("csrc", "tf32_mma.cuh"),),
    "tile_spmm": (),
}

NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

#: C signatures: library -> {function: argtypes}; every function returns
#: the launch's cudaError_t as an int.
SIGNATURES: Dict[str, Dict[str, List]] = {
    "fused_gnn": {
        # h, vals, vals_bf16, ek, eb, wi, bi, wh, bh, out,
        # n_rows, hidden, tile, n_tiles, bandwidth, stream
        "fused_step_launch": [_P, _P, _I, _P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _P],
        # h0, vals, vals_bf16, ek, eb, wi, bi, wh, bh, groups, n_groups,
        # max_group_rows, n_steps, cluster, out, hidden, tile, n_tiles,
        # bandwidth, stream
        "persistent_fwd_launch": [_P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _I,
                                  _I, _I, _I, _P, _I, _I, _I, _I, _P],
        # the same arguments, hist in place of out
        "persistent_fwd_hist_launch": [_P, _P, _I, _P, _P, _P, _P, _P, _P,
                                       _P, _I, _I, _I, _I, _P, _I, _I, _I,
                                       _I, _P],
        # vals_bf16, max_group_rows, hidden, cluster, blocks, clusters
        # (int outs)
        "persistent_fwd_occupancy": [_I, _I, _I, _I, _P, _P],
        # vals_bf16, n_rows, hidden, row_tile, cluster, slab_rows, blocks,
        # blocks_per_sm, smem_bytes, sms (int outs)
        "fused_step_geometry": [_I, _I, _I, _P, _P, _P, _P, _P, _P, _P],
    },
    "fused_gnn_bwd": {
        # h, vals, tvals, vals_bf16, g, ek, eb, wi, bi, wh, bh, wiT, whT,
        # ekT, x, dp, dx, dhl, dmsg, dh, n_rows, hidden, tile, n_tiles,
        # bandwidth, stream
        "fused_step_bwd_launch": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P,
                                  _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                  _I, _I, _I, _I, _I, _P],
        # h0, hist, vals, tvals, vals_bf16, g, ek, eb, wi, bi, wh, bh, wiT,
        # whT, ekT, groups, n_groups, max_group_rows, n_steps, x, dp, dmsg,
        # dh, hidden, tile, n_tiles, bandwidth, stream
        "persistent_bwd_launch": [_P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P,
                                  _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P,
                                  _P, _I, _I, _I, _I, _P],
        # h0, hist, x, dp, dmsg, n_rows, hidden, n_steps, rows_per_split,
        # partial, dek, deb, dwi, dbi, dwh, dbh, stream
        "step_weight_grad_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P,
                                    _P, _P, _P, _P, _P, _P, _P],
        # vals_bf16, max_group_rows, hidden, blocks (int out)
        "persistent_bwd_occupancy": [_I, _I, _I, _P],
        # vals_bf16, n_rows, hidden, row_tile, slab_rows, blocks,
        # blocks_per_sm, blocks_per_sm_pass1, smem_bytes, smem_bytes_pass1,
        # sms (int outs)
        "fused_step_bwd_geometry": [_I, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                                    _P],
    },
    "flash_attn": {
        # q, k, v, mask, o, lse, B, H, tq, tk, causal, scale, stream
        "flash_fwd_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                             _P],
        # q, k, v, mask, dout, lse, delta, dq, B, H, tq, tk, causal, scale,
        # stream
        "flash_bwd_dq_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                _I, _I, _F, _P],
        # q, k, v, mask, dout, lse, delta, dk, dv, B, H, tq, tk, causal,
        # scale, stream
        "flash_bwd_dkv_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                 _I, _I, _I, _F, _P],
    },
    "flash_bwd_fused": {
        # q, k, v, mask, dout, lse, delta, dq_part, dq, dk, dv, B, H, tq,
        # tk, causal, scale, stream
        "flash_bwd_fused_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                   _P, _I, _I, _I, _I, _I, _F, _P],
    },
    "tile_spmm": {
        # ptr, src, val, msg, out, n_rows, hidden, stream
        "tile_spmm_launch": [_P, _P, _P, _P, _P, _I, _I, _P],
    },
}

# The bf16 instances of the flash kernels take the f32 ones' arguments
# (bf16 tensors where those take f32, lse, delta and the dq partials f32).
for _lib in ("flash_attn", "flash_bwd_fused"):
    SIGNATURES[_lib].update({
        fn.replace("_launch", "_bf16_launch"): argtypes
        for fn, argtypes in list(SIGNATURES[_lib].items())})

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
#: library -> (seconds spent building, or 0.0 when it was already built;
#: the compiler's output, with ptxas's register and shared-memory report).
BUILD_INFO: Dict[str, Tuple[float, str]] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def library_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for rel in (SOURCES[name], *HEADERS[name]):
        with open(os.path.join(_PKG, rel), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def build_all() -> Dict[str, Tuple[float, str]]:
    """Compile every library that is not built yet, one ``nvcc`` per
    source, all started together. Returns BUILD_INFO."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name, rel in SOURCES.items():
        path = library_path(name)
        if os.path.exists(path):
            BUILD_INFO.setdefault(name, (0.0, ""))
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(_PKG, rel)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path, time.perf_counter())
    failed = []
    for name, (proc, tmp, path, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, path)  # atomic: a concurrent loader sees all or none
        BUILD_INFO[name] = (time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return BUILD_INFO


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        if not os.path.exists(library_path(name)):
            build_all()
        lib = ctypes.CDLL(library_path(name))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[name] = lib
        return lib
