"""Build and load the port's CUDA kernels.

Each source under ``deepdfa_tpu_torch/csrc/`` compiles with ``nvcc``
into a shared library with a plain C interface, loaded with ``ctypes``
(no PyTorch headers, so a build takes seconds, not minutes). The build
happens at first use, from the sources in the checkout only, into
``deepdfa_tpu_torch/_build/`` (git-ignored); a library is named by a
hash of its source and flags, so an edited source rebuilds and an
unchanged one loads as is. Nothing here runs at import time.
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
}
#: Headers every source may include; their text joins each library's hash.
HEADERS: Tuple[str, ...] = (os.path.join("csrc", "gated_step.cuh"),)

NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int

#: C signatures: library -> {function: argtypes}; every function returns
#: the launch's cudaError_t as an int.
SIGNATURES: Dict[str, Dict[str, List]] = {
    "fused_gnn": {
        # h, vals, vals_bf16, ek, eb, wi, bi, wh, bh, out,
        # n_rows, hidden, tile, n_tiles, bandwidth, stream
        "fused_step_launch": [_P, _P, _I, _P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _P],
        # h0, vals, vals_bf16, ek, eb, wi, bi, wh, bh, groups, n_groups,
        # max_group_rows, n_steps, out, hidden, tile, n_tiles, bandwidth,
        # stream
        "persistent_fwd_launch": [_P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _I,
                                  _I, _I, _P, _I, _I, _I, _I, _P],
        # the same arguments, hist in place of out
        "persistent_fwd_hist_launch": [_P, _P, _I, _P, _P, _P, _P, _P, _P,
                                       _P, _I, _I, _I, _P, _I, _I, _I, _I,
                                       _P],
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
    },
}

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
    for rel in (SOURCES[name], *HEADERS):
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
