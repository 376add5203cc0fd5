"""The C++ graph batcher (port of ``fill_batch`` from
``deepdfa_tpu/native/__init__.py``).

``src/batcher.cpp`` assembles a padded batch's arrays (features, vuln,
offset edges with self loops, node-to-graph map, masks) in one C pass.
It builds at first use, from the source in the checkout, with the host's
C++ compiler (``$CXX``, else ``g++``) into ``native/_build/``
(git-ignored), as a plain-C library named by a hash of the source, the
compiler and its flags, and loads with ``ctypes``; nothing builds at
import time. A failed build raises with the compiler's output: there is
no fallback to the Python batcher here (``batch_graphs(impl="python")``
is asked for by name).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Dict, Mapping, Optional, Sequence

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "src", "batcher.cpp")
BUILD_DIR = os.path.join(_DIR, "_build")
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-Wall")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _compiler() -> str:
    return os.environ.get("CXX", "g++")


def library_path() -> str:
    digest = hashlib.sha256(" ".join((_compiler(),) + CXXFLAGS).encode())
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"libbatcher_{digest.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library unless it is built; returns its path. Raises
    RuntimeError with the compiler's output when the build fails."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_compiler(), *CXXFLAGS, "-o", tmp, SOURCE]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except OSError as e:
        raise RuntimeError(f"native batcher build failed: {' '.join(cmd)}: "
                           f"{e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"native batcher build failed: {' '.join(cmd)}\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    return out


def load() -> ctypes.CDLL:
    """The loaded batcher library, built first if needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        i32 = ctypes.c_int32
        lib.batch_fill.restype = i32
        lib.batch_fill.argtypes = [
            i32, i32p, i32p, i32p, i32p, i32p, i32p, i32, i32, i32, i32,
            i32p, i32p, i32p, i32p, i32p, u8p, u8p]
        _lib = lib
        return _lib


def fill_batch(graphs: Sequence[Mapping], n_graphs: int, max_nodes: int,
               max_edges: int, subkeys: Sequence[str],
               add_self_loops: bool = True) -> Dict[str, np.ndarray]:
    """The padded batch arrays of ``graphs``, assembled natively: the
    contract of ``graphs/batch.py``'s Python loop, and its overflow
    ValueError word for word."""
    lib = load()
    num_nodes = np.array([int(g["num_nodes"]) for g in graphs], np.int32)
    num_edges = np.array([len(g["senders"]) for g in graphs], np.int32)

    def cat(key: str) -> np.ndarray:
        if not graphs:
            return np.zeros(0, np.int32)
        return np.ascontiguousarray(np.concatenate(
            [np.asarray(g[key], np.int32) for g in graphs]))

    senders_cat, receivers_cat, vuln_cat = (cat("senders"),
                                            cat("receivers"), cat("vuln"))
    total_nodes = int(num_nodes.sum())
    feats_cat = np.zeros((len(subkeys), total_nodes), np.int32)
    for ki, k in enumerate(subkeys):
        off = 0
        for g, n in zip(graphs, num_nodes.tolist()):
            feats_cat[ki, off: off + n] = np.asarray(g["feats"][k], np.int32)
            off += n

    out = {
        "feats": np.zeros((len(subkeys), max_nodes), np.int32),
        "vuln": np.zeros(max_nodes, np.int32),
        "senders": np.zeros(max_edges, np.int32),
        "receivers": np.zeros(max_edges, np.int32),
        "node_graph": np.zeros(max_nodes, np.int32),
        "node_mask": np.zeros(max_nodes, np.uint8),
        "edge_mask": np.zeros(max_edges, np.uint8),
    }
    rc = lib.batch_fill(
        len(graphs), num_nodes, num_edges, senders_cat, receivers_cat,
        vuln_cat, feats_cat, len(subkeys), int(add_self_loops), max_nodes,
        max_edges, out["feats"], out["vuln"], out["senders"],
        out["receivers"], out["node_graph"], out["node_mask"],
        out["edge_mask"])
    if rc < 0:
        gi = -rc - 1
        loops = num_nodes if add_self_loops else np.zeros_like(num_nodes)
        node_off = int(num_nodes[:gi].sum())
        edge_off = int((num_edges[:gi] + loops[:gi]).sum())
        e = int(num_edges[gi]) + int(loops[gi])
        raise ValueError(
            f"graph {gi} overflows budget "
            f"(nodes {node_off}+{num_nodes[gi]}/{max_nodes}, "
            f"edges {edge_off}+{e}/{max_edges})")
    return out
