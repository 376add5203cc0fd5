"""Where fused_step_kernel's time goes, phase by phase, on one NVIDIA GPU.

    python3 scripts/torch_step_phases.py [--out FILE]

Copies ``deepdfa_tpu_torch/csrc`` into the git-ignored build directory,
marks the forward's phases with ``clock64()`` in that copy (thread 0 of
each block: loading the tile's h, the aggregate, the edge linear, the
gate, each ending at the barrier that closes it), builds it with the
port's nvcc flags and runs it at the training shape (chip_smoke's
training batch, the published FlowGNN). Each block writes its cycle
counts over its own first output row, so the run's output is not a
step's; the unmarked library's time is printed beside the marked one.
Then reads the wide instance's SASS (``cuobjdump``): the FFMA share of
the hottest inner loop (the gate's k loop). Prints one JSON object: the
card's name and power limit, the medians and maxima of each phase over
the blocks in SM cycles, the kernel's ms marked and unmarked, the launch
geometry, ptxas's registers and spills for the wide instance, and the
loop's instruction mix. Needs one NVIDIA GPU and the CUDA toolkit.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from deepdfa_tpu_torch.ops import _build  # noqa: E402

F = cs.fused_gnn
# (anchor, replacement) pairs that mark fused_step_kernel's phases.
MARKS = (
    ("  const size_t off = static_cast<size_t>(r0) * H;\n"
     "  rows_to_shared(h_s, ld, h + off, R, H);\n  __syncthreads();\n",
     "  long long t0_ = clock64();\n"
     "  const size_t off = static_cast<size_t>(r0) * H;\n"
     "  rows_to_shared(h_s, ld, h + off, R, H);\n  __syncthreads();\n"
     "  long long t1_ = clock64();\n"),
    ("  if constexpr (kCS > 1) cg::this_cluster().sync();\n  const auto edge",
     "  if constexpr (kCS > 1) cg::this_cluster().sync();\n"
     "  long long t2_ = clock64(), t3_ = 0;\n  const auto edge"),
    ("    wide_rows_times<kGR>(t, a_s, R, ek, stages, edge);\n",
     "    wide_rows_times<kGR>(t, a_s, R, ek, stages, edge);\n"
     "    t3_ = clock64();\n"),
    ("    group_gate<true, kGR>(t, x_s, h_s, R, wi, wh, stages, gate);\n"
     "  }\n}\n",
     "    group_gate<true, kGR>(t, x_s, h_s, R, wi, wh, stages, gate);\n"
     "  }\n  long long t4_ = clock64();\n"
     "  if (threadIdx.x == 0 && rank == 0) {\n"
     "    dst[0] = float(t1_ - t0_);\n    dst[1] = float(t2_ - t1_);\n"
     "    dst[2] = float(t3_ - t2_);\n    dst[3] = float(t4_ - t3_);\n"
     "  }\n}\n"),
)
PHASES = ("load_h", "aggregate", "edge_linear", "gate")


def build_marked() -> tuple:
    """The marked library (ctypes) and nvcc's output for it."""
    work = os.path.join(_build.BUILD_DIR, "phases")
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(os.path.join(_build._PKG, "csrc"),
                    os.path.join(work, "csrc"))
    src = os.path.join(work, "csrc", "fused_gnn.cu")
    text = open(src).read()
    for anchor, marked in MARKS:
        if text.count(anchor) != 1:
            raise RuntimeError(f"fused_gnn.cu changed: no single {anchor!r}")
        text = text.replace(anchor, marked)
    open(src, "w").write(text)
    lib = os.path.join(work, "libfused_gnn_marked.so")
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", lib,
                           src], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(proc.stdout + proc.stderr)
    dll = ctypes.CDLL(lib)
    for fn, argtypes in _build.SIGNATURES["fused_gnn"].items():
        getattr(dll, fn).argtypes = argtypes
        getattr(dll, fn).restype = ctypes.c_int
    return dll, lib, proc.stdout + proc.stderr


# The mangled name of the wide f32 instance, fused_step_kernel<float, 1,
# 16, true>: the one the training shape launches.
WIDE = "fused_step_kernelIfLi1ELi16ELb1"


def wide_ptxas(log: str) -> str:
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and WIDE in line:
            return " ".join(x.strip() for x in lines[i + 1:i + 3])
    return ""


def gate_loop_mix(lib: str) -> dict:
    """Instruction counts of the innermost loop with the most FFMAs in the
    wide f32 instance (the gate's k loop)."""
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()),
                             "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    body, keep = [], False
    for line in sass.splitlines():
        if "Function :" in line:
            keep = WIDE in line
        elif keep:
            m = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                         r"([A-Z][A-Z0-9_.]*)(.*?);", line)
            if m:
                body.append((int(m.group(1), 16), m.group(2), m.group(3)))
    loops = []
    for addr, op, rest in body:
        m = re.search(r"0x([0-9a-f]+)", rest)
        if op.startswith("BRA") and m and int(m.group(1), 16) < addr:
            loops.append((int(m.group(1), 16), addr))
    inner = [(a, b) for a, b in loops
             if not any(a < c and d < b for c, d in loops)]
    best = collections.Counter()
    for a, b in inner:
        mix = collections.Counter(op for addr, op, _ in body if a <= addr <= b)
        if mix["FFMA"] > best["FFMA"]:
            best = mix
    total = sum(best.values())
    return {"instructions": total, "ffma": best["FFMA"],
            "ffma_share": best["FFMA"] / total if total else None,
            "top": best.most_common(8)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    dll, lib, log = build_marked()
    model = cs.FlowGNN(cs.FlowGNNConfig(message_impl="persistent"),
                       device="cuda", seed=cs.SEED)
    batch = cs._training_batch(model)
    adj = batch.band_adj
    with torch.no_grad():
        h = torch.cat([model.embeds[k](batch.node_feats[k])
                       for k in model.subkeys], dim=-1).contiguous()
        packed = [w.detach().contiguous()
                  for w in F.packed_weights(model.ggnn_step.step_params())]
    n, hidden = h.shape
    out = torch.empty_like(h)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    bf16 = int(adj.vals.dtype == torch.bfloat16)

    def marked():
        err = dll.fused_step_launch(
            F._ptr(h), F._ptr(adj.vals), bf16, *map(F._ptr, packed),
            F._ptr(out), n, hidden, adj.tile, adj.n_tiles, adj.bandwidth,
            stream)
        if err:
            raise RuntimeError(f"marked fused_step_kernel: cudaError_t {err}")

    geo = F.step_geometry(adj, hidden)
    marked_ms = cs._time_ms(marked)
    marked()
    torch.cuda.synchronize()
    cycles = out[::geo["row_tile"], :4].cpu()
    result = {
        "nvidia_smi": smi, "n_rows": n, "hidden": hidden,
        "band_dtype": str(adj.vals.dtype), "geometry": geo,
        "marked_ms": marked_ms,
        "kernel_ms": cs._time_ms(lambda: F.fused_gate_step(
            None, h, adj, packed=packed)),
        "cycles_median": {p: float(cycles[:, i].median())
                          for i, p in enumerate(PHASES)},
        "cycles_max": {p: float(cycles[:, i].max())
                       for i, p in enumerate(PHASES)},
        "ptxas_wide": wide_ptxas(log),
        "gate_loop": gate_loop_mix(lib),
    }
    text = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
