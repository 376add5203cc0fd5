"""Time layouts of the bf16 GNN backward kernels on one card.

    python3 scripts/torch_gnn_bwd_bf16_layouts.py [--out FILE] [--ablations]

The layout of ``fused_step_bwd_kernel_bf16`` and
``persistent_bwd_kernel_bf16`` is three constants: ``kRingStages`` (the
weight ring's stages, ``csrc/gnn_bf16_mma.cuh``, mirrored by
``GNN_BF16_RING_STAGES`` in ``ops/fused_gnn.py``), ``kStepBf16Blocks`` and
``kPersistBf16Blocks`` (the per-step passes' and the sweep's blocks an
SM, their ``__launch_bounds__``, ``csrc/fused_gnn_bwd.cu``). For each
layout in ``LAYOUTS`` this copies ``chip_smoke.py`` and the package
(without its builds) into ``.checkouts/gnn_layouts/<name>`` (git-ignored),
sets the constants there and, in a process of its own from that copy,
builds the two GNN libraries, reports ptxas's registers and spills for
the two kernels' instances, and at chip_smoke's training batch (N 16384,
H 128, bf16 band values, h the seeded model's embeddings rounded, a
seeded bf16 cotangent) holds each kernel's outputs to its plain version
(chip_smoke's ``GNN_BF16_BWD_*`` rule for one step, ``GNN_BF16_SWEEP_TOL``
for the 5-step sweep), the sweep bit for bit to the reverse scan of the
per-step kernel, and times both with CUDA events beside their bounds,
with their shared memory and blocks an SM, and the per-step kernel's
three passes by ``torch.profiler``; the same for each of ``VARIANTS``,
copies of the kept layout with an edit to the sources (the per-step
kernel's pass 1 computing its own rows' messages). The layout the sources
keep (a copy too) runs first and last, so a drift of the card over the
call shows.

``--ablations`` also times copies of the kept layout with parts of the
products cut out of ``csrc/gnn_bf16_mma.cuh`` (``ABLATIONS``: the mma
loop, the weight slabs' loads, both), for where the time goes; their
outputs are wrong, so they are timed only, not checked. Prints one JSON
object with the card's name and power limit. Needs one NVIDIA GPU; about
1.5 minutes a copy with its build.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join("deepdfa_tpu_torch", "csrc")
#: file -> the constants it holds, in LAYOUTS' order.
CONSTANTS = ((os.path.join(CSRC, "gnn_bf16_mma.cuh"), "kRingStages"),
             (os.path.join(CSRC, "fused_gnn_bwd.cu"), "kStepBf16Blocks"),
             (os.path.join(CSRC, "fused_gnn_bwd.cu"), "kPersistBf16Blocks"))
MIRROR = (os.path.join("deepdfa_tpu_torch", "ops", "fused_gnn.py"),
          "GNN_BF16_RING_STAGES")
#: layout name -> (kRingStages, kStepBf16Blocks, kPersistBf16Blocks).
LAYOUTS = {
    # Two stages: the sweep one block an SM (137,920 bytes at 48 rows).
    "ring_2_sweep_1_block": (2, 2, 1),
    # Three stages: one block an SM everywhere.
    "ring_3_one_block": (3, 1, 1),
}
KERNELS = ("fused_step_bwd_kernel_bf16", "persistent_bwd_kernel_bf16")
HEADER = os.path.join(CSRC, "gnn_bf16_mma.cuh")
SOURCE = os.path.join(CSRC, "fused_gnn_bwd.cu")
#: variant -> the edits (file, old, new) to a copy of the kept sources;
#: checked as the layouts are. fold_pass0: the per-step kernel's pass 1
#: computes its own rows' messages (the same product as pass 0, so the
#: same bits) instead of reading them back; pass 0 still writes every
#: row's, since the tiles' halos need them.
VARIANTS = {"fold_pass0": ((
    SOURCE, "    tile_in(mt, msg + off, R, H);\n    __syncthreads();\n",
    "    __syncthreads();\n"
    "    messages(R, H, hb, a.ek, a.eb, kRoundMsg, stages,\n"
    "             [&](int r, int c, const float(&m)[2]) {\n"
    "               put2(mt + r * ld + c, m[0], m[1]);\n"
    "             });\n"),)}
#: ablation -> the edits to a copy of the kept sources; timing only.
_NO_MMA = (HEADER, "          if (!active) return;\n",
           "          if (active || !active) return;  // ablation\n")
_STAGE = "  __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(stage);\n"
_NO_LOADS = (HEADER, _STAGE, _STAGE + "  if (H > 0) return;  // ablation\n")
ABLATIONS = {"no_products": (_NO_MMA,), "no_weight_loads": (_NO_LOADS,),
             "neither": (_NO_MMA, _NO_LOADS)}

CHILD = r"""
import json, re, torch
from torch.profiler import profile, ProfilerActivity
import chip_smoke as cs
from deepdfa_tpu_torch.ops import _build, fused_gnn as F
_build.SOURCES = {n: _build.SOURCES[n] for n in ("fused_gnn",
                                                 "fused_gnn_bwd")}
info = _build.build_all()
out = {"ptxas": {}}
current = None
for line in info["fused_gnn_bwd"][1].splitlines():
    if "Compiling entry function" in line:
        current = None
        for n in %(kernels)r:
            m = re.search(r"\d" + n + r"(I\w*?EE|E)", line)
            if m:
                current = n + m.group(1)
    if current and ("registers" in line or "spill" in line):
        out["ptxas"].setdefault(current, []).append(line.strip())
torch.set_grad_enabled(False)
cs._full_f32()
model = cs.FlowGNN(cs.FlowGNNConfig(message_impl="persistent"),
                   device="cuda", seed=cs.SEED)
batch = cs._training_batch(model)
adj, hidden, k = batch.band_adj, model.config.ggnn_hidden, model.config.n_steps
p32 = [w.detach().contiguous()
       for w in F.packed_weights(model.ggnn_step.step_params())]
h = torch.cat([model.embeds[s](batch.node_feats[s])
               for s in model.subkeys], dim=-1).bfloat16().contiguous()
gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
g = torch.randn(h.shape, generator=gen, device="cuda").bfloat16()
check = %(check)r
name = "fused_step_bwd_kernel_bf16"
rows = lambda: F.fused_step_bwd_rows(None, h, adj, g, p32)
got = rows()
outputs = {key: cs._check_bf16_bwd(name + key, a, b) for key, a, b in zip(
    ("dh", "x", "dp", "dmsg"), got,
    F.fused_step_bwd_rows_reference(None, h, adj, g, p32))} if check else None
if check:
    cs._same_bits(name + " twice", rows(), got)
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for _ in range(10):
        rows()
    torch.cuda.synchronize()
passes = {e.key.split(name + "<")[1].split(">")[0]: e.device_time_total
          / e.count / 1e3 for e in prof.key_averages()
          if name + "<" in e.key and e.count}
out[name] = dict(outputs=outputs, ms=cs._time_ms(rows, 10, 5),
                 pass_ms=passes,
                 bound_ms=cs._bound(F.kernel_cost(adj, hidden, 1, name))[0],
                 geometry=F.step_geometry(adj, hidden, name))
name = "persistent_bwd_kernel_bf16"
states = [h]
for _ in range(k - 1):
    states.append(F.fused_gate_step(None, states[-1], adj, packed=p32))
hist = torch.stack(states[1:]).contiguous()
sweep = lambda: F.persistent_bwd_rows(None, h, hist, adj, g, k, p32)
got = sweep()
tol = (cs.GNN_BF16_SWEEP_TOL, cs.GNN_BF16_SWEEP_TOL)
outputs = None
if check:
    outputs = {key: cs._check_bf16_bwd(name + key, a, b, *tol)
               for key, a, b in zip(("dh", "x", "dp", "dmsg"), got,
                                    F.persistent_bwd_rows_reference(
                                        None, h, hist, adj, g, k, p32))}
    gs, scan = g, [None] * k
    for s in reversed(range(k)):
        gs, *scan[s] = F.fused_step_bwd_rows(None, states[s], adj, gs, p32)
    cs._same_bits(name + " vs the per-step scan",
                  [gs] + [c[j] for j in range(3) for c in scan],
                  [got[0]] + [t for c in got[1:] for t in c.unbind(0)])
    cs._same_bits(name + " twice", sweep(), got)
out[name] = dict(outputs=outputs, scan_bits_equal=check,
                 ms=cs._time_ms(sweep, 5, 5),
                 bound_ms=cs._bound(F.kernel_cost(adj, hidden, k, name))[0],
                 max_group_rows=adj.max_group_rows,
                 **F.persistent_occupancy(adj, hidden, name))
print("LAYOUT " + json.dumps(out))
"""


def read_kept() -> tuple:
    values = []
    for path, const in CONSTANTS:
        with open(os.path.join(ROOT, path)) as f:
            values.append(int(re.search(rf"^constexpr int {const} = (\d+);",
                                        f.read(), re.M).group(1)))
    return tuple(values)


def set_constant(path: str, pattern: str, value: int) -> None:
    with open(path) as f:
        text = f.read()
    text, n = re.subn(pattern, lambda m: m.group(1) + str(value), text,
                      flags=re.M)
    if n != 1:
        raise RuntimeError(f"{path}: no single match of {pattern}")
    with open(path, "w") as f:
        f.write(text)


def copy_with(name: str, layout, edits=()) -> str:
    """A copy of this checkout with the constants set to ``layout``
    (None: the sources' own) and ``edits`` made to its sources."""
    dst = os.path.join(ROOT, ".checkouts", "gnn_layouts", name)
    if os.path.isdir(dst):
        return dst
    os.makedirs(dst)
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), dst)
    shutil.copytree(os.path.join(ROOT, "deepdfa_tpu_torch"),
                    os.path.join(dst, "deepdfa_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    if layout is not None:
        for (path, const), value in zip(CONSTANTS, layout):
            set_constant(os.path.join(dst, path),
                         rf"^(constexpr int {const} = )\d+", value)
        set_constant(os.path.join(dst, MIRROR[0]),
                     rf"^({MIRROR[1]} = )\d+", layout[0])
    for source, old, new in edits:
        path = os.path.join(dst, source)
        with open(path) as f:
            text = f.read()
        if text.count(old) != 1:
            raise RuntimeError(f"{source}: no single {old!r}")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    return dst


def run(checkout: str, check: bool = True) -> dict:
    proc = subprocess.run(
        [sys.executable, "-c", CHILD % {"kernels": KERNELS, "check": check}],
        cwd=checkout,
        capture_output=True, text=True, timeout=900)
    lines = [line for line in proc.stdout.splitlines()
             if line.startswith("LAYOUT ")]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"{checkout}: exit {proc.returncode}\n"
                           f"{proc.stderr[-4000:]}")
    return json.loads(lines[-1][len("LAYOUT "):])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write the JSON object to this file")
    ap.add_argument("--ablations", action="store_true",
                    help="also time the kept layout with parts cut out")
    args = ap.parse_args()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    kept = read_kept()
    order = ([("kept", None, ())] + [(n, v, ()) for n, v in LAYOUTS.items()]
             + [(n, None, e) for n, e in VARIANTS.items()]
             + [("kept", None, ())])
    shutil.rmtree(os.path.join(ROOT, ".checkouts", "gnn_layouts"),
                  ignore_errors=True)
    runs = []
    for name, layout, edits in order:
        consts = dict(zip((c for _, c in CONSTANTS), layout or kept))
        runs.append({"layout": name, "constants": consts,
                     **run(copy_with(name, layout, edits))})
    for name, edits in (ABLATIONS.items() if args.ablations else ()):
        runs.append({"layout": "kept", "ablation": name,
                     **run(copy_with(name, None, edits), check=False)})
    text = json.dumps({"nvidia_smi": smi, "runs": runs})
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
