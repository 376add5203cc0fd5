"""Time layouts of the bf16 GNN forward kernels on one card.

    python3 scripts/torch_gnn_fwd_bf16_layouts.py [--out FILE] [--ablations]

The layout of ``fused_step_kernel_bf16`` and ``persistent_fwd_kernel_bf16``
(with its hist instance) is three constants of ``csrc/fused_gnn.cu``:
``kFwdRingStages`` (the weight ring's stages, mirrored by
``GNN_BF16_FWD_RING_STAGES`` in ``ops/fused_gnn.py``), ``kFwdStepBlocks``
and ``kFwdPersistBlocks`` (the blocks an SM of the per-step passes' and
the sweep's ``__launch_bounds__``). For
each layout in ``LAYOUTS`` this copies ``chip_smoke.py`` and the package
(without its builds) into ``.checkouts/gnn_fwd_layouts/<name>``
(git-ignored), sets the constants there and, in a process of its own from
that copy, builds the GNN library, reports ptxas's registers and spills
for the two kernels' instances, and at chip_smoke's serving bucket (N
1024) and training batch (N 16384, H 128, bf16 band values, h the seeded
model's embeddings rounded) holds the per-step kernel to its plain
version (chip_smoke's ``GNN_BF16_STEP_TOL``) and the 5-step sweep to its
plain version (``GNN_BF16_UNROLL_TOL``) and bit for bit to the scan of the
per-step kernel, counts the elements apart from the plain versions, and
times both with CUDA events beside their bounds, with their shared memory
and blocks an SM, and the per-step kernel's two passes by
``torch.profiler``. The layout the sources keep (a copy too) runs first
and last, so a drift of the card over the call shows.

``--ablations`` also times copies of the kept layout with parts cut out
(``ABLATIONS``: no sum taken from the reference's chain, no test for a
near midpoint either, no weight slabs' loads); their outputs are not the
kept kernels', so they are timed only, not checked. Prints one JSON object
with the card's name and power limit. Needs one NVIDIA GPU; about a
minute a copy with its build.
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
SOURCE = os.path.join(CSRC, "fused_gnn.cu")
HEADER = os.path.join(CSRC, "gnn_bf16_mma.cuh")
#: The constants, in LAYOUTS' order, all in SOURCE.
CONSTANTS = ("kFwdRingStages", "kFwdStepBlocks", "kFwdPersistBlocks")
MIRROR = (os.path.join("deepdfa_tpu_torch", "ops", "fused_gnn.py"),
          "GNN_BF16_FWD_RING_STAGES")
#: layout name -> (kFwdRingStages, kFwdStepBlocks, kFwdPersistBlocks).
LAYOUTS = {
    "sweep_2_blocks": (2, 2, 2),
    "ring_1": (1, 2, 1),
    "ring_3": (3, 2, 1),
    "step_1_block": (2, 1, 1),
}
KERNELS = ("fused_step_kernel_bf16", "persistent_fwd_kernel_bf16")
#: ablation -> the edits (file, old, new) to a copy of the kept sources;
#: timing only.
_NO_CHAINS = (SOURCE, "constexpr float kNear = 16.0f / 16777216.0f;",
              "constexpr float kNear = 0.0f;  // ablation")
_NO_TESTS = (SOURCE, "  return (u & 0xffffu) != (u >> 16);",
             "  return false && u == 0u;  // ablation")
_STAGE = "  __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(stage);\n"
_NO_LOADS = (HEADER, _STAGE, _STAGE + "  if (H > 0) return;  // ablation\n")
# The sweep's phases, each cut out of its step (timing the sweep alone).
_SWEEP_MSG = ("    step_messages<kRoundMsg, true>(R, H, hb, nh, cn, a, "
              "stages, pending,\n")
_SWEEP_AGG = "    group_aggregate(vals, a.tile, a.n_tiles, a.bw,"
_SWEEP_GATE = ("    step_gate<true>(R, H, xb, hb, nx, nh, cn, a, stages, "
               "pending,\n")
_cut = lambda text: (SOURCE, text, "    if (R < 0)" + text[3:])
ABLATIONS = {"no_chains": (_NO_CHAINS,), "no_tests": (_NO_TESTS,),
             "no_weight_loads": (_NO_TESTS, _NO_LOADS),
             "sweep_no_messages": (_cut(_SWEEP_MSG),),
             "sweep_no_aggregate": (_cut(_SWEEP_AGG),),
             "sweep_no_gate": (_cut(_SWEEP_GATE),)}

CHILD = r"""
import dataclasses, json, re, torch
from torch.profiler import profile, ProfilerActivity
import chip_smoke as cs
from deepdfa_tpu_torch.ops import _build, fused_gnn as F
_build.SOURCES = {"fused_gnn": _build.SOURCES["fused_gnn"]}
info = _build.build_all()
out = {"ptxas": {}}
current = None
for line in info["fused_gnn"][1].splitlines():
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
hidden, k = model.config.ggnn_hidden, model.config.n_steps
p32 = [w.detach().contiguous()
       for w in F.packed_weights(model.ggnn_step.step_params())]
check = %(check)r


def apart(got, want):
    return int((got.float() != want.float()).sum())


for shape, batch in (("serving", cs._serving_batch(model)),
                     ("training", cs._training_batch(model))):
    adj = batch.band_adj
    h = torch.cat([model.embeds[s](batch.node_feats[s])
                   for s in model.subkeys], dim=-1).bfloat16().contiguous()
    rec = {}
    name = "fused_step_kernel_bf16"
    step = lambda: F.fused_gate_step(None, h, adj, p32)
    got = step()
    plain = F.fused_step_reference(model.ggnn_step.step_params(), h, adj)
    if check:
        cs._check(name, got.float(), plain.float(), cs.GNN_BF16_STEP_TOL)
        cs._same_bits(name + " twice", [step()], [got])
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            step()
        torch.cuda.synchronize()
    passes = {e.key.split(name + "<")[1].split(">")[0]: e.device_time_total
              / e.count / 1e3 for e in prof.key_averages()
              if name + "<" in e.key and e.count}
    rec[name] = dict(elements_apart=apart(got, plain),
                     ms=cs._time_ms(step, 20, 5), pass_ms=passes,
                     bound_ms=cs._bound(F.kernel_cost(adj, hidden, 1,
                                                      name))[0],
                     geometry=F.step_geometry(adj, hidden, name))
    name = "persistent_fwd_kernel_bf16"
    sweep = lambda: F.persistent_unroll(None, h, adj, k, p32)
    got = sweep()
    plain = F.persistent_reference(model.ggnn_step.step_params(), h, adj, k)
    if check:
        cs._check(name, got.float(), plain.float(), cs.GNN_BF16_UNROLL_TOL)
        scan = h
        for _ in range(k):
            scan = F.fused_gate_step(None, scan, adj, p32)
        cs._same_bits(name + " vs the per-step scan", [got], [scan])
        cs._same_bits(name + " twice", [sweep()], [got])
    rec[name] = dict(elements_apart=apart(got, plain), scan_bits_equal=check,
                     ms=cs._time_ms(sweep, 10, 5),
                     bound_ms=cs._bound(F.kernel_cost(adj, hidden, k,
                                                      name))[0],
                     max_group_rows=adj.max_group_rows,
                     **F.persistent_occupancy(adj, hidden, name))
    out[shape] = rec
print("LAYOUT " + json.dumps(out))
"""


def read_kept() -> tuple:
    with open(os.path.join(ROOT, SOURCE)) as f:
        text = f.read()
    return tuple(int(re.search(rf"^constexpr int {c} = (\d+);", text,
                               re.M).group(1)) for c in CONSTANTS)


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
    dst = os.path.join(ROOT, ".checkouts", "gnn_fwd_layouts", name)
    if os.path.isdir(dst):
        return dst
    os.makedirs(dst)
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), dst)
    shutil.copytree(os.path.join(ROOT, "deepdfa_tpu_torch"),
                    os.path.join(dst, "deepdfa_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    if layout is not None:
        for const, value in zip(CONSTANTS, layout):
            set_constant(os.path.join(dst, SOURCE),
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
        cwd=checkout, capture_output=True, text=True, timeout=900)
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
    ap.add_argument("--layouts", nargs="+", default=None, metavar="NAME",
                    help="these of LAYOUTS only")
    ap.add_argument("--only-ablations", nargs="*", default=None,
                    metavar="NAME",
                    help="the kept layout and these ablations (none named: "
                         "all), no other layout")
    args = ap.parse_args()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    kept = read_kept()
    only = args.only_ablations
    layouts = ({n: LAYOUTS[n] for n in args.layouts} if args.layouts
               else {} if only is not None else LAYOUTS)
    order = ([("kept", None)] + list(layouts.items()) + [("kept", None)])
    shutil.rmtree(os.path.join(ROOT, ".checkouts", "gnn_fwd_layouts"),
                  ignore_errors=True)
    runs = []
    for name, layout in order:
        runs.append({"layout": name,
                     "constants": dict(zip(CONSTANTS, layout or kept)),
                     **run(copy_with(name, layout))})
    ablations = ({n: ABLATIONS[n] for n in only or ABLATIONS}
                 if only is not None else ABLATIONS if args.ablations
                 else {})
    for name, edits in ablations.items():
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
