"""Time layouts of the bf16 weight pass and the bf16 tile product on one
card.

    python3 scripts/torch_wgrad_bf16_layouts.py [--out FILE] [--ablations]
        [--layouts NAME ..] [--only-ablations NAME ..]

The layout of ``step_weight_grad_kernel_bf16`` is four constants of
``csrc/fused_gnn_bwd.cu``: ``kW16Slab`` (rows a slab), ``kW16Stages`` and
``kW16SplitStages`` (the ``cp.async`` ring's slab stages, with bf16 and
with f32 messages), ``kW16Blocks`` (blocks an SM, its
``__launch_bounds__``), mirrored by ``WGRAD_BF16_SLAB_ROWS``,
``WGRAD_BF16_STAGES``, ``WGRAD_BF16_SPLIT_STAGES`` and
``WGRAD_BF16_BLOCKS`` in ``ops/fused_gnn.py``; and the split sizing,
``WGRAD_BF16_FILL_BLOCKS`` there (the blocks one step's tiles fill). The
tile product's is ``kRowSets`` and ``kBf16Threads`` in
``csrc/tile_spmm.cu`` (row sets a warp takes, threads a block). For
each layout in ``LAYOUTS`` (``TILE_LAYOUTS``) this copies
``chip_smoke.py`` and the package (without its builds) into
``.checkouts/wgrad_layouts/<name>`` (git-ignored), sets the constants
there and, in a process of its own from that copy, builds the one library
it needs, reports ptxas's registers and spills, and times the kernel with
CUDA events:

- the weight pass on seeded cotangents of the training shape (N 16384,
  H 128, 5 steps: h and x bf16, dp and dmsg f32), bf16 and f32 messages:
  held to its plain version (``GRAD_TOL`` of each gradient's largest
  entry), the 5-step call bit for bit the fold of 5 one-step calls and its
  own second launch; the 5-step call and the one-step call (the fused
  lane's), each beside its bound, and pass 1 apart from the shared fold
  ``step_weight_grad_reduce_kernel`` by ``torch.profiler``; the
  instance's blocks an SM and shared memory;
- the tile product over A and A^T on the tile lane's training lists and a
  seeded bf16 msg, bit for bit its plain version on the CPU, beside its
  bound.

The layout the sources keep (a copy too) runs first and last, so a drift
of the card over the call shows. ``--ablations`` also times copies of the
kept layout with parts of the weight pass cut out (``ABLATIONS``: the
products, R's rounding pass, the slabs' loads, the fold's launch), for
where the time goes, and a copy of the tile product that launches its
grid and returns (``TILE_ABLATIONS``); their outputs are wrong, so they
are timed only.
Prints one JSON object with the card's name and power limit. Needs one
NVIDIA GPU; about a minute a weight-pass copy with its build, seconds a
tile copy.
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
SOURCE = os.path.join(CSRC, "fused_gnn_bwd.cu")
TILE_SOURCE = os.path.join(CSRC, "tile_spmm.cu")
MIRRORS = os.path.join("deepdfa_tpu_torch", "ops", "fused_gnn.py")
#: the weight pass's constants (in SOURCE) and their mirrors, in LAYOUTS'
#: order; the last value of a layout is WGRAD_BF16_FILL_BLOCKS.
CONSTANTS = (("kW16Slab", "WGRAD_BF16_SLAB_ROWS"),
             ("kW16Stages", "WGRAD_BF16_STAGES"),
             ("kW16SplitStages", "WGRAD_BF16_SPLIT_STAGES"),
             ("kW16Blocks", "WGRAD_BF16_BLOCKS"))
#: layout -> (kW16Slab, kW16Stages, kW16SplitStages, kW16Blocks, fill).
LAYOUTS = {
    # Splits to fill the 264 resident blocks: 37 a step, twice the
    # partials.
    "fill_264": (32, 3, 2, 2, 264),
    # One slab ahead.
    "stages_2": (32, 2, 2, 2, 132),
    # 64-row slabs, two ahead, one block an SM (185,344 bytes).
    "slab_64": (64, 3, 2, 1, 132),
    # 64-row slabs, one ahead, one block an SM (135,168 bytes).
    "slab_64_stages_2": (64, 2, 2, 1, 132),
    # 32-row slabs, three ahead at one block an SM (117,760 bytes).
    "slab_32_stages_4": (32, 4, 2, 1, 132),
    # Three blocks an SM, one slab ahead (67,584 bytes; 85 registers).
    "three_blocks": (32, 2, 2, 3, 132),
}
#: tile layout -> (kRowSets, kBf16Threads).
TILE_LAYOUTS = {"row_sets_2": (2, 256), "threads_128": (1, 128),
                "threads_512": (1, 512), "threads_1024": (1, 1024)}
#: ablation -> the edits (file, old, new) to a copy of the kept sources;
#: timing only.
_LOOP = "    products(i % kS, i & 1);\n"
ABLATIONS = {
    "no_products": ((SOURCE, _LOOP, "    if (n_rows < 0) " + _LOOP[4:]),),
    "no_rounding": ((SOURCE, "    convert(i % kS, i & 1);\n",
                     "    if (n_rows < 0) convert(i % kS, i & 1);\n"),),
    "no_loads": ((SOURCE, "    if (i < n_slabs) issue(i, i);\n",
                  "    if (n_rows < 0) issue(i, i);\n"),
                 (SOURCE, "    if (i + kS - 1 < n_slabs) issue(",
                  "    if (n_rows < 0) issue(")),
    "no_fold": ((SOURCE, "  if (e != 0) return e;\n  const long long n_out",
                 "  if (e != 0 || n_rows > 0) return e;  // ablation\n"
                 "  const long long n_out"),),
}
#: the tile product's ablation: every warp returns at once (the launch of
#: its grid alone); timing only.
TILE_ABLATIONS = {"launch_only": ((
    TILE_SOURCE, "  if (w0 >= n_rows) return;  // the whole warp",
    "  if (w0 >= 0) return;  // ablation"),)}

CHILD = r"""
import json, re, torch
from torch.profiler import profile, ProfilerActivity
import chip_smoke as cs
from deepdfa_tpu_torch.ops import _build, fused_gnn as F, tile_spmm as T
which, check, fill = %(which)r, %(check)r, %(fill)r
lib = "fused_gnn_bwd" if which == "wgrad" else "tile_spmm"
_build.SOURCES = {lib: _build.SOURCES[lib]}
info = _build.build_all()
out = {"ptxas": [l.strip() for l in info[lib][1].splitlines()
                 if "registers" in l or "spill" in l or "Compiling" in l]}
torch.set_grad_enabled(False)
cs._full_f32()
gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
rand = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
if which == "wgrad":
    if fill:
        F.WGRAD_BF16_FILL_BLOCKS = fill
    n, hid, k = 16384, 128, 5
    h0, hist, x = rand(n, hid).bfloat16(), rand(k - 1, n, hid).bfloat16(), \
        rand(k, n, hid).bfloat16()
    dp, dmsg = rand(k, n, 4 * hid) * 1e-2, rand(k, n, hid)
    name = "step_weight_grad_kernel_bf16"
    adj = cs._training_batch(cs.FlowGNN(cs.FlowGNNConfig(
        message_impl="fused"), device="cpu"), device="cpu").band_adj
    for mdt in (torch.bfloat16, torch.float32):
        key = "bf16_msg" if mdt == torch.bfloat16 else "f32_msg"
        call = lambda: F.step_weight_grads(h0, hist, x, dp, dmsg, k, mdt)
        one = lambda: F.step_weight_grads(h0, None, x[:1], dp[:1],
                                          dmsg[:1], 1, mdt)
        rec = dict(F.wgrad_bf16_geometry(mdt == torch.bfloat16),
                   rows_per_split=F.wgrad_bf16_rows_per_split(n, hid))
        if check:
            got = call()
            rec["max_rel_err"] = cs._check_grads(
                key, got, F.step_weight_grad_reference(
                    h0, hist, x, dp, dmsg, k, mdt))[1]
            fold = None
            for s in reversed(range(k)):
                hs = (h0 if s == 0 else hist[s - 1]).contiguous()
                o = F.step_weight_grads(hs, None, x[s:s + 1], dp[s:s + 1],
                                        dmsg[s:s + 1], 1, mdt)
                fold = o if fold is None else tuple(
                    a + b for a, b in zip(fold, o))
            cs._same_bits(key + " fold", got, fold)
            cs._same_bits(key + " twice", call(), got)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                call()
            torch.cuda.synchronize()
        rec["pass_ms"] = {e.key[:60]: e.device_time_total / e.count / 1e3
                          for e in prof.key_averages()
                          if "step_weight_grad" in e.key and e.count}
        rec.update(ms=cs._time_ms(call, 10, 5),
                   one_step_ms=cs._time_ms(one, 10, 5),
                   bound_ms=cs._bound(F.kernel_cost(adj, hid, k, name))[0],
                   one_step_bound_ms=cs._bound(
                       F.kernel_cost(adj, hid, 1, name))[0])
        out[key] = rec
else:
    lists_cpu = cs._training_batch(cs.FlowGNN(cs.FlowGNNConfig(
        message_impl="tile"), device="cpu"), device="cpu").tile_adj
    lists = lists_cpu.to("cuda")
    msg = rand(lists.n_rows, 128).bfloat16()
    for over, a, a_cpu in (("A", lists, lists_cpu),
                           ("A^T", lists.transposed(),
                            lists_cpu.transposed())):
        run = lambda: T.tile_spmm(a, msg)
        if check:
            cs._same_bits(over, [run().cpu()],
                          [T.tile_spmm_reference(a_cpu, msg.cpu())])
        out[over] = dict(ms=cs._time_ms(run), bound_ms=cs._bound(
            T.kernel_cost(lists, 128, transposed=over == "A^T",
                          dtype=torch.bfloat16))[0])
print("LAYOUT " + json.dumps(out))
"""


def read_kept() -> tuple:
    with open(os.path.join(ROOT, SOURCE)) as f:
        text = f.read()
    values = [int(re.search(rf"^constexpr int {const} = (\d+);", text,
                            re.M).group(1)) for const, _ in CONSTANTS]
    with open(os.path.join(ROOT, MIRRORS)) as f:
        fill = re.search(r"^WGRAD_BF16_FILL_BLOCKS = (.+)$", f.read(), re.M)
    return tuple(values) + (fill.group(1).strip(),)


def set_constant(path: str, pattern: str, value) -> None:
    with open(path) as f:
        text = f.read()
    text, n = re.subn(pattern, lambda m: m.group(1) + str(value), text,
                      flags=re.M)
    if n != 1:
        raise RuntimeError(f"{path}: no single match of {pattern}")
    with open(path, "w") as f:
        f.write(text)


def copy_with(name: str, layout=None, row_sets=None, edits=()) -> str:
    """A copy of this checkout with the weight pass's constants set to
    ``layout``, the tile product's ``kRowSets`` and ``kBf16Threads`` to
    ``row_sets`` (None: the sources' own) and ``edits`` made to its
    sources."""
    dst = os.path.join(ROOT, ".checkouts", "wgrad_layouts", name)
    if os.path.isdir(dst):
        return dst
    os.makedirs(dst)
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), dst)
    shutil.copytree(os.path.join(ROOT, "deepdfa_tpu_torch"),
                    os.path.join(dst, "deepdfa_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    if layout is not None:
        for (const, mirror), value in zip(CONSTANTS, layout):
            set_constant(os.path.join(dst, SOURCE),
                         rf"^(constexpr int {const} = )\d+", value)
            set_constant(os.path.join(dst, MIRRORS), rf"^({mirror} = )\d+",
                         value)
    if row_sets is not None:
        for const, value in zip(("kRowSets", "kBf16Threads"), row_sets):
            set_constant(os.path.join(dst, TILE_SOURCE),
                         rf"^(constexpr int {const} = )\d+", value)
    for source, old, new in edits:
        path = os.path.join(dst, source)
        with open(path) as f:
            text = f.read()
        if text.count(old) != 1:
            raise RuntimeError(f"{source}: no single {old!r}")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    return dst


def run(checkout: str, which: str, check: bool = True, fill=None) -> dict:
    proc = subprocess.run(
        [sys.executable, "-c",
         CHILD % {"which": which, "check": check, "fill": fill}],
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
    ap.add_argument("--layouts", nargs="*", default=None,
                    help="only these of LAYOUTS and TILE_LAYOUTS (a kernel "
                         "none of them names is skipped)")
    ap.add_argument("--only-ablations", nargs="*", default=None,
                    help="only these of ABLATIONS (implies --ablations)")
    args = ap.parse_args()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    kept = read_kept()
    pick = lambda names: [n for n in names
                          if args.layouts is None or n in args.layouts]
    shutil.rmtree(os.path.join(ROOT, ".checkouts", "wgrad_layouts"),
                  ignore_errors=True)
    runs = []
    for which in ("wgrad", "tile"):
        family = LAYOUTS if which == "wgrad" else TILE_LAYOUTS
        names = pick(family)
        if args.layouts is not None and not names:
            continue  # --layouts names none of this kernel's
        for name in ["kept"] + names + ["kept"]:
            if name == "kept":
                consts = dict(zip([c for c, _ in CONSTANTS] + ["fill"], kept))
                path, fill = copy_with("kept"), None
            elif which == "wgrad":
                layout = LAYOUTS[name]
                consts = dict(zip([c for c, _ in CONSTANTS] + ["fill"],
                                  layout))
                path, fill = copy_with(name, layout[:4]), layout[4]
            else:
                consts = dict(zip(("kRowSets", "kBf16Threads"),
                                  TILE_LAYOUTS[name]))
                path = copy_with(name, row_sets=TILE_LAYOUTS[name])
                fill = None
            runs.append({"kernel": which, "layout": name,
                         "constants": consts, **run(path, which, fill=fill)})
    ablations = ABLATIONS if args.only_ablations is None else {
        n: ABLATIONS[n] for n in args.only_ablations}
    for name, edits in (ablations.items() if args.ablations
                        or args.only_ablations else ()):
        runs.append({"kernel": "wgrad", "layout": "kept", "ablation": name,
                     **run(copy_with(name, edits=edits), "wgrad",
                           check=False)})
    for name, edits in (TILE_ABLATIONS.items() if args.ablations else ()):
        runs.append({"kernel": "tile", "layout": "kept", "ablation": name,
                     **run(copy_with(name, edits=edits), "tile",
                           check=False)})
    text = json.dumps({"nvidia_smi": smi, "runs": runs})
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
