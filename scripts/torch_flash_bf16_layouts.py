"""Time layouts of the bf16 flash kernels on one card.

    python3 scripts/torch_flash_bf16_layouts.py [--out FILE]
                                                [--families pair fwd fused]

The layout of each bf16 flash kernel is a few constants in its source:

- the two-pass pair (``flash_bwd_dq_kernel_bf16``,
  ``flash_bwd_dkv_kernel_bf16``): ``BSTAGES`` (the streamed tiles'
  ring), ``BBLOCKS`` (blocks an SM, the ``__launch_bounds__`` that caps
  the registers) and ``BNC`` (a streamed tile's columns a warp takes at
  once) in ``csrc/bf16_mma.cuh``;
- the forward (``flash_fwd_kernel_bf16``): ``FWD_WARPS`` (16 query rows
  each), ``FWD_BLOCKS``, ``FWD_NC`` and ``FWD_STAGES`` in
  ``csrc/flash_attn.cu``;
- the fused backward (``flash_bwd_fused_kernel_bf16`` with
  ``flash_dq_sum_kernel_bf16``): ``FKW`` (warps, 16 keys each: the dq
  partials' key blocks), ``FSTAGES`` and ``FBLOCKS`` in
  ``csrc/flash_bwd_fused.cu``, and ``FUSED_KEY_ROWS`` in
  ``ops/attention.py`` (16 FKW keys, what the wrapper allocates).

For each layout of the chosen families in ``LAYOUTS`` this copies
``chip_smoke.py`` and the package (without its builds) into
``.checkouts/layouts/<name>`` (git-ignored), sets the constants there
and, in a process of its own from that copy, builds the two flash
libraries and reports ptxas's registers and spills for the bf16
kernels, holds every bf16 kernel's outputs to the f32 kernels' on the
widened inputs rounded once (within a bf16 step or 1e-5:
``chip_smoke._pair_apart``) and times each with CUDA events at
chip_smoke's training shape (B 16, T 512: the forward and the fused
backward) and long shape (B 8, T 4096, H 12: the forward and the pair)
beside its bound. The layout the sources keep (a copy too) runs first
and last, so a drift of the card over the call shows. Prints one JSON
object with the card's name and power limit. Needs one NVIDIA GPU.
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
#: family -> (the file of its constants, their names).
FAMILIES = {
    "pair": (os.path.join(CSRC, "bf16_mma.cuh"),
             ("BSTAGES", "BBLOCKS", "BNC")),
    "fwd": (os.path.join(CSRC, "flash_attn.cu"),
            ("FWD_WARPS", "FWD_BLOCKS", "FWD_NC", "FWD_STAGES")),
    "fused": (os.path.join(CSRC, "flash_bwd_fused.cu"),
              ("FKW", "FSTAGES", "FBLOCKS")),
}
ATTENTION = os.path.join("deepdfa_tpu_torch", "ops", "attention.py")
#: family -> layout name -> the family's constants, in FAMILIES' order.
LAYOUTS = {
    "pair": {
        "pair_2_blocks_3_stages_32_cols": (3, 2, 32),
        "pair_2_blocks_4_stages_32_cols": (4, 2, 32),
        "pair_1_block_4_stages_64_cols": (4, 1, 64),
    },
    "fwd": {
        "fwd_128_rows_16_cols": (8, 2, 16, 3),
        "fwd_64_rows_16_cols_3_blocks": (4, 3, 16, 3),
        "fwd_64_rows_64_cols_3_blocks": (4, 3, 64, 3),
    },
    "fused": {
        "fused_64_keys_3_stages_2_blocks": (4, 3, 2),
        "fused_128_keys_3_stages_1_block": (8, 3, 1),
    },
}
KERNELS = ("flash_fwd_kernel_bf16", "flash_bwd_fused_kernel_bf16",
           "flash_dq_sum_kernel_bf16", "flash_bwd_dq_kernel_bf16",
           "flash_bwd_dkv_kernel_bf16")

CHILD = r"""
import json, re, torch
import chip_smoke as cs
from deepdfa_tpu_torch.ops import _build, attention as A
_build.SOURCES = {n: _build.SOURCES[n] for n in ("flash_attn",
                                                 "flash_bwd_fused")}
info = _build.build_all()
out = {"ptxas": {}}
for lib in _build.SOURCES:
    current = None
    for line in info[lib][1].splitlines():
        if "Compiling entry function" in line:
            current = next((n for n in %(kernels)r
                            if re.search(r"\d" + n + r"E", line)), None)
        if current and ("registers" in line or "spill" in line):
            out["ptxas"].setdefault(current, []).append(line.strip())
runs = {"train": (cs.ATTN_TRAIN_SHAPE, 10, ("fwd", "fused")),
        "long": (cs.ATTN_LONG_SHAPE, 2, ("fwd", "pair"))}
for shape_name, (shape, iters, kinds) in runs.items():
    q, k, v, mask, g = cs._attn_inputs(shape, cs.SEED)
    q, k, v, g = (x.bfloat16() for x in (q, k, v, g))
    o, lse = A.flash_fwd(q, k, v, mask)
    args = (q, k, v, mask, g, lse, A.flash_delta(o, g))
    wide = cs._wide(args)
    calls = {"fwd": (("flash_fwd_kernel_bf16",),
                     lambda *a: A.flash_fwd(*a[:4])[:1]),
             "fused": (("flash_bwd_fused_kernel_bf16",), A.flash_bwd_fused),
             "pair": (("flash_bwd_dq_kernel_bf16", "flash_bwd_dkv_kernel_bf16"),
                      lambda *a: (A.flash_bwd_dq(*a), *A.flash_bwd_dkv(*a)))}
    rec = {}
    for kind in kinds:
        names, fn = calls[kind]
        want = [x.bfloat16() for x in fn(*wide)]
        rec[kind] = cs._pair_apart(kind + "@" + shape_name, list(fn(*args)),
                                   want)
        timed = {"flash_bwd_dq_kernel_bf16": A.flash_bwd_dq,
                 "flash_bwd_dkv_kernel_bf16": A.flash_bwd_dkv}
        for name in names:
            run = timed.get(name, fn)
            rec[name] = dict(
                ms=cs._time_ms(lambda: run(*args), iters, 5),
                bound_ms=cs._bound(A.kernel_cost(
                    mask, shape[1], shape[2], shape[3], name))[0])
    out[shape_name] = rec
print("LAYOUT " + json.dumps(out))
"""


def read_kept() -> dict:
    """family -> the constants the sources keep."""
    kept = {}
    for family, (path, names) in FAMILIES.items():
        with open(os.path.join(ROOT, path)) as f:
            text = f.read()
        kept[family] = tuple(
            int(re.search(rf"^constexpr int {c} = (\d+);", text,
                          re.M).group(1)) for c in names)
    return kept


def set_constants(path: str, names, values) -> None:
    with open(path) as f:
        text = f.read()
    for const, value in zip(names, values):
        text, n = re.subn(rf"^constexpr int {const} = \d+;",
                          f"constexpr int {const} = {value};", text,
                          flags=re.M)
        if n != 1:
            raise RuntimeError(f"{path}: no single {const} to set")
    with open(path, "w") as f:
        f.write(text)


def copy_with(name: str, family, layout) -> str:
    """A copy of this checkout to run ``name`` from, with ``family``'s
    constants set to ``layout`` (made once a name; ``family`` None: the
    sources' own)."""
    dst = os.path.join(ROOT, ".checkouts", "layouts", name)
    if os.path.isdir(dst):
        return dst
    os.makedirs(dst)
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), dst)
    shutil.copytree(os.path.join(ROOT, "deepdfa_tpu_torch"),
                    os.path.join(dst, "deepdfa_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    if family is not None:
        path, names = FAMILIES[family]
        set_constants(os.path.join(dst, path), names, layout)
        if family == "fused":
            path = os.path.join(dst, ATTENTION)
            with open(path) as f:
                text = f.read()
            text, n = re.subn(r"torch\.bfloat16: \d+}",
                              f"torch.bfloat16: {16 * layout[0]}}}", text)
            if n != 1:
                raise RuntimeError(f"{ATTENTION}: no FUSED_KEY_ROWS to set")
            with open(path, "w") as f:
                f.write(text)
    return dst


def run(checkout: str) -> dict:
    proc = subprocess.run(
        [sys.executable, "-c", CHILD % {"kernels": KERNELS}], cwd=checkout,
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
    ap.add_argument("--families", nargs="+", choices=sorted(FAMILIES),
                    default=sorted(FAMILIES),
                    help="whose layouts to try (the kept one always runs)")
    args = ap.parse_args()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    kept = read_kept()
    order = [("kept", None, None)]
    for family in args.families:
        order += [(name, family, layout)
                  for name, layout in LAYOUTS[family].items()]
    order.append(("kept", None, None))
    shutil.rmtree(os.path.join(ROOT, ".checkouts", "layouts"),
                  ignore_errors=True)
    runs = []
    for name, family, layout in order:
        consts = {f: dict(zip(FAMILIES[f][1], kept[f])) for f in FAMILIES}
        if family is not None:
            consts[family] = dict(zip(FAMILIES[family][1], layout))
        runs.append({"layout": name, "constants": consts,
                     **run(copy_with(name, family, layout))})
    text = json.dumps({"nvidia_smi": smi, "runs": runs})
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
