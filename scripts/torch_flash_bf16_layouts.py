"""Time layouts of the bf16 two-pass flash backward on one card.

    python3 scripts/torch_flash_bf16_layouts.py [--out FILE]

``csrc/flash_attn.cu`` fixes the layout of ``flash_bwd_dq_kernel_bf16``
and ``flash_bwd_dkv_kernel_bf16`` in three constants: ``BSTAGES`` (the
streamed tiles' ring), ``BBLOCKS`` (blocks an SM, the
``__launch_bounds__`` that caps the registers) and ``BNC`` (a streamed
tile's columns a warp takes at once). For each layout in ``LAYOUTS`` this
copies ``chip_smoke.py`` and the package (without its builds) into
``.checkouts/layouts/<name>`` (git-ignored), sets the three constants
there and, in a process of its own from that copy, builds the library and
reports ptxas's registers and spills for the two kernels, holds their
outputs to the f32 kernels on the widened inputs rounded once (within a
bf16 step or 1e-5: ``chip_smoke._pair_apart``) and times each kernel with
CUDA events at chip_smoke's training shape (B 16, T 512) and long shape
(B 8, T 4096, H 12) beside its bound. The layout the source keeps (a
copy too) runs first and last, so a drift of the card over the call
shows. Prints one JSON object with the card's name and power limit.
Needs one NVIDIA GPU.
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
SOURCE = os.path.join("deepdfa_tpu_torch", "csrc", "flash_attn.cu")
#: name -> (BSTAGES, BBLOCKS, BNC); "kept" is the source's own.
LAYOUTS = {
    "kept": None,
    "2_blocks_3_stages_32_cols": (3, 2, 32),
    "2_blocks_4_stages_32_cols": (4, 2, 32),
    "1_block_4_stages_64_cols": (4, 1, 64),
}
KERNELS = ("flash_bwd_dq_kernel_bf16", "flash_bwd_dkv_kernel_bf16")

CHILD = r"""
import json, torch
import chip_smoke as cs
from deepdfa_tpu_torch.ops import _build, attention as A
_build.SOURCES = {"flash_attn": _build.SOURCES["flash_attn"]}
log = _build.build_all()["flash_attn"][1]
out = {"ptxas": {}}
current = None
for line in log.splitlines():
    if "Compiling entry function" in line:
        current = next((n for n in %(kernels)r if n in line), None)
    if current and ("registers" in line or "spill" in line):
        out["ptxas"].setdefault(current, []).append(line.strip())
for shape_name, shape, iters in (("train", cs.ATTN_TRAIN_SHAPE, 10),
                                 ("long", cs.ATTN_LONG_SHAPE, 2)):
    q, k, v, mask, g = cs._attn_inputs(shape, cs.SEED)
    q, k, v, g = (x.bfloat16() for x in (q, k, v, g))
    o, lse = A.flash_fwd(q, k, v, mask)
    args = (q, k, v, mask, g, lse, A.flash_delta(o, g))
    wide = cs._wide(args)
    got = [A.flash_bwd_dq(*args), *A.flash_bwd_dkv(*args)]
    want = [x.bfloat16() for x in (A.flash_bwd_dq(*wide),
                                   *A.flash_bwd_dkv(*wide))]
    rec = cs._pair_apart("pair@" + shape_name, got, want)
    for name, fn in zip(%(kernels)r, (A.flash_bwd_dq, A.flash_bwd_dkv)):
        rec[name] = dict(
            ms=cs._time_ms(lambda: fn(*args), iters, 5),
            bound_ms=cs._bound(A.kernel_cost(mask, shape[1], shape[2],
                                             shape[3], name))[0])
    out[shape_name] = rec
print("LAYOUT " + json.dumps(out))
"""


def copy_with(name: str, layout) -> str:
    """A copy of this checkout to run ``name`` from, with the three
    constants set (made once a name)."""
    dst = os.path.join(ROOT, ".checkouts", "layouts", name)
    if os.path.isdir(dst):
        return dst
    os.makedirs(dst)
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), dst)
    shutil.copytree(os.path.join(ROOT, "deepdfa_tpu_torch"),
                    os.path.join(dst, "deepdfa_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    path = os.path.join(dst, SOURCE)
    with open(path) as f:
        text = f.read()
    for const, value in zip(("BSTAGES", "BBLOCKS", "BNC"), layout):
        text, n = re.subn(rf"^constexpr int {const} = \d+;",
                          f"constexpr int {const} = {value};", text,
                          flags=re.M)
        if n != 1:
            raise RuntimeError(f"{SOURCE}: no single {const} to set")
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
    args = ap.parse_args()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    with open(os.path.join(ROOT, SOURCE)) as f:
        text = f.read()
    kept = tuple(int(re.search(rf"^constexpr int {c} = (\d+);", text,
                               re.M).group(1))
                 for c in ("BSTAGES", "BBLOCKS", "BNC"))
    order = list(LAYOUTS) + ["kept"]
    shutil.rmtree(os.path.join(ROOT, ".checkouts", "layouts"),
                  ignore_errors=True)
    runs = []
    for name in order:
        layout = LAYOUTS[name] or kept
        runs.append({"layout": name, "BSTAGES_BBLOCKS_BNC": list(layout),
                     **run(copy_with(name, layout))})
    text = json.dumps({"nvidia_smi": smi, "runs": runs})
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
