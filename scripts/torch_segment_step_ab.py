"""Time a FlowGNN train step on the ``segment`` message lane, at f32 and
bf16, in two checkouts on one card, in turns.

    python3 scripts/torch_segment_step_ab.py OLD_DIR NEW_DIR [--out FILE]

Each checkout's own ``chip_smoke.py`` builds a seeded
``FlowGNN(message_impl="segment")`` at the published width on the card
and times ``make_train_step``'s step on the first training batch
(``_training_batch``: 256 graphs) with ``_gnn_step_breakdown``: the
median over 10 steps of the forward, backward and optimizer device ms
(CUDA events) and the step's host wall ms, after two warm-up steps that
also build any kernel library the step loads. The checkouts run in a
process each, in the order OLD, NEW, NEW, OLD, so that a drift of the
card or its host over the call shows as a gap between the two runs of one
checkout. Prints one JSON object: the card's name and power limit and,
for each run, each dtype's breakdown. Needs one NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

STEP = """
import chip_smoke as cs
cs.phase_device()
for dtype in ("float32", "bfloat16"):
    model = cs.FlowGNN(cs.FlowGNNConfig(message_impl="segment", dtype=dtype),
                       device="cuda", seed=cs.SEED)
    batch = cs._training_batch(model)
    cs.emit(phase="segment_step", dtype=dtype,
            graphs=int(batch.graph_mask.sum()),
            **cs._gnn_step_breakdown(model, batch))
"""


def run(checkout: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", STEP], cwd=checkout,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{checkout}: exit {proc.returncode}\n"
                           f"{proc.stderr[-4000:]}")
    out = {}
    for line in proc.stdout.splitlines():
        if line.startswith("{"):
            rec = json.loads(line)
            if rec.get("phase") == "segment_step":
                out[rec.pop("dtype")] = {k: v for k, v in rec.items()
                                         if k != "phase"}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--out", default=None,
                    help="also write the JSON object to this file")
    args = ap.parse_args()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    runs = [{"checkout": label,
             **run(os.path.abspath(getattr(args, label)))}
            for label in ("old", "new", "new", "old")]
    doc = json.dumps({"card": smi, "runs": runs})
    if args.out:
        with open(args.out, "w") as f:
            f.write(doc + "\n")
    print(doc)
    return 0


if __name__ == "__main__":
    sys.exit(main())
