"""Fit the GNN lanes on the card several times from one seed and count the
loss trajectories they take.

    python3 scripts/torch_fit_repeat.py [--reps 8]
                                        [--impls fused,persistent,tile]

Run from the root of the checkout to test (the script imports the
``deepdfa_tpu_torch`` and ``chip_smoke.py`` found there, so it also runs
against an unpacked older commit: ``cd <dir> && python3
<this repo>/scripts/torch_fit_repeat.py``). Each fit is chip_smoke's
train phase: the published FlowGNN with random weights from its seed, one
epoch of ``fit`` on its synthetic data. The CPU runs each lane's fit
once, in one intra-op thread. Prints the card's name and power limit,
then one JSON object a lane: how many distinct trajectories (per-step
losses, bit for bit) the card's fits took, each fit's largest per-step
difference from the CPU, and how many of them exceed chip_smoke's
``TRAIN_LOSS_TOL``. Needs one CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

import chip_smoke as cs  # noqa: E402
from deepdfa_tpu_torch.core.config import (  # noqa: E402
    DataConfig,
    FlowGNNConfig,
    TrainConfig,
)
from deepdfa_tpu_torch.models.flowgnn import FlowGNN  # noqa: E402
from deepdfa_tpu_torch.train import loop  # noqa: E402


def _fit(impl: str, device: str, examples, splits) -> list:
    cfg = FlowGNNConfig(message_impl=impl)
    train_cfg = dataclasses.replace(TrainConfig(),
                                    max_epochs=cs.TRAIN_EPOCHS)
    model = FlowGNN(cfg, device="cuda", seed=cs.SEED)
    if device == "cpu":
        cpu_model = FlowGNN(cfg, device="cpu")
        cpu_model.load_state_dict({k: v.cpu()
                                   for k, v in model.state_dict().items()})
        model = cpu_model
    _, history = loop.fit(model, examples, splits, train_cfg,
                          DataConfig(batch_size=256))
    return [x for e in history["epochs"] for x in e["step_losses"]]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--impls", default="fused,persistent,tile")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0], flush=True)
    examples, splits = cs._train_data(FlowGNNConfig().feature,
                                      TrainConfig().seed)
    for impl in args.impls.split(","):
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        cpu = np.asarray(_fit(impl, "cpu", examples, splits))
        torch.set_num_threads(threads)
        runs = [_fit(impl, "cuda", examples, splits)
                for _ in range(args.reps)]
        diffs = [float(np.abs(np.asarray(r) - cpu).max()) for r in runs]
        print(json.dumps({
            "impl": impl, "fits": len(runs),
            "distinct_trajectories": len({tuple(r) for r in runs}),
            "max_abs_loss_diff_vs_cpu": diffs,
            "over_tolerance": sum(d > cs.TRAIN_LOSS_TOL for d in diffs),
            "tolerance": cs.TRAIN_LOSS_TOL}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
