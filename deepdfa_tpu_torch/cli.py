"""Command line of the port (counterpart of ``deepdfa_tpu/cli.py``).

One subcommand so far, the offline client of the serving path::

    python -m deepdfa_tpu_torch.cli score --dataset synthetic:256 \\
        [--message-impl persistent] [--batch-slots 16] [--device cuda]

It scores a dataset through ``ServeEngine.score_sync`` (cache,
micro-batcher, bucketed execution), writes ``score_predictions.csv`` as
the reference's ``cmd_score`` does, and prints the reference's JSON
report plus the hand-written kernels' launch counts. The weights are a
random init from ``--seed`` (the reference's smoke mode: the serving
stack is real, the scores are not). Flags replace the reference's YAML
configuration, since the port needs no PyYAML.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)


def load_dataset(spec: str, feature, seed: int = 0) -> List[Dict]:
    """``synthetic[:N]``: the built-in generator, labelled and numbered
    as the reference's ``load_dataset`` does."""
    from deepdfa_tpu_torch.data.synthetic import synthetic_bigvul

    if not spec.startswith("synthetic"):
        raise ValueError(f"unknown dataset spec {spec!r} (the port reads "
                         "synthetic:N only; the JSONL loader is not ported)")
    n = int(spec.split(":")[1]) if ":" in spec else 256
    examples = synthetic_bigvul(n, feature, positive_fraction=0.5, seed=seed)
    for i, ex in enumerate(examples):
        ex["label"] = int(np.asarray(ex["vuln"]).max())
        ex["id"] = i
    return examples


def _dump_predictions(out_dir: str, ids, probs, labels,
                      name: str = "score_predictions.csv") -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name)
    with open(path, "w") as f:
        f.write("index,prob,label\n")
        for i, p, lab in zip(ids, probs, labels):
            f.write(f"{int(i)},{float(p):.6f},{int(lab)}\n")
    return path


def cmd_score(args) -> Dict[str, Any]:
    from deepdfa_tpu_torch.core.config import FlowGNNConfig
    from deepdfa_tpu_torch.models.flowgnn import FlowGNN
    from deepdfa_tpu_torch.ops import fused_gnn
    from deepdfa_tpu_torch.serve import ServeConfig, ServeEngine

    model_cfg = FlowGNNConfig(message_impl=args.message_impl)
    logger.warning("serving RANDOM-INIT weights (seed %d): the serving "
                   "stack is real, the scores are not", args.seed)
    model = FlowGNN(model_cfg, device=args.device, seed=args.seed)
    engine = ServeEngine(model, ServeConfig(batch_slots=args.batch_slots),
                         device=args.device)
    engine.warmup()
    examples = load_dataset(args.dataset, model_cfg.feature, seed=args.seed)
    fused_gnn.reset_launch_counts()
    results = engine.score_sync(examples)
    launches = fused_gnn.launch_counts()
    probs, labels, ids, errors = [], [], [], []
    for i, (ex, r) in enumerate(zip(examples, results)):
        if "error" in r:
            errors.append({"id": int(ex.get("id", i)), **r})
            continue
        probs.append(r["prob"])
        labels.append(int(ex.get("label", 0)))
        ids.append(int(ex.get("id", i)))
    out = _dump_predictions(args.out_dir, ids, probs, labels)
    report = {"n_scored": len(probs), "n_errors": len(errors),
              "errors": errors[:10], "split": "all", "out": out,
              "serving": engine.snapshot(),
              "device": str(engine.device),
              "message_impl": args.message_impl,
              "kernel_launches": launches,
              "over_gate_dispatches": model.over_gate_dispatches}
    print(json.dumps(report))
    return report


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="deepdfa_tpu_torch.cli")
    sub = p.add_subparsers(dest="command", required=True)
    sc = sub.add_parser(
        "score", help="offline batch client of the serving path (cache + "
                      "micro-batcher + bucketed execution)")
    sc.add_argument("--dataset", default="synthetic:256")
    sc.add_argument("--message-impl", default="persistent",
                    choices=["segment", "band", "fused", "persistent"])
    sc.add_argument("--batch-slots", type=int, default=16)
    sc.add_argument("--device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu")
    sc.add_argument("--seed", type=int, default=0)
    sc.add_argument("--out-dir", default="runs/score")
    sc.set_defaults(func=cmd_score)
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    logging.basicConfig(level=logging.WARNING,
                        format="%(levelname)s %(name)s: %(message)s")
    args = build_parser().parse_args(argv)
    args.func(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
