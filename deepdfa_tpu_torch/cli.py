"""Command line of the port (counterpart of ``deepdfa_tpu/cli.py``).

Three subcommands so far. ``fit`` trains the published FlowGNN::

    python -m deepdfa_tpu_torch.cli fit --dataset synthetic:2720 \\
        [--message-impl persistent|fused|tile|band|segment] \\
        [--max-epochs 25] [--batch-size 256] [--lr 1e-3] [--seed 1] \\
        [--device cuda] [--out-dir runs/fit]

It splits the dataset 80/10/10 from ``--seed``, trains with
``train.loop.fit``, writes ``history.json`` into ``--out-dir`` and
prints the reference's result record (best epoch, best validation loss,
the last epoch's validation metrics). ``score`` is the offline client of
the serving path::

    python -m deepdfa_tpu_torch.cli score --dataset synthetic:256 \\
        [--message-impl persistent] [--batch-slots 16] [--device cuda]

It scores a dataset through ``ServeEngine.score_sync`` (cache,
micro-batcher, bucketed execution), writes ``score_predictions.csv`` as
the reference's ``cmd_score`` does, and prints the reference's JSON
report plus the hand-written kernels' launch counts. The weights are a
random init from ``--seed`` (the reference's smoke mode: the serving
stack is real, the scores are not). ``fit-text`` trains DeepDFA+LineVul
(the codebert-base encoder combined with the FlowGNN graph encoder)::

    python -m deepdfa_tpu_torch.cli fit-text --dataset synthetic:256 \\
        --graphs synthetic [--tiny] [--attention-impl auto] [--remat] \\
        [--set model.message_impl=tile] [--epochs 10] [--batch-size 16] \\
        [--block-size 512] [--device cuda] [--out-dir runs/fit_text]

from a seeded random init (no pretrained weights are in the repository
yet), writes ``history.json``, ``model.json`` (the reference's run
descriptor) and, after the test split's evaluation of the best state,
``predictions.csv``. Flags replace the reference's YAML configuration,
since the port needs no PyYAML; ``--set model.<field>=<value>``
(repeatable) sets a field of the graph encoder's ``FlowGNNConfig``, as
the reference's ``fit-text --set`` does, and refuses any other section.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
from typing import Any, Dict, Optional, Sequence

logger = logging.getLogger(__name__)


def _dump_predictions(out_dir: str, ids, probs, labels,
                      name: str = "score_predictions.csv") -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name)
    with open(path, "w") as f:
        f.write("index,prob,label\n")
        for i, p, lab in zip(ids, probs, labels):
            f.write(f"{int(i)},{float(p):.6f},{int(lab)}\n")
    return path


def _coerce(value: str, field_type: Any):
    """The reference's ``_coerce``: a bool field reads 1/true/yes, any
    other field an int, else a float, else the string."""
    if field_type is bool or str(field_type) == "bool":
        return value.lower() in ("1", "true", "yes")
    for cast in (int, float):
        try:
            return cast(value)
        except (TypeError, ValueError):
            continue
    return value


def graph_overrides(items: Sequence[str]) -> Dict[str, Any]:
    """``fit-text --set`` items -> ``FlowGNNConfig`` fields, by the
    reference's rules: only ``model.*`` keys, ``section.key=value``,
    known fields, values coerced to the field's type (``feature``, a
    nested spec, is not settable here)."""
    import dataclasses

    from deepdfa_tpu_torch.core.config import FlowGNNConfig

    fields = {f.name: f for f in dataclasses.fields(FlowGNNConfig)}
    out: Dict[str, Any] = {}
    for item in items:
        if not item.startswith("model."):
            raise ValueError(
                f"fit-text --set only configures the graph encoder "
                f"(model.*); use the native flags instead of {item!r}")
        dotted, _, value = item.partition("=")
        key = dotted.partition(".")[2]
        if not key:
            raise ValueError(f"override must be section.key=value, got "
                             f"{item!r}")
        if key not in fields or key == "feature":
            raise ValueError(f"unknown model option {key!r}")
        ftype = fields[key].type
        out[key] = value if ftype in (str, "str") else _coerce(value, ftype)
    return out


def _launches(*modules) -> Dict[str, int]:
    """The launch counts of the kernels of ``modules`` (ops modules)."""
    from deepdfa_tpu_torch.ops import launch_counts

    counts = launch_counts()
    return {name: counts[name] for m in modules for name in m.KERNELS}


def cmd_score(args) -> Dict[str, Any]:
    from deepdfa_tpu_torch.core.config import FlowGNNConfig
    from deepdfa_tpu_torch.data.combined import load_graph_source
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
    examples = load_graph_source(args.dataset, model_cfg.feature,
                                 seed=args.seed)
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


def cmd_fit(args) -> Dict[str, Any]:
    from deepdfa_tpu_torch.core.config import (
        DataConfig,
        FlowGNNConfig,
        TrainConfig,
    )
    from deepdfa_tpu_torch.data.combined import load_graph_source
    from deepdfa_tpu_torch.data.splits import make_splits
    from deepdfa_tpu_torch.models.flowgnn import FlowGNN
    from deepdfa_tpu_torch.ops import fused_gnn, reset_launch_counts, tile_spmm
    from deepdfa_tpu_torch.train.loop import fit

    model_cfg = FlowGNNConfig(message_impl=args.message_impl)
    data_cfg = DataConfig(batch_size=args.batch_size)
    train_cfg = TrainConfig(learning_rate=args.lr, max_epochs=args.max_epochs,
                            seed=args.seed)
    examples = load_graph_source(args.dataset, model_cfg.feature,
                                 seed=train_cfg.seed)
    splits = make_splits(examples, mode="random", seed=train_cfg.seed)
    model = FlowGNN(model_cfg, device=args.device, seed=train_cfg.seed)
    reset_launch_counts()
    _, history = fit(model, examples, splits, train_cfg, data_cfg)
    history["kernel_launches"] = _launches(fused_gnn, tile_spmm)
    history["over_gate_dispatches"] = model.over_gate_dispatches
    result = {
        "best_epoch": history["best_epoch"],
        "best_val_loss": history["best_val_loss"],
        "final_val_metrics": history["epochs"][-1]["val_metrics"]
        if history["epochs"] else {},
    }
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, "history.json"), "w") as f:
        json.dump(history, f, indent=1)
    print(json.dumps(result))
    return result


def cmd_fit_text(args) -> Dict[str, Any]:
    import dataclasses

    from deepdfa_tpu_torch.core.config import (
        FlowGNNConfig,
        TransformerTrainConfig,
        subkeys_for,
    )
    from deepdfa_tpu_torch.data.combined import (
        graph_join_and_budget,
        load_combined_dataset,
    )
    from deepdfa_tpu_torch.data.text import HashingCodeTokenizer
    from deepdfa_tpu_torch.models.linevul import LineVul
    from deepdfa_tpu_torch.models.transformer import EncoderConfig
    from deepdfa_tpu_torch.ops import (
        attention,
        fused_gnn,
        reset_launch_counts,
        tile_spmm,
    )
    from deepdfa_tpu_torch.train.text_loop import (
        evaluate_text,
        fit_text,
        make_text_eval_step,
    )

    graph_cfg = dataclasses.replace(FlowGNNConfig(**graph_overrides(args.set)),
                                    encoder_mode=True, label_style="graph")
    combined = args.graphs is not None
    tcfg = TransformerTrainConfig(
        learning_rate=args.learning_rate, max_epochs=args.epochs,
        batch_size=args.batch_size,
        eval_batch_size=args.eval_batch_size or args.batch_size,
        block_size=args.block_size, seed=args.seed)
    enc = EncoderConfig.tiny() if args.tiny else EncoderConfig()
    if args.tiny:
        # The tiny position table (66) must still cover --block-size.
        enc = dataclasses.replace(enc, max_position_embeddings=max(
            enc.max_position_embeddings,
            args.block_size + enc.pad_token_id + 1))
    enc = dataclasses.replace(enc, attention_impl=args.attention_impl,
                              remat_layers=args.remat)
    head_dim = enc.hidden_size // enc.num_heads
    if (not str(args.device).startswith("cpu")
            and args.attention_impl in ("auto", "flash")
            and head_dim != attention.KERNEL_HEAD_DIM):
        raise ValueError(
            f"fit-text: head width {head_dim}: the CUDA flash kernels take "
            f"{attention.KERNEL_HEAD_DIM} only; pass --attention-impl dense "
            "or blockwise (or --device cpu)")
    logger.warning("training from a RANDOM init (seed %d): no pretrained "
                   "codebert weights are loaded", args.seed)
    model = LineVul(enc, graph_config=graph_cfg if combined else None,
                    device=args.device, seed=args.seed)
    tok = HashingCodeTokenizer(enc.vocab_size)
    data, splits, graphs_by_id = load_combined_dataset(
        args.dataset, graph_cfg.feature, tok, tcfg.block_size,
        graphs=args.graphs, seed=args.seed)
    subkeys = list(subkeys_for(graph_cfg.feature)) if combined else None
    budget = None
    if combined:
        graphs_by_id, budget = graph_join_and_budget(
            list(graphs_by_id.values()),
            max(tcfg.batch_size, tcfg.eval_batch_size),
            max_nodes=args.max_nodes, max_edges=args.max_edges)
    reset_launch_counts()
    best_state, history = fit_text(model, data, splits, tcfg,
                                   graphs_by_id=graphs_by_id,
                                   subkeys=subkeys, graph_budget=budget,
                                   pad_id=enc.pad_token_id)
    history["kernel_launches"] = _launches(attention)
    history["two_pass_dispatches"] = (
        attention.flash_backward.two_pass_dispatches)
    history["graph_kernel_launches"] = _launches(fused_gnn, tile_spmm)
    os.makedirs(args.out_dir, exist_ok=True)
    descriptor = {
        "model": args.model, "tiny": args.tiny,
        "attention_impl": args.attention_impl, "remat": args.remat,
        "gelu_approximate": enc.gelu_approximate, "combined": combined,
        "block_size": tcfg.block_size, "dataset": args.dataset,
        "split_mode": "random", "graphs": args.graphs,
        "tokenizer": None,
        "batch_size": max(tcfg.batch_size, tcfg.eval_batch_size),
        "graph_budget": budget,
        "graph_config": dataclasses.asdict(graph_cfg), "seed": args.seed,
    }
    with open(os.path.join(args.out_dir, "model.json"), "w") as f:
        json.dump(descriptor, f, indent=1)
    result: Dict[str, Any] = {"best_epoch": history["best_epoch"],
                              "best_val_f1": history["best_val_f1"]}
    if len(splits["test"]):
        model.load_state_dict(best_state.params)
        test = evaluate_text(make_text_eval_step(model), data,
                             splits["test"], tcfg, graphs_by_id, subkeys,
                             budget, pad_id=enc.pad_token_id,
                             build_band_adj=graph_cfg.uses_band_adj,
                             build_tile_adj=graph_cfg.uses_tile_adj)
        result["test"] = {"loss": test["loss"], **test["metrics"],
                          "num_missing": test["num_missing"]}
        _dump_predictions(args.out_dir, test["index"], test["probs"],
                          test["labels"], name="predictions.csv")
    with open(os.path.join(args.out_dir, "history.json"), "w") as f:
        json.dump(history, f, indent=1)
    print(json.dumps(result))
    return result


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="deepdfa_tpu_torch.cli")
    sub = p.add_subparsers(dest="command", required=True)
    ft = sub.add_parser(
        "fit", help="train FlowGNN (best state by validation loss); "
                    "writes history.json")
    ft.add_argument("--dataset", default="synthetic:256")
    ft.add_argument("--message-impl", default="persistent",
                    choices=["segment", "band", "tile", "fused",
                             "persistent"])
    ft.add_argument("--max-epochs", type=int, default=25)
    ft.add_argument("--batch-size", type=int, default=256)
    ft.add_argument("--lr", type=float, default=1e-3)
    ft.add_argument("--seed", type=int, default=1)
    ft.add_argument("--device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu")
    ft.add_argument("--out-dir", default="runs/fit")
    ft.set_defaults(func=cmd_fit)
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
    tx = sub.add_parser(
        "fit-text", help="train LineVul, optionally combined with the "
                         "FlowGNN graph encoder; writes history.json, "
                         "model.json and predictions.csv")
    tx.add_argument("--model", choices=["linevul"], default="linevul")
    tx.add_argument("--dataset", default="synthetic:256")
    tx.add_argument("--graphs", default=None, choices=["synthetic"],
                    help="graph source (omit for text only)")
    tx.add_argument("--tiny", action="store_true",
                    help="tiny encoder shapes (smoke tests). Its head width "
                         "is 8, which the CUDA flash kernels (head width 64) "
                         "do not take: on the card, pass --attention-impl "
                         "dense or blockwise")
    tx.add_argument("--attention-impl", default="auto",
                    choices=["auto", "dense", "blockwise", "flash"],
                    help="encoder attention (auto = the flash kernels on "
                         "the card, their plain versions on the CPU)")
    tx.add_argument("--remat", action="store_true",
                    help="recompute each encoder layer in the backward")
    tx.add_argument("--set", action="append", default=[],
                    metavar="model.K=V",
                    help="set a field of the graph encoder's FlowGNNConfig "
                         "(e.g. model.message_impl=tile); repeatable")
    tx.add_argument("--epochs", type=int, default=10)
    tx.add_argument("--batch-size", type=int, default=16)
    tx.add_argument("--eval-batch-size", type=int, default=None)
    tx.add_argument("--learning-rate", type=float, default=2e-5)
    tx.add_argument("--block-size", type=int, default=512)
    tx.add_argument("--seed", type=int, default=1)
    tx.add_argument("--max-nodes", type=int, default=None,
                    help="graph batch node budget (default: sized from the "
                         "data)")
    tx.add_argument("--max-edges", type=int, default=None)
    tx.add_argument("--device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu")
    tx.add_argument("--out-dir", default="runs/fit_text")
    tx.set_defaults(func=cmd_fit_text)
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    logging.basicConfig(level=logging.WARNING,
                        format="%(levelname)s %(name)s: %(message)s")
    args = build_parser().parse_args(argv)
    args.func(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
