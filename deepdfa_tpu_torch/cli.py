"""Command line of the port (counterpart of ``deepdfa_tpu/cli.py``).

The paper's two-stage recipe, end to end::

    python -m deepdfa_tpu_torch.cli fit --dataset synthetic:2600 \\
        --checkpoint-dir runs/ddfa [--resume]
    python -m deepdfa_tpu_torch.cli test --dataset synthetic:2600 \\
        --checkpoint-dir runs/ddfa [--which best]
    python -m deepdfa_tpu_torch.cli score --dataset synthetic:2600 \\
        --seed 1 --split test --checkpoint-dir runs/ddfa
    python -m deepdfa_tpu_torch.cli fit-text --dataset synthetic:256 \\
        --graphs synthetic --ddfa-checkpoint runs/ddfa --which best \\
        --freeze-graph --checkpoint-dir runs/combined
    python -m deepdfa_tpu_torch.cli test-text --checkpoint-dir runs/combined

``fit`` trains the published FlowGNN (``--message-impl
persistent|fused|tile|band|segment``, ``--max-epochs 25``,
``--batch-size 256``, ``--lr 1e-3``, ``--seed 1``): it splits the
dataset 80/10/10 from ``--seed``, writes the ``best``/``last``/periodic
snapshots, ``meta.json`` and ``history.json`` into the run dir
(``--checkpoint-dir``, alias ``--out-dir``) and prints the reference's
result record (best epoch, best validation loss, the last epoch's
validation metrics); ``--resume`` continues from the run dir's newest
intact snapshot. ``test`` restores a snapshot (verified; a damaged one
falls back, and the report says which was loaded) and evaluates the
test split. ``score`` is the offline client of the serving path: it
scores a dataset (or one split of it) through ``ServeEngine.score_sync``
(cache, micro-batcher, bucketed execution), writes
``score_predictions.csv`` and prints the reference's JSON report plus
the hand-written kernels' launch counts; without ``--checkpoint-dir``
the weights are a random init from ``--seed`` (the reference's smoke
mode). ``fit-text`` trains DeepDFA+LineVul (the codebert-base encoder,
from a seeded random init, combined with the FlowGNN graph encoder),
optionally from a ``fit`` run's trained graph encoder, frozen or not;
it writes snapshots, ``history.json``, ``model.json`` (the reference's
run descriptor), a params-only ``best`` and, after the test split's
evaluation of the best state, ``predictions.csv``. ``test-text``
rebuilds the model from ``model.json`` and evaluates a snapshot. Flags
replace the reference's YAML configuration, since the port needs no
PyYAML; ``--set model.<field>=<value>`` (repeatable) sets a field of
the graph encoder's ``FlowGNNConfig``, as the reference's ``fit-text
--set`` does, and refuses any other section. Every command runs on
``--device cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
from typing import Any, Dict, Optional, Sequence

logger = logging.getLogger(__name__)

GNN_LANES = ["segment", "band", "tile", "fused", "persistent"]


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


def _restored_fields(ckpt, which: str, what: str) -> Dict[str, Any]:
    """The report fields of a restore that fell back (none otherwise):
    the numbers that follow describe THAT snapshot, and the report says
    so instead of carrying ``which``'s name."""
    restored = ckpt.last_restored or {}
    if not restored.get("fallback"):
        return {}
    logger.error("%s: snapshot %r was damaged; the fallback snapshot %r "
                 "(epoch %s) was loaded in its place", what, which,
                 restored["name"], restored.get("epoch"))
    return {"restored_snapshot": restored["name"], "restored_fallback": True}


def cmd_score(args) -> Dict[str, Any]:
    import numpy as np

    from deepdfa_tpu_torch.core.config import FlowGNNConfig
    from deepdfa_tpu_torch.data.combined import load_graph_source
    from deepdfa_tpu_torch.data.splits import make_splits
    from deepdfa_tpu_torch.models.flowgnn import FlowGNN
    from deepdfa_tpu_torch.ops import fused_gnn
    from deepdfa_tpu_torch.serve import ServeConfig, ServeEngine
    from deepdfa_tpu_torch.train.checkpoint import CheckpointManager

    model_cfg = FlowGNNConfig(message_impl=args.message_impl)
    model = FlowGNN(model_cfg, device=args.device, seed=args.seed)
    restored: Dict[str, Any] = {}
    if args.checkpoint_dir:
        ckpt = CheckpointManager(args.checkpoint_dir)
        model.load_state_dict(ckpt.restore_params(args.which))
        restored = _restored_fields(ckpt, args.which, "score")
    else:
        logger.warning("no --checkpoint-dir: serving RANDOM-INIT weights "
                       "(seed %d): the serving stack is real, the scores "
                       "are not", args.seed)
    engine = ServeEngine(model, ServeConfig(batch_slots=args.batch_slots),
                         device=args.device)
    engine.warmup()
    examples = load_graph_source(args.dataset, model_cfg.feature,
                                 seed=args.seed)
    indices = (np.arange(len(examples)) if args.split == "all" else
               make_splits(examples, mode="random", seed=args.seed)[
                   args.split])
    chosen = [examples[int(i)] for i in indices]
    fused_gnn.reset_launch_counts()
    results = engine.score_sync(chosen)
    launches = fused_gnn.launch_counts()
    probs, labels, ids, errors = [], [], [], []
    for i, (ex, r) in enumerate(zip(chosen, results)):
        if "error" in r:
            errors.append({"id": int(ex.get("id", i)), **r})
            continue
        probs.append(r["prob"])
        labels.append(int(ex.get("label", 0)))
        ids.append(int(ex.get("id", i)))
    out = _dump_predictions(args.out_dir, ids, probs, labels)
    report = {"n_scored": len(probs), "n_errors": len(errors),
              "errors": errors[:10], "split": args.split, "out": out,
              **restored,
              "serving": engine.snapshot(),
              "device": str(engine.device),
              "message_impl": args.message_impl,
              "kernel_launches": launches,
              "over_gate_dispatches": model.over_gate_dispatches}
    print(json.dumps(report))
    return report


def _graph_data(dataset: str, feature, seed: int):
    """``cli fit``/``test``'s examples and their 80/10/10 split from
    ``seed`` (the reference's ``load_dataset``)."""
    from deepdfa_tpu_torch.data.combined import load_graph_source
    from deepdfa_tpu_torch.data.splits import make_splits

    examples = load_graph_source(dataset, feature, seed=seed)
    return examples, make_splits(examples, mode="random", seed=seed)


def cmd_fit(args) -> Dict[str, Any]:
    from deepdfa_tpu_torch.core.config import (
        DataConfig,
        FlowGNNConfig,
        TrainConfig,
    )
    from deepdfa_tpu_torch.models.flowgnn import FlowGNN
    from deepdfa_tpu_torch.ops import fused_gnn, reset_launch_counts, tile_spmm
    from deepdfa_tpu_torch.train.loop import fit

    # One run directory for snapshots, meta.json and history.json; the
    # snapshots are always written.
    run_dir = args.checkpoint_dir
    model_cfg = FlowGNNConfig(message_impl=args.message_impl)
    data_cfg = DataConfig(batch_size=args.batch_size)
    train_cfg = TrainConfig(learning_rate=args.lr, max_epochs=args.max_epochs,
                            seed=args.seed, checkpoint_dir=run_dir)
    examples, splits = _graph_data(args.dataset, model_cfg.feature,
                                   train_cfg.seed)
    model = FlowGNN(model_cfg, device=args.device, seed=train_cfg.seed)
    reset_launch_counts()
    _, history = fit(model, examples, splits, train_cfg, data_cfg,
                     resume=args.resume)
    history["kernel_launches"] = _launches(fused_gnn, tile_spmm)
    history["over_gate_dispatches"] = model.over_gate_dispatches
    result = {
        "best_epoch": history["best_epoch"],
        "best_val_loss": history["best_val_loss"],
        "final_val_metrics": history["epochs"][-1]["val_metrics"]
        if history["epochs"] else {},
    }
    resumed = history.get("resumed_from") or {}
    if resumed.get("fallback"):
        result.update(restored_snapshot=resumed["name"],
                      restored_fallback=True)
    with open(os.path.join(run_dir, "history.json"), "w") as f:
        json.dump(history, f, indent=1)
    print(json.dumps(result))
    return result


def cmd_test(args) -> Dict[str, Any]:
    """Evaluate a ``fit`` snapshot on the test split (the reference's
    ``cmd_test``): prints ``{"loss", ...metrics}`` and writes
    ``test_predictions.csv`` into the run dir."""
    from deepdfa_tpu_torch.core.config import (
        DataConfig,
        FlowGNNConfig,
        TrainConfig,
        subkeys_for,
    )
    from deepdfa_tpu_torch.models.flowgnn import FlowGNN
    from deepdfa_tpu_torch.train.checkpoint import CheckpointManager
    from deepdfa_tpu_torch.train.loop import evaluate, make_eval_step

    model_cfg = FlowGNNConfig(message_impl=args.message_impl)
    data_cfg, train_cfg = DataConfig(), TrainConfig(seed=args.seed)
    examples, splits = _graph_data(args.dataset, model_cfg.feature,
                                   train_cfg.seed)
    model = FlowGNN(model_cfg, device=args.device, seed=train_cfg.seed)
    ckpt = CheckpointManager(args.checkpoint_dir)
    model.load_state_dict(ckpt.restore(args.which)["params"])
    res = evaluate(make_eval_step(model, train_cfg), examples, splits["test"],
                   data_cfg, subkeys_for(model_cfg.feature),
                   next(model.parameters()).device,
                   build_band_adj=model_cfg.uses_band_adj,
                   build_tile_adj=model_cfg.uses_tile_adj)
    report = {"loss": res.loss, **res.metrics,
              **_restored_fields(ckpt, args.which, "test")}
    _dump_predictions(args.checkpoint_dir, res.graph_ids, res.probs,
                      res.labels, name="test_predictions.csv")
    print(json.dumps(report))
    return report


def _text_model(tiny: bool, attention_impl: str, remat: bool,
                block_size: int, graph_cfg, device, seed: int,
                gelu_approximate: Optional[bool] = None):
    """(LineVul, tokenizer) as ``fit-text`` builds them: codebert-base
    (or the tiny encoder, its position table stretched to cover
    ``block_size``) with the FlowGNN encoder when ``graph_cfg`` is given.
    The card's flash kernels take head width 64 only."""
    import dataclasses

    from deepdfa_tpu_torch.data.text import HashingCodeTokenizer
    from deepdfa_tpu_torch.models.linevul import LineVul
    from deepdfa_tpu_torch.models.transformer import EncoderConfig
    from deepdfa_tpu_torch.ops import attention

    enc = EncoderConfig.tiny() if tiny else EncoderConfig()
    if tiny:
        enc = dataclasses.replace(enc, max_position_embeddings=max(
            enc.max_position_embeddings,
            block_size + enc.pad_token_id + 1))
    enc = dataclasses.replace(enc, attention_impl=attention_impl,
                              remat_layers=remat)
    if gelu_approximate is not None:
        enc = dataclasses.replace(enc, gelu_approximate=gelu_approximate)
    head_dim = enc.hidden_size // enc.num_heads
    if (not str(device).startswith("cpu")
            and attention_impl in ("auto", "flash")
            and head_dim != attention.KERNEL_HEAD_DIM):
        raise ValueError(
            f"fit-text: head width {head_dim}: the CUDA flash kernels take "
            f"{attention.KERNEL_HEAD_DIM} only; pass --attention-impl dense "
            "or blockwise (or --device cpu)")
    model = LineVul(enc, graph_config=graph_cfg, device=device, seed=seed)
    return model, HashingCodeTokenizer(enc.vocab_size)


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
    from deepdfa_tpu_torch.ops import (
        attention,
        fused_gnn,
        reset_launch_counts,
        tile_spmm,
    )
    from deepdfa_tpu_torch.train.checkpoint import (
        CheckpointManager,
        load_encoder_params,
        make_checkpoint_manager,
    )
    from deepdfa_tpu_torch.train.text_loop import (
        evaluate_text,
        fit_text,
        make_text_eval_step,
    )

    graph_cfg = dataclasses.replace(FlowGNNConfig(**graph_overrides(args.set)),
                                    encoder_mode=True, label_style="graph")
    combined = args.graphs is not None
    if args.ddfa_checkpoint and not combined:
        raise ValueError("--ddfa-checkpoint needs --graphs (the encoder "
                         "slot only exists combined)")
    if args.freeze_graph and not args.ddfa_checkpoint:
        raise ValueError(
            "--freeze-graph without --ddfa-checkpoint would freeze a "
            "random-init encoder (the reference freezes a LOADED one, "
            "main_cli.py:136-144)")
    run_dir = args.checkpoint_dir
    tcfg = TransformerTrainConfig(
        learning_rate=args.learning_rate, max_epochs=args.epochs,
        batch_size=args.batch_size,
        eval_batch_size=args.eval_batch_size or args.batch_size,
        block_size=args.block_size, seed=args.seed)
    model, tok = _text_model(args.tiny, args.attention_impl, args.remat,
                             tcfg.block_size,
                             graph_cfg if combined else None, args.device,
                             args.seed)
    enc = model.encoder_config
    logger.warning("training from a RANDOM init (seed %d): no pretrained "
                   "codebert weights are loaded", args.seed)
    result: Dict[str, Any] = {}
    init_params = None
    if args.ddfa_checkpoint:
        # The trained DDFA model, verified, less its head and pooling,
        # into the encoder slot (main_cli.py:136-144).
        ddfa = CheckpointManager(args.ddfa_checkpoint)
        init_params = {f"flowgnn.{k}": v for k, v in load_encoder_params(
            ddfa.restore_params(args.which)).items()}
        result.update({f"ddfa_{k}": v for k, v in _restored_fields(
            ddfa, args.which, "fit-text --ddfa-checkpoint").items()})
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
    ckpt = make_checkpoint_manager(run_dir)
    reset_launch_counts()
    best_state, history = fit_text(
        model, data, splits, tcfg, graphs_by_id=graphs_by_id,
        subkeys=subkeys, graph_budget=budget, pad_id=enc.pad_token_id,
        init_params=init_params,
        freeze_submodules=("flowgnn",) if args.freeze_graph else (),
        checkpointer=ckpt)
    history["kernel_launches"] = _launches(attention)
    history["two_pass_dispatches"] = (
        attention.flash_backward.two_pass_dispatches)
    history["graph_kernel_launches"] = _launches(fused_gnn, tile_spmm)
    # Params only: restoring for evaluation must not depend on the
    # optimizer's state, whose layout changes with --freeze-graph.
    ckpt.save_best({"params": best_state.params}, history["best_epoch"],
                   metrics={"val_f1": history["best_val_f1"]})
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
    with open(os.path.join(run_dir, "model.json"), "w") as f:
        json.dump(descriptor, f, indent=1)
    result = {"best_epoch": history["best_epoch"],
              "best_val_f1": history["best_val_f1"], **result}
    if not args.no_test and len(splits["test"]):
        model.load_state_dict(best_state.params)
        test = evaluate_text(make_text_eval_step(model), data,
                             splits["test"], tcfg, graphs_by_id, subkeys,
                             budget, pad_id=enc.pad_token_id,
                             build_band_adj=graph_cfg.uses_band_adj,
                             build_tile_adj=graph_cfg.uses_tile_adj)
        result["test"] = {"loss": test["loss"], **test["metrics"],
                          "num_missing": test["num_missing"]}
        _dump_predictions(run_dir, test["index"], test["probs"],
                          test["labels"], name="predictions.csv")
    with open(os.path.join(run_dir, "history.json"), "w") as f:
        json.dump(history, f, indent=1)
    print(json.dumps(result))
    return result


def cmd_test_text(args) -> Dict[str, Any]:
    """Evaluate a ``fit-text`` run dir on the test split (the val split
    when test is empty), rebuilt from its ``model.json``; writes
    ``test_predictions.csv`` beside ``predictions.csv``."""
    from deepdfa_tpu_torch.core.config import (
        FeatureSpec,
        FlowGNNConfig,
        TransformerTrainConfig,
        subkeys_for,
    )
    from deepdfa_tpu_torch.data.combined import (
        graph_join_and_budget,
        load_combined_dataset,
    )
    from deepdfa_tpu_torch.train.checkpoint import CheckpointManager
    from deepdfa_tpu_torch.train.text_loop import (
        evaluate_text,
        make_text_eval_step,
    )

    with open(os.path.join(args.checkpoint_dir, "model.json")) as f:
        desc = json.load(f)
    gdict = dict(desc["graph_config"])
    gdict["feature"] = FeatureSpec(**gdict["feature"])
    graph_cfg = FlowGNNConfig(**gdict)
    combined = desc["combined"]
    model, tok = _text_model(
        desc["tiny"], desc.get("attention_impl", "auto"),
        desc.get("remat", False), desc["block_size"],
        graph_cfg if combined else None, args.device, desc["seed"],
        gelu_approximate=desc.get("gelu_approximate", False))
    tcfg = TransformerTrainConfig(
        block_size=desc["block_size"], eval_batch_size=args.eval_batch_size,
        batch_size=args.eval_batch_size, seed=desc["seed"])
    dataset = args.dataset or desc["dataset"]
    graphs = (args.graphs or desc["graphs"]) if combined else None
    data, splits, graphs_by_id = load_combined_dataset(
        dataset, graph_cfg.feature, tok, tcfg.block_size, graphs=graphs,
        seed=desc["seed"])
    subkeys = list(subkeys_for(graph_cfg.feature)) if combined else None
    budget = desc["graph_budget"]
    source_override = bool(args.dataset or args.graphs)
    if combined and (source_override
                     or args.eval_batch_size > desc.get("batch_size", 0)):
        # The recorded budget covers the fit-time graphs and batch size;
        # another source or a larger eval batch packs more than it
        # covers. Re-derive, so no test graph is dropped (keeping any
        # larger recorded budget when the source is unchanged).
        graphs_by_id, rebudget = graph_join_and_budget(
            list(graphs_by_id.values()),
            max(desc.get("batch_size", 0), args.eval_batch_size))
        budget = (rebudget if source_override
                  else {k: max(budget[k], rebudget[k]) for k in budget})
    split_used = "test" if len(splits["test"]) else "val"
    ckpt = CheckpointManager(args.checkpoint_dir)
    model.load_state_dict(ckpt.restore_params(args.which))
    res = evaluate_text(make_text_eval_step(model), data, splits[split_used],
                        tcfg, graphs_by_id, subkeys, budget,
                        pad_id=model.encoder_config.pad_token_id,
                        build_band_adj=graph_cfg.uses_band_adj,
                        build_tile_adj=graph_cfg.uses_tile_adj)
    report: Dict[str, Any] = {"loss": res["loss"], **res["metrics"],
                              "num_missing": res["num_missing"],
                              "split": split_used,
                              **_restored_fields(ckpt, args.which,
                                                 "test-text")}
    # Its own file: it must not overwrite fit-text's predictions.csv.
    _dump_predictions(args.checkpoint_dir, res["index"], res["probs"],
                      res["labels"], name="test_predictions.csv")
    print(json.dumps(report))
    return report


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="deepdfa_tpu_torch.cli")
    sub = p.add_subparsers(dest="command", required=True)

    def device_flag(parser):
        parser.add_argument("--device", default="cuda",
                            help="cuda (default; raises without CUDA) or cpu")

    ft = sub.add_parser(
        "fit", help="train FlowGNN (best state by validation loss); "
                    "writes snapshots, meta.json and history.json")
    ft.add_argument("--dataset", default="synthetic:256")
    ft.add_argument("--message-impl", default="persistent",
                    choices=GNN_LANES)
    ft.add_argument("--max-epochs", type=int, default=25)
    ft.add_argument("--batch-size", type=int, default=256)
    ft.add_argument("--lr", type=float, default=1e-3)
    ft.add_argument("--seed", type=int, default=1)
    device_flag(ft)
    ft.add_argument("--checkpoint-dir", "--out-dir", dest="checkpoint_dir",
                    default="runs/fit",
                    help="the run dir: snapshots, meta.json, history.json")
    ft.add_argument("--resume", action="store_true",
                    help="continue from the run dir's newest intact "
                         "snapshot")
    ft.set_defaults(func=cmd_fit)
    te = sub.add_parser(
        "test", help="evaluate a fit snapshot on the test split")
    te.add_argument("--checkpoint-dir", required=True)
    te.add_argument("--which", default="best", help="best | last | epoch_N")
    te.add_argument("--dataset", default="synthetic:256")
    te.add_argument("--message-impl", default="persistent",
                    choices=GNN_LANES)
    te.add_argument("--seed", type=int, default=1,
                    help="the data and split seed fit used")
    device_flag(te)
    te.set_defaults(func=cmd_test)
    sc = sub.add_parser(
        "score", help="offline batch client of the serving path (cache + "
                      "micro-batcher + bucketed execution)")
    sc.add_argument("--dataset", default="synthetic:256")
    sc.add_argument("--message-impl", default="persistent",
                    choices=["segment", "band", "fused", "persistent"])
    sc.add_argument("--checkpoint-dir", default=None,
                    help="cli fit run dir (omit for random-init smoke)")
    sc.add_argument("--which", default="best")
    sc.add_argument("--split", default="all",
                    choices=["all", "train", "val", "test"])
    sc.add_argument("--batch-slots", type=int, default=16)
    device_flag(sc)
    sc.add_argument("--seed", type=int, default=0,
                    help="the data and split seed (and the random init's "
                         "without --checkpoint-dir)")
    sc.add_argument("--out-dir", default="runs/score")
    sc.set_defaults(func=cmd_score)
    tx = sub.add_parser(
        "fit-text", help="train LineVul, optionally combined with the "
                         "FlowGNN graph encoder; writes snapshots, "
                         "history.json, model.json and predictions.csv")
    tx.add_argument("--model", choices=["linevul"], default="linevul")
    tx.add_argument("--dataset", default="synthetic:256")
    tx.add_argument("--graphs", default=None, choices=["synthetic"],
                    help="graph source (omit for text only)")
    tx.add_argument("--checkpoint-dir", "--out-dir", dest="checkpoint_dir",
                    default="runs/fit_text",
                    help="the run dir: snapshots, meta.json, model.json, "
                         "history.json, predictions.csv")
    tx.add_argument("--ddfa-checkpoint", default=None,
                    help="a cli fit run dir: its trained embeddings and "
                         "gated step initialize the graph encoder")
    tx.add_argument("--which", default="best",
                    help="the --ddfa-checkpoint snapshot")
    tx.add_argument("--freeze-graph", action="store_true",
                    help="keep the loaded graph encoder frozen")
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
    tx.add_argument("--no-test", action="store_true",
                    help="skip the test-split evaluation after training")
    device_flag(tx)
    tx.set_defaults(func=cmd_fit_text)
    tt = sub.add_parser(
        "test-text", help="evaluate a fit-text run dir (rebuilt from its "
                          "model.json) on the test split")
    tt.add_argument("--checkpoint-dir", required=True)
    tt.add_argument("--which", default="best")
    tt.add_argument("--dataset", default=None,
                    help="override the recorded dataset")
    tt.add_argument("--graphs", default=None, choices=["synthetic"],
                    help="override the recorded graph source")
    tt.add_argument("--eval-batch-size", type=int, default=16)
    device_flag(tt)
    tt.set_defaults(func=cmd_test_text)
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    logging.basicConfig(level=logging.WARNING,
                        format="%(levelname)s %(name)s: %(message)s")
    args = build_parser().parse_args(argv)
    args.func(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
