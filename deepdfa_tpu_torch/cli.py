"""Command line of the port (counterpart of ``deepdfa_tpu/cli.py``).

The paper's two-stage recipe, end to end::

    python -m deepdfa_tpu_torch.cli validate corpus.jsonl
    python -m deepdfa_tpu_torch.cli analyze --dataset corpus.jsonl
    python -m deepdfa_tpu_torch.cli fit --dataset corpus.jsonl \\
        --config configs/default.yaml --checkpoint-dir runs/ddfa [--resume]
    python -m deepdfa_tpu_torch.cli test --dataset corpus.jsonl \\
        --checkpoint-dir runs/ddfa [--which best]
    python -m deepdfa_tpu_torch.cli score --dataset synthetic:2600 \\
        --seed 1 --split test --checkpoint-dir runs/ddfa
    python -m deepdfa_tpu_torch.cli fit-text --dataset msr_csv_dir \\
        --graphs corpus.jsonl --tokenizer bpe_dir --ddfa-checkpoint runs/ddfa \\
        --which best --freeze-graph --checkpoint-dir runs/combined
    python -m deepdfa_tpu_torch.cli test-text --checkpoint-dir runs/combined

Datasets: ``synthetic[:N]`` (generated graphs) or a ``.jsonl`` corpus in
the ETL's export format, read through the data contracts (rows that
break them go to the corpus's ``quarantine/`` sibling); a
``splits.json`` beside the corpus pins its partition under
``--split-mode random`` (another mode overrides it, with a warning).
``fit-text``'s text is ``synthetic[:N]`` or a directory of MSR-layout
``train.csv``/``val.csv``/``test.csv``; ``--graphs`` is ``synthetic`` or
a ``.jsonl`` corpus; ``--tokenizer`` names byte-level BPE assets (a
``tokenizer.json`` or a ``*-vocab.json`` + ``*-merges.txt`` pair; by
default the hashing tokenizer).

Configuration as the reference's: ``fit``, ``test``, ``score`` and
``analyze`` take ``--config`` YAML files (later files override earlier
ones) and ``--set section.key=value`` overrides of the model, data and
train sections; ``fit-text`` takes ``model.*`` only, for its graph
encoder. The port's own flags (``--message-impl``, ``--max-epochs``,
``--batch-size``, ``--lr``, ``--seed``) name fields too: their defaults
lie under the files, and a flag given on the command line applies last,
over ``--set``. ``fit`` and ``fit-text`` log into ``run_<stamp>.log`` in
the run dir, renamed ``.error`` when the command fails.

``fit`` trains the published FlowGNN (``--message-impl
persistent|fused|tile|band|segment``; the label styles ``graph``,
``node``, ``dataflow_solution_in`` and ``dataflow_solution_out`` through
``model.label_style``): it writes the ``best``/``last``/periodic
snapshots, ``meta.json`` and ``history.json`` into the run dir
(``--checkpoint-dir``, alias ``--out-dir``) and prints the reference's
result record; ``--resume`` continues from the run dir's newest intact
snapshot. ``test`` restores a snapshot (verified; a damaged one falls
back, and the report says which was loaded) and evaluates the test
split. ``score`` is the offline client of the serving path: it scores a
dataset (or one split of it) through ``ServeEngine.score_sync``, writes
``score_predictions.csv`` and prints the reference's JSON report plus
the hand-written kernels' launch counts; without ``--checkpoint-dir``
the weights are a random init from ``--seed``. ``fit-text`` trains
DeepDFA+LineVul (the codebert-base encoder from a seeded random init,
combined with the FlowGNN graph encoder), optionally from a ``fit``
run's trained graph encoder, frozen or not; pretrained HF weights reach
``fit_text`` through the library (``models/pretrained.load_pretrained``),
as in the reference. ``test-text`` rebuilds the model from
``model.json`` and evaluates a snapshot. ``validate`` runs a corpus file
or a cache directory through the contracts and exits 1 when anything
was quarantined; ``analyze`` reports the abstract-dataflow feature
coverage. Every command that computes runs on ``--device cuda`` unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import sys
import time
from typing import Any, Dict, Optional, Sequence

from deepdfa_tpu_torch.core.config import _coerce, build_configs  # noqa: F401

logger = logging.getLogger(__name__)

GNN_LANES = ["segment", "band", "tile", "fused", "persistent"]

# The port's flags that name a config field: (flag attribute, section,
# field). Their defaults form the layer under the --config files.
_FIELD_FLAGS = (("message_impl", "model", "message_impl"),
                ("max_epochs", "train", "max_epochs"),
                ("batch_size", "data", "batch_size"),
                ("lr", "train", "learning_rate"),
                ("seed", "train", "seed"))


def _dump_predictions(out_dir: str, ids, probs, labels,
                      name: str = "score_predictions.csv") -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name)
    with open(path, "w") as f:
        f.write("index,prob,label\n")
        for i, p, lab in zip(ids, probs, labels):
            f.write(f"{int(i)},{float(p):.6f},{int(lab)}\n")
    return path


def _model_items_only(items: Sequence[str]) -> None:
    """``fit-text --set`` configures the graph encoder only: every item
    must be a ``model.*`` key, as the reference's fit-text requires."""
    for item in items:
        if not item.startswith("model."):
            raise ValueError(
                f"fit-text --set only configures the graph encoder "
                f"(model.*); use the native flags instead of {item!r}")


def graph_overrides(items: Sequence[str]) -> Dict[str, Any]:
    """``fit-text --set`` items -> the ``FlowGNNConfig`` fields they set,
    coerced by ``build_configs``."""
    _model_items_only(items)
    cfg = build_configs([], items)["model"]
    return {k: getattr(cfg, k) for k in
            (item.partition("=")[0].partition(".")[2] for item in items)}


def _configs(args, flags: Dict[str, Any]) -> Dict[str, Any]:
    """``build_configs`` over ``--config``/``--set``, with the port's
    field flags: ``flags`` maps each flag this command has to its
    default, which lies under the files; a flag given on the command
    line (not None) applies over ``--set``."""
    import dataclasses

    defaults: Dict[str, Dict[str, Any]] = {}
    given: Dict[str, Dict[str, Any]] = {}
    for attr, section, field in _FIELD_FLAGS:
        if attr not in flags:
            continue
        defaults.setdefault(section, {})[field] = flags[attr]
        if getattr(args, attr, None) is not None:
            given.setdefault(section, {})[field] = getattr(args, attr)
    cfgs = build_configs(args.config, args.set, defaults=defaults)
    return {k: dataclasses.replace(v, **given.get(k, {}))
            for k, v in cfgs.items()}


def _read_pinned_split(path: str) -> Optional[Dict[int, str]]:
    """A ``splits.json`` in either layout: ``{"<id>": "train", ...}`` or
    ``{"train": [ids], ...}``. None when absent or empty."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        doc = json.load(f)
    if not doc:
        # {} would read as the list layout and pin every partition empty.
        return None
    if set(doc) <= {"train", "val", "test"}:
        return {int(i): part for part, ids in doc.items() for i in ids}
    return {int(k): v for k, v in doc.items()}


def load_dataset(spec: str, feature, seed: int = 0,
                 split_mode: str = "random"):
    """(examples, splits) for ``fit``/``test``/``score``/``analyze`` (the
    reference's ``load_dataset``): ``synthetic[:N]``, split by
    ``split_mode`` from ``seed``, or a ``.jsonl`` corpus read through
    the contracts, whose sibling ``splits.json`` pins the partition the
    abstract-dataflow vocabulary was built on."""
    from deepdfa_tpu_torch.core.config import subkeys_for
    from deepdfa_tpu_torch.data.combined import load_graph_source
    from deepdfa_tpu_torch.data.splits import make_splits

    if spec.startswith("synthetic"):
        examples = load_graph_source(spec, feature, seed=seed)
        return examples, make_splits(examples, mode=split_mode, seed=seed)
    if spec.endswith(".jsonl") and os.path.exists(spec):
        from deepdfa_tpu_torch.contracts import load_examples_jsonl

        examples, report = load_examples_jsonl(spec, subkeys_for(feature))
        if report["quarantined"]:
            logger.warning("dataset %s: %d row(s) quarantined (%s) -> %s",
                           spec, report["quarantined"], report["by_reason"],
                           report["dir"])
        sibling = os.path.join(os.path.dirname(spec) or ".", "splits.json")
        fixed = _read_pinned_split(sibling)
        if split_mode == "random" and fixed is not None:
            logger.info("using pinned split %s", sibling)
            return examples, make_splits(examples, mode="fixed", fixed=fixed)
        if fixed is not None:
            logger.warning(
                "overriding the pinned split %s with --split-mode=%s: the "
                "abstract-dataflow vocab was built on the pinned train "
                "partition, so re-splitting risks vocab leakage into test "
                "— re-export with the matching --split-mode", sibling,
                split_mode)
        return examples, make_splits(examples, mode=split_mode, seed=seed)
    raise ValueError(f"unknown dataset spec {spec!r}")


_graph_data = load_dataset


@contextlib.contextmanager
def _run_log(run_dir: str):
    """The reference's run log (``_setup_run_logging``, ``_CrashLog``):
    a ``run_<stamp>.log`` handler on the root logger at INFO for the
    command's duration, renamed ``.error`` when the command raises; the
    handler goes and the root logger's level comes back either way."""
    os.makedirs(run_dir, exist_ok=True)
    path = os.path.join(run_dir, f"run_{time.strftime('%Y%m%d_%H%M%S')}.log")
    handler = logging.FileHandler(path)
    handler.setFormatter(logging.Formatter(
        "%(asctime)s %(name)s %(levelname)s %(message)s"))
    root = logging.getLogger()
    level = root.level
    root.addHandler(handler)
    root.setLevel(logging.INFO)
    failed = True
    try:
        yield path
        failed = False
    finally:
        root.removeHandler(handler)
        root.setLevel(level)
        handler.close()
        if failed and os.path.exists(path):
            os.replace(path, path + ".error")


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

    from deepdfa_tpu_torch.models.flowgnn import FlowGNN
    from deepdfa_tpu_torch.ops import fused_gnn
    from deepdfa_tpu_torch.serve import ServeConfig, ServeEngine
    from deepdfa_tpu_torch.train.checkpoint import CheckpointManager

    cfgs = _configs(args, {"message_impl": "persistent", "seed": 0})
    model_cfg, seed = cfgs["model"], cfgs["train"].seed
    model = FlowGNN(model_cfg, device=args.device, seed=seed)
    restored: Dict[str, Any] = {}
    if args.checkpoint_dir:
        ckpt = CheckpointManager(args.checkpoint_dir)
        model.load_state_dict(ckpt.restore_params(args.which))
        restored = _restored_fields(ckpt, args.which, "score")
    else:
        logger.warning("no --checkpoint-dir: serving RANDOM-INIT weights "
                       "(seed %d): the serving stack is real, the scores "
                       "are not", seed)
    engine = ServeEngine(model, ServeConfig(batch_slots=args.batch_slots),
                         device=args.device)
    engine.warmup()
    examples, splits = load_dataset(args.dataset, model_cfg.feature,
                                    seed=seed, split_mode=args.split_mode)
    indices = (np.arange(len(examples)) if args.split == "all"
               else splits[args.split])
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
              "message_impl": model_cfg.message_impl,
              "kernel_launches": launches,
              "over_gate_dispatches": model.over_gate_dispatches}
    print(json.dumps(report))
    return report


def _uses_dataflow(model_cfg) -> bool:
    return model_cfg.label_style.startswith("dataflow_solution")


def cmd_fit(args) -> Dict[str, Any]:
    import dataclasses

    from deepdfa_tpu_torch.models.flowgnn import FlowGNN
    from deepdfa_tpu_torch.ops import fused_gnn, reset_launch_counts, tile_spmm
    from deepdfa_tpu_torch.train.loop import fit

    cfgs = _configs(args, {"message_impl": "persistent", "max_epochs": 25,
                           "batch_size": 256, "lr": 1e-3, "seed": 1})
    model_cfg, data_cfg, train_cfg = cfgs["model"], cfgs["data"], cfgs["train"]
    # One run directory for snapshots, the log, meta.json and
    # history.json: the flag over the YAML over the default; the
    # snapshots are always written.
    run_dir = args.checkpoint_dir or train_cfg.checkpoint_dir or "runs/fit"
    train_cfg = dataclasses.replace(train_cfg, checkpoint_dir=run_dir)
    with _run_log(run_dir):
        examples, splits = load_dataset(args.dataset, model_cfg.feature,
                                        seed=train_cfg.seed,
                                        split_mode=args.split_mode)
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
    from deepdfa_tpu_torch.core.config import subkeys_for
    from deepdfa_tpu_torch.models.flowgnn import FlowGNN
    from deepdfa_tpu_torch.train.checkpoint import CheckpointManager
    from deepdfa_tpu_torch.train.loop import evaluate, make_eval_step

    cfgs = _configs(args, {"message_impl": "persistent", "seed": 1})
    model_cfg, data_cfg, train_cfg = cfgs["model"], cfgs["data"], cfgs["train"]
    examples, splits = load_dataset(args.dataset, model_cfg.feature,
                                    seed=train_cfg.seed,
                                    split_mode=args.split_mode)
    model = FlowGNN(model_cfg, device=args.device, seed=train_cfg.seed)
    ckpt = CheckpointManager(args.checkpoint_dir)
    model.load_state_dict(ckpt.restore(args.which)["params"])
    res = evaluate(make_eval_step(model, train_cfg), examples, splits["test"],
                   data_cfg, subkeys_for(model_cfg.feature),
                   next(model.parameters()).device,
                   build_band_adj=model_cfg.uses_band_adj,
                   build_tile_adj=model_cfg.uses_tile_adj,
                   with_dataflow=_uses_dataflow(model_cfg))
    report = {"loss": res.loss, **res.metrics,
              **_restored_fields(ckpt, args.which, "test")}
    _dump_predictions(args.checkpoint_dir, res.graph_ids, res.probs,
                      res.labels, name="test_predictions.csv")
    print(json.dumps(report))
    return report


def cmd_analyze(args) -> Dict[str, Any]:
    """Feature coverage (the reference's ``cmd_analyze``): the share of
    definition nodes whose abstract-dataflow index is known (> 1) rather
    than UNKNOWN (1), and the non-definition nodes (0), per subkey."""
    import numpy as np

    from deepdfa_tpu_torch.core.config import subkeys_for

    model_cfg = build_configs(args.config, args.set)["model"]
    examples, _ = load_dataset(args.dataset, model_cfg.feature,
                               split_mode=args.split_mode)
    report: Dict[str, Any] = {"n_examples": len(examples)}
    for k in subkeys_for(model_cfg.feature):
        known = unknown = nondef = 0
        for ex in examples:
            feats = np.asarray(ex["feats"][k])
            nondef += int((feats == 0).sum())
            unknown += int((feats == 1).sum())
            known += int((feats > 1).sum())
        defs = known + unknown
        report[k] = {"definitions": defs,
                     "coverage": known / defs if defs else 0.0,
                     "nondef_nodes": nondef}
    print(json.dumps(report))
    return report


def cmd_validate(args) -> Dict[str, Any]:
    """Run a corpus file or a cache directory (every ``*.jsonl`` under
    it) through the data contracts: violating rows go to
    ``quarantine/`` beside each file, with a reason-coded manifest, and
    the command exits 1 (fail-closed: a dirty cache fails a pipeline
    gate)."""
    from deepdfa_tpu_torch.contracts import STATS, gauntlet
    from deepdfa_tpu_torch.core.config import FeatureSpec, subkeys_for

    if args.smoke:
        raise NotImplementedError(
            "validate --smoke needs the corrupt-corpus fuzzer "
            "(contracts/gauntlet.py poison_corpus), which is not ported yet")
    if not args.cache_dir:
        raise ValueError("validate needs a cache dir/corpus (or --smoke)")
    # The required subkeys follow the export's feature: a single-subkey
    # corpus must not quarantine for lacking the other three.
    subkeys = (subkeys_for(FeatureSpec.parse_legacy(args.feature))
               if args.feature else None)
    report = gauntlet.validate_corpus(
        args.cache_dir, max_nodes=args.max_nodes,
        **({"subkeys": subkeys} if subkeys else {}))
    report["ingest_stats"] = STATS.snapshot()
    print(json.dumps({k: v for k, v in report.items() if k != "reports"}))
    return report


def _text_model(tiny: bool, attention_impl: str, remat: bool,
                block_size: int, graph_cfg, device, seed: int,
                gelu_approximate: Optional[bool] = None,
                tokenizer: Optional[str] = None):
    """(LineVul, tokenizer) as ``fit-text`` builds them: codebert-base
    (or the tiny encoder, its position table stretched to cover
    ``block_size``) with the FlowGNN encoder when ``graph_cfg`` is given.
    The card's flash kernels take head width 64 only. ``tokenizer``:
    BPE assets, held to the model's vocabulary and pad id; None for the
    hashing tokenizer."""
    import dataclasses

    from deepdfa_tpu_torch.data.text import (
        HashingCodeTokenizer,
        check_tok_vocab,
        load_bpe_tokenizer,
    )
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
    if tokenizer:
        tok = load_bpe_tokenizer(tokenizer)
        check_tok_vocab(tok, enc.vocab_size, pad_id=enc.pad_token_id)
    else:
        tok = HashingCodeTokenizer(enc.vocab_size)
    model = LineVul(enc, graph_config=graph_cfg, device=device, seed=seed)
    return model, tok


def cmd_fit_text(args) -> Dict[str, Any]:
    import dataclasses

    from deepdfa_tpu_torch.core.config import (
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

    _model_items_only(args.set)
    graph_cfg = dataclasses.replace(
        build_configs(args.config, args.set)["model"], encoder_mode=True,
        label_style="graph")
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
    with _run_log(run_dir):
        tcfg = TransformerTrainConfig(
            learning_rate=args.learning_rate, max_epochs=args.epochs,
            batch_size=args.batch_size,
            eval_batch_size=args.eval_batch_size or args.batch_size,
            block_size=args.block_size, seed=args.seed)
        model, tok = _text_model(args.tiny, args.attention_impl, args.remat,
                                 tcfg.block_size,
                                 graph_cfg if combined else None, args.device,
                                 args.seed, tokenizer=args.tokenizer)
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
            graphs=args.graphs, seed=args.seed, split_mode=args.split_mode)
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
            "split_mode": args.split_mode, "graphs": args.graphs,
            "tokenizer": args.tokenizer,
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
        gelu_approximate=desc.get("gelu_approximate", False),
        tokenizer=args.tokenizer or desc.get("tokenizer"))
    tcfg = TransformerTrainConfig(
        block_size=desc["block_size"], eval_batch_size=args.eval_batch_size,
        batch_size=args.eval_batch_size, seed=desc["seed"])
    dataset = args.dataset or desc["dataset"]
    graphs = (args.graphs or desc["graphs"]) if combined else None
    data, splits, graphs_by_id = load_combined_dataset(
        dataset, graph_cfg.feature, tok, tcfg.block_size, graphs=graphs,
        seed=desc["seed"],
        # The recorded split protocol: re-splitting otherwise would leak
        # fit-time train examples into the reported test metric.
        split_mode=desc.get("split_mode", "random"))
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

    def common(parser, set_help=None,
               dataset_help="synthetic[:N] or an etl export .jsonl"):
        parser.add_argument("--config", action="append", default=[],
                            help="YAML config file (repeatable; later files "
                                 "override earlier ones)")
        parser.add_argument("--set", action="append", default=[],
                            metavar="S.K=V", help=set_help or (
                                "override a config value (repeatable); a "
                                "port flag naming the same field wins"))
        parser.add_argument("--dataset", default="synthetic:256",
                            help=dataset_help)
        parser.add_argument("--split-mode", default="random",
                            choices=["random", "cross-project"],
                            help="cross-project = the Table 7 protocol; a "
                                 ".jsonl corpus's splits.json pins the "
                                 "random one")

    ft = sub.add_parser(
        "fit", help="train FlowGNN (best state by validation loss); "
                    "writes snapshots, meta.json, history.json and the run "
                    "log")
    common(ft)
    ft.add_argument("--message-impl", default=None, choices=GNN_LANES,
                    help="model.message_impl (default persistent)")
    ft.add_argument("--max-epochs", type=int, default=None,
                    help="train.max_epochs (default 25)")
    ft.add_argument("--batch-size", type=int, default=None,
                    help="data.batch_size (default 256)")
    ft.add_argument("--lr", type=float, default=None,
                    help="train.learning_rate (default 1e-3)")
    ft.add_argument("--seed", type=int, default=None,
                    help="train.seed: data, split and init (default 1)")
    device_flag(ft)
    ft.add_argument("--checkpoint-dir", "--out-dir", dest="checkpoint_dir",
                    default=None,
                    help="the run dir: snapshots, meta.json, history.json, "
                         "the run log (default: train.checkpoint_dir, else "
                         "runs/fit)")
    ft.add_argument("--resume", action="store_true",
                    help="continue from the run dir's newest intact "
                         "snapshot")
    ft.set_defaults(func=cmd_fit)
    te = sub.add_parser(
        "test", help="evaluate a fit snapshot on the test split")
    common(te)
    te.add_argument("--checkpoint-dir", required=True)
    te.add_argument("--which", default="best", help="best | last | epoch_N")
    te.add_argument("--message-impl", default=None, choices=GNN_LANES,
                    help="model.message_impl (default persistent)")
    te.add_argument("--seed", type=int, default=None,
                    help="train.seed: the data and split seed fit used "
                         "(default 1)")
    device_flag(te)
    te.set_defaults(func=cmd_test)
    sc = sub.add_parser(
        "score", help="offline batch client of the serving path (cache + "
                      "micro-batcher + bucketed execution)")
    common(sc)
    sc.add_argument("--message-impl", default=None,
                    choices=["segment", "band", "fused", "persistent"],
                    help="model.message_impl (default persistent)")
    sc.add_argument("--checkpoint-dir", default=None,
                    help="cli fit run dir (omit for random-init smoke)")
    sc.add_argument("--which", default="best")
    sc.add_argument("--split", default="all",
                    choices=["all", "train", "val", "test"])
    sc.add_argument("--batch-slots", type=int, default=16)
    device_flag(sc)
    sc.add_argument("--seed", type=int, default=None,
                    help="train.seed: the data and split seed, and the "
                         "random init's without --checkpoint-dir "
                         "(default 0)")
    sc.add_argument("--out-dir", default="runs/score")
    sc.set_defaults(func=cmd_score)
    an = sub.add_parser(
        "analyze", help="abstract-dataflow feature coverage of a dataset "
                        "(the paper's Table 2)")
    common(an)
    an.set_defaults(func=cmd_analyze)
    va = sub.add_parser(
        "validate", help="run a corpus through the data contracts; "
                         "violating rows move to <cache>/quarantine/ with a "
                         "reason-coded manifest; exit 1 when anything was "
                         "quarantined")
    va.add_argument("cache_dir", nargs="?", default=None,
                    help="cache directory (every *.jsonl under it) or one "
                         "corpus file")
    va.add_argument("--smoke", action="store_true",
                    help="the corrupt-corpus self-test (not ported yet: "
                         "raises)")
    va.add_argument("--max-nodes", type=int, default=None,
                    help="oversize-graph cap (default: no cap)")
    va.add_argument("--feature", default=None,
                    help="legacy feature name of the export (sets the "
                         "required subkeys; default: all four)")
    va.set_defaults(func=cmd_validate)
    tx = sub.add_parser(
        "fit-text", help="train LineVul, optionally combined with the "
                         "FlowGNN graph encoder; writes snapshots, "
                         "history.json, model.json, predictions.csv and "
                         "the run log")
    common(tx, set_help="set a field of the graph encoder's FlowGNNConfig "
                        "(model.* only, e.g. model.message_impl=tile); "
                        "repeatable",
           dataset_help="synthetic[:N] or a directory of MSR-layout "
                        "train.csv/val.csv[/test.csv]")
    tx.add_argument("--model", choices=["linevul"], default="linevul")
    tx.add_argument("--graphs", default=None,
                    help="graph source: synthetic or an etl export .jsonl "
                         "(omit for text only)")
    tx.add_argument("--tokenizer", default=None,
                    help="byte-level BPE assets: a tokenizer.json or a "
                         "directory with one, or with a *-vocab.json + "
                         "*-merges.txt pair (default: the hashing "
                         "tokenizer)")
    tx.add_argument("--checkpoint-dir", "--out-dir", dest="checkpoint_dir",
                    default="runs/fit_text",
                    help="the run dir: snapshots, meta.json, model.json, "
                         "history.json, predictions.csv, the run log")
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
    tt.add_argument("--graphs", default=None,
                    help="override the recorded graph source")
    tt.add_argument("--tokenizer", default=None,
                    help="override the recorded tokenizer assets")
    tt.add_argument("--eval-batch-size", type=int, default=16)
    device_flag(tt)
    tt.set_defaults(func=cmd_test_text)
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    logging.basicConfig(level=logging.WARNING,
                        format="%(levelname)s %(name)s: %(message)s")
    args = build_parser().parse_args(argv)
    result = args.func(args)
    # validate carries its gate in exit_code (anything quarantined: 1);
    # every other command reports through its JSON line and exits 0.
    if isinstance(result, dict) and result.get("exit_code"):
        return int(result["exit_code"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
