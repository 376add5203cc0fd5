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
dataset (or one split of it) through ``score_sync`` of the engine that
``serve`` builds, writes ``score_predictions.csv`` and prints the
reference's JSON report plus the hand-written kernels' launch counts;
without ``--checkpoint-dir`` the weights are a random init from
``--seed``. Both take ``--replicas N`` (a ``ServeFleet`` of N engines
behind the content-affine router) and ``--adaptive-flush``, and
``--run-dir`` (the run's telemetry: ``events.jsonl``, ``trace.json``)
and ``--slo`` (an SLO spec); ``serve`` drains on SIGTERM or SIGINT
(new requests 503, every admitted one answered) and exits 75. ``fit-text``
trains DeepDFA+LineVul (the codebert-base encoder from a seeded random init,
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

from deepdfa_tpu_torch.core.config import build_configs

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
    reference's ``load_dataset``): ``synthetic[:N]`` or a dbize cache
    directory (``nodes.csv``), split by ``split_mode`` from ``seed``, or
    a ``.jsonl`` corpus read through
    the contracts, whose sibling ``splits.json`` pins the partition the
    abstract-dataflow vocabulary was built on."""
    from deepdfa_tpu_torch.core.config import subkeys_for
    from deepdfa_tpu_torch.data.combined import load_graph_source
    from deepdfa_tpu_torch.data.splits import make_splits

    if spec.startswith("synthetic") or os.path.isdir(spec):
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


def _telemetry_scope(run_dir: Optional[str]):
    """The command's telemetry run (``<run_dir>/telemetry/events.jsonl``
    and ``trace.json``), or none without ``--run-dir``."""
    from deepdfa_tpu_torch import telemetry

    return (telemetry.run_scope(run_dir) if run_dir
            else contextlib.nullcontext())


def cmd_score(args) -> Dict[str, Any]:
    with _telemetry_scope(args.run_dir):
        return _score(args)


def _score(args) -> Dict[str, Any]:
    import numpy as np

    from deepdfa_tpu_torch.ops import fused_gnn
    from deepdfa_tpu_torch.serve import ServeFleet
    from deepdfa_tpu_torch.serve.http import slo_values
    from deepdfa_tpu_torch.telemetry import slo as slo_mod

    engine, cfgs, restored = _build_serve_engine(args)
    model_cfg, seed = cfgs["model"], cfgs["train"].seed
    _log_warmup(engine)
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
    fleet = (engine if isinstance(engine, ServeFleet)
             else ServeFleet.from_engine(engine))
    # Replicas of one device share one model: count each model once.
    models = {id(r.engine.model): r.engine.model for r in fleet.replicas}
    report = {"n_scored": len(probs), "n_errors": len(errors),
              "errors": errors[:10], "split": args.split, "out": out,
              **restored,
              "serving": engine.snapshot(),
              "compiles_after_warmup": engine.compiles_after_warmup,
              "graphs_captured": engine.graphs_captured,
              "graph_pool_bytes": engine.graph_pool_bytes,
              "device": str(fleet.primary.engine.device),
              "message_impl": model_cfg.message_impl,
              "kernel_launches": launches,
              "over_gate_dispatches": sum(m.over_gate_dispatches
                                          for m in models.values())}
    if args.slo != "none":
        # The spec over the engine's final state (the live monitor's
        # snapshot); a breach exits 1.
        gate = slo_mod.evaluate_report(slo_values(engine), args.slo)
        report["slo_gate"] = gate
        if not gate["ok"]:
            report["exit_code"] = 1
    print(json.dumps(report))
    return report


def _uses_dataflow(model_cfg) -> bool:
    return model_cfg.label_style.startswith("dataflow_solution")


def cmd_fit(args) -> Dict[str, Any]:
    import dataclasses

    from deepdfa_tpu_torch.models.flowgnn import FlowGNN
    from deepdfa_tpu_torch.graphs import segment
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
        history["kernel_launches"] = _launches(fused_gnn, tile_spmm, segment)
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
    gate).

    ``--smoke``: the self-test instead: poison a small synthetic corpus
    (seeded by ``--seed``) across every corruption class of the gauntlet
    and check that each is repaired or quarantined under its expected
    reason code; exit 1 otherwise."""
    from deepdfa_tpu_torch.contracts import STATS, gauntlet
    from deepdfa_tpu_torch.core.config import FeatureSpec, subkeys_for

    if args.smoke:
        report = gauntlet.smoke(seed=args.seed)
        print(json.dumps(report))
        return report
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
                tokenizer: Optional[str] = None,
                model_name: str = "linevul"):
    """(model, tokenizer) as ``fit-text`` builds them (the reference's
    ``_text_model_and_tokenizer``), with the FlowGNN encoder when
    ``graph_cfg`` is given. ``model_name`` "linevul": LineVul at
    codebert-base (or the tiny encoder, its position table stretched to
    cover ``block_size``); the card's flash kernels take head width 64
    only. "codet5": ``DefectModel`` at codet5-base (or ``T5Config.tiny()``),
    which takes no ``--attention-impl`` or ``--remat``. ``tokenizer``: BPE
    assets, held to the model's vocabulary, pad id and (codet5) eos id;
    None for the hashing tokenizer."""
    import dataclasses

    from deepdfa_tpu_torch.data.text import (
        HashingCodeTokenizer,
        HashingT5Tokenizer,
        check_tok_vocab,
        load_bpe_tokenizer,
    )

    if model_name == "codet5":
        from deepdfa_tpu_torch.models.t5 import DefectModel, T5Config

        if attention_impl != "auto" or remat:
            # The T5 stack has its own attention: recording settings that
            # were never in effect would mislead test-text's rebuild.
            raise ValueError(
                "--attention-impl/--remat configure the RoBERTa encoder "
                "(--model linevul); the codet5 stack does not take them")
        cfg = T5Config.tiny() if tiny else T5Config.codet5_base()
        model_cls, tok_cls = DefectModel, HashingT5Tokenizer
        vocab, pad_id, eos_id = (cfg.vocab_size, cfg.pad_token_id,
                                 cfg.eos_token_id)
    elif model_name == "linevul":
        from deepdfa_tpu_torch.models.linevul import LineVul
        from deepdfa_tpu_torch.models.transformer import EncoderConfig
        from deepdfa_tpu_torch.ops import attention

        cfg = EncoderConfig.tiny() if tiny else EncoderConfig()
        if tiny:
            cfg = dataclasses.replace(cfg, max_position_embeddings=max(
                cfg.max_position_embeddings,
                block_size + cfg.pad_token_id + 1))
        cfg = dataclasses.replace(cfg, attention_impl=attention_impl,
                                  remat_layers=remat)
        if gelu_approximate is not None:
            cfg = dataclasses.replace(cfg, gelu_approximate=gelu_approximate)
        head_dim = cfg.hidden_size // cfg.num_heads
        if (not str(device).startswith("cpu")
                and attention_impl in ("auto", "flash")
                and head_dim != attention.KERNEL_HEAD_DIM):
            raise ValueError(
                f"fit-text: head width {head_dim}: the CUDA flash kernels "
                f"take {attention.KERNEL_HEAD_DIM} only; pass "
                "--attention-impl dense or blockwise (or --device cpu)")
        model_cls, tok_cls = LineVul, HashingCodeTokenizer
        vocab, pad_id, eos_id = cfg.vocab_size, cfg.pad_token_id, None
    else:
        raise ValueError(f"unknown text model {model_name!r} (want linevul "
                         "or codet5)")
    if tokenizer:
        tok = load_bpe_tokenizer(tokenizer)
        check_tok_vocab(tok, vocab, pad_id=pad_id, eos_id=eos_id)
    else:
        tok = tok_cls(vocab)
    model = model_cls(cfg, graph_config=graph_cfg, device=device, seed=seed)
    return model, tok


def _text_style(model_name: str) -> str:
    """The text encoding a text model reads: "t5" for codet5, else
    "roberta"."""
    return "t5" if model_name == "codet5" else "roberta"


def _combined_model(args):
    """(LineVul, tokenizer, block_size) of a ``fit-text`` combined run
    dir, restored from its ``model.json`` and ``--combined-which``
    snapshot; ``--tokenizer`` overrides the recorded assets."""
    from deepdfa_tpu_torch.core.config import FeatureSpec, FlowGNNConfig
    from deepdfa_tpu_torch.train.checkpoint import CheckpointManager

    run = args.combined_checkpoint_dir
    with open(os.path.join(run, "model.json")) as f:
        desc = json.load(f)
    if desc.get("model", "linevul") != "linevul" or not desc["combined"]:
        raise ValueError("--combined-checkpoint-dir must hold a combined "
                         "linevul fit-text run (model.json says otherwise)")
    gdict = dict(desc["graph_config"])
    gdict["feature"] = FeatureSpec(**gdict["feature"])
    model, tok = _text_model(
        desc["tiny"], desc.get("attention_impl", "auto"),
        desc.get("remat", False), desc["block_size"], FlowGNNConfig(**gdict),
        args.device, desc["seed"],
        gelu_approximate=desc.get("gelu_approximate", False),
        tokenizer=args.tokenizer or desc.get("tokenizer"))
    model.load_state_dict(
        CheckpointManager(run).restore_params(args.combined_which))
    return model, tok, desc["block_size"]


def _build_serve_engine(args):
    """(engine, configs, restored): the serving engine of ``serve`` and
    ``score`` from ``fit`` and ``fit-text`` run dirs (the reference's
    ``_build_serve_engine``), with the configs it was built from and the
    report fields of a restore that fell back. Without
    ``--checkpoint-dir`` the GNN lane serves a random init from
    ``train.seed`` (the serving stack is real, the scores are not);
    ``--combined-checkpoint-dir`` attaches the DeepDFA+LineVul lane, at
    its recorded block size. ``--replicas N`` over 1 gives a
    ``ServeFleet`` of N engines over the visible cards (all on the CPU
    under ``--device cpu``, on that card under ``--device cuda:K``);
    ``--adaptive-flush`` gives each engine its flush policy."""
    from deepdfa_tpu_torch.models.flowgnn import FlowGNN
    from deepdfa_tpu_torch.serve import (
        AdaptiveFlushPolicy,
        ServeConfig,
        ServeEngine,
        ServeFleet,
    )
    from deepdfa_tpu_torch.train.checkpoint import CheckpointManager

    cfgs = _configs(args, {"message_impl": "persistent", "seed": 0})
    model_cfg, seed = cfgs["model"], cfgs["train"].seed
    if model_cfg.label_style != "graph":
        raise ValueError("serving scores functions; use label_style=graph")
    model = FlowGNN(model_cfg, device=args.device, seed=seed)
    restored: Dict[str, Any] = {}
    if args.checkpoint_dir:
        ckpt = CheckpointManager(args.checkpoint_dir)
        model.load_state_dict(ckpt.restore_params(args.which))
        restored = _restored_fields(ckpt, args.which, args.command)
    else:
        logger.warning("no --checkpoint-dir: serving RANDOM-INIT weights "
                       "(seed %d): the serving stack is real, the scores "
                       "are not", seed)
    combined = tok = None
    knobs: Dict[str, Any] = dict(
        batch_slots=args.batch_slots, deadline_ms=args.deadline_ms,
        queue_capacity=args.queue_capacity,
        cache_capacity=args.cache_capacity, replicas=args.replicas,
        adaptive_flush=args.adaptive_flush)
    if getattr(args, "combined_checkpoint_dir", None):
        combined, tok, knobs["block_size"] = _combined_model(args)
    config = ServeConfig(**knobs)
    if config.replicas > 1:
        fleet = ServeFleet.build(
            model, config, combined_model=combined, tokenizer=tok,
            devices=None if args.device == "cuda" else [args.device])
        logger.info("serving fleet: %d replicas on %s", fleet.size,
                    sorted({str(r.engine.device) for r in fleet.replicas}))
        return fleet, cfgs, restored
    policy = AdaptiveFlushPolicy(config) if config.adaptive_flush else None
    engine = ServeEngine(model, config, device=args.device,
                         combined_model=combined, tokenizer=tok,
                         policy=policy)
    return engine, cfgs, restored


def _log_warmup(engine) -> int:
    """Warm the engine or fleet and log its (lane, bucket) programs, the
    CUDA graphs captured and their pools' bytes."""
    built = engine.warmup()
    logger.info("warmed %d (lane, bucket) pairs: %d CUDA graphs captured, "
                "graph pools %d bytes", built, engine.graphs_captured,
                engine.graph_pool_bytes)
    return built


def _smoke_http(engine, host: str, port: int, n: int, feature,
                slo_monitor=None) -> Dict[str, Any]:
    """Drive the HTTP stack with ``n`` synthetic functions in half-bucket
    chunks, then the first chunk again (it must come back from the
    cache); with a combined lane the same graphs once more with their
    source. ``ok`` when every function was scored on its lane, the
    replay was cached and nothing compiled after warmup. Every POST
    carries a traceparent header, so each request's ``serve.request``
    span joins its client's trace id."""
    import threading
    import urllib.request

    import numpy as np

    from deepdfa_tpu_torch.data.synthetic import synthetic_bigvul
    from deepdfa_tpu_torch.serve.http import ServeHTTPServer
    from deepdfa_tpu_torch.telemetry import context as trace_context

    server = ServeHTTPServer((host, port), engine, slo_monitor=slo_monitor)
    server.start_pump()
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://{host}:{server.server_address[1]}"

    def post(doc):
        req = urllib.request.Request(
            f"{base}/score", data=json.dumps(doc).encode(),
            headers={"Content-Type": "application/json",
                     trace_context.TRACEPARENT_HEADER:
                         trace_context.make_traceparent()})
        with urllib.request.urlopen(req, timeout=120) as resp:
            return json.loads(resp.read())

    try:
        graphs = synthetic_bigvul(n, feature, positive_fraction=0.5, seed=0)
        payload = [
            {"id": int(g["id"]),
             "graph": {"num_nodes": int(g["num_nodes"]),
                       "senders": np.asarray(g["senders"]).tolist(),
                       "receivers": np.asarray(g["receivers"]).tolist(),
                       "feats": {k: np.asarray(v).tolist()
                                 for k, v in g["feats"].items()}}}
            for g in graphs]
        results = []
        chunk = max(server.fleet.config.batch_slots // 2, 1)
        for start in range(0, n, chunk):
            results += post({"functions": payload[start:start + chunk]}
                            )["results"]
        dup = post({"functions": payload[:chunk]})["results"]
        lanes = {"gnn": all(r.get("model") == "gnn" for r in results)}
        if server.engine.combined_model is not None:
            coded = [dict(p, code=f"int f_{p['id']}(char *p) "
                                  "{ return p[0]; }") for p in payload]
            combined = []
            for start in range(0, n, chunk):
                combined += post({"functions": coded[start:start + chunk]}
                                 )["results"]
            lanes["combined"] = all(r.get("model") == "combined"
                                    for r in combined)
        with urllib.request.urlopen(f"{base}/metrics", timeout=30) as resp:
            metrics = json.loads(resp.read())
        after = engine.compiles_after_warmup
        ok = (all("prob" in r for r in results) and all(lanes.values())
              and all(r.get("cached") for r in dup) and not after)
        report = {"smoke": n, "ok": ok, "cached_replay": len(dup),
                  "lanes": lanes, "compiles_after_warmup": after,
                  "metrics": metrics}
        if slo_monitor is not None:
            report["slo"] = slo_monitor.status()
        return report
    finally:
        server.shutdown()
        server.server_close()


def cmd_serve(args) -> Dict[str, Any]:
    """Serve scoring requests over HTTP (``serve/http.py``): bucketed
    micro-batching, warmup of every (lane, bucket) pair, content-hash
    caching, 429 backpressure, GNN-only degradation. ``--smoke N``
    drives the HTTP stack with N synthetic functions, prints the report
    and exits (1 when a check failed). Otherwise serve until SIGTERM or
    SIGINT: the server drains (503 with Retry-After for new requests,
    every admitted one answered), closes the telemetry run and exits 75.
    ``--run-dir`` records the run's telemetry; ``--slo`` runs an SLO spec
    as the live burn-rate monitor behind ``/healthz``'s ``slo``."""
    from deepdfa_tpu_torch.resilience import lifecycle
    from deepdfa_tpu_torch.serve.http import serve_forever
    from deepdfa_tpu_torch.telemetry import slo as slo_mod

    slo_monitor = (slo_mod.SLOMonitor(args.slo)
                   if args.slo != "none" else None)
    with _telemetry_scope(args.run_dir):
        engine, cfgs, _ = _build_serve_engine(args)
        model_cfg = cfgs["model"]
        if not args.no_warmup:
            _log_warmup(engine)
        if args.smoke is not None:
            report = _smoke_http(engine, args.host, args.port, args.smoke,
                                 model_cfg.feature, slo_monitor=slo_monitor)
            if not report["ok"]:
                report["exit_code"] = 1
            print(json.dumps(report))
            return report
        # SIGTERM/SIGINT become the lifecycle's notice (the handlers set
        # a flag; its monitor thread runs the drain).
        coordinator = lifecycle.fresh()
        try:
            notice = serve_forever(engine, args.host, args.port,
                                   slo_monitor=slo_monitor,
                                   port_file=args.port_file)
        finally:
            coordinator.uninstall()
    if notice is None:
        return {}
    coordinator.complete()
    # The reference's record, plus the serving counters at exit (every
    # admitted request is in them).
    report = {"preempted": True, "reason": notice.reason,
              "exit_code": lifecycle.EXIT_PREEMPTED,
              "serving": engine.snapshot()}
    print(json.dumps(report))
    return report


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
    from deepdfa_tpu_torch.graphs import segment
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
                                 args.seed, tokenizer=args.tokenizer,
                                 model_name=args.model)
        pad_id = model.pad_token_id
        logger.warning("training from a RANDOM init (seed %d): no pretrained "
                       "%s weights are loaded", args.seed,
                       "codet5" if args.model == "codet5" else "codebert")
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
            style=_text_style(args.model), graphs=args.graphs,
            seed=args.seed, split_mode=args.split_mode)
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
            subkeys=subkeys, graph_budget=budget, pad_id=pad_id,
            init_params=init_params,
            freeze_submodules=("flowgnn",) if args.freeze_graph else (),
            checkpointer=ckpt)
        history["kernel_launches"] = _launches(attention)
        history["two_pass_dispatches"] = (
            attention.flash_backward.two_pass_dispatches)
        history["graph_kernel_launches"] = _launches(fused_gnn, tile_spmm,
                                                     segment)
        # Params only: restoring for evaluation must not depend on the
        # optimizer's state, whose layout changes with --freeze-graph.
        ckpt.save_best({"params": best_state.params}, history["best_epoch"],
                       metrics={"val_f1": history["best_val_f1"]})
        descriptor = {
            "model": args.model, "tiny": args.tiny,
            "attention_impl": args.attention_impl, "remat": args.remat,
            # The activation LineVul's encoder used (the codet5 stack is
            # relu and ignores it on the rebuild).
            "gelu_approximate": getattr(getattr(
                model, "encoder_config", None), "gelu_approximate", True),
            "combined": combined,
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
                                 budget, pad_id=pad_id,
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
    model_name = desc.get("model", "linevul")
    model, tok = _text_model(
        desc["tiny"], desc.get("attention_impl", "auto"),
        desc.get("remat", False), desc["block_size"],
        graph_cfg if combined else None, args.device, desc["seed"],
        gelu_approximate=desc.get("gelu_approximate", False),
        tokenizer=args.tokenizer or desc.get("tokenizer"),
        model_name=model_name)
    tcfg = TransformerTrainConfig(
        block_size=desc["block_size"], eval_batch_size=args.eval_batch_size,
        batch_size=args.eval_batch_size, seed=desc["seed"])
    dataset = args.dataset or desc["dataset"]
    graphs = (args.graphs or desc["graphs"]) if combined else None
    data, splits, graphs_by_id = load_combined_dataset(
        dataset, graph_cfg.feature, tok, tcfg.block_size,
        style=_text_style(model_name), graphs=graphs, seed=desc["seed"],
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
                        pad_id=model.pad_token_id,
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

    def serve_knobs(parser):
        parser.add_argument("--batch-slots", type=int, default=16,
                            help="largest micro-batch (slot-bucket ladder "
                                 "top)")
        parser.add_argument("--deadline-ms", type=float, default=100.0,
                            help="per-request latency budget; a bucket "
                                 "flushes once the oldest request has spent "
                                 "half of it")
        parser.add_argument("--queue-capacity", type=int, default=256,
                            help="pending requests before 429 rejections")
        parser.add_argument("--cache-capacity", type=int, default=4096,
                            help="content-hash result cache entries (0 = "
                                 "off)")
        # A string default: argparse runs type= over it when it parses,
        # so a malformed DEEPDFA_SERVE_REPLICAS is a parser error of the
        # serving commands alone.
        parser.add_argument("--replicas", type=int,
                            default=os.environ.get(
                                "DEEPDFA_SERVE_REPLICAS", "1"),
                            help="engine replicas behind the content-affine "
                                 "router, each on its shard of the visible "
                                 "cards with its own micro-batcher and pump "
                                 "thread (env DEEPDFA_SERVE_REPLICAS; at "
                                 "most 8)")
        parser.add_argument("--adaptive-flush", action="store_true",
                            default=os.environ.get(
                                "DEEPDFA_ADAPTIVE_FLUSH", "") not in (
                                    "", "0"),
                            help="each replica tunes its flush deadline "
                                 "fraction and fill threshold from its own "
                                 "p99 and occupancy (clamped, with "
                                 "hysteresis; env DEEPDFA_ADAPTIVE_FLUSH=1)")

    def telemetry_flags(parser, slo_default):
        parser.add_argument("--run-dir", default=None,
                            help="telemetry sink: <run-dir>/telemetry/"
                                 "events.jsonl and trace.json (default: "
                                 "none: no events are written)")
        parser.add_argument("--slo", default=slo_default,
                            help="SLO spec: a JSON file, a built-in name "
                                 "(smoke, chaos, default) or 'none'. serve "
                                 "runs it as the live burn-rate monitor "
                                 "behind /healthz; score checks the final "
                                 f"state and exits 1 on a breach (default "
                                 f"{slo_default})")

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
    serve_knobs(sc)
    device_flag(sc)
    sc.add_argument("--seed", type=int, default=None,
                    help="train.seed: the data and split seed, and the "
                         "random init's without --checkpoint-dir "
                         "(default 0)")
    sc.add_argument("--out-dir", default="runs/score")
    telemetry_flags(sc, slo_default="none")
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
                    help="the corrupt-corpus self-test: poison a small "
                         "synthetic corpus across every corruption class "
                         "and grade the quarantine manifest")
    va.add_argument("--max-nodes", type=int, default=None,
                    help="oversize-graph cap (default: no cap)")
    va.add_argument("--feature", default=None,
                    help="legacy feature name of the export (sets the "
                         "required subkeys; default: all four)")
    va.add_argument("--seed", type=int, default=0,
                    help="--smoke's corruption plan seed")
    va.set_defaults(func=cmd_validate)
    tx = sub.add_parser(
        "fit-text", help="train LineVul or CodeT5's defect model, "
                         "optionally combined with the FlowGNN graph "
                         "encoder; writes snapshots, "
                         "history.json, model.json, predictions.csv and "
                         "the run log")
    common(tx, set_help="set a field of the graph encoder's FlowGNNConfig "
                        "(model.* only, e.g. model.message_impl=tile); "
                        "repeatable",
           dataset_help="synthetic[:N] or a directory of MSR-layout "
                        "train.csv/val.csv[/test.csv]")
    tx.add_argument("--model", choices=["linevul", "codet5"],
                    default="linevul",
                    help="linevul (codebert-base) or codet5 (codet5-base's "
                         "DefectModel)")
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
                    help="tiny model shapes (smoke tests). LineVul's tiny "
                         "head width is 8, which the CUDA flash kernels "
                         "(head width 64) do not take: on the card, pass "
                         "--attention-impl dense or blockwise")
    tx.add_argument("--attention-impl", default="auto",
                    choices=["auto", "dense", "blockwise", "flash"],
                    help="LineVul's attention (auto = the flash kernels on "
                         "the card, their plain versions on the CPU); "
                         "codet5 takes auto only")
    tx.add_argument("--remat", action="store_true",
                    help="recompute each LineVul encoder layer in the "
                         "backward (not codet5)")
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
    sv = sub.add_parser(
        "serve", help="HTTP scoring endpoint: bucketed micro-batching over "
                      "warmed (lane, bucket) pairs; the DeepDFA+LineVul lane "
                      "for functions sent with their code")
    sv.add_argument("--config", action="append", default=[],
                    help="YAML config file of the GNN lane (repeatable)")
    sv.add_argument("--set", action="append", default=[], metavar="S.K=V",
                    help="override a config value (repeatable), e.g. "
                         "model.message_impl=fused (default persistent)")
    sv.add_argument("--checkpoint-dir", default=None,
                    help="cli fit run dir (omit for random-init weights)")
    sv.add_argument("--which", default="best")
    sv.add_argument("--combined-checkpoint-dir", default=None,
                    help="fit-text combined linevul run dir: attaches the "
                         "DeepDFA+LineVul lane for functions with code")
    sv.add_argument("--combined-which", default="best")
    sv.add_argument("--tokenizer", default=None,
                    help="override the combined run's recorded tokenizer "
                         "assets")
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=8321)
    sv.add_argument("--port-file", default=None, metavar="FILE",
                    help="write the bound port here after bind (how a "
                         "client finds an ephemeral --port 0)")
    sv.add_argument("--no-warmup", action="store_true",
                    help="skip the warmup (each pair's first flush then "
                         "loads the kernels, captures its CUDA graph and "
                         "counts as a compile)")
    sv.add_argument("--smoke", type=int, default=None, metavar="N",
                    help="drive the HTTP stack with N synthetic functions, "
                         "print the report, exit")
    serve_knobs(sv)
    device_flag(sv)
    telemetry_flags(sv, slo_default="smoke")
    sv.set_defaults(func=cmd_serve)
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
