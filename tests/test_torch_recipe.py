"""The paper's two-stage recipe on the port (train DDFA, fine-tune
DeepDFA+LineVul from its graph encoder, frozen, evaluate) against the
JAX package, on the CPU at small sizes.

- A snapshot the JAX ``fit`` wrote (orbax) reaches the port only through
  the tests' converter: the JAX manager's ``restore_params`` gives numpy
  trees, ``models/convert.py`` turns them into a ``state_dict`` and the
  port's manager saves that. The port's ``cli test`` on it must give the
  JAX ``cli test``'s loss and probabilities within 1e-5 (f32 in another
  order).
- ``fit`` resumed after an epoch repeats the uninterrupted run bit for
  bit (same weights, optimizer state and data order; one thread).
- ``fit_text`` with a grafted, frozen encoder: per-step losses within
  1e-5 of the JAX ``fit_text(init_params=..., freeze_submodules=
  ("flowgnn",))`` on converted weights (dense attention, dropout off),
  and the frozen parameters unchanged bit for bit.
"""

import csv
import dataclasses
import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from deepdfa_tpu import cli as jcli
from deepdfa_tpu.core.config import DataConfig as JDataConfig
from deepdfa_tpu.core.config import FeatureSpec as JFeatureSpec
from deepdfa_tpu.core.config import FlowGNNConfig as JFlowGNNConfig
from deepdfa_tpu.core.config import TrainConfig as JTrainConfig
from deepdfa_tpu.core.config import TransformerTrainConfig as JTextConfig
from deepdfa_tpu.graphs import batch as jbatch
from deepdfa_tpu.models import linevul as jlinevul
from deepdfa_tpu.models import transformer as jtransformer
from deepdfa_tpu.models.flowgnn import FlowGNN as JFlowGNN
from deepdfa_tpu.train import checkpoint as jckpt
from deepdfa_tpu.train import loop as jloop
from deepdfa_tpu.train import text_loop as jtext_loop
from deepdfa_tpu_torch import cli
from deepdfa_tpu_torch.core.config import (
    DataConfig,
    FeatureSpec,
    FlowGNNConfig,
    TrainConfig,
    TransformerTrainConfig,
    subkeys_for,
)
from deepdfa_tpu_torch.data import combined, text
from deepdfa_tpu_torch.data.splits import make_splits
from deepdfa_tpu_torch.data.synthetic import synthetic_bigvul
from deepdfa_tpu_torch.models import linevul, transformer
from deepdfa_tpu_torch.models.convert import flowgnn_from_flax, linevul_from_flax
from deepdfa_tpu_torch.models.flowgnn import FlowGNN
from deepdfa_tpu_torch.train import checkpoint as pckpt
from deepdfa_tpu_torch.train import loop, text_loop

SUBKEYS = ["api", "datatype", "literal", "operator"]
TOL = 1e-5
# cli fit and fit-text at the sizes these tests run: the published
# FlowGNN (the CLI's only width) on a few graphs, the tiny text encoder.
FIT = ["--dataset", "synthetic:48", "--device", "cpu", "--batch-size", "16",
       "--message-impl", "segment"]
FIT_TEXT = ["fit-text", "--dataset", "synthetic:40", "--graphs", "synthetic",
            "--tiny", "--block-size", "32", "--batch-size", "8", "--device",
            "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: bit-for-bit comparisons, and the first
    multi-threaded ``torch.exp`` of a process can be off in one thread's
    chunk (tests/test_torch_linevul.py, ``scripts/torch_first_exp_race.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _json_out(capsys):
    lines = [l for l in capsys.readouterr().out.strip().splitlines()
             if l.startswith("{")]
    return json.loads(lines[-1])


def _probs(path):
    with open(path) as f:
        return {int(r["index"]): float(r["prob"]) for r in csv.DictReader(f)}


def _flip_byte(path):
    fp = os.path.join(path, pckpt.STATE_FILE)
    with open(fp, "r+b") as f:
        f.seek(os.path.getsize(fp) // 2)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))


# ---------------------------------------------------------------------------
# (d) A JAX fit snapshot restored by the port's cli test
# ---------------------------------------------------------------------------


def test_jax_fit_snapshot_gives_the_jax_cli_test_result(tmp_path, capsys,
                                                        monkeypatch):
    monkeypatch.chdir(tmp_path)
    sets = ["--set", "data.batch_size=16", "--set", "data.eval_batch_size=16"]
    jax_run, port_run = str(tmp_path / "jax"), str(tmp_path / "port")
    jcli.main(["fit", "--dataset", "synthetic:48", "--checkpoint-dir", jax_run,
               "--set", "train.max_epochs=2", *sets])
    capsys.readouterr()
    jcli.main(["test", "--dataset", "synthetic:48", "--checkpoint-dir",
               jax_run, *sets])
    want = _json_out(capsys)

    # The JAX cli test's probabilities: its own restore and evaluate.
    jm = jckpt.CheckpointManager(jax_run)
    params = jm.restore_params("best")
    jcfg, data = JFlowGNNConfig(), JDataConfig(batch_size=16)
    examples, splits = jcli.load_dataset("synthetic:48", jcfg.feature, seed=1)
    jmodel = JFlowGNN(jcfg)
    batch = next(jloop._batches(examples, splits["test"], data, SUBKEYS, 16,
                                shape_series=None))
    state, _ = jloop.make_train_state(jmodel, batch, JTrainConfig())
    state = state.replace(params=params)
    res = jloop.evaluate(jax.jit(jloop.make_eval_step(jmodel, JTrainConfig())),
                         state, examples, splits["test"], data, SUBKEYS)
    assert abs(res.loss - want["loss"]) <= 1e-7

    # Through the converter into a port run dir, then the port's cli test.
    pm = pckpt.CheckpointManager(port_run)
    pm.save_best({"params": flowgnn_from_flax(params)},
                 jm.best_meta["best_epoch"],
                 val_loss=jm.best_meta["best_val_loss"])
    cli.main(["test", "--dataset", "synthetic:48", "--checkpoint-dir",
              port_run, "--message-impl", "segment", "--device", "cpu"])
    got = _json_out(capsys)
    assert abs(got["loss"] - want["loss"]) <= TOL, (got, want)
    for k in ("acc", "precision", "recall", "f1"):
        assert got[k] == pytest.approx(want[k], abs=1e-6)
    probs = _probs(os.path.join(port_run, "test_predictions.csv"))
    assert sorted(probs) == sorted(int(i) for i in res.graph_ids)
    for i, p in zip(res.graph_ids, res.probs):
        assert abs(probs[int(i)] - float(p)) <= TOL


# ---------------------------------------------------------------------------
# (e) fit --resume
# ---------------------------------------------------------------------------


def test_cli_fit_resumed_equals_the_uninterrupted_run(tmp_path, capsys):
    full, cut = str(tmp_path / "full"), str(tmp_path / "cut")
    cli.main(["fit", *FIT, "--max-epochs", "2", "--checkpoint-dir", full])
    want = _json_out(capsys)
    cli.main(["fit", *FIT, "--max-epochs", "1", "--checkpoint-dir", cut])
    cli.main(["fit", *FIT, "--max-epochs", "2", "--checkpoint-dir", cut,
              "--resume"])
    got = _json_out(capsys)
    assert got == want
    h_full = json.loads(open(os.path.join(full, "history.json")).read())
    h_cut = json.loads(open(os.path.join(cut, "history.json")).read())
    assert [e["epoch"] for e in h_cut["epochs"]] == [1]
    assert h_cut["resumed_from"] == {"name": "last", "epoch": 0,
                                     "fallback": False}
    for key in ("step_losses", "val_loss", "train_loss", "val_metrics"):
        assert h_cut["epochs"][0][key] == h_full["epochs"][1][key], key
    for name in ("last", "best"):
        a = pckpt.CheckpointManager(full).restore(name)
        b = pckpt.CheckpointManager(cut).restore(name)
        assert a["step"] == b["step"]
        for k in a["params"]:
            assert torch.equal(a["params"][k], b["params"][k]), k


def _tiny_flowgnn_pair():
    limits = dict(limit_all=30, limit_subkeys=30)
    small = dict(hidden_dim=8, n_steps=4, num_output_layers=2)
    return (JFlowGNNConfig(feature=JFeatureSpec(**limits), **small),
            FlowGNNConfig(feature=FeatureSpec(**limits), **small))


def test_fit_resume_matches_the_jax_resume(tmp_path):
    jcfg, pcfg = _tiny_flowgnn_pair()
    ex = synthetic_bigvul(96, pcfg.feature, positive_fraction=0.5, seed=2)
    splits = make_splits(ex, "random", seed=0)
    data = dict(batch_size=16, eval_batch_size=16)
    train = dict(learning_rate=2e-3, seed=0)
    jmodel = JFlowGNN(jcfg)
    batch = next(jloop._batches(ex, splits["train"], JDataConfig(**data),
                                SUBKEYS, 16, shape_series=None))
    state, _ = jloop.make_train_state(jmodel, batch, JTrainConfig(**train))
    init = flowgnn_from_flax(jax.tree_util.tree_map(np.asarray, state.params))

    def port_fit(run, epochs, resume=False):
        model = FlowGNN(pcfg, device="cpu")
        model.load_state_dict(init)
        return model, loop.fit(
            model, ex, splits, TrainConfig(max_epochs=epochs, **train),
            DataConfig(**data),
            checkpointer=pckpt.CheckpointManager(str(tmp_path / run)),
            resume=resume)[1]

    model_full, full = port_fit("full", 2)
    port_fit("cut", 1)
    model_cut, cut = port_fit("cut", 2, resume=True)
    assert cut["epochs"][0]["step_losses"] == full["epochs"][1]["step_losses"]
    assert cut["epochs"][0]["val_loss"] == full["epochs"][1]["val_loss"]
    for a, b in zip(model_full.state_dict().values(),
                    model_cut.state_dict().values()):
        assert torch.equal(a, b)
    assert (cut["best_epoch"], cut["best_val_loss"]) == (
        full["best_epoch"], full["best_val_loss"])

    jrun = str(tmp_path / "jax")
    for epochs, resume in ((1, False), (2, True)):
        _, jhist = jloop.fit(
            JFlowGNN(jcfg), ex, splits, JTrainConfig(max_epochs=epochs,
                                                     **train),
            JDataConfig(**data), checkpointer=jckpt.CheckpointManager(jrun),
            resume=resume)
    assert [e["epoch"] for e in jhist["epochs"]] == [1]
    assert jhist["best_epoch"] == cut["best_epoch"]
    assert abs(jhist["best_val_loss"] - cut["best_val_loss"]) <= TOL
    assert abs(jhist["epochs"][0]["val_loss"]
               - cut["epochs"][0]["val_loss"]) <= TOL


def test_resume_falls_back_and_says_so(tmp_path, capsys, caplog):
    run = str(tmp_path / "run")
    cli.main(["fit", *FIT, "--max-epochs", "2", "--checkpoint-dir", run])
    capsys.readouterr()
    _flip_byte(os.path.join(run, "last"))
    cli.main(["fit", *FIT, "--max-epochs", "3", "--checkpoint-dir", run,
              "--resume"])
    got = _json_out(capsys)
    history = json.loads(open(os.path.join(run, "history.json")).read())
    best_epoch = history["resumed_from"]["epoch"]
    assert got["restored_snapshot"] == "best" and got["restored_fallback"]
    assert [e["epoch"] for e in history["epochs"]] == list(
        range(best_epoch + 1, 3))
    assert "failed integrity verification" in caplog.text
    # Every snapshot damaged: log it and train from scratch.
    for name in ("best", "last"):
        _flip_byte(os.path.join(run, name))
    cli.main(["fit", *FIT, "--max-epochs", "2", "--checkpoint-dir", run,
              "--resume"])
    history = json.loads(open(os.path.join(run, "history.json")).read())
    assert [e["epoch"] for e in history["epochs"]] == [0, 1]
    assert "restarting from scratch" in caplog.text


# ---------------------------------------------------------------------------
# (f) fit_text with the encoder grafted and frozen
# ---------------------------------------------------------------------------


def test_frozen_encoder_fit_text_matches_jax():
    vocab, block = 512, 32
    feat, jfeat = FeatureSpec(limit_all=30), JFeatureSpec(limit_all=30)
    gkw = dict(hidden_dim=4, n_steps=2)
    tok = text.HashingCodeTokenizer(vocab)
    data, splits, graphs = combined.load_combined_dataset(
        "synthetic:40", feat, tok, block, graphs="synthetic", seed=1)
    graphs, budget = combined.graph_join_and_budget(list(graphs.values()), 8)
    kw = dict(graphs_by_id=graphs, subkeys=SUBKEYS, graph_budget=budget)
    enc = dict(attention_impl="dense", dropout_rate=0.0,
               max_position_embeddings=40)
    jmodel = jlinevul.LineVul(
        dataclasses.replace(jtransformer.EncoderConfig.tiny(vocab_size=vocab),
                            **enc),
        JFlowGNNConfig(feature=jfeat, encoder_mode=True, **gkw))
    pmodel = linevul.LineVul(
        dataclasses.replace(transformer.EncoderConfig.tiny(vocab_size=vocab),
                            **enc),
        FlowGNNConfig(feature=feat, encoder_mode=True, **gkw), device="cpu")
    jcfg = JTextConfig(batch_size=8, eval_batch_size=8, block_size=block,
                       learning_rate=1e-3, max_epochs=2)
    pcfg = TransformerTrainConfig(batch_size=8, eval_batch_size=8,
                                  block_size=block, learning_rate=1e-3,
                                  max_epochs=2)

    # The "trained DDFA": a graph-level FlowGNN of the same widths, from
    # another seed than the combined model's encoder.
    example = next(jtext_loop.text_graph_batches(
        data, splits["train"][:8], 8, **kw))
    ddfa = jax.tree_util.tree_map(np.asarray, JFlowGNN(JFlowGNNConfig(
        feature=jfeat, **gkw)).init(jax.random.PRNGKey(7), example.graphs))
    jinit = {"params": {"flowgnn": jckpt.load_encoder_params(ddfa)["params"]}}
    pinit = {f"flowgnn.{k}": v for k, v in pckpt.load_encoder_params(
        flowgnn_from_flax(ddfa)).items()}

    steps = 2 * -(-len(splits["train"]) // 8)
    state, _ = jtext_loop.make_text_train_state(jmodel, example, jcfg, steps)
    pmodel.load_state_dict(linevul_from_flax(state.params))
    pooling = {k: v.clone() for k, v in pmodel.state_dict().items()
               if k.startswith("flowgnn.pooling.")}
    untouched = {k: v.clone() for k, v in pmodel.state_dict().items()
                 if k.startswith("roberta.layer.0.attention.query")}

    want = []
    real = jtext_loop._run_step

    def record(step_fn, st, batch):
        out = real(step_fn, st, batch)
        if len(out) == 3:  # a train step: (state, loss, stats)
            want.append(float(out[1]))
        return out

    try:
        jtext_loop._run_step = record
        jbest, jhist = jtext_loop.fit_text(
            jmodel, data, splits, jcfg, init_params=jinit,
            freeze_submodules=("flowgnn",), **kw)
    finally:
        jtext_loop._run_step = real
    best, hist = text_loop.fit_text(pmodel, data, splits, pcfg,
                                    init_params=pinit,
                                    freeze_submodules=("flowgnn",), **kw)
    got = [x for e in hist["epochs"] for x in e["step_losses"]]
    assert len(got) == len(want) == steps
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    assert hist["best_epoch"] == jhist["best_epoch"]

    # Frozen: no gradient, no update, bit for bit the grafted encoder and
    # the seeded pooling, in the model and in its best state.
    frozen = {k: v for k, v in pmodel.named_parameters()
              if k.startswith("flowgnn.")}
    assert frozen and all(not p.requires_grad and p.grad is None
                          for p in frozen.values())
    for sd in (pmodel.state_dict(), best.params):
        for k, v in pinit.items():
            assert torch.equal(sd[k], v), k
        for k, v in pooling.items():
            assert torch.equal(sd[k], v), k
        for k, v in untouched.items():
            assert not torch.equal(sd[k], v), k  # the text side trains
    want_graph = linevul_from_flax(jbest.params)
    for k in frozen:
        assert torch.equal(best.params[k], want_graph[k]), k


def test_merge_params_refuses_unknown_keys_and_shapes():
    model = FlowGNN(_tiny_flowgnn_pair()[1], device="cpu")
    sd = model.state_dict()
    with pytest.raises(KeyError, match="not present"):
        text_loop._merge_params(model, {"flowgnn.embeds.api.embedding":
                                        sd["embeds.api.embedding"]})
    with pytest.raises(ValueError, match="shape"):
        text_loop._merge_params(model, {"embeds.api.embedding":
                                        torch.zeros(3, 3)})
    text_loop._merge_params(model, {"embeds.api.embedding":
                                    torch.ones_like(sd["embeds.api.embedding"])})
    assert torch.equal(model.embeds["api"].embedding,
                       torch.ones_like(sd["embeds.api.embedding"]))


# ---------------------------------------------------------------------------
# (g)-(i) The CLI chain
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("argv", [
    ["--ddfa-checkpoint", "DDFA"],  # no --graphs
    ["--graphs", "synthetic", "--freeze-graph"],  # nothing loaded to freeze
])
def test_fit_text_refusals_are_the_reference_errors(tmp_path, argv):
    argv = [a.replace("DDFA", str(tmp_path / "ddfa")) for a in argv]
    common = ["fit-text", "--dataset", "synthetic:16", "--tiny", "--epochs",
              "1", "--batch-size", "8", "--block-size", "32"]
    with pytest.raises(ValueError) as want:
        jcli.main([*common, "--checkpoint-dir", str(tmp_path / "j"), *argv])
    with pytest.raises(ValueError) as got:
        cli.main([*common, "--checkpoint-dir", str(tmp_path / "p"),
                  "--device", "cpu", *argv])
    assert str(got.value) == str(want.value)


@pytest.fixture(scope="module")
def ddfa_run(tmp_path_factory):
    """A cli fit run dir (published widths, segment lane, 2 epochs)."""
    run = str(tmp_path_factory.mktemp("ddfa") / "run")
    cli.main(["fit", *FIT, "--max-epochs", "2", "--checkpoint-dir", run])
    return run


def test_fit_text_frozen_then_test_text_repeats_it(tmp_path, capsys,
                                                   ddfa_run):
    run = str(tmp_path / "combined")
    cli.main([*FIT_TEXT, "--epochs", "2", "--ddfa-checkpoint", ddfa_run,
              "--which", "best", "--freeze-graph", "--checkpoint-dir", run])
    result = _json_out(capsys)
    assert not any(k.startswith("ddfa_restored") for k in result)
    for artifact in ("model.json", "history.json", "predictions.csv",
                     "best", "last", "meta.json"):
        assert os.path.exists(os.path.join(run, artifact)), artifact
    meta = json.loads(open(os.path.join(run, "meta.json")).read())
    assert meta["best_metrics"] == {"val_f1": result["best_val_f1"]}

    # The params-only best: the grafted encoder, bit for bit, and the
    # pooling at the combined model's seeded init.
    best = pckpt.CheckpointManager(run).restore("best")
    assert set(best) == {"params"}
    encoder = pckpt.load_encoder_params(
        pckpt.CheckpointManager(ddfa_run).restore_params("best"))
    for k, v in encoder.items():
        assert torch.equal(best["params"][f"flowgnn.{k}"], v), k
    desc = json.loads(open(os.path.join(run, "model.json")).read())
    fresh, _ = cli._text_model(True, "auto", False, 32, FlowGNNConfig(
        encoder_mode=True), "cpu", desc["seed"])
    pooling = [k for k in best["params"] if k.startswith("flowgnn.pooling.")]
    assert pooling
    for k in pooling:
        assert torch.equal(best["params"][k], fresh.state_dict()[k]), k

    # test-text rebuilds the model and repeats fit-text's own test.
    cli.main(["test-text", "--checkpoint-dir", run, "--device", "cpu",
              "--eval-batch-size", "8"])
    report = _json_out(capsys)
    assert report["loss"] == result["test"]["loss"]
    assert report["f1"] == result["test"]["f1"]
    assert report["split"] == "test" and report["num_missing"] == 0
    with open(os.path.join(run, "predictions.csv")) as f:
        fit_rows = f.read()
    with open(os.path.join(run, "test_predictions.csv")) as f:
        assert f.read() == fit_rows


def test_fit_text_unfrozen_from_ddfa_trains_the_encoder(tmp_path, capsys,
                                                        ddfa_run):
    run = str(tmp_path / "combined")
    cli.main([*FIT_TEXT, "--epochs", "1", "--learning-rate", "1e-3",
              "--ddfa-checkpoint", ddfa_run, "--which", "last", "--no-test",
              "--checkpoint-dir", run])
    result = _json_out(capsys)
    assert "test" not in result
    assert not os.path.exists(os.path.join(run, "predictions.csv"))
    best = pckpt.CheckpointManager(run).restore_params("best")
    encoder = pckpt.load_encoder_params(
        pckpt.CheckpointManager(ddfa_run).restore_params("last"))
    assert not all(torch.equal(best[f"flowgnn.{k}"], v)
                   for k, v in encoder.items())


def test_score_and_test_give_the_restored_models_probabilities(
        tmp_path, capsys, ddfa_run):
    cli.main(["score", "--dataset", "synthetic:48", "--seed", "1",
              "--split", "test", "--message-impl", "segment", "--device",
              "cpu", "--checkpoint-dir", ddfa_run, "--out-dir",
              str(tmp_path / "score")])
    report = _json_out(capsys)
    assert report["split"] == "test" and report["n_errors"] == 0
    assert "restored_fallback" not in report
    scored = _probs(str(tmp_path / "score" / "score_predictions.csv"))

    cfg = FlowGNNConfig(message_impl="segment")
    model = FlowGNN(cfg, device="cpu")
    model.load_state_dict(pckpt.CheckpointManager(ddfa_run).restore_params())
    examples, splits = cli.load_dataset("synthetic:48", cfg.feature, 1)
    res = loop.evaluate(loop.make_eval_step(model, TrainConfig()), examples,
                        splits["test"], DataConfig(), subkeys_for(cfg.feature),
                        "cpu")
    assert sorted(scored) == sorted(int(i) for i in res.graph_ids)
    for i, p in zip(res.graph_ids, res.probs):
        assert abs(scored[int(i)] - float(p)) <= TOL

    cli.main(["test", "--dataset", "synthetic:48", "--message-impl",
              "segment", "--device", "cpu", "--checkpoint-dir", ddfa_run])
    assert _json_out(capsys)["loss"] == res.loss
    tested = _probs(os.path.join(ddfa_run, "test_predictions.csv"))
    assert tested.keys() == scored.keys()
    assert all(abs(tested[i] - scored[i]) <= TOL for i in tested)


def test_damaged_snapshot_is_reported_by_test_and_score(tmp_path, capsys,
                                                        ddfa_run):
    import shutil

    run = str(tmp_path / "run")
    shutil.copytree(ddfa_run, run)
    _flip_byte(os.path.join(run, "best"))
    cli.main(["test", "--dataset", "synthetic:48", "--message-impl",
              "segment", "--device", "cpu", "--checkpoint-dir", run])
    report = _json_out(capsys)
    assert report["restored_snapshot"] == "last"
    assert report["restored_fallback"] is True
    cli.main(["score", "--dataset", "synthetic:48", "--seed", "1",
              "--message-impl", "segment", "--device", "cpu",
              "--checkpoint-dir", run, "--out-dir", str(tmp_path / "s")])
    report = _json_out(capsys)
    assert report["restored_snapshot"] == "last"
    with pytest.raises(FileNotFoundError, match="epoch_3"):
        cli.main(["test", "--dataset", "synthetic:48", "--device", "cpu",
                  "--checkpoint-dir", run, "--which", "epoch_3"])


@pytest.mark.parametrize("command", ["test", "score"])
def test_restoring_commands_default_to_the_card(command, ddfa_run,
                                                monkeypatch):
    """No ``--device``: the card, and without one a refusal, never a
    quiet move to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main([command, "--dataset", "synthetic:48", "--checkpoint-dir",
                  ddfa_run])
