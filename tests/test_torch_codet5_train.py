"""Training and evaluating the CodeT5 defect model with the port
(``train/text_loop.py`` over ``DefectModel``, ``cli fit-text --model
codet5`` and ``test-text``), against the JAX package where it has the
same path.

The trajectory runs ``T5Config.tiny()`` (alone and combined with a tiny
FlowGNN, dropout off) through the port's train step and the JAX
package's, 20 steps from the same parameters and batches at lr 1e-4:
losses within 1e-4 (measured 2.5e-6 alone, 1.7e-6 combined). At lr
1e-3 the text-only gap reaches 1.0e-4 at step 12: one entry of a rare
token's embedding row gets a gradient near zero (-4.8e-6 in JAX,
+2.9e-5 here, both f32 noise against the tensor's largest entry, 1.2)
whose signs differ, and AdamW's per-entry normalisation turns each into
a full step of lr. The CLI runs at ``--tiny`` shapes on the CPU.
"""

import argparse
import dataclasses
import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from deepdfa_tpu import cli as jcli
from deepdfa_tpu.core.config import FeatureSpec as JFeatureSpec
from deepdfa_tpu.core.config import FlowGNNConfig as JFlowGNNConfig
from deepdfa_tpu.core.config import TransformerTrainConfig as JTrainConfig
from deepdfa_tpu.data import text as jtext
from deepdfa_tpu.data.synthetic import synthetic_bigvul as j_synthetic
from deepdfa_tpu.models import t5 as jt5
from deepdfa_tpu.train import text_loop as jloop
from deepdfa_tpu_torch import cli
from deepdfa_tpu_torch.core.config import (
    FeatureSpec,
    FlowGNNConfig,
    TransformerTrainConfig,
)
from deepdfa_tpu_torch.data import combined, text
from deepdfa_tpu_torch.models import t5
from deepdfa_tpu_torch.models.convert import defect_from_flax
from deepdfa_tpu_torch.train import checkpoint as pckpt
from deepdfa_tpu_torch.train import text_loop

BLOCK = 32
SUBKEYS = ["api", "datatype", "literal", "operator"]
TRAJ_TOL = 1e-4
# cli fit (the published FlowGNN on a few graphs) and fit-text --model
# codet5 --tiny at the sizes these tests run.
FIT = ["fit", "--dataset", "synthetic:48", "--device", "cpu",
       "--batch-size", "16", "--message-impl", "segment", "--max-epochs",
       "1"]
FIT_TEXT = ["fit-text", "--model", "codet5", "--dataset", "synthetic:40",
            "--tiny", "--block-size", str(BLOCK), "--batch-size", "8",
            "--epochs", "1"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: exact comparisons of two CPU runs, and the
    first multi-threaded ``torch.exp`` of a process can be off in one
    thread's chunk (``scripts/torch_first_exp_race.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _json_out(capsys):
    lines = [l for l in capsys.readouterr().out.strip().splitlines()
             if l.startswith("{")]
    return json.loads(lines[-1])


def _examples(n, seed=0):
    ex = j_synthetic(n, JFeatureSpec(limit_all=30), positive_fraction=0.5,
                     seed=seed)
    for i, e in enumerate(ex):
        e["label"] = int(np.asarray(e["vuln"]).max())
        e["id"] = i
    return ex


def _t5_data(n=48, seed=0):
    ex = _examples(n, seed)
    rows = jtext.attach_synthetic_text([dict(e) for e in ex], seed=seed)
    data = jtext.encode_dataset(rows, jtext.HashingT5Tokenizer(128),
                                block_size=BLOCK, style="t5")
    return data, {int(e["id"]): e for e in ex}


def test_text_graph_batches_pad_with_the_t5_pad_id_as_jax():
    data, graphs = _t5_data(21, seed=1)
    kw = dict(graphs_by_id=graphs, subkeys=SUBKEYS, pad_id=0,
              graph_budget={"max_nodes": 400, "max_edges": 1600})
    want = list(jloop.text_graph_batches(
        data, np.arange(21), 8, shuffle_rng=np.random.default_rng(2), **kw))
    got = list(text_loop.text_graph_batches(
        data, np.arange(21), 8, shuffle_rng=np.random.default_rng(2), **kw))
    assert len(got) == len(want) == 3
    for gb, jb in zip(got, want):
        for name in ("input_ids", "labels", "example_mask", "index"):
            a, b = getattr(gb, name), getattr(jb, name)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    assert (got[-1].input_ids[-3:] == 0).all()  # padded rows: pad id 0


def _trajectory(graph_impl):
    """20 train steps of the tiny DefectModel (dropout off; with a tiny
    FlowGNN of ``graph_impl`` unless None), the port's step against the
    JAX package's: (port losses, JAX losses)."""
    jcfg = dataclasses.replace(jt5.T5Config.tiny(), dropout_rate=0.0)
    pcfg = dataclasses.replace(t5.T5Config.tiny(), dropout_rate=0.0)
    gkw = dict(hidden_dim=4, n_steps=2, encoder_mode=True,
               message_impl=graph_impl or "segment")
    jg = JFlowGNNConfig(feature=JFeatureSpec(limit_all=30), **gkw)
    pg = FlowGNNConfig(feature=FeatureSpec(limit_all=30), **gkw)
    jmodel = jt5.DefectModel(jcfg, graph_config=jg if graph_impl else None)
    pmodel = t5.DefectModel(pcfg, graph_config=pg if graph_impl else None,
                            device="cpu")
    data, graphs = _t5_data()
    kw = dict(pad_id=0)
    if graph_impl:
        kw.update(graphs_by_id=graphs, subkeys=SUBKEYS,
                  graph_budget={"max_nodes": 512, "max_edges": 2048})
    train = np.arange(40)
    cfg_j = JTrainConfig(batch_size=8, max_epochs=4, learning_rate=1e-4,
                         block_size=BLOCK)
    cfg_p = TransformerTrainConfig(batch_size=8, max_epochs=4,
                                   learning_rate=1e-4, block_size=BLOCK)
    max_steps = 20

    def batches(loop):
        rng = np.random.default_rng(0)
        while True:
            yield from loop.text_graph_batches(data, train, 8,
                                               shuffle_rng=rng, **kw)

    example = next(jloop.text_graph_batches(data, train, 8, **kw))
    state, tx = jloop.make_text_train_state(jmodel, example, cfg_j, max_steps)
    pmodel.load_state_dict(defect_from_flax(state.params))
    jstep = jax.jit(jloop.make_text_train_step(jmodel, tx, cfg_j))
    jb = batches(jloop)
    want = []
    for _ in range(max_steps):
        b = next(jb)
        state, loss, _ = jstep(state, jnp.asarray(b.input_ids),
                               jnp.asarray(b.labels),
                               jnp.asarray(b.example_mask), b.graphs)
        want.append(float(loss))
    opt = text_loop.make_text_optimizer(pmodel.parameters(), cfg_p)
    step = text_loop.make_text_train_step(pmodel, opt, cfg_p)
    schedule = text_loop.make_schedule(cfg_p, max_steps)
    pb = batches(text_loop)
    got = [float(step(next(pb), schedule(i))[0]) for i in range(max_steps)]
    return got, want


@pytest.mark.parametrize("graph_impl", [None, "segment"])
def test_train_trajectory_matches_jax(graph_impl):
    got, want = _trajectory(graph_impl)
    np.testing.assert_allclose(got, want, atol=TRAJ_TOL, rtol=0)
    assert want[-1] < want[0]  # it trains


def test_fit_text_pads_with_the_models_pad_id(monkeypatch):
    tok = text.HashingT5Tokenizer(128)
    data, splits, graphs = combined.load_combined_dataset(
        "synthetic:30", FeatureSpec(limit_all=30), tok, BLOCK, style="t5",
        graphs="synthetic", seed=1)
    graphs, budget = combined.graph_join_and_budget(list(graphs.values()), 8)
    model = t5.DefectModel(
        dataclasses.replace(t5.T5Config.tiny(), dropout_rate=0.0),
        FlowGNNConfig(feature=FeatureSpec(limit_all=30), hidden_dim=4,
                      n_steps=2, encoder_mode=True), device="cpu")
    seen = []
    real = text_loop.text_graph_batches

    def spy(*args, **kw):
        seen.append(kw["pad_id"])
        return real(*args, **kw)

    monkeypatch.setattr(text_loop, "text_graph_batches", spy)
    cfg = TransformerTrainConfig(batch_size=8, block_size=BLOCK,
                                 learning_rate=1e-3, max_epochs=2)
    best, history = text_loop.fit_text(model, data, splits, cfg,
                                       graphs_by_id=graphs, subkeys=SUBKEYS,
                                       graph_budget=budget)
    assert seen and set(seen) == {0}
    e = history["epochs"]
    assert len(e) == 2 and all(np.isfinite(r["step_losses"]).all()
                               for r in e)
    assert best.step == 3 * (history["best_epoch"] + 1)  # 24 rows of 8


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ddfa_run(tmp_path_factory):
    run = str(tmp_path_factory.mktemp("ddfa") / "run")
    cli.main([*FIT, "--checkpoint-dir", run])
    return run


@pytest.fixture(scope="module")
def codet5_run(tmp_path_factory, ddfa_run):
    """(run dir, fit-text's result): DeepDFA+CodeT5 from the fit run's
    graph encoder, frozen."""
    run = str(tmp_path_factory.mktemp("codet5") / "run")
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main([*FIT_TEXT, "--graphs", "synthetic", "--device", "cpu",
                  "--ddfa-checkpoint", ddfa_run, "--which", "best",
                  "--freeze-graph", "--checkpoint-dir", run])
    return run, json.loads(out.getvalue().strip().splitlines()[-1])


def test_cli_fit_text_codet5_frozen_then_test_text(codet5_run, ddfa_run,
                                                   capsys):
    run, result = codet5_run
    assert "f1" in result["test"] and result["test"]["num_missing"] == 0
    desc = json.loads(open(os.path.join(run, "model.json")).read())
    assert desc["model"] == "codet5" and desc["combined"] and desc["tiny"]
    history = json.loads(open(os.path.join(run, "history.json")).read())
    # On the CPU the wrappers take the plain versions: no launches.
    assert set(history["graph_kernel_launches"].values()) == {0}
    best = pckpt.CheckpointManager(run).restore_params("best")
    assert any(k.startswith("t5.decoder.block.1.cross_attn.") for k in best)
    encoder = pckpt.load_encoder_params(
        pckpt.CheckpointManager(ddfa_run).restore_params("best"))
    for k, v in encoder.items():
        assert torch.equal(best[f"flowgnn.{k}"], v), k
    cli.main(["test-text", "--checkpoint-dir", run, "--device", "cpu",
              "--eval-batch-size", "8"])
    report = _json_out(capsys)
    assert report["loss"] == result["test"]["loss"]
    assert report["split"] == "test"
    with open(os.path.join(run, "predictions.csv")) as f:
        fit_rows = f.read()
    with open(os.path.join(run, "test_predictions.csv")) as f:
        assert f.read() == fit_rows


def test_cli_fit_text_codet5_text_only(tmp_path, capsys):
    run = str(tmp_path / "run")
    cli.main([*FIT_TEXT, "--device", "cpu", "--checkpoint-dir", run])
    result = _json_out(capsys)
    desc = json.loads(open(os.path.join(run, "model.json")).read())
    assert desc["model"] == "codet5" and not desc["combined"]
    cli.main(["test-text", "--checkpoint-dir", run, "--device", "cpu",
              "--eval-batch-size", "8"])
    assert _json_out(capsys)["loss"] == result["test"]["loss"]
    params = pckpt.CheckpointManager(run).restore_params("best")
    assert not any(k.startswith("flowgnn.") for k in params)


@pytest.mark.parametrize("argv", [["--attention-impl", "dense"],
                                  ["--attention-impl", "blockwise"],
                                  ["--attention-impl", "flash"],
                                  ["--remat"]])
def test_codet5_refuses_linevul_flags_as_the_reference(tmp_path, argv):
    with pytest.raises(ValueError) as want:
        jcli.main([*FIT_TEXT, "--checkpoint-dir", str(tmp_path / "j"),
                   *argv])
    with pytest.raises(ValueError) as got:
        cli.main([*FIT_TEXT, "--checkpoint-dir", str(tmp_path / "p"),
                  "--device", "cpu", *argv])
    assert str(got.value) == str(want.value)
    assert "codet5 stack does not take them" in str(got.value)


@pytest.mark.parametrize("command", ["fit-text", "test-text"])
def test_codet5_commands_need_the_card_without_device_cpu(
        command, codet5_run, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ([*FIT_TEXT, "--checkpoint-dir", str(tmp_path / "run")]
            if command == "fit-text"
            else ["test-text", "--checkpoint-dir", codet5_run[0]])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(argv)


def test_serve_refuses_a_codet5_run(codet5_run):
    args = argparse.Namespace(combined_checkpoint_dir=codet5_run[0],
                              combined_which="best", tokenizer=None,
                              device="cpu")
    with pytest.raises(ValueError, match="combined linevul"):
        cli._combined_model(args)


def test_codet5_checks_bpe_assets_against_its_ids(tmp_path):
    """``--tokenizer`` assets are held to codet5's pad and eos ids: a
    roberta-order pair (<s> 0, <pad> 1, </s> 2) is refused."""
    d = tmp_path / "bpe"
    d.mkdir()
    (d / "t-vocab.json").write_text(json.dumps(
        {"<s>": 0, "<pad>": 1, "</s>": 2, "a": 3, "b": 4, "ab": 5}))
    (d / "t-merges.txt").write_text("#version: 0.2\na b\n")
    with pytest.raises(ValueError, match="pad id 1 != model pad id 0"):
        cli._text_model(True, "auto", False, BLOCK, None, "cpu", 0,
                        tokenizer=str(d), model_name="codet5")
    model, tok = cli._text_model(True, "auto", False, BLOCK, None, "cpu", 0,
                                 model_name="codet5")
    assert isinstance(model, t5.DefectModel)
    assert isinstance(tok, text.HashingT5Tokenizer)


def test_fit_text_from_hf_t5_weights_with_the_graph_encoder_frozen(
        tmp_path):
    """An HF T5 directory (``save_pretrained``) through
    ``load_pretrained`` into ``DefectModel``'s ``t5.`` slot, one epoch of
    ``fit_text`` with the graph encoder frozen: the loaded weights are
    the start (the first step runs at lr 0), the encoder does not move."""
    transformers = pytest.importorskip("transformers")
    from deepdfa_tpu_torch.models.pretrained import load_pretrained

    hf_cfg = transformers.T5Config(
        vocab_size=128, d_model=32, d_kv=8, d_ff=64, num_layers=2,
        num_heads=4, pad_token_id=0, eos_token_id=2,
        decoder_start_token_id=0)
    torch.manual_seed(0)
    transformers.T5ForConditionalGeneration(hf_cfg).save_pretrained(
        str(tmp_path / "hf"))
    kind, cfg, params = load_pretrained(str(tmp_path / "hf"),
                                        dropout_rate=0.0)
    assert kind == "t5" and cfg == dataclasses.replace(
        t5.T5Config.tiny(), dropout_rate=0.0)
    tok = text.HashingT5Tokenizer(cfg.vocab_size)
    data, splits, graphs = combined.load_combined_dataset(
        "synthetic:20", FeatureSpec(limit_all=30), tok, BLOCK, style="t5",
        graphs="synthetic", seed=1)
    graphs, budget = combined.graph_join_and_budget(list(graphs.values()), 8)
    model = t5.DefectModel(cfg, FlowGNNConfig(
        feature=FeatureSpec(limit_all=30), hidden_dim=4, n_steps=2,
        encoder_mode=True), device="cpu")
    encoder = {k: v.clone() for k, v in model.flowgnn.state_dict().items()}
    cfg_t = TransformerTrainConfig(batch_size=8, block_size=BLOCK,
                                   max_epochs=1)
    seen = []
    step = text_loop.make_text_train_step

    def first_state(model_, *a, **kw):
        seen.append({k: v.clone() for k, v in model_.t5.state_dict().items()})
        return step(model_, *a, **kw)

    text_loop.make_text_train_step = first_state
    try:
        _, history = text_loop.fit_text(
            model, data, splits, cfg_t, graphs_by_id=graphs,
            subkeys=SUBKEYS, graph_budget=budget,
            init_params={f"t5.{k}": v for k, v in params.items()},
            freeze_submodules=("flowgnn",))
    finally:
        text_loop.make_text_train_step = step
    for k, v in params.items():
        assert torch.equal(seen[0][k], v), k
    assert np.isfinite(history["epochs"][0]["step_losses"]).all()
    for k, v in model.flowgnn.state_dict().items():
        assert torch.equal(v, encoder[k]), k
