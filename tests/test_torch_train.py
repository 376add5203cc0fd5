"""The port's training path (deepdfa_tpu_torch/train/loop.py and the data,
metric and batching helpers it runs) against the JAX package.

Inputs are made once (numpy RNG streams, synthetic graphs) and go
through both packages; parameters are carried across with
``models/convert.py``. For message_impl "persistent" the JAX model runs
its Pallas kernels on the interpreter (``DEEPDFA_FUSED_IMPL=interpret``)
and the port its plain versions, which its wrappers take for CPU
tensors.
"""

import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from deepdfa_tpu.core import metrics as jmetrics
from deepdfa_tpu.core.config import DataConfig as JDataConfig
from deepdfa_tpu.core.config import FeatureSpec as JFeatureSpec
from deepdfa_tpu.core.config import FlowGNNConfig as JFlowGNNConfig
from deepdfa_tpu.core.config import TrainConfig as JTrainConfig
from deepdfa_tpu.data.sampling import epoch_indices as jax_epoch_indices
from deepdfa_tpu.data.splits import make_splits as jax_make_splits
from deepdfa_tpu.graphs import batch as jax_batch
from deepdfa_tpu.models.flowgnn import FlowGNN as JFlowGNN
from deepdfa_tpu.train import loop as jloop
from deepdfa_tpu_torch.core import metrics as pmetrics
from deepdfa_tpu_torch.core.config import (
    DataConfig,
    FeatureSpec,
    FlowGNNConfig,
    TrainConfig,
    subkeys_for,
)
from deepdfa_tpu_torch.data.sampling import epoch_indices
from deepdfa_tpu_torch.data.splits import assert_no_leakage, make_splits
from deepdfa_tpu_torch.data.synthetic import synthetic_bigvul
from deepdfa_tpu_torch.graphs import batch as pt_batch
from deepdfa_tpu_torch.models.convert import flowgnn_from_flax
from deepdfa_tpu_torch.models.flowgnn import FlowGNN
from deepdfa_tpu_torch.train import loop

LIMITS = dict(limit_all=30, limit_subkeys=30)
# tests/test_train.py's SMALL model and DATA packing.
SMALL = dict(hidden_dim=8, n_steps=4, num_output_layers=2)
DATA = dict(batch_size=16, eval_batch_size=16, max_nodes_per_graph=64,
            max_edges_per_node=4, undersample_factor=1.0)
SUBKEYS = ["api", "datatype", "literal", "operator"]


def _configs(impl="segment"):
    return (JFlowGNNConfig(feature=JFeatureSpec(**LIMITS), message_impl=impl,
                           **SMALL),
            FlowGNNConfig(feature=FeatureSpec(**LIMITS), message_impl=impl,
                          **SMALL))


def _np(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _examples(n=120, seed=1):
    return synthetic_bigvul(n, FeatureSpec(**LIMITS), positive_fraction=0.5,
                            seed=seed)


# ---------------------------------------------------------------------------
# Data: splits, epoch sampling, batches — byte for byte
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode,seed", [("random", 0), ("random", 5),
                                       ("cross-project", 1)])
def test_make_splits_matches_jax(mode, seed):
    ex = _examples(200)
    want = jax_make_splits(ex, mode, seed=seed)
    got = make_splits(ex, mode, seed=seed)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert got[k].tobytes() == want[k].tobytes(), k
    assert_no_leakage(got)
    assert sum(len(v) for v in got.values()) == 200


def test_fixed_split_and_leakage_check():
    ex = _examples(10)
    fixed = {i: ("train", "val", "test")[i % 3] for i in range(10)}
    got = make_splits(ex, "fixed", fixed=fixed)
    want = jax_make_splits(ex, "fixed", fixed=fixed)
    for k in want:
        assert got[k].tobytes() == want[k].tobytes()
    with pytest.raises(AssertionError, match="leakage"):
        assert_no_leakage({"train": np.arange(3), "val": np.arange(2, 4),
                           "test": np.arange(5, 6)})


@pytest.mark.parametrize("epoch,under,over,shuffle", [
    (0, 1.0, None, True), (3, 1.0, None, True), (1, 0.5, 2.0, True),
    (2, None, None, True), (0, None, None, False), (4, 1.0, None, False)])
def test_epoch_indices_match_jax(epoch, under, over, shuffle):
    labels = [int(x) for x in np.random.default_rng(7).random(90) < 0.3]
    kw = dict(seed=11, undersample_factor=under, oversample_factor=over,
              shuffle=shuffle)
    want = jax_epoch_indices(labels, epoch, **kw)
    got = epoch_indices(labels, epoch, **kw)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("band", [False, True])
def test_batch_iterator_matches_jax(band):
    ex = _examples(70, seed=3)
    args = (ex, 16, 16 * 64, 16 * 64 * 4, SUBKEYS)
    want = list(jax_batch.batch_iterator(*args, build_band_adj=band,
                                         shape_series=None))
    got = list(pt_batch.batch_iterator(*args, build_band_adj=band))
    assert len(got) == len(want) > 3
    for gb, jb in zip(got, want):
        for name in ("node_vuln", "senders", "receivers", "node_graph",
                     "node_mask", "edge_mask", "graph_mask", "graph_ids"):
            assert _np(getattr(gb, name)).tobytes() == _np(
                getattr(jb, name)).tobytes(), name
        for k in SUBKEYS:
            assert _np(gb.node_feats[k]).tobytes() == _np(
                jb.node_feats[k]).tobytes()
        if band:
            assert gb.band_adj.bandwidth == jb.band_adj.bandwidth
            assert _np(gb.band_adj.vals).tobytes() == _np(
                jb.band_adj.vals).tobytes()
    # A single graph over the budget raises in both.
    with pytest.raises(ValueError, match="single graph exceeds budget"):
        list(pt_batch.batch_iterator(ex, 16, 8, 8, SUBKEYS))


def test_graph_labels_match_jax():
    ex = _examples(12, seed=4)
    jb = jax_batch.batch_graphs(ex[:10], 12, 1024, 4096, SUBKEYS,
                                impl="python", shape_series=None)
    pb = pt_batch.batch_graphs(ex[:10], 12, 1024, 4096, SUBKEYS)
    want = np.asarray(jax_batch.graph_label_from_nodes(jb, impl="segment"))
    got = pt_batch.graph_label_from_nodes(pb).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[10:].tolist() == [0.0, 0.0]  # empty slots


# ---------------------------------------------------------------------------
# Loss, metrics, optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pos_weight", [None, 3.0])
def test_bce_with_logits_matches_jax(pos_weight):
    rng = np.random.default_rng(2)
    logits = (rng.standard_normal(40) * 4).astype(np.float32)
    labels = (rng.random(40) < 0.5).astype(np.float32)
    mask = rng.random(40) < 0.8
    want = jloop.bce_with_logits(jnp.asarray(logits), jnp.asarray(labels),
                                 jnp.asarray(mask), pos_weight)
    got = loop.bce_with_logits(torch.from_numpy(logits),
                               torch.from_numpy(labels),
                               torch.from_numpy(mask), pos_weight)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    empty = torch.zeros(4, dtype=torch.bool)
    assert loop.bce_with_logits(torch.ones(4), torch.ones(4), empty) == 0


def test_binary_stats_and_metrics_match_jax():
    rng = np.random.default_rng(3)
    probs = rng.random(64).astype(np.float32)
    labels = (rng.random(64) < 0.4).astype(np.float32)
    mask = rng.random(64) < 0.9
    want = jmetrics.binary_stats(jnp.asarray(probs), jnp.asarray(labels),
                                 jnp.asarray(mask))
    got = pmetrics.binary_stats(torch.from_numpy(probs),
                                torch.from_numpy(labels),
                                torch.from_numpy(mask))
    total = got + got
    jtotal = want + want
    for a, b in zip(total, jtotal):
        assert float(a) == float(b)
    jm = jmetrics.compute_metrics(jtotal)
    pm = pmetrics.compute_metrics(total)
    for k in jm:
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-6)
    zero = pmetrics.compute_metrics(pmetrics.BinaryStats.zeros())
    assert all(float(v) == 0.0 for v in zero.values())


@pytest.mark.parametrize("clip", [None, 0.5, 1e3])
def test_adamw_steps_match_optax(clip):
    # Three AdamW steps from the same params and gradients (bias
    # correction at t = 1, 2, 3), with and without the global-norm clip;
    # 0.5 clips these gradients, 1e3 leaves them as they are.
    rng = np.random.default_rng(4)
    shapes = {"w": (6, 5), "b": (5,), "e": (7, 3)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    cfg = JTrainConfig(grad_clip_norm=clip)
    tx = jloop.make_optimizer(cfg)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = loop.make_optimizer(tp.values(), TrainConfig(grad_clip_norm=clip))
    import optax

    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        if clip:
            loop.clip_by_global_norm_(tp.values(), clip)
        opt.step()
    for k in shapes:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-6)


def test_labels_for_styles():
    ex = _examples(8, seed=5)
    batch = pt_batch.batch_graphs(ex, 8, 512, 2048, SUBKEYS)
    for style, n in (("graph", 8), ("node", 512)):
        cfg = FlowGNNConfig(feature=FeatureSpec(**LIMITS), label_style=style,
                            **SMALL)
        labels, mask = loop._labels_for(FlowGNN(cfg, device="cpu"), batch)
        assert labels.shape == mask.shape == (n,)
    cfg = FlowGNNConfig(feature=FeatureSpec(**LIMITS),
                        label_style="dataflow_solution_in", **SMALL)
    with pytest.raises(loop.MissingDataflowBits, match="with_dataflow"):
        loop._labels_for(FlowGNN(cfg, device="cpu"), batch)


# ---------------------------------------------------------------------------
# The train step: a 50-step trajectory against the JAX make_train_step
# ---------------------------------------------------------------------------

# Both sides start from the same params and see the same batches. The
# per-step losses drift apart only by f32 rounding order (XLA's fused
# CPU kernels against torch's, the port's persistent step against the
# Pallas interpreter, its tile product against ``_spmm_xla``); AdamW
# normalises each gradient entry, so an entry near zero can move by up
# to lr = 2e-3 on one side and less on the other. 1e-4 absolute on a
# loss of ~0.7 bounds that over 50 steps (the gap measures ~5e-6 in the
# segment and persistent lanes).
TRAJ_TOL = 1e-4


@pytest.mark.parametrize("impl", ["segment", "persistent", "tile"])
def test_fifty_step_trajectory_matches_jax(impl, monkeypatch):
    if impl == "persistent":
        monkeypatch.setenv("DEEPDFA_FUSED_IMPL", "interpret")
    jcfg, pcfg = _configs(impl)
    ex = _examples(160, seed=1)
    idx = np.arange(len(ex))
    band, tile = pcfg.uses_band_adj, pcfg.uses_tile_adj
    jdata, pdata = JDataConfig(**DATA), DataConfig(**DATA)
    jb = list(jloop._batches(ex, idx, jdata, SUBKEYS, 16,
                             build_band_adj=band, build_tile_adj=tile,
                             shape_series=None))
    pb = list(loop._batches(ex, idx, pdata, SUBKEYS, 16, build_band_adj=band,
                            build_tile_adj=tile))
    assert len(jb) == len(pb) == 10
    train = dict(learning_rate=2e-3, seed=0)
    jmodel = JFlowGNN(jcfg)
    state, tx = jloop.make_train_state(jmodel, jb[0], JTrainConfig(**train))
    jstep = jax.jit(jloop.make_train_step(jmodel, tx, JTrainConfig(**train)))
    model = FlowGNN(pcfg, device="cpu")
    model.load_state_dict(flowgnn_from_flax(
        jax.tree_util.tree_map(np.asarray, state.params)))
    cfg = TrainConfig(**train)
    step = loop.make_train_step(
        model, loop.make_optimizer(model.parameters(), cfg), cfg)
    want, got = [], []
    with jax.default_matmul_precision("highest"):
        for i in range(50):
            state, loss, _ = jstep(state, jb[i % 10])
            want.append(float(loss))
            got.append(float(step(pb[i % 10])[0]))
    diff = np.abs(np.asarray(got) - np.asarray(want))
    assert diff.max() <= TRAJ_TOL, (diff.max(), got[-3:], want[-3:])
    assert got[-1] < got[0]  # it trains


# ---------------------------------------------------------------------------
# fit and evaluate
# ---------------------------------------------------------------------------


def test_fit_learns_synthetic_task():
    """tests/test_train.py's gate on the port: test F1 > 0.8."""
    _, pcfg = _configs()
    ex = synthetic_bigvul(400, pcfg.feature, positive_fraction=0.5, seed=1)
    splits = make_splits(ex, "random", seed=0)
    model = FlowGNN(pcfg, device="cpu", seed=0)
    cfg = TrainConfig(max_epochs=16, learning_rate=2e-3, seed=0)
    data = DataConfig(**DATA)
    best, history = loop.fit(model, ex, splits, cfg, data)
    model.load_state_dict(best.params)
    test = loop.evaluate(loop.make_eval_step(model, cfg), ex, splits["test"],
                         data, subkeys_for(pcfg.feature), "cpu")
    assert test.metrics["f1"] > 0.8, (test.metrics, history["epochs"][-1])
    assert history["best_epoch"] >= 0
    assert len(test.probs) == len(test.labels) == len(test.graph_ids) == len(
        splits["test"])


def _small_fit(**train):
    _, pcfg = _configs("persistent")
    ex = _examples(64, seed=2)
    for i, e in enumerate(ex):
        e["id"] = i
    splits = make_splits(ex, "random", seed=0)
    model = FlowGNN(pcfg, device="cpu", seed=0)
    return model, loop.fit(model, ex, splits, TrainConfig(**train),
                           DataConfig(**DATA), log_every=2)


def test_fit_history_records_and_early_stop():
    calls = []
    _, pcfg = _configs("persistent")
    ex = _examples(64, seed=2)
    splits = make_splits(ex, "random", seed=0)
    model = FlowGNN(pcfg, device="cpu", seed=0)
    best, history = loop.fit(
        model, ex, splits, TrainConfig(max_epochs=3, seed=0),
        DataConfig(**DATA),
        on_epoch_end=lambda e, rec: calls.append(e) or e == 1)
    assert calls == [0, 1] and history["early_stopped"]
    assert len(history["epochs"]) == 2
    rec = history["epochs"][0]
    for key in ("epoch", "train_loss", "train_metrics", "val_loss",
                "val_metrics", "seconds", "step_losses"):
        assert key in rec
    assert rec["train_loss"] == pytest.approx(np.mean(rec["step_losses"]),
                                              rel=1e-5)
    assert best.step == len(rec["step_losses"]) * (history["best_epoch"] + 1)
    json.dumps(history)


def test_nonfinite_loss_raises_or_rolls_back():
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        _small_fit(max_epochs=1, positive_weight=float("nan"),
                   detect_anomaly=True)
    # Rollback skips the poisoned windows until its budget runs out.
    with pytest.raises(FloatingPointError, match="budget exhausted"):
        _small_fit(max_epochs=1, positive_weight=float("nan"),
                   anomaly_policy="rollback", anomaly_retry_budget=1)
    with pytest.raises(ValueError, match="anomaly_policy"):
        _small_fit(anomaly_policy="ignore")


def test_cli_fit_writes_history(tmp_path, capsys):
    from deepdfa_tpu_torch import cli

    out = tmp_path / "fit"
    cli.main(["fit", "--dataset", "synthetic:48", "--device", "cpu",
              "--max-epochs", "1", "--batch-size", "16", "--message-impl",
              "segment", "--out-dir", str(out)])
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(result) == {"best_epoch", "best_val_loss",
                           "final_val_metrics"}
    history = json.loads((out / "history.json").read_text())
    assert history["best_epoch"] == result["best_epoch"] == 0
    assert history["kernel_launches"]["persistent_bwd_kernel"] == 0
