"""The port's checkpoint manager (deepdfa_tpu_torch/train/checkpoint.py)
against the JAX package's synchronous ``CheckpointManager``.

The JAX manager opened on a run dir the port wrote reads the same
``meta.json``: it must give the same digests, the same fallback order,
the same resume candidate and the same verification results, also after
a byte of one snapshot is damaged. The snapshot bytes differ by design
(torch's format against orbax's), so the JAX side only ever verifies
them; it never loads one.
"""

import json
import logging
import os
import tempfile

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from deepdfa_tpu.train import checkpoint as jckpt
from deepdfa_tpu_torch.train import checkpoint as pckpt


def _state(seed=0, step=3):
    """A small trainer state: model params, an AdamW state, a step."""
    gen = torch.Generator().manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.Linear(3, 1))
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen))
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
    model(torch.ones(2, 4)).sum().backward()
    opt.step()
    return {"step": step, "params": model.state_dict(),
            "opt_state": opt.state_dict()}, model, opt


def _flip_byte(path):
    """Damage one byte in the middle of a snapshot's state file."""
    fp = os.path.join(path, pckpt.STATE_FILE)
    with open(fp, "r+b") as f:
        f.seek(os.path.getsize(fp) // 2)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))


def test_snapshot_checksum_is_the_reference_digest(tmp_path):
    m = pckpt.CheckpointManager(str(tmp_path))
    m.save_best(_state()[0], 0, val_loss=0.5)
    m.save_last(_state(seed=1)[0], 0)
    meta = json.loads((tmp_path / "meta.json").read_text())
    for name in ("best", "last"):
        path = str(tmp_path / name)
        want = jckpt.snapshot_checksum(path)
        assert pckpt.snapshot_checksum(path) == want
        assert meta["snapshots"][name]["sha256"] == want
    assert jckpt.snapshot_checksum(str(tmp_path)) == pckpt.snapshot_checksum(
        str(tmp_path))


def test_meta_json_matches_the_reference_call_for_call(tmp_path):
    """The same calls on both managers (the JAX one writing orbax, the
    port torch) leave the same meta.json, digests aside, and the same
    snapshot directories."""
    jm = jckpt.CheckpointManager(str(tmp_path / "jax"), periodic_every=2)
    pm = pckpt.CheckpointManager(str(tmp_path / "port"), periodic_every=2)
    jstate = {"w": np.arange(6, dtype=np.float32)}
    pstate = {"params": {"w": torch.arange(6, dtype=torch.float32)}}
    calls = [("save_best", 0, dict(val_loss=0.7)), ("save_last", 0, {}),
             ("maybe_save_periodic", 0, {}), ("save_last", 1, {}),
             ("maybe_save_periodic", 1, {}),
             ("save_best", 2, dict(metrics={"val_f1": 0.25})),
             ("save_last", 2, {}), ("maybe_save_periodic", 3, {})]
    for fn, epoch, kw in calls:
        getattr(jm, fn)(jstate, epoch, **kw)
        getattr(pm, fn)(pstate, epoch, **kw)

    def strip(meta):
        for rec in meta.get("snapshots", {}).values():
            assert len(rec.pop("sha256")) == 64
        return meta

    want = strip(json.loads((tmp_path / "jax" / "meta.json").read_text()))
    got = strip(json.loads((tmp_path / "port" / "meta.json").read_text()))
    assert got == want
    assert set(got["snapshots"]) == {"best", "last", "epoch_1", "epoch_3"}
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "jax"))
    assert pm.best_meta.keys() == jm.best_meta.keys()
    assert pm.drain() == 0.0 and not pm.has("epoch_0")


_NAMES = st.one_of(
    st.sampled_from(["best", "last"]),
    st.integers(0, 6).map(lambda n: f"epoch_{n}"),
    st.tuples(st.integers(0, 6), st.integers(0, 40)).map(
        lambda es: f"preempt_{es[0]}_{es[1]}"))


@settings(max_examples=30, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(snaps=st.dictionaries(_NAMES, st.integers(0, 6), min_size=1,
                             max_size=7),
       unrecorded=st.lists(st.integers(0, 8).map(lambda n: f"epoch_{n}"),
                           max_size=2, unique=True),
       meta_epochs=st.tuples(st.integers(-1, 6), st.integers(-1, 6)),
       damaged=st.integers(0, 100), requested=st.integers(0, 100))
def test_fallback_order_resume_and_verify_match_the_reference(
        snaps, unrecorded, meta_epochs, damaged, requested):
    with tempfile.TemporaryDirectory() as d:
        pm = pckpt.CheckpointManager(d)
        for i, (name, epoch) in enumerate(sorted(snaps.items())):
            pm._save(name, _state(seed=i)[0], epoch)
        pm._meta["last_epoch"], pm._meta["best_epoch"] = meta_epochs
        pm._write_meta()
        # Snapshots with no checksum record (written before meta.json
        # kept them): both managers take their epoch from the name.
        for name in unrecorded:
            if name not in snaps:
                os.makedirs(os.path.join(d, name))
                torch.save({"params": {}}, os.path.join(d, name,
                                                        pckpt.STATE_FILE))
        jm = jckpt.CheckpointManager(d)
        names = sorted(set(snaps) | set(unrecorded))
        for req in [""] + names:
            assert pm._fallback_order(req) == jm._fallback_order(req), req
        for pre in (True, False):
            assert pm.resume_candidate(pre) == jm.resume_candidate(pre)
        assert [pm.verify(n) for n in names] == [jm.verify(n) for n in names]
        assert all(pm.verify(n) for n in names)

        # Damage one recorded snapshot: both see it, and the port's
        # restore falls back to the snapshot the reference resolves to.
        recorded = sorted(snaps)
        bad = recorded[damaged % len(recorded)]
        _flip_byte(os.path.join(d, bad))
        pm, jm = pckpt.CheckpointManager(d), jckpt.CheckpointManager(d)
        assert [pm.verify(n) for n in names] == [jm.verify(n) for n in names]
        assert not pm.verify(bad)
        req = names[requested % len(names)]
        try:
            want = jm._resolve_intact(req)
        except jckpt.CheckpointError:
            with pytest.raises(pckpt.CheckpointError):
                pm.restore(req)
            return
        pm.restore(req)
        assert pm.last_restored == {"name": want, "fallback": want != req,
                                    "epoch": jm._snapshot_epoch(want)}
        pm.restore_params(req)
        assert pm.last_restored["name"] == want


def test_restore_round_trips_a_trainer_state(tmp_path):
    state, model, opt = _state(step=7)
    m = pckpt.CheckpointManager(str(tmp_path))
    m.save_last(state, 4)
    got = pckpt.CheckpointManager(str(tmp_path)).restore("last",
                                                         map_location="cpu")
    assert got["step"] == 7
    for k, v in model.state_dict().items():
        assert torch.equal(got["params"][k], v)
    opt2 = torch.optim.AdamW(model.parameters(), lr=1e-3)
    opt2.load_state_dict(got["opt_state"])
    for p in model.parameters():
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(opt2.state[p][k], opt.state[p][k])
    assert m.restore_params("last").keys() == model.state_dict().keys()
    m.save_best({"params": model.state_dict()}, 4, metrics={"f1": 0.5})
    assert m.restore_params().keys() == model.state_dict().keys()
    assert not os.path.exists(tmp_path / "meta.json.tmp")
    assert not any(n.endswith((".tmp", ".old")) for n in os.listdir(tmp_path))


def test_corrupt_meta_missing_and_all_damaged(tmp_path, caplog):
    m = pckpt.CheckpointManager(str(tmp_path))
    m.save_best(_state()[0], 1, val_loss=0.4)
    m.save_last(_state()[0], 1)
    # A never-written snapshot is a caller's error, not damage.
    for restore in (m.restore, m.restore_params):
        with pytest.raises(FileNotFoundError, match="epoch_5"):
            restore("epoch_5")
    # Every snapshot damaged: nothing to fall back to.
    for name in ("best", "last"):
        _flip_byte(str(tmp_path / name))
    m = pckpt.CheckpointManager(str(tmp_path))
    for restore in (m.restore, m.restore_params):
        with pytest.raises(pckpt.CheckpointError, match="no intact"):
            restore("best")
    assert m.resume_candidate() == "last"
    # A torn meta.json degrades to the reference's defaults, warning.
    (tmp_path / "meta.json").write_text('{"best_epoch": 1, "snap')
    with caplog.at_level(logging.WARNING):
        m = pckpt.CheckpointManager(str(tmp_path))
    assert "corrupt meta.json" in caplog.text
    assert m.best_meta == jckpt.CheckpointManager(str(tmp_path)).best_meta
    assert m.best_meta == {"best_epoch": -1, "best_val_loss": float("inf"),
                           "last_epoch": -1}
    assert m.verify("best")  # unrecorded now: restored unverified


def test_verify_caches_the_digest_by_stat_signature(tmp_path, monkeypatch):
    m = pckpt.CheckpointManager(str(tmp_path))
    m.save_last(_state()[0], 0)
    calls = []
    real = pckpt.snapshot_checksum
    monkeypatch.setattr(pckpt, "snapshot_checksum",
                        lambda p: calls.append(p) or real(p))
    assert m.verify("last") and m.verify("last")
    assert calls == []  # primed by the save
    fp = tmp_path / "last" / pckpt.STATE_FILE
    st_ = os.stat(fp)
    os.utime(fp, ns=(st_.st_atime_ns, st_.st_mtime_ns + 1000))
    assert m.verify("last") and len(calls) == 1
    assert m.verify("last") and len(calls) == 1


def test_load_encoder_params_keeps_what_the_reference_keeps():
    from deepdfa_tpu.core.config import FeatureSpec as JFeatureSpec
    from deepdfa_tpu.core.config import FlowGNNConfig as JFlowGNNConfig
    from deepdfa_tpu.graphs import batch as jbatch
    from deepdfa_tpu.models.flowgnn import FlowGNN as JFlowGNN
    from deepdfa_tpu_torch.data.synthetic import synthetic_bigvul
    from deepdfa_tpu_torch.core.config import FeatureSpec
    from deepdfa_tpu_torch.models.convert import flowgnn_from_flax

    cfg = JFlowGNNConfig(feature=JFeatureSpec(limit_all=30), hidden_dim=4,
                         n_steps=2)
    ex = synthetic_bigvul(4, FeatureSpec(limit_all=30), seed=0)
    b = jbatch.batch_graphs(ex, 4, 256, 1024,
                            ["api", "datatype", "literal", "operator"],
                            impl="python", shape_series=None)
    params = jax.tree_util.tree_map(
        np.asarray, JFlowGNN(cfg).init(jax.random.PRNGKey(0), b))
    kept = jckpt.load_encoder_params(params)
    want = flowgnn_from_flax(kept)
    got = pckpt.load_encoder_params(flowgnn_from_flax(params))
    assert got.keys() == want.keys()
    assert {k.split(".")[0] for k in got} == {"embeds", "ggnn_step"}
    for k in want:
        assert torch.equal(got[k], want[k])
