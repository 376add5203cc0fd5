"""The port's flagship forward (``deepdfa_tpu_torch/entry.py``) against
the JAX package's ``entry()`` in ``__graft_entry__.py``: the same batch
byte for byte, and logits within 1e-5 on the JAX params carried across
by ``models/convert.py``, with and without dense-slot packing."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import __graft_entry__ as jentry
from deepdfa_tpu_torch import entry as pentry
from deepdfa_tpu_torch.models.convert import flowgnn_from_flax

# f32 in another order (the band aggregate, the pooling's sums) over the
# published widths: per-graph logits.
LOGIT_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the first ``torch.exp`` of a process that
    splits across threads (MKL's ``vmsExp``, more than 2048 elements)
    can come back with a relative error near 1e-4 in one thread's chunk
    (``scripts/torch_first_exp_race.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_entry():
    fn, (params, batch) = jentry.entry()
    return fn, params, batch


def _batch_bytes(batch):
    out = {name: np.asarray(getattr(batch, name)) for name in (
        "node_vuln", "senders", "receivers", "node_graph", "node_mask",
        "edge_mask", "graph_mask", "graph_ids")}
    out.update({f"feat_{k}": np.asarray(v)
                for k, v in batch.node_feats.items()})
    return out


@pytest.mark.parametrize("slot_pack", [False, True])
def test_entry_logits_match_jax(jax_entry, slot_pack):
    jfn, jparams, jbatch = jax_entry
    if slot_pack:
        model_cfg, data_cfg, _ = jentry._flagship()
        jbatch = jentry._example_batch(data_cfg, model_cfg, slot_pack=True)
    want = np.asarray(jax.jit(jfn)(jparams, jbatch))

    fn, (params, batch) = pentry.entry(device="cpu", slot_pack=slot_pack)
    got_b, want_b = _batch_bytes(batch), _batch_bytes(jbatch)
    assert sorted(got_b) == sorted(want_b)
    for name, value in want_b.items():
        g = got_b[name]
        assert g.dtype == value.dtype and g.tobytes() == value.tobytes(), name
    assert batch.band_adj.bandwidth == jbatch.band_adj.bandwidth
    converted = flowgnn_from_flax(jax.tree_util.tree_map(np.asarray,
                                                         jparams))
    assert sorted(converted) == sorted(params)
    logits = fn({k: torch.as_tensor(v) for k, v in converted.items()}, batch)
    assert logits.shape == (256,) and torch.isfinite(logits).all()
    np.testing.assert_allclose(logits.numpy(), want, rtol=0, atol=LOGIT_TOL)
    # The port's own seeded weights give finite logits of the same shape.
    own = fn(params, batch)
    assert own.shape == (256,) and torch.isfinite(own).all()


def test_entry_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pentry.entry()


def test_flagship_config_matches_jax():
    import dataclasses

    pm, pd_, pt = pentry._flagship()
    jm, jd, jt = jentry._flagship()
    for p, j in ((pm, jm), (pd_, jd), (pt, jt)):
        assert dataclasses.asdict(p) == dataclasses.asdict(j)
