"""The port's FlowGNN against the JAX model, on parameters carried across
with ``flowgnn_from_flax``.

For "fused" and "persistent" the JAX model runs its Pallas kernels on
the interpreter (``DEEPDFA_FUSED_IMPL=interpret``, as
tests/test_fused_gnn.py does); the port runs its plain versions, which
its wrappers take for CPU tensors. 1e-5 is the tolerance of
tests/test_flowgnn.py:278.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from deepdfa_tpu.core.config import FeatureSpec as JFeatureSpec
from deepdfa_tpu.core.config import FlowGNNConfig as JFlowGNNConfig
from deepdfa_tpu.data.synthetic import synthetic_bigvul
from deepdfa_tpu.graphs.batch import batch_graphs as jax_batch_graphs
from deepdfa_tpu.graphs.batch import pad_budget_for
from deepdfa_tpu.models.flowgnn import FlowGNN as JFlowGNN
from deepdfa_tpu_torch.core.config import FeatureSpec, FlowGNNConfig
from deepdfa_tpu_torch.graphs.batch import batch_graphs
from deepdfa_tpu_torch.models.convert import flowgnn_from_flax
from deepdfa_tpu_torch.models.flowgnn import FlowGNN

TOL = dict(rtol=1e-5, atol=1e-5)
IMPLS = ["segment", "band", "fused", "persistent"]
LIMITS = dict(limit_all=20, limit_subkeys=20)
TILE = 16


def _configs(impl, **kw):
    base = dict(hidden_dim=8, n_steps=3, num_output_layers=3,
                message_impl=impl, **kw)
    return (JFlowGNNConfig(feature=JFeatureSpec(**LIMITS), **base),
            FlowGNNConfig(feature=FeatureSpec(**LIMITS), **base))


def _batches(n_graphs=6, seed=0):
    graphs = synthetic_bigvul(n_graphs, JFeatureSpec(**LIMITS),
                              positive_fraction=0.5, seed=seed)
    budget = pad_budget_for(graphs, n_graphs)
    max_nodes = -(-budget["max_nodes"] // TILE) * TILE
    args = (graphs, n_graphs, max_nodes, budget["max_edges"],
            ["api", "datatype", "literal", "operator"])
    jb = jax_batch_graphs(*args, tile=TILE, build_band_adj=True,
                          impl="python", shape_series=None)
    pb = batch_graphs(*args, tile=TILE, build_band_adj=True)
    assert pb.band_adj.bandwidth >= 1 and pb.band_adj.n_tiles > 1
    return jb, pb


def _run_both(impl, monkeypatch, seed=0, **kw):
    if impl in ("fused", "persistent"):
        monkeypatch.setenv("DEEPDFA_FUSED_IMPL", "interpret")
    jcfg, pcfg = _configs(impl, **kw)
    jb, pb = _batches(seed=seed)
    jmodel = JFlowGNN(jcfg)
    params = jmodel.init(jax.random.PRNGKey(seed), jb)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jmodel.apply(params, jb))
    model = FlowGNN(pcfg, device="cpu", seed=seed)
    model.load_state_dict(flowgnn_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    model.eval()
    with torch.inference_mode():
        got = model(pb).numpy()
    return got, want


@pytest.mark.parametrize("impl", IMPLS)
def test_logits_match_jax(impl, monkeypatch):
    got, want = _run_both(impl, monkeypatch)
    assert got.shape == want.shape == (6,)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("impl", IMPLS)
def test_encoder_mode_pooled_output_matches_jax(impl, monkeypatch):
    got, want = _run_both(impl, monkeypatch, seed=1, encoder_mode=True)
    assert got.shape == want.shape == (6, 64)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("impl", ["segment", "persistent"])
def test_node_label_logits_match_jax(impl, monkeypatch):
    # Node-level label styles skip pooling: one logit per node slot.
    got, want = _run_both(impl, monkeypatch, seed=2, label_style="node")
    assert got.shape == want.shape and got.shape[0] > 6
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("encoder_mode", [False, True])
def test_matmul_pooling_matches_jax(encoder_mode, monkeypatch):
    # pool_impl="matmul" on both sides: the assignment-matrix pooling that
    # "auto" picks on the card (and the reference on its accelerator).
    got, want = _run_both("segment", monkeypatch, seed=3,
                          encoder_mode=encoder_mode, pool_impl="matmul")
    assert got.shape == want.shape == ((6, 64) if encoder_mode else (6,))
    np.testing.assert_allclose(got, want, **TOL)


def test_pool_impls_agree_and_an_unknown_one_raises():
    _, cfg = _configs("segment")
    _, batch = _batches(seed=4)
    out = {}
    for pool in ("segment", "matmul"):
        model = FlowGNN(dataclasses.replace(cfg, pool_impl=pool),
                        device="cpu", seed=4)
        with torch.inference_mode():
            out[pool] = model(batch)
    torch.testing.assert_close(out["matmul"], out["segment"], **TOL)
    with pytest.raises(ValueError, match="pool_impl"):
        FlowGNN(dataclasses.replace(cfg, pool_impl="onehot"), device="cpu")


def test_converted_tree_fills_every_port_parameter():
    jcfg, pcfg = _configs("persistent")
    jb, _ = _batches()
    params = jax.tree_util.tree_map(
        np.asarray, JFlowGNN(jcfg).init(jax.random.PRNGKey(0), jb))
    state = flowgnn_from_flax(params)
    own = FlowGNN(pcfg, device="cpu").state_dict()
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        k: tuple(v.shape) for k, v in own.items()}
    # flax Dense kernels are [in, out]; torch weights [out, in].
    kernel = params["params"]["ggnn_step"]["gru"]["hn"]["kernel"]
    np.testing.assert_array_equal(state["ggnn_step.gru.hn.weight"].numpy(),
                                  kernel.T)
    # The GRU has no hidden-side r/z bias, in flax and in the port.
    assert "ggnn_step.gru.hr.bias" not in state
    assert "ggnn_step.gru.hz.bias" not in state
    with pytest.raises(ValueError, match="unexpected FlowGNN param"):
        flowgnn_from_flax({"params": {"bogus": {}}})


def test_random_init_follows_flax_initializers():
    # At the published width: 4 x 32 embedding columns over 1002 rows,
    # GGNN width 128, head 256-256-1.
    model = FlowGNN(FlowGNNConfig(), device="cpu", seed=0)
    sd = model.state_dict()
    emb = sd["embeds.api.embedding"]
    assert tuple(emb.shape) == (1002, 32)
    assert abs(emb.std().item() - 32 ** -0.5) < 0.01  # fan_in = width
    lecun = sd["ggnn_step.gru.ir.weight"]
    assert abs(lecun.std().item() - 128 ** -0.5) < 0.005
    assert lecun.abs().max().item() <= 2 * 128 ** -0.5 / 0.8796 + 1e-6
    orth = sd["ggnn_step.gru.hn.weight"].double()
    np.testing.assert_allclose((orth @ orth.T).numpy(), np.eye(128),
                               atol=1e-5)
    for k, v in sd.items():
        if k.endswith(".bias"):
            assert not v.any(), k
    assert tuple(sd["head.output_0.weight"].shape) == (256, 256)
    assert tuple(sd["head.output_2.weight"].shape) == (1, 256)
    # The same seed gives the same weights; another seed does not.
    again = FlowGNN(FlowGNNConfig(), device="cpu", seed=0).state_dict()
    other = FlowGNN(FlowGNNConfig(), device="cpu", seed=1).state_dict()
    assert all(torch.equal(v, again[k]) for k, v in sd.items())
    assert not torch.equal(emb, other["embeds.api.embedding"])


def test_bf16_and_unported_impls_raise():
    # bf16 builds (f32 parameters, as the reference keeps them); a dtype
    # other than float32 and bfloat16 raises.
    model = FlowGNN(FlowGNNConfig(dtype="bfloat16"), device="cpu")
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    with pytest.raises(ValueError, match="dtype"):
        FlowGNNConfig(dtype="float16")
    # Every impl of the reference is ported now: a name outside them.
    with pytest.raises(ValueError, match="not ported"):
        FlowGNN(FlowGNNConfig(message_impl="onehot"), device="cpu")
