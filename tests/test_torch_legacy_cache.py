"""The port's dbize-cache reader (``etl/legacy_cache.py``, the ``csv``
module) against the JAX package's (pandas): the same directory gives
the same examples byte for byte, and ``cli fit`` trains on one."""

import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
pd = pytest.importorskip("pandas")

from deepdfa_tpu.core.config import FeatureSpec as JFeatureSpec
from deepdfa_tpu.data import combined as jcombined
from deepdfa_tpu.etl import legacy_cache as jlegacy
from deepdfa_tpu_torch.core.config import ALL_SUBKEYS, FeatureSpec
from deepdfa_tpu_torch.data import combined as pcombined
from deepdfa_tpu_torch.etl import legacy_cache as plegacy


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the first ``torch.exp`` of a process that
    splits across threads (MKL's ``vmsExp``, more than 2048 elements)
    can come back with a relative error near 1e-4 in one thread's chunk
    (``scripts/torch_first_exp_race.py``); the ``fit`` below trains."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_dbize(root, seed=0, n_graphs=12, sample=False, limit=1000,
                 split="fixed", shuffle=True, oddities=True):
    """A directory as the reference's dbize stage writes it: nodes,
    edges and one feature file a subkey, each with pandas' index column.
    ``oddities``: a graph without edges, gaps in its dgl ids, nodes
    without a feature row, a node row without a graph id and a feature
    row with an empty value (float columns)."""
    rng = np.random.default_rng(seed)
    nodes, edges, feats = [], [], {k: [] for k in ALL_SUBKEYS}
    for g in range(n_graphs):
        gid = int(rng.integers(0, 10_000)) * 10 + g  # distinct, unordered
        n = int(rng.integers(2, 9))
        dgl = np.arange(n)
        if oddities and g == 1:
            dgl = dgl * 2  # gaps: the graph spans 2n - 1 dense ids
        for d in dgl:
            node_id = 1000 + 7 * int(d)
            nodes.append((gid, int(d), node_id, int(rng.random() < 0.2)))
            for k in ALL_SUBKEYS:
                if oddities and g == 2 and d == 0:
                    continue  # no feature row: reads 0
                feats[k].append((gid, node_id, int(rng.integers(0, limit))))
        if not (oddities and g == 3):
            for _ in range(int(rng.integers(1, 2 * n))):
                edges.append((gid, int(rng.choice(dgl)),
                              int(rng.choice(dgl))))
    if oddities:
        nodes.append((None, 0, 5, 1))
        for k in ALL_SUBKEYS:
            feats[k].append((99, 99, None))

    def frame(rows, cols):
        df = pd.DataFrame(rows, columns=cols)
        if shuffle:
            df = df.sample(frac=1.0, random_state=seed)
        return df.reset_index(drop=True)

    s = "_sample" if sample else ""
    os.makedirs(root, exist_ok=True)
    frame(nodes, ["graph_id", "dgl_id", "node_id", "vuln"]).to_csv(
        os.path.join(root, f"nodes{s}.csv"))
    frame(edges, ["graph_id", "innode", "outnode"]).to_csv(
        os.path.join(root, f"edges{s}.csv"))
    for k in ALL_SUBKEYS:
        col = (f"_ABS_DATAFLOW_{k}_all_limitall_{limit}"
               f"_limitsubkeys_{limit}")
        frame(feats[k], ["graph_id", "node_id", col]).to_csv(
            os.path.join(root, f"nodes_feat_{col}_{split}{s}.csv"))
    return root


def _assert_same_examples(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in ("id", "num_nodes", "label"):
            assert type(g[key]) is type(w[key]) and g[key] == w[key], key
        for key in ("senders", "receivers", "vuln"):
            a, b = np.asarray(g[key]), np.asarray(w[key])
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), key
        assert sorted(g["feats"]) == sorted(w["feats"])
        for k in w["feats"]:
            a, b = g["feats"][k], w["feats"][k]
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k


@pytest.mark.parametrize("sample", [False, True])
@pytest.mark.parametrize("concat_all", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_loader_matches_jax_byte_for_byte(tmp_path, sample, concat_all,
                                          seed):
    root = _write_dbize(str(tmp_path / "dbize"), seed=seed, sample=sample,
                        limit=20)
    kw = dict(limit_all=20, limit_subkeys=20, concat_all=concat_all,
              subkey="api")
    want = jlegacy.load_reference_cache(root, JFeatureSpec(**kw),
                                        sample=sample)
    got = plegacy.load_reference_cache(root, FeatureSpec(**kw),
                                       sample=sample)
    assert len(got) == 12
    _assert_same_examples(got, want)


def test_labels_by_id_and_ordered_input(tmp_path):
    root = _write_dbize(str(tmp_path / "dbize"), seed=5, shuffle=False,
                        oddities=False)
    first = plegacy.load_reference_cache(root)
    labels = {first[0]["id"]: 1, first[1]["id"]: 0}
    want = jlegacy.load_reference_cache(root, labels_by_id=labels)
    got = plegacy.load_reference_cache(root, labels_by_id=labels)
    _assert_same_examples(got, want)
    assert [g["id"] for g in got] == sorted(g["id"] for g in got)


@pytest.mark.parametrize("sample", [False, True])
def test_graph_source_reads_a_dbize_directory(tmp_path, sample):
    root = _write_dbize(str(tmp_path / "dbize"), seed=3, sample=sample)
    want = jcombined.load_graph_source(root, JFeatureSpec())
    got = pcombined.load_graph_source(root, FeatureSpec())
    _assert_same_examples(got, want)


def test_missing_feature_column_and_bad_cells_raise(tmp_path):
    root = _write_dbize(str(tmp_path / "dbize"), seed=4, oddities=False)
    col = "_ABS_DATAFLOW_api_all_limitall_1000_limitsubkeys_1000"
    path = os.path.join(root, f"nodes_feat_{col}_fixed.csv")
    df = pd.read_csv(path, index_col=0).rename(columns={col: "value"})
    df.to_csv(path)
    with pytest.raises(ValueError, match="no unique feature column"):
        plegacy.load_reference_cache(root)
    with pytest.raises(ValueError, match="no unique feature column"):
        jlegacy.load_reference_cache(root)
    df.rename(columns={"value": col}).to_csv(path)
    with open(os.path.join(root, "edges.csv"), "a") as f:
        f.write("99,7,x,1\n")
    with pytest.raises(ValueError, match="not a number"):
        plegacy.load_reference_cache(root)


def test_cli_fit_trains_on_a_dbize_directory(tmp_path, capsys):
    from deepdfa_tpu_torch import cli

    root = _write_dbize(str(tmp_path / "dbize"), seed=6, n_graphs=40,
                        oddities=False)
    run = str(tmp_path / "run")
    assert cli.main(["fit", "--dataset", root, "--device", "cpu",
                     "--max-epochs", "1", "--batch-size", "8",
                     "--message-impl", "segment",
                     "--checkpoint-dir", run]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(result["best_val_loss"])
    with open(os.path.join(run, "history.json")) as f:
        history = json.load(f)
    assert len(history["epochs"]) == 1
