"""Real inputs for the port, held to the JAX package or to the library
each reader replaces:

- the YAML subset reader (``core/yaml_subset.py``) against
  ``yaml.safe_load``, and ``build_configs``/``FeatureSpec.parse_legacy``
  against the JAX CLI's, field for field;
- the MSR CSV reader (``data/combined._read_text_csvs``, the ``csv``
  module) against the JAX one (pandas), and the combined dataset built
  from CSVs and a ``.jsonl`` graph corpus, byte for byte;
- ``models/pretrained.load_pretrained`` on a small random
  ``RobertaModel`` saved by ``save_pretrained`` (safetensors and
  ``pytorch_model.bin``): params exactly the JAX loader's, encoder
  output within 1e-5 of HF's;
- dataflow batches byte for byte, and a 20-step trajectory of each
  dataflow label style within 5e-6 of the JAX train step;
- the CLI: ``validate`` and ``analyze`` print the JAX CLI's JSON, ``fit``
  takes a ``.jsonl`` corpus's pinned partition, the flags layer over
  ``--config``/``--set``, and the run log is kept (``.error`` on a
  crash).
"""

import dataclasses
import json
import logging
import math
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
yaml = pytest.importorskip("yaml")
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from deepdfa_tpu import cli as jcli
from deepdfa_tpu.contracts import schema as jschema
from deepdfa_tpu.core.config import FeatureSpec as JFeatureSpec
from deepdfa_tpu.core.config import FlowGNNConfig as JFlowGNNConfig
from deepdfa_tpu.core.config import TrainConfig as JTrainConfig
from deepdfa_tpu.data import combined as jcombined
from deepdfa_tpu.data import text as jtext
from deepdfa_tpu.graphs import batch as jbatch
from deepdfa_tpu.models.flowgnn import FlowGNN as JFlowGNN
from deepdfa_tpu.train import loop as jloop
from deepdfa_tpu_torch import cli
from deepdfa_tpu_torch.contracts import ingest as pingest
from deepdfa_tpu_torch.contracts import schema as pschema
from deepdfa_tpu_torch.core import config as pconfig
from deepdfa_tpu_torch.core.config import (
    DataConfig,
    FeatureSpec,
    FlowGNNConfig,
    TrainConfig,
)
from deepdfa_tpu_torch.core.yaml_subset import YamlSubsetError, safe_load
from deepdfa_tpu_torch.data import combined as pcombined
from deepdfa_tpu_torch.data import text as ptext
from deepdfa_tpu_torch.data.synthetic import synthetic_bigvul
from deepdfa_tpu_torch.graphs import batch as pbatch
from deepdfa_tpu_torch.models import pretrained
from deepdfa_tpu_torch.models.convert import encoder_from_flax, flowgnn_from_flax
from deepdfa_tpu_torch.models.flowgnn import FlowGNN
from deepdfa_tpu_torch.models.transformer import RobertaEncoder
from deepdfa_tpu_torch.train import loop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_YAML = os.path.join(REPO, "configs", "default.yaml")
SUBKEYS = ["api", "datatype", "literal", "operator"]
LIMITS = dict(limit_all=30, limit_subkeys=30)
SMALL = dict(hidden_dim=8, n_steps=4, num_output_layers=2)
DF_TRAJ_TOL = 5e-6
HF_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the first multi-threaded ``torch.exp`` of a
    process can be wrong in one thread's chunk (MKL's first use;
    ``scripts/torch_first_exp_race.py``), and these shapes gain nothing
    from more threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The YAML subset against yaml.safe_load
# ---------------------------------------------------------------------------


def _canon(x):
    """Type-aware, NaN-safe form for comparing loaded documents."""
    if isinstance(x, dict):
        return ("dict", sorted(((_canon(k), _canon(v)) for k, v in x.items()),
                               key=repr))
    if isinstance(x, float) and math.isnan(x):
        return ("float", "nan")
    return (type(x).__name__, x)


PLAIN = ["1e-3", "1.0e-3", "1.0E+3", "yes", "No", "ON", "off", "True",
         "FALSE", "y", "n", "~", "null", "Null", "NULL", "0x1F", "0x_1f",
         "017", "08", "0", "-0", "1_000", "+12", "-3", ".5", "-.5", "5.",
         ".inf", "-.Inf", "+.INF", ".NaN", "1:30", "-1:30:05", "1:30.5",
         "0b101", "0o17", "abc", "a b", "a#b", "é", "graph",
         "dataflow_solution_in", "1.0", "-1.5e+10", "12e3", "x:y", "a-b",
         "-x", ":x", "?x", "1,000", "a[0]", "1.2.3", "0.", "+.5"]
KEYS = st.one_of(st.from_regex(r"[a-z_][a-z0-9_]{0,8}", fullmatch=True),
                 st.sampled_from(["on", "no", "1", "0x2", "null", "~"]))
QUOTED_TEXT = st.text(alphabet=st.characters(
    blacklist_categories=("Cs", "Co", "Cn", "Zl", "Zp"),
    blacklist_characters="\ufeff\ufffe\uffff\x85"), max_size=12)


def _double(s):
    out = []
    for c in s:
        o = ord(c)
        if c in '"\\':
            out.append("\\" + c)
        elif o < 0x20 or 0x7F <= o < 0xA0:
            out.append(f"\\x{o:02x}")
        else:
            out.append(c)
    return '"' + "".join(out) + '"'


def _single(s):
    return "'" + s.replace("'", "''") + "'"


SCALAR = st.one_of(
    st.sampled_from(PLAIN),
    st.sampled_from(["", "  # a comment"]),
    QUOTED_TEXT.filter(lambda s: all(ord(c) >= 0x20 and not 0x7F <= ord(c)
                                     < 0xA0 for c in s)).map(_single),
    QUOTED_TEXT.map(_double),
)
DOC = st.recursive(
    st.dictionaries(KEYS, SCALAR, min_size=1, max_size=4),
    lambda inner: st.dictionaries(KEYS, st.one_of(SCALAR, inner),
                                  min_size=1, max_size=4),
    max_leaves=12)


def _emit(doc, indent, step, comments, out):
    for key, value in doc.items():
        pad = " " * indent
        if comments.draw_comment():
            out.append(pad + "# note: x: [1] &a *b")
        if isinstance(value, dict):
            out.append(f"{pad}{key}:")
            _emit(value, indent + step, step, comments, out)
        else:
            out.append(f"{pad}{key}: {value}".rstrip() if value
                       else f"{pad}{key}:")


class _Comments:
    def __init__(self, draw):
        self.draw = draw

    def draw_comment(self):
        return self.draw(st.booleans())


@settings(max_examples=200, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(doc=DOC, step=st.sampled_from([2, 4]), data=st.data(),
       header=st.sampled_from(["", "---\n", "# head\n\n"]))
def test_yaml_subset_matches_safe_load(doc, step, data, header):
    lines = []
    _emit(doc, 0, step, _Comments(data.draw), lines)
    text = header + "\n".join(lines) + data.draw(st.sampled_from(
        ["", "\n", "\n\n# tail\n"]))
    assert _canon(safe_load(text)) == _canon(yaml.safe_load(text)), text


def test_yaml_subset_reads_default_yaml():
    with open(DEFAULT_YAML) as f:
        text = f.read()
    assert safe_load(text) == yaml.safe_load(text)
    assert safe_load("") is None and safe_load("# only\n\n") is None


@pytest.mark.parametrize("text", [
    "a: [1, 2]\n", "a: {b: 1}\n", "a: &x 1\n", "a: *x\n", "a: !!str 1\n",
    "a: |\n  text\n", "a: >\n  text\n", "- a\n", "a:\n  - 1\n",
    "a: 1\n---\nb: 2\n", "%YAML 1.1\n---\na: 1\n", "a: b: c\n",
    "a: 1\n  b: 2\n", "a:\n    b: 1\n  c: 2\n", "a: 2001-12-14\n",
    "<<: 1\n", "a: \"open\n", "a: 'x' y\n", "a:\tb\n", "\ta: 1\n",
    "a: \"\\q\"\n", "just a scalar\n", "  a: 1\n",
])
def test_yaml_subset_refuses_the_rest(text):
    with pytest.raises(YamlSubsetError):
        safe_load(text)


# ---------------------------------------------------------------------------
# build_configs and parse_legacy against the JAX CLI
# ---------------------------------------------------------------------------


def _asdicts(cfgs):
    return {k: dataclasses.asdict(v) for k, v in cfgs.items()}


@pytest.mark.parametrize("overrides", [
    [],
    ["train.max_epochs=1"],
    ["model.label_style=dataflow_solution_in", "model.message_impl=tile",
     "data.undersample_factor=0.5", "train.grad_clip_norm=1.0",
     "model.remat_steps=no", "train.detect_anomaly=yes"],
    ["model.feature=_ABS_DATAFLOW_api_all_limitall_500_limitsubkeys_200",
     "train.checkpoint_dir=runs/x", "data.oversample_factor=2"],
    ["model.feature=_ABS_DATAFLOW_literal_all", "train.seed=7"],
])
def test_build_configs_matches_jax(tmp_path, overrides):
    layer = tmp_path / "layer.yaml"
    layer.write_text("model:\n  hidden_dim: 16\n  feature:\n"
                     "    limit_all: 40  # smaller\n"
                     "train:\n  learning_rate: 2.0e-3\n  max_epochs: 3\n"
                     "data: ~\n")
    for files in ([], [DEFAULT_YAML], [DEFAULT_YAML, str(layer)]):
        want = _asdicts(jcli.build_configs(files, overrides))
        assert _asdicts(pconfig.build_configs(files, overrides)) == want


@pytest.mark.parametrize("bad,kind", [
    (["bogus.key=1"], "set"), (["model.=1"], "set"),
    (["model.nope=1"], "set"), (["train"], "set"),
    ("other:\n  a: 1\n", "file"), ("model:\n  nope: 1\n", "file"),
])
def test_build_configs_refusals_match_jax(tmp_path, bad, kind):
    files, sets = [], []
    if kind == "file":
        path = tmp_path / "bad.yaml"
        path.write_text(bad)
        files = [str(path)]
    else:
        sets = bad
    with pytest.raises(ValueError) as want:
        jcli.build_configs(files, sets)
    with pytest.raises(ValueError) as got:
        pconfig.build_configs(files, sets)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", [
    "_ABS_DATAFLOW_datatype_all_limitall_1000_limitsubkeys_1000",
    "_ABS_DATAFLOW_api_all", "_ABS_DATAFLOW_literal_all_limitall_5",
    "_ABS_DATAFLOW_operator_all_limitsubkeys_9", "datatype", "_ABS_x",
])
@pytest.mark.parametrize("concat_all", [True, False])
def test_parse_legacy_matches_jax(name, concat_all):
    outcome = []
    for spec in (JFeatureSpec, FeatureSpec):
        try:
            f = spec.parse_legacy(name, concat_all=concat_all)
            outcome.append((dataclasses.asdict(f), f.legacy_name))
        except ValueError as e:
            outcome.append(str(e))
    assert outcome[1] == outcome[0]


def test_coerce_matches_jax():
    for value in ("16", "yes", "0.5", "tile", "1e-3", "True", "0"):
        for ftype in ("int", "bool", "float", "str", "Optional[float]"):
            assert pconfig._coerce(value, ftype) == jcli._coerce(value, ftype)


# ---------------------------------------------------------------------------
# MSR CSVs against pandas; the combined dataset from CSVs and .jsonl
# ---------------------------------------------------------------------------

LONG = "int big(void) {\n" + "  x += \"\"quoted\"\", y;\n" * 8000 + "}"


def _csv_field(s):
    return '"' + s.replace('"', '""') + '"'


def _write_csv(path, header, rows, newline="\n", bom=False):
    lines = [",".join(header)]
    for r in rows:
        lines.append(",".join(_csv_field(str(v)) if i and isinstance(v, str)
                              else str(v) for i, v in enumerate(r)))
    text = newline.join(lines) + newline
    with open(path, "w", encoding="utf-8", newline="") as f:
        f.write(("\ufeff" if bom else "") + text)


def _msr_dir(root, layout):
    os.makedirs(root, exist_ok=True)
    code = [
        'int f(char *s) {\n  printf("%s, \\"x\\"", s);\n}',
        "void g() { /* é ñ 一二三 🙂 */ return; }",
        LONG,
        "",
        "int h(int a,\r\n int b) { return a<b; }",
        "NULL",
    ]
    assert len(LONG) > 131072
    if layout == "processed":
        header = ["", "processed_func", "target", "func"]
        rows = {s: [[10 * k + i, code[(k + i) % len(code)], (k + i) % 2,
                     "unused"] for i in range(4)]
                for k, s in enumerate(("train", "val", "test"))}
    elif layout == "func_only":
        header = ["idx", "func", "target"]
        rows = {s: [[100 + 10 * k + i, code[(k + 2 * i) % len(code)],
                     f"{(i % 2)}.0"] for i in range(3)]
                for k, s in enumerate(("train", "val", "test"))}
    else:  # no test.csv, CRLF and a BOM
        header = ["id", "target", "processed_func"]
        rows = {s: [[7 + 3 * k + i, i % 2, code[(i + k) % len(code)]]
                    for i in range(3)] for k, s in enumerate(("train", "val"))}
    for split, table in rows.items():
        if layout == "no_test":
            _write_csv(os.path.join(root, f"{split}.csv"), header, table,
                       newline="\r\n", bom=True)
        else:
            _write_csv(os.path.join(root, f"{split}.csv"), header, table)
    return root


@pytest.mark.parametrize("layout", ["processed", "func_only", "no_test"])
def test_csv_reader_matches_pandas(tmp_path, layout):
    pytest.importorskip("pandas")
    root = _msr_dir(str(tmp_path / layout), layout)
    jrows, jpos = jcombined._read_text_csvs(root)
    prows, ppos = pcombined._read_text_csvs(root)
    assert ppos == jpos
    assert len(prows) == len(jrows)
    for p, j in zip(prows, jrows):
        assert p["code"] == str(j["code"])
        assert p["label"] == j["label"] and type(p["label"]) is int
        assert p["id"] == j["id"] and type(p["id"]) is int
    tok = jtext.HashingCodeTokenizer(512)
    want = jtext.encode_dataset(jrows, tok, block_size=128)
    got = ptext.encode_dataset(prows, ptext.HashingCodeTokenizer(512),
                               block_size=128)
    for k in want:
        assert got[k].tobytes() == want[k].tobytes(), k


def _graph_corpus(path, ids, seed=0):
    exs = synthetic_bigvul(len(ids), FeatureSpec(**LIMITS), seed=seed)
    for ex, i in zip(exs, ids):
        ex["id"] = i
    pingest.write_examples_jsonl(exs, path)
    return exs


def test_combined_dataset_from_csvs_matches_jax(tmp_path):
    root = _msr_dir(str(tmp_path / "msr"), "processed")
    corpus = str(tmp_path / "graphs.jsonl")
    _graph_corpus(corpus, [0, 1, 2, 10, 11, 12, 20, 21])
    feat_p, feat_j = FeatureSpec(**LIMITS), JFeatureSpec(**LIMITS)
    want = jcombined.load_combined_dataset(
        root, feat_j, jtext.HashingCodeTokenizer(512), 64, graphs=corpus)
    got = pcombined.load_combined_dataset(
        root, feat_p, ptext.HashingCodeTokenizer(512), 64, graphs=corpus)
    for k in want[0]:
        assert got[0][k].tobytes() == want[0][k].tobytes()
    assert {k: v.tolist() for k, v in got[1].items()} == {
        k: v.tolist() for k, v in want[1].items()}
    assert sorted(got[2]) == sorted(want[2])
    for i in want[2]:
        for key in ("senders", "receivers", "vuln", "df_in"):
            assert got[2][i][key].tobytes() == want[2][i][key].tobytes()
    # The two join refusals, word for word.
    for args, kw in (((root,), dict(graphs="synthetic")),
                     (("synthetic:8",), dict(graphs=corpus))):
        with pytest.raises(ValueError) as jerr:
            jcombined.load_combined_dataset(*args, feat_j, None, 64, **kw)
        with pytest.raises(ValueError) as perr:
            pcombined.load_combined_dataset(*args, feat_p, None, 64, **kw)
        assert str(perr.value) == str(jerr.value)


def test_jsonl_graph_source_matches_jax(tmp_path):
    corpus = str(tmp_path / "g.jsonl")
    _graph_corpus(corpus, list(range(12)), seed=3)
    with open(corpus, "a") as f:
        f.write('{"num_nodes": 0}\n')
    for feature in (FeatureSpec(**LIMITS),
                    FeatureSpec(concat_all=False, subkey="api", **LIMITS)):
        jf = JFeatureSpec(**dataclasses.asdict(feature))
        want = jcombined.load_graph_source(corpus, jf)
        got = pcombined.load_graph_source(corpus, feature)
        assert [g["id"] for g in got] == [g["id"] for g in want]
        for p, j in zip(got, want):
            for k in ("senders", "receivers", "vuln", "df_in", "df_out"):
                assert p[k].tobytes() == j[k].tobytes()
    with pytest.raises(ValueError, match="unknown graph source"):
        pcombined.load_graph_source(str(tmp_path / "nodes"),
                                    FeatureSpec(**LIMITS))


# ---------------------------------------------------------------------------
# load_pretrained on a small random RobertaModel
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def hf_model():
    tr = pytest.importorskip("transformers")
    cfg = tr.RobertaConfig(
        vocab_size=120, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64,
        max_position_embeddings=40, type_vocab_size=1, pad_token_id=1,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    torch.manual_seed(0)
    return tr.RobertaModel(cfg).eval()


@pytest.mark.parametrize("safe", [True, False])
def test_load_pretrained_matches_jax_and_hf(tmp_path, hf_model, safe):
    from deepdfa_tpu.models import pretrained as jpretrained

    hf_model.save_pretrained(str(tmp_path), safe_serialization=safe)
    assert os.path.exists(tmp_path / ("model.safetensors" if safe
                                      else "pytorch_model.bin"))
    jkind, jcfg, jparams = jpretrained.load_pretrained(str(tmp_path))
    kind, cfg, params = pretrained.load_pretrained(str(tmp_path))
    assert kind == jkind == "roberta"
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    want = encoder_from_flax(jparams)
    assert sorted(params) == sorted(want)
    for k in want:
        assert params[k].dtype == want[k].dtype == torch.float32
        assert torch.equal(params[k], want[k]), k
    enc = RobertaEncoder(cfg, torch.Generator())
    enc.load_state_dict(params)
    rng = np.random.default_rng(0)
    ids = rng.integers(3, cfg.vocab_size, size=(3, 20)).astype(np.int64)
    ids[1, 12:] = cfg.pad_token_id
    with torch.no_grad():
        hf = hf_model(torch.from_numpy(ids), attention_mask=torch.from_numpy(
            ids != cfg.pad_token_id)).last_hidden_state
        got, _ = enc(torch.from_numpy(ids))
    keep = torch.from_numpy(ids != cfg.pad_token_id)
    torch.testing.assert_close(got[keep], hf[keep], atol=HF_TOL, rtol=HF_TOL)


def test_safetensors_round_trip_and_safetensors_library(tmp_path):
    st_torch = pytest.importorskip("safetensors.torch")
    tensors = {"a": torch.randn(3, 5), "b": torch.arange(7, dtype=torch.int64),
               "c": torch.randn(4).to(torch.bfloat16),
               "d": torch.zeros(0, 3), "e": torch.tensor([True, False])}
    ours = tmp_path / "ours.safetensors"
    pretrained.write_safetensors(str(ours), tensors, {"format": "pt"})
    back = st_torch.load_file(str(ours))
    theirs = tmp_path / "theirs.safetensors"
    st_torch.save_file(tensors, str(theirs), metadata={"format": "pt"})
    for got in (pretrained.read_safetensors(str(theirs)), back,
                pretrained.read_safetensors(str(ours))):
        assert sorted(got) == sorted(tensors)
        for k, v in tensors.items():
            assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def test_roberta_to_hf_inverts_roberta_from_hf(hf_model, tmp_path):
    from deepdfa_tpu_torch.models.convert import roberta_from_hf, roberta_to_hf

    sd = {k: v for k, v in hf_model.state_dict().items()
          if not k.startswith("pooler.")}
    ours = roberta_from_hf(sd)
    back = roberta_to_hf(ours)
    assert sorted(back) == sorted(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    pretrained.write_safetensors(str(tmp_path / "model.safetensors"), back)
    (tmp_path / "config.json").write_text(hf_model.config.to_json_string())
    _, _, params = pretrained.load_pretrained(str(tmp_path))
    for k in ours:
        assert torch.equal(params[k], ours[k])


def test_load_pretrained_refusals(tmp_path, hf_model):
    hf_model.save_pretrained(str(tmp_path))
    doc = json.loads((tmp_path / "config.json").read_text())
    for change, err in (({"model_type": "t5"}, NotImplementedError),
                        ({"model_type": "bert"}, ValueError),
                        ({"hidden_act": "relu"}, ValueError)):
        (tmp_path / "config.json").write_text(json.dumps(dict(doc, **change)))
        with pytest.raises(err):
            pretrained.load_pretrained(str(tmp_path))
    (tmp_path / "config.json").write_text(json.dumps(doc))
    os.remove(tmp_path / "model.safetensors")
    with pytest.raises(FileNotFoundError):
        pretrained.load_pretrained(str(tmp_path))


# ---------------------------------------------------------------------------
# Dataflow labels
# ---------------------------------------------------------------------------


def _df_examples(n, seed):
    return synthetic_bigvul(n, FeatureSpec(**LIMITS), positive_fraction=0.5,
                            seed=seed)


@pytest.mark.parametrize("band", [False, True])
def test_dataflow_batches_match_jax(band):
    ex = _df_examples(24, 4)
    want = jbatch.batch_graphs(ex, 24, 1024, 4096, SUBKEYS, impl="python",
                               with_dataflow=True, build_band_adj=band,
                               shape_series=None)
    got = pbatch.batch_graphs(ex, 24, 1024, 4096, SUBKEYS,
                              with_dataflow=True, build_band_adj=band)
    for name in ("node_df_in", "node_df_out", "node_vuln", "node_mask",
                 "node_graph"):
        w = np.asarray(getattr(want, name))
        g = getattr(got, name).numpy()
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), name
    assert pbatch.batch_graphs(ex, 24, 1024, 4096, SUBKEYS).node_df_in is None
    bare = [{k: v for k, v in e.items() if k != "df_in"} for e in ex[:2]]
    with pytest.raises(ValueError, match="no df_in/df_out"):
        pbatch.batch_graphs(bare, 2, 128, 512, SUBKEYS, with_dataflow=True)


@pytest.mark.parametrize("style", ["dataflow_solution_in",
                                   "dataflow_solution_out"])
def test_dataflow_labels_match_jax(style):
    ex = _df_examples(16, 2)
    jb = jbatch.batch_graphs(ex, 16, 1024, 4096, SUBKEYS, impl="python",
                             with_dataflow=True, shape_series=None)
    pb = pbatch.batch_graphs(ex, 16, 1024, 4096, SUBKEYS, with_dataflow=True)
    jmodel = JFlowGNN(JFlowGNNConfig(feature=JFeatureSpec(**LIMITS),
                                     label_style=style, **SMALL))
    pmodel = FlowGNN(FlowGNNConfig(feature=FeatureSpec(**LIMITS),
                                   label_style=style, **SMALL), device="cpu")
    jl, jm = jloop._labels_for(jmodel, jb)
    pl, pm = loop._labels_for(pmodel, pb)
    assert pl.numpy().tobytes() == np.asarray(jl).tobytes()
    assert pm.numpy().tobytes() == np.asarray(jm).tobytes()
    if style.endswith("_in"):
        assert int(pm.sum()) < int(pb.node_mask.sum())  # cut_nodef


@pytest.mark.parametrize("impl", ["segment", "persistent"])
@pytest.mark.parametrize("style", ["dataflow_solution_in",
                                   "dataflow_solution_out"])
def test_dataflow_trajectory_matches_jax(style, impl, monkeypatch):
    """20 steps of each dataflow label style from the same params on the
    same batches: per-step losses within 5e-6."""
    if impl == "persistent":
        monkeypatch.setenv("DEEPDFA_FUSED_IMPL", "interpret")
    from deepdfa_tpu.core.config import DataConfig as JDataConfig

    jcfg = JFlowGNNConfig(feature=JFeatureSpec(**LIMITS), label_style=style,
                          message_impl=impl, **SMALL)
    pcfg = FlowGNNConfig(feature=FeatureSpec(**LIMITS), label_style=style,
                         message_impl=impl, **SMALL)
    data = dict(batch_size=16, eval_batch_size=16, max_nodes_per_graph=64,
                max_edges_per_node=4)
    ex = _df_examples(80, 1)
    idx = np.arange(len(ex))
    band = pcfg.uses_band_adj
    jb = list(jloop._batches(ex, idx, JDataConfig(**data), SUBKEYS, 16,
                             build_band_adj=band, with_dataflow=True,
                             shape_series=None))
    pb = list(loop._batches(ex, idx, DataConfig(**data), SUBKEYS, 16,
                            build_band_adj=band, with_dataflow=True))
    assert len(jb) == len(pb) == 5
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
        for i in range(20):
            state, loss, _ = jstep(state, jb[i % 5])
            want.append(float(loss))
            got.append(float(step(pb[i % 5])[0]))
    diff = np.abs(np.asarray(got) - np.asarray(want))
    assert diff.max() <= DF_TRAJ_TOL, (diff.max(), got[-3:], want[-3:])
    assert got[-1] < got[0]


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture
def corpus(tmp_path):
    """A corpus with one repairable and three fatal rows, and no pin."""
    exs = _df_examples(40, 7)
    for i, ex in enumerate(exs):
        ex["id"] = 100 + i
    path = tmp_path / "cache" / "corpus.jsonl"
    pingest.write_examples_jsonl(exs, path, checksum=False)
    rows = path.read_text().splitlines()
    bad = json.loads(rows[3])
    bad["senders"][0] = 10_000
    rows[3] = json.dumps(bad)
    rows[5] = rows[5][:40]
    fl = json.loads(rows[8])
    fl["label"] = float(fl["label"])
    rows[8] = json.dumps(fl)
    rows.append(json.dumps(dict(json.loads(rows[0]), num_nodes=0, id=999)))
    path.write_text("\n".join(rows) + "\n")
    return path


def _clear_quarantine(path):
    import shutil

    shutil.rmtree(path.parent / "quarantine", ignore_errors=True)


def test_validate_json_matches_jax_cli(corpus, capsys):
    outs = []
    for pkg_cli, schema_mod in ((jcli, jschema), (cli, pschema)):
        schema_mod.STATS.reset()
        rc = pkg_cli.main(["validate", str(corpus.parent), "--max-nodes",
                           "512"])
        outs.append((rc, _last_json(capsys)))
        outs[-1][1]["manifest"] = (corpus.parent / "quarantine" /
                                   "manifest.jsonl").read_text()
        _clear_quarantine(corpus)
    assert outs[1] == outs[0]
    rc, report = outs[0]
    assert rc == 1 and report["quarantined"] == 3 and report["repaired"] == 1
    assert report["by_reason"] == {"dangling_endpoint": 1, "empty_graph": 1,
                                   "truncated_json": 1}
    clean = corpus.parent / "clean.jsonl"
    pingest.write_examples_jsonl(_df_examples(8, 1), clean)
    assert cli.main(["validate", str(clean)]) == 0
    assert _last_json(capsys)["quarantined"] == 0
    with pytest.raises(NotImplementedError, match="not ported"):
        cli.main(["validate", "--smoke"])


@pytest.mark.parametrize("extra", [[], ["--set",
                                        "model.feature=_ABS_DATAFLOW_api_all",
                                        "--set", "model.hidden_dim=8"]])
def test_analyze_json_matches_jax_cli(corpus, capsys, extra):
    outs = []
    for dataset in (str(corpus), "synthetic:30"):
        for pkg_cli in (jcli, cli):
            pkg_cli.main(["analyze", "--dataset", dataset,
                          "--config", DEFAULT_YAML, *extra])
            outs.append(_last_json(capsys))
            _clear_quarantine(corpus)
        assert outs[-1] == outs[-2]
    # A numpy count over the loaded arrays gives the same coverage.
    examples, _ = pingest.load_examples_jsonl(corpus, SUBKEYS)
    feats = np.concatenate([ex["feats"]["api"] for ex in examples])
    assert outs[0]["api"]["definitions"] == int((feats > 0).sum())
    assert outs[0]["api"]["coverage"] == (feats > 1).sum() / (feats > 0).sum()


@pytest.mark.parametrize("layout", ["by_id", "lists", "empty"])
@pytest.mark.parametrize("split_mode", ["random", "cross-project"])
def test_load_dataset_pinned_split_matches_jax(corpus, layout, split_mode,
                                               caplog):
    exs, _ = pingest.load_examples_jsonl(corpus, SUBKEYS)
    ids = [ex["id"] for ex in exs]
    parts = {i: ("train", "val", "test")[k % 3] for k, i in enumerate(ids)}
    doc = ({str(i): p for i, p in parts.items()} if layout == "by_id" else
           {p: [i for i in ids if parts[i] == p]
            for p in ("train", "val", "test")} if layout == "lists" else {})
    (corpus.parent / "splits.json").write_text(json.dumps(doc))
    feat_p, feat_j = FeatureSpec(), JFeatureSpec()
    jex, jsplits = jcli.load_dataset(str(corpus), feat_j, seed=2,
                                     split_mode=split_mode)
    _clear_quarantine(corpus)
    with caplog.at_level(logging.INFO, logger="deepdfa_tpu_torch.cli"):
        pex, psplits = cli.load_dataset(str(corpus), feat_p, seed=2,
                                        split_mode=split_mode)
    assert {k: v.tolist() for k, v in psplits.items()} == {
        k: v.tolist() for k, v in jsplits.items()}
    assert [e["id"] for e in pex] == [e["id"] for e in jex]
    pinned = layout != "empty"
    if pinned and split_mode == "random":
        assert [ids[i] for i in psplits["test"]] == [
            i for i in ids if parts[i] == "test"]
    assert ("overriding the pinned split" in caplog.text) == (
        pinned and split_mode != "random")


def test_fit_on_jsonl_takes_the_pinned_partition(corpus, tmp_path,
                                                 monkeypatch, capsys):
    exs, _ = pingest.load_examples_jsonl(corpus, SUBKEYS)
    _clear_quarantine(corpus)
    ids = [ex["id"] for ex in exs]
    pin = {"train": ids[:20], "val": ids[20:28], "test": ids[28:]}
    (corpus.parent / "splits.json").write_text(json.dumps(pin))
    seen = {}
    real_fit = loop.fit

    def spy(model, examples, splits, train_cfg, data_cfg, **kw):
        seen.update(ids=[[examples[i]["id"] for i in splits[k]]
                         for k in ("train", "val", "test")],
                    model=model.config, train=train_cfg, data=data_cfg)
        return real_fit(model, examples, splits, train_cfg, data_cfg, **kw)

    monkeypatch.setattr(loop, "fit", spy)
    run = tmp_path / "run"
    assert cli.main(["fit", "--dataset", str(corpus), "--config",
                     DEFAULT_YAML, "--set", "train.max_epochs=3", "--set",
                     "model.message_impl=segment", "--set",
                     "model.label_style=dataflow_solution_in",
                     "--max-epochs", "1", "--batch-size", "8", "--device",
                     "cpu", "--checkpoint-dir", str(run)]) == 0
    result = _last_json(capsys)
    assert seen["ids"] == [pin["train"], pin["val"], pin["test"]]
    # Flags over --set over the file over the flags' defaults.
    assert seen["train"].max_epochs == 1 and seen["data"].batch_size == 8
    assert seen["model"].message_impl == "segment"
    assert seen["model"].label_style == "dataflow_solution_in"
    assert seen["train"].learning_rate == 1e-3 and seen["train"].seed == 1
    assert result["best_epoch"] == 0
    logs = [f for f in os.listdir(run) if f.startswith("run_")]
    assert len(logs) == 1 and logs[0].endswith(".log")
    # test on the same run, dataflow labels through evaluate.
    assert cli.main(["test", "--dataset", str(corpus), "--checkpoint-dir",
                     str(run), "--device", "cpu", "--message-impl",
                     "segment", "--set",
                     "model.label_style=dataflow_solution_in"]) == 0
    assert math.isfinite(_last_json(capsys)["loss"])


def test_fit_defaults_without_config_are_the_port_flags(monkeypatch, tmp_path,
                                                        capsys):
    seen = {}

    def spy(model, examples, splits, train_cfg, data_cfg, **kw):
        seen.update(model=model.config, train=train_cfg, data=data_cfg)
        raise RuntimeError("stop here")

    monkeypatch.setattr(loop, "fit", spy)
    run = tmp_path / "run"
    with pytest.raises(RuntimeError, match="stop here"):
        cli.main(["fit", "--dataset", "synthetic:8", "--device", "cpu",
                  "--checkpoint-dir", str(run)])
    assert seen["model"].message_impl == "persistent"
    assert (seen["train"].max_epochs, seen["train"].learning_rate,
            seen["train"].seed, seen["data"].batch_size) == (25, 1e-3, 1, 256)
    logs = os.listdir(run)
    assert len(logs) == 1 and logs[0].endswith(".log.error")
    assert logging.getLogger().level == logging.WARNING


def _roberta_pair(root, texts):
    """A roberta-order byte-level BPE pair (<pad> 1), trained by
    ``tokenizers`` on ``texts``."""
    from tokenizers import ByteLevelBPETokenizer

    os.makedirs(root)
    corpus = root + ".txt"
    with open(corpus, "w", encoding="utf-8") as f:
        f.write("\n".join(texts))
    tok = ByteLevelBPETokenizer()
    tok.train([corpus], vocab_size=400, min_frequency=2, special_tokens=[
        "<s>", "<pad>", "</s>", "<unk>", "<mask>"])
    tok.save_model(root, "codebert")
    return root


def test_cli_fit_text_reads_csvs_jsonl_graphs_and_bpe(tmp_path, monkeypatch,
                                                      capsys):
    """fit-text on MSR CSVs joined with a .jsonl graph corpus through a
    BPE tokenizer, then test-text on its snapshot: the same test loss and
    predictions."""
    pytest.importorskip("tokenizers")
    from deepdfa_tpu_torch.models import transformer

    tiny = transformer.EncoderConfig.tiny.__func__
    monkeypatch.setattr(transformer.EncoderConfig, "tiny", classmethod(
        lambda cls, vocab_size=512: tiny(cls, vocab_size=512)))
    root = tmp_path / "msr"
    os.makedirs(root)
    ids = {"train": [3, 5, 8, 9, 11, 14], "val": [20, 21], "test": [30, 31]}
    exs = _df_examples(14, 6)
    for ex, i in zip(exs, sum(ids.values(), [])):
        ex["id"] = i
    corpus = tmp_path / "graphs.jsonl"
    pingest.write_examples_jsonl(exs, corpus)
    rows = ptext.attach_synthetic_text([dict(e) for e in exs], seed=1)
    by_id = {r["id"]: r for r in rows}
    for split, split_ids in ids.items():
        _write_csv(root / f"{split}.csv", ["", "processed_func", "target"],
                   [[i, by_id[i]["code"], by_id[i]["label"]]
                    for i in split_ids])
    tok = _roberta_pair(str(tmp_path / "bpe"), [r["code"] for r in rows])
    run = tmp_path / "run"
    assert cli.main(["fit-text", "--dataset", str(root), "--graphs",
                     str(corpus), "--tokenizer", tok, "--tiny",
                     "--block-size", "64", "--epochs", "1", "--batch-size",
                     "4", "--device", "cpu", "--set", "model.hidden_dim=8",
                     "--checkpoint-dir", str(run)]) == 0
    fit = _last_json(capsys)
    desc = json.loads((run / "model.json").read_text())
    assert desc["tokenizer"] == tok and desc["graphs"] == str(corpus)
    assert desc["split_mode"] == "random"
    assert fit["test"]["num_missing"] == 0
    assert any(f.startswith("run_") and f.endswith(".log")
               for f in os.listdir(run))
    assert cli.main(["test-text", "--checkpoint-dir", str(run),
                     "--device", "cpu"]) == 0
    tt = _last_json(capsys)
    assert tt["loss"] == fit["test"]["loss"] and tt["split"] == "test"
    assert (run / "test_predictions.csv").read_text() == (
        run / "predictions.csv").read_text()


def test_cli_tokenizer_refusals_match_jax(tmp_path):
    """The reference's asset order (<pad> 0) against codebert's pad id,
    and a vocabulary past the tiny table, refused with the JAX CLI's
    messages."""
    pytest.importorskip("tokenizers")
    from deepdfa_tpu.etl.tokenizer_train import train_bpe

    texts = [r["code"] for r in ptext.attach_synthetic_text(
        _df_examples(20, 2))]
    corpus = tmp_path / "c.txt"
    corpus.write_text("\n".join(texts))
    ref_order = str(tmp_path / "ref")
    train_bpe([str(corpus)], ref_order, vocab_size=300, min_frequency=2)
    for extra in ([], ["--tiny"]):
        argv = ["fit-text", "--dataset", "synthetic:16", "--tokenizer",
                ref_order, "--epochs", "1", "--block-size", "32", *extra]
        with pytest.raises(ValueError) as want:
            jcli.main([*argv, "--checkpoint-dir", str(tmp_path / "j")])
        with pytest.raises(ValueError) as got:
            cli.main([*argv, "--checkpoint-dir", str(tmp_path / "p"),
                      "--device", "cpu"])
        assert str(got.value) == str(want.value)
