"""The port's data contracts (deepdfa_tpu_torch/contracts) against the
JAX package's.

Corpora come from the JAX package's own corrupt-corpus fuzzer
(``gauntlet.poison_corpus``), one class at a time and all together; both
loaders read the same file, each into its own quarantine directory. The
surviving examples must match byte for byte (keys, dtypes, values), and
the reports, manifest rows and quarantined raw lines must be equal.
"""

import json
import os
import shutil

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from deepdfa_tpu.contracts import gauntlet as jgauntlet
from deepdfa_tpu.contracts import ingest as jingest
from deepdfa_tpu.contracts import quarantine as jquarantine
from deepdfa_tpu.contracts import schema as jschema
from deepdfa_tpu_torch.contracts import gauntlet as pgauntlet
from deepdfa_tpu_torch.contracts import ingest as pingest
from deepdfa_tpu_torch.contracts import quarantine as pquarantine
from deepdfa_tpu_torch.contracts import schema as pschema
from deepdfa_tpu_torch.core.config import ALL_SUBKEYS, FeatureSpec
from deepdfa_tpu_torch.data.synthetic import synthetic_bigvul

FEAT = FeatureSpec(limit_all=20, limit_subkeys=20)
MAX_NODES = jgauntlet.GAUNTLET_MAX_NODES


def _examples(n=24, seed=0):
    return synthetic_bigvul(n, FEAT, positive_fraction=0.5, seed=seed)


def _assert_same_example(p, j):
    assert sorted(p) == sorted(j)
    for key, want in j.items():
        got = p[key]
        if key == "feats":
            assert list(got) == list(want)
            for k in want:
                assert got[k].dtype == want[k].dtype
                assert got[k].tobytes() == want[k].tobytes()
        elif isinstance(want, np.ndarray):
            assert got.dtype == want.dtype, key
            assert got.tobytes() == want.tobytes(), key
        else:
            assert type(got) is type(want) and got == want, key


def _load_both(path, root, **kw):
    """Each package's loader over ``path``, each into its own sink."""
    out = []
    for pkg, qmod, name in ((jingest, jquarantine, "jax"),
                            (pingest, pquarantine, "port")):
        sink = qmod.Quarantine(os.path.join(root, f"q_{name}"))
        examples, report = pkg.load_examples_jsonl(
            path, ALL_SUBKEYS, quarantine=sink, **kw)
        with open(sink.items_path) if os.path.exists(sink.items_path) \
                else open(os.devnull) as f:
            items = f.read()
        out.append((examples, report, qmod.read_manifest(sink.root), items))
    return out


def _assert_loads_equal(path, root, **kw):
    (je, jr, jm, ji), (pe, pr, pm, pi) = _load_both(path, root, **kw)
    assert len(pe) == len(je)
    for p, j in zip(pe, je):
        _assert_same_example(p, j)
    assert {k: v for k, v in pr.items() if k != "dir"} == {
        k: v for k, v in jr.items() if k != "dir"}
    assert pm == jm
    assert pi == ji
    return jr


@pytest.mark.parametrize("cls", sorted(jgauntlet.CORRUPTIONS) + ["ALL"])
@pytest.mark.parametrize("seed", [0, 3])
def test_loader_matches_jax_on_every_corruption_class(tmp_path, cls, seed):
    classes = None if cls == "ALL" else [cls]
    plan = jgauntlet.poison_corpus(_examples(24, seed), tmp_path, seed=seed,
                                   classes=classes)
    report = _assert_loads_equal(str(tmp_path / "corpus.jsonl"),
                                 str(tmp_path), max_nodes=MAX_NODES)
    fatal = sum(v["expected_reason"] is not None for v in plan["victims"])
    assert report["quarantined"] == fatal
    # The clean subset: every row survives, and the fast path takes none
    # of them (checksummed rows take the full validator).
    _assert_loads_equal(str(tmp_path / "clean_subset.jsonl"),
                        str(tmp_path / "clean"), max_nodes=MAX_NODES)


@pytest.mark.parametrize("checksum", [False, True])
def test_writer_and_fast_path_match_jax(tmp_path, checksum):
    """Rows written by each package's writer are the same bytes; an
    unchecksummed corpus takes the structural fast path in both, with
    ``id`` and ``label`` defaulted as the reference does."""
    exs = _examples(30, seed=5)
    for ex in exs[::3]:
        del ex["label"]
    for ex in exs[1::4]:
        del ex["id"]
    jpath, ppath = tmp_path / "j.jsonl", tmp_path / "p.jsonl"
    assert jingest.write_examples_jsonl(exs, jpath, checksum=checksum) == \
        pingest.write_examples_jsonl(exs, ppath, checksum=checksum) == 30
    assert jpath.read_bytes() == ppath.read_bytes()
    report = _assert_loads_equal(str(ppath), str(tmp_path))
    assert report["fast_path"] == (0 if checksum else 30)


def test_fast_path_negativity_pass_matches_jax(tmp_path):
    """Rows the fast path accepts per row but the corpus-level min pass
    rejects (negative endpoints, features, vuln bits) and rows that miss
    the fast path (bools, float labels, stray types)."""
    rows = [pingest.encode_row(ex) for ex in _examples(12, seed=2)]
    rows[1]["senders"][0] = -1
    rows[2]["feats"]["api"][1] = -4
    rows[3]["vuln"][0] = -1
    rows[4]["label"] = True
    rows[5]["vuln"] = [bool(v) for v in rows[5]["vuln"]]
    rows[6]["df_in"] = [float(v) for v in rows[6]["df_in"]]
    rows[7]["node_lines"] = list(range(rows[7]["num_nodes"]))
    rows[8]["node_ids"] = [7] * rows[8]["num_nodes"]
    rows[9]["label"] = 2
    rows[10]["id"] = "x"
    text = "\n".join(json.dumps(r) for r in rows)
    text += "\n\n[1, 2]\n{\"num_nodes\": 3\n"
    path = tmp_path / "c.jsonl"
    path.write_text(text)
    report = _assert_loads_equal(str(path), str(tmp_path))
    assert report["quarantined"] >= 6


def test_validate_corpus_report_matches_jax(tmp_path):
    root = tmp_path / "cache"
    jgauntlet.poison_corpus(_examples(24, 1), root / "a", seed=1)
    pingest.write_examples_jsonl(_examples(10, 2), root / "b" / "x.jsonl")
    reports = []
    for pkg in (jgauntlet, pgauntlet):
        reports.append(pkg.validate_corpus(root, max_nodes=MAX_NODES))
        manifests = [jquarantine.read_manifest(q)
                     for q in sorted(root.rglob("quarantine"))]
        reports[-1]["_manifests"] = manifests
        for q in list(root.rglob("quarantine")):
            shutil.rmtree(q)
    assert reports[1] == reports[0]
    assert reports[0]["exit_code"] == 1


@pytest.mark.parametrize("row", [
    {"a": 1, "b": [1.5, "x"], "c": {"z": None, "é": True}},
    {"num_nodes": 3, "feats": {"api": [1, 2, 3]}, "__sha1__": "0" * 40},
    {"b": float("nan"), "a": [1e300, -0.0]},
])
def test_row_checksum_matches_jax(row):
    assert pschema.row_checksum(row) == jschema.row_checksum(row)
    checked = dict(row, **{pschema.CHECKSUM_KEY: pschema.row_checksum(row)})
    assert pschema.validate_cache_row(checked) == jschema.validate_cache_row(
        checked)


def test_row_checksum_matches_jax_on_corpus_rows(tmp_path):
    jgauntlet.poison_corpus(_examples(24, 4), tmp_path, seed=4)
    for line in (tmp_path / "corpus.jsonl").read_text().splitlines():
        try:
            row = json.loads(line)
        except json.JSONDecodeError:
            continue
        assert pschema.row_checksum(row) == jschema.row_checksum(row)
        outcome = []
        for mod in (jschema, pschema):
            try:
                outcome.append(("ok", mod.validate_cache_row(row)))
            except ValueError as e:
                outcome.append((e.reason, str(e)))
        assert outcome[0] == outcome[1]


def _graph(n=4):
    return {"num_nodes": n, "senders": list(range(n - 1)),
            "receivers": list(range(1, n)),
            "feats": {k: [2] * n for k in ALL_SUBKEYS},
            "vuln": [0] * (n - 1) + [1], "label": 1}


def _variants():
    g = _graph()
    n = g["num_nodes"]
    return {
        "ok": g,
        "float_repair": dict(g, num_nodes=4.0, label=1.0,
                             vuln=[0.0, 0.0, 0.0, 1.0]),
        "bool_vuln": dict(g, vuln=[False, False, False, True]),
        "no_label": {k: v for k, v in g.items() if k != "label"},
        "label_domain": dict(g, label=3),
        "vuln_domain": dict(g, vuln=[0, 0, 0, 2]),
        "vuln_length": dict(g, vuln=[0, 1]),
        "missing_vuln": {k: v for k, v in g.items() if k != "vuln"},
        "empty": dict(g, num_nodes=0),
        "oversize": dict(g, num_nodes=600),
        "df": dict(g, df_in=[0, 1, 1, 1], df_out=[1, 1, 1, 1]),
        "df_length": dict(g, df_in=[0, 1]),
        "node_ids": dict(g, node_ids=[10, 11, 12, 13],
                         node_lines=[1, 2, 2, 3]),
        "duplicate_ids": dict(g, node_ids=[10, 10, 12, 13]),
        "node_lines_length": dict(g, node_lines=[1]),
        "project": dict(g, project="linux", id=7),
        "float_id": dict(g, id=7.0),
        "bad_id": dict(g, id="seven"),
        "nan_feature": dict(g, feats=dict(g["feats"],
                                          api=[1.0, float("nan"), 2, 2])),
        "fraction_feature": dict(g, feats=dict(g["feats"],
                                               api=[1.5, 1, 2, 2])),
        "huge_endpoint": dict(g, senders=[2 ** 40, 0, 1]),
        "not_object": [1, 2],
        "feats_list": dict(g, feats=[1] * n),
    }


@pytest.mark.parametrize("name", sorted(_variants()))
def test_validate_example_with_labels_matches_jax(name):
    graph = _variants()[name]
    outcomes = []
    for mod in (jschema, pschema):
        repairs = []
        stats = (jschema if mod is jschema else pschema).STATS.__class__()
        try:
            out = mod.validate_example(graph, ALL_SUBKEYS, with_label=True,
                                       max_nodes=512, item_id=5,
                                       repairs=repairs, stats=stats)
        except ValueError as e:
            outcomes.append(("error", e.reason, str(e), e.fragment,
                             e.item_id, stats.snapshot()))
        else:
            outcomes.append(("ok", out, repairs, stats.snapshot()))
    (jk, *jrest), (pk, *prest) = outcomes
    assert pk == jk, outcomes
    if pk == "error":
        assert prest == jrest
        return
    _assert_same_example(prest[0], jrest[0])
    assert prest[1:] == jrest[1:]


def test_reason_table_matches_jax():
    assert pschema.REASONS == jschema.REASONS
    assert pschema.FATAL_REASONS == jschema.FATAL_REASONS
    assert pschema.REPAIRABLE_REASONS == jschema.REPAIRABLE_REASONS
    assert pschema.CHECKSUM_KEY == jschema.CHECKSUM_KEY


def test_quarantine_sink_matches_jax(tmp_path):
    err = dict(reason="dangling_endpoint", message="edge endpoint out of range",
               boundary="cache", item_id=3, fragment='{"x": 1}')
    for mod, qmod, name in ((jschema, jquarantine, "j"),
                            (pschema, pquarantine, "p")):
        sink = qmod.Quarantine(tmp_path / name)
        e = mod.ContractError(err["reason"], err["message"],
                              boundary=err["boundary"],
                              item_id=err["item_id"],
                              fragment=err["fragment"])
        sink.put(e, raw="line text\n")
        sink.put(e, raw={"structured": [1, 2]})
        sink.put(e)
        assert qmod.quarantine_dir(tmp_path / name / "c.jsonl") == \
            tmp_path / name / "quarantine"
    for fname in (jquarantine.MANIFEST_NAME, jquarantine.ITEMS_NAME):
        assert (tmp_path / "p" / fname).read_bytes() == \
            (tmp_path / "j" / fname).read_bytes()
    assert pquarantine.read_manifest(tmp_path / "p") == \
        jquarantine.read_manifest(tmp_path / "j")
    pquarantine.clear(tmp_path / "p")
    assert pquarantine.read_manifest(tmp_path / "p") == []


def test_ingest_stats_match_jax(tmp_path):
    jgauntlet.poison_corpus(_examples(24, 6), tmp_path, seed=6)
    snaps = []
    for pkg, schema_mod in ((jingest, jschema), (pingest, pschema)):
        schema_mod.STATS.reset()
        pkg.load_examples_jsonl(tmp_path / "corpus.jsonl", ALL_SUBKEYS,
                                max_nodes=MAX_NODES)
        snaps.append(schema_mod.STATS.snapshot())
        shutil.rmtree(tmp_path / "quarantine")
    assert snaps[1] == snaps[0]
    assert snaps[0]["cache"]["rejected"] > 0
