"""The port's corrupt-corpus gauntlet (``contracts/gauntlet.py``) against
the JAX package's: for one seed the poisoned corpus, the clean subset and
the plan are the same bytes; the port's loader quarantines the port's
corpus as the JAX loader does the JAX corpus (manifests equal); the two
graders agree; ``smoke`` and ``cli validate --smoke`` pass."""

import json
import os

import pytest

jax = pytest.importorskip("jax")

from deepdfa_tpu.contracts import gauntlet as jgauntlet
from deepdfa_tpu.contracts import ingest as jingest
from deepdfa_tpu.contracts import quarantine as jquarantine
from deepdfa_tpu.core.config import FeatureSpec as JFeatureSpec
from deepdfa_tpu.data.synthetic import synthetic_bigvul as jsynthetic
from deepdfa_tpu_torch.contracts import gauntlet as pgauntlet
from deepdfa_tpu_torch.contracts import ingest as pingest
from deepdfa_tpu_torch.contracts import quarantine as pquarantine
from deepdfa_tpu_torch.core.config import ALL_SUBKEYS, FeatureSpec
from deepdfa_tpu_torch.data.synthetic import synthetic_bigvul as psynthetic

LIMITS = dict(limit_all=20, limit_subkeys=20)
FILES = ("corpus.jsonl", "clean_subset.jsonl", "poison_plan.json")


def _poison_both(root, n, seed, classes=None):
    plans = {}
    for name, pkg, synth, spec in (
            ("jax", jgauntlet, jsynthetic, JFeatureSpec),
            ("port", pgauntlet, psynthetic, FeatureSpec)):
        examples = synth(n, spec(**LIMITS), positive_fraction=0.5, seed=seed)
        plans[name] = pkg.poison_corpus(examples, os.path.join(root, name),
                                        seed=seed, classes=classes)
    return plans


def test_the_corruption_table_matches_jax():
    assert list(pgauntlet.CORRUPTIONS) == list(jgauntlet.CORRUPTIONS)
    for cls, (level, _, reason, repair) in jgauntlet.CORRUPTIONS.items():
        plevel, _, preason, prepair = pgauntlet.CORRUPTIONS[cls]
        assert (plevel, preason, prepair) == (level, reason, repair), cls
    assert pgauntlet.GAUNTLET_MAX_NODES == jgauntlet.GAUNTLET_MAX_NODES


@pytest.mark.parametrize("classes", [None, ["float_label"],
                                     ["truncated_json", "checksum_mismatch",
                                      "nan_feature", "float_feats"]])
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_poisoned_corpus_and_plan_match_jax_byte_for_byte(tmp_path, seed,
                                                          classes):
    plans = _poison_both(str(tmp_path), 24, seed, classes)
    assert plans["port"] == plans["jax"]
    for f in FILES:
        with open(tmp_path / "port" / f, "rb") as a, \
                open(tmp_path / "jax" / f, "rb") as b:
            assert a.read() == b.read(), f


@pytest.mark.parametrize("seed", [0, 5])
def test_quarantine_manifest_matches_the_jax_loader(tmp_path, seed):
    plans = _poison_both(str(tmp_path), 30, seed)
    loaded = {}
    for name, ingest, qmod in (("jax", jingest, jquarantine),
                               ("port", pingest, pquarantine)):
        root = tmp_path / name
        sink = qmod.Quarantine(root / "quarantine")
        examples, report = ingest.load_examples_jsonl(
            root / "corpus.jsonl", ALL_SUBKEYS,
            max_nodes=jgauntlet.GAUNTLET_MAX_NODES, quarantine=sink)
        loaded[name] = ([ex["id"] for ex in examples],
                        qmod.read_manifest(sink.root),
                        {k: v for k, v in report.items()
                         if k not in ("dir", "path")})
    assert loaded["port"] == loaded["jax"]
    ids, manifest, _ = loaded["port"]
    grades = [pkg.check_manifest(plans["port"], manifest, ids)
              for pkg in (pgauntlet, jgauntlet)]
    assert grades[0] == grades[1] and grades[0]["ok"]
    assert grades[0]["fatal_victims"] == 12
    assert grades[0]["repairable_victims"] == 2


def test_graders_agree_on_a_wrong_manifest(tmp_path):
    plan = _poison_both(str(tmp_path), 24, 2)["port"]
    fatal = [v for v in plan["victims"] if v["expected_reason"]]
    manifest = [{"item_id": v["index"], "reason": v["expected_reason"]}
                for v in fatal[1:]]
    manifest[0]["reason"] = "label_domain" if \
        manifest[0]["reason"] != "label_domain" else "empty_graph"
    victims = {v["index"] for v in plan["victims"]}
    manifest.append({"item_id": min(set(range(24)) - victims),
                     "reason": "feat_length"})
    repair = [v["index"] for v in plan["victims"]
              if not v["expected_reason"]]
    ids = [i for i in range(24) if i not in repair[:1]]
    got = pgauntlet.check_manifest(plan, manifest, ids)
    want = jgauntlet.check_manifest(plan, manifest, ids)
    assert got == want
    assert not got["ok"] and got["missing"] and got["wrong_reason"]
    assert got["false_quarantines"] and got["repairs_lost"]


@pytest.mark.parametrize("seed", [0, 3])
def test_smoke_matches_jax(tmp_path, seed):
    got = pgauntlet.smoke(tmp_path / "port", seed=seed)
    want = jgauntlet.smoke(tmp_path / "jax", seed=seed)
    assert got["ok"] and want["ok"]
    for report in (got, want):
        report.pop("out_dir")
        for key in ("dir", "path"):
            report["ingest"].pop(key)
    assert got == want


def test_too_small_a_corpus_and_unknown_classes_raise(tmp_path):
    examples = psynthetic(10, FeatureSpec(**LIMITS), seed=0)
    with pytest.raises(ValueError, match="cannot host"):
        pgauntlet.poison_corpus(examples, tmp_path)
    with pytest.raises(ValueError, match="unknown corruption classes"):
        pgauntlet.poison_corpus(examples, tmp_path, classes=["bitrot"])


@pytest.mark.parametrize("seed", ["0", "11"])
def test_cli_validate_smoke_exits_0(capsys, seed):
    from deepdfa_tpu_torch import cli

    assert cli.main(["validate", "--smoke", "--seed", seed]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["ok"] and report["classes"] == 14
    assert report["grade"]["false_quarantines"] == []
