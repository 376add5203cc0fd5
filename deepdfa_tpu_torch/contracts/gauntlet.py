"""The corrupt-corpus gauntlet (port of
``deepdfa_tpu/contracts/gauntlet.py``): a seeded fuzzer proving the
contracts, and ``cli validate``'s engine.

``poison_corpus`` damages a synthetic corpus across every corruption class
in :data:`CORRUPTIONS` (one victim row per class, chosen by a seeded RNG:
same seed, same plan, same damage) and writes

- ``corpus.jsonl``       — the poisoned corpus (checksummed rows);
- ``clean_subset.jsonl`` — the pre-corruption originals of every row that
  SHOULD survive ingestion (fatally-corrupted victims removed, repairable
  victims restored);
- ``poison_plan.json``   — the plan: each class's victim and the reason
  code the quarantine manifest must record.

``validate_corpus`` is the ``cli validate <cache-dir>`` engine; ``smoke``
is the seconds-long self-test behind ``cli validate --smoke``. For one
seed the corpus, the clean subset and the plan are the reference's byte
for byte.
"""

from __future__ import annotations

import copy
import json
import random
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from deepdfa_tpu_torch.contracts.ingest import load_examples_jsonl
from deepdfa_tpu_torch.contracts.quarantine import (
    DIRNAME as QUARANTINE_DIRNAME,
    Quarantine,
    read_manifest,
)
from deepdfa_tpu_torch.contracts.schema import CHECKSUM_KEY, row_checksum
from deepdfa_tpu_torch.core.config import ALL_SUBKEYS

#: Node cap the gauntlet corpora are validated under (the oversize class
#: multiplies past it; every clean synthetic graph sits far below it).
GAUNTLET_MAX_NODES = 512


def _first_subkey(row) -> str:
    return next(iter(row["feats"]))


# Each corruption: (level, mutate, expected_reason, expected_repair)
#   level "row"  — mutates the parsed row; the checksum is RE-computed
#                  after (damage predates the cache write, so the digest
#                  is consistent and the schema validator must catch it);
#   level "post" — mutates the row AFTER checksumming (bitrot after the
#                  write: the digest check must catch it);
#   level "line" — mutates the serialized line text (torn writes).
# expected_reason None => the row must survive; expected_repair names the
# repair code the loader must apply.


def _c_truncate(line: str, rng: random.Random) -> str:
    return line[: max(len(line) // 2, 1)]


def _c_dangling(row, rng):
    k = rng.randrange(len(row["senders"]))
    row["senders"][k] = int(row["num_nodes"]) + 3
    return row


def _c_negative_feature(row, rng):
    key = _first_subkey(row)
    row["feats"][key][rng.randrange(len(row["feats"][key]))] = -5
    return row


def _c_nan_feature(row, rng):
    key = _first_subkey(row)
    feats = [float(v) for v in row["feats"][key]]
    feats[rng.randrange(len(feats))] = float("nan")
    row["feats"][key] = feats
    return row


def _c_feat_length(row, rng):
    key = _first_subkey(row)
    row["feats"][key] = row["feats"][key][:-1]
    return row


def _c_duplicate_node_id(row, rng):
    ids = row["node_ids"]
    ids[1 % len(ids)] = ids[0]
    return row


def _c_label_domain(row, rng):
    row["label"] = 7
    return row


def _c_empty_graph(row, rng):
    row["num_nodes"] = 0
    for key in ("senders", "receivers", "vuln", "df_in", "df_out",
                "node_ids"):
        if key in row:
            row[key] = []
    row["feats"] = {k: [] for k in row["feats"]}
    return row


def _c_oversize_graph(row, rng):
    row["num_nodes"] = GAUNTLET_MAX_NODES * 10
    return row


def _c_mistyped_field(row, rng):
    row["senders"] = "not-an-edge-list"
    return row


def _c_missing_subkey(row, rng):
    row["feats"].pop(_first_subkey(row))
    return row


def _c_checksum(row, rng):
    # "post" level: flips content under an already-recorded digest.
    row["label"] = 1 - int(row["label"])
    return row


def _c_float_feats(row, rng):
    key = _first_subkey(row)
    row["feats"][key] = [float(v) for v in row["feats"][key]]
    return row


def _c_float_label(row, rng):
    row["label"] = float(row["label"])
    return row


CORRUPTIONS: Dict[str, Tuple[str, Callable, Optional[str], Optional[str]]] = {
    "truncated_json":    ("line", _c_truncate,          "truncated_json", None),
    "dangling_endpoint": ("row",  _c_dangling,          "dangling_endpoint", None),
    "negative_feature":  ("row",  _c_negative_feature,  "negative_feature", None),
    "nan_feature":       ("row",  _c_nan_feature,       "nan_feature", None),
    "feat_length":       ("row",  _c_feat_length,       "feat_length", None),
    "duplicate_node_id": ("row",  _c_duplicate_node_id, "duplicate_node_id", None),
    "label_domain":      ("row",  _c_label_domain,      "label_domain", None),
    "empty_graph":       ("row",  _c_empty_graph,       "empty_graph", None),
    "oversize_graph":    ("row",  _c_oversize_graph,    "oversize_graph", None),
    "mistyped_field":    ("row",  _c_mistyped_field,    "mistyped_field", None),
    "missing_subkey":    ("row",  _c_missing_subkey,    "missing_subkey", None),
    "checksum_mismatch": ("post", _c_checksum,          "checksum_mismatch", None),
    # Repairable classes: the loader must fix these in place, exactly.
    "float_feats":       ("row",  _c_float_feats,       None, "float_field"),
    "float_label":       ("row",  _c_float_label,       None, "float_field"),
}


def _rows_from_examples(examples: Sequence[Dict]) -> List[Dict]:
    """JSON-able rows via THE shared row encoder (ingest.encode_row),
    re-id'd to their corpus position (so a quarantine manifest ``item_id``
    equals the line index for every class, including unparseable lines)
    and carrying explicit ``node_ids``."""
    from deepdfa_tpu_torch.contracts.ingest import encode_row

    rows: List[Dict] = []
    for i, ex in enumerate(examples):
        row = encode_row(ex)
        row["id"] = i
        row.setdefault("node_ids", list(range(int(row["num_nodes"]))))
        rows.append(row)
    return rows


def poison_corpus(
    examples: Sequence[Dict],
    out_dir: str | Path,
    seed: int = 0,
    classes: Optional[Sequence[str]] = None,
) -> Dict:
    """Write ``corpus.jsonl`` (poisoned) + ``clean_subset.jsonl`` under
    ``out_dir``; returns the corruption plan.

    One victim row per class, victims distinct, chosen by
    ``random.Random(seed)``. Raises when the corpus is too small to host
    every class (each needs its own victim).
    """
    classes = list(classes) if classes is not None else list(CORRUPTIONS)
    unknown = set(classes) - set(CORRUPTIONS)
    if unknown:
        raise ValueError(f"unknown corruption classes {sorted(unknown)}")
    rows = _rows_from_examples(examples)
    if len(rows) <= len(classes):
        raise ValueError(
            f"corpus of {len(rows)} rows cannot host {len(classes)} "
            "corruption classes plus clean survivors")
    rng = random.Random(seed)
    victims = rng.sample(range(len(rows)), len(classes))
    victim_of = dict(zip(classes, victims))

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    plan: List[Dict] = []
    poisoned_lines: List[str] = []
    clean_lines: List[str] = []
    index_to_class = {idx: cls for cls, idx in victim_of.items()}
    for i, row in enumerate(rows):
        clean_text = None
        cls = index_to_class.get(i)
        if cls is None:
            text = json.dumps(
                dict(row, **{CHECKSUM_KEY: row_checksum(row)}))
            clean_text = text
        else:
            level, fn, reason, repair = CORRUPTIONS[cls]
            bad = copy.deepcopy(row)
            if level == "row":
                bad = fn(bad, rng)
                bad[CHECKSUM_KEY] = row_checksum(bad)
                text = json.dumps(bad)
            elif level == "post":
                bad[CHECKSUM_KEY] = row_checksum(bad)
                bad = fn(bad, rng)
                text = json.dumps(bad)
            else:  # line
                text = fn(json.dumps(
                    dict(bad, **{CHECKSUM_KEY: row_checksum(bad)})), rng)
            if reason is None:
                # Repairable: the original belongs in the clean subset.
                clean_text = json.dumps(
                    dict(row, **{CHECKSUM_KEY: row_checksum(row)}))
            plan.append({"class": cls, "index": i, "id": row["id"],
                         "expected_reason": reason,
                         "expected_repair": repair})
        poisoned_lines.append(text)
        if clean_text is not None:
            clean_lines.append(clean_text)

    (out_dir / "corpus.jsonl").write_text(
        "\n".join(poisoned_lines) + "\n", encoding="utf-8")
    (out_dir / "clean_subset.jsonl").write_text(
        "\n".join(clean_lines) + "\n", encoding="utf-8")
    plan_doc = {"seed": seed, "classes": classes, "n_rows": len(rows),
                "victims": sorted(plan, key=lambda p: p["index"])}
    with open(out_dir / "poison_plan.json", "w", encoding="utf-8") as f:
        json.dump(plan_doc, f, indent=1)
    return plan_doc


def check_manifest(plan: Dict, manifest: List[Dict],
                   loaded_ids: Sequence[int]) -> Dict:
    """Grade a quarantine manifest against a corruption plan.

    Every fatal victim must appear exactly once with its expected reason;
    no clean (or repairable) row may be quarantined; every repairable
    victim must have survived into ``loaded_ids``.
    """
    fatal = {p["index"]: p for p in plan["victims"]
             if p["expected_reason"] is not None}
    repairable = [p for p in plan["victims"] if p["expected_reason"] is None]
    by_item: Dict[int, List[Dict]] = {}
    for entry in manifest:
        by_item.setdefault(int(entry["item_id"]), []).append(entry)

    missing = [i for i in fatal if i not in by_item]
    wrong_reason = [
        {"index": i, "want": fatal[i]["expected_reason"],
         "got": [e["reason"] for e in by_item[i]]}
        for i in fatal if i in by_item
        and [e["reason"] for e in by_item[i]] != [fatal[i]["expected_reason"]]
    ]
    false_quarantines = sorted(set(by_item) - set(fatal))
    loaded = set(int(i) for i in loaded_ids)
    repairs_lost = [p["index"] for p in repairable
                    if p["index"] not in loaded]
    ok = not (missing or wrong_reason or false_quarantines or repairs_lost)
    return {"ok": ok, "missing": missing, "wrong_reason": wrong_reason,
            "false_quarantines": false_quarantines,
            "repairs_lost": repairs_lost,
            "fatal_victims": len(fatal),
            "repairable_victims": len(repairable)}


# ---------------------------------------------------------------------------
# cli validate
# ---------------------------------------------------------------------------


def validate_corpus(
    target: str | Path,
    subkeys: Sequence[str] = ALL_SUBKEYS,
    max_nodes: Optional[int] = None,
    quarantine_root: Optional[str | Path] = None,
) -> Dict:
    """Validate a corpus file or cache directory (every ``*.jsonl`` under
    it, the quarantine directory excluded). Returns the ``cli validate``
    report; ``exit_code`` 1 when anything was quarantined (fail-closed:
    a dirty cache fails a pipeline gate instead of passing silently)."""
    target = Path(target)
    if target.is_dir():
        files = sorted(
            p for p in target.rglob("*.jsonl")
            if QUARANTINE_DIRNAME not in p.parts
        )
    else:
        files = [target]
    if not files:
        raise FileNotFoundError(f"no .jsonl corpus under {target}")
    reports = []
    total_quarantined = 0
    by_reason: Dict[str, int] = {}
    for path in files:
        sink = Quarantine(quarantine_root) if quarantine_root is not None \
            else Quarantine(path.parent / QUARANTINE_DIRNAME)
        _, rep = load_examples_jsonl(path, subkeys, max_nodes=max_nodes,
                                     quarantine=sink)
        reports.append(rep)
        total_quarantined += rep["quarantined"]
        for reason, count in rep["by_reason"].items():
            by_reason[reason] = by_reason.get(reason, 0) + count
    return {
        "files": [r["path"] for r in reports],
        "rows": sum(r["lines"] for r in reports),
        "loaded": sum(r["loaded"] for r in reports),
        "repaired": sum(r["repaired"] for r in reports),
        "quarantined": total_quarantined,
        "by_reason": dict(sorted(by_reason.items())),
        "reports": reports,
        "exit_code": 1 if total_quarantined else 0,
    }


def smoke(out_dir: Optional[str | Path] = None, n_examples: int = 24,
          seed: int = 0) -> Dict:
    """Seconds-long self-test (the ``cli validate --smoke`` engine): poison
    a tiny synthetic corpus across EVERY corruption class, ingest it, and
    grade the quarantine manifest. ``ok`` only when every class was
    repaired or quarantined under its expected reason code with zero false
    quarantines."""
    import tempfile

    from deepdfa_tpu_torch.core.config import FeatureSpec
    from deepdfa_tpu_torch.data.synthetic import synthetic_bigvul

    tmp = Path(out_dir) if out_dir is not None else Path(
        tempfile.mkdtemp(prefix="contracts_smoke_"))
    tmp.mkdir(parents=True, exist_ok=True)
    feature = FeatureSpec(limit_all=20, limit_subkeys=20)
    examples = synthetic_bigvul(n_examples, feature, positive_fraction=0.5,
                                seed=seed)
    plan = poison_corpus(examples, tmp, seed=seed)
    sink = Quarantine(tmp / QUARANTINE_DIRNAME)
    loaded, report = load_examples_jsonl(
        tmp / "corpus.jsonl", ALL_SUBKEYS,
        max_nodes=GAUNTLET_MAX_NODES, quarantine=sink)
    grade = check_manifest(plan, read_manifest(sink.root),
                           [ex["id"] for ex in loaded])
    n_fatal = grade["fatal_victims"]
    survived = report["loaded"] == n_examples - n_fatal
    repaired = report["repaired"] >= grade["repairable_victims"]
    ok = bool(grade["ok"] and survived and repaired)
    return {
        "ok": ok,
        "classes": len(plan["classes"]),
        "n_examples": n_examples,
        "ingest": {k: v for k, v in report.items() if k != "reports"},
        "grade": grade,
        "out_dir": str(tmp),
        "exit_code": 0 if ok else 1,
    }
