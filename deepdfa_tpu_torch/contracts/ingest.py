"""Validated JSONL ingestion (port of ``deepdfa_tpu/contracts/ingest.py``):
the one loader for cached graph corpora.

``cli.load_dataset``, ``data/combined.py``'s graph source and ``cli
validate`` all read exported examples through :func:`load_examples_jsonl`,
so the contract (schema.py) and the fail-closed quarantine (quarantine.py)
hold at every consumer:

- a line that does not parse is quarantined as ``truncated_json``;
- a row whose ``__sha1__`` digest mismatches is ``checksum_mismatch``;
- a row violating the example schema quarantines under its reason code;
- repairable violations (integral-float casts) are fixed in place,
  counted, and the item is kept: repairs preserve values, so a repaired
  corpus trains bit for bit like its clean original.

The loader never raises mid-corpus: one poisoned row costs that row, not
the run.

It is two-tier, as the reference's:

1. a **structural fast path** per row: exact-type probes (``type(x) is
   int``; ``bool`` fails one and routes to the slow path), ``len()``
   shape checks, required-subkey presence, python-level ``max()`` upper
   bounds on the parsed lists, and one ``np.asarray`` over a merged
   per-row buffer whose slices become the example's arrays;
2. a **corpus-level negativity pass**: the merged buffers concatenate
   once per corpus and one ``min()`` proves every edge endpoint, vuln bit
   and feature index non-negative; a violation rescans per row and routes
   offenders through the precise validator (``schema.validate_example``)
   for their exact reason code and quarantine.

Rows that miss the fast path (checksummed rows, float-typed fields, any
structural oddity) take the full validator. The reference's known
fast-path limit holds here too: a *single* non-integral float spliced
mid-array (not at either probed end) casts instead of quarantining;
whole-array float fields, the JSON round-trip artifact, are caught and
repaired, and checksummed rows always get the full validator. The two
tiers give the
reference's examples, report and manifest rows (tests/test_torch_contracts.py
holds them to it, corpus for corpus).
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from deepdfa_tpu_torch.contracts.quarantine import Quarantine, quarantine_dir
from deepdfa_tpu_torch.contracts.schema import (
    CHECKSUM_KEY,
    ContractError,
    IngestStats,
    STATS,
    row_checksum,
    validate_cache_row,
    validate_example,
)

logger = logging.getLogger(__name__)


def encode_row(ex: Mapping) -> Dict:
    """One example as a JSON-able row (numpy arrays to lists): the row
    encoder of :func:`write_examples_jsonl`."""
    row: Dict = {}
    for k, v in ex.items():
        if isinstance(v, np.ndarray):
            row[k] = v.tolist()
        elif isinstance(v, Mapping):
            row[k] = {kk: (vv.tolist()
                           if isinstance(vv, np.ndarray) else vv)
                      for kk, vv in v.items()}
        elif isinstance(v, (np.integer,)):
            row[k] = int(v)
        else:
            row[k] = v
    return row


def write_examples_jsonl(examples: Sequence[Mapping], path: str | Path,
                         checksum: bool = True) -> int:
    """Write graph examples as JSONL (numpy arrays to lists); with
    ``checksum`` each row carries its ``__sha1__`` content digest so
    bitrot is detectable at load. Returns rows written."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    n = 0
    with open(path, "w", encoding="utf-8") as f:
        for ex in examples:
            row = encode_row(ex)
            if checksum:
                row[CHECKSUM_KEY] = row_checksum(row)
            f.write(json.dumps(row) + "\n")
            n += 1
    return n


class _FastMiss(Exception):
    """Row needs the full per-row validator (not necessarily bad)."""


_PER_NODE_OPTIONAL = ("df_in", "df_out", "node_ids", "node_lines")


def _fast_example(doc, subkeys, max_nodes,
                  line_index) -> Tuple[Dict, np.ndarray]:
    """The structural fast path: validate + normalize one parsed row, or
    raise ``_FastMiss`` to defer to the full validator. Returns
    ``(example, merged_buffer)``; the buffer (layout: senders, receivers,
    vuln, feats values) feeds the corpus-level negativity pass, and the
    example's arrays are slice views of it — one conversion dispatch per
    row."""
    if type(doc) is not dict or CHECKSUM_KEY in doc:
        raise _FastMiss
    n = doc.get("num_nodes")
    if type(n) is not int or n < 1:
        raise _FastMiss
    if max_nodes is not None and n > max_nodes:
        raise _FastMiss
    s = doc.get("senders")
    r = doc.get("receivers")
    if type(s) is not list or type(r) is not list or len(s) != len(r):
        raise _FastMiss
    if s and (type(s[0]) is not int or type(s[-1]) is not int
              or type(r[0]) is not int or type(r[-1]) is not int):
        raise _FastMiss
    feats = doc.get("feats")
    if type(feats) is not dict:
        raise _FastMiss
    for key in subkeys:
        if key not in feats:
            raise _FastMiss
    vuln = doc.get("vuln")
    if type(vuln) is not list or len(vuln) != n:
        raise _FastMiss
    if type(vuln[0]) is not int or type(vuln[-1]) is not int:
        raise _FastMiss
    for key in _PER_NODE_OPTIONAL:
        if key in doc:
            v = doc[key]
            if type(v) is not list or len(v) != n:
                raise _FastMiss
    if "node_ids" in doc and len(set(doc["node_ids"])) != n:
        raise _FastMiss  # duplicate_node_id — the slow path names it
    if "id" in doc:
        if type(doc["id"]) is not int:
            raise _FastMiss
    else:
        doc["id"] = line_index
    if "label" in doc:
        # Exact-type probe: 1.0 and True compare equal to 1 but need the
        # slow path's float_field repair (the two tiers must agree).
        lab = doc["label"]
        if type(lab) is not int or lab not in (0, 1):
            raise _FastMiss
    e = len(s)
    merged = s + r + vuln
    try:
        # Upper bounds python-side on the parsed lists (a C loop, no numpy
        # dispatch; TypeError on mixed types -> slow path). Lower bounds
        # ride the corpus-level min over the merged buffers.
        if s and (max(s) >= n or max(r) >= n):
            raise _FastMiss
        if max(vuln) > 1:
            raise _FastMiss
        feat_views: Dict[str, slice] = {}
        off = 2 * e + n
        for key, v in feats.items():
            if type(v) is not list or len(v) != n:
                raise _FastMiss
            if v and (type(v[0]) is not int or type(v[-1]) is not int):
                raise _FastMiss
            merged += v
            feat_views[key] = slice(off, off + n)
            off += n
        # ONE conversion per row (the raw loader paid one per field).
        # numpy itself rejects NaN-to-int and non-numeric input.
        buf = np.asarray(merged, np.int32)
    except (TypeError, ValueError, OverflowError):
        raise _FastMiss
    doc["senders"] = buf[:e]
    doc["receivers"] = buf[e:2 * e]
    doc["vuln"] = buf[2 * e:2 * e + n]
    doc["feats"] = {k: buf[sl] for k, sl in feat_views.items()}
    return doc, buf


def load_examples_jsonl(
    path: str | Path,
    subkeys: Sequence[str],
    *,
    max_nodes: Optional[int] = None,
    quarantine: Optional[Quarantine] = None,
    boundary: str = "cache",
    stats: Optional[IngestStats] = None,
) -> Tuple[List[Dict], Dict]:
    """Load a graph-example JSONL corpus through the full contract.

    Returns ``(examples, report)``: the surviving normalized examples (the
    ``batch_graphs`` input schema — int32 arrays, ``id`` defaulting to the
    line index, ``label`` defaulting to ``vuln.max()``) and a report dict
    with per-reason quarantine counts. ``quarantine`` defaults to the
    ``quarantine/`` sibling of ``path``; pass an explicit sink to redirect.
    """
    path = Path(path)
    sink = quarantine if quarantine is not None else Quarantine(
        quarantine_dir(path))
    target = stats if stats is not None else STATS

    examples: List[Dict] = []
    fast_bufs: List[np.ndarray] = []
    fast_positions: List[int] = []
    fast_lines: List[str] = []
    repaired = 0
    n_lines = 0

    def slow_validate(doc, line, item_id) -> Optional[Dict]:
        """The precise per-row path; returns the example or quarantines."""
        nonlocal repaired
        repairs: List[str] = []
        try:
            row = validate_cache_row(doc, boundary=boundary,
                                     item_id=item_id)
            ex = validate_example(
                row, subkeys, with_label=True, max_nodes=max_nodes,
                boundary=boundary, item_id=item_id, repairs=repairs)
        except ContractError as err:
            target.bump(boundary, f"reason:{err.reason}")
            sink.put(err, raw=line)
            return None
        if repairs:
            repaired += 1
            for rep in set(repairs):
                target.bump(boundary, f"repair:{rep}")
        return ex

    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            try:
                doc = json.loads(line)
            except json.JSONDecodeError as e:
                if not line.strip():
                    continue  # blank line, not a violation
                n_lines += 1
                target.bump(boundary, "reason:truncated_json")
                sink.put(ContractError(
                    "truncated_json", f"line {i}: {e}", boundary=boundary,
                    item_id=i, fragment=line.strip()[:160]), raw=line)
                continue
            n_lines += 1
            try:
                ex, buf = _fast_example(doc, subkeys, max_nodes, i)
            except _FastMiss:
                item_id = doc.get("id", i) if isinstance(doc, Mapping) else i
                ex = slow_validate(doc, line, item_id)
                if ex is None:
                    continue
                ex.setdefault("id", i)
            else:
                fast_positions.append(len(examples))
                fast_bufs.append(buf)
                fast_lines.append(line)
            examples.append(ex)

    # Corpus-level negativity pass: one concat + one min proves every
    # fast-path edge endpoint, vuln bit, and feature index >= 0 (upper
    # bounds were checked per row). Violators re-run the precise validator
    # for their reason code (dangling_endpoint / label_domain /
    # negative_feature) and quarantine.
    if fast_bufs:
        allcat = (np.concatenate(fast_bufs) if len(fast_bufs) > 1
                  else fast_bufs[0])
        if allcat.size and int(allcat.min()) < 0:
            drop = set()
            for pos, buf, line in zip(fast_positions, fast_bufs,
                                      fast_lines):
                if buf.size and int(buf.min()) < 0:
                    ex = examples[pos]
                    if slow_validate(ex, line, ex.get("id", pos)) is None:
                        drop.add(pos)
            examples = [ex for i, ex in enumerate(examples)
                        if i not in drop]

    # Label default for fast-path rows that carried none (the raw loader's
    # setdefault semantics; exports always write a label).
    for ex in examples:
        if "label" not in ex:
            ex["label"] = int(ex["vuln"].max()) if len(ex["vuln"]) else 0

    target.bump(boundary, "seen", n_lines)
    target.bump(boundary, "valid", len(examples))
    target.bump(boundary, "rejected", n_lines - len(examples))
    if repaired:
        target.bump(boundary, "repaired", repaired)

    report = {
        "path": str(path),
        "lines": n_lines,
        "loaded": len(examples),
        "repaired": repaired,
        "fast_path": len(fast_bufs),
        **sink.report(),
    }
    if sink.total:
        logger.warning(
            "ingest %s: %d/%d rows quarantined (%s) -> %s", path,
            sink.total, n_lines, dict(sink.counts), sink.root)
    return examples, report
