"""The data contracts at every ingestion boundary the port reads (port
of ``deepdfa_tpu/contracts/schema.py``).

One validator family guards cached JSONL rows, ``batch_graphs`` inputs
and serve admission, with the reference's reason-coded taxonomy:

- **fatal** reasons reject the item (:class:`ContractError`); the
  ingestion loader moves it to the quarantine sink
  (``contracts/quarantine.py``) instead of letting it reach the model;
- **repairable** reasons are fixed in place *exactly* (integral floats
  and bools cast back to ints, a JSON round-trip artifact), recorded in
  the ``repairs`` out-param, and never change what the item means.

Same reason codes and messages as the reference, so a malformed row
reads the same from both packages. The Joern export validators and the
scan-source contract wait for the scan path.
"""

from __future__ import annotations

import hashlib
import json
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np

from deepdfa_tpu_torch.core.metrics import IngestStats

#: Process-wide per-boundary ingest counters (``STATS.snapshot()`` is
#: ``cli validate``'s ``ingest_stats``). The bulk loader counts once per
#: corpus; a validator counts only when handed ``stats=``.
STATS = IngestStats()

#: Reason-code taxonomy: code -> severity. Fatal reasons quarantine the
#: item; repairable reasons are fixed in place (value-preserving) and only
#: counted. The whole table is the reference's, including the codes of
#: the boundaries the port does not read yet (Joern exports, scan).
REASONS: Dict[str, str] = {
    "truncated_json": "fatal",     # line does not parse as JSON
    "checksum_mismatch": "fatal",  # cache row fails its __sha1__ digest
    "mistyped_field": "fatal",     # non-coercible field type
    "missing_field": "fatal",      # required field absent
    "missing_subkey": "fatal",     # a required feature subkey absent
    "empty_graph": "fatal",        # num_nodes < 1
    "oversize_graph": "fatal",     # num_nodes > the configured cap
    "edge_shape": "fatal",         # senders/receivers not equal-length 1-d
    "dangling_endpoint": "fatal",  # edge endpoint < 0 or >= num_nodes
    "feat_length": "fatal",        # per-node array not shaped (num_nodes,)
    "negative_feature": "fatal",   # feature index < 0
    "nan_feature": "fatal",        # non-finite feature value
    "label_domain": "fatal",       # label / vuln bit outside {0, 1}
    "duplicate_node_id": "fatal",  # node id repeats in an export
    "no_method_node": "fatal",     # Joern graph without a METHOD node
    "bad_source": "fatal",         # scan source text fails the API contract
    "joern_failure": "fatal",      # CPG extraction gave up after retries
    "float_field": "repairable",   # integral floats / bools cast back exactly
}

FATAL_REASONS = frozenset(r for r, sev in REASONS.items() if sev == "fatal")
REPAIRABLE_REASONS = frozenset(
    r for r, sev in REASONS.items() if sev == "repairable"
)

#: Key carrying a cache row's content digest (``row_checksum`` of the row
#: without this key). Absent on pipeline exports; written by the
#: checksummed writer (``contracts/ingest.write_examples_jsonl``).
CHECKSUM_KEY = "__sha1__"


class ContractError(ValueError):
    """A fatal data-contract violation at an ingestion boundary.

    Subclasses :class:`ValueError`, so callers that catch ValueError
    (the batcher's overflow handling) keep working. Carries the taxonomy ``reason`` code, the ``boundary`` it was
    detected at, the ``item_id`` (when known), and a bounded ``fragment``
    of the offending data — everything the quarantine manifest records.
    """

    def __init__(self, reason: str, message: str, *,
                 boundary: str = "example",
                 item_id=None, fragment: Optional[str] = None):
        if reason not in REASONS:
            raise ValueError(f"unknown contract reason {reason!r}")
        super().__init__(message)
        self.reason = reason
        self.boundary = boundary
        self.item_id = item_id
        self.fragment = fragment


def fragment_of(value, limit: int = 160) -> str:
    """Bounded repr of the offending data for the quarantine manifest."""
    try:
        text = json.dumps(value, default=repr)
    except (TypeError, ValueError):
        text = repr(value)
    return text if len(text) <= limit else text[: limit - 1] + "…"


def row_checksum(row: Mapping) -> str:
    """Content digest of one cache row (the :data:`CHECKSUM_KEY` value):
    sha1 over the canonical JSON of the row without the digest key."""
    payload = {k: v for k, v in row.items() if k != CHECKSUM_KEY}
    canon = json.dumps(payload, sort_keys=True, separators=(",", ":"),
                       default=repr)
    return hashlib.sha1(canon.encode("utf-8")).hexdigest()


# ---------------------------------------------------------------------------
# Field coercion
# ---------------------------------------------------------------------------


def _int_array(
    value,
    what: str,
    *,
    boundary: str,
    item_id,
    repairs: Optional[List[str]],
    dtype=np.int32,
) -> np.ndarray:
    """Coerce one per-node/per-edge field to an int array.

    Int/uint input passes through (cast only when the dtype differs — the
    hot path for already-typed arrays is copy-free); bool and *integral*
    float input is a repairable JSON artifact and casts back exactly;
    non-integral floats, NaN/inf, strings, and ragged objects are fatal.
    """
    try:
        arr = np.asarray(value)
    except (TypeError, ValueError) as e:
        raise ContractError(
            "mistyped_field", f"malformed graph payload: {what}: {e}",
            boundary=boundary, item_id=item_id, fragment=fragment_of(value))

    def check_range(a):
        # astype wraps silently past the target dtype's range — a corrupt
        # 64-bit edge endpoint must not wrap back INTO valid range and
        # slip past the endpoint check (the silent-poisoning class again).
        info = np.iinfo(dtype)
        if a.size and (int(a.min()) < info.min or int(a.max()) > info.max):
            raise ContractError(
                "mistyped_field",
                f"malformed graph payload: {what} exceeds the "
                f"{np.dtype(dtype).name} range",
                boundary=boundary, item_id=item_id,
                fragment=fragment_of([int(a.min()), int(a.max())]))

    kind = arr.dtype.kind
    if kind in "iu":
        if arr.dtype == dtype:
            return arr
        check_range(arr)
        return arr.astype(dtype)
    if kind == "b":
        if repairs is not None and arr.size:
            repairs.append("float_field")
        return arr.astype(dtype)
    if kind == "f":
        if not np.all(np.isfinite(arr)):
            raise ContractError(
                "nan_feature", f"{what} has non-finite entries",
                boundary=boundary, item_id=item_id,
                fragment=fragment_of(np.asarray(value).tolist()))
        if arr.size and not np.array_equal(arr, np.trunc(arr)):
            raise ContractError(
                "mistyped_field",
                f"malformed graph payload: {what} has non-integral values",
                boundary=boundary, item_id=item_id,
                fragment=fragment_of(np.asarray(value).tolist()))
        check_range(arr)
        if repairs is not None and arr.size:
            repairs.append("float_field")
        return arr.astype(dtype)
    raise ContractError(
        "mistyped_field",
        f"malformed graph payload: {what} is not numeric "
        f"(dtype {arr.dtype})",
        boundary=boundary, item_id=item_id, fragment=fragment_of(value))


def _int_scalar(value, what: str, *, boundary: str, item_id,
                repairs: Optional[List[str]] = None) -> int:
    if isinstance(value, bool):
        if repairs is not None:
            repairs.append("float_field")
        return int(value)
    if isinstance(value, float):
        if not np.isfinite(value) or value != int(value):
            raise ContractError(
                "mistyped_field",
                f"malformed graph payload: {what} is not an integer",
                boundary=boundary, item_id=item_id,
                fragment=fragment_of(value))
        if repairs is not None:
            repairs.append("float_field")
        return int(value)
    try:
        return int(value)
    except (TypeError, ValueError):
        raise ContractError(
            "mistyped_field",
            f"malformed graph payload: {what} is not an integer",
            boundary=boundary, item_id=item_id, fragment=fragment_of(value))


# ---------------------------------------------------------------------------
# The example contract (cached JSONL rows, batch_graphs inputs, serve
# admission payloads)
# ---------------------------------------------------------------------------


def validate_example(
    graph: Mapping,
    subkeys: Sequence[str],
    *,
    with_label: bool = False,
    max_nodes: Optional[int] = None,
    boundary: str = "example",
    item_id=None,
    repairs: Optional[List[str]] = None,
    stats: Optional[IngestStats] = None,
) -> Dict:
    """Validate + canonicalize one graph example; raises
    :class:`ContractError` (fatal reasons) or returns the normalized dict.

    ``with_label=False`` is the serve-admission shape (no labels exist at
    scoring time; ``vuln`` comes back zeroed), with the reference's
    400-class messages.
    ``with_label=True`` is the training/cache shape: ``vuln`` is required,
    ``label`` defaults to ``vuln.max()``, and the optional export fields
    (``df_in``/``df_out``/``project``/``node_ids``/``node_lines``) are
    validated and passed through.

    ``repairs``: optional list collecting repairable reason codes applied
    (value-preserving casts only). ``max_nodes``: oversize cap (checked
    before per-field shapes so an oversize corruption reads as
    ``oversize_graph``, not a shape mismatch).
    """
    if stats is not None:
        stats.bump(boundary, "seen")
    try:
        out = _validate_example(
            graph, subkeys, with_label=with_label, max_nodes=max_nodes,
            boundary=boundary, item_id=item_id, repairs=repairs)
    except ContractError as e:
        if stats is not None:
            stats.bump(boundary, "rejected")
            stats.bump(boundary, f"reason:{e.reason}")
        raise
    if stats is not None:
        stats.bump(boundary, "valid")
        if repairs:
            stats.bump(boundary, "repaired")
            for r in set(repairs):
                stats.bump(boundary, f"repair:{r}")
    return out


def _validate_example(graph, subkeys, *, with_label, max_nodes, boundary,
                      item_id, repairs) -> Dict:
    if not isinstance(graph, Mapping):
        raise ContractError(
            "mistyped_field",
            f"malformed graph payload: expected an object, got "
            f"{type(graph).__name__}",
            boundary=boundary, item_id=item_id, fragment=fragment_of(graph))

    def require(field):
        if field not in graph:
            # The reference's serve text: "malformed graph payload:
            # 'num_nodes'".
            raise ContractError(
                "missing_field", f"malformed graph payload: '{field}'",
                boundary=boundary, item_id=item_id,
                fragment=fragment_of(sorted(graph)))
        return graph[field]

    n = _int_scalar(require("num_nodes"), "num_nodes",
                    boundary=boundary, item_id=item_id, repairs=repairs)
    if n < 1:
        raise ContractError(
            "empty_graph", "graph needs at least one node",
            boundary=boundary, item_id=item_id,
            fragment=fragment_of({"num_nodes": n}))
    if max_nodes is not None and n > max_nodes:
        raise ContractError(
            "oversize_graph",
            f"graph has {n} nodes, over the {max_nodes}-node cap",
            boundary=boundary, item_id=item_id,
            fragment=fragment_of({"num_nodes": n}))

    senders = _int_array(require("senders"), "senders", boundary=boundary,
                         item_id=item_id, repairs=repairs)
    receivers = _int_array(require("receivers"), "receivers",
                           boundary=boundary, item_id=item_id,
                           repairs=repairs)
    if senders.shape != receivers.shape or senders.ndim != 1:
        raise ContractError(
            "edge_shape", "senders/receivers must be equal-length 1-d",
            boundary=boundary, item_id=item_id,
            fragment=fragment_of({"senders": list(senders.shape),
                                  "receivers": list(receivers.shape)}))
    if len(senders) and (int(senders.min()) < 0 or int(receivers.min()) < 0
                         or int(senders.max()) >= n
                         or int(receivers.max()) >= n):
        raise ContractError(
            "dangling_endpoint", "edge endpoint out of range",
            boundary=boundary, item_id=item_id,
            fragment=fragment_of({
                "num_nodes": n,
                "senders": [int(senders.min()), int(senders.max())]
                if len(senders) else [],
                "receivers": [int(receivers.min()), int(receivers.max())]
                if len(receivers) else [],
            }))

    raw_feats = require("feats")
    if not isinstance(raw_feats, Mapping):
        raise ContractError(
            "mistyped_field",
            "malformed graph payload: feats must be an object",
            boundary=boundary, item_id=item_id,
            fragment=fragment_of(raw_feats))
    feats: Dict[str, np.ndarray] = {}
    for key in list(subkeys) + [k for k in raw_feats if k not in subkeys]:
        if key not in raw_feats:
            raise ContractError(
                "missing_subkey", f"missing feature subkey {key!r}",
                boundary=boundary, item_id=item_id,
                fragment=fragment_of(sorted(raw_feats)))
        arr = _int_array(raw_feats[key], f"feats[{key!r}]",
                         boundary=boundary, item_id=item_id, repairs=repairs)
        if arr.shape != (n,):
            raise ContractError(
                "feat_length", f"feats[{key!r}] must have shape ({n},)",
                boundary=boundary, item_id=item_id,
                fragment=fragment_of({key: list(arr.shape)}))
        if arr.size and int(arr.min()) < 0:
            raise ContractError(
                "negative_feature", f"feats[{key!r}] has negative entries",
                boundary=boundary, item_id=item_id,
                fragment=fragment_of({key: int(arr.min())}))
        feats[key] = arr

    out: Dict = {"num_nodes": n, "senders": senders, "receivers": receivers,
                 "feats": feats}
    if "id" in graph:
        out["id"] = _int_scalar(graph["id"], "id", boundary=boundary,
                                item_id=item_id, repairs=repairs)

    if not with_label:
        out["vuln"] = np.zeros(n, np.int32)  # labels don't exist at serve
        return out

    vuln = _int_array(require("vuln"), "vuln", boundary=boundary,
                      item_id=item_id, repairs=repairs)
    if vuln.shape != (n,):
        raise ContractError(
            "feat_length", f"vuln must have shape ({n},)",
            boundary=boundary, item_id=item_id,
            fragment=fragment_of(list(vuln.shape)))
    if vuln.size and (int(vuln.min()) < 0 or int(vuln.max()) > 1):
        raise ContractError(
            "label_domain", "vuln bits must be in {0, 1}",
            boundary=boundary, item_id=item_id,
            fragment=fragment_of([int(vuln.min()), int(vuln.max())]))
    out["vuln"] = vuln

    if "label" in graph:
        label = _int_scalar(graph["label"], "label", boundary=boundary,
                            item_id=item_id, repairs=repairs)
    else:
        label = int(vuln.max(initial=0))
    if label not in (0, 1):
        raise ContractError(
            "label_domain", f"label {label} outside {{0, 1}}",
            boundary=boundary, item_id=item_id,
            fragment=fragment_of(graph.get("label")))
    out["label"] = label

    for key in ("df_in", "df_out"):
        if key in graph:
            arr = _int_array(graph[key], key, boundary=boundary,
                             item_id=item_id, repairs=repairs)
            if arr.shape != (n,):
                raise ContractError(
                    "feat_length", f"{key} must have shape ({n},)",
                    boundary=boundary, item_id=item_id,
                    fragment=fragment_of(list(arr.shape)))
            out[key] = arr
    if "node_ids" in graph:
        ids = _int_array(graph["node_ids"], "node_ids", boundary=boundary,
                         item_id=item_id, repairs=repairs, dtype=np.int64)
        if ids.shape != (n,):
            raise ContractError(
                "feat_length", f"node_ids must have shape ({n},)",
                boundary=boundary, item_id=item_id,
                fragment=fragment_of(list(ids.shape)))
        if len(np.unique(ids)) != n:
            raise ContractError(
                "duplicate_node_id", "node_ids contains duplicates",
                boundary=boundary, item_id=item_id,
                fragment=fragment_of(np.asarray(graph["node_ids"]).tolist()))
        out["node_ids"] = ids
    if "node_lines" in graph:
        lines = _int_array(graph["node_lines"], "node_lines",
                           boundary=boundary, item_id=item_id,
                           repairs=repairs)
        if lines.shape != (n,):
            raise ContractError(
                "feat_length", f"node_lines must have shape ({n},)",
                boundary=boundary, item_id=item_id,
                fragment=fragment_of(list(lines.shape)))
        out["node_lines"] = lines
    if "project" in graph:
        out["project"] = graph["project"]
    return out


# ---------------------------------------------------------------------------
# The cache-row contract (checksummed JSONL rows)
# ---------------------------------------------------------------------------


def validate_cache_row(row, *, boundary: str = "cache", item_id=None,
                       stats: Optional[IngestStats] = None) -> Dict:
    """Validate one parsed cache/JSONL row: must be an object; when it
    carries a :data:`CHECKSUM_KEY` digest, the digest must match the row's
    canonical content (bitrot detection). Returns the row WITHOUT the
    digest key."""
    if stats is not None:
        stats.bump(boundary, "seen")
    try:
        if not isinstance(row, Mapping):
            raise ContractError(
                "mistyped_field",
                f"cache row is {type(row).__name__}, expected an object",
                boundary=boundary, item_id=item_id, fragment=fragment_of(row))
        if CHECKSUM_KEY in row:
            want = row[CHECKSUM_KEY]
            got = row_checksum(row)
            if got != want:
                raise ContractError(
                    "checksum_mismatch",
                    f"cache row digest {got[:12]} != recorded "
                    f"{str(want)[:12]}",
                    boundary=boundary, item_id=item_id,
                    fragment=fragment_of(
                        {k: row[k] for k in list(row)[:4]}))
            row = {k: v for k, v in row.items() if k != CHECKSUM_KEY}
    except ContractError as e:
        if stats is not None:
            stats.bump(boundary, "rejected")
            stats.bump(boundary, f"reason:{e.reason}")
        raise
    if stats is not None:
        stats.bump(boundary, "valid")
    return dict(row)
