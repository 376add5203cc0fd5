"""The example contract at serve admission (port of the
``validate_example`` subset of ``deepdfa_tpu/contracts/schema.py`` that
``ServeEngine`` uses).

Same reason codes and the same 400-class messages as the reference, so a
malformed payload reads the same from both engines. Only the
``with_label=False`` (scoring) shape is ported; labelled training rows
and the Joern export contracts are not ported yet.
"""

from __future__ import annotations

import json
from typing import Dict, Mapping, Optional, Sequence

import numpy as np

#: The reference's reason codes that serve admission and batching raise
#: (all fatal: the item is rejected).
REASONS = frozenset({
    "mistyped_field", "missing_field", "missing_subkey", "empty_graph",
    "edge_shape", "dangling_endpoint", "feat_length", "negative_feature",
    "nan_feature",
})


class ContractError(ValueError):
    """A fatal data-contract violation at an ingestion boundary."""

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
    """Bounded repr of the offending data."""
    try:
        text = json.dumps(value, default=repr)
    except (TypeError, ValueError):
        text = repr(value)
    return text if len(text) <= limit else text[: limit - 1] + "…"


def _int_array(value, what: str, *, boundary: str) -> np.ndarray:
    """Coerce one per-node/per-edge field to an int array (integral
    floats and bools cast back exactly; anything else non-integer is
    fatal)."""
    try:
        arr = np.asarray(value)
    except (TypeError, ValueError) as e:
        raise ContractError(
            "mistyped_field", f"malformed graph payload: {what}: {e}",
            boundary=boundary, fragment=fragment_of(value))

    dtype = np.int32

    def check_range(a):
        info = np.iinfo(dtype)
        if a.size and (int(a.min()) < info.min or int(a.max()) > info.max):
            raise ContractError(
                "mistyped_field",
                f"malformed graph payload: {what} exceeds the "
                f"{np.dtype(dtype).name} range",
                boundary=boundary,
                fragment=fragment_of([int(a.min()), int(a.max())]))

    kind = arr.dtype.kind
    if kind in "iu":
        if arr.dtype == dtype:
            return arr
        check_range(arr)
        return arr.astype(dtype)
    if kind == "b":
        return arr.astype(dtype)
    if kind == "f":
        if not np.all(np.isfinite(arr)):
            raise ContractError(
                "nan_feature", f"{what} has non-finite entries",
                boundary=boundary,
                fragment=fragment_of(np.asarray(value).tolist()))
        if arr.size and not np.array_equal(arr, np.trunc(arr)):
            raise ContractError(
                "mistyped_field",
                f"malformed graph payload: {what} has non-integral values",
                boundary=boundary,
                fragment=fragment_of(np.asarray(value).tolist()))
        check_range(arr)
        return arr.astype(dtype)
    raise ContractError(
        "mistyped_field",
        f"malformed graph payload: {what} is not numeric "
        f"(dtype {arr.dtype})",
        boundary=boundary, fragment=fragment_of(value))


def _int_scalar(value, what: str, *, boundary: str) -> int:
    if isinstance(value, bool):
        return int(value)
    if isinstance(value, float):
        if not np.isfinite(value) or value != int(value):
            raise ContractError(
                "mistyped_field",
                f"malformed graph payload: {what} is not an integer",
                boundary=boundary, fragment=fragment_of(value))
        return int(value)
    try:
        return int(value)
    except (TypeError, ValueError):
        raise ContractError(
            "mistyped_field",
            f"malformed graph payload: {what} is not an integer",
            boundary=boundary, fragment=fragment_of(value))


def validate_example(graph: Mapping, subkeys: Sequence[str], *,
                     boundary: str = "example") -> Dict:
    """Validate + canonicalize one scoring graph; raises
    :class:`ContractError` or returns the normalized dict (``vuln``
    zeroed: labels do not exist at scoring time)."""
    if not isinstance(graph, Mapping):
        raise ContractError(
            "mistyped_field",
            f"malformed graph payload: expected an object, got "
            f"{type(graph).__name__}",
            boundary=boundary, fragment=fragment_of(graph))

    def require(field):
        if field not in graph:
            raise ContractError(
                "missing_field", f"malformed graph payload: '{field}'",
                boundary=boundary,
                fragment=fragment_of(sorted(graph)))
        return graph[field]

    n = _int_scalar(require("num_nodes"), "num_nodes", boundary=boundary)
    if n < 1:
        raise ContractError(
            "empty_graph", "graph needs at least one node",
            boundary=boundary,
            fragment=fragment_of({"num_nodes": n}))

    senders = _int_array(require("senders"), "senders", boundary=boundary)
    receivers = _int_array(require("receivers"), "receivers",
                           boundary=boundary)
    if senders.shape != receivers.shape or senders.ndim != 1:
        raise ContractError(
            "edge_shape", "senders/receivers must be equal-length 1-d",
            boundary=boundary,
            fragment=fragment_of({"senders": list(senders.shape),
                                  "receivers": list(receivers.shape)}))
    if len(senders) and (int(senders.min()) < 0 or int(receivers.min()) < 0
                         or int(senders.max()) >= n
                         or int(receivers.max()) >= n):
        raise ContractError(
            "dangling_endpoint", "edge endpoint out of range",
            boundary=boundary,
            fragment=fragment_of({
                "num_nodes": n,
                "senders": [int(senders.min()), int(senders.max())],
                "receivers": [int(receivers.min()), int(receivers.max())],
            }))

    raw_feats = require("feats")
    if not isinstance(raw_feats, Mapping):
        raise ContractError(
            "mistyped_field",
            "malformed graph payload: feats must be an object",
            boundary=boundary,
            fragment=fragment_of(raw_feats))
    feats: Dict[str, np.ndarray] = {}
    for key in list(subkeys) + [k for k in raw_feats if k not in subkeys]:
        if key not in raw_feats:
            raise ContractError(
                "missing_subkey", f"missing feature subkey {key!r}",
                boundary=boundary,
                fragment=fragment_of(sorted(raw_feats)))
        arr = _int_array(raw_feats[key], f"feats[{key!r}]",
                         boundary=boundary)
        if arr.shape != (n,):
            raise ContractError(
                "feat_length", f"feats[{key!r}] must have shape ({n},)",
                boundary=boundary,
                fragment=fragment_of({key: list(arr.shape)}))
        if arr.size and int(arr.min()) < 0:
            raise ContractError(
                "negative_feature", f"feats[{key!r}] has negative entries",
                boundary=boundary,
                fragment=fragment_of({key: int(arr.min())}))
        feats[key] = arr

    out: Dict = {"num_nodes": n, "senders": senders, "receivers": receivers,
                 "feats": feats}
    if "id" in graph:
        out["id"] = _int_scalar(graph["id"], "id", boundary=boundary)
    out["vuln"] = np.zeros(n, np.int32)
    return out
