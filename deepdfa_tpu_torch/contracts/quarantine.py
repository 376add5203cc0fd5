"""Fail-closed quarantine sink for contract-violating items (port of
``deepdfa_tpu/contracts/quarantine.py``).

Bad items never reach the model and never abort the corpus: each one is
recorded under ``<cache>/quarantine/`` with

- ``manifest.jsonl`` — one line per quarantined item: ``{"item_id",
  "boundary", "reason", "fragment", "ordinal"}`` (ordinal = quarantine
  order, so a manifest diff is stable across runs of the same corpus);
- ``items.jsonl`` — the raw offending payload (the JSONL line as read, or
  a JSON dump of the structured item) for post-mortem repair.

Writes are append-only line writes: a crash mid-quarantine loses at most
one line, and two processes quarantining into the same directory
interleave whole lines. Each item is also a ``quarantine`` telemetry
event (a no-op without an active run), as in the reference.
"""

from __future__ import annotations

import collections
import json
import os
import threading
from pathlib import Path
from typing import Dict, List

from deepdfa_tpu_torch import telemetry
from deepdfa_tpu_torch.contracts.schema import ContractError, fragment_of

MANIFEST_NAME = "manifest.jsonl"
ITEMS_NAME = "items.jsonl"
DIRNAME = "quarantine"


def quarantine_dir(cache_path: str | Path) -> Path:
    """The quarantine root for a cache file or directory: the
    ``quarantine/`` sibling of a file, or child of a directory."""
    p = Path(cache_path)
    root = p if p.is_dir() else p.parent
    return root / DIRNAME


class Quarantine:
    """Append-only quarantine sink rooted at one directory."""

    def __init__(self, root: str | Path):
        self.root = Path(root)
        self.counts: collections.Counter = collections.Counter()
        self._ordinal = 0
        # One sink may be fed from several threads; ordinal assignment
        # and the two appends stay one atom, or the manifest<->items
        # ordinal join breaks.
        self._lock = threading.Lock()

    @property
    def manifest_path(self) -> Path:
        return self.root / MANIFEST_NAME

    @property
    def items_path(self) -> Path:
        return self.root / ITEMS_NAME

    def put(self, error: ContractError, raw=None) -> None:
        """Record one violation. ``raw``: the offending payload as read
        (a JSONL line string or a structured item); defaults to the
        error's own fragment."""
        with self._lock:
            self.root.mkdir(parents=True, exist_ok=True)
            entry = {
                "ordinal": self._ordinal,
                "item_id": error.item_id,
                "boundary": error.boundary,
                "reason": error.reason,
                "message": str(error),
                "fragment": error.fragment,
            }
            with open(self.manifest_path, "a", encoding="utf-8") as f:
                f.write(json.dumps(entry) + "\n")
            with open(self.items_path, "a", encoding="utf-8") as f:
                f.write(json.dumps({
                    "ordinal": self._ordinal,
                    "item_id": error.item_id,
                    "raw": raw if isinstance(raw, str) else fragment_of(
                        raw if raw is not None else error.fragment,
                        limit=4096),
                }) + "\n")
            self._ordinal += 1
            self.counts[error.reason] += 1
        telemetry.event("quarantine", boundary=error.boundary,
                        reason=error.reason, item_id=error.item_id)

    @property
    def total(self) -> int:
        return sum(self.counts.values())

    def report(self) -> Dict:
        return {"quarantined": self.total,
                "by_reason": dict(sorted(self.counts.items())),
                "dir": str(self.root)}


def read_manifest(root: str | Path) -> List[Dict]:
    """All manifest entries under a quarantine root (empty when none)."""
    path = Path(root) / MANIFEST_NAME if Path(root).name != MANIFEST_NAME \
        else Path(root)
    if not path.exists():
        return []
    out: List[Dict] = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def clear(root: str | Path) -> None:
    """Remove a quarantine directory's record files (a fresh-run
    reset)."""
    for name in (MANIFEST_NAME, ITEMS_NAME):
        p = Path(root) / name
        if p.exists():
            os.remove(p)
