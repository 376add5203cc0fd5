"""Content-hash result cache (port of ``deepdfa_tpu/serve/cache.py``).

Keys hash the model inputs only — graph structure and features, plus the
source text on the combined lane — so two submissions of the same
function share a cache line whoever sends them. The digest is the
reference's, byte for byte.
"""

from __future__ import annotations

import collections
import hashlib
import threading
from typing import Dict, Mapping, Optional

import numpy as np


def content_hash(graph: Mapping, code: Optional[str] = None) -> str:
    """Stable digest of a scoring request's model inputs (arrays
    canonicalized to int64 little-endian bytes, so the caller's dtypes do
    not matter). ``code`` joins only when it is scored (the combined
    lane): a degraded or graph-only request shares the graph's line."""
    h = hashlib.blake2b(digest_size=16)
    h.update(int(graph["num_nodes"]).to_bytes(8, "little"))
    for key in ("senders", "receivers"):
        arr = np.ascontiguousarray(np.asarray(graph[key], np.int64))
        h.update(arr.tobytes())
    for name in sorted(graph["feats"]):
        h.update(name.encode())
        arr = np.ascontiguousarray(np.asarray(graph["feats"][name], np.int64))
        h.update(arr.tobytes())
    if code is not None:
        h.update(b"\x00code\x00")
        h.update(str(code).encode("utf-8", "replace"))
    return h.hexdigest()


class ResultCache:
    """Thread-safe LRU of ``content_hash -> result dict``; capacity <= 0
    disables it."""

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._entries: "collections.OrderedDict[str, Dict]" = (
            collections.OrderedDict())
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, key: str) -> Optional[Dict]:
        with self._lock:
            value = self._entries.get(key)
            if value is not None:
                self._entries.move_to_end(key)
            return value

    def put(self, key: str, value: Dict) -> None:
        if self.capacity <= 0:
            return
        with self._lock:
            self._entries[key] = value
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
