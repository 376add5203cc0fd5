"""``cli validate``'s engine (port of ``validate_corpus`` from
``deepdfa_tpu/contracts/gauntlet.py``).

The reference's corrupt-corpus fuzzer (``poison_corpus``, ``smoke``,
``cli validate --smoke``) is not ported yet; the tests run the JAX
package's fuzzer against the port's loader.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Sequence

from deepdfa_tpu_torch.contracts.ingest import load_examples_jsonl
from deepdfa_tpu_torch.contracts.quarantine import (
    DIRNAME as QUARANTINE_DIRNAME,
    Quarantine,
)
from deepdfa_tpu_torch.core.config import ALL_SUBKEYS


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
