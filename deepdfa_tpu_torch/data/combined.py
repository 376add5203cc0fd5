"""Data for the combined DeepDFA+LineVul model (port of
``deepdfa_tpu/data/combined.py``, its synthetic sources).

The combined model trains on text and graphs joined by example id. Here
both come from ``synthetic[:N]``: generated graphs (ids 0..N-1) and
C-like functions rendered from them. The reference's other sources (the
dbize cache, etl ``.jsonl`` exports and the MSR CSVs) wait until the
port reads those files.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

from deepdfa_tpu_torch.core.config import FeatureSpec
from deepdfa_tpu_torch.graphs.batch import pad_budget_for


def load_graph_source(spec: str, feature: FeatureSpec,
                      seed: int = 0) -> List[Dict]:
    """Graph examples from ``synthetic[:N]``, labelled and numbered as the
    reference's ``load_graph_source`` and ``cli.load_dataset`` do (``cli
    fit``, ``score`` and ``fit-text`` all read them here)."""
    from deepdfa_tpu_torch.data.synthetic import synthetic_bigvul

    if not spec.startswith("synthetic"):
        raise ValueError(f"unknown dataset {spec!r} (the port reads "
                         "synthetic[:N] only; the JSONL loader is not "
                         "ported)")
    n = int(spec.split(":")[1]) if ":" in spec else 256
    examples = synthetic_bigvul(n, feature, positive_fraction=0.5, seed=seed)
    for i, ex in enumerate(examples):
        ex["label"] = int(np.asarray(ex["vuln"]).max())
        ex["id"] = i
    return examples


def graph_join_and_budget(
    gexamples: List[Dict], batch_size: int,
    max_nodes: Optional[int] = None, max_edges: Optional[int] = None,
) -> Tuple[Dict[int, Dict], Dict[str, int]]:
    """(graphs_by_id, per-batch node/edge budget) for the combined join:
    twice the order-preserving ``pad_budget_for`` bound (shuffling
    regroups batches each epoch), unless both are given."""
    graphs_by_id = {int(g["id"]): g for g in gexamples}
    if max_nodes and max_edges:
        return graphs_by_id, {"max_nodes": max_nodes, "max_edges": max_edges}
    ordered = [graphs_by_id[k] for k in sorted(graphs_by_id)]
    b = pad_budget_for(ordered, batch_size)
    return graphs_by_id, {
        "max_nodes": max_nodes or 2 * b["max_nodes"],
        "max_edges": max_edges or 2 * b["max_edges"],
    }


def load_combined_dataset(
    dataset: str, feature: FeatureSpec, tokenizer, block_size: int,
    graphs: Optional[str] = None, seed: int = 0,
) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray],
           Optional[Mapping[int, Mapping]]]:
    """(data, splits, graphs_by_id) for ``fit_text`` from
    ``synthetic[:N]`` text, joined with its own synthetic graphs when
    ``graphs`` is given (None: text only); split 80/10/10 at random
    from ``seed``."""
    from deepdfa_tpu_torch.data.splits import make_splits
    from deepdfa_tpu_torch.data.text import attach_synthetic_text, encode_dataset

    if not dataset.startswith("synthetic"):
        raise ValueError(f"unknown dataset {dataset!r} (the port reads "
                         "synthetic[:N] only; the MSR CSVs are not ported)")
    if graphs is not None and not graphs.startswith("synthetic"):
        # Synthetic text is rendered from the generated graphs; a foreign
        # graph cache would join on unrelated ids.
        raise ValueError("synthetic text pairs only with its own synthetic "
                         "graphs (pass --graphs synthetic or drop it)")
    gexamples = load_graph_source(dataset, feature, seed=seed)
    graphs_by_id = None
    if graphs is not None:
        graphs_by_id = {int(g["id"]): g for g in gexamples}
    rows = attach_synthetic_text([dict(g) for g in gexamples], seed=seed)
    splits = make_splits(rows, mode="random", seed=seed)
    data = encode_dataset(rows, tokenizer, block_size=block_size)
    return data, splits, graphs_by_id
