"""Data for the combined DeepDFA+LineVul and DeepDFA+CodeT5 models (port of
``deepdfa_tpu/data/combined.py``).

The combined model trains on text and graphs joined by example id.

Graph sources (``load_graph_source``):
  - ``synthetic[:N]``          generated sample graphs (ids 0..N-1)
  - ``<dir with nodes.csv>``   the reference pipeline's dbize cache
                               (``etl/legacy_cache.py``; a directory
                               holding only ``nodes_sample.csv`` reads
                               the sample files)
  - ``<file.jsonl>``           the ETL's export format, read through the
                               validated loader (``contracts/ingest.py``)

Text sources (``load_combined_dataset``):
  - ``synthetic[:N]``          C-like functions rendered from the graphs
  - ``<dir with train.csv>``   train/val/test CSVs in the MSR layout,
                               read with the standard library's ``csv``;
                               the CSV partition is the fixed split
"""

from __future__ import annotations

import csv
import os
import sys
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

from deepdfa_tpu_torch.core.config import ALL_SUBKEYS, FeatureSpec, subkeys_for
from deepdfa_tpu_torch.graphs.batch import pad_budget_for

# Text that pandas' ``read_csv`` reads as NaN by default; the reference
# then encodes the code cell as ``str(nan)``, "nan".
_PANDAS_NA = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"})


def read_examples_jsonl(path: str,
                        feature: Optional[FeatureSpec] = None) -> List[Dict]:
    """Graph examples in the ETL export format (one JSON object per line
    with num_nodes/senders/receivers/vuln/feats[/label/id]), read
    through the validated loader: rows that break the contract go to
    the corpus's ``quarantine/`` sibling and are skipped. The required
    subkeys come from ``feature`` (a single-subkey export must not be
    quarantined for lacking the other three)."""
    from deepdfa_tpu_torch.contracts import load_examples_jsonl

    subkeys = subkeys_for(feature) if feature is not None else ALL_SUBKEYS
    examples, _ = load_examples_jsonl(path, subkeys)
    return examples


def load_graph_source(spec: str, feature: FeatureSpec,
                      seed: int = 0) -> List[Dict]:
    """Graph examples from a spec string (see the module docstring);
    synthetic graphs labelled and numbered as the reference's
    ``load_graph_source`` and ``cli.load_dataset`` do."""
    if spec.startswith("synthetic"):
        from deepdfa_tpu_torch.data.synthetic import synthetic_bigvul

        n = int(spec.split(":")[1]) if ":" in spec else 256
        examples = synthetic_bigvul(n, feature, positive_fraction=0.5,
                                    seed=seed)
        for i, ex in enumerate(examples):
            ex["label"] = int(np.asarray(ex["vuln"]).max())
            ex["id"] = i
        return examples
    if spec.endswith(".jsonl") and os.path.exists(spec):
        return read_examples_jsonl(spec, feature)
    if os.path.isdir(spec) and (
            os.path.exists(os.path.join(spec, "nodes.csv"))
            or os.path.exists(os.path.join(spec, "nodes_sample.csv"))):
        from deepdfa_tpu_torch.etl.legacy_cache import load_reference_cache

        sample = not os.path.exists(os.path.join(spec, "nodes.csv"))
        return load_reference_cache(spec, feature, sample=sample)
    raise ValueError(
        f"unknown graph source {spec!r} (want synthetic[:N], an etl export "
        ".jsonl, or a dbize cache directory holding nodes.csv)")


def _csv_int(text: str, what: str, path: str) -> int:
    """An int cell as pandas reads one and ``astype(int)`` casts it:
    "1" and "1.0" are 1."""
    try:
        return int(text)
    except ValueError:
        try:
            return int(float(text))
        except ValueError:
            raise ValueError(f"{path}: {what} {text!r} is not a number")


def _read_csv_rows(path: str) -> Tuple[List[str], List[List[str]]]:
    """(header, rows) of one CSV: quoted fields may hold quotes, commas
    and newlines, and a field may be of any length (Big-Vul's longest
    functions pass the ``csv`` module's default 131,072-character
    limit). Blank lines are skipped, as pandas skips them."""
    limit = csv.field_size_limit()
    csv.field_size_limit(min(sys.maxsize, 2 ** 31 - 1))
    try:
        with open(path, newline="", encoding="utf-8-sig") as f:
            reader = csv.reader(f)
            header = next(reader, None)
            rows = [r for r in reader if r]
    finally:
        csv.field_size_limit(limit)
    if header is None:
        raise ValueError(f"{path}: empty CSV")
    for i, r in enumerate(rows):
        if len(r) != len(header):
            raise ValueError(f"{path}: row {i + 1} has {len(r)} fields, the "
                             f"header {len(header)}")
    return header, rows


def _read_text_csvs(data_dir: str
                    ) -> Tuple[List[Dict], Dict[str, List[int]]]:
    """MSR-layout train/val/test CSVs -> (rows, positions per split).

    As the reference (pandas ``read_csv(index_col=0)``): the example id
    is the first column, the code ``processed_func`` falling back to
    ``func``, the label ``target`` as an int; ``test.csv`` is optional.
    """
    rows: List[Dict] = []
    split_pos: Dict[str, List[int]] = {}
    for split, name in (("train", "train.csv"), ("val", "val.csv"),
                        ("test", "test.csv")):
        path = os.path.join(data_dir, name)
        if not os.path.exists(path):
            if split == "test":  # test.csv optional: fit-only directories
                split_pos[split] = []
                continue
            raise FileNotFoundError(f"{path} (MSR layout needs {name})")
        header, table = _read_csv_rows(path)
        columns = header[1:]
        func_key = ("processed_func" if "processed_func" in columns
                    else "func")
        code_at = 1 + columns.index(func_key)
        target_at = 1 + columns.index("target")
        pos = []
        for r in table:
            code = r[code_at]
            pos.append(len(rows))
            rows.append({"code": "nan" if code in _PANDAS_NA else code,
                         "label": _csv_int(r[target_at], "target", path),
                         "id": _csv_int(r[0], "id", path)})
        split_pos[split] = pos
    return rows, split_pos


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
    style: str = "roberta", graphs: Optional[str] = None, seed: int = 0,
    split_mode: str = "random",
) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray],
           Optional[Mapping[int, Mapping]]]:
    """(data, splits, graphs_by_id) for ``fit_text``.

    ``dataset``: ``synthetic[:N]`` (text rendered from generated graphs,
    split by ``split_mode`` from ``seed``) or a directory of MSR CSVs
    (their partition is the split), encoded in ``style`` ("roberta" for
    LineVul, "t5" for CodeT5). ``graphs``: a graph source spec
    joined by id (None: text only); synthetic text joins only its own
    synthetic graphs, and the CSVs only a graph cache of their ids.
    """
    from deepdfa_tpu_torch.data.splits import make_splits
    from deepdfa_tpu_torch.data.text import attach_synthetic_text, encode_dataset

    graphs_by_id = None
    if dataset.startswith("synthetic"):
        if graphs is not None and not graphs.startswith("synthetic"):
            # Synthetic text is rendered from the generated graphs; a
            # foreign graph cache would join on unrelated ids.
            raise ValueError(
                "synthetic text pairs only with its own synthetic graphs "
                "(pass --graphs synthetic or drop it)")
        gexamples = load_graph_source(dataset, feature, seed=seed)
        if graphs is not None:
            graphs_by_id = {int(g["id"]): g for g in gexamples}
        rows = attach_synthetic_text([dict(g) for g in gexamples], seed=seed)
        splits = make_splits(rows, mode=split_mode, seed=seed)
        data = encode_dataset(rows, tokenizer, block_size=block_size,
                              style=style)
        return data, splits, graphs_by_id
    if os.path.isdir(dataset):
        if graphs is not None and graphs.startswith("synthetic"):
            # Positional synthetic ids (0..N-1) against the CSVs' own ids:
            # rows would join unrelated graphs or none.
            raise ValueError(
                "a CSV dataset needs its own graph cache (dbize dir or etl "
                ".jsonl); synthetic graphs join by positional id only")
        rows, split_pos = _read_text_csvs(dataset)
        data = encode_dataset(rows, tokenizer, block_size=block_size,
                              style=style)
        splits = {k: np.asarray(v, np.int64) for k, v in split_pos.items()}
        if graphs is not None:
            gexamples = load_graph_source(graphs, feature, seed=seed)
            graphs_by_id = {int(g["id"]): g for g in gexamples}
        return data, splits, graphs_by_id
    raise ValueError(
        f"unknown dataset {dataset!r} (want synthetic[:N] or a directory "
        "holding train.csv/val.csv[/test.csv])")
