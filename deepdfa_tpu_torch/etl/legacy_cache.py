"""Loader for the reference pipeline's dbize cache (port of
``deepdfa_tpu/etl/legacy_cache.py``).

The dbize stage writes ``nodes[_sample].csv`` (per-node rows with
``graph_id``/``dgl_id``/``node_id``/``vuln``), ``edges[_sample].csv``
(``graph_id``/``innode``/``outnode``) and one
``nodes_feat_<feature>_<split>[_sample].csv`` per abstract-dataflow
subkey (the vocabulary index of each ``(graph_id, node_id)``). This
module reads those CSVs with the standard library's ``csv`` (the
reference reads them with pandas) into the example dicts
``graphs/batch.py`` consumes.

Pandas' rules are kept where they change a value: the first column is
the index (``index_col=0``) and names no field; a column of whole
numbers is int64, one with a fraction or an empty or NA cell float64
(NaN); rows without a ``graph_id`` join no graph.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from deepdfa_tpu_torch.core.config import ALL_SUBKEYS, FeatureSpec


def _feat_path(processed_dir: str, feature: FeatureSpec, subkey: str,
               split: str, sample: bool) -> str:
    name = (f"_ABS_DATAFLOW_{subkey}_all"
            f"_limitall_{feature.limit_all}"
            f"_limitsubkeys_{feature.limit_subkeys}")
    sample_text = "_sample" if sample else ""
    return os.path.join(processed_dir,
                        f"nodes_feat_{name}_{split}{sample_text}.csv")


class _Table:
    """One CSV read as pandas' ``read_csv(path, index_col=0)`` reads it:
    the columns after the index, each a numeric numpy array on demand."""

    def __init__(self, path: str):
        from deepdfa_tpu_torch.data.combined import _read_csv_rows

        self.path = path
        header, self._rows = _read_csv_rows(path)
        self.columns = header[1:]

    def __getitem__(self, name: str) -> np.ndarray:
        if name not in self.columns:
            raise KeyError(f"{self.path}: no column {name!r}")
        from deepdfa_tpu_torch.data.combined import _PANDAS_NA

        at = 1 + self.columns.index(name)
        values: List[float] = []
        fraction = False
        for row in self._rows:
            cell = row[at]
            if cell in _PANDAS_NA:
                values.append(math.nan)
                fraction = True
                continue
            try:
                values.append(int(cell))
            except ValueError:
                try:
                    values.append(float(cell))
                except ValueError:
                    raise ValueError(f"{self.path}: column {name!r} holds "
                                     f"{cell!r}, not a number")
                fraction = True
        return np.asarray(values, np.float64 if fraction else np.int64)


def _groups(keys: np.ndarray, *within: np.ndarray
            ) -> Tuple[np.ndarray, Dict[object, slice]]:
    """(row order, key -> its slice of that order): rows grouped by key
    ascending (NaN keys dropped, as ``groupby`` drops them), each group
    in ``within`` order (``np.lexsort``'s, stable), else file order."""
    rows = np.flatnonzero(~np.isnan(keys)) if keys.dtype.kind == "f" \
        else np.arange(len(keys))
    sort_keys = tuple(w[rows] for w in reversed(within)) + (keys[rows],)
    order = rows[np.lexsort(sort_keys)]
    sorted_keys = keys[order]
    uniq, starts = np.unique(sorted_keys, return_index=True)
    ends = list(starts[1:]) + [len(order)]
    return order, {k: slice(int(s), int(e))
                   for k, s, e in zip(uniq.tolist(), starts, ends)}


def load_reference_cache(
    processed_dir: str,
    feature: Optional[FeatureSpec] = None,
    split: str = "fixed",
    sample: bool = False,
    labels_by_id: Optional[Dict[int, int]] = None,
) -> List[Dict]:
    """Read nodes/edges/nodes_feat CSVs into example dicts, one a graph
    in ascending ``graph_id`` order.

    Node order within a graph is ``dgl_id`` (the dense ids of the
    reference's ``graphs.bin``); a node without a feature row reads 0;
    the graph label is the max node ``vuln`` unless ``labels_by_id``
    gives it.
    """
    feature = feature or FeatureSpec()
    sample_text = "_sample" if sample else ""
    nodes = _Table(os.path.join(processed_dir, f"nodes{sample_text}.csv"))
    edges = _Table(os.path.join(processed_dir, f"edges{sample_text}.csv"))

    subkeys = ALL_SUBKEYS if feature.concat_all else (feature.subkey,)
    tables = {}
    for subkey in subkeys:
        path = _feat_path(processed_dir, feature, subkey, split, sample)
        fdf = _Table(path)
        feat_col = [c for c in fdf.columns if c.startswith("_ABS_DATAFLOW")]
        if len(feat_col) != 1:
            raise ValueError(
                f"{path} has no unique feature column: {list(fdf.columns)}")
        tables[subkey] = dict(zip(
            zip(fdf["graph_id"].tolist(), fdf["node_id"].tolist()),
            fdf[feat_col[0]].tolist()))

    n_graph, n_dgl = nodes["graph_id"], nodes["dgl_id"]
    n_node, n_vuln = nodes["node_id"], nodes["vuln"]
    order, node_groups = _groups(n_graph, n_dgl)
    e_graph = edges["graph_id"]
    e_order, edge_groups = _groups(e_graph)
    innode, outnode = edges["innode"], edges["outnode"]

    out: List[Dict] = []
    for graph_id, part in node_groups.items():
        rows = order[part]
        dgl_ids = n_dgl[rows]
        num_nodes = int(dgl_ids.max()) + 1
        vuln = np.zeros(num_nodes, np.int32)
        vuln[dgl_ids] = n_vuln[rows]

        epart = edge_groups.get(graph_id)
        if epart is not None:
            erows = e_order[epart]
            senders = innode[erows].astype(np.int32)
            receivers = outnode[erows].astype(np.int32)
        else:
            senders = np.zeros(0, np.int32)
            receivers = np.zeros(0, np.int32)

        feats = {}
        node_ids = n_node[rows].tolist()
        for subkey in subkeys:
            table = tables[subkey]
            vals = np.zeros(num_nodes, np.int64)
            for nid, did in zip(node_ids, dgl_ids):
                vals[did] = int(table.get((graph_id, nid), 0))
            feats[subkey] = vals

        gid = int(graph_id)
        out.append({
            "id": gid,
            "num_nodes": num_nodes,
            "senders": senders,
            "receivers": receivers,
            "vuln": vuln,
            "feats": feats,
            "label": (labels_by_id[gid]
                      if labels_by_id is not None and gid in labels_by_id
                      else int(vuln.max(initial=0))),
        })
    return out
