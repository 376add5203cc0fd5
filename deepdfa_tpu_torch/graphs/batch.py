"""Static-shape graph batching (port of ``deepdfa_tpu/graphs/batch.py``).

A batch is a fixed budget of ``n_graphs`` graph slots, ``max_nodes``
node slots and ``max_edges`` edge slots; real entries are marked by
masks and padding is inert under the masked ops. Budgets round up a
power-of-two ladder so traffic sees a handful of shapes.

Only the python packing path is ported, with the greedy
:func:`batch_iterator`; the reference's C++ batcher
(``native.fill_batch``) and dense-slot packing (``slot_nodes``) are not
ported yet.
Batches are built on the host as CPU tensors; ``GraphBatch.to`` moves
them to the device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from deepdfa_tpu_torch.contracts.schema import ContractError
from deepdfa_tpu_torch.graphs.segment import segment_max
from deepdfa_tpu_torch.ops.band_spmm import BandAdjacency, build_band_adjacency
from deepdfa_tpu_torch.ops.tile_spmm import (
    DEFAULT_TILE,
    CsrAdjacency,
    build_csr_adjacency,
)


@dataclasses.dataclass
class GraphBatch:
    """A padded batch of graphs.

    node_feats  : dict subkey -> int32[max_nodes] abstract-dataflow indices
    node_vuln   : int32[max_nodes]
    senders     : int32[max_edges] source node slot of each edge
    receivers   : int32[max_edges] destination node slot of each edge
    node_graph  : int32[max_nodes] graph slot each node belongs to
    node_mask   : bool[max_nodes]
    edge_mask   : bool[max_edges]
    graph_mask  : bool[n_graphs]
    graph_ids   : int32[n_graphs] example ids, -1 for empty slots
    band_adj    : optional block-banded adjacency (message_impl band,
                  fused, persistent)
    tile_adj    : optional nonzero lists of A and A^T (message_impl tile;
                  ``ops.tile_spmm.tile_layout`` gives the reference's
                  dense tiles of them)
    """

    node_feats: Dict[str, torch.Tensor]
    node_vuln: torch.Tensor
    senders: torch.Tensor
    receivers: torch.Tensor
    node_graph: torch.Tensor
    node_mask: torch.Tensor
    edge_mask: torch.Tensor
    graph_mask: torch.Tensor
    graph_ids: torch.Tensor
    band_adj: Optional[BandAdjacency] = None
    tile_adj: Optional[CsrAdjacency] = None

    @property
    def n_graphs(self) -> int:
        return self.graph_mask.shape[0]

    @property
    def max_nodes(self) -> int:
        return self.node_mask.shape[0]

    @property
    def max_edges(self) -> int:
        return self.edge_mask.shape[0]

    def to(self, device: Union[str, torch.device]) -> "GraphBatch":
        moved = {f.name: getattr(self, f.name)
                 for f in dataclasses.fields(self)}
        for name, value in moved.items():
            if isinstance(value, torch.Tensor):
                moved[name] = value.to(device)
        moved["node_feats"] = {k: v.to(device)
                               for k, v in self.node_feats.items()}
        for name in ("band_adj", "tile_adj"):
            if moved[name] is not None:
                moved[name] = moved[name].to(device)
        return GraphBatch(**moved)


def graph_label_from_nodes(batch: GraphBatch) -> torch.Tensor:
    """Graph-level label = max node ``vuln`` over the graph's real nodes
    (the reference's segment form); an empty slot gets 0."""
    vuln = torch.where(batch.node_mask, batch.node_vuln.float(), -torch.inf)
    out = segment_max(vuln, batch.node_graph, batch.n_graphs)
    return torch.where(torch.isneginf(out), 0.0, out)


# Bucket ladder top for padding budgets: beyond it, sizes stay exact.
_BUCKET_TOP = 2 ** 21


def select_bucket(n: int, maximum: Optional[int] = None,
                  minimum: int = 16) -> int:
    """Round ``n`` up the power-of-two ladder from ``minimum``, capped at
    ``maximum``; beyond the cap or the ladder top ``n`` comes back
    unrounded so callers fail on their budget checks."""
    n = max(int(n), 1)
    if maximum is not None and n >= maximum:
        return max(n, maximum)
    if n > _BUCKET_TOP:
        return n
    b = minimum
    while b < n:
        b *= 2
    return b if maximum is None else min(b, maximum)


def pad_budget_for(graphs: Sequence[Mapping], n_graphs: int,
                   add_self_loops: bool = True) -> Dict[str, int]:
    """Bucketed node/edge budgets covering every graph in ``graphs``
    when packed ``n_graphs`` at a time (greedy, order-preserving)."""
    max_nodes = 0
    max_edges = 0
    for start in range(0, len(graphs), n_graphs):
        chunk = graphs[start: start + n_graphs]
        nodes = sum(int(g["num_nodes"]) for g in chunk)
        edges = sum(len(g["senders"]) for g in chunk)
        if add_self_loops:
            edges += nodes
        max_nodes = max(max_nodes, nodes)
        max_edges = max(max_edges, edges)
    return {
        "n_graphs": n_graphs,
        "max_nodes": select_bucket(max(max_nodes, 1)),
        "max_edges": select_bucket(max(max_edges, 1)),
    }


def batch_graphs(
    graphs: Sequence[Mapping],
    n_graphs: int,
    max_nodes: int,
    max_edges: int,
    subkeys: Sequence[str],
    add_self_loops: bool = True,
    tile: Optional[int] = None,
    build_band_adj: bool = False,
    band_bandwidth: Optional[int] = None,
    build_tile_adj: bool = False,
) -> GraphBatch:
    """Pack up to ``n_graphs`` graphs into one padded batch on the host.

    Each graph mapping needs ``num_nodes``, ``senders``, ``receivers``,
    ``vuln`` and ``feats`` (subkey -> int[num_nodes]), optionally ``id``.
    Graphs that overflow the budget raise; edge endpoints are checked
    before any copy (a dangling endpoint would silently land in another
    graph's rows). ``build_band_adj``/``build_tile_adj`` attach the band
    adjacency or the tile path's nonzero lists.
    """
    if len(graphs) > n_graphs:
        raise ValueError(f"{len(graphs)} graphs > {n_graphs} slots")
    for gi, g in enumerate(graphs):
        n = int(g["num_nodes"])
        s = np.asarray(g["senders"])
        r = np.asarray(g["receivers"])
        if s.shape != r.shape or s.ndim != 1:
            raise ContractError(
                "edge_shape",
                f"graph {gi} (id {g.get('id', '?')}): senders/receivers "
                "must be equal-length 1-d",
                boundary="batch", item_id=g.get("id", gi))
        if s.size and (int(s.min()) < 0 or int(r.min()) < 0
                       or int(s.max()) >= n or int(r.max()) >= n):
            raise ContractError(
                "dangling_endpoint",
                f"graph {gi} (id {g.get('id', '?')}): edge endpoint out of "
                f"range for {n} nodes "
                f"(senders [{int(s.min())}, {int(s.max())}], receivers "
                f"[{int(r.min())}, {int(r.max())}])",
                boundary="batch", item_id=g.get("id", gi))

    graph_mask = np.zeros(n_graphs, bool)
    graph_ids = np.full(n_graphs, -1, np.int32)
    feats = {k: np.zeros(max_nodes, np.int32) for k in subkeys}
    vuln = np.zeros(max_nodes, np.int32)
    senders = np.zeros(max_edges, np.int32)
    receivers = np.zeros(max_edges, np.int32)
    node_graph = np.zeros(max_nodes, np.int32)
    node_mask = np.zeros(max_nodes, bool)
    edge_mask = np.zeros(max_edges, bool)

    node_off = 0
    edge_off = 0
    for gi, g in enumerate(graphs):
        graph_mask[gi] = True
        graph_ids[gi] = int(g.get("id", gi))
        n = int(g["num_nodes"])
        s = np.asarray(g["senders"], np.int32)
        r = np.asarray(g["receivers"], np.int32)
        if add_self_loops:
            loops = np.arange(n, dtype=np.int32)
            s = np.concatenate([s, loops])
            r = np.concatenate([r, loops])
        e = len(s)
        if node_off + n > max_nodes or edge_off + e > max_edges:
            raise ValueError(
                f"graph {gi} overflows budget "
                f"(nodes {node_off}+{n}/{max_nodes}, "
                f"edges {edge_off}+{e}/{max_edges})")
        for k in subkeys:
            feats[k][node_off: node_off + n] = np.asarray(g["feats"][k],
                                                          np.int32)
        vuln[node_off: node_off + n] = np.asarray(g["vuln"], np.int32)
        senders[edge_off: edge_off + e] = s + node_off
        receivers[edge_off: edge_off + e] = r + node_off
        node_graph[node_off: node_off + n] = gi
        node_mask[node_off: node_off + n] = True
        edge_mask[edge_off: edge_off + e] = True
        node_off += n
        edge_off += e

    band_adj = None
    if build_band_adj:
        band_adj = build_band_adjacency(
            senders, receivers, edge_mask, max_nodes,
            tile=tile if tile is not None else DEFAULT_TILE,
            bandwidth=band_bandwidth)
    tile_adj = None
    if build_tile_adj:
        tile_adj = build_csr_adjacency(senders, receivers, edge_mask,
                                       max_nodes)

    t = torch.from_numpy
    return GraphBatch(
        node_feats={k: t(v) for k, v in feats.items()},
        node_vuln=t(vuln),
        senders=t(senders),
        receivers=t(receivers),
        node_graph=t(node_graph),
        node_mask=t(node_mask),
        edge_mask=t(edge_mask),
        graph_mask=t(graph_mask),
        graph_ids=t(graph_ids),
        band_adj=band_adj,
        tile_adj=tile_adj,
    )


def batch_iterator(
    graphs: List[Mapping],
    n_graphs: int,
    max_nodes: int,
    max_edges: int,
    subkeys: Sequence[str],
    add_self_loops: bool = True,
    tile: Optional[int] = None,
    build_band_adj: bool = False,
    band_bandwidth: Optional[int] = None,
    build_tile_adj: bool = False,
) -> Iterator[GraphBatch]:
    """Greedy packer: yields GraphBatches in order, starting a new batch
    when the next graph would overflow the graph, node or edge budget."""
    pending: List[Mapping] = []
    nodes = edges = 0
    kw = dict(add_self_loops=add_self_loops, tile=tile,
              build_band_adj=build_band_adj, band_bandwidth=band_bandwidth,
              build_tile_adj=build_tile_adj)
    for g in graphs:
        n = int(g["num_nodes"])
        e = len(g["senders"]) + (n if add_self_loops else 0)
        if pending and (len(pending) >= n_graphs or nodes + n > max_nodes
                        or edges + e > max_edges):
            yield batch_graphs(pending, n_graphs, max_nodes, max_edges,
                               subkeys, **kw)
            pending, nodes, edges = [], 0, 0
        if n > max_nodes or e > max_edges:
            raise ValueError(f"single graph exceeds budget: {n} nodes / "
                             f"{e} edges")
        pending.append(g)
        nodes += n
        edges += e
    if pending:
        yield batch_graphs(pending, n_graphs, max_nodes, max_edges, subkeys,
                           **kw)
