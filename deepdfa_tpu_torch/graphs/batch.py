"""Static-shape graph batching (port of ``deepdfa_tpu/graphs/batch.py``).

A batch is a fixed budget of ``n_graphs`` graph slots, ``max_nodes``
node slots and ``max_edges`` edge slots; real entries are marked by
masks and padding is inert under the masked ops. Budgets round up a
power-of-two ladder so traffic sees a handful of shapes.

Graphs pack contiguously, or each into a fixed dense slot
(``slot_nodes``, :func:`slot_nodes_for`); the greedy
:func:`batch_iterator` spills into the next batch. The padded arrays come
from the C++ batcher (``deepdfa_tpu_torch/native``, ``impl="native"``;
``"auto"`` means native too, and a failed build raises) or from the
numpy loop (``impl="python"``, the oracle). Slot packing and the
dataflow-solution bits (``with_dataflow``) always take the Python path.
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
    node_df_in, node_df_out : optional int32[max_nodes] dataflow-solution
                  bits (``with_dataflow``; the dataflow label styles)
    node_graph_sorted : whether ``node_graph`` keyed by ``node_mask`` (a
                  padded node's id ``n_graphs``) is non-decreasing: graphs
                  packed contiguously, the padding after the last graph.
                  The pooling's segment sums on the card then search it as
                  it is (``segment_sum_plan(indices_are_sorted=True)``),
                  which the card cannot check: a wrong True gives wrong
                  sums. False (the default, for a batch built by hand, and
                  slot packing, which leaves padding inside the slots):
                  they build an index plan.
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
    node_df_in: Optional[torch.Tensor] = None
    node_df_out: Optional[torch.Tensor] = None
    node_graph_sorted: bool = False

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


def slot_nodes_for(graphs: Sequence[Mapping], minimum: int = 16,
                   tile: Optional[int] = None) -> int:
    """The dense-slot size for ``slot_nodes`` packing: the bucket ladder
    (:func:`select_bucket`) rounded up from the largest graph. A power of
    two, so with a power-of-two ``tile`` either the slot divides the tile
    or the tile divides the slot; ``tile`` only checks that contract and
    never widens the slot."""
    biggest = max((int(g["num_nodes"]) for g in graphs), default=1)
    slot = select_bucket(max(biggest, 1), minimum=minimum)
    if tile is not None and tile & (tile - 1):
        raise ValueError(f"tile {tile} is not a power of two")
    return slot


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


def _fill_python(graphs, max_nodes, max_edges, subkeys, add_self_loops,
                 slot_nodes):
    """The padded arrays by the numpy loop (the oracle of the native
    batcher; the only path of slot packing)."""
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
        if slot_nodes is not None:
            node_off = gi * slot_nodes
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
    return feats, vuln, senders, receivers, node_graph, node_mask, edge_mask


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
    with_dataflow: bool = False,
    slot_nodes: Optional[int] = None,
    impl: str = "auto",
) -> GraphBatch:
    """Pack up to ``n_graphs`` graphs into one padded batch on the host.

    Each graph mapping needs ``num_nodes``, ``senders``, ``receivers``,
    ``vuln`` and ``feats`` (subkey -> int[num_nodes]), optionally ``id``.
    Graphs that overflow the budget raise; edge endpoints are checked
    before any copy (a dangling endpoint would silently land in another
    graph's rows). ``build_band_adj``/``build_tile_adj`` attach the band
    adjacency or the tile path's nonzero lists; ``with_dataflow`` the
    examples' ``df_in``/``df_out`` bits (an example without them
    raises).

    ``slot_nodes``: graph ``gi`` occupies the node range
    ``[gi * slot_nodes, (gi + 1) * slot_nodes)`` instead of packing
    contiguously, so one slot size (:func:`slot_nodes_for`) pins the
    band's bandwidth whatever the batch mix; the in-slot tails are
    masked padding. ``impl``: "native" (the C++ batcher), "python" (the
    numpy loop) or "auto" (native); slot packing takes the python path
    and refuses "native".
    """
    if len(graphs) > n_graphs:
        raise ValueError(f"{len(graphs)} graphs > {n_graphs} slots")
    if slot_nodes is not None:
        if slot_nodes < 1:
            raise ValueError(f"slot_nodes {slot_nodes} < 1")
        if n_graphs * slot_nodes > max_nodes:
            raise ValueError(
                f"{n_graphs} slots of {slot_nodes} nodes exceed the "
                f"{max_nodes}-node budget")
        for gi, g in enumerate(graphs):
            if int(g["num_nodes"]) > slot_nodes:
                raise ValueError(
                    f"graph {gi} (id {g.get('id', '?')}): "
                    f"{int(g['num_nodes'])} nodes > slot_nodes {slot_nodes}")
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
    for gi, g in enumerate(graphs):
        graph_mask[gi] = True
        graph_ids[gi] = int(g.get("id", gi))

    if impl not in ("auto", "native", "python"):
        raise ValueError(f"unknown impl {impl!r}")
    if slot_nodes is not None and impl == "native":
        raise ValueError("slot_nodes packing has no native batcher path")
    if slot_nodes is None and impl != "python":
        from deepdfa_tpu_torch import native

        arrs = native.fill_batch(graphs, n_graphs, max_nodes, max_edges,
                                 subkeys, add_self_loops)
        feats = {k: arrs["feats"][ki] for ki, k in enumerate(subkeys)}
        vuln = arrs["vuln"]
        senders = arrs["senders"]
        receivers = arrs["receivers"]
        node_graph = arrs["node_graph"]
        node_mask = arrs["node_mask"].astype(bool)
        edge_mask = arrs["edge_mask"].astype(bool)
    else:
        feats, vuln, senders, receivers, node_graph, node_mask, edge_mask = \
            _fill_python(graphs, max_nodes, max_edges, subkeys,
                         add_self_loops, slot_nodes)

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

    df_in = df_out = None
    if with_dataflow:
        df_in = np.zeros(max_nodes, np.int32)
        df_out = np.zeros(max_nodes, np.int32)
        off = 0
        for gi, g in enumerate(graphs):
            if slot_nodes is not None:
                # The bits land at the same slot offsets as the features.
                off = gi * slot_nodes
            n = int(g["num_nodes"])
            if "df_in" not in g or "df_out" not in g:
                raise ValueError(
                    "with_dataflow=True but example "
                    f"{g.get('id', '?')} carries no df_in/df_out bits — "
                    "re-run the ETL export (it attaches them) or "
                    "regenerate synthetic data")
            df_in[off: off + n] = np.asarray(g["df_in"], np.int32)
            df_out[off: off + n] = np.asarray(g["df_out"], np.int32)
            off += n

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
        node_df_in=t(df_in) if df_in is not None else None,
        node_df_out=t(df_out) if df_out is not None else None,
        node_graph_sorted=slot_nodes is None,
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
    with_dataflow: bool = False,
    slot_nodes: Optional[int] = None,
    impl: str = "auto",
) -> Iterator[GraphBatch]:
    """Greedy packer: yields GraphBatches in order, starting a new batch
    when the next graph would overflow the graph, node or edge budget.
    With ``slot_nodes`` each graph costs one slot of the node budget (pin
    it, e.g. :func:`slot_nodes_for` over the whole corpus, so every batch
    shares one slot layout)."""
    pending: List[Mapping] = []
    nodes = edges = 0
    kw = dict(add_self_loops=add_self_loops, tile=tile,
              build_band_adj=build_band_adj, band_bandwidth=band_bandwidth,
              build_tile_adj=build_tile_adj, with_dataflow=with_dataflow,
              slot_nodes=slot_nodes, impl=impl)
    for g in graphs:
        n_real = int(g["num_nodes"])
        n = n_real if slot_nodes is None else slot_nodes
        e = len(g["senders"]) + (n_real if add_self_loops else 0)
        if pending and (len(pending) >= n_graphs or nodes + n > max_nodes
                        or edges + e > max_edges):
            yield batch_graphs(pending, n_graphs, max_nodes, max_edges,
                               subkeys, **kw)
            pending, nodes, edges = [], 0, 0
        if slot_nodes is not None and n_real > slot_nodes:
            raise ValueError(f"single graph exceeds slot: {n_real} nodes > "
                             f"slot_nodes {slot_nodes}")
        if n > max_nodes or e > max_edges:
            raise ValueError(f"single graph exceeds budget: {n} nodes / "
                             f"{e} edges")
        pending.append(g)
        nodes += n
        edges += e
    if pending:
        yield batch_graphs(pending, n_graphs, max_nodes, max_edges, subkeys,
                           **kw)
