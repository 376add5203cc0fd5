"""The flagship forward of the port (counterpart of ``entry()`` in the
repository's ``__graft_entry__.py``).

``entry()`` returns ``(fn, (params, batch))``: the published DeepDFA
FlowGNN (k = 1000 vocabulary, hidden 32, 5 steps, 3 output layers, all
four subkeys, the block-banded message path) at seeded random weights,
and one 256-graph batch of synthetic Big-Vul-shaped graphs.
``fn(params, batch)`` is the inference forward, per-graph logits;
``params`` maps parameter names to tensors, so weights from elsewhere
(``models/convert.py``) go in by name. It runs on the card unless the
CPU is asked for.

    fn, args = entry()             # cuda
    logits = fn(*args)             # [256]
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from deepdfa_tpu_torch.core.config import (
    DataConfig,
    FlowGNNConfig,
    TrainConfig,
    subkeys_for,
)
from deepdfa_tpu_torch.core.device import DeviceLike, resolve_device
from deepdfa_tpu_torch.graphs.batch import GraphBatch


def _flagship() -> Tuple[FlowGNNConfig, DataConfig, TrainConfig]:
    """The published DeepDFA configuration (paper Table 2) on a
    256-graph batch over the block-banded message path."""
    return (FlowGNNConfig(message_impl="band"), DataConfig(batch_size=256),
            TrainConfig())


def _example_batch(data_cfg: DataConfig, model_cfg: FlowGNNConfig,
                   slot_pack: bool = False) -> GraphBatch:
    """A batch size of synthetic graphs (seed 0) packed on the host as
    the reference's example batch: ``pad_budget_for``'s budget, the node
    budget aligned to the tile for band and tile batches; ``slot_pack``
    gives every graph one dense slot (``slot_nodes_for``), so the band's
    bandwidth is pinned by the slot and not by the batch mix."""
    from deepdfa_tpu_torch.data.synthetic import synthetic_bigvul
    from deepdfa_tpu_torch.graphs.batch import (
        batch_graphs,
        pad_budget_for,
        slot_nodes_for,
    )
    from deepdfa_tpu_torch.ops.tile_spmm import DEFAULT_TILE, align_to_tile

    n_graphs = data_cfg.batch_size
    graphs = synthetic_bigvul(n_graphs, model_cfg.feature,
                              positive_fraction=0.5, seed=0)
    budget = pad_budget_for(graphs, n_graphs)
    slot_nodes = None
    if slot_pack:
        slot_nodes = slot_nodes_for(graphs, tile=DEFAULT_TILE)
        budget = dict(budget, max_nodes=align_to_tile(n_graphs * slot_nodes))
    elif model_cfg.uses_tile_adj or model_cfg.uses_band_adj:
        budget = dict(budget, max_nodes=align_to_tile(budget["max_nodes"]))
    return batch_graphs(graphs, n_graphs, budget["max_nodes"],
                        budget["max_edges"], subkeys_for(model_cfg.feature),
                        build_tile_adj=model_cfg.uses_tile_adj,
                        build_band_adj=model_cfg.uses_band_adj,
                        slot_nodes=slot_nodes)


def entry(device: DeviceLike = None, slot_pack: bool = False
          ) -> Tuple[Callable, Tuple[Dict[str, torch.Tensor], GraphBatch]]:
    """(fn, (params, batch)): the flagship model's inference forward, its
    seeded weights and example batch on ``device`` (default ``cuda``;
    raises without CUDA unless "cpu" is asked for)."""
    from deepdfa_tpu_torch.models.flowgnn import FlowGNN

    dev = resolve_device(device)
    model_cfg, data_cfg, _ = _flagship()
    model = FlowGNN(model_cfg, device=dev, seed=0)
    model.eval()
    batch = _example_batch(data_cfg, model_cfg, slot_pack=slot_pack).to(dev)
    params = {k: v.detach() for k, v in model.state_dict().items()}

    def fn(params: Dict[str, torch.Tensor], batch: GraphBatch
           ) -> torch.Tensor:
        with torch.inference_mode():
            return torch.func.functional_call(model, params, (batch,))

    return fn, (params, batch)
