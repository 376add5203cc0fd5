"""Inference-only apply path for the serving layer (port of
``make_gnn_infer`` in ``deepdfa_tpu/models/infer.py``)."""

from __future__ import annotations

from typing import Callable

import torch

from deepdfa_tpu_torch.graphs.batch import GraphBatch
from deepdfa_tpu_torch.models.flowgnn import FlowGNN


def make_gnn_infer(model: FlowGNN) -> Callable[[GraphBatch], torch.Tensor]:
    """GraphBatch -> float32 probabilities per graph slot (padded slots
    give values callers drop via ``batch.graph_mask``)."""
    if model.config.label_style != "graph":
        raise ValueError(
            f"serving scores functions (label_style='graph'), got "
            f"{model.config.label_style!r}")
    model.eval()

    def infer(batch: GraphBatch) -> torch.Tensor:
        with torch.inference_mode():
            return torch.sigmoid(model(batch))

    return infer
