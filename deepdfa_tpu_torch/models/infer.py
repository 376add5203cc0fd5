"""Inference-only apply paths for the serving layer (port of
``deepdfa_tpu/models/infer.py``).

Each factory puts the model in eval mode and returns a function of the
padded inputs alone: per-slot probabilities, computed under
``torch.inference_mode`` (so the forward kernels launch, never the
backward). On the same padded inputs ``make_gnn_infer`` reproduces the
offline eval path's probabilities and ``make_combined_infer`` the text
eval step's.
"""

from __future__ import annotations

from typing import Callable

import torch

from deepdfa_tpu_torch.graphs.batch import GraphBatch
from deepdfa_tpu_torch.models.flowgnn import FlowGNN
from deepdfa_tpu_torch.models.linevul import LineVul


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


def make_combined_infer(model: LineVul
                        ) -> Callable[[torch.Tensor, GraphBatch],
                                      torch.Tensor]:
    """(input_ids [B, T], GraphBatch) -> float32 P(vulnerable) per row:
    the DeepDFA+LineVul forward (text row i joined with graph slot i),
    dropout off."""
    if model.graph_config is None:
        raise ValueError("combined inference needs LineVul(graph_config=...)")
    model.eval()

    def infer(input_ids: torch.Tensor, graphs: GraphBatch) -> torch.Tensor:
        with torch.inference_mode():
            logits = model(input_ids, graphs, deterministic=True)
            return torch.softmax(logits, dim=-1)[:, 1]

    return infer


def make_text_infer(model: LineVul) -> Callable[[torch.Tensor], torch.Tensor]:
    """input_ids [B, T] -> float32 P(vulnerable) per row: LineVul alone
    (no graph encoder), for text-only deployments."""
    if model.graph_config is not None:
        raise ValueError(
            "model has a graph encoder; use make_combined_infer (a "
            "text-only forward would skip its flowgnn parameters)")
    model.eval()

    def infer(input_ids: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            logits = model(input_ids, None, deterministic=True)
            return torch.softmax(logits, dim=-1)[:, 1]

    return infer
