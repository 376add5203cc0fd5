"""LineVul, optionally combined with the FlowGNN graph encoder (port of
``deepdfa_tpu/models/linevul.py``).

RoBERTa encoder; classification vector = the <s> hidden state,
optionally concatenated with the pooled FlowGNN embedding
(``FlowGNNConfig(encoder_mode=True)``), then the RoBERTa head (dropout,
dense to the hidden width, tanh, dropout, projection to 2 logits) and a
masked two-class cross entropy. Parameters are named as the flax tree:
``roberta.*``, ``flowgnn.*``, ``classifier.{dense,out_proj}``. With a
bf16 encoder (``EncoderConfig(dtype="bfloat16")``) the head stays f32,
as the reference's Dense layers there carry no dtype: the f32 CLS vector
and graph embedding in, f32 logits and loss out.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from deepdfa_tpu_torch.core.config import FlowGNNConfig
from deepdfa_tpu_torch.core.device import DeviceLike, resolve_device
from deepdfa_tpu_torch.graphs.batch import GraphBatch
from deepdfa_tpu_torch.models.flowgnn import FlowGNN, _linear
from deepdfa_tpu_torch.models.transformer import (
    EncoderConfig,
    RobertaEncoder,
    draw_seed,
    dropout,
    seeded,
)


class ClassificationHead(nn.Module):
    """RobertaClassificationHead with an extra-feature slot."""

    def __init__(self, in_width: int, hidden_size: int, dropout_rate: float,
                 gen: torch.Generator):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.dense = _linear(in_width, hidden_size, gen)
        self.out_proj = _linear(hidden_size, 2, gen)

    def forward(self, cls_vec: torch.Tensor,
                graph_embed: Optional[torch.Tensor],
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = cls_vec
        if graph_embed is not None:
            x = torch.cat([x, graph_embed], dim=-1)
        active = not deterministic
        x = dropout(x, self.dropout_rate, active, generator)
        x = torch.tanh(self.dense(x))
        x = dropout(x, self.dropout_rate, active, generator)
        return self.out_proj(x)


class LineVul(nn.Module):
    """Text (+ graph) classifier. ``graph_config`` None: LineVul;
    set (with ``encoder_mode=True``): DeepDFA+LineVul combined."""

    def __init__(self, encoder_config: EncoderConfig,
                 graph_config: Optional[FlowGNNConfig] = None,
                 device: DeviceLike = None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.encoder_config = encoder_config
        self.graph_config = graph_config
        self.roberta = RobertaEncoder(encoder_config, gen)
        extra = 0
        if graph_config is not None:
            if not graph_config.encoder_mode:
                raise ValueError("graph_config must set encoder_mode")
            self.flowgnn = FlowGNN(graph_config, device="cpu", generator=gen)
            extra = graph_config.out_dim
        self.classifier = ClassificationHead(
            encoder_config.hidden_size + extra, encoder_config.hidden_size,
            encoder_config.dropout_rate, gen)
        self.to(dev)

    @property
    def pad_token_id(self) -> int:
        return self.encoder_config.pad_token_id

    def forward(self, input_ids: torch.Tensor,
                graphs: Optional[GraphBatch] = None,
                deterministic: bool = True, output_attentions: bool = False,
                input_embeds: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """Logits [B, 2] (and the attentions with ``output_attentions``).
        ``generator``: the CPU generator dropout seeds come from."""
        attn_mask = input_ids != self.encoder_config.pad_token_id
        hidden, attentions = self.roberta(
            input_ids, attn_mask, deterministic=deterministic,
            output_attentions=output_attentions, input_embeds=input_embeds,
            generator=generator)
        graph_embed = None
        if self.graph_config is not None:
            if graphs is None:
                raise ValueError("the combined model needs a GraphBatch")
            graph_embed = self.flowgnn(graphs)
        head_gen = None
        if not deterministic:
            head_gen = seeded(draw_seed(generator), input_ids.device)
        logits = self.classifier(hidden[:, 0, :], graph_embed, deterministic,
                                 head_gen)
        if output_attentions:
            return logits, attentions
        return logits


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       example_mask: torch.Tensor) -> torch.Tensor:
    """Masked mean two-class cross entropy. Masked rows are neutralized
    before the log-softmax: a padded row's logits may be non-finite, and
    neither the loss nor the gradient may see them."""
    logits = torch.where(example_mask[:, None], logits, 0.0)
    log_probs = torch.log_softmax(logits, dim=-1)
    picked = log_probs.gather(1, labels.long()[:, None])[:, 0]
    picked = torch.where(example_mask, picked, 0.0)
    m = example_mask.float()
    return -picked.sum() / torch.clamp(m.sum(), min=1.0)
