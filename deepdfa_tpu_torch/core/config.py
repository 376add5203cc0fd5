"""Structured configuration (port of ``deepdfa_tpu/core/config.py``).

Field for field the same dataclasses, with the same defaults, so a
configuration reads the same in both packages (pinned by
tests/test_torch_imports.py). The model, data and training configs are
carried over, and the transformer fine-tune's ``TransformerTrainConfig``;
``EncoderConfig`` lives with the encoder (``models/transformer.py``), as
in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

# The four abstract-dataflow subkeys mined from each definition node.
ALL_SUBKEYS = ("api", "datatype", "literal", "operator")


@dataclasses.dataclass(frozen=True)
class FeatureSpec:
    """Which abstract-dataflow embedding feeds the GNN.

    Index 0 is reserved for "not a definition" and index 1 for the
    UNKNOWN hash, hence ``input_dim == limit_all + 2``.
    """

    subkey: str = "datatype"
    limit_all: int = 1000
    limit_subkeys: int = 1000
    concat_all: bool = True

    @property
    def input_dim(self) -> int:
        return self.limit_all + 2


@dataclasses.dataclass(frozen=True)
class FlowGNNConfig:
    """FlowGNN GGNN hyperparameters; defaults are the published
    configuration (5 gated steps, hidden 32 per subkey, 3 output layers,
    per-subkey embedding tables concatenated).

    ``message_impl``: "segment" (gather + ``index_add_``), "band" (the
    block-banded batched matmul), "tile" (the block-sparse tile product,
    a hand-written CUDA kernel), "fused" (one hand-written CUDA kernel
    per gated step) or "persistent" (one CUDA kernel for all
    ``n_steps``). ``pool_impl``: "segment" (``index_add_``), "matmul"
    (the reference's assignment-matrix sums, in one order on CUDA too) or
    "auto" (matmul on CUDA, segment on the CPU). ``embed_impl`` is kept
    for parity; the port embeds with a gather.
    """

    feature: FeatureSpec = dataclasses.field(default_factory=FeatureSpec)
    hidden_dim: int = 32
    n_steps: int = 5
    num_output_layers: int = 3
    label_style: str = "graph"
    encoder_mode: bool = False
    dtype: str = "float32"
    message_impl: str = "segment"
    remat_steps: bool = True
    pool_impl: str = "auto"
    embed_impl: str = "auto"

    @property
    def input_dim(self) -> int:
        return self.feature.input_dim

    @property
    def uses_band_adj(self) -> bool:
        """Batches for this model must carry the band adjacency."""
        return self.message_impl in ("band", "fused", "persistent")

    @property
    def uses_tile_adj(self) -> bool:
        """Batches for this model must carry the tile adjacency."""
        return self.message_impl == "tile"

    @property
    def embedding_dim(self) -> int:
        n = len(ALL_SUBKEYS) if self.feature.concat_all else 1
        return self.hidden_dim * n

    @property
    def ggnn_hidden(self) -> int:
        n = len(ALL_SUBKEYS) if self.feature.concat_all else 1
        return self.hidden_dim * n

    @property
    def out_dim(self) -> int:
        # skip-concat of [ggnn_out, feat_embed]
        return self.embedding_dim + self.ggnn_hidden


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset/batching configuration: static padding budgets per batch."""

    batch_size: int = 256
    eval_batch_size: int = 16
    max_nodes_per_graph: int = 64
    max_edges_per_node: int = 4
    undersample_factor: Optional[float] = 1.0
    oversample_factor: Optional[float] = None
    seed: int = 0

    @property
    def max_nodes(self) -> int:
        return self.batch_size * self.max_nodes_per_graph

    @property
    def max_edges(self) -> int:
        return self.max_nodes * self.max_edges_per_node


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimizer/trainer configuration; defaults are the published DeepDFA
    settings (AdamW lr 1e-3, weight decay 1e-2, 25 epochs, batch 256).

    ``checkpoint_dir`` set: ``fit`` writes its snapshots there
    (``train/checkpoint.py``), with a periodic one every
    ``checkpoint_every_epochs`` epochs. ``tensorboard_dir`` is kept for
    parity; the port does not log to TensorBoard yet.
    ``detect_anomaly``/``anomaly_policy`` ("raise" or "rollback") and
    ``anomaly_retry_budget`` act at ``log_every`` windows.
    """

    learning_rate: float = 1e-3
    weight_decay: float = 1e-2
    max_epochs: int = 25
    grad_clip_norm: Optional[float] = None
    positive_weight: Optional[float] = None
    seed: int = 1
    checkpoint_dir: Optional[str] = None
    checkpoint_every_epochs: int = 25
    detect_anomaly: bool = False
    anomaly_policy: str = "raise"
    anomaly_retry_budget: int = 3
    tensorboard_dir: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class TransformerTrainConfig:
    """LineVul-style fine-tune settings (the reference's defaults: AdamW
    lr 2e-5, eps 1e-8, no weight decay, linear warmup over 20 % of the
    steps then linear decay, global-norm clip 1.0, batch 16, 512 tokens).

    ``early_stop_patience``: stop after that many epochs without a
    validation-F1 improvement. ``detect_anomaly``/``anomaly_policy``
    ("raise" or "rollback" to the epoch-start state) and
    ``anomaly_retry_budget`` act once an epoch.
    """

    learning_rate: float = 2e-5
    adam_epsilon: float = 1e-8
    weight_decay: float = 0.0
    max_epochs: int = 10
    batch_size: int = 16
    eval_batch_size: int = 16
    block_size: int = 512
    warmup_fraction: float = 0.2
    grad_clip_norm: float = 1.0
    seed: int = 1
    early_stop_patience: Optional[int] = None
    detect_anomaly: bool = False
    anomaly_policy: str = "raise"
    anomaly_retry_budget: int = 3


def subkeys_for(spec: FeatureSpec) -> Sequence[str]:
    return ALL_SUBKEYS if spec.concat_all else (spec.subkey,)
