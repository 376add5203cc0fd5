"""Structured configuration (port of ``deepdfa_tpu/core/config.py``, and
of ``build_configs`` from ``deepdfa_tpu/cli.py``).

Field for field the same dataclasses, with the same defaults, so a
configuration reads the same in both packages (pinned by
tests/test_torch_imports.py). The model, data and training configs are
carried over, and the transformer fine-tune's ``TransformerTrainConfig``;
``EncoderConfig`` lives with the encoder (``models/transformer.py``), as
in the reference. :func:`build_configs` layers YAML files and
``section.key=value`` overrides onto them as the reference's CLI does;
the YAML is read by ``core/yaml_subset.py``, so PyYAML is not needed.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Mapping, Optional, Sequence

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

    @property
    def legacy_name(self) -> str:
        return (
            f"_ABS_DATAFLOW_{self.subkey}_all"
            f"_limitall_{self.limit_all}_limitsubkeys_{self.limit_subkeys}"
        )

    @classmethod
    def parse_legacy(cls, name: str, concat_all: bool = True) -> "FeatureSpec":
        """Parse a reference-style feature name
        (``_ABS_DATAFLOW_<subkey>_all[_limitall_N][_limitsubkeys_M]``);
        a missing limit reads 1000, the published configuration."""
        m = re.match(
            r"_ABS_DATAFLOW_(?P<subkey>\w+?)_all"
            r"(?:_limitall_(?P<la>\d+))?(?:_limitsubkeys_(?P<ls>\d+))?$",
            name,
        )
        if not m:
            raise ValueError(f"unparseable legacy feature name: {name!r}")
        return cls(
            subkey=m.group("subkey"),
            limit_all=int(m.group("la") or 1000),
            limit_subkeys=int(m.group("ls") or 1000),
            concat_all=concat_all,
        )


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


_SECTIONS = {"model": FlowGNNConfig, "data": DataConfig, "train": TrainConfig}


def _coerce(value: str, field_type: Any):
    """The reference's ``_coerce``: a bool field reads 1/true/yes, any
    other field an int, else a float, else the string."""
    if field_type is bool or str(field_type) == "bool":
        return value.lower() in ("1", "true", "yes")
    for cast in (int, float):
        try:
            return cast(value)
        except (TypeError, ValueError):
            continue
    return value


def build_configs(
    config_files: Sequence[str], overrides: Sequence[str],
    defaults: Optional[Mapping[str, Mapping[str, Any]]] = None,
) -> Dict[str, Any]:
    """Layered YAML files + ``section.key=value`` overrides ->
    ``{"model", "data", "train"}`` (the reference's ``build_configs``).

    Later files override earlier ones; each ``--set`` item overrides
    them all, its value coerced to the field's type. ``defaults``
    (port only) is a layer under the files: the port's CLI puts its own
    flag defaults there, so a file or ``--set`` still overrides them.
    The reference's tune-parameter injection (NNI,
    ``DEEPDFA_TUNE_PARAMS``) is not ported.
    """
    from deepdfa_tpu_torch.core.yaml_subset import safe_load

    def deep_update(dst: Dict, src: Mapping) -> None:
        for k, v in src.items():
            if isinstance(v, dict) and isinstance(dst.get(k), dict):
                deep_update(dst[k], v)
            else:
                dst[k] = v

    merged: Dict[str, Dict[str, Any]] = {k: {} for k in _SECTIONS}
    for section, values in (defaults or {}).items():
        deep_update(merged[section], dict(values))
    for path in config_files:
        with open(path) as f:
            doc = safe_load(f) or {}
        for section, values in doc.items():
            if section not in merged:
                raise ValueError(
                    f"unknown config section {section!r} in {path}")
            deep_update(merged[section], values or {})
    for item in overrides:
        dotted, _, value = item.partition("=")
        section, _, key = dotted.partition(".")
        if section not in merged or not key:
            raise ValueError(
                f"override must be section.key=value, got {item!r}")
        merged[section][key] = value

    out: Dict[str, Any] = {}
    for section, cls in _SECTIONS.items():
        kwargs = dict(merged[section])
        if section == "model" and "feature" in kwargs:
            feat = kwargs["feature"]
            kwargs["feature"] = (
                FeatureSpec.parse_legacy(feat) if isinstance(feat, str)
                else FeatureSpec(**feat)
            )
        fields = {f.name: f for f in dataclasses.fields(cls)}
        for k in list(kwargs):
            if k not in fields:
                raise ValueError(f"unknown {section} option {k!r}")
            if isinstance(kwargs[k], str) and fields[k].type not in (
                    str, "str"):
                kwargs[k] = _coerce(kwargs[k], fields[k].type)
        out[section] = cls(**kwargs)
    return out
