"""Carry parameters from the JAX package (and HuggingFace RoBERTa) into
the port.

``flowgnn_from_flax`` maps a flax FlowGNN parameter tree (nested dicts
of numpy-convertible arrays, with or without the outer ``"params"``) to
a ``state_dict`` of :class:`deepdfa_tpu_torch.models.flowgnn.FlowGNN`:

- ``embed_{key}/embedding``            -> ``embeds.{key}.embedding``
- ``ggnn_step/edge_linear/{kernel,bias}`` -> ``ggnn_step.edge_linear``
- ``ggnn_step/gru/{ir,iz,in,hr,hz,hn}`` -> ``ggnn_step.gru.{name}``;
  flax's GRU has no hidden-side r/z bias, and neither has the port, so
  ``hr``/``hz`` carry a kernel only
- ``pooling/gate``                     -> ``pooling.gate``
- ``_head/output_{i}``                 -> ``head.output_{i}``

``encoder_from_flax`` maps a flax ``RobertaEncoder`` tree to a
``state_dict`` of :class:`deepdfa_tpu_torch.models.transformer.RobertaEncoder`
(``layer_{i}`` -> ``layer.{i}``, LayerNorm ``scale`` -> ``weight``);
``linevul_from_flax`` maps a flax ``LineVul`` tree (its ``roberta``,
``flowgnn`` and ``classifier`` subtrees) to a ``LineVul`` ``state_dict``;
``roberta_from_hf`` maps a HuggingFace RoBERTa ``state_dict``
(codebert-base, unixcoder-base; with or without the ``roberta.``
prefix), the counterpart of the reference's ``convert_hf_roberta``;
``roberta_to_hf`` maps back, to a ``RobertaModel``'s keys.

``t5_from_flax`` maps a flax ``T5Model`` tree to a ``state_dict`` of
:class:`deepdfa_tpu_torch.models.t5.T5Model` (``block_{i}`` ->
``block.{i}``; the relative bias table and the RMS norms' ``weight`` as
they are); ``defect_from_flax`` maps a flax ``DefectModel`` tree (its
``t5``, ``flowgnn`` and ``classifier`` subtrees; the classifier's input
is ``[t5 vector, graph embedding]`` in that order) to a ``DefectModel``
``state_dict``; ``t5_from_hf`` maps a HuggingFace T5 ``state_dict``
(t5-*, Salesforce/codet5-*), the counterpart of the reference's
``convert_hf_t5``, and ``t5_to_hf`` maps back.

flax ``Dense`` kernels are ``[in, out]``; torch ``Linear`` weights are
``[out, in]``, so every kernel is transposed. HuggingFace weights are
torch's layout already.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))  # an owned copy


def _dense(prefix: str, p: Mapping, out: Dict[str, torch.Tensor]) -> None:
    out[f"{prefix}.weight"] = _tensor(np.asarray(p["kernel"]).T)
    if "bias" in p:
        out[f"{prefix}.bias"] = _tensor(p["bias"])


def flowgnn_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """A torch ``state_dict`` from a flax FlowGNN parameter tree."""
    params = tree["params"] if "params" in tree else tree
    out: Dict[str, torch.Tensor] = {}
    for name, sub in params.items():
        if name.startswith("embed_"):
            out[f"embeds.{name[len('embed_'):]}.embedding"] = _tensor(
                sub["embedding"])
        elif name == "ggnn_step":
            _dense("ggnn_step.edge_linear", sub["edge_linear"], out)
            for gate, p in sub["gru"].items():
                _dense(f"ggnn_step.gru.{gate}", p, out)
        elif name == "pooling":
            _dense("pooling.gate", sub["gate"], out)
        elif name == "_head":
            for layer, p in sub.items():
                _dense(f"head.{layer}", p, out)
        else:
            raise ValueError(f"unexpected FlowGNN param subtree {name!r}")
    return out


def _unwrap(tree: Mapping) -> Mapping:
    return tree["params"] if "params" in tree else tree


def _layer_norm(prefix: str, p: Mapping, out: Dict[str, torch.Tensor]) -> None:
    out[f"{prefix}.weight"] = _tensor(p["scale"])
    out[f"{prefix}.bias"] = _tensor(p["bias"])


def encoder_from_flax(tree: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A ``RobertaEncoder`` ``state_dict`` from a flax encoder tree (keys
    under ``prefix``)."""
    out: Dict[str, torch.Tensor] = {}
    for name, sub in _unwrap(tree).items():
        if name.endswith("_embeddings"):
            out[f"{prefix}{name}.embedding"] = _tensor(sub["embedding"])
        elif name == "embeddings_ln":
            _layer_norm(f"{prefix}embeddings_ln", sub, out)
        elif name.startswith("layer_"):
            base = f"{prefix}layer.{int(name[len('layer_'):])}"
            for qkv in ("query", "key", "value"):
                _dense(f"{base}.attention.{qkv}", sub["attention"][qkv], out)
            for dense in ("attention_output", "intermediate", "output"):
                _dense(f"{base}.{dense}", sub[dense], out)
            for ln in ("attention_ln", "output_ln"):
                _layer_norm(f"{base}.{ln}", sub[ln], out)
        else:
            raise ValueError(f"unexpected encoder param subtree {name!r}")
    return out


def linevul_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """A ``LineVul`` ``state_dict`` from a flax LineVul tree."""
    params = _unwrap(tree)
    out = encoder_from_flax(params["roberta"], prefix="roberta.")
    if "flowgnn" in params:
        out.update({f"flowgnn.{k}": v
                    for k, v in flowgnn_from_flax(params["flowgnn"]).items()})
    for layer in ("dense", "out_proj"):
        _dense(f"classifier.{layer}", params["classifier"][layer], out)
    unknown = set(params) - {"roberta", "flowgnn", "classifier"}
    if unknown:
        raise ValueError(f"unexpected LineVul param subtrees {sorted(unknown)}")
    return out


_HF_EMBEDDINGS = (
    ("word_embeddings.embedding", "embeddings.word_embeddings.weight"),
    ("position_embeddings.embedding",
     "embeddings.position_embeddings.weight"),
    ("token_type_embeddings.embedding",
     "embeddings.token_type_embeddings.weight"),
    ("embeddings_ln.weight", "embeddings.LayerNorm.weight"),
    ("embeddings_ln.bias", "embeddings.LayerNorm.bias"))
_HF_LAYER_PAIRS = (("attention.query", "attention.self.query"),
                   ("attention.key", "attention.self.key"),
                   ("attention.value", "attention.self.value"),
                   ("attention_output", "attention.output.dense"),
                   ("attention_ln", "attention.output.LayerNorm"),
                   ("intermediate", "intermediate.dense"),
                   ("output", "output.dense"),
                   ("output_ln", "output.LayerNorm"))


def roberta_to_hf(state_dict: Mapping[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    """A HuggingFace ``RobertaModel`` ``state_dict`` (bare
    ``embeddings.``/``encoder.`` keys, no pooler) from a port
    ``RobertaEncoder`` ``state_dict``: the inverse of
    :func:`roberta_from_hf`."""
    out = {theirs: state_dict[ours] for ours, theirs in _HF_EMBEDDINGS}
    num_layers = 1 + max(int(k.split(".")[1]) for k in state_dict
                         if k.startswith("layer."))
    for i in range(num_layers):
        for ours, theirs in _HF_LAYER_PAIRS:
            for w in ("weight", "bias"):
                out[f"encoder.layer.{i}.{theirs}.{w}"] = state_dict[
                    f"layer.{i}.{ours}.{w}"]
    return out


def roberta_from_hf(state_dict: Mapping) -> Dict[str, torch.Tensor]:
    """A ``RobertaEncoder`` ``state_dict`` from a HuggingFace RoBERTa
    ``state_dict`` (``roberta.``-prefixed keys of a
    ``ForSequenceClassification`` checkpoint, or a base model's bare
    ``embeddings.``/``encoder.`` keys), every encoder layer it holds."""

    def get(key: str) -> torch.Tensor:
        for prefix in ("roberta.", ""):
            if prefix + key in state_dict:
                value = state_dict[prefix + key]
                if hasattr(value, "detach"):
                    value = value.detach().cpu().numpy()
                return _tensor(value)
        raise KeyError(key)

    num_layers = 1 + max(int(k.split("encoder.layer.")[1].split(".")[0])
                         for k in state_dict if "encoder.layer." in k)
    out = {ours: get(theirs) for ours, theirs in _HF_EMBEDDINGS}
    for i in range(num_layers):
        for ours, theirs in _HF_LAYER_PAIRS:
            for w in ("weight", "bias"):
                out[f"layer.{i}.{ours}.{w}"] = get(
                    f"encoder.layer.{i}.{theirs}.{w}")
    return out


def t5_from_flax(tree: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A ``T5Model`` ``state_dict`` from a flax ``T5Model`` tree (keys
    under ``prefix``)."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping, path: str) -> None:
        for name, sub in node.items():
            if isinstance(sub, Mapping):
                key = (f"block.{int(name[len('block_'):])}"
                       if name.startswith("block_") else name)
                walk(sub, f"{path}{key}.")
            elif name == "kernel":
                out[f"{path}weight"] = _tensor(np.asarray(sub).T)
            else:
                out[f"{path}{name}"] = _tensor(sub)

    walk(_unwrap(tree), prefix)
    return out


def defect_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """A ``DefectModel`` ``state_dict`` from a flax DefectModel tree."""
    params = _unwrap(tree)
    unknown = set(params) - {"t5", "flowgnn", "classifier"}
    if unknown:
        raise ValueError(
            f"unexpected DefectModel param subtrees {sorted(unknown)}")
    out = t5_from_flax(params["t5"], prefix="t5.")
    if "flowgnn" in params:
        out.update({f"flowgnn.{k}": v
                    for k, v in flowgnn_from_flax(params["flowgnn"]).items()})
    _dense("classifier", params["classifier"], out)
    return out


def _t5_pairs(num_layers: int, num_decoder_layers: int, gated_ffn: bool,
              tie_word_embeddings: bool):
    """(port key, HuggingFace key) of every T5 tensor."""
    pairs = [("shared.embedding", "shared.weight")]
    ffn = ("wi_0", "wi_1", "wo") if gated_ffn else ("wi", "wo")
    for side, n, causal in (("encoder", num_layers, False),
                            ("decoder", num_decoder_layers, True)):
        for i in range(n):
            ours, theirs = f"{side}.block.{i}", f"{side}.block.{i}.layer"
            pairs.append((f"{ours}.self_attn_ln.weight",
                          f"{theirs}.0.layer_norm.weight"))
            for p in "qkvo":
                pairs.append((f"{ours}.self_attn.{p}.weight",
                              f"{theirs}.0.SelfAttention.{p}.weight"))
            if i == 0:
                pairs.append((
                    f"{ours}.self_attn.relative_attention_bias",
                    f"{theirs}.0.SelfAttention.relative_attention_bias."
                    "weight"))
            at = 1
            if causal:
                pairs.append((f"{ours}.cross_attn_ln.weight",
                              f"{theirs}.1.layer_norm.weight"))
                for p in "qkvo":
                    pairs.append((f"{ours}.cross_attn.{p}.weight",
                                  f"{theirs}.1.EncDecAttention.{p}.weight"))
                at = 2
            pairs.append((f"{ours}.ffn_ln.weight",
                          f"{theirs}.{at}.layer_norm.weight"))
            for w in ffn:
                pairs.append((f"{ours}.ffn.{w}.weight",
                              f"{theirs}.{at}.DenseReluDense.{w}.weight"))
        pairs.append((f"{side}.final_ln.weight",
                      f"{side}.final_layer_norm.weight"))
    if not tie_word_embeddings:
        pairs.append(("lm_head.weight", "lm_head.weight"))
    return pairs


def t5_from_hf(state_dict: Mapping, cfg) -> Dict[str, torch.Tensor]:
    """A ``T5Model`` ``state_dict`` from a HuggingFace T5 ``state_dict``
    and the model's ``T5Config``. The embedding comes from
    ``shared.weight``: ``save_pretrained`` drops the tied copies
    (``encoder.embed_tokens``, ``decoder.embed_tokens``, ``lm_head``)."""

    def get(key: str) -> torch.Tensor:
        value = state_dict[key]
        if hasattr(value, "detach"):
            value = value.detach().cpu().numpy()
        return _tensor(value)

    return {ours: get(theirs) for ours, theirs in _t5_pairs(
        cfg.num_layers, cfg.num_decoder_layers, cfg.gated_ffn,
        cfg.tie_word_embeddings)}


def t5_to_hf(state_dict: Mapping[str, torch.Tensor], cfg
             ) -> Dict[str, torch.Tensor]:
    """A HuggingFace ``T5ForConditionalGeneration`` ``state_dict`` as
    ``save_pretrained`` writes it (no tied copies) from a port
    ``T5Model`` ``state_dict``: the inverse of :func:`t5_from_hf`."""
    return {theirs: state_dict[ours] for ours, theirs in _t5_pairs(
        cfg.num_layers, cfg.num_decoder_layers, cfg.gated_ffn,
        cfg.tie_word_embeddings)}
