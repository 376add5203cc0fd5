"""Pretrained checkpoints: a HuggingFace directory -> the port's config
and parameters (port of ``deepdfa_tpu/models/pretrained.py``).

The reference fine-tunes from ``from_pretrained`` checkpoints
(linevul_main.py:605-621); its loader calls ``transformers``. The port
reads the same directory (``config.json`` and the weights that
``save_pretrained`` writes) with the standard library and torch alone:

- ``model.safetensors`` by a hand parser (an 8-byte little-endian header
  length, a JSON header naming each tensor's dtype, shape and
  ``data_offsets``, then the raw little-endian bytes);
- else ``pytorch_model.bin`` by ``torch.load(weights_only=True)``.

A RoBERTa directory maps through ``roberta_from_hf`` to a
``RobertaEncoder`` ``state_dict``, a T5 one (t5-*, Salesforce/codet5-*)
through ``t5_from_hf`` to a ``T5Model`` ``state_dict``. Nest it under
the model's submodule name (``roberta.`` in ``LineVul``, ``t5.`` in
``DefectModel``) before ``fit_text(init_params=)``.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from deepdfa_tpu_torch.models.convert import roberta_from_hf, t5_from_hf
from deepdfa_tpu_torch.models.t5 import T5Config
from deepdfa_tpu_torch.models.transformer import EncoderConfig

_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
_DTYPE_NAMES = {v: k for k, v in _SAFETENSORS_DTYPES.items()}

# RobertaConfig's defaults, for keys a config.json leaves out.
_HF_DEFAULTS = {
    "vocab_size": 50265, "hidden_size": 768, "num_hidden_layers": 12,
    "num_attention_heads": 12, "intermediate_size": 3072,
    "hidden_act": "gelu", "hidden_dropout_prob": 0.1,
    "max_position_embeddings": 512, "type_vocab_size": 2,
    "layer_norm_eps": 1e-12, "pad_token_id": 1,
    "position_embedding_type": "absolute",
}
# T5Config's defaults, for keys a config.json leaves out
# (``save_pretrained`` drops ``tie_word_embeddings`` when it is True).
_HF_T5_DEFAULTS = {
    "vocab_size": 32128, "d_model": 512, "d_kv": 64, "d_ff": 2048,
    "num_layers": 6, "num_decoder_layers": None, "num_heads": 8,
    "relative_attention_num_buckets": 32,
    "relative_attention_max_distance": 128, "dropout_rate": 0.1,
    "layer_norm_epsilon": 1e-6, "feed_forward_proj": "relu",
    "pad_token_id": 0, "eos_token_id": 1, "decoder_start_token_id": None,
    "tie_word_embeddings": True,
}
# The FFN forms the T5 stack computes: relu, and gated tanh gelu
# (HuggingFace's "gated-gelu" is gelu_new, the tanh form).
_T5_FFNS = ("relu", "gated-gelu")


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of one ``.safetensors`` file, on the CPU."""
    buf = bytearray(os.path.getsize(path))
    with open(path, "rb") as f:
        f.readinto(buf)
    if len(buf) < 8:
        raise ValueError(f"{path}: too short for a safetensors header")
    (n,) = struct.unpack("<Q", buf[:8])
    base = 8 + n
    if base > len(buf):
        raise ValueError(f"{path}: header length {n} past the file's end")
    header = json.loads(buf[8:base].decode("utf-8"))
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name}: dtype {info['dtype']!r} is "
                             "not supported")
        begin, end = (int(x) for x in info["data_offsets"])
        shape = [int(s) for s in info["shape"]]
        itemsize = torch.empty((), dtype=dtype).element_size()
        count = 1
        for s in shape:
            count *= s
        if end - begin != count * itemsize or base + end > len(buf):
            raise ValueError(f"{path}: {name}: data_offsets {begin}-{end} "
                             f"do not hold {shape} {info['dtype']}")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        out[name] = torch.frombuffer(buf, dtype=dtype, count=count,
                                     offset=base + begin).reshape(
                                         shape).clone()
    return out


def write_safetensors(path: str, tensors: Mapping[str, torch.Tensor],
                      metadata: Optional[Mapping[str, str]] = None) -> None:
    """``tensors`` as one ``.safetensors`` file (the layout
    :func:`read_safetensors` reads and ``save_pretrained`` writes)."""
    header: Dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = dict(metadata)
    blobs = []
    offset = 0
    for name in sorted(tensors):
        t = tensors[name].detach().cpu().contiguous()
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes() \
            if t.numel() else b""
        header[name] = {"dtype": _DTYPE_NAMES[t.dtype],
                        "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header, separators=(",", ":")).encode("utf-8")
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in blobs:
            f.write(raw)


def read_hf_weights(path: str) -> Dict[str, torch.Tensor]:
    """A HuggingFace directory's ``state_dict``: ``model.safetensors``
    first, else ``pytorch_model.bin`` (a sharded checkpoint raises)."""
    single = os.path.join(path, "model.safetensors")
    binary = os.path.join(path, "pytorch_model.bin")
    if os.path.exists(single):
        return read_safetensors(single)
    if os.path.exists(binary):
        return torch.load(binary, map_location="cpu", weights_only=True)
    raise FileNotFoundError(
        f"no weights under {path!r} (want model.safetensors or "
        "pytorch_model.bin)")


def encoder_config_from_hf(hf_cfg: Mapping[str, Any],
                           **overrides) -> EncoderConfig:
    """:class:`EncoderConfig` from a RoBERTa ``config.json`` (a dict).

    ``overrides`` pass through runtime choices the checkpoint does not
    fix (``attention_impl`` etc.). ``gelu_approximate`` defaults to
    False: an HF checkpoint was trained with the exact erf gelu.
    """
    cfg = dict(_HF_DEFAULTS, **hf_cfg)
    if cfg["hidden_act"] != "gelu":
        raise ValueError(f"hidden_act {cfg['hidden_act']!r}: the encoder "
                         "computes gelu")
    if cfg["position_embedding_type"] != "absolute":
        raise ValueError(f"position_embedding_type "
                         f"{cfg['position_embedding_type']!r}: the encoder "
                         "has absolute positions")
    overrides.setdefault("gelu_approximate", False)
    return EncoderConfig(
        vocab_size=cfg["vocab_size"],
        hidden_size=cfg["hidden_size"],
        num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        intermediate_size=cfg["intermediate_size"],
        max_position_embeddings=cfg["max_position_embeddings"],
        type_vocab_size=cfg["type_vocab_size"],
        pad_token_id=cfg["pad_token_id"],
        layer_norm_eps=cfg["layer_norm_eps"],
        dropout_rate=cfg["hidden_dropout_prob"],
        **overrides,
    )


def t5_config_from_hf(hf_cfg: Mapping[str, Any], **overrides) -> T5Config:
    """:class:`T5Config` from a T5 ``config.json`` (a dict):
    ``num_decoder_layers`` falls back to ``num_layers``,
    ``relative_attention_max_distance`` to 128, and the FFN is gated
    when ``feed_forward_proj`` says so. ``overrides`` replace fields
    after the checkpoint's (``dropout_rate`` etc.)."""
    cfg = dict(_HF_T5_DEFAULTS, **hf_cfg)
    if cfg["feed_forward_proj"] not in _T5_FFNS:
        raise ValueError(f"feed_forward_proj {cfg['feed_forward_proj']!r}: "
                         f"the T5 stack computes {list(_T5_FFNS)}")
    if cfg["decoder_start_token_id"] is None:
        raise ValueError("config.json has no decoder_start_token_id: the "
                         "decoder's inputs need one")
    fields = dict(
        vocab_size=cfg["vocab_size"],
        d_model=cfg["d_model"],
        d_kv=cfg["d_kv"],
        d_ff=cfg["d_ff"],
        num_layers=cfg["num_layers"],
        num_decoder_layers=cfg["num_decoder_layers"] or cfg["num_layers"],
        num_heads=cfg["num_heads"],
        relative_attention_num_buckets=cfg["relative_attention_num_buckets"],
        relative_attention_max_distance=(
            cfg["relative_attention_max_distance"] or 128),
        dropout_rate=cfg["dropout_rate"],
        layer_norm_epsilon=cfg["layer_norm_epsilon"],
        gated_ffn="gated" in cfg["feed_forward_proj"],
        pad_token_id=cfg["pad_token_id"],
        eos_token_id=cfg["eos_token_id"],
        decoder_start_token_id=cfg["decoder_start_token_id"],
        tie_word_embeddings=cfg["tie_word_embeddings"],
    )
    fields.update(overrides)
    return T5Config(**fields)


def load_pretrained(path: str, map_location=None, **config_overrides
                    ) -> Tuple[str, Any, Dict[str, torch.Tensor]]:
    """Load a HuggingFace checkpoint directory.

    Returns ``(kind, config, params)``: ``"roberta"``, its
    :class:`EncoderConfig` and a ``RobertaEncoder`` ``state_dict``; or
    ``"t5"``, its :class:`T5Config` and a ``T5Model`` ``state_dict``
    (f32, on ``map_location``, the CPU by default).
    """
    with open(os.path.join(path, "config.json")) as f:
        hf_cfg = json.load(f)
    kind = hf_cfg.get("model_type")
    if kind not in ("roberta", "t5"):
        raise ValueError(f"unsupported model_type {kind!r} in {path} "
                         "(supported: t5, roberta)")
    if kind == "t5":
        cfg = t5_config_from_hf(hf_cfg, **config_overrides)
    else:
        cfg = encoder_config_from_hf(hf_cfg, **config_overrides)
    state = {k: (v.float() if v.is_floating_point() else v)
             for k, v in read_hf_weights(path).items()}
    params = (t5_from_hf(state, cfg) if kind == "t5"
              else roberta_from_hf(state))
    if map_location is not None:
        params = {k: v.to(map_location) for k, v in params.items()}
    return kind, cfg, params
