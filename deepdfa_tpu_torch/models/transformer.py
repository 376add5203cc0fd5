"""RoBERTa-compatible transformer encoder (port of
``deepdfa_tpu/models/transformer.py``).

Post-LN BERT encoder: embeddings = word + learned positions (RoBERTa's
``cumsum(mask) * mask + pad_id``, clamped to the table) + token type,
LayerNorm; N layers of multi-head attention + FFN (gelu), residual and
post-LayerNorm each. Parameters follow the flax tree's names
(``word_embeddings.embedding``, ``layer.{i}.attention.query``, ...,
``layer.{i}.output_ln``) with torch's ``Linear``/``LayerNorm`` layout;
``models/convert.py`` carries a flax tree or a HuggingFace RoBERTa
``state_dict`` across. Random init follows flax's initializers (lecun
normal kernels, zero biases, variance-scaling embeddings, unit
LayerNorm scales) from an explicit ``torch.Generator``.

``attention_impl``: "dense" (the reference's -1e9 bias softmax, with
attention-probability dropout, and the only one that returns weights),
"blockwise", "flash" or "auto" (``ops/attention.py``: the flash kernels
on the card, their plain versions on the CPU). As in the reference, the
non-dense paths apply no attention-probability dropout. "ring" waits for
the several-GPU slice.

Dropout draws from a CPU ``torch.Generator`` passed to ``forward``: each
layer (and the embeddings) takes one seed from it and runs its dropouts
on a generator of its own device seeded with it, so a rematerialized
layer (``remat_layers``, ``torch.utils.checkpoint``) replays the same
masks. Without a generator, dropout uses torch's default one.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from deepdfa_tpu_torch.models.flowgnn import EmbedTable, _linear
from deepdfa_tpu_torch.ops.attention import attention


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """codebert-base / unixcoder-base shape by default (field for field
    the reference's, pinned by tests/test_torch_linevul.py).
    ``gelu_approximate`` True is the tanh form (the fit-text default);
    HuggingFace RoBERTa numerics need False."""

    vocab_size: int = 50265
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 514
    type_vocab_size: int = 1
    gelu_approximate: bool = True
    pad_token_id: int = 1
    layer_norm_eps: float = 1e-5
    dropout_rate: float = 0.1
    dtype: str = "float32"
    attention_impl: str = "dense"
    seq_axis: str = "seq"
    remat_layers: bool = False

    @classmethod
    def tiny(cls, vocab_size: int = 128) -> "EncoderConfig":
        return cls(vocab_size=vocab_size, hidden_size=32, num_layers=2,
                   num_heads=4, intermediate_size=64,
                   max_position_embeddings=66)

    @classmethod
    def codebert_base(cls) -> "EncoderConfig":
        """microsoft/codebert-base, the LineVul backbone."""
        return cls()

    @classmethod
    def unixcoder_base(cls) -> "EncoderConfig":
        """microsoft/unixcoder-base: the same encoder with a longer
        position table."""
        return cls(vocab_size=51416, max_position_embeddings=1026)


def dropout(x: torch.Tensor, rate: float, active: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``Dropout``: keep with probability ``1 - rate``, scale kept
    entries by ``1 / (1 - rate)``."""
    if not active or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device,
                      dtype=x.dtype) >= rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


def draw_seed(seeds: Optional[torch.Generator]) -> Optional[int]:
    """One seed drawn from the CPU generator ``seeds`` (None without
    one); :func:`seeded` turns it into a generator on a device."""
    if seeds is None:
        return None
    return int(torch.randint(0, 2 ** 62, (), generator=seeds))


def seeded(seed: Optional[int], device: torch.device
           ) -> Optional[torch.Generator]:
    if seed is None:
        return None
    return torch.Generator(device=device).manual_seed(seed)


class SelfAttention(nn.Module):
    def __init__(self, cfg: EncoderConfig, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        w = cfg.hidden_size
        self.query = _linear(w, w, gen)
        self.key = _linear(w, w, gen)
        self.value = _linear(w, w, gen)

    def forward(self, x: torch.Tensor, attn_mask: torch.Tensor,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        c = self.cfg
        b, t, _ = x.shape
        hd = c.hidden_size // c.num_heads

        def split(y):
            return y.view(b, t, c.num_heads, hd)

        q, k, v = split(self.query(x)), split(self.key(x)), split(self.value(x))
        weights = None
        if c.attention_impl == "dense":
            scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
            bias = torch.where(attn_mask[:, None, None, :], 0.0, -1e9)
            weights = torch.softmax(scores + bias, dim=-1)
            weights = dropout(weights, c.dropout_rate, not deterministic,
                              generator)
            out = torch.einsum("bhqk,bkhd->bqhd", weights, v)
        elif c.attention_impl in ("blockwise", "flash", "auto"):
            out = attention(q, k, v, kv_mask=attn_mask,
                            impl=c.attention_impl)
        elif c.attention_impl == "ring":
            raise NotImplementedError(
                "attention_impl='ring' is not ported yet (several GPUs)")
        else:
            raise ValueError(f"unknown attention_impl {c.attention_impl!r}")
        return out.reshape(b, t, c.hidden_size), weights


class EncoderLayer(nn.Module):
    def __init__(self, cfg: EncoderConfig, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        w, f = cfg.hidden_size, cfg.intermediate_size
        self.attention = SelfAttention(cfg, gen)
        self.attention_output = _linear(w, w, gen)
        self.attention_ln = nn.LayerNorm(w, eps=cfg.layer_norm_eps)
        self.intermediate = _linear(w, f, gen)
        self.output = _linear(f, w, gen)
        self.output_ln = nn.LayerNorm(w, eps=cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor, attn_mask: torch.Tensor,
                deterministic: bool = True, seed: Optional[int] = None):
        c = self.cfg
        gen = seeded(seed, x.device)
        active = not deterministic
        attn_out, weights = self.attention(x, attn_mask, deterministic, gen)
        attn_out = dropout(self.attention_output(attn_out), c.dropout_rate,
                           active, gen)
        x = self.attention_ln(x + attn_out)
        ff = F.gelu(self.intermediate(x),
                    approximate="tanh" if c.gelu_approximate else "none")
        ff = dropout(self.output(ff), c.dropout_rate, active, gen)
        return self.output_ln(x + ff), weights


class RobertaEncoder(nn.Module):
    """``forward`` returns ``(last_hidden_state, attentions)``;
    ``output_attentions`` needs ``attention_impl="dense"``."""

    def __init__(self, cfg: EncoderConfig, gen: torch.Generator):
        super().__init__()
        if cfg.dtype != "float32":
            raise NotImplementedError(
                f"dtype {cfg.dtype!r}: the port's encoder is float32 only; "
                "bf16 kernels are not ported yet")
        self.cfg = cfg
        w = cfg.hidden_size
        self.word_embeddings = EmbedTable(cfg.vocab_size, w, gen)
        self.position_embeddings = EmbedTable(cfg.max_position_embeddings, w,
                                              gen)
        self.token_type_embeddings = EmbedTable(cfg.type_vocab_size, w, gen)
        self.embeddings_ln = nn.LayerNorm(w, eps=cfg.layer_norm_eps)
        self.layer = nn.ModuleList(EncoderLayer(cfg, gen)
                                   for _ in range(cfg.num_layers))

    def forward(self, input_ids: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None,
                deterministic: bool = True, output_attentions: bool = False,
                input_embeds: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
        """``input_embeds`` ([B, T, hidden]) replaces the word-embedding
        lookup (the attribution hook). ``generator``: the CPU generator
        dropout seeds come from (``deterministic=False`` only)."""
        c = self.cfg
        if attn_mask is None:
            attn_mask = input_ids != c.pad_token_id
        word = (self.word_embeddings(input_ids) if input_embeds is None
                else input_embeds)
        # RoBERTa position ids: pads stay at pad_id, tokens count up from
        # pad_id + 1; ids past the table clamp to its last entry (an
        # out-of-range index is a device assert on CUDA, and the 4096-token
        # shape rides the 514-entry table).
        m = attn_mask.to(torch.int64)
        positions = torch.cumsum(m, dim=1) * m + c.pad_token_id
        positions = torch.clamp(positions, max=c.max_position_embeddings - 1)
        x = (word + self.position_embeddings(positions)
             + self.token_type_embeddings(torch.zeros_like(input_ids)))
        x = self.embeddings_ln(x)
        active = not deterministic and c.dropout_rate > 0.0
        dev = x.device
        x = dropout(x, c.dropout_rate, active,
                    seeded(draw_seed(generator) if active else None, dev))
        if output_attentions and c.attention_impl != "dense":
            raise ValueError("output_attentions needs attention_impl='dense'; "
                             f"got {c.attention_impl!r}")
        remat = c.remat_layers and not output_attentions
        attentions = []
        for layer in self.layer:
            seed = draw_seed(generator) if active else None
            if remat:
                x, weights = checkpoint(layer, x, attn_mask, deterministic,
                                        seed, use_reentrant=False)
            else:
                x, weights = layer(x, attn_mask, deterministic, seed)
            if output_attentions:
                attentions.append(weights)
        return x, tuple(attentions)
