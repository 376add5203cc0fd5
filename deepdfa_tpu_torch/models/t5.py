"""The T5 encoder-decoder and the CodeT5 defect classifier (port of
``deepdfa_tpu/models/t5.py``, the non-decoding half).

T5 v1.0, the codet5 architecture:

- RMS LayerNorm (no centering, no bias; the variance in f32), pre-LN
  residual blocks.
- Attention projections without bias and no ``1/sqrt(d_kv)`` score
  scaling (the init compensates for it).
- A bucketed relative position bias, computed by the first block of
  each stack and passed to the others: bidirectional in the encoder,
  causal in the decoder, none on cross-attention.
- The FFN relu (``wi``/``wo``) or gated gelu (``wi_0``/``wi_1``, tanh
  gelu, v1.1).
- Tied input/output embeddings, the logits scaled by ``d_model**-0.5``.

``DefectModel`` is the reference's CodeT5 defect classifier: the whole
encoder-decoder over ``shift_right(source_ids)`` with the source mask as
the decoder's mask, the last decoder hidden state at each row's last
``</s>``, optionally concatenated with the pooled FlowGNN embedding
(``FlowGNNConfig(encoder_mode=True)``: DeepDFA+CodeT5), then one linear
to 2 logits. Its ``forward`` takes the arguments of ``LineVul.forward``,
so ``train/text_loop.py`` trains either.

Attention is plain PyTorch (``matmul`` and softmax): the reference
computes it as an ``einsum`` outside any Pallas kernel, and its additive
position bias is not an input of the port's flash kernels. A combined
model's graph encoder runs the hand kernels of ``ops/fused_gnn.py`` or
``ops/tile_spmm.py`` as ``FlowGNN`` does.

Parameters follow the flax tree's names (``shared.embedding``,
``encoder.block.{i}.self_attn.{q,k,v,o}``, ``...relative_attention_bias``
in block 0, ``self_attn_ln``, ``cross_attn_ln``, ``cross_attn``,
``ffn_ln``, ``ffn.{wi,wi_0,wi_1,wo}``, ``final_ln``) with torch's
``Linear`` layout; ``models/convert.py`` carries a flax tree or a
HuggingFace T5 ``state_dict`` across. Random init follows the
reference's flax initializers from an explicit CPU ``torch.Generator``.
Dropout draws one seed a stack piece from the CPU generator passed to
``forward`` and runs on a generator of the tensor's own device, as
``models/transformer.py`` does.

Not ported yet: incremental decoding (``decode=True``, the decode
cache, beam ancestry), generation and ``CloneModel``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from deepdfa_tpu_torch.core.config import FlowGNNConfig
from deepdfa_tpu_torch.core.device import DeviceLike, resolve_device
from deepdfa_tpu_torch.graphs.batch import GraphBatch
from deepdfa_tpu_torch.models.flowgnn import EmbedTable, FlowGNN, _linear
from deepdfa_tpu_torch.models.transformer import draw_seed, dropout, seeded

_DECODE_NOT_PORTED = ("incremental decoding (decode=True, beam_anc) is not "
                      "ported yet: it comes with generation (ROADMAP A5b)")


@dataclasses.dataclass(frozen=True)
class T5Config:
    """Salesforce codet5-base shape by default (field for field the
    reference's). ``decode_cache_layout`` is read by incremental
    decoding, which is not ported yet."""

    vocab_size: int = 32100
    d_model: int = 768
    d_kv: int = 64
    d_ff: int = 3072
    num_layers: int = 12
    num_decoder_layers: int = 12
    num_heads: int = 12
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    dropout_rate: float = 0.1
    layer_norm_epsilon: float = 1e-6
    gated_ffn: bool = False  # False: relu (v1.0, codet5); True: gated gelu
    pad_token_id: int = 0
    eos_token_id: int = 2
    decoder_start_token_id: int = 0
    tie_word_embeddings: bool = True
    dtype: str = "float32"
    decode_cache_layout: str = "split"

    @classmethod
    def tiny(cls, vocab_size: int = 128) -> "T5Config":
        return cls(vocab_size=vocab_size, d_model=32, d_kv=8, d_ff=64,
                   num_layers=2, num_decoder_layers=2, num_heads=4)

    @classmethod
    def codet5_small(cls) -> "T5Config":
        return cls(d_model=512, d_kv=64, d_ff=2048, num_layers=6,
                   num_decoder_layers=6, num_heads=8)

    @classmethod
    def codet5_base(cls) -> "T5Config":
        return cls()

    @classmethod
    def codet5_large(cls) -> "T5Config":
        return cls(d_model=1024, d_kv=64, d_ff=4096, num_layers=24,
                   num_decoder_layers=24, num_heads=16)


def _normal_linear(n_in: int, n_out: int, std: float,
                   gen: torch.Generator) -> nn.Linear:
    """A bias-free Linear with flax ``normal(std)`` weights."""
    lin = nn.Linear(n_in, n_out, bias=False)
    with torch.no_grad():
        lin.weight.copy_(torch.randn((n_out, n_in), generator=gen) * std)
    return lin


class T5LayerNorm(nn.Module):
    """RMS norm: ``x * rsqrt(mean(x^2) + eps) * weight``, the variance
    in f32."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var = x.float().square().mean(dim=-1, keepdim=True)
        return (x * torch.rsqrt(var + self.eps)).to(x.dtype) * self.weight


def relative_position_bucket(relative_position: torch.Tensor,
                             bidirectional: bool, num_buckets: int,
                             max_distance: int) -> torch.Tensor:
    """T5's log-bucketed relative positions (memory - query), int32.

    The reference's formula, not HuggingFace's: the f32 log takes
    ``n / max_exact + 1e-6``, and the quotient truncates toward zero."""
    rel = relative_position.to(torch.int32)
    ret = torch.zeros_like(rel)
    n = -rel
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n < 0).to(torch.int32) * num_buckets
        n = n.abs()
    else:
        n = torch.clamp(n, min=0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    scale = torch.tensor(math.log(max_distance / max_exact),
                         dtype=torch.float32)
    val_if_large = max_exact + (
        torch.log(n.to(torch.float32) / max_exact + 1e-6) / scale
        * (num_buckets - max_exact)).to(torch.int32)
    val_if_large = torch.clamp(val_if_large, max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_if_large)


@functools.lru_cache(maxsize=64)
def _bucket_grid(q_len: int, k_len: int, bidirectional: bool,
                 num_buckets: int, max_distance: int,
                 device: torch.device) -> torch.Tensor:
    """The [q_len, k_len] bucket ids (int64 on ``device``), computed on
    the CPU once for each shape: every device indexes the same buckets
    the CPU tests hold against the reference."""
    ctx = torch.arange(q_len)[:, None]
    mem = torch.arange(k_len)[None, :]
    buckets = relative_position_bucket(mem - ctx, bidirectional,
                                       num_buckets, max_distance)
    return buckets.long().to(device)


class T5Attention(nn.Module):
    """Multi-head attention without bias or score scaling; block 0 of a
    stack owns the relative position bias table."""

    def __init__(self, cfg: T5Config, gen: torch.Generator,
                 causal: bool = False, has_relative_bias: bool = False):
        super().__init__()
        self.cfg = cfg
        self.causal = causal
        self.has_relative_bias = has_relative_bias
        inner = cfg.num_heads * cfg.d_kv
        # T5's factor-1.0 init stands in for the missing 1/sqrt(d_kv)
        # score scaling.
        self.q = _normal_linear(cfg.d_model, inner,
                                (cfg.d_model * cfg.d_kv) ** -0.5, gen)
        self.k = _normal_linear(cfg.d_model, inner, cfg.d_model ** -0.5, gen)
        self.v = _normal_linear(cfg.d_model, inner, cfg.d_model ** -0.5, gen)
        if has_relative_bias:
            self.relative_attention_bias = nn.Parameter(
                torch.randn((cfg.relative_attention_num_buckets,
                             cfg.num_heads), generator=gen)
                * cfg.d_model ** -0.5)
        self.o = _normal_linear(inner, cfg.d_model, inner ** -0.5, gen)

    def rel_bias(self, q_len: int, k_len: int) -> torch.Tensor:
        """[1, H, q_len, k_len] from the bucket table."""
        c = self.cfg
        buckets = _bucket_grid(q_len, k_len, not self.causal,
                               c.relative_attention_num_buckets,
                               c.relative_attention_max_distance,
                               self.relative_attention_bias.device)
        return F.embedding(buckets, self.relative_attention_bias).permute(
            2, 0, 1)[None]

    def forward(self, x: torch.Tensor, kv: Optional[torch.Tensor],
                mask: Optional[torch.Tensor],
                position_bias: Optional[torch.Tensor],
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(output [B, Q, d_model], the position bias used). ``mask``
        [B or 1, 1, Q, K] bool: True keeps a key."""
        c = self.cfg
        kv = x if kv is None else kv
        b, q_len, _ = x.shape
        k_len = kv.shape[1]

        def heads(y, t):
            return y.view(b, t, c.num_heads, c.d_kv).transpose(1, 2)

        q = heads(self.q(x), q_len)
        k = heads(self.k(kv), k_len)
        v = heads(self.v(kv), k_len)
        scores = torch.matmul(q, k.transpose(-1, -2))  # no sqrt(d_kv)
        if position_bias is None and self.has_relative_bias:
            position_bias = self.rel_bias(q_len, k_len)
        if position_bias is not None:
            scores = scores + position_bias
        if mask is not None:
            # -1e9, not -inf: an all-pad row stays finite and uniform.
            scores = scores + torch.where(mask, 0.0, -1e9)
        weights = torch.softmax(scores.float(), dim=-1).to(scores.dtype)
        weights = dropout(weights, c.dropout_rate, not deterministic,
                          generator)
        out = torch.matmul(weights, v).transpose(1, 2).reshape(
            b, q_len, c.num_heads * c.d_kv)
        return self.o(out), position_bias


class T5FFN(nn.Module):
    def __init__(self, cfg: T5Config, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        std_in, std_out = cfg.d_model ** -0.5, cfg.d_ff ** -0.5
        if cfg.gated_ffn:
            self.wi_0 = _normal_linear(cfg.d_model, cfg.d_ff, std_in, gen)
            self.wi_1 = _normal_linear(cfg.d_model, cfg.d_ff, std_in, gen)
        else:
            self.wi = _normal_linear(cfg.d_model, cfg.d_ff, std_in, gen)
        self.wo = _normal_linear(cfg.d_ff, cfg.d_model, std_out, gen)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.cfg.gated_ffn:
            # flax's nn.gelu: the tanh form.
            h = F.gelu(self.wi_0(x), approximate="tanh") * self.wi_1(x)
        else:
            h = F.relu(self.wi(x))
        h = dropout(h, self.cfg.dropout_rate, not deterministic, generator)
        return self.wo(h)


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, gen: torch.Generator,
                 causal: bool = False, has_relative_bias: bool = False,
                 has_cross_attention: bool = False):
        super().__init__()
        self.cfg = cfg
        eps = cfg.layer_norm_epsilon
        self.self_attn_ln = T5LayerNorm(cfg.d_model, eps)
        self.self_attn = T5Attention(cfg, gen, causal=causal,
                                     has_relative_bias=has_relative_bias)
        self.has_cross_attention = has_cross_attention
        if has_cross_attention:
            self.cross_attn_ln = T5LayerNorm(cfg.d_model, eps)
            self.cross_attn = T5Attention(cfg, gen)
        self.ffn_ln = T5LayerNorm(cfg.d_model, eps)
        self.ffn = T5FFN(cfg, gen)

    def forward(self, x: torch.Tensor, self_mask: torch.Tensor,
                position_bias: Optional[torch.Tensor],
                enc_out: Optional[torch.Tensor] = None,
                cross_mask: Optional[torch.Tensor] = None,
                deterministic: bool = True, seed: Optional[int] = None):
        rate = self.cfg.dropout_rate
        active = not deterministic
        gen = seeded(seed, x.device)
        attn, position_bias = self.self_attn(
            self.self_attn_ln(x), None, self_mask, position_bias,
            deterministic, gen)
        x = x + dropout(attn, rate, active, gen)
        if self.has_cross_attention:
            attn, _ = self.cross_attn(self.cross_attn_ln(x), enc_out,
                                      cross_mask, None, deterministic, gen)
            x = x + dropout(attn, rate, active, gen)
        ff = self.ffn(self.ffn_ln(x), deterministic, gen)
        return x + dropout(ff, rate, active, gen), position_bias


class T5Stack(nn.Module):
    """The encoder (``causal=False``) or the decoder (causal, with
    cross-attention)."""

    def __init__(self, cfg: T5Config, gen: torch.Generator,
                 causal: bool = False, num_layers: int = 12):
        super().__init__()
        self.cfg = cfg
        self.causal = causal
        self.block = nn.ModuleList(
            T5Block(cfg, gen, causal=causal, has_relative_bias=(i == 0),
                    has_cross_attention=causal)
            for i in range(num_layers))
        self.final_ln = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon)

    def forward(self, embeds: torch.Tensor, attn_mask: torch.Tensor,
                enc_out: Optional[torch.Tensor] = None,
                enc_mask: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                decode: bool = False, beam_anc=None) -> torch.Tensor:
        """``decode``/``beam_anc`` (incremental decoding) raise: not
        ported yet."""
        if decode or beam_anc is not None:
            raise NotImplementedError(_DECODE_NOT_PORTED)
        c = self.cfg
        q_len = embeds.shape[1]
        dev = embeds.device
        # [B, 1, Q, K]; the decoder adds the causal triangle.
        self_mask = attn_mask[:, None, None, :]
        if self.causal:
            tril = torch.tril(torch.ones((q_len, q_len), dtype=torch.bool,
                                         device=dev))
            self_mask = self_mask & tril[None, None]
        cross_mask = None
        if enc_out is not None and enc_mask is not None:
            cross_mask = enc_mask[:, None, None, :]
        active = not deterministic and c.dropout_rate > 0.0

        def seed():
            return draw_seed(generator) if active else None

        x = dropout(embeds, c.dropout_rate, active, seeded(seed(), dev))
        position_bias = None
        for block in self.block:
            x, position_bias = block(x, self_mask, position_bias, enc_out,
                                     cross_mask, deterministic, seed())
        x = self.final_ln(x)
        return dropout(x, c.dropout_rate, active, seeded(seed(), dev))


def shift_right(ids: torch.Tensor, decoder_start_token_id: int
                ) -> torch.Tensor:
    """Decoder inputs for ``labels=source_ids``: the ids shifted right,
    the start token first."""
    return torch.cat([torch.full_like(ids[:, :1], decoder_start_token_id),
                      ids[:, :-1]], dim=1)


class T5Model(nn.Module):
    """The encoder-decoder: ``forward`` returns the last decoder hidden
    state; ``logits`` maps it to the vocabulary."""

    def __init__(self, cfg: T5Config, device: DeviceLike = None,
                 seed: int = 0, generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.dtype != "float32":
            raise NotImplementedError(
                f"dtype {cfg.dtype!r}: the port's T5 is float32 only; bf16 "
                "kernels are not ported yet")
        dev = resolve_device(device)
        gen = generator if generator is not None else (
            torch.Generator().manual_seed(seed))
        self.cfg = cfg
        self.shared = EmbedTable(cfg.vocab_size, cfg.d_model, gen)
        self.encoder = T5Stack(cfg, gen, causal=False,
                               num_layers=cfg.num_layers)
        self.decoder = T5Stack(cfg, gen, causal=True,
                               num_layers=cfg.num_decoder_layers)
        if not cfg.tie_word_embeddings:
            self.lm_head = _linear(cfg.d_model, cfg.vocab_size, gen,
                                   bias=False)
        self.to(dev)

    def encode(self, input_ids: torch.Tensor, attn_mask: torch.Tensor,
               deterministic: bool = True,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.encoder(self.shared(input_ids), attn_mask,
                            deterministic=deterministic, generator=generator)

    def decode(self, decoder_input_ids: torch.Tensor,
               decoder_mask: torch.Tensor, enc_out: torch.Tensor,
               enc_mask: torch.Tensor, deterministic: bool = True,
               generator: Optional[torch.Generator] = None,
               decode: bool = False, beam_anc=None) -> torch.Tensor:
        return self.decoder(self.shared(decoder_input_ids), decoder_mask,
                            enc_out, enc_mask, deterministic=deterministic,
                            generator=generator, decode=decode,
                            beam_anc=beam_anc)

    def logits(self, decoder_hidden: torch.Tensor) -> torch.Tensor:
        if self.cfg.tie_word_embeddings:
            # T5 scales tied-embedding logits by d_model**-0.5.
            return (decoder_hidden * (self.cfg.d_model ** -0.5)
                    ) @ self.shared.embedding.T
        return self.lm_head(decoder_hidden)

    def forward(self, input_ids: torch.Tensor,
                decoder_input_ids: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None,
                decoder_mask: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator``: the CPU generator dropout seeds come from
        (``deterministic=False`` only); the encoder draws first."""
        if attn_mask is None:
            attn_mask = input_ids != self.cfg.pad_token_id
        if decoder_mask is None:
            decoder_mask = torch.ones_like(decoder_input_ids,
                                           dtype=torch.bool)
        enc_out = self.encode(input_ids, attn_mask, deterministic, generator)
        return self.decode(decoder_input_ids, decoder_mask, enc_out,
                           attn_mask, deterministic, generator)


def last_eos_vector(hidden: torch.Tensor, source_ids: torch.Tensor,
                    eos_token_id: int) -> torch.Tensor:
    """Each row's hidden state at its last ``eos`` position; a row with
    no eos takes position 0 (the reference filters such rows upstream)."""
    eos = source_ids == eos_token_id
    positions = torch.arange(source_ids.shape[1],
                             device=source_ids.device)[None, :]
    last = torch.where(eos, positions, 0).amax(dim=1)
    rows = torch.arange(source_ids.shape[0], device=source_ids.device)
    return hidden[rows, last]


class DefectModel(nn.Module):
    """The CodeT5 defect classifier. ``graph_config`` None: CodeT5;
    set (with ``encoder_mode=True``): DeepDFA+CodeT5 combined."""

    def __init__(self, cfg: T5Config,
                 graph_config: Optional[FlowGNNConfig] = None,
                 device: DeviceLike = None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.cfg = cfg
        self.graph_config = graph_config
        self.t5 = T5Model(cfg, device="cpu", generator=gen)
        extra = 0
        if graph_config is not None:
            if not graph_config.encoder_mode:
                raise ValueError("graph_config must set encoder_mode")
            self.flowgnn = FlowGNN(graph_config, device="cpu", generator=gen)
            extra = graph_config.out_dim
        self.classifier = _linear(cfg.d_model + extra, 2, gen)
        self.to(dev)

    @property
    def pad_token_id(self) -> int:
        return self.cfg.pad_token_id

    def forward(self, input_ids: torch.Tensor,
                graphs: Optional[GraphBatch] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Logits [B, 2]. ``generator``: the CPU generator dropout seeds
        come from."""
        c = self.cfg
        attn_mask = input_ids != c.pad_token_id
        dec_in = shift_right(input_ids, c.decoder_start_token_id)
        # The reference passes the source mask as the decoder's mask too.
        hidden = self.t5(input_ids, dec_in, attn_mask=attn_mask,
                         decoder_mask=attn_mask,
                         deterministic=deterministic, generator=generator)
        vec = last_eos_vector(hidden, input_ids, c.eos_token_id)
        if self.graph_config is not None:
            if graphs is None:
                raise ValueError("the combined model needs a GraphBatch")
            vec = torch.cat([vec, self.flowgnn(graphs)], dim=-1)
        return self.classifier(vec)
