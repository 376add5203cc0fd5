"""FlowGNN as a PyTorch module (port of ``deepdfa_tpu/models/flowgnn.py``).

Per-subkey embedding tables (concatenated to width 4 * hidden_dim), then
``n_steps`` weight-shared gated message-passing steps, a skip-concat of
the GGNN output with the embedding, masked attention pooling per graph,
and an MLP head.

Parameters follow the flax tree's names (``embeds.{key}.embedding``,
``ggnn_step.edge_linear``, ``ggnn_step.gru.{ir,iz,in,hr,hz,hn}``,
``pooling.gate``, ``head.output_{i}``) with torch's ``Linear`` layout;
``models/convert.py`` carries a flax tree across. Random init follows
flax's initializers (variance-scaling embeddings, lecun-normal dense
kernels, orthogonal recurrent kernels, zero biases) from an explicit
``torch.Generator``.

``message_impl``: "segment" and "band" are plain PyTorch on any device;
"tile" aggregates with ``ops.tile_spmm.tile_spmm`` each step, "fused"
runs ``ops.fused_gnn.fused_gate_step`` per step and "persistent" runs
``ops.fused_gnn.persistent_unroll`` once — the CUDA kernels on the card,
their plain versions on the CPU. Under autograd the kernels run through
``torch.autograd.Function``s whose backwards are CUDA kernels too (the
tile lane's is the same kernel over A^T); under
``torch.inference_mode()`` or ``no_grad`` only the forward kernels
launch. A persistent batch whose row groups exceed the kernel's
shared memory (the backward's larger gate when a gradient is needed)
runs the fused kernel per step instead, counted in
``FlowGNN.over_gate_dispatches``.

``dtype="bfloat16"`` (``FlowGNNConfig.dtype``; the reference's TPU
flagship): the parameters stay f32; the embeddings, messages, GRU,
skip-concat and pooling compute in bf16 at the reference's rounding
points (each Dense rounds its product, then its bias add; each
elementwise op of the GRU rounds; the explicit casts of ``_dense`` and
``ops/fused_gnn.py``'s bf16 helpers, not ``torch.autocast``); the head
takes the pooled bf16 rows widened and gives f32 logits. The fused and
persistent lanes launch the kernels' bf16 instances on the card. Training
at bf16 runs the fused and persistent lanes' backward instances (their
VJPs, the reference's custom VJPs, on the CPU too:
``ops/fused_gnn._FusedStep`` and ``_PersistentUnroll``), the tile
product's and autograd of the segment and band lanes, with the parameters
f32 masters.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from deepdfa_tpu_torch.core.config import FlowGNNConfig, subkeys_for
from deepdfa_tpu_torch.core.device import DeviceLike, resolve_device
from deepdfa_tpu_torch.graphs.batch import GraphBatch
from deepdfa_tpu_torch.graphs.segment import (
    SegmentPlan,
    segment_onehot,
    segment_softmax,
    segment_sum,
    segment_sum_plan,
    segment_sum_rows,
)
from deepdfa_tpu_torch.ops import count_launch, fused_gnn
from deepdfa_tpu_torch.ops.band_spmm import band_spmm
from deepdfa_tpu_torch.ops.tile_spmm import tile_spmm

# flax's truncated normal keeps |x| <= 2 sigma and rescales the stddev by
# this constant so the truncated draw has the intended variance.
_TRUNC_STD = 0.87962566103423978


def _trunc_normal_(t: torch.Tensor, std: float,
                   gen: torch.Generator) -> torch.Tensor:
    """In place: N(0, std) truncated to +-2 sigma, redrawing outliers."""
    with torch.no_grad():
        sigma = std / _TRUNC_STD
        x = torch.randn(t.shape, generator=gen)
        bad = x.abs() > 2.0
        while bool(bad.any()):
            x[bad] = torch.randn(int(bad.sum()), generator=gen)
            bad = x.abs() > 2.0
        t.copy_(x * sigma)
    return t


def _lecun_normal_(t: torch.Tensor, fan_in: int,
                   gen: torch.Generator) -> torch.Tensor:
    return _trunc_normal_(t, math.sqrt(1.0 / fan_in), gen)


def _orthogonal_(weight: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """flax ``orthogonal()`` on the [in, out] kernel, written into a
    torch [out, in] weight."""
    n_out, n_in = weight.shape
    rows, cols = max(n_in, n_out), min(n_in, n_out)
    a = torch.randn((rows, cols), generator=gen)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    kernel = q if n_in >= n_out else q.T  # [in, out]
    with torch.no_grad():
        weight.copy_(kernel.T)
    return weight


def _linear(n_in: int, n_out: int, gen: torch.Generator, bias: bool = True,
            init: str = "lecun") -> nn.Linear:
    lin = nn.Linear(n_in, n_out, bias=bias)
    if init == "orthogonal":
        _orthogonal_(lin.weight, gen)
    else:
        _lecun_normal_(lin.weight, n_in, gen)
    if bias:
        nn.init.zeros_(lin.bias)
    return lin


class EmbedTable(nn.Module):
    """An embedding table (flax ``{name}/embedding``), looked up with a
    gather. ``F.embedding`` rather than indexing: the same forward, and
    its backward reduces the rows of each index in parallel, where
    indexing's backward walks repeated indices one by one (most nodes
    share index 0, "not a definition")."""

    def __init__(self, num: int, dim: int, gen: torch.Generator,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        # variance_scaling(1.0, "fan_in", "normal", out_axis=0): an
        # untruncated normal whose fan_in is the embedding width.
        self.embedding = nn.Parameter(
            torch.randn((num, dim), generator=gen) * math.sqrt(1.0 / dim))
        self.dtype = dtype

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        # The f32 rows, cast to the model's dtype after the lookup.
        return F.embedding(idx.long(), self.embedding).to(self.dtype)


def _dense(lin: nn.Linear, x: torch.Tensor, dtype: torch.dtype
           ) -> torch.Tensor:
    """flax ``nn.Dense(dtype=dtype)`` with f32 parameters. bf16: the
    product of the rounded input and kernel summed in f32 and rounded,
    then the rounded bias added in bf16 (XLA keeps both roundings).
    f32: ``lin(x)``."""
    if dtype == torch.float32:
        return lin(x)
    y = fused_gnn.matmul_bf16(x.to(dtype), lin.weight.T.to(dtype))
    return y if lin.bias is None else y + lin.bias.to(dtype)


class GatedGraphStep(nn.Module):
    """One gated message-passing step: ``a_v = sum_{(u,v)} W h_u + b``,
    ``h' = GRU(a, h)`` (flax ``GRUCell`` gate names and biases)."""

    def __init__(self, hidden: int, in_features: int, gen: torch.Generator,
                 message_impl: str = "segment",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.message_impl = message_impl
        self.dtype = dtype
        self.edge_linear = _linear(in_features, hidden, gen)
        self.gru = nn.ModuleDict({
            "ir": _linear(hidden, hidden, gen),
            "iz": _linear(hidden, hidden, gen),
            "in": _linear(hidden, hidden, gen),
            "hr": _linear(hidden, hidden, gen, bias=False, init="orthogonal"),
            "hz": _linear(hidden, hidden, gen, bias=False, init="orthogonal"),
            "hn": _linear(hidden, hidden, gen, init="orthogonal"),
        })

    def step_params(self) -> Dict:
        """The parameter tree in the reference's ``[in, out]`` layout (the
        kernels' input; transposed views, no copies)."""
        def dense(lin: nn.Linear) -> Dict:
            p = {"kernel": lin.weight.T}
            if lin.bias is not None:
                p["bias"] = lin.bias
            return p

        return {"edge_linear": dense(self.edge_linear),
                "gru": {k: dense(v) for k, v in self.gru.items()}}

    def _gru(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        g = self.gru
        if self.dtype == torch.bfloat16:
            # flax GRUCell(dtype=bfloat16): each Dense and each
            # elementwise op rounds to bf16.
            dt = self.dtype
            gi = torch.cat([_dense(g[k], x, dt) for k in ("ir", "iz", "in")], 1)
            gh = torch.cat([_dense(g[k], h, dt) for k in ("hr", "hz", "hn")], 1)
            return fused_gnn.gru_bf16(gi, gh, h)
        r = torch.sigmoid(g["ir"](x) + g["hr"](h))
        z = torch.sigmoid(g["iz"](x) + g["hz"](h))
        n = torch.tanh(g["in"](x) + r * g["hn"](h))
        return (1.0 - z) * n + z * h

    def forward(self, h: torch.Tensor, batch: GraphBatch,
                packed: Optional[Tuple[torch.Tensor, ...]] = None,
                plan: Optional[SegmentPlan] = None) -> torch.Tensor:
        """``packed``: the kernels' packed weights, when the caller packs
        them once for all steps (fused and persistent only). ``plan``: the
        receivers' segment-sum plan, when the caller builds it once for
        all steps (segment only)."""
        impl = self.message_impl
        if impl in ("band", "fused", "persistent") and batch.band_adj is None:
            raise ValueError(f"message_impl={impl!r} needs batch_graphs("
                             "build_band_adj=True)")
        if impl in ("fused", "persistent"):
            return fused_gnn.fused_gate_step(self.step_params(), h,
                                             batch.band_adj, packed=packed)
        if impl == "tile" and batch.tile_adj is None:
            raise ValueError(
                "message_impl='tile' needs batch_graphs(build_tile_adj=True)")
        msg = _dense(self.edge_linear, h, self.dtype)
        if impl == "tile":
            agg = tile_spmm(batch.tile_adj, msg)
        elif impl == "band":
            agg = band_spmm(batch.band_adj, msg)
        elif impl == "segment":
            gathered = msg[batch.senders.long()]
            gathered = torch.where(batch.edge_mask[:, None], gathered, 0.0)
            agg = segment_sum(gathered, batch.receivers, batch.max_nodes,
                              mask=batch.edge_mask, plan=plan)
        else:
            raise ValueError(f"message_impl {impl!r} is not ported")
        return self._gru(agg, h)


class GlobalAttentionPool(nn.Module):
    """Masked per-graph attention pooling: gate logits softmaxed over each
    graph's nodes, then a weighted node sum.

    ``impl="segment"``: scatter sums (``index_add_``). ``impl="matmul"``:
    the reference's assignment-matrix form (``pool_impl="matmul"``):
    every per-graph sum and graph-to-node broadcast is a matmul with
    :func:`segment_onehot`, and the softmax shift (each graph's largest
    logit, the segment form's values) carries no gradient. On CUDA
    ``index_add_`` adds with atomics in whatever order the threads
    arrive; the matmuls sum in one order, so a training run on the card
    repeats its bits. ``impl="auto"``: on the CPU segment; on CUDA matmul
    where a gradient flows, and otherwise (serving, evaluation) the
    matmul form with its two sums over nodes taken per graph, in one
    launch (``graphs.segment.segment_sum_rows``, each graph's rows in row
    order, found in ``node_graph`` as it is where ``node_graph_sorted``
    says that, keyed by the mask, it is non-decreasing, else through an
    index plan):
    cuBLAS groups a graph's terms by where its rows sit in the batch, so a
    served graph's probability moved by an f32 ulp with the flush that
    carried it (``scripts/torch_serve_batch_bits.py``); per graph, it is
    the same wherever the graph sits, and no step of it reads the device
    from the host, so a CUDA graph captures it.
    """

    def __init__(self, width: int, gen: torch.Generator, impl: str = "auto",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.gate = _linear(width, 1, gen)
        self.impl = impl
        self.dtype = dtype

    def forward(self, feat, node_graph, node_mask, n_graphs: int,
                node_graph_sorted: bool = False):
        gate = _dense(self.gate, feat, self.dtype)[:, 0]
        impl = self.impl
        if impl == "auto":
            if not feat.is_cuda:
                impl = "segment"
            elif torch.is_grad_enabled() and (
                    feat.requires_grad or self.gate.weight.requires_grad):
                impl = "matmul"
            else:
                impl = "rows"
        if impl == "segment":
            # At bf16 each op of the softmax rounds and the sums add row
            # by row in bf16, as XLA's (graphs/segment.py).
            weights = segment_softmax(gate, node_graph, n_graphs,
                                      mask=node_mask)
            weighted = feat * weights[:, None]
            weighted = torch.where(node_mask[:, None], weighted, 0.0)
            return segment_sum(weighted, node_graph, n_graphs)
        onehot = segment_onehot(node_graph, n_graphs, mask=node_mask)
        # The softmax weights in f32 whatever the dtype (the reference
        # widens the gate); at bf16 the weighted rows and the pooled
        # quotient round to bf16, the sums stay f32.
        gate = torch.where(node_mask, gate.float(), -torch.inf)
        with torch.no_grad():
            shift = torch.where(onehot != 0, gate[None, :],
                                -torch.inf).amax(dim=1)
            shift = torch.where(torch.isneginf(shift), 0.0, shift)
        e = torch.where(node_mask, torch.exp(gate - shift @ onehot), 0.0)
        weighted = feat * e[:, None].to(feat.dtype)
        if impl == "rows":
            # Each graph's rows in row order, the padding rows (zero
            # weights) left out: one segment_sum_rows launch for both
            # sums, which reads nothing back to the host. A contiguous
            # batch's node_graph (graph by graph, the padding after the
            # last graph, keyed past every graph by the mask) is searched
            # as it is, with no index plan.
            sums, denom = segment_sum_rows(
                (weighted.float(), e), segment_sum_plan(
                    node_graph, n_graphs, node_mask,
                    indices_are_sorted=node_graph_sorted))
        else:
            denom = onehot @ e
            sums = onehot @ weighted.float()
        denom = torch.where(denom > 0, denom, 1.0)  # empty graphs pool to 0
        return (sums / denom[:, None]).to(feat.dtype)


class FlowGNN(nn.Module):
    """The DeepDFA graph model.

    ``encoder_mode=True`` returns the pooled graph embedding of width
    ``config.out_dim``; otherwise the head gives one logit per graph
    (label_style "graph") or per node.
    """

    def __init__(self, config: FlowGNNConfig, device: DeviceLike = None,
                 seed: int = 0, generator: Optional[torch.Generator] = None):
        super().__init__()
        if config.message_impl not in ("segment", "band", "tile", "fused",
                                       "persistent"):
            raise ValueError(
                f"message_impl {config.message_impl!r} is not ported")
        if config.pool_impl not in ("auto", "segment", "matmul"):
            raise ValueError(f"unknown pool_impl {config.pool_impl!r}")
        dev = resolve_device(device)
        gen = generator if generator is not None else (
            torch.Generator().manual_seed(seed))
        self.config = config
        self.dtype = getattr(torch, config.dtype)
        self.subkeys = tuple(subkeys_for(config.feature))
        self.embeds = nn.ModuleDict({
            k: EmbedTable(config.input_dim, config.hidden_dim, gen,
                          self.dtype)
            for k in self.subkeys})
        self.ggnn_step = GatedGraphStep(
            config.ggnn_hidden, config.embedding_dim, gen,
            message_impl=config.message_impl, dtype=self.dtype)
        if config.label_style == "graph":
            self.pooling = GlobalAttentionPool(config.out_dim, gen,
                                               impl=config.pool_impl,
                                               dtype=self.dtype)
        if not config.encoder_mode:
            self.head = nn.ModuleDict({
                f"output_{i}": _linear(
                    config.out_dim,
                    1 if i == config.num_output_layers - 1 else config.out_dim,
                    gen)
                for i in range(config.num_output_layers)})
        self.over_gate_dispatches = 0
        self.to(dev)

    def _message_pass(self, h: torch.Tensor, batch: GraphBatch) -> torch.Tensor:
        cfg = self.config
        step = self.ggnn_step
        packed = None
        if cfg.message_impl in ("fused", "persistent") and (
                h.is_cuda or self.dtype == torch.bfloat16):
            # Pack the r|z|n weights once for every launch of this pass
            # (differentiable: autograd maps the packed gradients back).
            # f32 masters at either dtype: at bf16 the kernels' autograd
            # Function rounds them inside, so their gradients stay f32.
            packed = fused_gnn.packed_weights(step.step_params())
        if cfg.message_impl == "persistent":
            if batch.band_adj is None:
                raise ValueError("message_impl='persistent' needs "
                                 "batch_graphs(build_band_adj=True)")
            # A pass that needs a gradient runs the persistent backward
            # too, which holds more a row: its gate decides (at the
            # model's dtype: the bf16 instances hold more).
            if h.is_cuda and not (
                    fused_gnn.persistent_bwd_smem_ok(batch.band_adj,
                                                     cfg.ggnn_hidden,
                                                     self.dtype)
                    if fused_gnn.needs_grad(h, packed)
                    else fused_gnn.persistent_smem_ok(
                        batch.band_adj, cfg.ggnn_hidden, self.dtype)):
                # Over the shared-memory gate: the fused kernel per step
                # (counted as a launch is, so a graph's replays count it).
                count_launch(self, "over_gate_dispatches")
            else:
                return fused_gnn.persistent_unroll(
                    step.step_params(), h, batch.band_adj, cfg.n_steps,
                    packed=packed)
        plan = None
        if cfg.message_impl == "segment" and h.is_cuda:
            # The receivers' index plan, once for every step's aggregate
            # on the card (the CPU's sums key the ids in each call).
            plan = segment_sum_plan(batch.receivers, batch.max_nodes,
                                    batch.edge_mask)
        for _ in range(cfg.n_steps):
            h = step(h, batch, packed=packed, plan=plan)
        return h

    def forward(self, batch: GraphBatch) -> torch.Tensor:
        cfg = self.config
        feat_embed = torch.cat(
            [self.embeds[k](batch.node_feats[k]) for k in self.subkeys],
            dim=-1)
        ggnn_out = self._message_pass(feat_embed, batch)
        out = torch.cat([ggnn_out, feat_embed], dim=-1)
        if cfg.label_style == "graph":
            out = self.pooling(out, batch.node_graph, batch.node_mask,
                               batch.n_graphs, batch.node_graph_sorted)
        if cfg.encoder_mode:
            return out
        # The head carries no dtype (flax promotes a bf16 input to the f32
        # parameters): f32 logits.
        x = out.float()
        last = cfg.num_output_layers - 1
        for i in range(cfg.num_output_layers):
            x = self.head[f"output_{i}"](x)
            if i != last:
                x = torch.relu(x)
        return x[:, 0]
