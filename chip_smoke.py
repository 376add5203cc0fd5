"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's serving and training paths (``deepdfa_tpu_torch``;
nothing of JAX) at the published FlowGNN width and checks every
hand-written kernel they run against that kernel's plain PyTorch version.
Phases, in order; each raises on failure and nothing is caught around
one:

1. Device: the card's name, and its name and power limit from nvidia-smi.
   No CUDA: exit 1 with no result.
2. Build: nvcc compiles every kernel library from the sources here.
3. Kernels against their plain versions, on the card, at the serving
   shape (16 slots: N = 1024 rows, H = 128, bandwidth 1) and at the
   flagship shape (256 synthetic graphs packed for a band batch), with
   times from CUDA events and the least time the card could take;
   ``persistent_fwd_kernel`` also bit for bit against 5 launches of
   ``fused_step_kernel``, with that scan's time (``scan_ms``), the blocks
   an SM holds and the blocks of a thread-block cluster a row group gets;
   the per-step pair (``fused_step_kernel`` and, at the serving shape,
   ``fused_step_bwd_kernel``) with its launch geometry: the row tile,
   the grid's blocks, the blocks of a cluster a tile gets, the k rows of
   a gate slab, the blocks an SM holds of the instance that runs and a
   block's shared memory, each as the host's plan (``fused_gnn.step_plan``,
   ``step_smem_bytes``) says for the card's SM count.
4. Serve, persistent lane: ``ServeEngine`` with random weights from a
   seed, 64 requests and 16 duplicates through submit/pump/drain, kernel
   launches counted over that run, probabilities held against the same
   engine on the CPU.
5. Serve, fused lane: the same with ``message_impl="fused"``.
6. Every kernel of the train path against its plain version at the
   training shape (a batch as ``fit`` packs it: 256 graphs, N = 16384
   rows, H = 128, 5 steps): the two forward kernels, then the backward
   ones with times and bounds (the per-step pair with its launch
   geometry); ``persistent_fwd_hist_kernel``'s
   ``h_k`` bit for bit against ``persistent_fwd_kernel`` run for k steps
   and against the fused scan, and ``persistent_bwd_kernel`` plus
   ``step_weight_grad_kernel`` bit for bit against the scan of
   ``fused_step_bwd_kernel``, each persistent kernel timed beside its scan
   (``scan_ms``); the weight pass also
   against its own second launch, and timed beside three ``torch.mm``
   calls over the step-stacked operands (``library_ms``).
7. ``tile_spmm_kernel`` against its plain version at the training shape
   (the first batch of ``fit`` packed with its nonzero lists: N = 16384
   rows, H = 128), over A and over A^T (the backward's launch): times,
   the bound of the sparse product, the time of ``torch.sparse.mm`` on
   the same lists as an f32 CSR tensor (cuSPARSE), the tile counts the
   reference's dense layout would have, and the host's build and copy of
   the nonzero lists a batch beside those of the dense layout.
8. Train, persistent lane: ``train.loop.fit`` on the card (published
   widths, ``DataConfig(batch_size=256)``, ``TrainConfig`` defaults but
   one epoch: 9 steps and a validation pass), launches counted over the
   run; the same initial weights and batches through the port on the
   CPU, per-step losses compared; then a step-time breakdown (CUDA
   events) and each kernel's device ms a step (``torch.profiler``).
9. Train, fused lane: the same with ``message_impl="fused"``.
10. Train, tile lane: the same with ``message_impl="tile"``: exactly 10
   launches of ``tile_spmm_kernel`` a train step (5 gated steps
   forward, 5 backward over A^T) and 5 an evaluation batch.
11. The four flash-attention kernels against their plain versions at the
   text training shape (B 16, T 512, H 12, D 64: random q/k/v at the
   encoder's init scale, a mask with padded tails and one all-pad row)
   and at the long shape (B 8, T 4096, H 12), the fused backward against
   the two-pass pair at T 512, with times, bounds (the operations and
   bytes of the (query, key) pairs the mask leaves) and the time of
   ``F.scaled_dot_product_attention`` on the same inputs without the
   all-pad row (forward, and its autograd backward, which computes dq,
   dk and dv together: the two-pass pair's summed time stands beside
   it). Each kernel is also run twice on the same inputs and compared bit
   for bit, the all-pad row's output and the padded keys' dk and dv and
   the all-pad row's gradients must be exactly 0, the key tiles each skips
   are counted and each backward kernel's device time is read by the
   profiler.
12. Train DeepDFA+LineVul: ``train.text_loop.fit_text`` at the published
   width and depth (codebert-base, 12 layers, T 512, batch 16, the
   FlowGNN encoder, ``TransformerTrainConfig`` defaults but one epoch:
   6 steps and one validation batch on ``synthetic:120``), launches
   counted over the run; then a step-time breakdown (CUDA events),
   examples per second and each kernel's device ms a step
   (``torch.profiler``).
13. The same ``fit_text`` on the card and on the CPU, at full width with
   the depth cut to 2 layers, batch 4, dropout off (the two devices'
   random streams differ): first one batch's parameter gradients from
   the same weights, each tensor compared; then 3 steps, per-step losses
   compared.
14. Phase 13 with a tile graph encoder (``--set
   model.message_impl=tile``): its launches count toward the path.
15. ``fit_text`` at T 4096 (batch 8, 2 layers, 2 steps): the fused
   backward's dq partials would outgrow their bound, so the backward runs
   the two-pass pair; then each kernel's device ms a step
   (``torch.profiler``) and the pair's share of it.

16. The paper's two-stage recipe through the CLI, snapshots on disk in a
   temporary directory removed afterwards: ``fit`` (persistent lane,
   ``synthetic_bigvul(2600)``) for 2 epochs, and for 1 epoch resumed to
   2, which must repeat the uninterrupted run's epoch-1 losses bit for
   bit; ``test`` of its ``best`` on the card and on the CPU (loss within
   1e-5); ``score --split test`` (probabilities within 1e-4 of
   ``test``'s); ``fit-text --ddfa-checkpoint --freeze-graph`` at
   codebert-base width (12 layers, T 512, batch 16, ``synthetic:120``,
   one epoch, a persistent graph encoder), whose ``best`` must hold the
   grafted encoder and the seeded pooling bit for bit and whose launches
   must hold no GNN backward kernel; ``test-text``, which must repeat
   fit-text's test loss and ``predictions.csv`` bit for bit. Then each
   snapshot's bytes and its checksum, restore and save ms, and the frozen
   fine-tune's device ms a step by kernel (``torch.profiler``).
17. Real inputs, in a temporary directory removed afterwards: a
   ``synthetic_bigvul(2600)`` corpus written by the port's
   ``write_examples_jsonl`` in the ETL's export format (1002-row tables,
   ``df_in``/``df_out``, a pinned ``splits.json``) and a file of planted
   bad rows (seven fatal reasons, one ``float_field`` repair); ``cli
   validate`` exits 1 with exactly the planted counts and 0 on the clean
   corpus; ``cli analyze`` gives a numpy count's coverage; the corpus
   loads as the generated examples byte for byte; ``cli fit --config
   configs/default.yaml --set train.max_epochs=1`` (persistent lane)
   repeats the in-memory fit's losses bit for bit; one epoch with
   ``model.label_style=dataflow_solution_in``, its first step's loss
   within 1e-4 of the CPU's; MSR CSVs written with ``csv`` (one function
   over 131,072 characters, one field with quotes and newlines); a
   roberta-order BPE asset pair learned by pair counting on the corpus's
   functions and the checkout's code (up to codebert's 50,004 merges,
   until every word is one token); an HF directory
   at codebert-base width that ``load_pretrained`` reads back bit for
   bit; ``fit_text`` from those weights and the fit run's frozen graph
   encoder on the CSVs, the corpus and the BPE tokenizer; ``cli test-text
   --tokenizer`` on its snapshot, bit for bit its test. Each step's
   seconds, the corpus's rows/s and the tokenizer's functions/s (a fresh
   load, then all 2600 functions), and the
   fine-tune step's device ms by kernel.

Each phase's seconds go into a ``phase_seconds`` record. Each main-path
run sets every kernel's launch count to 0 just before it and reads the
counts just after. Every number goes on a line of its own before the
last; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import csv
import dataclasses
import heapq
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from deepdfa_tpu_torch import cli
from deepdfa_tpu_torch.contracts import ingest, schema
from deepdfa_tpu_torch.core import config as core_config
from deepdfa_tpu_torch.core.config import (
    DataConfig,
    FlowGNNConfig,
    TrainConfig,
    TransformerTrainConfig,
    subkeys_for,
)
from deepdfa_tpu_torch.data.combined import (
    graph_join_and_budget,
    load_combined_dataset,
    load_graph_source,
)
from deepdfa_tpu_torch.data.sampling import epoch_indices
from deepdfa_tpu_torch.data.splits import make_splits
from deepdfa_tpu_torch.data.synthetic import synthetic_bigvul
from deepdfa_tpu_torch.data import bpe
from deepdfa_tpu_torch.data.text import (
    HashingCodeTokenizer,
    attach_synthetic_text,
    encode_dataset,
    load_bpe_tokenizer,
)
from deepdfa_tpu_torch.graphs.batch import batch_graphs, pad_budget_for
from deepdfa_tpu_torch.models.flowgnn import FlowGNN
from deepdfa_tpu_torch.models.linevul import LineVul, cross_entropy_loss
from deepdfa_tpu_torch.models import convert, pretrained
from deepdfa_tpu_torch.models.transformer import EncoderConfig, RobertaEncoder
from deepdfa_tpu_torch.ops import (
    PEAK_BYTES_PER_S,
    _build,
    attention,
    fused_gnn,
    launch_counts,
    reset_launch_counts,
    tile_spmm,
)
from deepdfa_tpu_torch.ops.tile_spmm import DEFAULT_TILE, align_to_tile
from deepdfa_tpu_torch.serve import ServeConfig, ServeEngine
from deepdfa_tpu_torch.serve.engine import bucket_batch
from deepdfa_tpu_torch.train import checkpoint as train_checkpoint
from deepdfa_tpu_torch.train import loop, text_loop

SEED = 0
N_REQUESTS = 64
N_DUPLICATES = 16
# Tolerances, |kernel - plain| <= atol + rtol * |plain|, elementwise. One
# step differs only in f32 rounding order (the kernel aggregates h before
# the edge linear); five steps let it compound.
STEP_TOL = dict(rtol=1e-5, atol=1e-5)
UNROLL_TOL = dict(rtol=1e-4, atol=1e-4)
SERVE_TOL = 1e-4
# Backward kernels: per-row cotangents (dh, x, dp, dmsg) elementwise as
# above; weight gradients are sums over all 16384 rows of a step, so the
# rounding-order difference scales with the largest gradient entry:
# |kernel - plain| <= GRAD_TOL * max|plain|, per gradient tensor.
GRAD_TOL = 1e-4
# Per-step training losses, card against the CPU run of the same weights
# and batches: every step's gradients differ in f32 rounding order (and
# the embedding and segment scatters use atomics on the card), so the
# trajectories drift apart a little each step. The largest gap seen over
# 9 steps is 4.4e-6; the limit is about 20 times that.
TRAIN_LOSS_TOL = 1e-4
# Synthetic graphs for the train lanes: 80 % train, half positive, one
# epoch undersampled to all positives plus as many negatives = about
# 2080 graphs = 9 steps of 256, and 260 validation graphs.
N_TRAIN_EXAMPLES = 2600
TRAIN_EPOCHS = 1
# Train steps under torch.profiler a lane, the kernels it reports, and
# the profiler sessions tried before one that recorded no device time
# fails the run.
PROFILE_STEPS = 5
PROFILE_TOP = 8
PROFILE_SESSIONS = 3
# Each kernel's TPU counterpart (the Pallas kernel body it replaces) and
# its source here.
REPLACES = {
    "fused_step_kernel": "deepdfa_tpu/ops/fused_gnn.py:271",
    "persistent_fwd_kernel": "deepdfa_tpu/ops/fused_gnn.py:626",
    "fused_step_bwd_kernel": "deepdfa_tpu/ops/fused_gnn.py:369",
    "persistent_fwd_hist_kernel": "deepdfa_tpu/ops/fused_gnn.py:626",
    "persistent_bwd_kernel": "deepdfa_tpu/ops/fused_gnn.py:751",
    # the weight-gradient accumulation of _bwd_kernel (and the per-step
    # partials and fold of _persist_bwd_kernel, :854-895)
    "step_weight_grad_kernel": "deepdfa_tpu/ops/fused_gnn.py:446",
}
SOURCES = {name: "deepdfa_tpu_torch/csrc/fused_gnn.cu"
           for name in ("fused_step_kernel", "persistent_fwd_kernel",
                        "persistent_fwd_hist_kernel")}
SOURCES.update({name: "deepdfa_tpu_torch/csrc/fused_gnn_bwd.cu"
                for name in ("fused_step_bwd_kernel", "persistent_bwd_kernel",
                             "step_weight_grad_kernel")})


# DeepDFA+LineVul. Attention kernel shapes (B, T, H, D): the text
# training batch (16 functions of 512 tokens, codebert-base's 12 heads of
# 64) and the long-context shape the reference trains at T 4096.
ATTN_TRAIN_SHAPE = (16, 512, 12, 64)
ATTN_LONG_SHAPE = (8, 4096, 12, 64)
# Forward against the plain version: f32 in another order (64-key tiles
# against 512-key blocks). Gradients sum over up to 4096 keys or queries:
# |kernel - plain| <= atol + rtol * |plain| elementwise, as _check.
ATTN_FWD_TOL = dict(rtol=1e-5, atol=1e-5)
ATTN_GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
# What the library_ms of each backward kernel covers: SDPA's autograd
# backward gives dq, dk and dv in one call.
BWD_COVERS = ["dq", "dk", "dv"]
# fit_text runs: synthetic:N split 80/10/10. Full depth: 96 training
# rows = 6 steps of 16 and 12 validation rows = one batch. Card against
# CPU: 12 rows = 3 steps of 4. Long context: 16 rows = 2 steps of 8.
TEXT_N_FULL, TEXT_N_VS_CPU, TEXT_N_LONG = 120, 15, 20
TEXT_SEED = 1
# Per-step losses of the 2-layer run, card against CPU (f32 order, and
# the FlowGNN scatters' atomics on the card). The schedule's first update
# runs at lr 0, so of the 3 steps only the last follows a moved weight:
# the gradients are compared directly, per tensor, |card - cpu| <=
# GRAD_TOL * max|cpu| + TEXT_GRAD_FLOOR (the floor covers gradients that
# are zero in exact arithmetic, such as the pooling gate's bias, and are
# rounding noise on both devices).
TEXT_LOSS_TOL = 1e-4
TEXT_GRAD_FLOOR = 1e-6
TEXT_PROFILE_STEPS = 3
# The recipe phase: ``cli test`` of one snapshot on the card against the
# CPU, one evaluation pass, f32 in another order (loss).
RECIPE_TEST_TOL = 1e-5
REPLACES.update({
    "flash_fwd_kernel": "deepdfa_tpu/ops/attention.py:220",
    "flash_bwd_fused_kernel": "deepdfa_tpu/ops/attention.py:320",
    "flash_bwd_dq_kernel": "deepdfa_tpu/ops/attention.py:262",
    "flash_bwd_dkv_kernel": "deepdfa_tpu/ops/attention.py:293",
})
SOURCES.update({name: "deepdfa_tpu_torch/csrc/flash_attn.cu"
                for name in attention.KERNELS})
SOURCES["flash_bwd_fused_kernel"] = "deepdfa_tpu_torch/csrc/flash_bwd_fused.cu"
REPLACES["tile_spmm_kernel"] = "deepdfa_tpu/ops/tile_spmm.py:364"
SOURCES["tile_spmm_kernel"] = "deepdfa_tpu_torch/csrc/tile_spmm.cu"
# The tile product against its plain version: each output sums a row's
# few edges in another order (f32 FMAs against cuBLAS's bmm and
# index_add_).
TILE_TOL = dict(rtol=1e-5, atol=1e-5)
# What torch.sparse.mm on A (f32 CSR) computes of the kernel's output.
TILE_LIBRARY_COVERS = ["agg = A @ msg"]
# Every __global__ function of csrc/ by its name in the source, as
# torch.profiler reports it: the kernels above (persistent_fwd_hist_kernel
# is an instance of persistent_fwd_kernel and counts under that name) and
# the second steps of two of them, the weight gradients' and the fused
# flash backward's reductions.
PORT_KERNELS = (set(REPLACES) - {"persistent_fwd_hist_kernel"}) | {
    "step_weight_grad_reduce_kernel", "flash_dq_sum_kernel"}
# What the weight pass's library_ms covers: three torch.mm calls over the
# step-stacked operands ([K N, H]^T x [K N, .]) and three column sums.
WGRAD_LIBRARY_COVERS = ["dW_e, dW_i, dW_h as torch.mm over the K steps' "
                        "stacked rows", "db_e, db_i, db_h column sums"]


def emit(**record) -> None:
    print(json.dumps(record), flush=True)


def phase_device() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one "
              "NVIDIA GPU", file=sys.stderr)
        sys.exit(1)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"device: {name} | nvidia-smi: {smi}", flush=True)
    print(smi, flush=True)
    emit(phase="device", torch=torch.__version__, cuda=torch.version.cuda,
         device=name, count=torch.cuda.device_count())
    # The plain versions run f32 products in full f32, as the reference
    # holds them to Precision.HIGHEST.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name


def phase_build() -> None:
    t0 = time.perf_counter()
    info = _build.build_all()
    for name in _build.SOURCES:
        _build.load(name)
    ptxas = [line.strip() for _, log in info.values()
             for line in log.splitlines() if "registers" in line]
    emit(phase="build", seconds=time.perf_counter() - t0,
         libraries=sorted(info), ptxas=ptxas)


def _time_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Device time of one call, from CUDA events around ``iters`` calls
    queued behind a device-side sleep that outlasts their enqueue (so the
    events time the card, not the host); the median of ``reps``."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(2 * host_s * 2.0e9)  # ~2x the enqueue time at <= 2 GHz
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / iters)
    return statistics.median(out)


def _bound(cost) -> tuple:
    """(bound ms, what bounds it): the larger of the operations over the
    peak the kernel's ``kernel_cost`` names (published H100 SXM rates at
    700 W) and the bytes over 3.35 TB/s."""
    t_ops = cost["flops"] / cost["peak_flops"]
    t_bytes = cost["bytes"] / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _peak(cost) -> dict:
    return {"bound_peak": cost["peak"],
            "bound_peak_tflops": cost["peak_flops"] / 1e12}


def _serving_batch(model: FlowGNN):
    graphs = synthetic_bigvul(16, model.config.feature, seed=SEED)
    return bucket_batch(ServeConfig(), graphs, 16, list(model.subkeys),
                        band=True).to("cuda")


def _flagship_batch(model: FlowGNN):
    # 256 graphs packed as the JAX package's flagship example batch:
    # pad_budget_for, node budget aligned to the tile, band built.
    graphs = synthetic_bigvul(256, model.config.feature,
                              positive_fraction=0.5, seed=SEED)
    budget = pad_budget_for(graphs, 256)
    return batch_graphs(graphs, 256, align_to_tile(budget["max_nodes"]),
                        budget["max_edges"], list(model.subkeys),
                        tile=DEFAULT_TILE, build_band_adj=True).to("cuda")


def _check(name, got, want, tol) -> float:
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)}, or non-finite values")
    err = (got - want).abs()
    limit = tol["atol"] + tol["rtol"] * want.abs()
    if bool((err > limit).any()):
        raise AssertionError(f"{name}: max |diff| {err.max().item():.3e} "
                             f"over the tolerance {tol}")
    return float(err.max())


def _fused_scan(params, h, adj, steps, packed):
    """``steps`` launches of fused_step_kernel: the per-step scan a
    persistent forward owes its bits to."""
    for _ in range(steps):
        h = fused_gnn.fused_gate_step(params, h, adj, packed=packed)
    return h


def _scan_record(name, kernel, scan, adj, hidden,
                 which="persistent_fwd_kernel", iters=20, reps=5) -> dict:
    """A persistent kernel against the scan of its per-step counterpart:
    the same bits, the scan's time (``scan_ms``), the blocks a group gets
    (``cluster``) and, for the instance that this batch launches, the
    blocks one SM holds (``blocks_per_sm``) and, in clusters, the
    clusters the card holds at once (``active_clusters``)."""
    _same_bits(f"{name} vs the per-step scan", _as_list(kernel()),
               _as_list(scan()))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cluster = (fused_gnn.persistent_cluster_size(adj, hidden, sms)
               if which == "persistent_fwd_kernel" else 1)
    return dict(scan_ms=_time_ms(scan, iters, reps), cluster=cluster,
                **fused_gnn.persistent_occupancy(adj, hidden, which,
                                                 cluster))


def _step_geometry(adj, hidden, kernel) -> dict:
    """The launch geometry of a per-step kernel at this adjacency, as its
    library reports it, held to the host plan it mirrors on this card's
    SMs, shared memory included."""
    geo = fused_gnn.step_geometry(adj, hidden, kernel)
    n = adj.n_tiles * adj.tile
    plan = fused_gnn.step_plan(n, hidden, geo["sms"], kernel)
    plan["smem_bytes"] = fused_gnn.step_smem_bytes(n, hidden, geo["sms"],
                                                   kernel, 0)
    if kernel == "fused_step_bwd_kernel":
        plan["smem_bytes_pass1"] = fused_gnn.step_smem_bytes(
            n, hidden, geo["sms"], kernel, 1)
    for key in plan.keys() - {"wide"}:
        if geo[key] != plan[key]:
            raise AssertionError(f"{kernel}: the library plans {key} "
                                 f"{geo[key]}, step_plan {plan[key]}")
    return dict(geo, wide=plan["wide"])


def _as_list(out) -> list:
    return list(out) if isinstance(out, (tuple, list)) else [out]


def phase_kernels(model: FlowGNN) -> dict:
    """Both kernels against their plain versions at both shapes; returns
    the serving-shape numbers by kernel."""
    cfg = model.config
    params = model.ggnn_step.step_params()
    packed = fused_gnn.packed_weights(params)
    serving = {}
    with torch.inference_mode():
        for shape, batch in (("serving", _serving_batch(model)),
                             ("flagship", _flagship_batch(model))):
            adj = batch.band_adj
            h = torch.cat([model.embeds[k](batch.node_feats[k])
                           for k in model.subkeys], dim=-1).contiguous()
            if not fused_gnn.persistent_smem_ok(adj, cfg.ggnn_hidden):
                raise AssertionError(f"{shape}: row groups over the gate")
            runs = {
                "fused_step_kernel": (
                    lambda: fused_gnn.fused_gate_step(params, h, adj,
                                                      packed=packed),
                    lambda: fused_gnn.fused_step_reference(params, h, adj),
                    STEP_TOL, 1, cfg.n_steps),
                "persistent_fwd_kernel": (
                    lambda: fused_gnn.persistent_unroll(
                        params, h, adj, cfg.n_steps, packed=packed),
                    lambda: fused_gnn.persistent_reference(
                        params, h, adj, cfg.n_steps),
                    UNROLL_TOL, cfg.n_steps, 1),
            }
            for name, (kernel, plain, tol, steps, per_forward) in runs.items():
                before = fused_gnn.launch_counts()[name]
                err = _check(f"{name}@{shape}", kernel(), plain(), tol)
                kernel_ms = _time_ms(kernel)
                launches = fused_gnn.launch_counts()[name] - before
                plain_ms = _time_ms(plain)
                cost = fused_gnn.kernel_cost(adj, cfg.ggnn_hidden, steps)
                bound_ms, bound_by = _bound(cost)
                rec = dict(kernel=name, shape=shape, n_rows=h.shape[0],
                           hidden=h.shape[1], bandwidth=adj.bandwidth,
                           row_groups=adj.row_groups.numel() - 1,
                           max_group_rows=adj.max_group_rows,
                           nnz=cost["nnz"], steps=steps,
                           max_abs_err=err, tol=tol, kernel_ms=kernel_ms,
                           plain_ms=plain_ms, bound_us=bound_ms * 1e3,
                           bound_by=bound_by, **_peak(cost),
                           flops=cost["flops"],
                           bytes=cost["bytes"], launches=launches,
                           launches_per_forward=per_forward)
                if name == "persistent_fwd_kernel":
                    rec.update(_scan_record(
                        f"persistent_fwd_kernel@{shape}", kernel,
                        lambda: _fused_scan(params, h, adj, cfg.n_steps,
                                            packed),
                        adj, cfg.ggnn_hidden))
                else:
                    rec.update(_step_geometry(adj, cfg.ggnn_hidden, name))
                emit(phase="kernels", **rec)
                if shape == "serving":
                    serving[name] = rec
            if shape == "serving":
                # The per-step backward at the serving bucket (a batch
                # over the persistent backward's gate trains through it).
                gen = torch.Generator(device="cuda").manual_seed(SEED)
                g = torch.randn(h.shape, generator=gen, device="cuda")
                bwd = lambda: fused_gnn.fused_step_bwd_rows(params, h, adj,
                                                            g, packed)
                want = fused_gnn.fused_step_bwd_rows_reference(params, h,
                                                               adj, g)
                err = max(_check(f"fused_step_bwd_kernel@{shape}[{i}]", a, b,
                                 STEP_TOL)
                          for i, (a, b) in enumerate(zip(bwd(), want)))
                before = fused_gnn.launch_counts()["fused_step_bwd_kernel"]
                kernel_ms = _time_ms(bwd)
                launches = (fused_gnn.launch_counts()["fused_step_bwd_kernel"]
                            - before)
                cost = fused_gnn.kernel_cost(adj, cfg.ggnn_hidden, 1,
                                             kernel="fused_step_bwd_kernel")
                bound_ms, bound_by = _bound(cost)
                emit(phase="kernels", kernel="fused_step_bwd_kernel",
                     shape=shape, n_rows=h.shape[0], hidden=h.shape[1],
                     bandwidth=adj.bandwidth, nnz=cost["nnz"], steps=1,
                     max_abs_err=err, tol=STEP_TOL, kernel_ms=kernel_ms,
                     plain_ms=_time_ms(lambda: fused_gnn.
                                       fused_step_bwd_rows_reference(
                                           params, h, adj, g)),
                     bound_us=bound_ms * 1e3, bound_by=bound_by,
                     **_peak(cost), flops=cost["flops"],
                     bytes=cost["bytes"], launches=launches,
                     **_step_geometry(adj, cfg.ggnn_hidden,
                                      "fused_step_bwd_kernel"))
    return serving


def _requests():
    graphs = synthetic_bigvul(N_REQUESTS, FlowGNNConfig().feature,
                              seed=SEED + 1)
    return [{k: g[k] for k in ("num_nodes", "senders", "receivers",
                               "feats", "id")} for g in graphs]


def _flush_breakdown(engine: ServeEngine, graphs, reps: int = 10) -> dict:
    """Median host seconds of one full 16-slot flush's parts: packing the
    batch on the host, the copy to the card, and the forward (launches
    and device work, ended by a synchronize); plus the forward's device
    time from CUDA events."""
    parts = {"pack_ms": [], "to_device_ms": [], "forward_ms": [],
             "forward_device_ms": []}
    slots = engine.config.batch_slots
    for _ in range(reps):
        t0 = time.perf_counter()
        gb = bucket_batch(engine.config, graphs, slots,
                          engine.required_subkeys, band=True)
        t1 = time.perf_counter()
        gb = gb.to(engine.device)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        engine._infer(gb)
        end.record()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        parts["pack_ms"].append((t1 - t0) * 1e3)
        parts["to_device_ms"].append((t2 - t1) * 1e3)
        parts["forward_ms"].append((t3 - t2) * 1e3)
        parts["forward_device_ms"].append(start.elapsed_time(end))
    return {k: statistics.median(v) for k, v in parts.items()}


def phase_serve(impl: str) -> dict:
    cfg = FlowGNNConfig(message_impl=impl)
    model = FlowGNN(cfg, device="cuda", seed=SEED)
    engine = ServeEngine(model, ServeConfig(), device="cuda")
    t0 = time.perf_counter()
    warmed = engine.warmup()
    warm_s = time.perf_counter() - t0
    reqs = _requests()

    reset_launch_counts()
    t0 = time.perf_counter()
    handles = []
    for g in reqs:
        handles.append(engine.submit(g))
        engine.pump()
    dups = [engine.submit(g) for g in reqs[:N_DUPLICATES]]
    engine.drain()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = launch_counts()

    snap = engine.snapshot()
    flushes = snap["batches"]
    results = [h.result for h in handles + dups]
    if any(r is None or "prob" not in r for r in results):
        raise AssertionError(f"{impl}: unanswered or failed requests: "
                             f"{[r for r in results if not r or 'error' in r][:3]}")
    probs = np.asarray([r["prob"] for r in results[:N_REQUESTS]])
    if not np.all(np.isfinite(probs)) or not np.all((probs >= 0)
                                                     & (probs <= 1)):
        raise AssertionError(f"{impl}: probabilities out of [0, 1]")
    if not all(r["cached"] for r in results[N_REQUESTS:]):
        raise AssertionError(f"{impl}: duplicates were not answered from "
                             "the cache")
    if snap["cache_hits"] != N_DUPLICATES or snap["failures"]:
        raise AssertionError(f"{impl}: snapshot {snap}")
    if impl == "persistent":
        if launches["persistent_fwd_kernel"] + model.over_gate_dispatches \
                < flushes or launches["persistent_fwd_kernel"] == 0:
            raise AssertionError(f"persistent lane: {launches} over "
                                 f"{flushes} flushes")
    elif launches["fused_step_kernel"] != cfg.n_steps * flushes:
        raise AssertionError(f"fused lane: {launches} over {flushes} "
                             "flushes")

    # The same weights on the CPU, where the plain versions run.
    cpu_model = FlowGNN(cfg, device="cpu")
    cpu_model.load_state_dict({k: v.cpu()
                               for k, v in model.state_dict().items()})
    cpu_engine = ServeEngine(cpu_model, ServeConfig(), device="cpu")
    want = np.asarray([r["prob"] for r in cpu_engine.score_sync(reqs)])
    max_diff = float(np.abs(probs - want).max())
    if max_diff > SERVE_TOL:
        raise AssertionError(f"{impl}: |cuda - cpu| prob {max_diff:.3e} > "
                             f"{SERVE_TOL}")
    rec = dict(phase="serve", message_impl=impl, warmed_buckets=warmed,
               warmup_s=warm_s, requests=len(results), flushes=flushes,
               cache_hits=snap["cache_hits"], launches=launches,
               over_gate_dispatches=model.over_gate_dispatches,
               max_abs_prob_diff_vs_cpu=max_diff, wall_s=wall_s,
               requests_per_s=len(results) / wall_s,
               latency_p50_ms=snap["latency_p50_ms"],
               latency_p99_ms=snap["latency_p99_ms"],
               flush_breakdown=_flush_breakdown(
                   engine, [engine._normalize_graph(g) for g in reqs[:16]]))
    emit(**rec)
    return rec


def _train_data(feature, seed: int):
    examples = load_graph_source(f"synthetic:{N_TRAIN_EXAMPLES}", feature,
                                 seed=seed)
    return examples, make_splits(examples, mode="random", seed=seed)


def _training_batch(model: FlowGNN, device: str = "cuda"):
    """The first batch of fit's first epoch at the published sizes, with
    the tile adjacency for a tile model and the band one otherwise."""
    examples, splits = _train_data(model.config.feature, TrainConfig().seed)
    train = splits["train"]
    idx = epoch_indices([examples[i]["label"] for i in train], 0,
                        seed=DataConfig().seed)
    tile = model.config.uses_tile_adj
    batches = loop._batches(examples, train[idx], DataConfig(),
                            list(model.subkeys), DataConfig().batch_size,
                            build_band_adj=not tile, build_tile_adj=tile)
    return next(iter(batches)).to(device)


def _check_grads(name, got, want) -> tuple:
    """Weight gradients: |got - want| <= GRAD_TOL * max|want|; returns
    the largest |got - want| and the largest difference over max|want|."""
    torch.cuda.synchronize()
    worst_abs = worst_rel = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        if a.shape != b.shape or not torch.isfinite(a).all():
            raise AssertionError(f"{name}[{i}]: shape {tuple(a.shape)} vs "
                                 f"{tuple(b.shape)}, or non-finite values")
        diff = float((a - b).abs().max())
        rel = diff / max(float(b.abs().max()), 1e-30)
        if rel > GRAD_TOL:
            raise AssertionError(f"{name}[{i}]: max |diff| / max |plain| "
                                 f"{rel:.3e} > {GRAD_TOL}")
        worst_abs, worst_rel = max(worst_abs, diff), max(worst_rel, rel)
    return worst_abs, worst_rel


def _same_bits(name, got, want) -> None:
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(got, want)):
        if a.shape != b.shape or not torch.equal(a, b):
            diff = (a - b).abs().max().item() if a.shape == b.shape else None
            raise AssertionError(f"{name}[{i}] is not bitwise equal "
                                 f"(max |diff| {diff})")


def phase_train_kernels(model: FlowGNN) -> dict:
    """The train path's kernels at the training shape: each against its
    plain version (tolerances above), timed; the bitwise identities the
    persistent kernels owe the per-step ones. Returns the numbers of the
    four backward-path kernels by kernel (the forward kernels' stand at
    the serving shape)."""
    cfg = model.config
    k_steps = cfg.n_steps
    batch = _training_batch(model)
    adj = batch.band_adj
    out = {}
    with torch.no_grad():
        h = torch.cat([model.embeds[k](batch.node_feats[k])
                       for k in model.subkeys], dim=-1).contiguous()
        params = model.ggnn_step.step_params()
        packed = [w.detach().contiguous()
                  for w in fused_gnn.packed_weights(params)]
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        g = torch.randn(h.shape, generator=gen, device="cuda")
        hidden = h.shape[1]
        if not fused_gnn.persistent_bwd_smem_ok(adj, hidden):
            raise AssertionError("training batch over the backward gate")

        def record(name, err, kernel, plain, steps, tol, iters=10, reps=3,
                   library=None, **extra):
            before = fused_gnn.launch_counts()[name]
            kernel_ms = _time_ms(kernel, iters, reps)
            launches = fused_gnn.launch_counts()[name] - before
            plain_ms = _time_ms(plain, iters, reps)
            if library is not None:
                extra.update(library_ms=_time_ms(library, iters, reps),
                             library_covers=WGRAD_LIBRARY_COVERS)
            cost = fused_gnn.kernel_cost(adj, hidden, steps, kernel=name)
            bound_ms, bound_by = _bound(cost)
            rec = dict(kernel=name, shape="training", n_rows=h.shape[0],
                       hidden=hidden, bandwidth=adj.bandwidth,
                       row_groups=adj.row_groups.numel() - 1,
                       max_group_rows=adj.max_group_rows, nnz=cost["nnz"],
                       steps=steps, max_abs_err=err, tol=tol,
                       kernel_ms=kernel_ms, plain_ms=plain_ms,
                       bound_us=bound_ms * 1e3, bound_by=bound_by,
                       **_peak(cost), flops=cost["flops"],
                       bytes=cost["bytes"], timing_launches=launches,
                       **extra)
            emit(phase="train_kernels", **rec)
            return rec

        # The forward kernels on this batch: fit's fused lane launches
        # fused_step_kernel here, the persistent lane persistent_fwd_kernel.
        err = _check("fused_step_kernel@training",
                     fused_gnn.fused_gate_step(params, h, adj, packed=packed),
                     fused_gnn.fused_step_reference(params, h, adj), STEP_TOL)
        record("fused_step_kernel", err,
               lambda: fused_gnn.fused_gate_step(params, h, adj,
                                                 packed=packed),
               lambda: fused_gnn.fused_step_reference(params, h, adj), 1,
               STEP_TOL, **_step_geometry(adj, hidden, "fused_step_kernel"))
        err = _check("persistent_fwd_kernel@training",
                     fused_gnn.persistent_unroll(params, h, adj, k_steps,
                                                 packed=packed),
                     fused_gnn.persistent_reference(params, h, adj, k_steps),
                     UNROLL_TOL)
        unroll = lambda: fused_gnn.persistent_unroll(params, h, adj, k_steps,
                                                     packed=packed)
        record("persistent_fwd_kernel", err, unroll,
               lambda: fused_gnn.persistent_reference(params, h, adj,
                                                      k_steps),
               k_steps, UNROLL_TOL, **_scan_record(
                   "persistent_fwd_kernel@training", unroll,
                   lambda: _fused_scan(params, h, adj, k_steps, packed), adj,
                   hidden, iters=10, reps=3))

        # fused_step_bwd_kernel: one step's cotangents.
        got = fused_gnn.fused_step_bwd_rows(params, h, adj, g, packed)
        want = fused_gnn.fused_step_bwd_rows_reference(params, h, adj, g)
        err = max(_check(f"fused_step_bwd_kernel[{i}]", a, b, STEP_TOL)
                  for i, (a, b) in enumerate(zip(got, want)))
        out["fused_step_bwd_kernel"] = record(
            "fused_step_bwd_kernel", err,
            lambda: fused_gnn.fused_step_bwd_rows(params, h, adj, g, packed),
            lambda: fused_gnn.fused_step_bwd_rows_reference(params, h, adj,
                                                            g),
            1, STEP_TOL, **_step_geometry(adj, hidden,
                                          "fused_step_bwd_kernel"))

        # persistent_fwd_hist_kernel: h_1..h_{K-1}; each h_k bit for bit
        # the persistent forward's after k steps and the k-th state of the
        # fused scan.
        hist = fused_gnn.persistent_hist(params, h, adj, k_steps, packed)
        want = fused_gnn.persistent_hist_reference(params, h, adj, k_steps)
        err = _check("persistent_fwd_hist_kernel", hist, want, UNROLL_TOL)
        _same_bits("persistent_fwd_hist_kernel vs persistent_fwd_kernel",
                   list(hist), [fused_gnn.persistent_unroll(
                       params, h, adj, k, packed) for k in range(1, k_steps)])

        def hist_scan():
            states = [h]
            for _ in range(k_steps - 1):
                states.append(fused_gnn.fused_gate_step(
                    params, states[-1], adj, packed=packed))
            return states[1:]

        hist_kernel = lambda: fused_gnn.persistent_hist(params, h, adj,
                                                        k_steps, packed)
        out["persistent_fwd_hist_kernel"] = record(
            "persistent_fwd_hist_kernel", err, hist_kernel,
            lambda: fused_gnn.persistent_hist_reference(params, h, adj,
                                                        k_steps),
            k_steps, UNROLL_TOL, **_scan_record(
                "persistent_fwd_hist_kernel@training",
                lambda: list(hist_kernel()), hist_scan, adj, hidden,
                iters=10, reps=3))

        # persistent_bwd_kernel: the reverse sweep over the kernel's hist.
        rows = fused_gnn.persistent_bwd_rows(params, h, hist, adj, g, k_steps,
                                             packed)
        want = fused_gnn.persistent_bwd_rows_reference(params, h, hist, adj,
                                                       g, k_steps)
        err = max(_check(f"persistent_bwd_kernel[{i}]", a, b, UNROLL_TOL)
                  for i, (a, b) in enumerate(zip(rows, want)))
        # ... and bit for bit the scan of fused_step_bwd_kernel: dh_0, then
        # each step's x, dp and dmsg.
        def bwd_scan():
            gs, scan = g, [None] * k_steps
            for s in reversed(range(k_steps)):
                hs = h if s == 0 else hist[s - 1]
                gs, *scan[s] = fused_gnn.fused_step_bwd_rows(params, hs, adj,
                                                             gs, packed)
            return [gs] + [c[j] for j in range(3) for c in scan]

        def bwd_kernel():
            dh, *per_step = fused_gnn.persistent_bwd_rows(
                params, h, hist, adj, g, k_steps, packed)
            return [dh] + [t for c in per_step for t in c.unbind(0)]

        out["persistent_bwd_kernel"] = record(
            "persistent_bwd_kernel", err, bwd_kernel,
            lambda: fused_gnn.persistent_bwd_rows_reference(
                params, h, hist, adj, g, k_steps),
            k_steps, UNROLL_TOL, iters=5, **_scan_record(
                "persistent_bwd_kernel@training", bwd_kernel, bwd_scan, adj,
                hidden, "persistent_bwd_kernel", iters=5, reps=3))

        # step_weight_grad_kernel: the K-step weight gradients from those
        # cotangents, and bit for bit the descending fold of K one-step
        # calls (what autograd does over the fused lane's K steps).
        _, x, dp, dmsg = rows
        grads = fused_gnn.step_weight_grads(h, hist, x, dp, dmsg, k_steps)
        want = fused_gnn.step_weight_grad_reference(h, hist, x, dp, dmsg,
                                                    k_steps)
        err, rel = _check_grads("step_weight_grad_kernel", grads, want)
        fold = None
        for s in reversed(range(k_steps)):
            hs = (h if s == 0 else hist[s - 1]).contiguous()
            one = fused_gnn.step_weight_grads(hs, None, x[s:s + 1],
                                              dp[s:s + 1], dmsg[s:s + 1], 1)
            fold = one if fold is None else tuple(
                a + b for a, b in zip(fold, one))
        _same_bits("step_weight_grad_kernel vs the fold of one-step calls",
                   grads, fold)
        _same_bits("step_weight_grad_kernel twice",
                   fused_gnn.step_weight_grads(h, hist, x, dp, dmsg, k_steps),
                   grads)
        # The yardstick: the same contractions as three torch.mm calls
        # (cuBLAS, f32: TF32 is off) over every step's rows at once, the
        # operands stacked [K N, .] before the timer, and the bias sums.
        hs_all = torch.cat([h[None], hist]).reshape(-1, hidden)
        x_all, dmsg_all = x.reshape(-1, hidden), dmsg.reshape(-1, hidden)
        dp_all = dp.reshape(-1, 4 * hidden)
        dpi_all = dp_all[:, :3 * hidden].contiguous()
        dph_all = torch.cat([dp_all[:, :2 * hidden],
                             dp_all[:, 3 * hidden:]], dim=1)

        def library():
            return (torch.mm(hs_all.T, dmsg_all),
                    dmsg_all.sum(0, keepdim=True),
                    torch.mm(x_all.T, dpi_all), dpi_all.sum(0, keepdim=True),
                    torch.mm(hs_all.T, dph_all), dph_all.sum(0, keepdim=True))

        _check_grads("stacked torch.mm", library(), want)
        out["step_weight_grad_kernel"] = record(
            "step_weight_grad_kernel", err,
            lambda: fused_gnn.step_weight_grads(h, hist, x, dp, dmsg,
                                                k_steps),
            lambda: fused_gnn.step_weight_grad_reference(h, hist, x, dp,
                                                         dmsg, k_steps),
            k_steps, dict(rel=GRAD_TOL), iters=5, library=library,
            max_rel_err=rel, bitwise_repeatable=True)
    return out


def _step_breakdown(forward_loss, update, reps: int) -> dict:
    """Median device ms of one train step's parts, as the train steps run
    them (CUDA events around ``forward_loss()``: zero_grad, forward and
    loss; the loss's backward; ``update()``: the optimizer step, after
    the clip where the step clips), and the step's host wall ms; two
    warm-up steps first."""
    parts = {"forward_ms": [], "backward_ms": [], "optimizer_ms": [],
             "step_wall_ms": []}
    for _ in range(reps + 2):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        loss = forward_loss()
        ev[1].record()
        loss.backward()
        ev[2].record()
        update()
        ev[3].record()
        torch.cuda.synchronize()
        parts["step_wall_ms"].append((time.perf_counter() - t0) * 1e3)
        for key, a, b in (("forward_ms", 0, 1), ("backward_ms", 1, 2),
                          ("optimizer_ms", 2, 3)):
            parts[key].append(ev[a].elapsed_time(ev[b]))
    return {k: statistics.median(v[2:]) for k, v in parts.items()}


def _gnn_step_breakdown(model: FlowGNN, batch) -> dict:
    """``_step_breakdown`` of make_train_step's step on one batch."""
    opt = loop.make_optimizer(model.parameters(), TrainConfig())
    labels, mask = loop._labels_for(model, batch)

    def forward_loss():
        opt.zero_grad(set_to_none=True)
        return loop.bce_with_logits(model(batch), labels, mask)

    return _step_breakdown(forward_loss, opt.step, reps=10)


def _device_profile(step, n_steps: int) -> dict:
    """Device ms a call of ``step`` by kernel: ``n_steps`` calls under
    ``torch.profiler`` after three warm-up calls; the ``PROFILE_TOP``
    kernels with the most device time, and the device-busy ms a call (the
    sum over every kernel; overlapping kernels would count twice, and
    these paths run one stream). A session that records no device
    activity at all (CUPTI now and then hands back none in a process that
    has run many sessions) is run again, up to ``PROFILE_SESSIONS`` in
    all; ``profile_sessions`` says how many it took."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    for sessions in range(1, PROFILE_SESSIONS + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n_steps):
                step()
            torch.cuda.synchronize()
        kernels = []
        for evt in prof.key_averages():
            us = float(getattr(evt, "device_time_total",
                               getattr(evt, "cuda_time_total", 0.0)))
            # A user annotation's device range (the optimizer step's) spans
            # kernels already counted on their own.
            if getattr(evt, "is_user_annotation", False):
                continue
            if us > 0 and "cuda" in str(evt.device_type).lower():
                kernels.append((us / 1e3 / n_steps, evt.key,
                                evt.count / n_steps))
        if kernels:
            break
    else:
        raise AssertionError(f"torch.profiler recorded no device time in "
                             f"{PROFILE_SESSIONS} sessions")
    kernels.sort(reverse=True)
    # The port's own kernels, by the name in their source, wherever they
    # rank.
    port = {}
    for ms, key, calls in kernels:
        name = re.search(r"(\w+)(?:<[^(]*>)?\(", key)
        if name and name.group(1) in PORT_KERNELS:
            entry = port.setdefault(name.group(1), {"ms": 0.0, "calls": 0.0})
            entry["ms"] += ms
            entry["calls"] += calls
    return {"device_busy_ms": sum(k[0] for k in kernels),
            "top_kernels": [{"name": name[:90], "ms": ms, "calls": calls}
                            for ms, name, calls in kernels[:PROFILE_TOP]],
            "port_kernels": port, "profile_sessions": sessions}


def _profile_step(model: FlowGNN, batch) -> dict:
    """``_device_profile`` of ``PROFILE_STEPS`` steps of
    ``make_train_step``."""
    step = loop.make_train_step(
        model, loop.make_optimizer(model.parameters(), TrainConfig()),
        TrainConfig())
    return _device_profile(lambda: step(batch), PROFILE_STEPS)


def _host_ms(fn, reps: int = 5) -> float:
    """Median host ms of ``fn()``, synchronising the card around it."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def phase_tile_kernels() -> dict:
    """``tile_spmm_kernel`` against its plain version at the training
    shape, over A and over A^T, timed beside its bound and cuSPARSE; the
    host's build and copy of a batch's nonzero lists beside those of the
    reference's dense tile layout. Returns the numbers over A (its
    backward's launch, over A^T, stands beside them as
    ``transpose_ms``)."""
    model = FlowGNN(FlowGNNConfig(message_impl="tile"), device="cuda",
                    seed=SEED)
    host = _training_batch(model, device="cpu")
    s, r, m = (x.numpy() for x in (host.senders, host.receivers,
                                    host.edge_mask))
    n, hidden = host.max_nodes, model.config.ggnn_hidden
    lists = host.tile_adj
    dense = tile_spmm.tile_layout(lists)
    dense_tensors = [getattr(dense, f) for f in ("vals", "rows", "cols",
                                                 "t_vals", "t_rows",
                                                 "t_cols")]
    list_tensors = [lists.ptr, lists.src, lists.val, lists.t_ptr,
                    lists.t_src, lists.t_val]
    host_cost = dict(
        host_build_ms=_host_ms(
            lambda: tile_spmm.build_csr_adjacency(s, r, m, n)),
        host_to_device_ms=_host_ms(lambda: lists.to("cuda")),
        bytes_to_device=_nbytes(*list_tensors),
        dense_build_ms=_host_ms(
            lambda: tile_spmm.build_tile_adjacency(s, r, m, n)),
        dense_to_device_ms=_host_ms(
            lambda: [x.to("cuda") for x in dense_tensors]),
        dense_bytes_to_device=_nbytes(*dense_tensors))
    adj = lists.to("cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    msg = torch.randn((n, hidden), generator=gen, device="cuda")
    recs = {}
    for direction, a in (("A", adj), ("A^T", adj.transposed())):
        got = tile_spmm.tile_spmm(a, msg)
        want = tile_spmm.tile_spmm_reference(a, msg)
        err = _check(f"tile_spmm_kernel@{direction}", got, want, TILE_TOL)
        # The yardstick: the same lists as an f32 CSR matrix, one
        # torch.sparse.mm call (cuSPARSE).
        csr = torch.sparse_csr_tensor(a.ptr.long(), a.src.long(), a.val,
                                      (n, n))
        _check(f"torch.sparse.mm@{direction}", torch.sparse.mm(csr, msg),
               want, TILE_TOL)
        kernel_ms = _time_ms(lambda: tile_spmm.tile_spmm(a, msg))
        plain_ms = _time_ms(lambda: tile_spmm.tile_spmm_reference(a, msg))
        library_ms = _time_ms(lambda: torch.sparse.mm(csr, msg))
        cost = tile_spmm.kernel_cost(adj, hidden,
                                     transposed=direction == "A^T")
        bound_ms, bound_by = _bound(cost)
        recs[direction] = dict(
            kernel="tile_spmm_kernel", over=direction, shape="training",
            n_rows=n, hidden=hidden, max_abs_err=err, tol=TILE_TOL,
            kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
            library_covers=TILE_LIBRARY_COVERS, bound_us=bound_ms * 1e3,
            bound_by=bound_by, **_peak(cost), flops=cost["flops"],
            bytes=cost["bytes"], executed_flops=cost["executed_flops"],
            gbytes_per_s=cost["bytes"] / kernel_ms / 1e6, nnz=cost["nnz"],
            sender_rows=cost["sender_rows"],
            dense_layout_tiles=dict(edge=cost["edge_tiles"],
                                    filler=cost["filler_tiles"],
                                    pad=cost["pad_tiles"],
                                    vals_dtype=str(dense.vals.dtype)),
            **host_cost)
        emit(phase="tile_kernels", **recs[direction])
    return {"tile_spmm_kernel": dict(
        recs["A"], transpose_ms=recs["A^T"]["kernel_ms"])}


def phase_train(impl: str) -> dict:
    cfg = FlowGNNConfig(message_impl=impl)
    train_cfg = dataclasses.replace(TrainConfig(), max_epochs=TRAIN_EPOCHS)
    data_cfg = DataConfig(batch_size=256)
    examples, splits = _train_data(cfg.feature, train_cfg.seed)
    model = FlowGNN(cfg, device="cuda", seed=SEED)
    cpu_model = FlowGNN(cfg, device="cpu")
    cpu_model.load_state_dict({k: v.cpu()
                               for k, v in model.state_dict().items()})

    reset_launch_counts()
    t0 = time.perf_counter()
    _, history = loop.fit(model, examples, splits, train_cfg, data_cfg)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = launch_counts()

    losses = [x for e in history["epochs"] for x in e["step_losses"]]
    _, cpu_history = loop.fit(cpu_model, examples, splits, train_cfg,
                              data_cfg)
    cpu_losses = [x for e in cpu_history["epochs"] for x in e["step_losses"]]
    if len(losses) < 8 or len(losses) != len(cpu_losses):
        raise AssertionError(f"{impl}: {len(losses)} card steps, "
                             f"{len(cpu_losses)} CPU steps")
    diffs = np.abs(np.asarray(losses) - np.asarray(cpu_losses))
    if not np.all(np.isfinite(losses)) or diffs.max() > TRAIN_LOSS_TOL:
        raise AssertionError(f"{impl}: per-step loss |card - cpu| "
                             f"{diffs.max():.3e} > {TRAIN_LOSS_TOL}: card "
                             f"{losses} against cpu {cpu_losses}")
    val_diff = abs(history["epochs"][-1]["val_loss"]
                   - cpu_history["epochs"][-1]["val_loss"])
    steps = len(losses)
    exact = {"tile_spmm_kernel": 0}
    if impl == "persistent":
        need = ("persistent_fwd_kernel", "persistent_fwd_hist_kernel",
                "persistent_bwd_kernel", "step_weight_grad_kernel")
        if model.over_gate_dispatches == 0:
            exact["persistent_bwd_kernel"] = steps
    elif impl == "fused":
        need = ("fused_step_kernel", "fused_step_bwd_kernel",
                "step_weight_grad_kernel")
        exact["fused_step_bwd_kernel"] = cfg.n_steps * steps
    else:
        # Each train step: n_steps forward launches and n_steps backward
        # ones (over A^T); each evaluation batch: n_steps forward.
        val_batches = sum(1 for _ in loop._batches(
            examples, splits["val"], data_cfg, list(model.subkeys),
            data_cfg.eval_batch_size, build_tile_adj=True))
        need = ("tile_spmm_kernel",)
        exact = {**dict.fromkeys(fused_gnn.KERNELS, 0), "tile_spmm_kernel":
                 2 * cfg.n_steps * steps + cfg.n_steps * val_batches}
    if any(launches[k] == 0 for k in need) or any(
            launches[k] != v for k, v in exact.items()):
        raise AssertionError(f"{impl} train lane: launches {launches} over "
                             f"{steps} steps")

    batch = _training_batch(model)
    breakdown = _gnn_step_breakdown(model, batch)
    n_graphs = int(batch.graph_mask.sum())
    step_ms = (breakdown["forward_ms"] + breakdown["backward_ms"]
               + breakdown["optimizer_ms"])
    rec = dict(phase="train", message_impl=impl, steps=steps,
               epochs=len(history["epochs"]), launches=launches,
               over_gate_dispatches=model.over_gate_dispatches,
               losses=losses, cpu_losses=cpu_losses,
               max_abs_loss_diff_vs_cpu=float(diffs.max()),
               val_loss=history["epochs"][-1]["val_loss"],
               val_loss_diff_vs_cpu=val_diff,
               val_f1=history["epochs"][-1]["val_metrics"]["f1"],
               fit_wall_s=wall_s, step_breakdown=breakdown,
               step_profile=_profile_step(model, batch),
               graphs_per_step=n_graphs,
               graphs_per_s=n_graphs / (step_ms / 1e3))
    emit(**rec)
    return rec


# ---------------------------------------------------------------------------
# DeepDFA+LineVul: the flash-attention kernels and fit_text
# ---------------------------------------------------------------------------


def _attn_inputs(shape, seed: int, all_pad_row: bool = True):
    """q, k, v and a cotangent at the encoder's init scale (x after
    LayerNorm times lecun-normal weights: unit variance), and a kv mask
    with padded tails (and one all-pad row)."""
    b, t, h, d = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, g = (torch.randn(shape, generator=gen, device="cuda")
                  for _ in range(4))
    lengths = torch.randint(t // 2, t + 1, (b,), generator=gen,
                            device="cuda")
    if all_pad_row:
        lengths[-1] = 0
    mask = torch.arange(t, device="cuda")[None, :] < lengths[:, None]
    return q, k, v, mask, g


def _sdpa_calls(q, k, v, mask, g):
    """``F.scaled_dot_product_attention`` with the same boolean mask, as
    (forward, autograd backward) callables: the yardstick of
    ``library_ms``, used nowhere in the port."""
    import torch.nn.functional as F

    qt, kt, vt = (x.detach().transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    am = mask[:, None, None, :]

    def fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am)

    out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am)
    gt = g.transpose(1, 2).contiguous()

    def bwd():
        return torch.autograd.grad(out, (qt, kt, vt), gt, retain_graph=True)

    return fwd, bwd


def phase_attention_kernels() -> dict:
    """Each flash kernel against its plain version at the text training
    shape and the long shape, timed beside its bound and SDPA. Returns
    the numbers at the main-path shapes by kernel: the forward and the
    fused backward at T 512, the two-pass pair at T 4096."""
    out = {}
    for shape_name, shape, iters, reps in (("train", ATTN_TRAIN_SHAPE, 10, 3),
                                           ("long", ATTN_LONG_SHAPE, 2, 3)):
        b, t, h, d = shape
        q, k, v, mask, g = _attn_inputs(shape, SEED)
        # SDPA gives a fully masked row NaN: time it on the same inputs
        # with every row holding tokens.
        full = mask.clone()
        full[-1, : t // 2] = True
        lib_fwd, lib_bwd = _sdpa_calls(q, k, v, full, g)
        o, lse = attention.flash_fwd(q, k, v, mask)
        o_ref, lse_ref = attention.flash_fwd_reference(q, k, v, mask)
        err = max(_check(f"flash_fwd_kernel@{shape_name}", o, o_ref,
                         ATTN_FWD_TOL),
                  _check(f"flash_fwd_kernel@{shape_name} lse", lse, lse_ref,
                         ATTN_FWD_TOL))
        if not bool((o[-1] == 0).all()):
            raise AssertionError("flash_fwd_kernel: the all-pad row is not 0")
        _same_bits(f"flash_fwd_kernel twice@{shape_name}",
                   list(attention.flash_fwd(q, k, v, mask)), [o, lse])
        delta = attention.flash_delta(o_ref, g)
        args = (q, k, v, mask, g, lse_ref, delta)
        runs = {"flash_fwd_kernel": (
            err, lambda: attention.flash_fwd(q, k, v, mask),
            lambda: attention.flash_fwd_reference(q, k, v, mask), lib_fwd,
            ["o"])}
        dq = attention.flash_bwd_dq(*args)
        dk, dv = attention.flash_bwd_dkv(*args)
        if attention.flash_fused_bwd_ok(t, d):
            want = attention.flash_bwd_fused_reference(*args)
            fused = attention.flash_bwd_fused(*args)
            err = max(_check(f"flash_bwd_fused_kernel[{i}]@{shape_name}", a,
                             w, ATTN_GRAD_TOL)
                      for i, (a, w) in enumerate(zip(fused, want)))
            # Fused against the two-pass pair, kernel against kernel; and
            # against itself: no atomics, so a second launch on the same
            # inputs gives the same bits.
            for i, (a, c) in enumerate(zip(fused, (dq, dk, dv))):
                _check(f"fused vs two-pass [{i}]@{shape_name}", a, c,
                       ATTN_GRAD_TOL)
            _same_bits(f"flash_bwd_fused_kernel twice@{shape_name}",
                       list(attention.flash_bwd_fused(*args)), list(fused))
            runs["flash_bwd_fused_kernel"] = (
                err, lambda: attention.flash_bwd_fused(*args),
                lambda: attention.flash_bwd_fused_reference(*args), lib_bwd,
                BWD_COVERS)
        else:
            want = (attention.flash_bwd_dq_reference(*args),
                    *attention.flash_bwd_dkv_reference(*args))
        err_dq = _check(f"flash_bwd_dq_kernel@{shape_name}", dq, want[0],
                        ATTN_GRAD_TOL)
        err_dkv = max(_check(f"flash_bwd_dkv_kernel[{i}]@{shape_name}", a, w,
                             ATTN_GRAD_TOL)
                      for i, (a, w) in enumerate(zip((dk, dv), want[1:])))
        runs["flash_bwd_dq_kernel"] = (
            err_dq, lambda: attention.flash_bwd_dq(*args),
            lambda: attention.flash_bwd_dq_reference(*args), lib_bwd,
            BWD_COVERS)
        runs["flash_bwd_dkv_kernel"] = (
            err_dkv, lambda: attention.flash_bwd_dkv(*args),
            lambda: attention.flash_bwd_dkv_reference(*args), lib_bwd,
            BWD_COVERS)
        # The backward kernels own every sum (no atomics): a second launch
        # on the same inputs gives the same bits. A padded key has P = dS
        # = 0, so its dk and dv are exactly 0 (a key tile with no real key
        # is skipped and written as zeros), and the all-pad row's
        # gradients are 0 everywhere.
        _same_bits(f"flash_bwd_dq_kernel twice@{shape_name}",
                   [attention.flash_bwd_dq(*args)], [dq])
        _same_bits(f"flash_bwd_dkv_kernel twice@{shape_name}",
                   list(attention.flash_bwd_dkv(*args)), [dk, dv])
        for grad_name, x in (("dk", dk), ("dv", dv)):
            if bool(x[~mask].any()):
                raise AssertionError(f"{grad_name}@{shape_name}: a padded "
                                     "key's gradient is not 0")
        if bool(dq[-1].any()):
            raise AssertionError(f"dq@{shape_name}: the all-pad row is not 0")
        recs = {}
        for name, (err, kernel, plain, library, covers) in runs.items():
            kernel_ms = _time_ms(kernel, iters, reps)
            plain_ms = _time_ms(plain, iters, reps)
            library_ms = _time_ms(library, iters, reps)
            cost = attention.kernel_cost(mask, t, h, d, name)
            bound_ms, bound_by = _bound(cost)
            recs[name] = dict(
                kernel=name, shape=shape_name, B=b, T=t, H=h, D=d,
                real_key_fraction=float(mask.float().mean()),
                max_abs_err=err,
                tol=ATTN_FWD_TOL if name == "flash_fwd_kernel"
                else ATTN_GRAD_TOL,
                kernel_ms=kernel_ms, plain_ms=plain_ms,
                library_ms=library_ms, library_covers=covers,
                bound_us=bound_ms * 1e3, bound_by=bound_by, **_peak(cost),
                flops=cost["flops"], executed_flops=cost["executed_flops"],
                bytes=cost["bytes"],
                tflops=cost["flops"] / kernel_ms / 1e9,
                executed_tflops=cost["executed_flops"] / kernel_ms / 1e9)
            recs[name].update(bitwise_repeatable=True,
                              key_tiles=b * h * -(-t // 64),
                              key_tiles_skipped=cost["dead_key_tiles"])
            if name != "flash_fwd_kernel":
                # Each backward kernel's device ms a launch by the profiler
                # (the fused kernel's two launches apart: the products, then
                # the dq sum), over the launches it recorded.
                split = _device_profile(kernel, iters)["port_kernels"]
                recs[name].update(
                    device_split_ms={k: v["ms"] / v["calls"]
                                     for k, v in split.items()},
                    device_split_calls={k: v["calls"] * iters
                                        for k, v in split.items()})
        # SDPA's backward computes dq, dk and dv together: set the
        # two-pass pair's summed time beside it.
        pair_ms = (recs["flash_bwd_dq_kernel"]["kernel_ms"]
                   + recs["flash_bwd_dkv_kernel"]["kernel_ms"])
        for name in ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel"):
            recs[name]["pair_ms"] = pair_ms
        for name, rec in recs.items():
            emit(phase="attention_kernels", **rec)
            main_shape = ("long" if name in ("flash_bwd_dq_kernel",
                                             "flash_bwd_dkv_kernel")
                          else "train")
            if shape_name == main_shape:
                out[name] = rec
        del q, k, v, g, o, o_ref, args, dq, dk, dv, lib_fwd, lib_bwd, runs, \
            recs
        torch.cuda.empty_cache()
    return out


def _text_setup(enc: EncoderConfig, n: int, batch: int, block: int,
                message_impl: str = "segment"):
    """The model, data and fit_text arguments of ``cli fit-text
    --graphs synthetic [--set model.message_impl=...]`` at these sizes
    (one epoch)."""
    graph_cfg = FlowGNNConfig(encoder_mode=True, label_style="graph",
                              message_impl=message_impl)
    tcfg = TransformerTrainConfig(max_epochs=1, batch_size=batch,
                                  eval_batch_size=batch, block_size=block,
                                  seed=TEXT_SEED)
    data, splits, graphs = load_combined_dataset(
        f"synthetic:{n}", graph_cfg.feature, HashingCodeTokenizer(
            enc.vocab_size), block, graphs="synthetic", seed=TEXT_SEED)
    graphs, budget = graph_join_and_budget(list(graphs.values()), batch)
    kw = dict(graphs_by_id=graphs, subkeys=list(subkeys_for(
        graph_cfg.feature)), graph_budget=budget, pad_id=enc.pad_token_id)
    return graph_cfg, tcfg, data, splits, kw


def _fit_text_counted(model: LineVul, data, splits, tcfg, kw):
    """``fit_text`` with every kernel's count set to 0 just before and
    read just after: (history, launches, two-pass dispatches, seconds)."""
    reset_launch_counts()
    t0 = time.perf_counter()
    _, history = text_loop.fit_text(model, data, splits, tcfg, **kw)
    torch.cuda.synchronize()
    return (history, launch_counts(),
            attention.flash_backward.two_pass_dispatches,
            time.perf_counter() - t0)


def _text_steps(history) -> list:
    losses = [x for e in history["epochs"] for x in e["step_losses"]]
    if not losses or not np.all(np.isfinite(losses)):
        raise AssertionError(f"fit_text losses {losses}")
    return losses


def _require_launches(what: str, launches: dict, want: dict) -> None:
    """Exactly ``want``, and no launch of any other kernel."""
    if launches != {**dict.fromkeys(REPLACES, 0), **want}:
        raise AssertionError(f"{what}: launches {launches}, want {want}")


def _text_step_breakdown(model: LineVul, batch, tcfg) -> dict:
    """``_step_breakdown`` of make_text_train_step's step on one batch
    (dropout on; the clip belongs to the update)."""
    opt = text_loop.make_text_optimizer(model.parameters(), tcfg)
    params = list(model.parameters())
    ids, labels, mask, graphs = text_loop._on_device(batch, "cuda")
    gen = torch.Generator().manual_seed(TEXT_SEED)

    def forward_loss():
        opt.zero_grad(set_to_none=True)
        return cross_entropy_loss(model(ids, graphs, deterministic=False,
                                        generator=gen), labels, mask)

    def update():
        loop.clip_by_global_norm_(params, tcfg.grad_clip_norm)
        opt.step()

    return _step_breakdown(forward_loss, update, reps=5)


def phase_fit_text() -> dict:
    """DeepDFA+LineVul at the published width and depth."""
    enc = dataclasses.replace(EncoderConfig(), attention_impl="auto")
    graph_cfg, tcfg, data, splits, kw = _text_setup(enc, TEXT_N_FULL, 16,
                                                    512)
    model = LineVul(enc, graph_cfg, device="cuda", seed=SEED)
    history, launches, two_pass, wall_s = _fit_text_counted(
        model, data, splits, tcfg, kw)
    losses = _text_steps(history)
    val_batches = -(-len(splits["val"]) // tcfg.eval_batch_size)
    layers = enc.num_layers
    _require_launches("fit_text", launches, {
        "flash_fwd_kernel": layers * (len(losses) + val_batches),
        "flash_bwd_fused_kernel": layers * len(losses)})
    batch = next(text_loop.text_graph_batches(data, splits["train"],
                                              tcfg.batch_size, **kw))
    breakdown = _text_step_breakdown(model, batch, tcfg)
    step = text_loop.make_text_train_step(
        model, text_loop.make_text_optimizer(model.parameters(), tcfg), tcfg,
        torch.Generator().manual_seed(TEXT_SEED))
    profile = _device_profile(lambda: step(batch, tcfg.learning_rate),
                              TEXT_PROFILE_STEPS)
    step_ms = (breakdown["forward_ms"] + breakdown["backward_ms"]
               + breakdown["optimizer_ms"])
    n_rows = int(batch.example_mask.sum())
    rec = dict(phase="fit_text", layers=layers, hidden=enc.hidden_size,
               block_size=tcfg.block_size, batch_size=tcfg.batch_size,
               steps=len(losses), val_batches=val_batches, losses=losses,
               val_loss=history["epochs"][-1]["val_loss"],
               val_f1=history["epochs"][-1]["val_metrics"]["f1"],
               num_missing=history["epochs"][-1]["num_missing"],
               launches=launches, two_pass_dispatches=two_pass,
               fit_wall_s=wall_s, step_breakdown=breakdown,
               step_profile=profile, examples_per_step=n_rows,
               examples_per_s=n_rows / (step_ms / 1e3),
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    emit(**rec)
    return rec


def _text_grads(model: LineVul, batch, device) -> dict:
    """Parameter name -> the gradient of the loss on ``batch``."""
    ids, labels, mask, graphs = text_loop._on_device(batch, device)
    model.zero_grad(set_to_none=True)
    cross_entropy_loss(model(ids, graphs), labels, mask).backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return grads


def _compare_text_grads(got: dict, want: dict) -> dict:
    """Each gradient tensor, card against CPU: |got - want| <= GRAD_TOL
    * max|want| + TEXT_GRAD_FLOOR; returns the largest share of its limit
    a tensor's gap takes, and that tensor (``.cpu()`` waits for the
    card)."""
    if got.keys() != want.keys():
        raise AssertionError("card and CPU models differ in parameters")
    worst_share, worst_name = 0.0, None
    for name, w in want.items():
        g = got[name]
        if g is None or w is None or not torch.isfinite(g).all():
            raise AssertionError(f"gradient of {name}: missing or "
                                 "non-finite")
        diff = float((g.cpu() - w).abs().max())
        top = float(w.abs().max())
        limit = GRAD_TOL * top + TEXT_GRAD_FLOOR
        if diff > limit:
            raise AssertionError(f"gradient of {name}: |card - cpu| "
                                 f"{diff:.3e} > {GRAD_TOL} * {top:.3e} + "
                                 f"{TEXT_GRAD_FLOOR}")
        if worst_name is None or diff / limit > worst_share:
            worst_share, worst_name = diff / limit, name
    return {"grad_gap_share_of_limit": worst_share,
            "worst_tensor": worst_name, "tensors": len(want)}


def phase_fit_text_vs_cpu(message_impl: str = "segment") -> dict:
    """fit_text on the card and on the CPU from the same weights: full
    width, 2 layers, batch 4, dropout off, the graph encoder's
    ``message_impl``; one batch's gradients, then 3 steps."""
    enc = dataclasses.replace(EncoderConfig(), attention_impl="auto",
                              num_layers=2, dropout_rate=0.0)
    graph_cfg, tcfg, data, splits, kw = _text_setup(enc, TEXT_N_VS_CPU, 4,
                                                    512, message_impl)
    model = LineVul(enc, graph_cfg, device="cuda", seed=SEED)
    cpu_model = LineVul(enc, graph_cfg, device="cpu")
    cpu_model.load_state_dict({k: v.cpu()
                               for k, v in model.state_dict().items()})
    batch = next(text_loop.text_graph_batches(
        data, splits["train"], tcfg.batch_size,
        build_tile_adj=graph_cfg.uses_tile_adj, **kw))
    grads = _compare_text_grads(_text_grads(model, batch, "cuda"),
                                _text_grads(cpu_model, batch, "cpu"))
    history, launches, _, wall_s = _fit_text_counted(model, data, splits,
                                                     tcfg, kw)
    losses = _text_steps(history)
    t0 = time.perf_counter()
    _, cpu_history = text_loop.fit_text(cpu_model, data, splits, tcfg, **kw)
    cpu_s = time.perf_counter() - t0
    cpu_losses = _text_steps(cpu_history)
    diffs = np.abs(np.asarray(losses) - np.asarray(cpu_losses))
    if len(losses) != 3 or len(cpu_losses) != 3 or diffs.max() > \
            TEXT_LOSS_TOL:
        raise AssertionError(f"fit_text card {losses} against cpu "
                             f"{cpu_losses} (limit {TEXT_LOSS_TOL})")
    val_batches = -(-len(splits["val"]) // tcfg.eval_batch_size)
    want = {"flash_fwd_kernel": enc.num_layers * (3 + val_batches),
            "flash_bwd_fused_kernel": enc.num_layers * 3}
    if graph_cfg.uses_tile_adj:
        # The graph encoder: n_steps launches forward, n_steps backward a
        # train step; n_steps forward an evaluation batch.
        want["tile_spmm_kernel"] = graph_cfg.n_steps * (2 * 3 + val_batches)
    _require_launches(f"fit_text vs cpu ({message_impl})", launches, want)
    rec = dict(phase="fit_text_vs_cpu", graph_message_impl=message_impl,
               layers=enc.num_layers,
               batch_size=tcfg.batch_size, **grads, losses=losses,
               cpu_losses=cpu_losses,
               max_abs_loss_diff_vs_cpu=float(diffs.max()),
               val_loss_diff_vs_cpu=abs(
                   history["epochs"][-1]["val_loss"]
                   - cpu_history["epochs"][-1]["val_loss"]),
               launches=launches, fit_wall_s=wall_s, cpu_fit_s=cpu_s)
    emit(**rec)
    return rec


def phase_fit_text_long() -> dict:
    """fit_text at T 4096: the backward's gate sends it to the two-pass
    pair."""
    enc = dataclasses.replace(EncoderConfig(), attention_impl="auto",
                              num_layers=2)
    b, t = ATTN_LONG_SHAPE[:2]
    if attention.flash_fused_bwd_ok(t, enc.hidden_size // enc.num_heads):
        raise AssertionError("T 4096 passes the fused backward's gate")
    graph_cfg, tcfg, data, splits, kw = _text_setup(enc, TEXT_N_LONG, b, t)
    model = LineVul(enc, graph_cfg, device="cuda", seed=SEED)
    history, launches, two_pass, wall_s = _fit_text_counted(
        model, data, splits, tcfg, kw)
    losses = _text_steps(history)
    steps = len(losses)
    val_batches = -(-len(splits["val"]) // tcfg.eval_batch_size)
    _require_launches("fit_text at T 4096", launches, {
        "flash_fwd_kernel": enc.num_layers * (steps + val_batches),
        "flash_bwd_dq_kernel": enc.num_layers * steps,
        "flash_bwd_dkv_kernel": enc.num_layers * steps})
    if two_pass != enc.num_layers * steps:
        raise AssertionError(f"{two_pass} two-pass dispatches")
    # Where a long step's device time goes, the two-pass pair's share read
    # from the profiler.
    batch = next(text_loop.text_graph_batches(data, splits["train"],
                                              tcfg.batch_size, **kw))
    step = text_loop.make_text_train_step(
        model, text_loop.make_text_optimizer(model.parameters(), tcfg), tcfg,
        torch.Generator().manual_seed(TEXT_SEED))
    profile = _device_profile(lambda: step(batch, tcfg.learning_rate),
                              TEXT_PROFILE_STEPS)
    pair_ms = sum(profile["port_kernels"].get(name, {}).get("ms", 0.0)
                  for name in ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel"))
    rec = dict(phase="fit_text_long", layers=enc.num_layers, block_size=t,
               batch_size=b, steps=steps, losses=losses, launches=launches,
               two_pass_dispatches=two_pass, fit_wall_s=wall_s,
               step_s=wall_s / max(steps, 1), step_profile=profile,
               pair_ms_per_step=pair_ms,
               pair_share_of_device=pair_ms / profile["device_busy_ms"])
    emit(**rec)
    return rec


# ---------------------------------------------------------------------------
# The paper's two-stage recipe through the CLI, snapshots on disk
# ---------------------------------------------------------------------------


def _cli(argv) -> dict:
    """One command of ``deepdfa_tpu_torch.cli``, as ``main`` runs it; its
    JSON report (printed by the command, kept off this script's output)."""
    args = cli.build_parser().parse_args(argv)
    with contextlib.redirect_stdout(io.StringIO()):
        return args.func(args)


def _counted_cli(argv) -> tuple:
    """``_cli`` with every kernel's count set to 0 just before and read
    just after: (report, launches)."""
    reset_launch_counts()
    report = _cli(argv)
    torch.cuda.synchronize()
    return report, launch_counts()


def _read_history(run: str) -> dict:
    with open(os.path.join(run, "history.json")) as f:
        return json.load(f)


def _read_probs(path: str) -> dict:
    with open(path) as f:
        return {int(r["index"]): float(r["prob"]) for r in csv.DictReader(f)}


def _snapshot_costs(run: str, scratch: str) -> list:
    """Each snapshot of ``run``: its bytes; the ms of its sha256
    (``checksum_ms``), of a verified restore onto the card by a fresh
    manager (``restore_ms``: the checksum, then ``torch.load``), and of
    writing the restored state back from the card into ``scratch``
    (``save_ms``: the copy to the host, ``torch.save`` with fsync, the
    checksum and the meta commit, as a trainer's save runs). The files
    are in the host's page cache throughout."""
    out = []
    for name in sorted(os.listdir(run)):
        path = os.path.join(run, name)
        if not os.path.isdir(path):
            continue
        t0 = time.perf_counter()
        train_checkpoint.snapshot_checksum(path)
        checksum_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        tree = train_checkpoint.CheckpointManager(run).restore(
            name, map_location="cuda")
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        train_checkpoint.CheckpointManager(scratch).save_last(tree, 0)
        save_ms = (time.perf_counter() - t0) * 1e3
        out.append(dict(run=os.path.basename(run), snapshot=name,
                        trainer_state="opt_state" in tree,
                        bytes=os.path.getsize(os.path.join(
                            path, train_checkpoint.STATE_FILE)),
                        save_ms=save_ms, checksum_ms=checksum_ms,
                        restore_ms=restore_ms))
        del tree
        shutil.rmtree(scratch, ignore_errors=True)
    return out


def _frozen_step_profile(model: LineVul, data, splits, tcfg, kw) -> dict:
    """Device ms a step of the frozen fine-tune, by kernel: the graph
    encoder frozen as ``fit_text(freeze_submodules=("flowgnn",))``
    freezes it, one batch."""
    model.flowgnn.requires_grad_(False)
    step = text_loop.make_text_train_step(
        model, text_loop.make_text_optimizer(model.parameters(), tcfg), tcfg,
        torch.Generator().manual_seed(TEXT_SEED))
    batch = next(text_loop.text_graph_batches(
        data, splits["train"], tcfg.batch_size, build_band_adj=True, **kw))
    return _device_profile(lambda: step(batch, tcfg.learning_rate),
                           TEXT_PROFILE_STEPS)


def phase_recipe() -> dict:
    """``fit`` -> ``test`` -> ``score`` -> ``fit-text --ddfa-checkpoint
    --freeze-graph`` -> ``test-text`` at the published widths, each
    through the CLI, in a temporary directory removed afterwards."""
    root = tempfile.mkdtemp(prefix="recipe_")
    try:
        return _recipe(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _recipe(root: str) -> dict:
    full, cut, text_run = (os.path.join(root, d)
                           for d in ("ddfa", "ddfa_cut", "combined"))
    gnn = ["--dataset", f"synthetic:{N_TRAIN_EXAMPLES}", "--message-impl",
           "persistent", "--device", "cuda"]
    launches = {k: 0 for k in REPLACES}

    def add(counts):
        for k, v in counts.items():
            launches[k] += v
        return counts

    # Stage 1: train DDFA, 2 epochs; then 1 epoch resumed to 2.
    t0 = time.perf_counter()
    fit_report, counts = _counted_cli(["fit", *gnn, "--max-epochs", "2",
                                       "--checkpoint-dir", full])
    fit_s = time.perf_counter() - t0
    fit_launches = add(counts)
    add(_counted_cli(["fit", *gnn, "--max-epochs", "1", "--checkpoint-dir",
                      cut])[1])
    resumed, counts = _counted_cli(["fit", *gnn, "--max-epochs", "2",
                                    "--checkpoint-dir", cut, "--resume"])
    add(counts)
    want, got = _read_history(full), _read_history(cut)
    if (got["resumed_from"] != {"name": "last", "epoch": 0,
                                "fallback": False}
            or [e["epoch"] for e in got["epochs"]] != [1]
            or got["epochs"][0]["step_losses"]
            != want["epochs"][1]["step_losses"]
            or got["epochs"][0]["val_loss"] != want["epochs"][1]["val_loss"]
            or resumed != fit_report):
        raise AssertionError(
            f"resumed fit {got['epochs'][0]['step_losses']} val "
            f"{got['epochs'][0]['val_loss']} against the uninterrupted "
            f"epoch 1 {want['epochs'][1]['step_losses']} val "
            f"{want['epochs'][1]['val_loss']}")
    if any(fit_launches[k] == 0 for k in (
            "persistent_fwd_kernel", "persistent_fwd_hist_kernel",
            "persistent_bwd_kernel", "step_weight_grad_kernel")):
        raise AssertionError(f"fit launches {fit_launches}")

    # Evaluate: test on the card and on the CPU, score the test split.
    test_card, counts = _counted_cli(["test", *gnn, "--checkpoint-dir",
                                      full])
    add(counts)
    card_probs = _read_probs(os.path.join(full, "test_predictions.csv"))
    if counts["persistent_fwd_kernel"] == 0:
        raise AssertionError(f"test launches {counts}")
    test_cpu = _cli(["test", *gnn[:-1], "cpu", "--checkpoint-dir", full])
    test_loss_diff = abs(test_card["loss"] - test_cpu["loss"])
    if test_loss_diff > RECIPE_TEST_TOL:
        raise AssertionError(f"test loss card {test_card['loss']} against "
                             f"cpu {test_cpu['loss']}")
    score, counts = _counted_cli([
        "score", *gnn, "--seed", "1", "--split", "test", "--checkpoint-dir",
        full, "--out-dir", os.path.join(root, "score")])
    add(counts)
    scored = _read_probs(score["out"])
    if scored.keys() != card_probs.keys() or score["n_errors"]:
        raise AssertionError(f"score covers {sorted(scored)}, test "
                             f"{sorted(card_probs)}")
    score_diff = max(abs(scored[i] - card_probs[i]) for i in scored)
    if score_diff > SERVE_TOL or counts["persistent_fwd_kernel"] == 0:
        raise AssertionError(f"score against test: {score_diff} (limit "
                             f"{SERVE_TOL}); launches {counts}")

    # Stage 2: fine-tune DeepDFA+LineVul from the frozen encoder.
    enc = EncoderConfig()
    t0 = time.perf_counter()
    ft, ft_launches = _counted_cli([
        "fit-text", "--dataset", f"synthetic:{TEXT_N_FULL}", "--graphs",
        "synthetic", "--epochs", "1", "--batch-size", "16", "--block-size",
        "512", "--set", "model.message_impl=persistent", "--ddfa-checkpoint",
        full, "--which", "best", "--freeze-graph", "--checkpoint-dir",
        text_run, "--device", "cuda"])
    fit_text_s = time.perf_counter() - t0
    add(ft_launches)
    history = _read_history(text_run)
    steps = len(history["epochs"][0]["step_losses"])
    graph_cfg, tcfg, data, splits, kw = _text_setup(
        enc, TEXT_N_FULL, 16, 512, "persistent")
    val_batches = -(-len(splits["val"]) // tcfg.eval_batch_size)
    test_batches = -(-len(splits["test"]) // tcfg.eval_batch_size)
    batches = steps + val_batches + test_batches
    over_gate = ft_launches["fused_step_kernel"] // graph_cfg.n_steps
    _require_launches("frozen fit-text", ft_launches, {
        "flash_fwd_kernel": enc.num_layers * batches,
        "flash_bwd_fused_kernel": enc.num_layers * steps,
        "persistent_fwd_kernel": batches - over_gate,
        "fused_step_kernel": graph_cfg.n_steps * over_gate})

    # The frozen encoder: T's best holds D's best encoder bit for bit,
    # and the pooling at the combined model's seeded init.
    encoder = train_checkpoint.load_encoder_params(
        train_checkpoint.CheckpointManager(full).restore_params("best"))
    tuned = train_checkpoint.CheckpointManager(text_run).restore_params(
        "best", map_location="cuda")
    model = LineVul(dataclasses.replace(enc, attention_impl="auto"),
                    graph_cfg, device="cuda", seed=TEXT_SEED)
    fresh = model.state_dict()
    pooling = [k for k in fresh if k.startswith("flowgnn.pooling.")]
    changed = [k for k, v in encoder.items()
               if not torch.equal(tuned[f"flowgnn.{k}"].cpu(), v)]
    changed += [k for k in pooling if not torch.equal(tuned[k], fresh[k])]
    if changed or not pooling:
        raise AssertionError(f"frozen encoder moved: {changed}")
    model.load_state_dict(tuned)
    frozen_profile = _frozen_step_profile(model, data, splits, tcfg, kw)
    del model, tuned

    # Evaluate the fine-tune from its snapshot.
    tt, counts = _counted_cli(["test-text", "--checkpoint-dir", text_run,
                               "--device", "cuda"])
    add(counts)
    with open(os.path.join(text_run, "predictions.csv")) as f:
        fit_rows = f.read()
    with open(os.path.join(text_run, "test_predictions.csv")) as f:
        test_rows = f.read()
    if tt["loss"] != ft["test"]["loss"] or test_rows != fit_rows:
        raise AssertionError(f"test-text loss {tt['loss']} against "
                             f"fit-text's {ft['test']['loss']}")

    snapshots = []
    for run in (full, text_run):
        snapshots += _snapshot_costs(run, os.path.join(root, "resave"))
    rec = dict(phase="recipe", fit_epochs=len(want["epochs"]),
               fit_steps=sum(len(e["step_losses"]) for e in want["epochs"]),
               fit_wall_s=fit_s, best_epoch=fit_report["best_epoch"],
               best_val_loss=fit_report["best_val_loss"],
               resumed_bits_equal=True,
               resumed_step_losses=got["epochs"][0]["step_losses"],
               test_loss=test_card["loss"], test_loss_cpu=test_cpu["loss"],
               test_loss_diff_vs_cpu=test_loss_diff,
               score_max_abs_diff_vs_test=score_diff,
               n_test=len(card_probs),
               fit_text_wall_s=fit_text_s, fit_text_steps=steps,
               fit_text_losses=history["epochs"][0]["step_losses"],
               fit_text_test_loss=ft["test"]["loss"],
               frozen_encoder_bits_equal=True,
               test_text_bits_equal=True, fit_text_launches=ft_launches,
               fit_text_over_gate_dispatches=over_gate,
               frozen_step_profile=frozen_profile, snapshots=snapshots,
               launches=launches)
    emit(**rec)
    return rec


# ---------------------------------------------------------------------------
# Real inputs: a JSONL corpus, MSR CSVs, BPE assets and HF weights
# ---------------------------------------------------------------------------

# Rows planted in the validate phase's bad file: one per fatal reason,
# and one integral-float feature array (repaired, kept).
PLANTED_FATAL = ("truncated_json", "dangling_endpoint", "negative_feature",
                 "empty_graph", "missing_subkey", "label_domain",
                 "checksum_mismatch")
# The CSV subset fit_text reads (the pinned partition's first rows):
# 6 steps of 16, two evaluation batches each for val and test.
CSV_ROWS = {"train": 96, "val": 32, "test": 32}
# The most merges the phase learns for its BPE assets by pair counting:
# codebert-base's table (50,265 ids: 5 specials, 256 bytes, the merges).
BPE_MERGES = 50004
# The checkout's source files that the merges are also learned on, so
# the table holds real code's words beside the corpus's.
CODE_SUFFIXES = (".py", ".cu", ".cuh", ".cc", ".h")
# codebert-base's config.json, as HuggingFace writes it.
CODEBERT_CONFIG = {
    "model_type": "roberta", "architectures": ["RobertaModel"],
    "vocab_size": 50265, "hidden_size": 768, "num_hidden_layers": 12,
    "num_attention_heads": 12, "intermediate_size": 3072,
    "hidden_act": "gelu", "hidden_dropout_prob": 0.1,
    "attention_probs_dropout_prob": 0.1, "max_position_embeddings": 514,
    "type_vocab_size": 1, "initializer_range": 0.02,
    "layer_norm_eps": 1e-05, "pad_token_id": 1, "bos_token_id": 0,
    "eos_token_id": 2, "position_embedding_type": "absolute"}
CONFIG_YAML = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "configs", "default.yaml")


def _cli_rc(argv) -> tuple:
    """``cli.main(argv)``: (exit code, its JSON report), the report kept
    off this script's output."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    return rc, json.loads(out.getvalue().strip().splitlines()[-1])


def _planted_rows(examples) -> list:
    """The bad file's lines: each reason of ``PLANTED_FATAL`` once, one
    float_field repair and two clean rows."""
    rows = [ingest.encode_row(ex) for ex in examples[:len(PLANTED_FATAL) + 3]]
    lines = []
    for reason, row in zip(PLANTED_FATAL, rows):
        n = int(row["num_nodes"])
        if reason == "dangling_endpoint":
            row["senders"][0] = n + 3
        elif reason == "negative_feature":
            row["feats"]["api"][0] = -5
        elif reason == "empty_graph":
            row.update(num_nodes=0, senders=[], receivers=[], vuln=[],
                       df_in=[], df_out=[])
            row["feats"] = {k: [] for k in row["feats"]}
        elif reason == "missing_subkey":
            row["feats"].pop("literal")
        elif reason == "label_domain":
            row["label"] = 7
        text = json.dumps(row)
        if reason == "checksum_mismatch":
            row[schema.CHECKSUM_KEY] = schema.row_checksum(row)
            row["label"] = 1 - int(row["label"])
            text = json.dumps(row)
        elif reason == "truncated_json":
            text = text[: len(text) // 2]
        lines.append(text)
    repaired = rows[len(PLANTED_FATAL)]
    repaired["feats"]["api"] = [float(v) for v in repaired["feats"]["api"]]
    lines.append(json.dumps(repaired))
    lines += [json.dumps(r) for r in rows[len(PLANTED_FATAL) + 1:]]
    return lines


def _same_examples(loaded, generated) -> None:
    """The loaded examples are the generated ones, byte for byte (the
    loader's int32 arrays against the generator's arrays as int32; the
    loader's fast path, as the reference's, passes the optional per-node
    keys through as the parsed lists)."""
    if [ex["id"] for ex in loaded] != [ex["id"] for ex in generated]:
        raise AssertionError("loaded ids differ from the generated ones")
    for got, want in zip(loaded, generated):
        if (got["num_nodes"] != want["num_nodes"]
                or got["label"] != want["label"]):
            raise AssertionError(f"example {want['id']}: scalars differ")
        if any(got[k].dtype != np.int32 for k in ("senders", "receivers",
                                                  "vuln")):
            raise AssertionError(f"example {want['id']}: not int32")
        pairs = [(got[k], want[k]) for k in ("senders", "receivers", "vuln",
                                             "df_in", "df_out")]
        pairs += [(got["feats"][k], want["feats"][k]) for k in want["feats"]]
        for g, w in pairs:
            if np.asarray(g, np.int32).tobytes() != np.asarray(
                    w, np.int32).tobytes():
                raise AssertionError(f"example {want['id']}: arrays differ")


def _write_msr_csvs(root: str, examples, pin) -> dict:
    """train/val/test.csv in the MSR layout (first column the example id,
    ``processed_func``, ``target``) from the pinned partition's first
    rows; one function passes the csv module's 131,072-character field
    limit and one field holds quotes and newlines."""
    by_id = {ex["id"]: ex for ex in examples}
    rows = {}
    for split, n in CSV_ROWS.items():
        ids = [i for i, part in sorted(pin.items()) if part == split][:n]
        rows[split] = attach_synthetic_text(
            [dict(by_id[i]) for i in ids], seed=TEXT_SEED)
    rows["train"][0]["code"] += "\n/* " + "padding " * 17000 + "*/"
    rows["train"][1]["code"] = rows["train"][1]["code"].replace(
        "{\n", '{\n  printf("a \\"quoted\\" %s,\\n", buf);\n', 1)
    if len(rows["train"][0]["code"]) <= 131072:
        raise AssertionError("the long function is too short")
    for split, table in rows.items():
        with open(os.path.join(root, f"{split}.csv"), "w",
                  newline="", encoding="utf-8") as f:
            w = csv.writer(f)
            w.writerow(["", "processed_func", "target"])
            for ex in table:
                w.writerow([ex["id"], ex["code"], ex["label"]])
    return rows


def _code_texts() -> list:
    """The checkout's source files (``CODE_SUFFIXES``), in path order,
    without hidden directories and build outputs."""
    top = os.path.dirname(os.path.abspath(__file__))
    texts = []
    for here, dirs, files in os.walk(top):
        dirs[:] = sorted(d for d in dirs if not d.startswith(".")
                         and d not in ("_build", "__pycache__"))
        for name in sorted(files):
            if name.endswith(CODE_SUFFIXES):
                with open(os.path.join(here, name), encoding="utf-8",
                          errors="replace") as f:
                    texts.append(f.read())
    return texts


def _learn_bpe(root: str, texts) -> int:
    """A roberta-order byte-level BPE asset pair (``<s>`` 0, ``<pad>`` 1,
    ``</s>`` 2, ``<unk>`` 3, ``<mask>`` 4, then the 256 byte symbols and
    the merged ones), its merges learned by pair counting over the
    texts' words: each round merges the most frequent adjacent pair
    (the least pair on a tie), until every word is one symbol or
    ``BPE_MERGES`` are learned. Pair counts are updated in the words a
    merge touches only. Returns (merges, vocabulary size): two merges
    can make one string."""
    table = bpe.bytes_to_unicode()
    counts = {}
    for text in texts:
        for w in bpe.split_words(text):
            key = "".join(table[b] for b in w.encode("utf-8"))
            counts[key] = counts.get(key, 0) + 1
    words = [list(w) for w in counts]
    freq = list(counts.values())
    pairs, where = {}, {}
    for i, w in enumerate(words):
        for pair in zip(w, w[1:]):
            pairs[pair] = pairs.get(pair, 0) + freq[i]
            where.setdefault(pair, set()).add(i)
    heap = [(-c, pair) for pair, c in pairs.items()]
    heapq.heapify(heap)
    merges = []
    while heap and len(merges) < BPE_MERGES:
        c, pair = heapq.heappop(heap)
        if pairs.get(pair) != -c:
            continue  # a count that a later merge changed
        merges.append(pair)
        a, b = pair
        touched = set()
        for i in where.pop(pair):
            w, f = words[i], freq[i]
            for old in zip(w, w[1:]):
                pairs[old] -= f
                touched.add(old)
            out, k = [], 0
            while k < len(w):
                if k + 1 < len(w) and w[k] == a and w[k + 1] == b:
                    out.append(a + b)
                    k += 2
                else:
                    out.append(w[k])
                    k += 1
            words[i] = out
            for new in zip(out, out[1:]):
                pairs[new] = pairs.get(new, 0) + f
                where.setdefault(new, set()).add(i)
                touched.add(new)
        del pairs[pair]
        for t in touched:
            if pairs.get(t, 0) > 0:
                heapq.heappush(heap, (-pairs[t], t))
    vocab = {t: i for i, t in enumerate(
        ["<s>", "<pad>", "</s>", "<unk>", "<mask>"])}
    for t in list(table.values()) + [a + b for a, b in merges]:
        vocab.setdefault(t, len(vocab))
    with open(os.path.join(root, "codebert-vocab.json"), "w",
              encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    with open(os.path.join(root, "codebert-merges.txt"), "w",
              encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n"
                                            for a, b in merges))
    return len(merges), len(vocab)


def phase_inputs() -> dict:
    """Real inputs through validate, analyze, fit (both label styles), a
    pretrained fine-tune from CSVs and BPE assets, and test-text, in a
    temporary directory removed afterwards."""
    root = tempfile.mkdtemp(prefix="inputs_")
    try:
        return _inputs(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _inputs(root: str) -> dict:
    seconds = {}
    launches = {k: 0 for k in REPLACES}

    def add(counts):
        for k, v in counts.items():
            launches[k] += v
        return counts

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    # The corpus: the ETL export format (no digests: the fast path),
    # df_in/df_out attached, and a pinned 80/10/10 partition by id.
    cfgs = core_config.build_configs([CONFIG_YAML], ["train.max_epochs=1"])
    feature = cfgs["model"].feature
    generated = load_graph_source(f"synthetic:{N_TRAIN_EXAMPLES}", feature,
                                  seed=TrainConfig().seed)
    corpus_dir = os.path.join(root, "cache")
    corpus = os.path.join(corpus_dir, "corpus.jsonl")
    timed("write_corpus", ingest.write_examples_jsonl, generated, corpus,
          False)
    perm = np.random.default_rng(SEED).permutation(len(generated))
    n_train, n_val = int(0.8 * len(perm)), int(0.1 * len(perm))
    pin = {int(generated[i]["id"]): ("train" if k < n_train else "val"
                                     if k < n_train + n_val else "test")
           for k, i in enumerate(perm)}
    with open(os.path.join(corpus_dir, "splits.json"), "w") as f:
        json.dump({str(i): part for i, part in pin.items()}, f)
    bad_dir = os.path.join(root, "bad")
    os.makedirs(bad_dir)
    bad = os.path.join(bad_dir, "bad.jsonl")
    with open(bad, "w") as f:
        f.write("\n".join(_planted_rows(generated)) + "\n")

    # validate: the planted reasons exactly; the clean corpus passes.
    rc_bad, rep_bad = timed("validate_bad", _cli_rc, ["validate", bad])
    want_reasons = dict.fromkeys(sorted(PLANTED_FATAL), 1)
    if (rc_bad != 1 or rep_bad["quarantined"] != len(PLANTED_FATAL)
            or rep_bad["by_reason"] != want_reasons
            or rep_bad["repaired"] != 1 or rep_bad["loaded"] != 3):
        raise AssertionError(f"validate of the planted rows: rc {rc_bad}, "
                             f"{rep_bad}")
    rc_clean, rep_clean = timed("validate_clean", _cli_rc,
                                ["validate", corpus])
    if rc_clean != 0 or rep_clean["loaded"] != len(generated):
        raise AssertionError(f"validate of the corpus: rc {rc_clean}, "
                             f"{rep_clean}")

    # analyze: the coverage a numpy count over the same arrays gives.
    _, coverage = timed("analyze", _cli_rc, [
        "analyze", "--dataset", corpus, "--config", CONFIG_YAML])
    for k in subkeys_for(feature):
        f = np.concatenate([np.asarray(ex["feats"][k]) for ex in generated])
        want = {"definitions": int((f > 0).sum()),
                "coverage": float((f > 1).sum() / (f > 0).sum()),
                "nondef_nodes": int((f == 0).sum())}
        if coverage[k] != want:
            raise AssertionError(f"analyze {k}: {coverage[k]} against {want}")

    # The corpus as fit reads it: the generated examples, byte for byte,
    # split by the pin.
    t0 = time.perf_counter()
    loaded, splits = cli.load_dataset(corpus, feature, seed=TrainConfig().seed)
    seconds["load_corpus"] = time.perf_counter() - t0
    _same_examples(loaded, generated)
    for part, idx in splits.items():
        if any(pin[int(loaded[i]["id"])] != part for i in idx):
            raise AssertionError(f"the {part} split is not the pinned one")

    # fit from the corpus, graph labels, persistent lane; then the same
    # fit from the generated examples in memory: the same losses, bit for
    # bit.
    run = os.path.join(root, "ddfa")
    gnn = ["--dataset", corpus, "--config", CONFIG_YAML, "--set",
           "train.max_epochs=1", "--device", "cuda"]
    t0 = time.perf_counter()
    fit_report, counts = _counted_cli(["fit", *gnn, "--checkpoint-dir", run])
    seconds["fit_jsonl"] = time.perf_counter() - t0
    fit_launches = add(counts)
    history = _read_history(run)
    if any(fit_launches[k] == 0 for k in (
            "persistent_fwd_kernel", "persistent_fwd_hist_kernel",
            "persistent_bwd_kernel", "step_weight_grad_kernel")):
        raise AssertionError(f"fit launches {fit_launches}")
    if not any(f.startswith("run_") and f.endswith(".log")
               for f in os.listdir(run)):
        raise AssertionError(f"no run log in {os.listdir(run)}")
    model_cfg = dataclasses.replace(cfgs["model"], message_impl="persistent")
    model = FlowGNN(model_cfg, device="cuda", seed=cfgs["train"].seed)
    pinned = make_splits(generated, mode="fixed", fixed=pin)
    _, memory = loop.fit(model, generated, pinned, cfgs["train"], cfgs["data"])
    card_losses = history["epochs"][0]["step_losses"]
    if (memory["epochs"][0]["step_losses"] != card_losses
            or memory["epochs"][0]["val_loss"]
            != history["epochs"][0]["val_loss"]):
        raise AssertionError(f"fit from the corpus {card_losses} against "
                             f"the in-memory fit "
                             f"{memory['epochs'][0]['step_losses']}")
    del model

    # The dataflow labels: one epoch on the card, its first step's loss
    # held to the CPU's from the same weights and batch.
    df_run = os.path.join(root, "ddfa_df")
    style = "dataflow_solution_in"
    t0 = time.perf_counter()
    _, counts = _counted_cli(["fit", *gnn, "--set",
                              f"model.label_style={style}",
                              "--checkpoint-dir", df_run])
    seconds["fit_dataflow"] = time.perf_counter() - t0
    df_launches = add(counts)
    df_losses = _read_history(df_run)["epochs"][0]["step_losses"]
    df_cfg = dataclasses.replace(model_cfg, label_style=style)
    cpu_model = FlowGNN(df_cfg, device="cpu", seed=cfgs["train"].seed)
    data_cfg = cfgs["data"]
    train_idx = pinned["train"]
    order = epoch_indices([generated[i]["label"] for i in train_idx], 0,
                          seed=data_cfg.seed,
                          undersample_factor=data_cfg.undersample_factor,
                          oversample_factor=data_cfg.oversample_factor)
    first = next(iter(loop._batches(
        generated, train_idx[order], data_cfg, list(subkeys_for(feature)),
        data_cfg.batch_size, build_band_adj=True, with_dataflow=True)))
    cpu_step = loop.make_train_step(cpu_model, loop.make_optimizer(
        cpu_model.parameters(), cfgs["train"]), cfgs["train"])
    cpu_loss = float(cpu_step(first)[0])
    df_diff = abs(df_losses[0] - cpu_loss)
    if not np.all(np.isfinite(df_losses)) or df_diff > TRAIN_LOSS_TOL:
        raise AssertionError(f"{style}: first step {df_losses[0]} on the "
                             f"card against {cpu_loss} on the CPU")
    if df_launches["persistent_bwd_kernel"] == 0:
        raise AssertionError(f"{style} fit launches {df_launches}")
    del cpu_model

    # MSR CSVs, BPE assets learned from them, HF weights on disk.
    csv_dir = os.path.join(root, "msr")
    tok_dir = os.path.join(root, "bpe")
    hf_dir = os.path.join(root, "codebert")
    for d in (csv_dir, tok_dir, hf_dir):
        os.makedirs(d)
    rows = _write_msr_csvs(csv_dir, generated, pin)
    texts = [ex["code"] for table in rows.values() for ex in table]
    functions = attach_synthetic_text([dict(ex) for ex in generated],
                                      seed=TEXT_SEED)
    n_merges, vocab_size = timed("learn_bpe", _learn_bpe, tok_dir,
                     [ex["code"] for ex in functions] + _code_texts())
    # The tokenizer's rate: a fresh load, then every corpus function.
    t0 = time.perf_counter()
    tok = load_bpe_tokenizer(tok_dir)
    by_function = encode_dataset(functions, tok, block_size=512)
    seconds["tokenize_corpus"] = time.perf_counter() - t0
    encoded = encode_dataset([dict(ex) for t in rows.values() for ex in t],
                             tok, block_size=512)
    if tok.pad_token_id != 1 or tok.vocab_size != vocab_size:
        raise AssertionError(f"BPE assets: pad {tok.pad_token_id}, vocab "
                             f"{tok.vocab_size}")
    enc = EncoderConfig()
    t0 = time.perf_counter()
    seeded = RobertaEncoder(enc, torch.Generator().manual_seed(TEXT_SEED))
    source = seeded.state_dict()
    pretrained.write_safetensors(os.path.join(hf_dir, "model.safetensors"),
                                 convert.roberta_to_hf(source),
                                 {"format": "pt"})
    with open(os.path.join(hf_dir, "config.json"), "w") as f:
        json.dump(CODEBERT_CONFIG, f, indent=2)
    seconds["write_hf"] = time.perf_counter() - t0
    del seeded
    t0 = time.perf_counter()
    kind, hf_enc, hf_params = pretrained.load_pretrained(
        hf_dir, attention_impl="auto")
    seconds["load_pretrained"] = time.perf_counter() - t0
    moved = [k for k, v in source.items() if not torch.equal(hf_params[k], v)]
    if kind != "roberta" or moved or sorted(hf_params) != sorted(source):
        raise AssertionError(f"load_pretrained: {kind}, changed {moved}")
    del source

    # fit_text from the pretrained encoder and the fit run's frozen graph
    # encoder, on the CSVs joined with the corpus, the BPE tokenizer.
    graph_cfg = dataclasses.replace(model_cfg, encoder_mode=True,
                                    label_style="graph")
    tcfg = TransformerTrainConfig(max_epochs=1, batch_size=16,
                                  eval_batch_size=16, block_size=512,
                                  seed=TEXT_SEED)
    data, tsplits, graphs = load_combined_dataset(
        csv_dir, feature, tok, tcfg.block_size, graphs=corpus,
        seed=TEXT_SEED)
    if data["input_ids"].tobytes() != encoded["input_ids"].tobytes():
        raise AssertionError("the CSVs tokenized two ways differ")
    graphs, budget = graph_join_and_budget(list(graphs.values()),
                                           tcfg.batch_size)
    kw = dict(graphs_by_id=graphs, subkeys=list(subkeys_for(feature)),
              graph_budget=budget, pad_id=hf_enc.pad_token_id)
    model = LineVul(hf_enc, graph_cfg, device="cuda", seed=TEXT_SEED)
    init = {f"roberta.{k}": v for k, v in hf_params.items()}
    init.update({f"flowgnn.{k}": v for k, v in
                 train_checkpoint.load_encoder_params(
                     train_checkpoint.CheckpointManager(run).restore_params(
                         "best")).items()})
    del hf_params
    reset_launch_counts()
    t0 = time.perf_counter()
    best, ft_history = text_loop.fit_text(
        model, data, tsplits, tcfg, init_params=init,
        freeze_submodules=("flowgnn",), **kw)
    torch.cuda.synchronize()
    seconds["fit_text"] = time.perf_counter() - t0
    ft_launches = add(launch_counts())
    ft_losses = _text_steps(ft_history)
    if len(ft_losses) != CSV_ROWS["train"] // tcfg.batch_size or any(
            ft_launches[k] == 0 for k in ("flash_fwd_kernel",
                                          "flash_bwd_fused_kernel",
                                          "persistent_fwd_kernel")):
        raise AssertionError(f"fit_text: {ft_losses}, launches "
                             f"{ft_launches}")
    text_run = os.path.join(root, "combined")
    train_checkpoint.make_checkpoint_manager(text_run).save_best(
        {"params": best.params}, ft_history["best_epoch"],
        metrics={"val_f1": ft_history["best_val_f1"]})
    with open(os.path.join(text_run, "model.json"), "w") as f:
        json.dump({"model": "linevul", "tiny": False, "attention_impl": "auto",
                   "remat": False, "gelu_approximate": hf_enc.gelu_approximate,
                   "combined": True, "block_size": tcfg.block_size,
                   "dataset": csv_dir, "split_mode": "random",
                   "graphs": corpus, "tokenizer": tok_dir,
                   "batch_size": tcfg.batch_size, "graph_budget": budget,
                   "graph_config": dataclasses.asdict(graph_cfg),
                   "seed": TEXT_SEED}, f, indent=1)
    model.load_state_dict(best.params)
    ft_test = text_loop.evaluate_text(
        text_loop.make_text_eval_step(model), data, tsplits["test"], tcfg,
        build_band_adj=True, **kw)
    step_profile = _frozen_step_profile(model, data, tsplits, tcfg, kw)
    del model, best, init

    # test-text from the snapshot, with the BPE assets: fit_text's test,
    # bit for bit.
    t0 = time.perf_counter()
    tt, counts = _counted_cli(["test-text", "--checkpoint-dir", text_run,
                               "--tokenizer", tok_dir, "--device", "cuda"])
    seconds["test_text"] = time.perf_counter() - t0
    add(counts)
    got = _read_probs(os.path.join(text_run, "test_predictions.csv"))
    want = {int(i): float(f"{p:.6f}") for i, p in zip(ft_test["index"],
                                                      ft_test["probs"])}
    if tt["loss"] != ft_test["loss"] or got != want or tt["split"] != "test":
        raise AssertionError(f"test-text loss {tt['loss']} against "
                             f"fit_text's test {ft_test['loss']}")

    rec = dict(phase="inputs", seconds=seconds,
               corpus_rows=len(generated),
               corpus_rows_per_s=len(generated) / seconds["load_corpus"],
               tokenizer_functions=len(functions),
               tokenizer_functions_per_s=len(functions)
               / seconds["tokenize_corpus"],
               corpus_tokens_per_row_mean=float(
                   (by_function["input_ids"] != tok.pad_token_id).sum(1)
                   .mean()),
               longest_function_chars=max(len(t) for t in texts),
               tokens_per_row_mean=float(
                   (data["input_ids"] != tok.pad_token_id).sum(1).mean()),
               validate_bad=rep_bad, validate_clean_exit=rc_clean,
               coverage=coverage, fit_losses=card_losses,
               fit_bits_equal_in_memory=True,
               best_val_loss=fit_report["best_val_loss"],
               dataflow_style=style, dataflow_losses=df_losses,
               dataflow_first_step_cpu=cpu_loss,
               dataflow_first_step_diff_vs_cpu=df_diff,
               bpe_vocab=vocab_size, bpe_merges=n_merges,
               load_pretrained_bits_equal=True, fit_text_losses=ft_losses,
               fit_text_test_loss=ft_test["loss"],
               test_text_bits_equal=True,
               fine_tune_step_profile=step_profile, launches=launches)
    emit(**rec)
    return rec


def main() -> int:
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    name = timed("device", phase_device)
    timed("build", phase_build)
    model = FlowGNN(FlowGNNConfig(message_impl="persistent"), device="cuda",
                    seed=SEED)
    timings = timed("kernels", phase_kernels, model)
    path_launches = {k: 0 for k in REPLACES}
    for impl in ("persistent", "fused"):
        for k, v in timed(f"serve_{impl}", phase_serve, impl)[
                "launches"].items():
            path_launches[k] += v
    timings.update(timed("train_kernels", phase_train_kernels, model))
    timings.update(timed("tile_kernels", phase_tile_kernels))
    for impl in ("persistent", "fused", "tile"):
        for k, v in timed(f"train_{impl}", phase_train, impl)[
                "launches"].items():
            path_launches[k] += v
    timings.update(timed("attention_kernels", phase_attention_kernels))
    for phase, fn, args in (
            ("fit_text", phase_fit_text, ()),
            ("fit_text_vs_cpu", phase_fit_text_vs_cpu, ()),
            ("fit_text_vs_cpu_tile", phase_fit_text_vs_cpu, ("tile",)),
            ("fit_text_long", phase_fit_text_long, ()),
            ("recipe", phase_recipe, ()),
            ("inputs", phase_inputs, ())):
        for k, v in timed(phase, fn, *args)["launches"].items():
            path_launches[k] += v
    emit(phase_seconds=seconds, total_s=sum(seconds.values()))
    kernels = []
    for kname, replaces in REPLACES.items():
        t = timings[kname]
        if path_launches[kname] <= 0:
            raise AssertionError(f"{kname} never ran on the main path")
        # library_ms: SDPA for the attention kernels, torch.sparse.mm
        # (cuSPARSE) for the tile product; null for the gated-step
        # kernels (no single PyTorch call computes a GRU gated graph step
        # or its VJP).
        kernels.append({
            "name": kname, "route": "cuda", "source": SOURCES[kname],
            "replaces": replaces, "launches": path_launches[kname],
            "max_abs_err": t["max_abs_err"], "ms": t["kernel_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_us"] / 1e3,
            "bound_by": t["bound_by"], "bound_peak": t["bound_peak"],
            "bound_peak_tflops": t["bound_peak_tflops"],
            "library_ms": t.get("library_ms"),
            **{key: t[key] for key in ("library_covers", "pair_ms",
                                       "max_rel_err", "transpose_ms",
                                       "scan_ms", "blocks_per_sm", "cluster",
                                       "active_clusters", "row_tile",
                                       "slab_rows", "blocks", "wide",
                                       "blocks_per_sm_pass1")
               if key in t}})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
