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
   fine-tune step's device ms by kernel. Also: the same 2600 graphs
   written as the reference pipeline's dbize cache (``csv``) load as the
   corpus does; the JSONL ``fit``, whose batches come from the C++
   batcher, repeats an in-memory fit on the numpy batcher bit for bit;
   both batchers' host ms at the flagship batch (256 graphs), their
   bytes equal; ``entry()``'s logits on the card against the CPU
   (1e-5) and its forward ms; ``cli validate --smoke`` exits 0.
18. Serving over HTTP: a combined run dir at codebert-base width (12
   layers, 768 wide, block 512, the persistent graph encoder) from a
   seed, written by the phase; ``cli serve`` in its own process on the
   card (``--port 0 --port-file``), once on the GNN lane's default
   (persistent) and once with ``--set model.message_impl=fused``.
   Each is driven over HTTP with graph-only and coded functions in
   4-function POSTs (client-side p50/p99 ms by lane, requests/s), their
   first chunks again (cached), an unencodable function (a forced
   tokenizer failure: degraded to the gnn lane), a malformed and an
   oversized POST (400, 413); every answer held to the same engine on
   the CPU within 1e-5; no compile after warmup; the kernels' launches
   read from ``/metrics`` just before and just after the traffic (the
   server's counts, taken as a difference); stopped with Ctrl-C (exit
   0). Then the combined lane's device ms a flush at each slot bucket.
19. The reference's 200-request replay gate (``tests/test_serve.py``)
   on the card: a seeded bursty trace through a warmed 8-slot engine
   (published FlowGNN, persistent lane) on a virtual clock: all
   completed, none dropped, occupancy at least 0.5, cache hits, no
   compile after warmup, every answer within 1e-6 of the offline eval
   of the same graphs.
20. DeepDFA+CodeT5 (``DefectModel``: the T5 stack in plain torch, the
   FlowGNN encoder's hand kernels under it), in a temporary directory
   removed afterwards: ``cli fit-text --model codet5`` at codet5-base
   width (12 encoder and 12 decoder layers, 768 wide, T 512, batch 16,
   ``synthetic:120``, one epoch, ``--set model.message_impl=persistent``),
   its launches exactly what the batches' gates say (the persistent
   kernels with their backward for training, ``persistent_fwd_kernel``
   for evaluation; the fused kernel per step for a batch over a gate),
   in ``history.json`` too; ``test-text`` on the run dir, bit for bit
   ``predictions.csv``; then the step at the same shapes (CUDA events,
   examples per second, device ms by kernel from ``torch.profiler``,
   peak memory). Against the CPU: 2 encoder and 2 decoder layers at
   width 768, batch 4, the fused graph lane, dropout off: logits and
   gradients within 1e-4 of the largest entry + 1e-6, 3 steps' losses
   within 1e-4. A codet5-base HF directory (random, from a seed, written
   by ``write_safetensors`` with a ``config.json``) read back through
   ``load_pretrained`` bit for bit, and one ``fit_text`` step from it
   with the graph encoder frozen.
21. The four flash kernels' bf16 instances as phase 11 (right after
   it): bf16 q, k, v and cotangent, each against its plain version
   within a bf16 step (rtol 2^-7) plus phase 11's atol, lse within 1e-5,
   each bit for bit the f32 kernel's output on the widened inputs
   rounded once to bf16, twice the same bits, timed beside its bound
   (bf16 bytes; the products of two bf16 inputs at the bf16 tensor-core
   rate, those with an f32 operand at 3xTF32's) and SDPA at bf16 with
   the same mask.
22. The reference's flagship at bf16: ``LineVul(EncoderConfig(dtype=
   "bfloat16"), FlowGNNConfig(encoder_mode=True))`` at codebert-base
   width and depth (T 512, batch 16, the graph encoder f32 on the
   persistent lane) through one epoch of ``fit_text``, then
   ``evaluate_text`` on the test split and ``make_combined_infer`` on its
   first batch (within 1e-6 of the evaluation's probabilities), each
   run's launches exactly the bf16 flash instances and the GNN lane's
   kernels its batches' gates call for; the step's breakdown (CUDA
   events), device ms by kernel, examples/s and peak memory; a 2-layer
   copy against the CPU at full width (logits and 3 steps' losses within
   5e-2, the CPU tests' bf16 tolerance).
23. ``fit_text`` at T 4096 (batch 8, 2 layers) at bf16: the bf16
   two-pass pair, its share of the step's device time.
24. DeepDFA+CodeT5 at bf16 (``T5Config.codet5_base()`` with
   ``dtype="bfloat16"``, persistent graph encoder) through one epoch of
   ``fit_text``, its GNN launches as the batches' gates say; the step's
   breakdown, profile, examples/s and peak memory; a 2 + 2 layer copy
   against the CPU (logits and losses within 5e-2).

Each phase's seconds go into a ``phase_seconds`` record. Each main-path
run sets every kernel's launch count to 0 just before it and reads the
counts just after. Every number goes on a line of its own before the
last; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import dataclasses
import functools
import heapq
import http.client
import io
import json
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import torch

from deepdfa_tpu_torch import cli
from deepdfa_tpu_torch import entry as port_entry
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
    HashingT5Tokenizer,
    attach_synthetic_text,
    encode_dataset,
    encode_function,
    load_bpe_tokenizer,
)
from deepdfa_tpu_torch.graphs.batch import (
    batch_graphs,
    batch_iterator,
    pad_budget_for,
)
from deepdfa_tpu_torch.models.flowgnn import FlowGNN
from deepdfa_tpu_torch.models.linevul import LineVul, cross_entropy_loss
from deepdfa_tpu_torch.models import convert, pretrained
from deepdfa_tpu_torch.models import infer as models_infer
from deepdfa_tpu_torch.models.t5 import DefectModel, T5Config, T5Model
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
from deepdfa_tpu_torch.serve.batcher import ServeRequest
from deepdfa_tpu_torch.serve.engine import bucket_batch
from deepdfa_tpu_torch.serve.replay import VirtualClock, bursty_trace, replay
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
# The flash kernels' bf16 instances: the same TPU kernels (generic over
# the dtype there), the same sources.
for _name in ("flash_fwd_kernel", "flash_bwd_fused_kernel",
              "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel"):
    REPLACES[_name + "_bf16"] = REPLACES[_name]
    SOURCES[_name + "_bf16"] = SOURCES[_name]
# A bf16 instance against its plain version: both compute in f32 (in
# another order) and round once to bf16, so within a bf16 step (rtol
# 2^-7) of each other, plus the f32 kernels' order gap (ATTN_*_TOL's
# atol); lse is f32 (ATTN_FWD_TOL).
ATTN_BF16_FWD_TOL = dict(rtol=2.0 ** -7, atol=1e-5)
ATTN_BF16_GRAD_TOL = dict(rtol=2.0 ** -7, atol=1e-4)
# The bf16 text paths against the CPU: the CPU tests' tolerance
# (tests/test_torch_bf16_text.py, the reference's own bf16 tolerance):
# logits and losses within 5e-2 absolute and relative.
BF16_TEXT_TOL = dict(rtol=5e-2, atol=5e-2)
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
    "step_weight_grad_reduce_kernel", "flash_dq_sum_kernel",
    "flash_dq_sum_kernel_bf16"}
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
    # A flash kernel's bf16 instance (<__nv_bfloat16>) under its own
    # name; the GNN kernels' template arguments do not name them.
    port = {}
    for ms, key, calls in kernels:
        found = re.search(r"(\w+)(<[^(]*>)?\(", key)
        if not found:
            continue
        name = found.group(1)
        if (name + "_bf16" in PORT_KERNELS
                and "bfloat16" in (found.group(2) or "")):
            name += "_bf16"
        if name in PORT_KERNELS:
            entry = port.setdefault(name, {"ms": 0.0, "calls": 0.0})
            entry["ms"] += ms
            entry["calls"] += calls
    # cuBLAS's products (the linears, and the T5 attention's matmuls).
    gemm = [k for k in kernels if re.search(r"gemm|nvjet", k[1])]
    return {"device_busy_ms": sum(k[0] for k in kernels),
            "kernels_a_call": sum(k[2] for k in kernels),
            "gemm_ms": sum(k[0] for k in gemm),
            "gemm_calls": sum(k[2] for k in gemm),
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


def _wide(xs) -> list:
    """Each floating tensor of ``xs`` as f32 (a bf16 one widened)."""
    return [x.float() if torch.is_tensor(x) and x.is_floating_point()
            and x.dtype == torch.bfloat16 else x for x in xs]


def phase_attention_kernels(dtype: torch.dtype = torch.float32) -> dict:
    """Each flash kernel's ``dtype`` instance against its plain version
    at the text training shape and the long shape, timed beside its bound
    and SDPA (at the same dtype). A bf16 instance is also held bit for bit
    to the f32 kernel on the widened inputs, rounded once to bf16 (the
    identity its design keeps). Returns the numbers at the main-path
    shapes by kernel instance: the forward and the fused backward at
    T 512, the two-pass pair at T 4096."""
    bf16 = dtype == torch.bfloat16
    sfx = "_bf16" if bf16 else ""
    fwd_tol = ATTN_BF16_FWD_TOL if bf16 else ATTN_FWD_TOL
    grad_tol = ATTN_BF16_GRAD_TOL if bf16 else ATTN_GRAD_TOL

    def check(name, got, want, tol):
        return _check(name + sfx, got.float(), want.float(), tol)

    def identity(name, got, fn, args):
        """bf16: ``got`` is the f32 kernel's output on the widened
        inputs, rounded once."""
        if bf16:
            want = fn(*_wide(args))
            want = [want] if torch.is_tensor(want) else list(want)
            got = [got] if torch.is_tensor(got) else list(got)
            _same_bits(f"{name}_bf16 = {name} on the widened inputs", got,
                       [w.bfloat16() if w.dtype == torch.float32
                        and g.dtype == torch.bfloat16 else w
                        for g, w in zip(got, want)])

    out = {}
    for shape_name, shape, iters, reps in (("train", ATTN_TRAIN_SHAPE, 10, 3),
                                           ("long", ATTN_LONG_SHAPE, 2, 3)):
        b, t, h, d = shape
        q, k, v, mask, g = _attn_inputs(shape, SEED)
        q, k, v, g = (x.to(dtype) for x in (q, k, v, g))
        # SDPA gives a fully masked row NaN: time it on the same inputs
        # with every row holding tokens.
        full = mask.clone()
        full[-1, : t // 2] = True
        lib_fwd, lib_bwd = _sdpa_calls(q, k, v, full, g)
        o, lse = attention.flash_fwd(q, k, v, mask)
        o_ref, lse_ref = attention.flash_fwd_reference(q, k, v, mask)
        err = max(check(f"flash_fwd_kernel@{shape_name}", o, o_ref, fwd_tol),
                  check(f"flash_fwd_kernel@{shape_name} lse", lse, lse_ref,
                        ATTN_FWD_TOL))
        if not bool((o[-1] == 0).all()):
            raise AssertionError("flash_fwd_kernel: the all-pad row is not 0")
        _same_bits(f"flash_fwd_kernel{sfx} twice@{shape_name}",
                   list(attention.flash_fwd(q, k, v, mask)), [o, lse])
        identity("flash_fwd_kernel", (o, lse), attention.flash_fwd,
                 (q, k, v, mask))
        delta = attention.flash_delta(o_ref, g)
        args = (q, k, v, mask, g, lse_ref, delta)
        runs = {"flash_fwd_kernel": (
            err, lambda: attention.flash_fwd(q, k, v, mask),
            lambda: attention.flash_fwd_reference(q, k, v, mask), lib_fwd,
            ["o"])}
        dq = attention.flash_bwd_dq(*args)
        dk, dv = attention.flash_bwd_dkv(*args)
        identity("flash_bwd_dq_kernel", dq, attention.flash_bwd_dq, args)
        identity("flash_bwd_dkv_kernel", (dk, dv), attention.flash_bwd_dkv,
                 args)
        if attention.flash_fused_bwd_ok(t, d):
            want = attention.flash_bwd_fused_reference(*args)
            fused = attention.flash_bwd_fused(*args)
            err = max(check(f"flash_bwd_fused_kernel[{i}]@{shape_name}", a,
                            w, grad_tol)
                      for i, (a, w) in enumerate(zip(fused, want)))
            # Fused against the two-pass pair, kernel against kernel; and
            # against itself: no atomics, so a second launch on the same
            # inputs gives the same bits.
            for i, (a, c) in enumerate(zip(fused, (dq, dk, dv))):
                check(f"fused vs two-pass [{i}]@{shape_name}", a, c,
                      grad_tol)
            _same_bits(f"flash_bwd_fused_kernel{sfx} twice@{shape_name}",
                       list(attention.flash_bwd_fused(*args)), list(fused))
            identity("flash_bwd_fused_kernel", fused,
                     attention.flash_bwd_fused, args)
            runs["flash_bwd_fused_kernel"] = (
                err, lambda: attention.flash_bwd_fused(*args),
                lambda: attention.flash_bwd_fused_reference(*args), lib_bwd,
                BWD_COVERS)
        else:
            want = (attention.flash_bwd_dq_reference(*args),
                    *attention.flash_bwd_dkv_reference(*args))
        err_dq = check(f"flash_bwd_dq_kernel@{shape_name}", dq, want[0],
                       grad_tol)
        err_dkv = max(check(f"flash_bwd_dkv_kernel[{i}]@{shape_name}", a, w,
                            grad_tol)
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
        _same_bits(f"flash_bwd_dq_kernel{sfx} twice@{shape_name}",
                   [attention.flash_bwd_dq(*args)], [dq])
        _same_bits(f"flash_bwd_dkv_kernel{sfx} twice@{shape_name}",
                   list(attention.flash_bwd_dkv(*args)), [dk, dv])
        for grad_name, x in (("dk", dk), ("dv", dv)):
            if bool(x[~mask].any()):
                raise AssertionError(f"{grad_name}@{shape_name}: a padded "
                                     "key's gradient is not 0")
        if bool(dq[-1].any()):
            raise AssertionError(f"dq@{shape_name}: the all-pad row is not 0")
        recs = {}
        for base, (err, kernel, plain, library, covers) in runs.items():
            name = base + sfx
            kernel_ms = _time_ms(kernel, iters, reps)
            plain_ms = _time_ms(plain, iters, reps)
            library_ms = _time_ms(library, iters, reps)
            cost = attention.kernel_cost(mask, t, h, d, name)
            bound_ms, bound_by = _bound(cost)
            recs[name] = dict(
                kernel=name, dtype=str(dtype).removeprefix("torch."),
                shape=shape_name, B=b, T=t, H=h, D=d,
                real_key_fraction=float(mask.float().mean()),
                max_abs_err=err,
                tol=fwd_tol if base == "flash_fwd_kernel" else grad_tol,
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
            if bf16:
                recs[name]["bits_equal_f32_kernel_rounded"] = True
            if base != "flash_fwd_kernel":
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
        pair = ("flash_bwd_dq_kernel" + sfx, "flash_bwd_dkv_kernel" + sfx)
        pair_ms = sum(recs[name]["kernel_ms"] for name in pair)
        for name in pair:
            recs[name]["pair_ms"] = pair_ms
        for name, rec in recs.items():
            emit(phase="attention_kernels" + sfx, **rec)
            main_shape = "long" if name in pair else "train"
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
# The text models at bf16 (the reference's flagship configuration)
# ---------------------------------------------------------------------------


def _bf16(cfg):
    return dataclasses.replace(cfg, dtype="bfloat16")


def _counted(fn, *args, **kw):
    """``fn``'s result and the kernels' launches in it (counts set to 0
    just before, read just after)."""
    reset_launch_counts()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    return out, launch_counts()


def _flash_want(layers: int, fwd: int, bwd: int, two_pass: bool = False
                ) -> dict:
    """The bf16 flash launches of ``fwd`` forward and ``bwd`` backward
    passes through ``layers`` layers."""
    if two_pass:
        bwd_names = ("flash_bwd_dq_kernel_bf16", "flash_bwd_dkv_kernel_bf16")
    else:
        bwd_names = ("flash_bwd_fused_kernel_bf16",)
    want = {"flash_fwd_kernel_bf16": layers * fwd}
    want.update({name: layers * bwd for name in bwd_names if bwd})
    return want


def _vs_cpu_bf16(model, cpu_model, data, splits, tcfg, kw) -> dict:
    """A bf16 text model on the card and on the CPU from the same
    weights: one batch's logits, then fit_text's per-step losses, each
    within BF16_TEXT_TOL (the CPU tests' tolerance)."""
    cpu_model.load_state_dict({k: v.cpu()
                               for k, v in model.state_dict().items()})
    batch = next(text_loop.text_graph_batches(
        data, splits["train"], tcfg.batch_size,
        build_band_adj=model.graph_config.uses_band_adj, **kw))
    with torch.no_grad():
        ids, _, _, graphs = text_loop._on_device(batch, "cuda")
        card = model(ids, graphs).float().cpu()
        ids, _, _, graphs = text_loop._on_device(batch, "cpu")
        want = cpu_model(ids, graphs)
    logit_gap = _check("bf16 logits card vs cpu", card, want, BF16_TEXT_TOL)
    history, launches, _, wall_s = _fit_text_counted(model, data, splits,
                                                     tcfg, kw)
    losses = _text_steps(history)
    t0 = time.perf_counter()
    _, cpu_history = text_loop.fit_text(cpu_model, data, splits, tcfg, **kw)
    cpu_s = time.perf_counter() - t0
    cpu_losses = _text_steps(cpu_history)
    gap = _check("bf16 fit_text losses card vs cpu", torch.tensor(losses),
                 torch.tensor(cpu_losses), BF16_TEXT_TOL)
    return dict(batch_size=tcfg.batch_size, logit_gap=logit_gap,
                losses=losses, cpu_losses=cpu_losses,
                max_abs_loss_diff_vs_cpu=gap, tol=BF16_TEXT_TOL,
                launches=launches, fit_wall_s=wall_s, cpu_fit_s=cpu_s)


def phase_fit_text_bf16() -> dict:
    """The reference's flagship DeepDFA+LineVul at bf16
    (``EncoderConfig(dtype="bfloat16")``, codebert-base, T 512, batch 16;
    the graph encoder f32 on the persistent lane): one epoch of
    ``fit_text``, then ``evaluate_text`` on the test split and the
    combined serving forward on the same weights, each with its launches;
    the step's breakdown, profile, examples/s and peak memory; a 2-layer
    copy against the CPU."""
    enc = _bf16(dataclasses.replace(EncoderConfig(), attention_impl="auto"))
    graph_cfg, tcfg, data, splits, kw = _text_setup(enc, TEXT_N_FULL, 16,
                                                    512, "persistent")
    layers = enc.num_layers
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = LineVul(enc, graph_cfg, device="cuda", seed=SEED)
    history, fit_launches, two_pass, wall_s = _fit_text_counted(
        model, data, splits, tcfg, kw)
    fit_peak = torch.cuda.max_memory_allocated()
    losses = _text_steps(history)
    val_batches = -(-len(splits["val"]) // tcfg.eval_batch_size)
    gnn = _sum_launches(
        _gnn_lane_launches(graph_cfg, data, splits["train"], tcfg, kw,
                           train=True, shuffle_seed=TEXT_SEED),
        _gnn_lane_launches(graph_cfg, data, splits["val"], tcfg, kw,
                           train=False))
    _require_launches("fit_text bf16", fit_launches, {
        **{k: v for k, v in gnn.items() if v},
        **_flash_want(layers, len(losses) + val_batches, len(losses))})
    # evaluate_text and the serving forward, the fitted weights.
    band = dict(build_band_adj=True, **kw)
    test, eval_launches = _counted(
        text_loop.evaluate_text, text_loop.make_text_eval_step(model), data,
        splits["test"], tcfg, **band)
    test_batches = -(-len(splits["test"]) // tcfg.eval_batch_size)
    gnn_eval = _gnn_lane_launches(graph_cfg, data, splits["test"], tcfg, kw,
                                  train=False)
    _require_launches("evaluate_text bf16", eval_launches, {
        **{k: v for k, v in gnn_eval.items() if v},
        **_flash_want(layers, test_batches, 0)})
    batch = next(text_loop.text_graph_batches(
        data, splits["test"], tcfg.eval_batch_size, **band))
    ids, _, mask, graphs = text_loop._on_device(batch, "cuda")
    infer = models_infer.make_combined_infer(model)
    probs, serve_launches = _counted(infer, ids, graphs)
    rows = int(batch.example_mask.sum())
    serve_gap = _check("make_combined_infer vs evaluate_text",
                       probs[mask].cpu(),
                       torch.from_numpy(test["probs"][:rows]),
                       dict(rtol=0.0, atol=1e-6))
    model.train()
    train_batch = next(text_loop.text_graph_batches(
        data, splits["train"], tcfg.batch_size, **band))
    torch.cuda.reset_peak_memory_stats()
    breakdown = _text_step_breakdown(model, train_batch, tcfg)
    step_peak = torch.cuda.max_memory_allocated()
    step = text_loop.make_text_train_step(
        model, text_loop.make_text_optimizer(model.parameters(), tcfg), tcfg,
        torch.Generator().manual_seed(TEXT_SEED))
    profile = _device_profile(lambda: step(train_batch, tcfg.learning_rate),
                              TEXT_PROFILE_STEPS)
    if not all(p.dtype == torch.float32 for p in model.parameters()):
        raise AssertionError("bf16 LineVul: master parameters not f32")
    del model, step
    torch.cuda.empty_cache()
    step_ms = (breakdown["forward_ms"] + breakdown["backward_ms"]
               + breakdown["optimizer_ms"])
    n_rows = int(train_batch.example_mask.sum())

    # The 2-layer copy against the CPU.
    enc2 = dataclasses.replace(enc, num_layers=2, dropout_rate=0.0)
    graph2, tcfg2, data2, splits2, kw2 = _text_setup(enc2, TEXT_N_VS_CPU, 4,
                                                     512, "persistent")
    vs_cpu = _vs_cpu_bf16(LineVul(enc2, graph2, device="cuda", seed=SEED),
                          LineVul(enc2, graph2, device="cpu"), data2,
                          splits2, tcfg2, kw2)
    vs_cpu["layers"] = enc2.num_layers
    launches = _sum_launches(fit_launches, eval_launches, serve_launches,
                             vs_cpu["launches"])
    rec = dict(phase="fit_text_bf16", dtype=enc.dtype, layers=layers,
               hidden=enc.hidden_size, block_size=tcfg.block_size,
               batch_size=tcfg.batch_size,
               graph_message_impl=graph_cfg.message_impl,
               steps=len(losses), val_batches=val_batches, losses=losses,
               val_loss=history["epochs"][-1]["val_loss"],
               val_f1=history["epochs"][-1]["val_metrics"]["f1"],
               test_loss=test["loss"], test_f1=test["metrics"]["f1"],
               serve_gap_vs_eval=serve_gap,
               fit_launches=fit_launches, eval_launches=eval_launches,
               serve_launches=serve_launches, two_pass_dispatches=two_pass,
               fit_wall_s=wall_s, fit_peak_mem_gb=fit_peak / 1e9,
               step_breakdown=breakdown, step_profile=profile,
               examples_per_step=n_rows,
               examples_per_s=n_rows / (step_ms / 1e3),
               device_idle_share=1.0 - profile["device_busy_ms"]
               / breakdown["step_wall_ms"],
               peak_mem_gb=step_peak / 1e9, vs_cpu=vs_cpu,
               launches=launches)
    emit(**rec)
    return rec


def phase_fit_text_long_bf16() -> dict:
    """fit_text at T 4096 (batch 8, 2 layers) at bf16: the backward's
    gate sends it to the bf16 two-pass pair; the step's profile."""
    enc = _bf16(dataclasses.replace(EncoderConfig(), attention_impl="auto",
                                    num_layers=2))
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
    _require_launches("fit_text bf16 at T 4096", launches, _flash_want(
        enc.num_layers, steps + val_batches, steps, two_pass=True))
    if two_pass != enc.num_layers * steps:
        raise AssertionError(f"{two_pass} two-pass dispatches")
    batch = next(text_loop.text_graph_batches(data, splits["train"],
                                              tcfg.batch_size, **kw))
    step = text_loop.make_text_train_step(
        model, text_loop.make_text_optimizer(model.parameters(), tcfg), tcfg,
        torch.Generator().manual_seed(TEXT_SEED))
    profile = _device_profile(lambda: step(batch, tcfg.learning_rate),
                              TEXT_PROFILE_STEPS)
    pair_ms = sum(profile["port_kernels"].get(name, {}).get("ms", 0.0)
                  for name in ("flash_bwd_dq_kernel_bf16",
                               "flash_bwd_dkv_kernel_bf16"))
    del model, step
    torch.cuda.empty_cache()
    rec = dict(phase="fit_text_long_bf16", dtype=enc.dtype,
               layers=enc.num_layers, block_size=t, batch_size=b,
               steps=steps, losses=losses, launches=launches,
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
# entry()'s per-graph logits, card against the CPU: one band forward,
# f32 in another order.
ENTRY_TOL = dict(rtol=0.0, atol=1e-5)
# The serve_http phase: cli serve in its own process on the card, over
# real HTTP, against the same engine on the CPU (one forward: f32 in
# another order, the encoder's flash kernel against the dense plain
# version). Graph-only and coded functions, POSTed a chunk at a time.
HTTP_TOL = 1e-5
N_HTTP_GRAPHS = 24
N_HTTP_CODED = 8
HTTP_CHUNK = 4
HTTP_START_S = 600
# The load windows: LOAD_CLIENTS closed-loop clients, each on its own
# keep-alive connection, send LOAD_POSTS one-function POSTs a lane, every
# function new to the server (no cache hit), so 16 clients can fill the
# 16-slot bucket and a flush does not wait out the deadline.
LOAD_CLIENTS = 16
LOAD_POSTS = 32
# A lone surrogate cannot be encoded to UTF-8: the tokenizer raises on
# such code, which forces the request onto the gnn lane, degraded.
UNENCODABLE = "int f(char *p) { return '\ud800'; }"
# The reference's 200-request replay gate (tests/test_serve.py), at the
# published FlowGNN width on the card: every answer against the offline
# eval of the same graphs (another packing: f32 in another order).
REPLAY_REQUESTS = 200
REPLAY_TOL = 1e-6


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


@contextlib.contextmanager
def _numpy_batcher():
    """``loop.fit``/``evaluate`` batch with the numpy loop inside (they
    take the C++ batcher otherwise)."""
    native_iterator = loop.batch_iterator
    loop.batch_iterator = functools.partial(batch_iterator, impl="python")
    try:
        yield
    finally:
        loop.batch_iterator = native_iterator


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


def _write_dbize(root: str, examples, feature) -> None:
    """``examples`` as the reference pipeline's dbize stage writes them,
    with the ``csv`` module: nodes.csv, edges.csv and one
    nodes_feat_<feature>_fixed.csv a subkey, each led by an index
    column; node ids are not the dense ids (1000 + 7 x dgl id)."""
    os.makedirs(root, exist_ok=True)
    nodes = [["", "graph_id", "dgl_id", "node_id", "vuln"]]
    edges = [["", "graph_id", "innode", "outnode"]]
    feats = {k: [] for k in subkeys_for(feature)}
    for ex in examples:
        gid = int(ex["id"])
        for d, v in enumerate(np.asarray(ex["vuln"]).tolist()):
            nodes.append([len(nodes) - 1, gid, d, 1000 + 7 * d, v])
        for s, r in zip(np.asarray(ex["senders"]).tolist(),
                        np.asarray(ex["receivers"]).tolist()):
            edges.append([len(edges) - 1, gid, s, r])
        for k, rows in feats.items():
            for d, v in enumerate(np.asarray(ex["feats"][k]).tolist()):
                rows.append([len(rows), gid, 1000 + 7 * d, v])
    tables = {"nodes.csv": nodes, "edges.csv": edges}
    for k, rows in feats.items():
        col = (f"_ABS_DATAFLOW_{k}_all_limitall_{feature.limit_all}"
               f"_limitsubkeys_{feature.limit_subkeys}")
        tables[f"nodes_feat_{col}_fixed.csv"] = [
            ["", "graph_id", "node_id", col]] + rows
    for name, rows in tables.items():
        with open(os.path.join(root, name), "w", newline="") as f:
            csv.writer(f).writerows(rows)


def _batcher_ms(feature, reps: int = 20) -> dict:
    """Host ms of one flagship batch (256 synthetic graphs, the reference
    example's budget) by the C++ batcher and by the numpy loop, the
    median of ``reps``; the two batches' bytes must agree."""
    graphs = synthetic_bigvul(256, feature, positive_fraction=0.5,
                              seed=SEED)
    budget = pad_budget_for(graphs, 256)
    args = (graphs, 256, budget["max_nodes"], budget["max_edges"],
            list(subkeys_for(feature)))
    out, batches = {}, {}
    for impl in ("native", "python"):
        batches[impl] = batch_graphs(*args, impl=impl)
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            batch_graphs(*args, impl=impl)
            times.append((time.perf_counter() - t0) * 1e3)
        out[f"{impl}_ms"] = statistics.median(times)
    a, b = batches["native"], batches["python"]
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor) and not torch.equal(x, y):
            raise AssertionError(f"native and python batches differ: "
                                 f"{f.name}")
    if any(not torch.equal(a.node_feats[k], b.node_feats[k])
           for k in a.node_feats):
        raise AssertionError("native and python batches differ: node_feats")
    return out


def _entry_forward() -> dict:
    """``entry()`` on the card against the same weights and batch on the
    CPU, and the card's forward ms."""
    fn, (params, batch) = port_entry.entry(device="cuda")
    logits = fn(params, batch)
    cpu_fn, (_, cpu_batch) = port_entry.entry(device="cpu")
    want = cpu_fn({k: v.cpu() for k, v in params.items()}, cpu_batch)
    diff = _check("entry() logits", logits.cpu(), want, ENTRY_TOL)
    return {"entry_logits": int(logits.shape[0]),
            "entry_max_abs_diff_vs_cpu": diff,
            "entry_forward_ms": _time_ms(lambda: fn(params, batch),
                                         iters=10, reps=5)}


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

    # The same graphs as a dbize cache directory: they load as the corpus
    # does (ascending ids; the CSVs carry no dataflow bits).
    dbize = os.path.join(root, "dbize")
    timed("write_dbize", _write_dbize, dbize, generated, feature)
    from_dbize = timed("load_dbize", load_graph_source, dbize, feature)
    by_id = {int(ex["id"]): ex for ex in loaded}
    if sorted(by_id) != [ex["id"] for ex in from_dbize]:
        raise AssertionError("dbize ids differ from the corpus's")
    for ex in from_dbize:
        want = by_id[ex["id"]]
        pairs = [(ex[k], want[k]) for k in ("senders", "receivers", "vuln")]
        pairs += [(ex["feats"][k], want["feats"][k]) for k in want["feats"]]
        if (ex["num_nodes"] != want["num_nodes"]
                or ex["label"] != want["label"]
                or any(not np.array_equal(g, w) for g, w in pairs)):
            raise AssertionError(f"dbize example {ex['id']} differs from "
                                 "the corpus's")

    # fit from the corpus, graph labels, persistent lane, its batches from
    # the C++ batcher; then the same fit from the generated examples in
    # memory on the numpy batcher: the same losses, bit for bit.
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
    with _numpy_batcher():
        _, memory = loop.fit(model, generated, pinned, cfgs["train"],
                             cfgs["data"])
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

    # The flagship forward against the CPU, both batchers at the
    # flagship batch, and the corrupt-corpus self-test.
    more = timed("entry", _entry_forward)
    more["batcher_256_graphs"] = timed("batcher", _batcher_ms, feature)
    rc_smoke, smoke = timed("validate_smoke", _cli_rc,
                            ["validate", "--smoke"])
    if rc_smoke != 0 or not smoke["ok"] or smoke["classes"] != 14:
        raise AssertionError(f"validate --smoke: rc {rc_smoke}, {smoke}")

    rec = dict(phase="inputs", seconds=seconds, **more,
               dbize_rows_per_s=len(from_dbize) / seconds["load_dbize"],
               fit_native_bits_equal_python=True,
               validate_smoke_grade=smoke["grade"],
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


def _write_combined_run(run: str) -> None:
    """A combined fit-text run dir at codebert-base width (12 layers,
    768 wide, block 512) with the published FlowGNN encoder on the
    persistent lane, random weights from ``TEXT_SEED``: the ``best``
    snapshot and the ``model.json`` that ``cli serve`` restores."""
    graph_cfg = FlowGNNConfig(message_impl="persistent", encoder_mode=True)
    enc = EncoderConfig()
    model = LineVul(enc, graph_cfg, device="cpu", seed=TEXT_SEED)
    train_checkpoint.make_checkpoint_manager(run).save_best(
        {"params": model.state_dict()}, 0, metrics={"val_f1": 0.0})
    with open(os.path.join(run, "model.json"), "w") as f:
        json.dump({"model": "linevul", "tiny": False, "attention_impl": "auto",
                   "remat": False, "gelu_approximate": enc.gelu_approximate,
                   "combined": True, "block_size": 512,
                   "dataset": "synthetic", "split_mode": "random",
                   "graphs": "synthetic", "tokenizer": None,
                   "batch_size": 16, "graph_budget": None,
                   "graph_config": dataclasses.asdict(graph_cfg),
                   "seed": TEXT_SEED}, f, indent=1)


def _serve_args(run: str, impl: str, device: str) -> argparse.Namespace:
    return cli.build_parser().parse_args([
        "serve", "--combined-checkpoint-dir", run, "--set",
        f"model.message_impl={impl}", "--device", device])


def _http(base: str, path: str, doc=None) -> tuple:
    """(status, headers, JSON body) of a GET (``doc`` None) or a POST."""
    req = urllib.request.Request(
        f"{base}{path}", data=None if doc is None else json.dumps(
            doc).encode(), headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, dict(resp.headers), json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def _functions(graphs, codes=None) -> list:
    out = []
    for i, g in enumerate(graphs):
        fn = {"id": int(g["id"]), "graph": {
            "num_nodes": int(g["num_nodes"]),
            "senders": np.asarray(g["senders"]).tolist(),
            "receivers": np.asarray(g["receivers"]).tolist(),
            "feats": {k: np.asarray(v).tolist()
                      for k, v in g["feats"].items()}}}
        if codes is not None:
            fn["code"] = codes[i]
        out.append(fn)
    return out


def _start_server(run: str, impl: str, root: str) -> tuple:
    """``cli serve`` on the card in its own process, on an ephemeral
    port: (process, base URL, its log path)."""
    port_file = os.path.join(root, f"port_{impl}")
    log = os.path.join(root, f"serve_{impl}.log")
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "deepdfa_tpu_torch.cli", "serve",
             "--combined-checkpoint-dir", run, "--set",
             f"model.message_impl={impl}", "--device", "cuda", "--port", "0",
             "--port-file", port_file], cwd=here, env=env, stdout=f,
            stderr=subprocess.STDOUT)
    t0 = time.monotonic()
    while not os.path.exists(port_file):
        if proc.poll() is not None or time.monotonic() - t0 > HTTP_START_S:
            _stop_server(proc)
            with open(log) as f:
                raise AssertionError(f"cli serve ({impl}) did not start: "
                                     f"{f.read()[-3000:]}")
        time.sleep(0.2)
    with open(port_file) as f:
        return proc, f"http://127.0.0.1:{int(f.read())}", log


def _stop_server(proc) -> int:
    """Ctrl-C, as a user stops it; killed if it does not exit."""
    if proc.poll() is None:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    return proc.returncode


def _combined_bucket_ms(run: str) -> dict:
    """One combined-lane flush at each slot bucket (full 512-token rows),
    in an engine of this process restored from the same run dir: the
    forward alone on a batch already on the card (``forward_ms``, CUDA
    events; ``busy_ms`` and ``kernels``, the device-busy ms and kernel
    launches a forward under ``torch.profiler``), and the whole flush
    (``flush_wall_ms``, host clock: packing on the host, the copies, the
    forward)."""
    engine, _ = cli._build_serve_engine(_serve_args(run, "persistent",
                                                    "cuda"))
    graphs = synthetic_bigvul(16, FlowGNNConfig().feature, seed=SEED + 9)
    texts = attach_synthetic_text([dict(g) for g in graphs], seed=TEXT_SEED)
    reqs = []
    for i, (g, t) in enumerate(zip(graphs, texts)):
        norm = engine._normalize_graph(g)
        reqs.append(ServeRequest(
            rid=i, key="", graph=norm, lane="combined", arrival=0.0,
            deadline_s=0.1, input_ids=encode_function(
                t["code"], engine.tokenizer, engine.config.block_size)))
    lane = engine._lanes["combined"]
    out = {}
    for slots in engine.config.slot_buckets:
        gb = engine._graph_batch(lane, [r.graph for r in reqs[:slots]],
                                 slots)
        ids = torch.from_numpy(np.stack(
            [r.input_ids for r in reqs[:slots]])).to("cuda")
        with torch.inference_mode():
            forward_ms = _time_ms(lambda: engine._combined_infer(ids, gb),
                                  iters=5, reps=3)
            prof = _device_profile(lambda: engine._combined_infer(ids, gb),
                                   3)
        out[str(slots)] = {
            "forward_ms": forward_ms, "busy_ms": prof["device_busy_ms"],
            "kernels": prof["kernels_a_call"],
            "flush_wall_ms": _host_ms(lambda: engine._execute(
                "combined", reqs[:slots], slots), reps=5)}
    del engine
    torch.cuda.empty_cache()
    return out


def _post_all(base: str, bodies) -> tuple:
    """``LOAD_CLIENTS`` closed-loop clients, each on its own keep-alive
    connection, POST the encoded ``bodies`` (client c takes every c-th):
    (ms from send to answer by body, the answers by body, the window's
    wall seconds from the first send to the last answer)."""
    url = urllib.parse.urlsplit(base)
    ms = [None] * len(bodies)
    answers = [None] * len(bodies)
    faults = []
    ready = threading.Barrier(LOAD_CLIENTS + 1)

    def client(c):
        conn = http.client.HTTPConnection(url.hostname, url.port, timeout=120)
        try:
            # Connected before the window: 16 connects at once overflow
            # the server's listen backlog (socketserver's 5), and a
            # dropped SYN is retried after a second.
            conn.connect()
            ready.wait()
            for i in range(c, len(bodies), LOAD_CLIENTS):
                t0 = time.perf_counter()
                conn.request("POST", "/score", body=bodies[i], headers={
                    "Content-Type": "application/json"})
                resp = conn.getresponse()
                doc = json.loads(resp.read())
                ms[i] = (time.perf_counter() - t0) * 1e3
                if resp.status != 200:
                    faults.append((resp.status, doc))
                    return
                answers[i] = doc["results"]
        except Exception as e:  # reported below, after every client ends
            faults.append(repr(e))
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(LOAD_CLIENTS)]
    for t in threads:
        t.start()
    ready.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if faults:
        raise AssertionError(f"load POSTs failed: {faults[:3]}")
    return ms, answers, wall


def _flushes(metrics: dict, lane: str) -> dict:
    return {key.split(":b")[1]: cell["flushes"]
            for key, cell in metrics.get("padding_waste", {}).items()
            if key.startswith(f"{lane}:")}


def _load_http(base: str, lane: str, graphs, codes=None) -> dict:
    """One lane's load window: every function once, one a POST, from
    ``LOAD_CLIENTS`` clients at once. Checks every answer (the lane, not
    cached, not degraded, a probability) and that the window hit no
    cache line; returns the probabilities with the client's latency
    quantiles, the rates (requests and functions counted apart) and the
    flushes by slot bucket."""
    bodies = [json.dumps({"functions": [fn]}).encode()
              for fn in _functions(graphs, codes)]
    _, _, m0 = _http(base, "/metrics")
    ms, answers, wall = _post_all(base, bodies)
    _, _, m1 = _http(base, "/metrics")
    functions = [r for res in answers for r in res]
    probs = np.asarray([r.get("prob", np.nan) for r in functions])
    if (len(functions) != len(bodies) or not np.all(np.isfinite(probs))
            or not np.all((probs >= 0) & (probs <= 1))
            or any(r.get("model") != lane or r["cached"] or r["degraded"]
                   for r in functions)):
        raise AssertionError(f"{lane} load answers: {functions[:3]}")
    hits = m1["cache_hits"] - m0["cache_hits"]
    if hits or m1["completed"] - m0["completed"] != len(bodies):
        raise AssertionError(f"{lane} load window: {hits} cache hits, "
                             f"{m1['completed'] - m0['completed']} "
                             f"completed of {len(bodies)}")
    before = _flushes(m0, lane)
    flushes = {k: v - before.get(k, 0) for k, v in _flushes(m1, lane).items()
               if v - before.get(k, 0)}
    slots = sum(int(k) * v for k, v in flushes.items())
    return {"probs": probs, "clients": LOAD_CLIENTS,
            "requests": len(bodies), "functions": len(functions),
            "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)),
            "max_ms": float(max(ms)), "wall_s": wall,
            "requests_per_s": len(bodies) / wall,
            "functions_per_s": len(functions) / wall,
            "flushes_by_bucket": flushes,
            "slot_occupancy": len(functions) / slots}


def _check_http(base: str, graphs, coded, codes, fresh) -> dict:
    """The smoke traffic, one POST at a time: graph-only and coded
    functions a chunk a POST, their first chunks again (cached), an
    unencodable function with a graph the server has not seen (degraded,
    its own gnn flush), a malformed POST (400) and an oversized one
    (413). Returns the answers and the status codes."""
    answers = {"gnn": [], "combined": []}
    for lane, fns in (("gnn", _functions(graphs)),
                      ("combined", _functions(coded, codes))):
        for start in range(0, len(fns), HTTP_CHUNK):
            status, _, body = _http(base, "/score", {
                "functions": fns[start:start + HTTP_CHUNK]})
            if status != 200:
                raise AssertionError(f"{lane} POST: {status} {body}")
            answers[lane] += body["results"]
        status, _, body = _http(base, "/score",
                                {"functions": fns[:HTTP_CHUNK]})
        if status != 200 or not all(r["cached"] for r in body["results"]):
            raise AssertionError(f"{lane} replay not cached: {body}")
    for lane, res in answers.items():
        if any(r.get("model") != lane or r.get("degraded") or r["cached"]
               for r in res):
            raise AssertionError(f"{lane} answers: {res[:3]}")
    status, _, body = _http(base, "/score", {"functions": _functions(
        [fresh], [UNENCODABLE])})
    degraded = body["results"][0]
    if (status != 200 or not degraded["degraded"] or degraded["cached"]
            or degraded["model"] != "gnn"):
        raise AssertionError(f"forced tokenizer failure: {status} {body}")
    big = synthetic_bigvul(1, FlowGNNConfig().feature, seed=SEED,
                           min_nodes=80, max_nodes=90)
    codes_seen = (_http(base, "/score", {"functions": []})[0],
                  _http(base, "/score", {"functions": _functions(big)})[0])
    if codes_seen != (400, 413):
        raise AssertionError(f"bad requests answered {codes_seen}")
    return {"answers": answers, "degraded": degraded,
            "bad_request_codes": list(codes_seen)}


def phase_serve_http() -> dict:
    """``cli serve`` on the card over real HTTP, the combined lane at
    codebert-base width beside the GNN lane on the persistent (default)
    and the fused message paths, each against the same engine on the
    CPU; a temporary directory removed afterwards."""
    root = tempfile.mkdtemp(prefix="serve_http_")
    try:
        return _serve_http(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _serve_http(root: str) -> dict:
    run = os.path.join(root, "combined")
    t0 = time.perf_counter()
    _write_combined_run(run)
    write_s = time.perf_counter() - t0
    feature = FlowGNNConfig().feature
    keep = ("num_nodes", "senders", "receivers", "feats", "id")

    def functions(n, seed):
        made = synthetic_bigvul(n, feature, seed=seed)
        codes = [t["code"] for t in attach_synthetic_text(
            [dict(g) for g in made], seed=TEXT_SEED)]
        return [{k: g[k] for k in keep} for g in made], codes

    graphs, _ = functions(N_HTTP_GRAPHS, SEED + 7)
    coded, codes = functions(N_HTTP_CODED, SEED + 8)
    load_graphs, _ = functions(LOAD_CLIENTS * LOAD_POSTS, SEED + 11)
    load_coded, load_codes = functions(LOAD_CLIENTS * LOAD_POSTS, SEED + 12)
    fresh = functions(1, SEED + 13)[0][0]
    launches = {k: 0 for k in REPLACES}
    lanes = {}
    load_probs = {}
    for impl in ("persistent", "fused"):
        t0 = time.perf_counter()
        proc, base, log = _start_server(run, impl, root)
        start_s = time.perf_counter() - t0
        try:
            _, _, m0 = _http(base, "/metrics")
            _, _, health = _http(base, "/healthz")
            load = {"gnn": _load_http(base, "gnn", load_graphs)}
            _, _, m_gnn = _http(base, "/metrics")
            load["combined"] = _load_http(base, "combined", load_coded,
                                          load_codes)
            traffic = _check_http(base, graphs, coded, codes, fresh)
            _, _, m1 = _http(base, "/metrics")
        finally:
            rc = _stop_server(proc)
        if rc != 0:
            with open(log) as f:
                raise AssertionError(f"cli serve ({impl}) exited {rc}: "
                                     f"{f.read()[-3000:]}")
        delta = {k: m1["kernel_launches"][k] - m0["kernel_launches"][k]
                 for k in launches}
        for k, v in delta.items():
            launches[k] += v
        step = "persistent_fwd_kernel" if impl == "persistent" \
            else "fused_step_kernel"
        if (delta["flash_fwd_kernel"] == 0 or delta[step] == 0
                or delta["persistent_fwd_kernel"] == 0):
            raise AssertionError(f"{impl} server launches {delta}")
        if m1["compiles"] != m0["compiles"] or m0["compiles"] != \
                health["warm_buckets"] or health["warm_buckets"] != 10:
            raise AssertionError(f"{impl}: compiles {m0['compiles']} -> "
                                 f"{m1['compiles']}, health {health}")
        hits = m1["cache_hits"] - m0["cache_hits"]
        if hits != 2 * HTTP_CHUNK or m1["degraded"] - m0["degraded"] != 1:
            raise AssertionError(f"{impl}: {hits} cache hits (want "
                                 f"{2 * HTTP_CHUNK}: the replayed chunks), "
                                 f"{m1['degraded'] - m0['degraded']} "
                                 f"degraded")
        # The same engine on the CPU: the checked functions, the gnn
        # lane's load and a bucket of the combined lane's load.
        cpu_engine, _ = cli._build_serve_engine(_serve_args(run, impl,
                                                            "cpu"))
        cpu_engine.warmup()
        n_cpu = 16
        want = {"gnn": cpu_engine.score_sync(graphs),
                "combined": cpu_engine.score_sync(coded, codes),
                "degraded": cpu_engine.score_sync([fresh]),
                "gnn_load": cpu_engine.score_sync(load_graphs),
                "combined_load": cpu_engine.score_sync(
                    load_coded[:n_cpu], load_codes[:n_cpu])}
        del cpu_engine
        got = {"gnn": [r["prob"] for r in traffic["answers"]["gnn"]],
               "combined": [r["prob"] for r in
                            traffic["answers"]["combined"]],
               "degraded": [traffic["degraded"]["prob"]],
               "gnn_load": load["gnn"]["probs"],
               "combined_load": load["combined"]["probs"][:n_cpu]}
        gaps = {k: float(np.abs(np.asarray(got[k]) - np.asarray(
            [r["prob"] for r in want[k]])).max()) for k in want}
        if max(gaps.values()) > HTTP_TOL:
            raise AssertionError(f"{impl}: |card - cpu| {gaps} > {HTTP_TOL}")
        load_probs[impl] = load["combined"]["probs"]
        lanes[impl] = dict(
            start_s=start_s, warm_buckets=health["warm_buckets"],
            compiles=m1["compiles"], launches=delta,
            max_abs_prob_diff_vs_cpu=gaps, cache_hits=hits,
            degraded=m1["degraded"] - m0["degraded"],
            gnn_engine_latency_p50_ms=m_gnn["latency_p50_ms"],
            gnn_engine_latency_p99_ms=m_gnn["latency_p99_ms"],
            device_bytes_in_use=health.get("device_bytes_in_use"),
            bad_request_codes=traffic["bad_request_codes"],
            load={lane: {k: v for k, v in rec.items() if k != "probs"}
                  for lane, rec in load.items()})
    # Every combined load answer, one server against the other.
    combined_load_gap = float(np.abs(load_probs["persistent"]
                                     - load_probs["fused"]).max())
    if combined_load_gap > HTTP_TOL:
        raise AssertionError(f"combined load answers differ between the "
                             f"servers by {combined_load_gap}")
    t0 = time.perf_counter()
    bucket_ms = _combined_bucket_ms(run)
    rec = dict(phase="serve_http", write_checkpoint_s=write_s, lanes=lanes,
               combined_load_persistent_vs_fused=combined_load_gap,
               combined_flush_by_bucket=bucket_ms,
               bucket_timing_s=time.perf_counter() - t0, launches=launches)
    emit(**rec)
    return rec


def phase_replay() -> dict:
    """The reference's replay gate on the card: 200 seeded bursty
    requests through a warmed engine (published FlowGNN, persistent
    lane, 8 slots) on a virtual clock."""
    model = FlowGNN(FlowGNNConfig(message_impl="persistent"), device="cuda",
                    seed=SEED)
    clock = VirtualClock()
    engine = ServeEngine(model, ServeConfig(batch_slots=8,
                                            deadline_ms=100.0),
                         clock=clock, device="cuda")
    warmed = engine.warmup()
    trace = bursty_trace(REPLAY_REQUESTS, model.config.feature, seed=1)
    reset_launch_counts()
    t0 = time.perf_counter()
    out = replay(engine, trace, clock)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = launch_counts()
    m = out["metrics"]
    if (m["completed"] != REPLAY_REQUESTS or m["dropped"]
            or m["batch_occupancy"] < 0.5 or not m["cache_hit_rate"] > 0
            or m["compiles"] != warmed or m["failures"]
            or launches["persistent_fwd_kernel"] == 0):
        raise AssertionError(f"replay gate: {m}, warmed {warmed}, "
                             f"launches {launches}")
    by_id = {int(r.graph["id"]): r.result["prob"] for r in out["requests"]}
    graphs = [e.graph for e in trace]
    offline = loop.evaluate(loop.make_eval_step(model, TrainConfig()),
                            graphs, np.arange(len(graphs)),
                            DataConfig(eval_batch_size=16),
                            list(subkeys_for(model.config.feature)), "cuda",
                            build_band_adj=True)
    gap = max(abs(by_id[int(i)] - float(p))
              for i, p in zip(offline.graph_ids, offline.probs))
    if gap > REPLAY_TOL:
        raise AssertionError(f"replay against the offline eval: {gap:.3e} "
                             f"> {REPLAY_TOL}")
    rec = dict(phase="replay", requests=REPLAY_REQUESTS, warmed=warmed,
               completed=m["completed"], dropped=m["dropped"],
               compiles=m["compiles"], batch_occupancy=m["batch_occupancy"],
               cache_hit_rate=m["cache_hit_rate"], batches=m["batches"],
               latency_p50_ms=m["latency_p50_ms"],
               latency_p99_ms=m["latency_p99_ms"],
               graphs_per_sec_virtual=m["graphs_per_sec"], wall_s=wall_s,
               max_abs_prob_diff_vs_offline=gap, launches=launches)
    emit(**rec)
    return rec


# ---------------------------------------------------------------------------
# DeepDFA+CodeT5: the paper's third model family
# ---------------------------------------------------------------------------

# synthetic:20 split 80/10/10: 16 training rows, one step of 16 (the HF
# weights' step).
CODET5_N_HF = 20
# What a codet5-base config.json holds (Salesforce/codet5-base's keys
# that the port reads; the card's host has no transformers).
CODET5_CONFIG = {
    "model_type": "t5", "vocab_size": 32100, "d_model": 768, "d_kv": 64,
    "d_ff": 3072, "num_layers": 12, "num_decoder_layers": 12,
    "num_heads": 12, "relative_attention_num_buckets": 32,
    "relative_attention_max_distance": 128, "dropout_rate": 0.1,
    "layer_norm_epsilon": 1e-6, "feed_forward_proj": "relu",
    "pad_token_id": 0, "bos_token_id": 1, "eos_token_id": 2,
    "decoder_start_token_id": 0, "tie_word_embeddings": True}


def _codet5_setup(n: int, batch: int, block: int, message_impl: str):
    """The data and fit_text arguments of ``cli fit-text --model codet5
    --graphs synthetic --set model.message_impl=...`` at these sizes (one
    epoch): t5-style ids from the hashing tokenizer, pad id 0."""
    graph_cfg = FlowGNNConfig(encoder_mode=True, label_style="graph",
                              message_impl=message_impl)
    tcfg = TransformerTrainConfig(max_epochs=1, batch_size=batch,
                                  eval_batch_size=batch, block_size=block,
                                  seed=TEXT_SEED)
    t5cfg = T5Config.codet5_base()
    data, splits, graphs = load_combined_dataset(
        f"synthetic:{n}", graph_cfg.feature,
        HashingT5Tokenizer(t5cfg.vocab_size), block, style="t5",
        graphs="synthetic", seed=TEXT_SEED)
    graphs, budget = graph_join_and_budget(list(graphs.values()), batch)
    kw = dict(graphs_by_id=graphs, subkeys=list(subkeys_for(
        graph_cfg.feature)), graph_budget=budget,
        pad_id=t5cfg.pad_token_id)
    return graph_cfg, tcfg, data, splits, kw


def _gnn_lane_launches(graph_cfg, data, indices, tcfg, kw, train: bool,
                       shuffle_seed=None) -> dict:
    """The GNN kernels a graph encoder of ``graph_cfg.message_impl``
    (fused or persistent) launches over the batches fit_text makes of
    ``indices`` (train: a gradient through the encoder; else forward
    only, as an evaluation or a frozen encoder runs it). A persistent
    batch over its gate runs the fused kernel per step
    (``FlowGNN._message_pass``)."""
    k, hidden = graph_cfg.n_steps, graph_cfg.ggnn_hidden
    gate = (fused_gnn.persistent_bwd_smem_ok if train
            else fused_gnn.persistent_smem_ok)
    rng = (np.random.default_rng(shuffle_seed) if shuffle_seed is not None
           else None)
    out = dict.fromkeys(REPLACES, 0)
    for b in text_loop.text_graph_batches(
            data, indices, tcfg.batch_size if train else tcfg.eval_batch_size,
            shuffle_rng=rng, build_band_adj=True, **kw):
        if graph_cfg.message_impl == "persistent" and gate(
                b.graphs.band_adj, hidden):
            names = (["persistent_fwd_kernel", "persistent_fwd_hist_kernel",
                      "persistent_bwd_kernel", "step_weight_grad_kernel"]
                     if train else ["persistent_fwd_kernel"])
            for name in names:
                out[name] += 1
        else:
            names = (["fused_step_kernel", "fused_step_bwd_kernel",
                      "step_weight_grad_kernel"] if train
                     else ["fused_step_kernel"])
            for name in names:
                out[name] += k
    return out


def _sum_launches(*counts) -> dict:
    return {name: sum(c[name] for c in counts) for name in REPLACES}


def phase_codet5() -> dict:
    """DeepDFA+CodeT5 (``DefectModel`` with the FlowGNN encoder): fit-text
    and test-text through the CLI at codet5-base width, 2 layers each
    side against the CPU, and a codet5-base HF directory read back and
    trained from; in a temporary directory removed afterwards."""
    root = tempfile.mkdtemp(prefix="codet5_")
    try:
        return _codet5(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _codet5(root: str) -> dict:
    t_phase = time.perf_counter()
    run = os.path.join(root, "run")
    t5cfg = T5Config.codet5_base()
    graph_cfg, tcfg, data, splits, kw = _codet5_setup(TEXT_N_FULL, 16, 512,
                                                      "persistent")

    # (a) fit-text --model codet5, then test-text, through the CLI.
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ft, ft_launches = _counted_cli([
        "fit-text", "--model", "codet5", "--dataset",
        f"synthetic:{TEXT_N_FULL}", "--graphs", "synthetic", "--epochs",
        "1", "--batch-size", "16", "--block-size", "512", "--set",
        "model.message_impl=persistent", "--checkpoint-dir", run,
        "--device", "cuda"])
    fit_text_s = time.perf_counter() - t0
    fit_text_peak = torch.cuda.max_memory_allocated()
    history = _read_history(run)
    losses = _text_steps(history)
    train_want = _gnn_lane_launches(graph_cfg, data, splits["train"], tcfg,
                                    kw, train=True, shuffle_seed=TEXT_SEED)
    val_want = _gnn_lane_launches(graph_cfg, data, splits["val"], tcfg, kw,
                                  train=False)
    test_want = _gnn_lane_launches(graph_cfg, data, splits["test"], tcfg,
                                   kw, train=False)
    for name in ("persistent_fwd_hist_kernel", "persistent_bwd_kernel",
                 "step_weight_grad_kernel"):
        if train_want[name] == 0:
            raise AssertionError(f"no training batch under the persistent "
                                 f"backward's gate: {train_want}")
    if val_want["persistent_fwd_kernel"] == 0:
        raise AssertionError(f"no evaluation batch under the persistent "
                             f"forward's gate: {val_want}")
    # history.json: fit_text's launches (train and validation); the CLI's
    # count adds the test split's evaluation.
    fit_want = {k: v for k, v in _sum_launches(train_want, val_want).items()
                if v}
    history_launches = {k: v for k, v in
                        history["graph_kernel_launches"].items() if v}
    if history_launches != fit_want:
        raise AssertionError(f"fit-text codet5 history launches "
                             f"{history_launches}, want {fit_want}")
    _require_launches("fit-text --model codet5", ft_launches, {
        k: v for k, v in _sum_launches(train_want, val_want,
                                       test_want).items() if v})
    desc = json.load(open(os.path.join(run, "model.json")))
    if desc["model"] != "codet5" or desc["tiny"] or not desc["combined"]:
        raise AssertionError(f"model.json {desc}")
    tt, tt_launches = _counted_cli(["test-text", "--checkpoint-dir", run,
                                    "--device", "cuda"])
    _require_launches("test-text --model codet5", tt_launches,
                      {k: v for k, v in test_want.items() if v})
    with open(os.path.join(run, "predictions.csv")) as f:
        fit_rows = f.read()
    with open(os.path.join(run, "test_predictions.csv")) as f:
        test_rows = f.read()
    if tt["loss"] != ft["test"]["loss"] or test_rows != fit_rows:
        raise AssertionError(f"test-text loss {tt['loss']} against "
                             f"fit-text's {ft['test']['loss']}")
    shutil.rmtree(run, ignore_errors=True)

    # The step at the same shapes: events, device ms by kernel, memory.
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = DefectModel(t5cfg, graph_cfg, device="cuda", seed=TEXT_SEED)
    n_params = sum(p.numel() for p in model.parameters())
    batch = next(text_loop.text_graph_batches(
        data, splits["train"], tcfg.batch_size, build_band_adj=True, **kw))
    breakdown = _text_step_breakdown(model, batch, tcfg)
    step_peak = torch.cuda.max_memory_allocated()
    step = text_loop.make_text_train_step(
        model, text_loop.make_text_optimizer(model.parameters(), tcfg), tcfg,
        torch.Generator().manual_seed(TEXT_SEED))
    profile = _device_profile(lambda: step(batch, tcfg.learning_rate),
                              TEXT_PROFILE_STEPS)
    del model, step
    torch.cuda.empty_cache()
    step_ms = (breakdown["forward_ms"] + breakdown["backward_ms"]
               + breakdown["optimizer_ms"])
    n_rows = int(batch.example_mask.sum())

    vs_cpu = _codet5_vs_cpu()
    hf = _codet5_hf(root)
    launches = _sum_launches(ft_launches, tt_launches, vs_cpu["launches"],
                             hf["launches"])
    rec = dict(phase="codet5", d_model=t5cfg.d_model,
               layers=[t5cfg.num_layers, t5cfg.num_decoder_layers],
               params=n_params, block_size=tcfg.block_size,
               batch_size=tcfg.batch_size, steps=len(losses), losses=losses,
               val_f1=history["epochs"][-1]["val_metrics"]["f1"],
               test_loss=ft["test"]["loss"], test_text_bits_equal=True,
               fit_text_wall_s=fit_text_s,
               fit_text_peak_mem_gb=fit_text_peak / 1e9,
               fit_text_launches=ft_launches, test_text_launches=tt_launches,
               step_breakdown=breakdown, step_profile=profile,
               examples_per_step=n_rows,
               examples_per_s=n_rows / (step_ms / 1e3),
               peak_mem_gb=step_peak / 1e9, vs_cpu=vs_cpu, hf=hf,
               launches=launches, seconds=time.perf_counter() - t_phase)
    emit(**rec)
    return rec


def _codet5_vs_cpu() -> dict:
    """DeepDFA+CodeT5 on the card and on the CPU from the same weights:
    width 768, 2 encoder and 2 decoder layers, batch 4, dropout off, the
    fused graph lane; one batch's logits and gradients, then 3 steps of
    fit_text, held to the fit_text_vs_cpu limits."""
    cfg = dataclasses.replace(T5Config.codet5_base(), num_layers=2,
                              num_decoder_layers=2, dropout_rate=0.0)
    graph_cfg, tcfg, data, splits, kw = _codet5_setup(TEXT_N_VS_CPU, 4, 512,
                                                      "fused")
    model = DefectModel(cfg, graph_cfg, device="cuda", seed=SEED)
    cpu_model = DefectModel(cfg, graph_cfg, device="cpu")
    cpu_model.load_state_dict({k: v.cpu()
                               for k, v in model.state_dict().items()})
    batch = next(text_loop.text_graph_batches(
        data, splits["train"], tcfg.batch_size, build_band_adj=True, **kw))
    with torch.no_grad():
        ids, _, _, graphs = text_loop._on_device(batch, "cuda")
        card = model(ids, graphs).cpu()
        ids, _, _, graphs = text_loop._on_device(batch, "cpu")
        want = cpu_model(ids, graphs)
    logit_gap = float((card - want).abs().max())
    logit_limit = GRAD_TOL * float(want.abs().max()) + TEXT_GRAD_FLOOR
    if not torch.isfinite(card).all() or logit_gap > logit_limit:
        raise AssertionError(f"codet5 logits card against cpu: {logit_gap} "
                             f"> {logit_limit}")
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
        raise AssertionError(f"codet5 fit_text card {losses} against cpu "
                             f"{cpu_losses} (limit {TEXT_LOSS_TOL})")
    want_launches = _sum_launches(
        _gnn_lane_launches(graph_cfg, data, splits["train"], tcfg, kw,
                           train=True, shuffle_seed=TEXT_SEED),
        _gnn_lane_launches(graph_cfg, data, splits["val"], tcfg, kw,
                           train=False))
    _require_launches("codet5 fit_text vs cpu (fused)", launches,
                      {k: v for k, v in want_launches.items() if v})
    return dict(layers=[cfg.num_layers, cfg.num_decoder_layers],
                graph_message_impl=graph_cfg.message_impl,
                batch_size=tcfg.batch_size, logit_gap=logit_gap,
                logit_gap_share_of_limit=logit_gap / logit_limit, **grads,
                losses=losses, cpu_losses=cpu_losses,
                max_abs_loss_diff_vs_cpu=float(diffs.max()),
                launches=launches, fit_wall_s=wall_s, cpu_fit_s=cpu_s)


def _codet5_hf(root: str) -> dict:
    """A codet5-base-shaped HF directory (random weights from a seed,
    written with ``write_safetensors`` and a ``config.json``), read back
    through ``load_pretrained`` bit for bit; then one fit_text step from
    those weights with the persistent graph encoder frozen (the step runs
    at lr 0: the weights after it are the loaded ones, bit for bit)."""
    cfg = T5Config.codet5_base()
    hf_dir = os.path.join(root, "codet5_hf")
    os.makedirs(hf_dir)
    src = T5Model(cfg, device="cpu", seed=SEED).state_dict()
    t0 = time.perf_counter()
    pretrained.write_safetensors(os.path.join(hf_dir, "model.safetensors"),
                                 convert.t5_to_hf(src, cfg))
    with open(os.path.join(hf_dir, "config.json"), "w") as f:
        json.dump(CODET5_CONFIG, f)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    kind, got_cfg, params = pretrained.load_pretrained(hf_dir)
    read_s = time.perf_counter() - t0
    if kind != "t5" or got_cfg != cfg or params.keys() != src.keys():
        raise AssertionError(f"load_pretrained: {kind} {got_cfg}")
    moved = [k for k, v in src.items() if not torch.equal(params[k], v)]
    if moved:
        raise AssertionError(f"HF T5 read back differs: {moved[:4]}")
    hf_bytes = os.path.getsize(os.path.join(hf_dir, "model.safetensors"))
    del src
    shutil.rmtree(hf_dir, ignore_errors=True)

    graph_cfg, tcfg, data, splits, kw = _codet5_setup(CODET5_N_HF, 16, 512,
                                                      "persistent")
    model = DefectModel(got_cfg, graph_cfg, device="cuda", seed=TEXT_SEED)
    encoder = {k: v.clone() for k, v in model.flowgnn.state_dict().items()}
    reset_launch_counts()
    t0 = time.perf_counter()
    _, history = text_loop.fit_text(
        model, data, splits, tcfg, init_params={
            f"t5.{k}": v for k, v in params.items()},
        freeze_submodules=("flowgnn",), **kw)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = launch_counts()
    losses = _text_steps(history)
    want = _sum_launches(
        _gnn_lane_launches(graph_cfg, data, splits["train"], tcfg, kw,
                           train=False),
        _gnn_lane_launches(graph_cfg, data, splits["val"], tcfg, kw,
                           train=False))
    _require_launches("codet5 from HF weights, graph encoder frozen",
                      launches, {k: v for k, v in want.items() if v})
    tuned = model.t5.state_dict()
    moved = [k for k, v in params.items()
             if not torch.equal(tuned[k].cpu(), v)]
    moved += [k for k, v in model.flowgnn.state_dict().items()
              if not torch.equal(v, encoder[k])]
    if len(losses) != 1 or moved:
        raise AssertionError(f"one lr-0 step from the HF weights: losses "
                             f"{losses}, moved {moved[:4]}")
    return dict(hf_bytes=hf_bytes, write_s=write_s, read_s=read_s,
                read_back_bits_equal=True, steps=len(losses), losses=losses,
                fit_s=fit_s, launches=launches)


def phase_codet5_bf16() -> dict:
    """DeepDFA+CodeT5 at bf16 (``T5Config.codet5_base()`` with
    ``dtype="bfloat16"``, the T5 attention plain torch; the graph encoder
    f32 on the persistent lane) through ``fit_text``: one epoch of
    ``synthetic:120`` at T 512, batch 16, its GNN launches as the
    batches' gates say; the step's breakdown, profile, examples/s and
    peak memory; a 2 + 2 layer copy against the CPU."""
    t5cfg = _bf16(T5Config.codet5_base())
    graph_cfg, tcfg, data, splits, kw = _codet5_setup(TEXT_N_FULL, 16, 512,
                                                      "persistent")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = DefectModel(t5cfg, graph_cfg, device="cuda", seed=TEXT_SEED)
    history, fit_launches, _, wall_s = _fit_text_counted(
        model, data, splits, tcfg, kw)
    fit_peak = torch.cuda.max_memory_allocated()
    losses = _text_steps(history)
    want = _sum_launches(
        _gnn_lane_launches(graph_cfg, data, splits["train"], tcfg, kw,
                           train=True, shuffle_seed=TEXT_SEED),
        _gnn_lane_launches(graph_cfg, data, splits["val"], tcfg, kw,
                           train=False))
    _require_launches("codet5 bf16 fit_text", fit_launches,
                      {k: v for k, v in want.items() if v})
    batch = next(text_loop.text_graph_batches(
        data, splits["train"], tcfg.batch_size, build_band_adj=True, **kw))
    torch.cuda.reset_peak_memory_stats()
    breakdown = _text_step_breakdown(model, batch, tcfg)
    step_peak = torch.cuda.max_memory_allocated()
    step = text_loop.make_text_train_step(
        model, text_loop.make_text_optimizer(model.parameters(), tcfg), tcfg,
        torch.Generator().manual_seed(TEXT_SEED))
    profile = _device_profile(lambda: step(batch, tcfg.learning_rate),
                              TEXT_PROFILE_STEPS)
    del model, step
    torch.cuda.empty_cache()
    step_ms = (breakdown["forward_ms"] + breakdown["backward_ms"]
               + breakdown["optimizer_ms"])
    n_rows = int(batch.example_mask.sum())
    cfg2 = dataclasses.replace(t5cfg, num_layers=2, num_decoder_layers=2,
                               dropout_rate=0.0)
    graph2, tcfg2, data2, splits2, kw2 = _codet5_setup(TEXT_N_VS_CPU, 4, 512,
                                                       "persistent")
    vs_cpu = _vs_cpu_bf16(DefectModel(cfg2, graph2, device="cuda", seed=SEED),
                          DefectModel(cfg2, graph2, device="cpu"), data2,
                          splits2, tcfg2, kw2)
    vs_cpu["layers"] = [cfg2.num_layers, cfg2.num_decoder_layers]
    rec = dict(phase="codet5_bf16", dtype=t5cfg.dtype, d_model=t5cfg.d_model,
               layers=[t5cfg.num_layers, t5cfg.num_decoder_layers],
               block_size=tcfg.block_size, batch_size=tcfg.batch_size,
               steps=len(losses), losses=losses,
               val_f1=history["epochs"][-1]["val_metrics"]["f1"],
               fit_launches=fit_launches, fit_wall_s=wall_s,
               fit_peak_mem_gb=fit_peak / 1e9, step_breakdown=breakdown,
               step_profile=profile, examples_per_step=n_rows,
               examples_per_s=n_rows / (step_ms / 1e3),
               device_idle_share=1.0 - profile["device_busy_ms"]
               / breakdown["step_wall_ms"],
               peak_mem_gb=step_peak / 1e9, vs_cpu=vs_cpu,
               launches=_sum_launches(fit_launches, vs_cpu["launches"]))
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
    timings.update(timed("attention_kernels_bf16", phase_attention_kernels,
                         torch.bfloat16))
    for phase, fn, args in (
            ("fit_text", phase_fit_text, ()),
            ("fit_text_vs_cpu", phase_fit_text_vs_cpu, ()),
            ("fit_text_vs_cpu_tile", phase_fit_text_vs_cpu, ("tile",)),
            ("fit_text_long", phase_fit_text_long, ()),
            ("recipe", phase_recipe, ()),
            ("inputs", phase_inputs, ()),
            ("serve_http", phase_serve_http, ()),
            ("replay", phase_replay, ()),
            ("codet5", phase_codet5, ()),
            ("fit_text_bf16", phase_fit_text_bf16, ()),
            ("fit_text_long_bf16", phase_fit_text_long_bf16, ()),
            ("codet5_bf16", phase_codet5_bf16, ())):
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
