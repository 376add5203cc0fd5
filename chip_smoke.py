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
   ``test``'s); ``test --set model.dtype=bfloat16`` of the same
   snapshot on the card (``persistent_fwd_kernel_bf16``) and on the CPU
   (loss within 5e-2, and within 5e-2 of the f32 test's); ``fit-text
   --ddfa-checkpoint --freeze-graph`` at codebert-base width (12 layers,
   T 512, batch 16, ``synthetic:120``, one epoch, a persistent graph
   encoder), whose ``best`` must hold the
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
   server's counts, taken as a difference); the first stopped with
   Ctrl-C (the lifecycle's drain: exit 75). The second records a
   telemetry run (``--run-dir``, ``--slo smoke``): ``/metrics`` as
   Prometheus text and as JSON, ``/healthz`` with ``slo`` and no
   telemetry drop, the run's ``serve.flush`` spans one a batch; then
   SIGTERM in a load window of 16 clients, one more holding a half-sent
   POST open so the drain lasts while probes see a new POST answered 503
   with Retry-After and ``/healthz`` "draining": exit 75, every 200 with
   its probabilities, every request the trace enqueued answered in it,
   its flush spans the exit record's batches, ``events.jsonl`` and
   ``trace.json`` written. Then the combined lane's device ms a flush at
   each slot bucket.
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
   each within a bf16 step (or 1e-5) of the f32 kernel's output on the
   widened inputs rounded once to bf16 (the elements apart counted) and,
   as a mean, no further from a float64 evaluation than 1.02 times it
   (the forward and the fused backward at T 512, the two-pass pair at
   T 4096; an earlier line), twice the same bits, timed beside its bound
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
25. The GNN kernels' bf16 instances (``FlowGNN(dtype="bfloat16")``,
   serving; run right after phase 5, with 26):
   ``fused_step_kernel_bf16`` and ``persistent_fwd_kernel_bf16`` at the
   serving and flagship shapes,
   bf16 h and band values (and f32 values at the serving shape), each
   against its plain version (one step within a bf16 step, rtol 2^-7;
   five steps within 5e-2; the elements that differ counted), the
   persistent instance bit for bit the scan of five fused launches,
   each timed beside its bound (bf16 bytes; the products of two bf16
   values at the bf16 tensor-core rate, the rest at f32 SIMT's), its
   plain version and the f32 kernel on the same inputs widened; the
   per-step instance's launch geometry held to the host plan.
26. Serving at bf16 (``--set model.dtype=bfloat16``, random weights from
   a seed): ``ServeEngine`` on the persistent and the fused lanes as
   phases 4-5 (64 requests and 16 duplicates, 16 slots; every flush a
   bf16 kernel launch and no f32 GNN kernel; probabilities against the
   same engine on the CPU within 5e-2, the gap recorded); ``cli score``
   of ``synthetic:64`` on both lanes, its launches and predictions
   against ``cli score --device cpu``; then ``cli serve`` in its own
   process over HTTP, GNN lane, 512 one-function POSTs from 16 clients
   (p50/p99 ms, requests/s), a chunk again (cache hits), the launches
   from ``/metrics``, the answers against the CPU engine.
27. The backward at bf16 (``FlowGNN(dtype="bfloat16")`` training; run
   last, with 28) at the training shape (N 16384, H 128, 5 steps), bf16
   and f32 band values: ``fused_step_bwd_kernel_bf16`` against its plain
   version (each output within a bf16 step of the element plus half a
   step at the tensor's scale, the elements apart counted),
   ``step_weight_grad_kernel_bf16`` over the 5 steps' cotangents against
   its plain version (1e-4 of each gradient's largest entry) and bit for
   bit the fold of 5 one-step calls, its one-step call (the fused lane's)
   timed beside it, the instance's blocks an SM and shared memory held to
   the host's mirror; the persistent lane's
   ``persistent_fwd_hist_kernel_bf16`` and ``persistent_bwd_kernel_bf16``
   against their plain versions (within 5e-2 of the element and of the
   tensor's scale over the 5 steps, the elements apart counted) and bit
   for bit the scans of the per-step instances (``scan_bits_equal``,
   timed beside them: ``scan_ms``);
   ``tile_spmm_kernel_bf16`` over A and A^T bit for bit its plain
   version (on the CPU, where its sums run in list order); each run
   twice for its bits and timed beside its bound,
   its plain version, the f32 kernel on the same inputs widened and its
   library call (the three products as stacked ``torch.mm`` at bf16;
   ``torch.sparse.mm`` on a bf16 CSR matrix; none for the gated steps).
28. Train at bf16, in a process of its own (fresh profiler state):
   ``train.loop.fit`` as phases 8-10 on the persistent (the CLI's
   default), fused, tile and band lanes with
   ``FlowGNNConfig(dtype="bfloat16")`` (f32 master parameters), losses
   against the CPU within 5e-2, the bf16 instances' launches exact (the
   persistent lane: no batch over its gate) and no f32 GNN or tile
   kernel launched, the step's breakdown and device ms by kernel beside
   the f32 lanes'.
29. DeepDFA+LineVul with a bf16 graph encoder (``fit-text --set
   model.dtype=bfloat16 --set model.message_impl=persistent``; the text
   encoder f32), as phase 13: full width, 2 layers, batch 4, dropout off,
   3 steps on the card and on the CPU from the same weights, losses
   within 5e-2; the persistent lane's bf16 instances launched as the
   batches' gates say.

30. The serving fleet (run after 19), the published FlowGNN (persistent
   lane, f32) from a seed: 200 bursty requests through a 2-replica
   ``ServeFleet`` on the card (both replicas on the one card, sharing
   its model) and through one ``ServeEngine``, bit for bit, both
   replicas flushing, no compile after warmup; the reference's fleet
   bench (640 open-loop requests at 20,000 a second, 8 slots, a 250 ms
   deadline, a 64-request queue, no cache, adaptive flush on) replayed
   through 1 and 4 replicas, primed first: every request completed or
   shed, no compile after warmup, the admitted p99 within the deadline,
   rps, p50, p99, sheds and the policies' decisions (the 4-replica rps
   modelled: one replica timeline stands for one card); then a live
   2-replica fleet over HTTP in this process with adaptive flush, 512
   one-function POSTs from 16 client threads (a 429 retried after its
   Retry-After), r1 out of rotation mid-traffic (``/healthz`` 503
   degraded, then 200 ok) and rolled (``roll_replica``): every function
   answered, the replica sections summing to ``/metrics``, compiles
   flat, ``persistent_fwd_kernel``'s launches those of the flushes
   (two pump threads counting), HTTP p50/p99 and requests/s; under a
   telemetry run, whose trace shows r1's ``fleet.replica_drain`` and
   ``fleet.replica_restore`` around the drain and again around the roll.

31. Serving as captured CUDA graphs (in a process of its own,
   run last): nine engines at the published FlowGNN width (the gnn lane
   on the persistent, fused, band and segment lanes at f32 and bf16, and
   the combined lane at codebert-base width, block 512, at f32) each
   capture every (lane, slot bucket) pair once at warmup; on each bucket
   the replay equals the eager forward (the lane's forward op by op on
   a fresh device copy of the packed batch) bit for bit on a full batch and on a partial batch
   after it, with eager and replay flush wall ms and device ms (medians
   of 20) and the staged bytes; 20 replays of the 16-slot pair under
   torch.profiler, each port kernel name's launches equal to what its
   launch counters moved by; ``bursty_trace(200, seed=1)`` replayed on
   the engine's virtual clock with nothing captured after warmup; each
   engine's graph-pool bytes. The phase runs under a telemetry run: a
   fenced ``serve.compile`` span a capture, a fenced ``serve.flush`` span
   a flush, nothing dropped; and ``span_cost``, the persistent f32
   lane's flush wall at 1 and 16 slots with telemetry off and with the
   run active, 300 interleaved pairs, the paired difference's median
   with its 95 % interval and quartiles. Phase 3
   also holds ``segment_sum_kernel``
   (the pooling's per-graph sums and softmax weights in one launch, the
   ids searched as they are, narrow lanes; the segment lane's f32
   aggregate over its plan, wide lanes) and phase 25
   ``segment_sum_kernel_bf16`` (the segment lane's bf16 aggregate over a
   plan built in the call and given: wide lanes at 16 slots, narrow at
   1) bit for bit to their plain versions at the serving buckets, each
   record naming the lanes the launcher chose, beside their bounds, a
   one-row launch (``floor_ms``) and ``index_add_``;
   phases 4-5, 18-19, 26 and 30 serve through the captured graphs, phase
   30's roll with no capture after warmup.

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
import math
import os
import re
import shutil
import signal
import socket
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
from deepdfa_tpu_torch import telemetry
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
from deepdfa_tpu_torch.graphs import segment
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
from deepdfa_tpu_torch.core.metrics import ServingStats
from deepdfa_tpu_torch.serve import ServeConfig, ServeEngine, ServeFleet
from deepdfa_tpu_torch.serve.batcher import ServeRequest
from deepdfa_tpu_torch.serve.engine import bucket_batch
from deepdfa_tpu_torch.serve.replay import (
    ReplicaTimeline,
    VirtualClock,
    bursty_trace,
    open_loop_trace,
    replay,
    replay_fleet,
)
from deepdfa_tpu_torch.resilience import lifecycle
from deepdfa_tpu_torch.telemetry import export as telemetry_export
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
# Long context at bf16 against the CPU (1 layer): of synthetic:10's 8
# training rows the first 4 = 2 steps of 2 (the CPU's plain attention at
# T 4096 takes about 8 s a layer and row), and its 1 validation row.
TEXT_N_LONG_VS_CPU, TEXT_LONG_VS_CPU_ROWS = 10, 4
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
# The flash kernels' bf16 instances (bf16 products grouped 16 deep, P and
# dS split three ways) against the f32 kernels on the widened inputs,
# rounded once to bf16: each element within one bf16 step, or within 1e-5
# (the f32 kernels' order gap, for values near 0 where sums cancel); lse
# within ATTN_FWD_TOL; and, as a mean over each output, no further from a
# float64 evaluation of the reference's formulas than 1.02 times the f32
# kernels' rounded result (f32 summation order): the two-pass pair at
# this shape and these lengths (the card test's), the forward and the
# fused backward at a T 512 shape, where the fused gate holds.
ATTN_BF16_PAIR_ATOL = 1e-5
ATTN_BF16_PAIR_F64_RATIO = 1.02
ATTN_PAIR_F64_SHAPE, ATTN_PAIR_F64_LENGTHS = (2, 4096, 2, 64), (3000, 100)
ATTN_FUSED_F64_SHAPE, ATTN_FUSED_F64_LENGTHS = (2, 512, 2, 64), (400, 70)
# The bf16 text paths against the CPU: the CPU tests' tolerance
# (tests/test_torch_bf16_text.py, the reference's own bf16 tolerance):
# logits and losses within 5e-2 absolute and relative.
BF16_TEXT_TOL = dict(rtol=5e-2, atol=5e-2)
# The GNN forward kernels' bf16 instances: the same TPU kernels (generic
# over the dtype there), the same source.
for _name in ("fused_step_kernel", "persistent_fwd_kernel"):
    REPLACES[_name + "_bf16"] = REPLACES[_name]
    SOURCES[_name + "_bf16"] = SOURCES[_name]
# A bf16 instance against its plain version: both round at the reference
# kernel's points and compute each sum in f32 in another order, so a
# value may land one bf16 step apart (rtol 2^-7); five steps carry such a
# step onward: the CPU tests' bf16 tolerance (tests/test_torch_bf16_gnn.py).
GNN_BF16_STEP_TOL = dict(rtol=2.0 ** -7, atol=1e-6)
GNN_BF16_UNROLL_TOL = dict(rtol=5e-2, atol=5e-2)
# The bf16 GNN paths, card against the CPU on the same weights: served
# probabilities, test losses and per-step training losses (the
# reference's bf16 tolerance).
BF16_GNN_TOL = 5e-2
# The bf16 backward instances and the bf16 tile product: the same TPU
# kernels at dt = bfloat16.
for _name in ("fused_step_bwd_kernel", "step_weight_grad_kernel",
              "persistent_fwd_hist_kernel", "persistent_bwd_kernel"):
    REPLACES[_name + "_bf16"] = REPLACES[_name]
    SOURCES[_name + "_bf16"] = SOURCES[_name]
REPLACES["tile_spmm_kernel"] = "deepdfa_tpu/ops/tile_spmm.py:364"
SOURCES["tile_spmm_kernel"] = "deepdfa_tpu_torch/csrc/tile_spmm.cu"
REPLACES["tile_spmm_kernel_bf16"] = REPLACES["tile_spmm_kernel"]
SOURCES["tile_spmm_kernel_bf16"] = SOURCES["tile_spmm_kernel"]
# The port's own kernel, no Pallas site: the ordered segment sum
# (graphs/segment.py) stands where the reference leaves
# jax.ops.segment_sum to XLA (the segment lane's aggregate, the pooling's
# per-graph sums); its f32 instance serves the pooling on the card.
for _name in ("segment_sum_kernel", "segment_sum_kernel_bf16"):
    REPLACES[_name] = "deepdfa_tpu/graphs/segment.py:24"
    SOURCES[_name] = "deepdfa_tpu_torch/csrc/segment_sum.cu"
# What index_add_ (the library_ms of the segment sums) computes of them:
# the same sums, in the order its atomics arrive.
SEGMENT_LIBRARY_COVERS = ["the per-bucket sums, by index_add_"]
# A bf16 persistent sweep's output against its plain version over the 5
# steps: a value one bf16 step apart carries onward, as in the forward
# (GNN_BF16_UNROLL_TOL): within 5e-2 of the element plus 5e-2 of the
# tensor's scale (the backward's cotangents are not of h's scale).
GNN_BF16_SWEEP_TOL = 5e-2
# A bf16 backward output against its plain version: each sums in f32 in
# another order and rounds at the reference's points, so a rounded
# intermediate (dpre, dx, dmsg) may land one bf16 step apart, and that
# step moves a later sum by one step of its term, which is not one step
# of the sum where the terms cancel: |kernel - plain| <= one bf16 step of
# the element (2^-7 of it) + half a step at the tensor's scale (2^-8 of
# its largest entry).
GNN_BF16_BWD_RTOL, GNN_BF16_BWD_SCALE = 2.0 ** -7, 2.0 ** -8
# The tile product against its plain version: each output sums a row's
# few edges in another order (f32 FMAs against cuBLAS's bmm and
# index_add_).
TILE_TOL = dict(rtol=1e-5, atol=1e-5)
# What torch.sparse.mm on A (f32 CSR) computes of the kernel's output.
TILE_LIBRARY_COVERS = ["agg = A @ msg"]
# Every __global__ function of csrc/ by its name in the source, as
# torch.profiler reports it: the kernels above (persistent_fwd_hist_kernel
# is an instance of persistent_fwd_kernel and counts under that name, its
# bf16 instance likewise under persistent_fwd_kernel_bf16), the second
# steps of two of them, the weight gradients' and the fused flash
# backward's reductions, and the first step of the bf16 GNN forwards, their
# weights' prep.
PORT_KERNELS = (set(REPLACES) - {"persistent_fwd_hist_kernel",
                                 "persistent_fwd_hist_kernel_bf16"}) | {
    "step_weight_grad_reduce_kernel", "flash_dq_sum_kernel",
    "flash_dq_sum_kernel_bf16", "fwd_bf16_prep_kernel"}
# The launch counters that must move where the profile files time under
# a name: the reductions' parent kernels (the weight pass's reduction is
# shared by its f32 and bf16 instances), the hist instances of the
# persistent forwards, which the profile files under their names, and the
# bf16 forwards' prep.
PROFILE_COUNTERS = {
    "step_weight_grad_reduce_kernel": ("step_weight_grad_kernel",
                                       "step_weight_grad_kernel_bf16"),
    "flash_dq_sum_kernel": ("flash_bwd_fused_kernel",),
    "flash_dq_sum_kernel_bf16": ("flash_bwd_fused_kernel_bf16",),
    "persistent_fwd_kernel": ("persistent_fwd_kernel",
                              "persistent_fwd_hist_kernel"),
    "persistent_fwd_kernel_bf16": ("persistent_fwd_kernel_bf16",
                                   "persistent_fwd_hist_kernel_bf16"),
    "fwd_bf16_prep_kernel": ("fused_step_kernel_bf16",
                             "persistent_fwd_kernel_bf16",
                             "persistent_fwd_hist_kernel_bf16"),
}
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
    _full_f32()
    return name


def _full_f32() -> None:
    # The plain versions run f32 products in full f32, as the reference
    # holds them to Precision.HIGHEST.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


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
    clusters the card holds at once (``active_clusters``); for a bf16
    instance its blocks' shared memory as the library sizes it
    (``smem_bytes``), held to the host's mirror."""
    _same_bits(f"{name} vs the per-step scan", _as_list(kernel()),
               _as_list(scan()))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cluster = (fused_gnn.persistent_cluster_size(
        adj, hidden, sms,
        torch.bfloat16 if which.endswith("_bf16") else torch.float32)
               if which in ("persistent_fwd_kernel",
                            "persistent_fwd_kernel_bf16",
                            "persistent_fwd_hist_kernel_bf16") else 1)
    occ = fused_gnn.persistent_occupancy(adj, hidden, which, cluster)
    mirror = {"persistent_fwd_kernel_bf16":
              fused_gnn.persistent_fwd_bf16_smem_bytes,
              "persistent_fwd_hist_kernel_bf16":
              fused_gnn.persistent_fwd_bf16_smem_bytes,
              "persistent_bwd_kernel_bf16":
              fused_gnn.persistent_bwd_bf16_smem_bytes}.get(which)
    if mirror is not None and occ["smem_bytes"] != mirror(adj, hidden):
        raise AssertionError(f"{name}: the library sizes {occ['smem_bytes']}"
                             f" B of shared memory, the host "
                             f"{mirror(adj, hidden)}")
    return dict(scan_ms=_time_ms(scan, iters, reps), cluster=cluster, **occ)


def _step_geometry(adj, hidden, kernel) -> dict:
    """The launch geometry of a per-step kernel at this adjacency, as its
    library reports it, held to the host plan it mirrors on this card's
    SMs, shared memory included."""
    geo = fused_gnn.step_geometry(adj, hidden, kernel)
    n = adj.n_tiles * adj.tile
    plan = fused_gnn.step_plan(n, hidden, geo["sms"], kernel)
    plan["smem_bytes"] = fused_gnn.step_smem_bytes(n, hidden, geo["sms"],
                                                   kernel, 0)
    if kernel in ("fused_step_bwd_kernel", "fused_step_kernel_bf16",
                  "fused_step_bwd_kernel_bf16"):
        plan["smem_bytes_pass1"] = fused_gnn.step_smem_bytes(
            n, hidden, geo["sms"], kernel, 1)
    if kernel == "fused_step_bwd_kernel_bf16":
        plan["smem_bytes_pass2"] = fused_gnn.step_smem_bytes(
            n, hidden, geo["sms"], kernel, 2)
    for key in plan.keys() - {"wide"}:
        if geo[key] != plan[key]:
            raise AssertionError(f"{kernel}: the library plans {key} "
                                 f"{geo[key]}, step_plan {plan[key]}")
    return dict(geo, wide=plan["wide"])


def _as_list(out) -> list:
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _segment_record(phase: str, name: str, parts, ids, n, mask,
                    indices_are_sorted: bool, instance: str,
                    lanes: tuple) -> dict:
    """The ordered segment sum (``name``'s instance) over ``parts`` (one
    launch for all) against its plain version, bit for bit, timed beside
    its bound (the rows the mask keeps read once, the ids and the mask
    read once, the output written once, over 3.35 TB/s; an add a kept
    element at the f32 SIMT rate), its floor (the same wrapper's call on
    one row into one bucket: a launch and little else), its plain version
    and ``index_add_`` on the same rows side by side in one tensor (the
    same sums in its atomics' order). ``indices_are_sorted``: the ids are
    searched as they are (the pooling); else the call builds its plan
    (``kernel_ms``), and the record adds the call with the plan given
    (``plan_given_ms``: what each of a forward's steps pays) and the plan
    alone (``plan_ms``). ``instance`` names the call; ``lanes`` are the
    lane kinds the launcher must choose for the operands (recorded as
    ``lanes``), so the record holds that instance of the kernel."""
    parts = tuple(parts)
    plan = lambda: segment.segment_sum_plan(
        ids, n, mask, indices_are_sorted=indices_are_sorted)
    kernel = lambda: segment.segment_sum_rows(parts, plan())
    keyed = segment._bucket_ids(ids, n, mask)
    plain = lambda: tuple(segment._segment_sum_ordered(x, keyed, n)
                          for x in parts)
    wide = torch.cat([x.reshape(x.shape[0], -1) for x in parts], 1)
    library = lambda: torch.zeros(
        (n + 1, wide.shape[1]), dtype=wide.dtype,
        device=wide.device).index_add_(0, keyed, wide)[:n]
    before = launch_counts()[name]
    got = kernel()
    launches = launch_counts()[name] - before
    want = plain()
    _same_bits(f"{name} ({instance}) vs its plain version", list(got),
               list(want))
    chosen = segment.segment_sum_lanes(parts, got)
    if chosen != tuple(lanes):
        raise AssertionError(f"{name} ({instance}): the launcher chose "
                             f"{chosen} lanes, the record holds {lanes}")
    got_wide = torch.cat([x.reshape(n, -1) for x in got], 1)
    err = float((got_wide.float() - library().float()).abs().max())
    cols = wide.shape[1]
    kept = wide.shape[0] if mask is None else int(mask.sum())
    elem = wide.element_size()
    nbytes = _nbytes(ids, *([] if mask is None else [mask])) + (
        kept + n) * cols * elem
    flops = float(kept * cols)
    t_ops, t_bytes = flops / 67e12, nbytes / PEAK_BYTES_PER_S
    one = torch.zeros(1, dtype=wide.dtype, device=wide.device)
    one_id = torch.zeros(1, dtype=torch.int32, device=wide.device)
    rec = dict(kernel=name, instance=instance,
               mode="sorted" if indices_are_sorted else "plan",
               lanes=list(chosen), rows=wide.shape[0], kept_rows=kept,
               cols=cols, operands=[list(x.shape) for x in parts],
               buckets=n, dtype=str(wide.dtype), max_abs_err=0.0,
               max_abs_diff_vs_index_add=err, plain_bits_equal=True,
               kernel_ms=_time_ms(kernel), plain_ms=_time_ms(plain),
               library_ms=_time_ms(library),
               library_covers=SEGMENT_LIBRARY_COVERS,
               floor_ms=_time_ms(lambda: segment.segment_sum_rows(
                   one, segment.segment_sum_plan(
                       one_id, 1, indices_are_sorted=True))),
               bound_us=max(t_ops, t_bytes) * 1e6,
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               bound_peak="f32 SIMT FMA, 67 TFLOP/s",
               bound_peak_tflops=67.0, bytes=nbytes, flops=flops,
               launches=launches)
    if not indices_are_sorted:
        given_plan = plan()
        given = lambda: segment.segment_sum_rows(parts, given_plan)
        _same_bits(f"{name} ({instance}) with its plan given vs its plain "
                   f"version", list(given()), list(want))
        rec.update(plan_given_ms=_time_ms(given), plan_ms=_time_ms(plan))
    emit(phase=phase, **rec)
    return rec


def _segment_checked(main: dict, *others: dict) -> dict:
    """``main`` (the record the ``kernels`` line times) with ``checked``:
    every instance of the kernel held bit for bit to its plain version in
    this run, by call, mode, lanes and shape."""
    return dict(main, checked=[
        {key: r[key] for key in ("instance", "mode", "lanes", "rows",
                                 "buckets", "cols", "kernel_ms")}
        for r in (main,) + others])


def _aggregate_rows(batch, width: int, dtype, seed: int):
    """The segment lane's messages over ``batch``'s edges (padded edges
    zero), seeded."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    msg = torch.randn((batch.max_edges, width), generator=gen,
                      device="cuda").to(dtype)
    return torch.where(batch.edge_mask[:, None], msg, 0.0)


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
        # The pooling's per-graph sums at the serving bucket, both in one
        # launch: the weighted node rows (the GGNN output beside the
        # embedding) and the softmax weights, by graph, node_graph
        # searched as it is.
        batch = _serving_batch(model)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        rows = torch.randn((batch.max_nodes, cfg.out_dim), generator=gen,
                           device="cuda")
        rows = torch.where(batch.node_mask[:, None], rows, 0.0)
        e = torch.where(batch.node_mask, torch.rand(
            batch.max_nodes, generator=gen, device="cuda"), 0.0)
        if not batch.node_graph_sorted:
            raise AssertionError("the serving bucket's node_graph is not "
                                 "sorted")
        pool = _segment_record(
            "kernels", "segment_sum_kernel", (rows, e), batch.node_graph,
            batch.n_graphs, batch.node_mask, True, "pooling, 16 slots",
            ("narrow", "narrow"))
        # The segment lane's f32 aggregate at the same bucket: one bucket
        # a node, 16-byte lanes over a plan's order.
        agg = _segment_record(
            "kernels", "segment_sum_kernel",
            (_aggregate_rows(batch, cfg.ggnn_hidden, torch.float32,
                             SEED + 2),), batch.receivers, batch.max_nodes,
            batch.edge_mask, False, "aggregate, 16 slots", ("wide",))
        serving["segment_sum_kernel"] = _segment_checked(pool, agg)
    return serving


def _requests():
    graphs = synthetic_bigvul(N_REQUESTS, FlowGNNConfig().feature,
                              seed=SEED + 1)
    return [{k: g[k] for k in ("num_nodes", "senders", "receivers",
                               "feats", "id")} for g in graphs]


def _flush_breakdown(engine: ServeEngine, graphs, reps: int = 10) -> dict:
    """Median host ms of one full 16-slot flush's parts: packing the batch
    on the host, staging it into the pair's buffers and on to the card in
    one transfer, and the forward (the pair's graph replayed, ended by a
    synchronize); plus the replay's device time from CUDA events."""
    parts = {"pack_ms": [], "to_device_ms": [], "forward_ms": [],
             "forward_device_ms": []}
    slots = engine.config.batch_slots
    for _ in range(reps):
        t0 = time.perf_counter()
        gb, ids = engine._pack("gnn", graphs, slots)
        t1 = time.perf_counter()
        with engine._on_stream():
            prog = engine._program("gnn", slots, gb, ids)
            prog.staged.stage(gb, ids)
            torch.cuda.current_stream().synchronize()
            t2 = time.perf_counter()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            prog.graph.replay()
            end.record()
            end.synchronize()
        t3 = time.perf_counter()
        parts["pack_ms"].append((t1 - t0) * 1e3)
        parts["to_device_ms"].append((t2 - t1) * 1e3)
        parts["forward_ms"].append((t3 - t2) * 1e3)
        parts["forward_device_ms"].append(start.elapsed_time(end))
    return {k: statistics.median(v) for k, v in parts.items()}


def phase_serve(impl: str, dtype: str = "float32") -> dict:
    """The serving engine on one lane at the published width (phases 4-5;
    at bf16, part of phase 26): every flush a launch of the lane's kernel
    (its bf16 instance at bf16, and then no f32 GNN kernel), the
    probabilities against the same engine on the CPU."""
    cfg = FlowGNNConfig(message_impl=impl, dtype=dtype)
    bf16 = dtype == "bfloat16"
    suffix = "_bf16" if bf16 else ""
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
    persistent = launches["persistent_fwd_kernel" + suffix]
    if impl == "persistent":
        if persistent + model.over_gate_dispatches < flushes \
                or persistent == 0:
            raise AssertionError(f"persistent lane: {launches} over "
                                 f"{flushes} flushes")
    elif launches["fused_step_kernel" + suffix] != cfg.n_steps * flushes:
        raise AssertionError(f"fused lane: {launches} over {flushes} "
                             "flushes")
    if bf16 and any(launches[k] for k in fused_gnn.KERNELS
                    if not k.endswith("_bf16")):
        raise AssertionError(f"{impl} at bf16 launched an f32 GNN kernel: "
                             f"{launches}")

    # The same weights on the CPU, where the plain versions run.
    cpu_model = FlowGNN(cfg, device="cpu")
    cpu_model.load_state_dict({k: v.cpu()
                               for k, v in model.state_dict().items()})
    cpu_engine = ServeEngine(cpu_model, ServeConfig(), device="cpu")
    want = np.asarray([r["prob"] for r in cpu_engine.score_sync(reqs)])
    max_diff = float(np.abs(probs - want).max())
    tol = BF16_GNN_TOL if bf16 else SERVE_TOL
    if max_diff > tol:
        raise AssertionError(f"{impl}: |cuda - cpu| prob {max_diff:.3e} > "
                             f"{tol}")
    rec = dict(phase="serve", message_impl=impl, dtype=dtype,
               warmed_buckets=warmed, graphs_captured=engine.graphs_captured,
               graph_pool_bytes=engine.graph_pool_bytes,
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


def _bf16_diff(got, want) -> dict:
    """A bf16 kernel output against its plain version: the elements that
    differ, of how many, and the largest difference in bf16 steps of the
    plain value (2^-8 to 2^-7 of it a step)."""
    torch.cuda.synchronize()
    g, w = got.float(), want.float()
    d = (g - w).abs()
    nonzero = w != 0
    return {"elements_differing": int((d > 0).sum()),
            "elements": g.numel(),
            "max_rel_diff": float((d[nonzero] / w[nonzero].abs()).max())
            if bool(nonzero.any()) else 0.0}


def phase_kernels_bf16(model: FlowGNN) -> dict:
    """Phase 25: both bf16 instances against their plain versions at the
    serving and flagship shapes, the persistent one bit for bit the scan
    of the fused one, timed beside their bounds, their plain versions and
    the f32 kernels on the same inputs; returns the serving-shape numbers
    by kernel."""
    cfg = model.config
    params = model.ggnn_step.step_params()
    p16 = fused_gnn.packed_weights(params, torch.bfloat16)
    p32 = fused_gnn.packed_weights(params)
    k = cfg.n_steps
    serving = {}
    with torch.inference_mode():
        for shape, batch in (("serving", _serving_batch(model)),
                             ("flagship", _flagship_batch(model))):
            h32 = torch.cat([model.embeds[k_](batch.node_feats[k_])
                             for k_ in model.subkeys], dim=-1).contiguous()
            h = h32.bfloat16()
            cases = [("bf16", batch.band_adj)]
            if shape == "serving":
                cases.append(("f32", dataclasses.replace(
                    batch.band_adj, vals=batch.band_adj.vals.float())))
            for vals, adj in cases:
                if not fused_gnn.persistent_smem_ok(adj, cfg.ggnn_hidden,
                                                    torch.bfloat16):
                    raise AssertionError(f"{shape}: row groups over the "
                                         "bf16 gate")
                runs = {
                    "fused_step_kernel_bf16": (
                        lambda: fused_gnn.fused_gate_step(params, h, adj,
                                                          packed=p16),
                        lambda: fused_gnn.fused_step_reference(params, h,
                                                               adj),
                        lambda: fused_gnn.fused_gate_step(params, h32, adj,
                                                          packed=p32),
                        GNN_BF16_STEP_TOL, 1, k),
                    "persistent_fwd_kernel_bf16": (
                        lambda: fused_gnn.persistent_unroll(
                            params, h, adj, k, packed=p16),
                        lambda: fused_gnn.persistent_reference(
                            params, h, adj, k),
                        lambda: fused_gnn.persistent_unroll(
                            params, h32, adj, k, packed=p32),
                        GNN_BF16_UNROLL_TOL, k, 1),
                }
                for name, (kernel, plain, f32, tol, steps,
                           per_forward) in runs.items():
                    got, want = kernel(), plain()
                    if got.dtype != torch.bfloat16:
                        raise AssertionError(f"{name}: {got.dtype} out")
                    err = _check(f"{name}@{shape}/{vals}", got.float(),
                                 want.float(), tol)
                    rec = dict(kernel=name, shape=shape, band_vals=vals,
                               n_rows=h.shape[0], hidden=h.shape[1],
                               bandwidth=adj.bandwidth, steps=steps,
                               max_abs_err=err, tol=tol,
                               **_bf16_diff(got, want))
                    if name == "persistent_fwd_kernel_bf16":
                        rec.update(_scan_record(
                            f"{name}@{shape}/{vals}", kernel,
                            lambda: _fused_scan(params, h, adj, k, p16),
                            adj, cfg.ggnn_hidden, which=name),
                            scan_bits_equal=True)
                    else:
                        rec.update(_step_geometry(adj, cfg.ggnn_hidden,
                                                  name))
                    if vals == "bf16":
                        before = launch_counts()[name]
                        kernel_ms = _time_ms(kernel)
                        launches = launch_counts()[name] - before
                        cost = fused_gnn.kernel_cost(adj, cfg.ggnn_hidden,
                                                     steps, kernel=name)
                        bound_ms, bound_by = _bound(cost)
                        rec.update(
                            kernel_ms=kernel_ms, plain_ms=_time_ms(plain),
                            f32_kernel_ms=_time_ms(f32),
                            bound_us=bound_ms * 1e3, bound_by=bound_by,
                            **_peak(cost), flops=cost["flops"],
                            flops_bf16=cost["flops_bf16"],
                            bytes=cost["bytes"], nnz=cost["nnz"],
                            launches=launches,
                            launches_per_forward=per_forward)
                    emit(phase="kernels_bf16", **rec)
                    if shape == "serving" and vals == "bf16":
                        serving[name] = rec
        # The segment lane's aggregate at bf16 at the serving bucket: each
        # edge's message summed into its receiver in edge order, rounded
        # after each add, the padded edges left out.
        # The 16-slot bucket takes 16-byte lanes; the 1-slot bucket's few
        # nodes take 4-byte lanes of bf16 pairs.
        aggs = []
        for slots, lanes in ((16, "wide"), (1, "narrow")):
            batch = (_serving_batch(model) if slots == 16 else bucket_batch(
                ServeConfig(), synthetic_bigvul(1, cfg.feature, seed=SEED),
                1, list(model.subkeys), band=True).to("cuda"))
            aggs.append(_segment_record(
                "kernels_bf16", "segment_sum_kernel_bf16",
                (_aggregate_rows(batch, cfg.ggnn_hidden, torch.bfloat16,
                                 SEED + 1),), batch.receivers,
                batch.max_nodes, batch.edge_mask, False,
                f"aggregate, {slots} slot{'s' * (slots > 1)}", (lanes,)))
        serving["segment_sum_kernel_bf16"] = _segment_checked(*aggs)
    return serving


def phase_serve_bf16() -> dict:
    """Phase 26: serving at bf16 through the engine, ``cli score`` and
    ``cli serve`` over HTTP; a temporary directory removed afterwards."""
    root = tempfile.mkdtemp(prefix="serve_bf16_")
    try:
        return _serve_bf16(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _serve_bf16(root: str) -> dict:
    bf16 = ["--set", "model.dtype=bfloat16"]
    launches = {k: 0 for k in REPLACES}
    engine = {}
    for impl in ("persistent", "fused"):
        rec = phase_serve(impl, "bfloat16")
        engine[impl] = {key: rec[key] for key in (
            "requests", "flushes", "cache_hits", "launches",
            "over_gate_dispatches", "max_abs_prob_diff_vs_cpu",
            "requests_per_s", "latency_p50_ms", "latency_p99_ms",
            "flush_breakdown", "warmup_s")}
        for key in launches:
            launches[key] += rec["launches"][key]
    score = {}
    for impl in ("persistent", "fused"):
        lane = ["--set", f"model.message_impl={impl}"]
        argv = ["score", "--dataset", f"synthetic:{N_REQUESTS}",
                "--batch-slots", "16", *bf16, *lane]
        t0 = time.perf_counter()
        report, counts = _counted_cli(
            argv + ["--device", "cuda", "--out-dir",
                    os.path.join(root, f"score_{impl}")])
        wall_s = time.perf_counter() - t0
        cpu = _cli(argv + ["--device", "cpu", "--out-dir",
                           os.path.join(root, f"score_{impl}_cpu")])
        card, want = _read_probs(report["out"]), _read_probs(cpu["out"])
        gap = max(abs(card[i] - want[i]) for i in want)
        batches = report["serving"]["batches"]
        kname = ("persistent_fwd_kernel_bf16" if impl == "persistent"
                 else "fused_step_kernel_bf16")
        want = batches if impl == "persistent" else 5 * batches
        if (report["n_scored"] != N_REQUESTS or report["n_errors"]
                or counts[kname] + report["over_gate_dispatches"] < want
                or counts[kname] == 0 or gap > BF16_GNN_TOL
                or any(counts[k] for k in fused_gnn.KERNELS
                       if not k.endswith("_bf16"))):
            raise AssertionError(f"cli score ({impl}, bf16): {report}, "
                                 f"launches {counts}, |card - cpu| {gap}")
        for key in launches:
            launches[key] += counts[key]
        score[impl] = dict(wall_s=wall_s, batches=batches, launches={
            k: v for k, v in counts.items() if v},
            max_abs_prob_diff_vs_cpu=gap,
            latency_p50_ms=report["serving"]["latency_p50_ms"],
            latency_p99_ms=report["serving"]["latency_p99_ms"])
    # cli serve over HTTP, GNN lane, the default (persistent) lane.
    graphs = [{k: g[k] for k in ("num_nodes", "senders", "receivers",
                                 "feats", "id")}
              for g in synthetic_bigvul(LOAD_CLIENTS * LOAD_POSTS,
                                        FlowGNNConfig().feature,
                                        seed=SEED + 21)]
    t0 = time.perf_counter()
    # The GNN lane alone, random weights from the seed.
    proc, base, log = _start_server(bf16, "gnn_bf16", root)
    start_s = time.perf_counter() - t0
    try:
        _, _, m0 = _http(base, "/metrics")
        _, _, health = _http(base, "/healthz")
        load = _load_http(base, "gnn", graphs)
        status, _, replay = _http(base, "/score", {
            "functions": _functions(graphs[:HTTP_CHUNK])})
        _, _, m1 = _http(base, "/metrics")
    finally:
        rc = _stop_server(proc)
    if rc != lifecycle.EXIT_PREEMPTED:
        with open(log) as f:
            raise AssertionError(f"cli serve (bf16) exited {rc}: "
                                 f"{f.read()[-3000:]}")
    delta = {k: m1["kernel_launches"][k] - m0["kernel_launches"][k]
             for k in launches}
    hits = m1["cache_hits"] - m0["cache_hits"]
    if (status != 200 or hits != HTTP_CHUNK
            or not all(r["cached"] for r in replay["results"])
            or delta["persistent_fwd_kernel_bf16"] == 0
            or any(delta[k] for k in fused_gnn.KERNELS
                   if not k.endswith("_bf16"))
            or m1["compiles"] != m0["compiles"]):
        raise AssertionError(f"cli serve (bf16): status {status}, {hits} "
                             f"cache hits, launches {delta}")
    for key in launches:
        launches[key] += delta[key]
    cpu_engine, _, _ = cli._build_serve_engine(cli.build_parser().parse_args(
        ["serve", *bf16, "--device", "cpu"]))
    cpu_engine.warmup()
    want = np.asarray([r["prob"] for r in cpu_engine.score_sync(graphs)])
    http_gap = float(np.abs(load["probs"] - want).max())
    if http_gap > BF16_GNN_TOL:
        raise AssertionError(f"cli serve (bf16): |card - cpu| {http_gap}")
    rec = dict(phase="serve_bf16", engine=engine, score=score,
               http=dict(start_s=start_s, warm_buckets=health[
                   "warm_buckets"], launches={k: v for k, v in delta.items()
                                              if v},
                         cache_hits=hits, max_abs_prob_diff_vs_cpu=http_gap,
                         **{k: v for k, v in load.items() if k != "probs"}),
               launches=launches)
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
    all; ``profile_sessions`` says how many it took. If none of them
    records any, the calls are timed with CUDA events instead
    (``_event_profile``): the per-kernel numbers are then not measured
    (None, or empty), and the run goes on."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    for sessions in range(1, PROFILE_SESSIONS + 1):
        before = launch_counts()
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
        return _event_profile(step, n_steps)
    kernels.sort(reverse=True)
    # The port's own kernels, by the name in their source, wherever they
    # rank. Every bf16 instance carries _bf16 in its own __global__ name;
    # template arguments (the band-value type VT is bf16 in the f32 GNN
    # kernels too) name nothing.
    port = {}
    for ms, key, calls in kernels:
        found = re.search(r"(\w+)(<[^(]*>)?\(", key)
        if not found:
            continue
        name = found.group(1)
        if name in PORT_KERNELS:
            entry = port.setdefault(name, {"ms": 0.0, "calls": 0.0})
            entry["ms"] += ms
            entry["calls"] += calls
    # Each name filed must have launched in the profiled run, by its own
    # counter (or its parent's): a kernel filed under another name shows
    # here. (Not the converse: the profiler drops some launches, all of a
    # rarely launched kernel's at times.)
    after = launch_counts()
    for name in port:
        counters = PROFILE_COUNTERS.get(name, (name,))
        if sum(after[c] - before[c] for c in counters) <= 0:
            raise AssertionError(
                f"the profile files {port[name]['ms']:.3f} ms under {name}, "
                f"but {counters} launched nothing in its run")
    # cuBLAS's products (the linears, and the T5 attention's matmuls).
    gemm = [k for k in kernels if re.search(r"gemm|nvjet", k[1])]
    return {"device_busy_ms": sum(k[0] for k in kernels),
            "kernels_a_call": sum(k[2] for k in kernels),
            "gemm_ms": sum(k[0] for k in gemm),
            "gemm_calls": sum(k[2] for k in gemm),
            "top_kernels": [{"name": name[:90], "ms": ms, "calls": calls}
                            for ms, name, calls in kernels[:PROFILE_TOP]],
            "port_kernels": port, "profile_sessions": sessions}


def _event_profile(step, n_steps: int) -> dict:
    """``_device_profile``'s result where torch.profiler recorded no
    device time: the device span a call between two CUDA events around
    ``n_steps`` calls (``event_span_ms``; it holds the device's idle gaps
    too, so it bounds the busy time from above) and no per-kernel
    numbers."""
    print(f"torch.profiler recorded no device time in {PROFILE_SESSIONS} "
          "sessions: CUDA-event span instead", file=sys.stderr, flush=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n_steps):
        step()
    end.record()
    torch.cuda.synchronize()
    return {"device_busy_ms": None, "kernels_a_call": None,
            "gemm_ms": None, "gemm_calls": None, "top_kernels": [],
            "port_kernels": {}, "profile_sessions": PROFILE_SESSIONS,
            "event_span_ms": start.elapsed_time(end) / n_steps}


def _ratio(num, den):
    """num / den, or None where either was not measured."""
    return None if num is None or den is None else num / den


def _pair_ms(profile: dict, names) -> float | None:
    """Device ms a call of the kernels ``names`` by the profiler, None
    where it recorded no device time."""
    if profile["device_busy_ms"] is None:
        return None
    return sum(profile["port_kernels"].get(name, {}).get("ms", 0.0)
               for name in names)


def _idle_share(profile: dict, breakdown: dict) -> float | None:
    """The device's idle share of a train step's wall time, None where
    the profiler recorded no device time."""
    busy = _ratio(profile["device_busy_ms"], breakdown["step_wall_ms"])
    return None if busy is None else 1.0 - busy


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


def phase_train(impl: str, dtype: str = "float32") -> dict:
    """``fit`` on the card against the CPU on one lane; at bf16 the
    lane's bf16 instances (phase 28)."""
    bf16 = dtype == "bfloat16"
    cfg = FlowGNNConfig(message_impl=impl, dtype=dtype)
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
    tol = BF16_GNN_TOL if bf16 else TRAIN_LOSS_TOL
    if not np.all(np.isfinite(losses)) or diffs.max() > tol:
        raise AssertionError(f"{impl} ({dtype}): per-step loss |card - cpu| "
                             f"{diffs.max():.3e} > {tol}: card "
                             f"{losses} against cpu {cpu_losses}")
    val_diff = abs(history["epochs"][-1]["val_loss"]
                   - cpu_history["epochs"][-1]["val_loss"])
    steps = len(losses)
    sfx = "_bf16" if bf16 else ""
    val_batches = sum(1 for _ in loop._batches(
        examples, splits["val"], data_cfg, list(model.subkeys),
        data_cfg.eval_batch_size, build_band_adj=cfg.uses_band_adj,
        build_tile_adj=cfg.uses_tile_adj))
    # At bf16 no f32 GNN or tile kernel launches: the bf16 instances
    # replace them.
    exact = ({k: 0 for k in (*fused_gnn.KERNELS, *tile_spmm.KERNELS)
              if not k.endswith("_bf16")} if bf16
             else {"tile_spmm_kernel": 0})
    if impl == "persistent":
        need = tuple(name + sfx for name in (
            "persistent_fwd_kernel", "persistent_fwd_hist_kernel",
            "persistent_bwd_kernel", "step_weight_grad_kernel"))
        if model.over_gate_dispatches == 0:
            exact[f"persistent_bwd_kernel{sfx}"] = steps
            if bf16:
                # One forward launch a train step and an evaluation
                # batch; each step's VJP one hist sweep, one reverse
                # sweep and one weight pass over the K steps.
                exact.update({
                    "persistent_fwd_kernel_bf16": steps + val_batches,
                    "persistent_fwd_hist_kernel_bf16": steps,
                    "step_weight_grad_kernel_bf16": steps})
    elif impl == "fused":
        need = (f"fused_step_kernel{sfx}", f"fused_step_bwd_kernel{sfx}",
                f"step_weight_grad_kernel{sfx}")
        exact[f"fused_step_bwd_kernel{sfx}"] = cfg.n_steps * steps
        if bf16:
            # n_steps forward launches a train step and an evaluation
            # batch; each step's VJP one backward and one weight pass.
            exact.update({
                "fused_step_kernel_bf16": cfg.n_steps * (steps
                                                         + val_batches),
                "step_weight_grad_kernel_bf16": cfg.n_steps * steps})
    elif impl == "tile":
        # Each train step: n_steps forward launches and n_steps backward
        # ones (over A^T); each evaluation batch: n_steps forward.
        need = (f"tile_spmm_kernel{sfx}",)
        exact = {**dict.fromkeys(fused_gnn.KERNELS, 0),
                 **dict.fromkeys(tile_spmm.KERNELS, 0),
                 f"tile_spmm_kernel{sfx}":
                 2 * cfg.n_steps * steps + cfg.n_steps * val_batches}
    else:  # band: plain torch on the card, no kernel of the port
        need = ()
        exact = dict.fromkeys((*fused_gnn.KERNELS, *tile_spmm.KERNELS), 0)
    if any(launches[k] == 0 for k in need) or any(
            launches[k] != v for k, v in exact.items()):
        raise AssertionError(f"{impl} ({dtype}) train lane: launches "
                             f"{launches} over {steps} steps")

    batch = _training_batch(model)
    breakdown = _gnn_step_breakdown(model, batch)
    n_graphs = int(batch.graph_mask.sum())
    step_ms = (breakdown["forward_ms"] + breakdown["backward_ms"]
               + breakdown["optimizer_ms"])
    rec = dict(phase="train_bf16" if bf16 else "train", message_impl=impl,
               dtype=dtype, steps=steps,
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


def _check_bf16_bwd(name, got, want, rtol=GNN_BF16_BWD_RTOL,
                    scale=GNN_BF16_BWD_SCALE) -> dict:
    """A bf16 backward output against its plain version: within ``rtol``
    of the element plus ``scale`` of the tensor's largest entry (one bf16
    step plus half a step, ``GNN_BF16_BWD_*``; a K-step sweep's
    ``GNN_BF16_SWEEP_TOL``); the largest difference and the elements
    apart."""
    torch.cuda.synchronize()
    g, w = got.float(), want.float()
    if got.dtype != want.dtype or g.shape != w.shape or not bool(
            torch.isfinite(g).all()):
        raise AssertionError(f"{name}: {got.dtype} {tuple(g.shape)} vs "
                             f"{want.dtype} {tuple(w.shape)}, or non-finite")
    err = (g - w).abs()
    limit = rtol * w.abs() + scale * float(w.abs().max())
    if bool((err > limit).any()):
        raise AssertionError(f"{name}: max |diff| {err.max().item():.3e} "
                             f"over {rtol} of the element plus {scale} "
                             "of the tensor's scale")
    return dict(max_abs_err=float(err.max()), **_bf16_diff(got, want))


def _bf16_record(name, adj, hidden, steps, kernel, plain, f32, cost, iters,
                 reps, **extra) -> dict:
    """Times (kernel, plain version, f32 kernel on the inputs widened),
    the launches the timing counted and the bound of one bf16 call."""
    before = launch_counts()[name]
    kernel_ms = _time_ms(kernel, iters, reps)
    launches = launch_counts()[name] - before
    bound_ms, bound_by = _bound(cost)
    return dict(kernel=name, shape="training", hidden=hidden,
                bandwidth=getattr(adj, "bandwidth", None), steps=steps,
                kernel_ms=kernel_ms, plain_ms=_time_ms(plain, iters, reps),
                f32_kernel_ms=_time_ms(f32, iters, reps),
                bound_us=bound_ms * 1e3, bound_by=bound_by, **_peak(cost),
                flops=cost["flops"], flops_bf16=cost.get("flops_bf16"),
                bytes=cost["bytes"], nnz=cost["nnz"],
                timing_launches=launches, **extra)


def _persistent_bwd_bf16(adj, vals, h, h32, g, p32, states, k) -> dict:
    """The persistent lane's bf16 backward sweeps at the training shape
    (phase 27): ``persistent_fwd_hist_kernel_bf16`` and
    ``persistent_bwd_kernel_bf16`` against their plain versions, bit for
    bit the scans of ``fused_step_kernel_bf16`` (``states``: h_0 and the
    scan's states) and ``fused_step_bwd_kernel_bf16``, twice for their
    bits; with bf16 band values timed beside their scans, bounds, plain
    versions and the f32 kernels on the inputs widened. Returns the
    records by kernel at bf16 band values."""
    hidden = h.shape[1]
    out = {}
    if not fused_gnn.persistent_bwd_smem_ok(adj, hidden, torch.bfloat16):
        raise AssertionError("training batch over the bf16 backward gate")
    none = ["none: no PyTorch call computes a GRU gated graph step or its "
            "VJP"]
    # The hist sweep: h_1..h_{K-1}.
    name = "persistent_fwd_hist_kernel_bf16"
    sweep = lambda: fused_gnn.persistent_hist(None, h, adj, k, p32)
    plain = lambda: fused_gnn.persistent_hist_reference(None, h, adj, k, p32)
    hist = sweep()
    sweep_tol = (GNN_BF16_SWEEP_TOL, GNN_BF16_SWEEP_TOL)
    rec = dict(kernel=name, band_vals=vals, n_rows=h.shape[0],
               **_check_bf16_bwd(f"{name}@{vals}", hist, plain(),
                                 *sweep_tol))
    _same_bits(f"{name}@{vals} twice", [sweep()], [hist])

    def hist_scan():
        states = [h]
        for _ in range(k - 1):
            states.append(fused_gnn.fused_gate_step(None, states[-1], adj,
                                                    packed=p32))
        return states[1:]

    _same_bits(f"{name}@{vals} vs the phase's states", list(hist),
               states[1:])
    rec.update(bits_repeat=True, scan_bits_equal=True, **_scan_record(
        f"{name}@{vals}", lambda: list(sweep()), hist_scan, adj, hidden,
        which=name, iters=10, reps=3))
    if vals == "bf16":
        rec.update(_bf16_record(
            name, adj, hidden, k, sweep, plain,
            lambda: fused_gnn.persistent_hist(None, h32, adj, k, p32),
            fused_gnn.kernel_cost(adj, hidden, k, name), 10, 3,
            library_ms=None, library_covers=none))
        out[name] = rec
    emit(phase="train_kernels_bf16", **rec)
    # The reverse sweep over that hist: dh_0 and each step's x, dp, dmsg.
    name = "persistent_bwd_kernel_bf16"
    sweep = lambda: fused_gnn.persistent_bwd_rows(None, h, hist, adj, g, k,
                                                  p32)
    plain = lambda: fused_gnn.persistent_bwd_rows_reference(
        None, h, hist, adj, g, k, p32)
    rows = sweep()
    outputs = {key: _check_bf16_bwd(f"{name}[{key}]@{vals}", a, b,
                                    *sweep_tol)
               for key, a, b in zip(("dh", "x", "dp", "dmsg"), rows,
                                    plain())}
    _same_bits(f"{name}@{vals} twice", sweep(), rows)

    def bwd_scan():
        gs, scan = g, [None] * k
        for s in reversed(range(k)):
            gs, *scan[s] = fused_gnn.fused_step_bwd_rows(None, states[s],
                                                         adj, gs, p32)
        return [gs] + [c[j] for j in range(3) for c in scan]

    def bwd_kernel():
        dh, *per_step = sweep()
        return [dh] + [t for c in per_step for t in c.unbind(0)]

    rec = dict(kernel=name, band_vals=vals, n_rows=h.shape[0],
               max_abs_err=max(o["max_abs_err"] for o in outputs.values()),
               elements_differing=sum(o["elements_differing"]
                                      for o in outputs.values()),
               outputs=outputs, bits_repeat=True, scan_bits_equal=True,
               **_scan_record(f"{name}@{vals}", bwd_kernel, bwd_scan, adj,
                              hidden, which=name, iters=5, reps=3))
    if vals == "bf16":
        rec.update(_bf16_record(
            name, adj, hidden, k, sweep, plain,
            lambda: fused_gnn.persistent_bwd_rows(
                None, h32, hist.float(), adj, g.float(), k, p32),
            fused_gnn.kernel_cost(adj, hidden, k, name), 5, 3,
            library_ms=None, library_covers=none))
        out[name] = rec
    emit(phase="train_kernels_bf16", **rec)
    return out


def phase_train_kernels_bf16(model: FlowGNN) -> dict:
    """Phase 27: the bf16 backward instances and the bf16 tile product at
    the training shape against their plain versions, their bits twice,
    the weight pass's K steps bit for bit the fold of one-step calls, the
    persistent sweeps bit for bit the per-step scans, each timed beside
    its bound, plain version, f32 kernel and library call; returns the
    numbers by kernel (bf16 band values)."""
    cfg = model.config
    k_steps, hidden = cfg.n_steps, cfg.ggnn_hidden
    out = {}
    with torch.no_grad():
        batch = _training_batch(model)
        params = model.ggnn_step.step_params()
        p32 = [w.detach().contiguous()
               for w in fused_gnn.packed_weights(params)]
        h32 = torch.cat([model.embeds[k](batch.node_feats[k])
                         for k in model.subkeys], dim=-1).contiguous()
        h = h32.bfloat16()
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        g = torch.randn(h.shape, generator=gen, device="cuda").bfloat16()
        for vals in ("bf16", "f32"):
            adj = batch.band_adj
            if vals == "f32":
                adj = dataclasses.replace(adj, vals=adj.vals.float())
            mdt = fused_gnn.msg_dtype(adj, torch.bfloat16)
            # fused_step_bwd_kernel_bf16: one step's cotangents.
            name = "fused_step_bwd_kernel_bf16"
            rows = lambda: fused_gnn.fused_step_bwd_rows(None, h, adj, g,
                                                         p32)
            plain = lambda: fused_gnn.fused_step_bwd_rows_reference(
                None, h, adj, g, p32)
            got = rows()
            outputs = {key: _check_bf16_bwd(f"{name}[{key}]@{vals}", a, b)
                       for key, a, b in zip(("dh", "x", "dp", "dmsg"), got,
                                            plain())}
            _same_bits(f"{name}@{vals} twice", rows(), got)
            rec = dict(kernel=name, band_vals=vals, n_rows=h.shape[0],
                       max_abs_err=max(o["max_abs_err"]
                                       for o in outputs.values()),
                       elements_differing=sum(o["elements_differing"]
                                              for o in outputs.values()),
                       outputs=outputs, bits_repeat=True,
                       **_step_geometry(adj, hidden, name))
            if vals == "bf16":
                rec.update(_bf16_record(
                    name, adj, hidden, 1, rows, plain,
                    lambda: fused_gnn.fused_step_bwd_rows(
                        None, h32, adj, g.float(), p32),
                    fused_gnn.kernel_cost(adj, hidden, 1, name), 10, 3,
                    library_ms=None,
                    library_covers=["none: no PyTorch call computes a GRU "
                                    "gated graph step's VJP"]))
                out[name] = rec
            emit(phase="train_kernels_bf16", **rec)
            # step_weight_grad_kernel_bf16 over K steps: the inputs of the
            # fused lane's scan (hist from the bf16 forward instance, each
            # step's cotangents from the backward instance).
            name = "step_weight_grad_kernel_bf16"
            states = [h]
            for _ in range(k_steps - 1):
                states.append(fused_gnn.fused_gate_step(None, states[-1], adj,
                                                        packed=p32))
            hist = torch.stack(states[1:]).contiguous()
            per_step, gs = [None] * k_steps, g
            for s in reversed(range(k_steps)):
                gs, *per_step[s] = fused_gnn.fused_step_bwd_rows(
                    None, states[s], adj, gs, p32)
            x, dp, dmsg = (torch.stack([c[j] for c in per_step]).contiguous()
                           for j in range(3))
            wgrads = lambda: fused_gnn.step_weight_grads(h, hist, x, dp, dmsg,
                                                         k_steps, mdt)
            wplain = lambda: fused_gnn.step_weight_grad_reference(
                h, hist, x, dp, dmsg, k_steps, mdt)
            grads = wgrads()
            err, rel = _check_grads(f"{name}@{vals}", grads, wplain())
            fold = None
            for s in reversed(range(k_steps)):
                one = fused_gnn.step_weight_grads(
                    states[s].contiguous(), None, x[s:s + 1], dp[s:s + 1],
                    dmsg[s:s + 1], 1, mdt)
                fold = one if fold is None else tuple(
                    a + b for a, b in zip(fold, one))
            _same_bits(f"{name}@{vals} vs the fold of one-step calls", grads,
                       fold)
            _same_bits(f"{name}@{vals} twice", wgrads(), grads)
            # The instance this launch runs, held to the host's mirror.
            geo = fused_gnn.wgrad_bf16_geometry(mdt == torch.bfloat16)
            smem = fused_gnn.wgrad_bf16_smem_bytes(mdt == torch.bfloat16)
            if geo["smem_bytes"] != smem or geo["blocks_per_sm"] < 1:
                raise AssertionError(f"{name}@{vals}: geometry {geo}, the "
                                     f"mirror's shared memory {smem}")
            rows_per_split = fused_gnn.wgrad_bf16_rows_per_split(
                h.shape[0], hidden)
            rec = dict(kernel=name, band_vals=vals, n_rows=h.shape[0],
                       max_abs_err=err, max_rel_err=rel, tol=dict(
                           rel=GRAD_TOL), fold_bits_equal=True,
                       bits_repeat=True, **geo,
                       rows_per_split=rows_per_split,
                       splits=-(-h.shape[0] // rows_per_split))
            if vals == "bf16":
                # The fused lane's call: one step's sums (five a train
                # step), timed beside the K-step call.
                s0 = states[0].contiguous()
                rec["one_step_ms"] = _time_ms(
                    lambda: fused_gnn.step_weight_grads(
                        s0, None, x[:1], dp[:1], dmsg[:1], 1, mdt), 10, 3)
                # The yardstick: the three products as torch.mm at bf16
                # (cuBLAS, bf16 out) over every step's rows stacked
                # [K N, .], dpre rounded as the kernel rounds it, and the
                # bias sums.
                hs_all = torch.cat([h[None], hist]).reshape(-1, hidden)
                x_all = x.reshape(-1, hidden)
                dm_all = dmsg.reshape(-1, hidden).bfloat16()
                dp_all = dp.reshape(-1, 4 * hidden)
                dpi = dp_all[:, :3 * hidden].bfloat16()
                dph = torch.cat([dp_all[:, :2 * hidden],
                                 dp_all[:, 3 * hidden:]], 1).bfloat16()

                def library():
                    return (torch.mm(hs_all.T, dm_all), dm_all.sum(0),
                            torch.mm(x_all.T, dpi), dpi.sum(0),
                            torch.mm(hs_all.T, dph), dph.sum(0))

                lib = library()
                lib_rel = max(float((a.float().reshape(b.shape) - b).abs()
                                    .max() / b.abs().max())
                              for a, b in zip(lib, grads))
                rec.update(_bf16_record(
                    name, adj, hidden, k_steps, wgrads, wplain,
                    lambda: fused_gnn.step_weight_grads(
                        h32, hist.float(), x.float(), dp, dmsg, k_steps),
                    fused_gnn.kernel_cost(adj, hidden, k_steps, name), 5, 3,
                    library_ms=_time_ms(library, 5, 3),
                    library_covers=["dW_e, dW_i, dW_h as torch.mm at bf16 "
                                    "(bf16 out) over the K steps' stacked "
                                    "rows", "the bias sums"],
                    library_max_rel_diff=lib_rel))
                out[name] = rec
            emit(phase="train_kernels_bf16", **rec)
            out.update(_persistent_bwd_bf16(adj, vals, h, h32, g, p32,
                                            states, k_steps))
        # tile_spmm_kernel_bf16 over A and A^T, the tile lane's batch.
        name = "tile_spmm_kernel_bf16"
        tmodel = FlowGNN(FlowGNNConfig(message_impl="tile"), device="cpu")
        lists = _training_batch(tmodel, device="cpu").tile_adj.to("cuda")
        msg = torch.randn(h.shape, generator=gen, device="cuda").bfloat16()
        recs = {}
        cpu_lists, msg_cpu = lists.to("cpu"), msg.cpu()
        for direction, a, a_cpu in (
                ("A", lists, cpu_lists),
                ("A^T", lists.transposed(), cpu_lists.transposed())):
            run = lambda: tile_spmm.tile_spmm(a, msg)
            got = run()
            diff = _check_bf16_bwd(f"{name}@{direction}", got,
                                   tile_spmm.tile_spmm_reference(a, msg))
            _same_bits(f"{name}@{direction} twice", [run()], [got])
            # Its plain version sums each row in list order on the CPU
            # (on the card index_add_ adds with atomics): bit for bit.
            _same_bits(f"{name}@{direction} vs its plain version",
                       [got.cpu()],
                       [tile_spmm.tile_spmm_reference(a_cpu, msg_cpu)])
            n = a.n_rows
            try:
                csr = torch.sparse_csr_tensor(a.ptr.long(), a.src.long(),
                                              a.val.bfloat16(), (n, n))
                torch.sparse.mm(csr, msg)
                library = dict(library_ms=_time_ms(
                    lambda: torch.sparse.mm(csr, msg)),
                    library_covers=["agg = A @ msg, bf16 CSR x bf16"])
            except (RuntimeError, NotImplementedError) as exc:
                library = dict(library_ms=None, library_covers=[
                    f"none: torch.sparse.mm refuses a bf16 CSR matrix "
                    f"here ({str(exc).splitlines()[0][:120]})"])
            recs[direction] = dict(
                over=direction, n_rows=n, bits_repeat=True,
                plain_bits_equal=True, **diff,
                **_bf16_record(
                    name, a, hidden, 1, run,
                    lambda: tile_spmm.tile_spmm_reference(a, msg),
                    lambda: tile_spmm.tile_spmm(a, msg.float()),
                    tile_spmm.kernel_cost(lists, hidden,
                                          transposed=direction == "A^T",
                                          dtype=torch.bfloat16), 20, 5,
                    **library))
            emit(phase="train_kernels_bf16", **recs[direction])
        out[name] = dict(recs["A"], transpose_ms=recs["A^T"]["kernel_ms"])
    return out


def phase_train_bf16(f32: dict) -> dict:
    """Phase 28: ``fit`` at bf16 on the persistent (the CLI's default),
    fused, tile and band lanes (``phase_train`` at bf16), each step's
    device ms beside the f32 lane's (``f32``: lane -> phases 8-10's
    ``device_busy_ms`` and ``graphs_per_s``); the persistent lane with
    no batch over its gate. Returns the lanes' launches summed."""
    launches = {k: 0 for k in REPLACES}
    lanes = {}
    for impl in ("persistent", "fused", "tile", "band"):
        rec = phase_train(impl, "bfloat16")
        if impl == "persistent" and rec["over_gate_dispatches"]:
            raise AssertionError(f"persistent lane at bf16: "
                                 f"{rec['over_gate_dispatches']} passes "
                                 "over the gate")
        for k in launches:
            launches[k] += rec["launches"][k]
        base = f32.get(impl, {})
        lanes[impl] = dict(
            device_busy_ms=rec["step_profile"]["device_busy_ms"],
            graphs_per_s=rec["graphs_per_s"],
            max_abs_loss_diff_vs_cpu=rec["max_abs_loss_diff_vs_cpu"],
            f32_device_busy_ms=base.get("device_busy_ms"),
            f32_graphs_per_s=base.get("graphs_per_s"))
    emit(phase="train_bf16_summary", lanes=lanes)
    return dict(launches=launches, lanes=lanes)


#: Phases run in a process of their own (``_phase_in_child``).
CHILD_PHASES = {"train_bf16": phase_train_bf16,
                "serve_graphs": lambda arg: phase_serve_graphs(arg)}


def _phase_in_child(name: str, arg: dict) -> dict:
    """Run phase ``name`` in a fresh process of this script and return
    its result (the child's last line). Its torch.profiler sessions then
    run after a short history: late in this script's run the profiler
    has recorded no device time at all in short windows, three sessions
    running. The child's records go to this process's output."""
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--phase", name,
         json.dumps(arg)], capture_output=True, text=True, timeout=900)
    sys.stderr.write(proc.stderr)
    lines = proc.stdout.splitlines()
    for line in lines[:-1]:
        print(line, flush=True)
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"phase {name} exited {proc.returncode} in its "
                             f"own process")
    return json.loads(lines[-1])


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


def _bf16_ulps_apart(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise distance of two bf16 tensors in bf16 steps (the bit
    patterns in order; +0 and -0 one value)."""
    def ordered(x):
        i = x.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)

    return (ordered(a) - ordered(b)).abs()


def _pair_apart(name: str, got, want) -> dict:
    """A bf16 flash kernel's outputs ``got`` against ``want``, the f32
    kernel's on the widened inputs rounded once: raises where an element
    is more than one bf16 step and more than ATTN_BF16_PAIR_ATOL apart;
    returns the elements apart and the largest gap in steps."""
    torch.cuda.synchronize()
    apart, worst = 0, 0
    for i, (a, w) in enumerate(zip(got, want)):
        ulps = _bf16_ulps_apart(a, w)
        gap = (a.float() - w.float()).abs()
        bad = (ulps > 1) & (gap > ATTN_BF16_PAIR_ATOL)
        if bool(bad.any()):
            raise AssertionError(
                f"{name}[{i}]: {int(bad.sum())} elements over one bf16 step "
                f"and {ATTN_BF16_PAIR_ATOL} from the f32 kernel rounded "
                f"(max {int(ulps.max())} steps, |diff| "
                f"{float(gap.max()):.3e})")
        apart += int((ulps > 0).sum())
        worst = max(worst, int(ulps.max()))
    return dict(bits_equal_f32_kernel_rounded=apart == 0,
                elements_apart_f32_kernel_rounded=apart,
                max_ulps_apart=worst, within_ulp_or_atol=True)


def _f64_errors(fused: bool) -> dict:
    """The bf16 kernels and the f32 ones on the widened inputs (rounded
    once) against a float64 evaluation of the reference's formulas (o by
    the softmax; the backward's P from the bf16 forward's lse, dS = P (dO
    V^T - delta)), one (batch, head) at a time: the mean absolute error of
    each output. ``fused``: the forward's o and the fused backward's dq,
    dk and dv at ATTN_FUSED_F64_SHAPE; else the two-pass pair's dq, dk and
    dv at ATTN_PAIR_F64_SHAPE. Raises where a bf16 kernel's passes
    ATTN_BF16_PAIR_F64_RATIO times the f32 kernel's."""
    shape, lengths = ((ATTN_FUSED_F64_SHAPE, ATTN_FUSED_F64_LENGTHS)
                      if fused else
                      (ATTN_PAIR_F64_SHAPE, ATTN_PAIR_F64_LENGTHS))
    b, t, h, d = shape
    q, k, v, _, g = _attn_inputs(shape, SEED)
    q, k, v, g = (x.bfloat16() for x in (q, k, v, g))
    mask = torch.arange(t, device="cuda")[None, :] < torch.tensor(
        lengths, device="cuda")[:, None]
    o, lse = attention.flash_fwd(q, k, v, mask)
    args = (q, k, v, mask, g, lse, attention.flash_delta(o, g))
    wide = _wide(args)
    if fused:
        names = ("o", "dq", "dk", "dv")
        outs = {"bf16": (o, *attention.flash_bwd_fused(*args)),
                "f32_rounded": tuple(x.bfloat16() for x in (
                    attention.flash_fwd(*wide[:4])[0],
                    *attention.flash_bwd_fused(*wide)))}
    else:
        names = ("dq", "dk", "dv")
        outs = {"bf16": (attention.flash_bwd_dq(*args),
                         *attention.flash_bwd_dkv(*args)),
                "f32_rounded": tuple(x.bfloat16() for x in (
                    attention.flash_bwd_dq(*wide),
                    *attention.flash_bwd_dkv(*wide)))}
    sums = {which: [0.0] * len(names) for which in outs}
    scale = 1.0 / d ** 0.5
    for bi in range(b):
        for hi in range(h):
            qd, kd, vd, gd = (x[bi, :, hi].double() for x in (q, k, v, g))
            s = (qd * scale) @ kd.T
            p = torch.where(mask[bi][None, :], torch.exp(
                s - lse[bi, hi].double()[:, None]), 0.0)
            ds = p * (gd @ vd.T - args[6][bi, hi].double()[:, None])
            ref = (scale * ds @ kd, scale * ds.T @ qd, p.T @ gd)
            if fused:
                w = torch.softmax(torch.where(mask[bi][None, :], s,
                                              -torch.inf), -1)
                ref = (torch.nan_to_num(w) @ vd, *ref)
            for which, got in outs.items():
                for i, (x, r) in enumerate(zip(got, ref)):
                    sums[which][i] += float(
                        (x[bi, :, hi].double() - r).abs().sum())
            del s, p, ds, ref
    n = b * t * h * d
    rec = {f"{name}_mean_abs_err_f64": {which: sums[which][i] / n
                                         for which in outs}
           for i, name in enumerate(names)}
    for name, errs in rec.items():
        if errs["bf16"] > ATTN_BF16_PAIR_F64_RATIO * errs["f32_rounded"]:
            raise AssertionError(
                f"bf16 {'fused' if fused else 'pair'} {name}: "
                f"{errs['bf16']:.4e} > {ATTN_BF16_PAIR_F64_RATIO} x the f32 "
                f"kernel's {errs['f32_rounded']:.4e}")
    return dict(f64_shape=list(shape), f64_lengths=list(lengths), **rec)


def phase_attention_kernels(dtype: torch.dtype = torch.float32) -> dict:
    """Each flash kernel's ``dtype`` instance against its plain version
    at the text training shape and the long shape, timed beside its bound
    and SDPA (at the same dtype). A bf16 instance is also held to the f32
    kernel on the widened inputs, rounded once to bf16: within a bf16 step
    element by element (lse within ATTN_FWD_TOL), and no further than it
    from a float64 evaluation (``_pair_apart``, ``_f64_errors``). Returns the
    numbers at the main-path shapes by kernel instance: the forward and
    the fused backward at T 512, the two-pass pair at T 4096."""
    bf16 = dtype == torch.bfloat16
    sfx = "_bf16" if bf16 else ""
    fwd_tol = ATTN_BF16_FWD_TOL if bf16 else ATTN_FWD_TOL
    grad_tol = ATTN_BF16_GRAD_TOL if bf16 else ATTN_GRAD_TOL
    pair = ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")

    def check(name, got, want, tol):
        return _check(name + sfx, got.float(), want.float(), tol)

    def identity(name, got, fn, args) -> dict:
        """bf16: ``got`` against the f32 kernel's output on the widened
        inputs, rounded once: within a bf16 step (the forward's lse, f32,
        within ATTN_FWD_TOL). Returns the record's fields."""
        if not bf16:
            return {}
        want = fn(*_wide(args))
        want = [want] if torch.is_tensor(want) else list(want)
        got = [got] if torch.is_tensor(got) else list(got)
        if name == "flash_fwd_kernel":
            _check(f"{name}_bf16 lse vs {name}", got[1], want[1],
                   ATTN_FWD_TOL)
            got, want = got[:1], want[:1]
        return _pair_apart(name + sfx, got, [w.bfloat16() for w in want])

    f64 = {}
    if bf16:
        for fused in (False, True):
            rec = _f64_errors(fused)
            emit(phase="attention_kernels_bf16_f64",
                 kernels="forward, fused backward" if fused
                 else "two-pass pair", **rec)
            for name in (("flash_fwd_kernel", "flash_bwd_fused_kernel")
                         if fused else pair):
                f64[name] = rec
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
        ident = {"flash_fwd_kernel": identity(
            "flash_fwd_kernel", (o, lse), attention.flash_fwd,
            (q, k, v, mask))}
        delta = attention.flash_delta(o_ref, g)
        args = (q, k, v, mask, g, lse_ref, delta)
        runs = {"flash_fwd_kernel": (
            err, lambda: attention.flash_fwd(q, k, v, mask),
            lambda: attention.flash_fwd_reference(q, k, v, mask), lib_fwd,
            ["o"])}
        dq = attention.flash_bwd_dq(*args)
        dk, dv = attention.flash_bwd_dkv(*args)
        ident["flash_bwd_dq_kernel"] = identity(
            "flash_bwd_dq_kernel", dq, attention.flash_bwd_dq, args)
        ident["flash_bwd_dkv_kernel"] = identity(
            "flash_bwd_dkv_kernel", (dk, dv), attention.flash_bwd_dkv, args)
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
            ident["flash_bwd_fused_kernel"] = identity(
                "flash_bwd_fused_kernel", fused, attention.flash_bwd_fused,
                args)
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
            recs[name].update(ident[base])
            if base in f64 and shape_name == ("long" if base in pair
                                              else "train"):
                recs[name].update(f64[base])
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
        pair_ms = sum(recs[name + sfx]["kernel_ms"] for name in pair)
        for name in pair:
            recs[name + sfx]["pair_ms"] = pair_ms
        for name, rec in recs.items():
            emit(phase="attention_kernels" + sfx, **rec)
            main_shape = ("long" if name.removesuffix(sfx) in pair
                          else "train")
            if shape_name == main_shape:
                out[name] = rec
        del q, k, v, g, o, o_ref, args, dq, dk, dv, lib_fwd, lib_bwd, runs, \
            recs
        torch.cuda.empty_cache()
    return out


def _text_setup(enc: EncoderConfig, n: int, batch: int, block: int,
                message_impl: str = "segment", graph_dtype: str = "float32"):
    """The model, data and fit_text arguments of ``cli fit-text
    --graphs synthetic [--set model.message_impl=...] [--set
    model.dtype=...]`` at these sizes (one epoch)."""
    graph_cfg = FlowGNNConfig(encoder_mode=True, label_style="graph",
                              message_impl=message_impl, dtype=graph_dtype)
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
    gnn = _sum_launches(
        _gnn_lane_launches(graph_cfg, data, splits["train"], tcfg, kw,
                           train=True, shuffle_seed=TEXT_SEED),
        _gnn_lane_launches(graph_cfg, data, splits["val"], tcfg, kw,
                           train=False))
    _require_launches("fit_text", launches, {
        **{k: v for k, v in gnn.items() if v},
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
    gnn = _sum_launches(
        _gnn_lane_launches(graph_cfg, data, splits["train"], tcfg, kw,
                           train=True, shuffle_seed=TEXT_SEED),
        _gnn_lane_launches(graph_cfg, data, splits["val"], tcfg, kw,
                           train=False))
    want = {**{k: v for k, v in gnn.items() if v},
            "flash_fwd_kernel": enc.num_layers * (3 + val_batches),
            "flash_bwd_fused_kernel": enc.num_layers * 3}
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


def phase_fit_text_bf16_graph() -> dict:
    """Phase 29: DeepDFA+LineVul as phase 13 (full width, 2 layers, batch
    4, dropout off; the text encoder f32) with the graph encoder at bf16
    on the persistent lane, ``fit-text --set model.dtype=bfloat16 --set
    model.message_impl=persistent``: 3 steps on the card and on the CPU
    from the same weights, losses within ``BF16_GNN_TOL``, the persistent
    lane's bf16 instances launched as the batches' gates say."""
    enc = dataclasses.replace(EncoderConfig(), attention_impl="auto",
                              num_layers=2, dropout_rate=0.0)
    graph_cfg, tcfg, data, splits, kw = _text_setup(
        enc, TEXT_N_VS_CPU, 4, 512, "persistent", "bfloat16")
    model = LineVul(enc, graph_cfg, device="cuda", seed=SEED)
    cpu_model = LineVul(enc, graph_cfg, device="cpu")
    cpu_model.load_state_dict({k: v.cpu()
                               for k, v in model.state_dict().items()})
    history, launches, _, wall_s = _fit_text_counted(model, data, splits,
                                                     tcfg, kw)
    losses = _text_steps(history)
    t0 = time.perf_counter()
    _, cpu_history = text_loop.fit_text(cpu_model, data, splits, tcfg, **kw)
    cpu_s = time.perf_counter() - t0
    cpu_losses = _text_steps(cpu_history)
    diffs = np.abs(np.asarray(losses) - np.asarray(cpu_losses))
    if len(losses) != 3 or len(cpu_losses) != 3 or diffs.max() > \
            BF16_GNN_TOL:
        raise AssertionError(f"fit_text, bf16 graph encoder: card {losses} "
                             f"against cpu {cpu_losses} (limit "
                             f"{BF16_GNN_TOL})")
    val_batches = -(-len(splits["val"]) // tcfg.eval_batch_size)
    gnn = _sum_launches(
        _gnn_lane_launches(graph_cfg, data, splits["train"], tcfg, kw,
                           train=True, shuffle_seed=TEXT_SEED),
        _gnn_lane_launches(graph_cfg, data, splits["val"], tcfg, kw,
                           train=False))
    _require_launches("fit_text, bf16 graph encoder", launches, {
        "flash_fwd_kernel": enc.num_layers * (3 + val_batches),
        "flash_bwd_fused_kernel": enc.num_layers * 3,
        **{k: v for k, v in gnn.items() if v}})
    for name in ("persistent_fwd_hist_kernel_bf16",
                 "persistent_bwd_kernel_bf16"):
        if launches[name] <= 0:
            raise AssertionError(f"fit_text, bf16 graph encoder: {name} "
                                 f"never ran ({launches})")
    rec = dict(phase="fit_text_bf16_graph", graph_dtype=graph_cfg.dtype,
               graph_message_impl=graph_cfg.message_impl,
               text_dtype=enc.dtype, layers=enc.num_layers,
               batch_size=tcfg.batch_size, losses=losses,
               cpu_losses=cpu_losses,
               max_abs_loss_diff_vs_cpu=float(diffs.max()),
               tol=BF16_GNN_TOL,
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
    gnn = _sum_launches(
        _gnn_lane_launches(graph_cfg, data, splits["train"], tcfg, kw,
                           train=True, shuffle_seed=TEXT_SEED),
        _gnn_lane_launches(graph_cfg, data, splits["val"], tcfg, kw,
                           train=False))
    _require_launches("fit_text at T 4096", launches, {
        **{k: v for k, v in gnn.items() if v},
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
    pair_ms = _pair_ms(profile, ("flash_bwd_dq_kernel",
                                 "flash_bwd_dkv_kernel"))
    rec = dict(phase="fit_text_long", layers=enc.num_layers, block_size=t,
               batch_size=b, steps=steps, losses=losses, launches=launches,
               two_pass_dispatches=two_pass, fit_wall_s=wall_s,
               step_s=wall_s / max(steps, 1), step_profile=profile,
               pair_ms_per_step=pair_ms,
               pair_share_of_device=_ratio(pair_ms,
                                           profile["device_busy_ms"]))
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
    history, launches, two_pass, wall_s = _fit_text_counted(
        model, data, splits, tcfg, kw)
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
                launches=launches, two_pass_dispatches=two_pass,
                fit_wall_s=wall_s, cpu_fit_s=cpu_s)


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
               device_idle_share=_idle_share(profile, breakdown),
               peak_mem_gb=step_peak / 1e9, vs_cpu=vs_cpu,
               launches=launches)
    emit(**rec)
    return rec


def phase_fit_text_long_bf16() -> dict:
    """fit_text at T 4096 (batch 8, 2 layers) at bf16: the backward's
    gate sends it to the bf16 two-pass pair; the step's profile and the
    pair's share of it; a 1-layer copy with dropout off against the CPU
    (``_vs_cpu_bf16``: 2 steps of 2, losses within BF16_TEXT_TOL)."""
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
    gnn = _sum_launches(
        _gnn_lane_launches(graph_cfg, data, splits["train"], tcfg, kw,
                           train=True, shuffle_seed=TEXT_SEED),
        _gnn_lane_launches(graph_cfg, data, splits["val"], tcfg, kw,
                           train=False))
    _require_launches("fit_text bf16 at T 4096", launches, {
        **{k: v for k, v in gnn.items() if v},
        **_flash_want(enc.num_layers, steps + val_batches, steps,
                      two_pass=True)})
    if two_pass != enc.num_layers * steps:
        raise AssertionError(f"{two_pass} two-pass dispatches")
    batch = next(text_loop.text_graph_batches(data, splits["train"],
                                              tcfg.batch_size, **kw))
    step = text_loop.make_text_train_step(
        model, text_loop.make_text_optimizer(model.parameters(), tcfg), tcfg,
        torch.Generator().manual_seed(TEXT_SEED))
    profile = _device_profile(lambda: step(batch, tcfg.learning_rate),
                              TEXT_PROFILE_STEPS)
    pair_ms = _pair_ms(profile, ("flash_bwd_dq_kernel_bf16",
                                 "flash_bwd_dkv_kernel_bf16"))
    del model, step
    torch.cuda.empty_cache()
    # A 1-layer copy with dropout off against the CPU on the same weights,
    # through the bf16 pair: 2 steps of 2 at T 4096.
    enc0 = dataclasses.replace(enc, dropout_rate=0.0, num_layers=1)
    graph0, tcfg0, data0, splits0, kw0 = _text_setup(
        enc0, TEXT_N_LONG_VS_CPU, 2, t)
    splits0 = dict(splits0, train=splits0["train"][:TEXT_LONG_VS_CPU_ROWS])
    vs_cpu = _vs_cpu_bf16(LineVul(enc0, graph0, device="cuda", seed=SEED),
                          LineVul(enc0, graph0, device="cpu"), data0,
                          splits0, tcfg0, kw0)
    if vs_cpu["two_pass_dispatches"] != enc0.num_layers * len(
            vs_cpu["losses"]):
        raise AssertionError(f"T 4096 against the CPU: "
                             f"{vs_cpu['two_pass_dispatches']} two-pass "
                             "dispatches")
    rec = dict(phase="fit_text_long_bf16", dtype=enc.dtype,
               layers=enc.num_layers, block_size=t, batch_size=b,
               steps=steps, losses=losses, launches=launches,
               two_pass_dispatches=two_pass, fit_wall_s=wall_s,
               step_s=wall_s / max(steps, 1), step_profile=profile,
               pair_ms_per_step=pair_ms,
               pair_share_of_device=_ratio(pair_ms,
                                           profile["device_busy_ms"]),
               vs_cpu=vs_cpu)
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
    # The f32 snapshot tested at bf16 (the f32 params load into the bf16
    # model): on the card through the bf16 instance, against the CPU.
    bf16 = ["--set", "model.dtype=bfloat16"]
    test_bf16, counts = _counted_cli(["test", *gnn, "--checkpoint-dir", full,
                                      *bf16])
    add(counts)
    test_bf16_cpu = _cli(["test", *gnn[:-1], "cpu", "--checkpoint-dir",
                          full, *bf16])
    test_bf16_diff = abs(test_bf16["loss"] - test_bf16_cpu["loss"])
    if (counts["persistent_fwd_kernel_bf16"] == 0
            or any(counts[k] for k in fused_gnn.KERNELS
                   if not k.endswith("_bf16"))
            or test_bf16_diff > BF16_GNN_TOL
            or abs(test_bf16["loss"] - test_card["loss"]) > BF16_GNN_TOL):
        raise AssertionError(f"test at bf16: loss {test_bf16['loss']} (cpu "
                             f"{test_bf16_cpu['loss']}, f32 "
                             f"{test_card['loss']}); launches {counts}")

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
        "fused_step_kernel": graph_cfg.n_steps * over_gate,
        # The frozen encoder's pooling: its per-graph sums, one launch a
        # batch.
        "segment_sum_kernel": batches})

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
               test_bf16={k: v for k, v in test_bf16.items()},
               test_bf16_loss_diff_vs_cpu=test_bf16_diff,
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
# The second server records its telemetry run (--run-dir, --slo smoke)
# and is drained by a SIGTERM in a load window of its own: LOAD_CLIENTS
# closed-loop clients over DRAIN_POSTS new functions, the signal after
# DRAIN_AFTER answers, and one client holding a half-sent POST open so
# the drain lasts until the probes (503 with Retry-After, /healthz
# "draining") have been answered.
DRAIN_POSTS = 512
DRAIN_AFTER = 64
DRAIN_WAIT_S = 60
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


def _start_server(extra, name: str, root: str) -> tuple:
    """``cli serve`` with the arguments ``extra`` on the card in its own
    process, on an ephemeral port: (process, base URL, its log path)."""
    port_file = os.path.join(root, f"port_{name}")
    log = os.path.join(root, f"serve_{name}.log")
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "deepdfa_tpu_torch.cli", "serve", *extra,
             "--device", "cuda", "--port", "0", "--port-file", port_file],
            cwd=here, env=env, stdout=f, stderr=subprocess.STDOUT)
    t0 = time.monotonic()
    while not os.path.exists(port_file):
        if proc.poll() is not None or time.monotonic() - t0 > HTTP_START_S:
            _stop_server(proc)
            with open(log) as f:
                raise AssertionError(f"cli serve ({name}) did not start: "
                                     f"{f.read()[-3000:]}")
        time.sleep(0.2)
    with open(port_file) as f:
        return proc, f"http://127.0.0.1:{int(f.read())}", log


def _stop_server(proc) -> int:
    """Ctrl-C, as a user stops it (the lifecycle's drain, exit 75);
    killed if it does not exit."""
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
    forward: the pair's graph replayed)."""
    engine, _, _ = cli._build_serve_engine(_serve_args(run, "persistent",
                                                       "cuda"))
    engine.warmup()
    graphs = synthetic_bigvul(16, FlowGNNConfig().feature, seed=SEED + 9)
    texts = attach_synthetic_text([dict(g) for g in graphs], seed=TEXT_SEED)
    reqs = []
    for i, (g, t) in enumerate(zip(graphs, texts)):
        norm = engine._normalize_graph(g)
        reqs.append(ServeRequest(
            rid=i, key="", graph=norm, lane="combined", arrival=0.0,
            deadline_s=0.1, input_ids=encode_function(
                t["code"], engine.tokenizer, engine.config.block_size)))
    out = {}
    for slots in engine.config.slot_buckets:
        gb = engine._pack("combined", [r.graph for r in reqs[:slots]],
                          slots)[0].to("cuda")
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


def _http_text(base: str, path: str, accept: str) -> tuple:
    """(status, Content-Type, body text) of a GET with ``accept``."""
    req = urllib.request.Request(f"{base}{path}", headers={"Accept": accept})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status, resp.headers["Content-Type"], \
            resp.read().decode()


def _prometheus(text: str) -> dict:
    """{series: value} of a Prometheus text exposition."""
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            out[name] = float(value)
    return out


def _run_events(run_dir: str) -> list:
    return telemetry_export.read_run_dir(run_dir)[0]


def _named(events, name: str) -> list:
    return [e for e in events if e.get("name") == name]


def _telemetry_scrape(base: str, run_dir: str) -> dict:
    """The server quiet: ``/metrics`` as Prometheus text and as JSON (the
    same batches), ``/healthz`` with ``slo`` and no telemetry drop, and
    the run's ``serve.flush`` spans on disk (the pump flushes its rings
    every pass), one a batch."""
    t0 = time.monotonic()
    while _http(base, "/metrics")[2]["queue_depth"]:
        if time.monotonic() - t0 > DRAIN_WAIT_S:
            raise AssertionError("the server never went quiet")
        time.sleep(0.05)
    status, ctype, text = _http_text(base, "/metrics", "text/plain")
    prom = _prometheus(text)
    _, _, js = _http(base, "/metrics")
    h_status, _, health = _http(base, "/healthz")
    batches = int(prom.get("deepdfa_serve_batches_total", -1))
    if (status != 200 or not ctype.startswith("text/plain")
            or batches != js["batches"] or "kernel_launches" not in js
            or "slo" not in health or health["telemetry_drops"] != 0
            or prom.get("deepdfa_serve_compiles_after_warmup") != 0.0):
        raise AssertionError(f"telemetry scrape: {status} {ctype}, "
                             f"Prometheus batches {batches} against "
                             f"{js.get('batches')}, /healthz {h_status} "
                             f"{health}")
    while True:
        spans = len(_named(_run_events(run_dir), "serve.flush"))
        if spans == batches:
            break
        if time.monotonic() - t0 > DRAIN_WAIT_S:
            raise AssertionError(f"{spans} serve.flush spans on disk, "
                                 f"{batches} batches")
        time.sleep(0.1)
    return dict(prometheus_series=sum(
        1 for line in text.splitlines() if line.startswith("# TYPE")),
        prometheus_bytes=len(text), batches=batches, flush_spans=spans,
        healthz_status=health["status"], slo=health["slo"],
        telemetry_drops=health["telemetry_drops"])


def _drain_window(base: str, proc, run_dir: str, log: str, graphs) -> dict:
    """SIGTERM in the middle of a load window: ``LOAD_CLIENTS`` closed-loop
    clients POST new one-function bodies; after ``DRAIN_AFTER`` answers
    the server gets SIGTERM while one client holds a half-sent POST open
    (its handler counts in flight, so the drain waits for it). Probes
    then see a new POST answered 503 with Retry-After and ``/healthz``
    "draining"; the held POST is finished (its answer: 429, the engine
    admits nothing new); the server exits 75. Every 200 carries
    probabilities, every client ends on a 503 with Retry-After or a
    closed connection, the trace answers every request it enqueued
    (``serve.enqueue`` rid against ``serve.request``), and its
    ``serve.flush`` spans equal the batches in the exit record."""
    url = urllib.parse.urlsplit(base)
    bodies = [json.dumps({"functions": [fn]}).encode()
              for fn in _functions(graphs)]
    held_body = bodies.pop()
    counts = {"ok": 0, "draining": 0, "closed": 0}
    faults = []
    lock = threading.Lock()
    cursor = iter(range(len(bodies)))

    def client():
        conn = http.client.HTTPConnection(url.hostname, url.port,
                                          timeout=120)
        try:
            while True:
                with lock:
                    i = next(cursor, None)
                if i is None:
                    return
                try:
                    conn.request("POST", "/score", body=bodies[i], headers={
                        "Content-Type": "application/json"})
                    resp = conn.getresponse()
                    doc = json.loads(resp.read())
                except (OSError, http.client.HTTPException):
                    with lock:  # the server closed after its drain
                        counts["closed"] += 1
                    return
                if resp.status == 200 and all(
                        "prob" in r for r in doc["results"]):
                    with lock:
                        counts["ok"] += 1
                    continue
                if (resp.status == 503 and doc.get("error") == "draining"
                        and int(resp.getheader("Retry-After", "0")) >= 1):
                    with lock:
                        counts["draining"] += 1
                    return
                with lock:
                    faults.append((resp.status, doc))
                return
        finally:
            conn.close()

    held = socket.create_connection((url.hostname, url.port), timeout=120)
    try:
        held.sendall((f"POST /score HTTP/1.1\r\nHost: {url.hostname}\r\n"
                      "Content-Type: application/json\r\nContent-Length: "
                      f"{len(held_body)}\r\n\r\n").encode()
                     + held_body[:len(held_body) // 2])
        clients = [threading.Thread(target=client)
                   for _ in range(LOAD_CLIENTS)]
        for c in clients:
            c.start()
        t0 = time.monotonic()
        while counts["ok"] < DRAIN_AFTER:
            if time.monotonic() - t0 > DRAIN_WAIT_S or faults:
                raise AssertionError(f"drain load: {counts}, {faults[:3]}")
            time.sleep(0.005)
        t_signal = time.monotonic()
        proc.send_signal(signal.SIGTERM)
        probe = probe_health = None
        while probe is None or probe_health is None:
            if time.monotonic() - t_signal > DRAIN_WAIT_S:
                raise AssertionError(f"no drain seen: {probe} "
                                     f"{probe_health}")
            status, headers, body = _http(base, "/score",
                                          {"functions": _functions(
                                              graphs[-1:])})
            if status == 503 and body.get("error") == "draining":
                probe = (status, int(headers["Retry-After"]), body)
            h_status, _, health = _http(base, "/healthz")
            if h_status == 503 and health["status"] == "draining":
                probe_health = health
            time.sleep(0.01)
        held.sendall(held_body[len(held_body) // 2:])
        held_answer = held.recv(65536).decode(errors="replace")
    finally:
        held.close()
    for c in clients:
        c.join(timeout=DRAIN_WAIT_S)
    rc = proc.wait(timeout=DRAIN_WAIT_S)
    exit_s = time.monotonic() - t_signal
    with open(log) as f:
        exit_rec = [json.loads(line) for line in f
                    if line.startswith('{"preempted"')]
    events = _run_events(run_dir)
    enqueued = {e["attrs"]["rid"] for e in _named(events, "serve.enqueue")}
    answered = {e["attrs"]["rid"] for e in _named(events, "serve.request")}
    dropped = sorted(enqueued - answered)
    drains = _named(events, "lifecycle.drain")
    notices = _named(events, "lifecycle.notice")
    tdir = os.path.join(run_dir, "telemetry")
    serving = exit_rec[-1]["serving"] if exit_rec else {}
    flush_spans = len(_named(events, "serve.flush"))
    if (rc != lifecycle.EXIT_PREEMPTED or faults
            or any(c.is_alive() for c in clients)
            or counts["draining"] + counts["closed"] != LOAD_CLIENTS
            or probe[1] < 1 or "slo" not in probe_health
            or probe_health["telemetry_drops"] != 0
            or not held_answer.startswith("HTTP/1.1 429")
            or dropped or not enqueued
            or [n["attrs"]["reason"] for n in notices] != ["SIGTERM"]
            or [(d["attrs"]["participant"], d["attrs"]["ok"])
                for d in drains] != [("serve", True)]
            or not exit_rec or serving["compiles_after_warmup"] != 0
            or flush_spans != serving["batches"]
            or not os.path.exists(os.path.join(tdir, "events.jsonl"))
            or not os.path.exists(os.path.join(tdir, "trace.json"))):
        raise AssertionError(
            f"SIGTERM drain: exit {rc}, clients {counts}, faults "
            f"{faults[:3]}, probe {probe}, /healthz {probe_health}, held "
            f"POST {held_answer[:80]!r}, {len(dropped)} enqueued rids "
            f"unanswered of {len(enqueued)}, notices {notices}, drains "
            f"{drains}, {flush_spans} serve.flush spans against the exit "
            f"record {exit_rec[-1:]}")
    return dict(exit_code=rc, exit_s=exit_s, answered_200=counts["ok"],
                answered_503=counts["draining"] + 1,
                closed_after_drain=counts["closed"],
                retry_after_s=probe[1], held_post=held_answer.split(
                    "\r\n", 1)[0], enqueued=len(enqueued),
                dropped=len(dropped),
                drain_ms=drains[0]["attrs"]["drain_ms"],
                final_batches=serving["batches"], final_flush_spans=flush_spans,
                trace_json_bytes=os.path.getsize(
                    os.path.join(tdir, "trace.json")))


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
    drain_graphs, _ = functions(DRAIN_POSTS + 1, SEED + 14)
    telemetry_rec = None
    for impl in ("persistent", "fused"):
        # The second server records its run and is drained by SIGTERM.
        run_dir = os.path.join(root, "run_fused") if impl == "fused" \
            else None
        extra = ["--run-dir", run_dir, "--slo", "smoke"] if run_dir else []
        t0 = time.perf_counter()
        proc, base, log = _start_server(
            ["--combined-checkpoint-dir", run, "--set",
             f"model.message_impl={impl}", *extra], impl, root)
        start_s = time.perf_counter() - t0
        try:
            _, _, m0 = _http(base, "/metrics")
            _, _, health = _http(base, "/healthz")
            if ("slo" not in health or health["telemetry_drops"] != 0
                    or not 0 < health.get("device_bytes_in_use", 0)
                    <= health.get("device_peak_bytes_in_use", 0)):
                raise AssertionError(f"{impl}: /healthz {health}")
            load = {"gnn": _load_http(base, "gnn", load_graphs)}
            _, _, m_gnn = _http(base, "/metrics")
            load["combined"] = _load_http(base, "combined", load_coded,
                                          load_codes)
            traffic = _check_http(base, graphs, coded, codes, fresh)
            _, _, m1 = _http(base, "/metrics")
            if run_dir:
                t1 = time.perf_counter()
                telemetry_rec = _telemetry_scrape(base, run_dir)
                telemetry_rec.update(_drain_window(base, proc, run_dir, log,
                                                   drain_graphs))
                telemetry_rec["seconds"] = time.perf_counter() - t1
        finally:
            rc = _stop_server(proc)
        if rc != lifecycle.EXIT_PREEMPTED:
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
        cpu_engine, _, _ = cli._build_serve_engine(_serve_args(run, impl,
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
               telemetry=telemetry_rec,
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
# The serving fleet
# ---------------------------------------------------------------------------

# The reference's fleet bench (bench.py's bench_serve_fleet): 640
# open-loop requests at 20,000 a second through 1 and 4 replicas, 8 slots,
# a 250 ms deadline, a 64-request queue, no cache, adaptive flush on.
FLEET_PARITY_REQUESTS = 200
FLEET_TRACE_REQUESTS = 640
FLEET_RPS = 20000.0
FLEET_REPLICAS = (1, 4)
FLEET_BENCH = dict(batch_slots=8, deadline_ms=250.0, queue_capacity=64,
                   cache_capacity=0, adaptive_flush=True)
# The live fleet: 512 one-function POSTs from 16 client threads over 2
# replicas, r1 taken out and brought back mid-traffic, then rolled.
FLEET_HTTP_REPLICAS = 2
FLEET_HTTP_CLIENTS = 16
FLEET_HTTP_POSTS = 512


def _fleet_parity(model: FlowGNN) -> dict:
    """200 bursty requests through a 2-replica fleet on the card and
    through one engine: the same bits, both replicas flushing, no
    compile after warmup, the persistent kernel launched."""
    config = ServeConfig(batch_slots=8, deadline_ms=100.0)
    graphs = [e.graph for e in bursty_trace(FLEET_PARITY_REQUESTS,
                                            model.config.feature, seed=1)]
    single = ServeEngine(model, config, device="cuda")
    single.warmup()
    t0 = time.perf_counter()
    want = [r["prob"] for r in single.score_sync(graphs)]
    single_s = time.perf_counter() - t0
    fleet = ServeFleet.build(model, config, n_replicas=2)
    fleet.warmup()
    reset_launch_counts()
    t0 = time.perf_counter()
    got = [r["prob"] for r in fleet.score_sync(graphs)]
    torch.cuda.synchronize()
    fleet_s = time.perf_counter() - t0
    launches = launch_counts()
    batches = [r.engine.stats.batches for r in fleet.replicas]
    apart = sum(a != b for a, b in zip(got, want))
    if (apart or len(got) != FLEET_PARITY_REQUESTS
            or fleet.compiles_after_warmup != 0
            or any(r.engine.compiles_after_warmup != 0
                   for r in fleet.replicas)
            or not all(batches) or launches["persistent_fwd_kernel"] == 0
            or any(r.engine.model is not model for r in fleet.replicas)):
        raise AssertionError(
            f"fleet parity: {apart} probabilities apart from one engine, "
            f"batches {batches}, compiles after warmup "
            f"{fleet.compiles_after_warmup}, launches {launches}")
    return dict(requests=len(got), probs_apart=apart,
                replica_batches=batches,
                replica_devices=[str(r.engine.device)
                                 for r in fleet.replicas],
                cache_hits=fleet.snapshot()["cache_hits"],
                single_engine_s=single_s, fleet_s=fleet_s,
                launches=launches)


def _fleet_bench(model: FlowGNN) -> tuple:
    """The reference's fleet bench on the card: the same open-loop trace
    replayed through 1 and 4 replicas. Every replica's flushes are
    measured on the one card; the replay credits each to its own
    timeline, so the 4-replica rate models four cards."""
    config = ServeConfig(**FLEET_BENCH)
    trace = open_loop_trace(FLEET_TRACE_REQUESTS, model.config.feature,
                            seed=0, rps=FLEET_RPS, duplicate_fraction=0.0)
    primer = synthetic_bigvul(sum(config.slot_buckets),
                              model.config.feature, positive_fraction=0.5,
                              seed=1)
    runs, launches = {}, {}
    for n in FLEET_REPLICAS:
        clock = VirtualClock()
        timelines = [ReplicaTimeline(clock) for _ in range(n)]
        fleet = ServeFleet.build(model, config, n_replicas=n,
                                 clock_factory=lambda i: timelines[i])
        fleet.warmup()
        fleet.prime(primer)
        primed = fleet.snapshot()["batches"]
        over0 = model.over_gate_dispatches
        reset_launch_counts()
        t0 = time.perf_counter()
        rep = replay_fleet(fleet, trace, clock)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = launch_counts()
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        flushes = rep["metrics"]["batches"] - primed
        if (rep["completed"] + rep["shed"] != FLEET_TRACE_REQUESTS
                or rep["compiles_after_warmup"] != 0
                or rep["latency_p99_ms"] > config.deadline_ms
                or rep["metrics"]["failures"]
                or counts["persistent_fwd_kernel"]
                + model.over_gate_dispatches - over0 != flushes):
            raise AssertionError(
                f"fleet bench, {n} replica(s): completed {rep['completed']}"
                f" + shed {rep['shed']} of {FLEET_TRACE_REQUESTS}, compiles "
                f"after warmup {rep['compiles_after_warmup']}, p99 "
                f"{rep['latency_p99_ms']} ms, launches {counts} over "
                f"{flushes} flushes")
        key = "rps_modelled" if n > 1 else "rps"
        runs[f"replicas_{n}"] = {
            key: rep["rps"], "latency_p50_ms": rep["latency_p50_ms"],
            "latency_p99_ms": rep["latency_p99_ms"],
            "completed": rep["completed"], "shed": rep["shed"],
            "offered_rps": rep["offered_rps"], "span_s": rep["span_s"],
            "flushes": flushes,
            "batch_occupancy": rep["metrics"]["batch_occupancy"],
            "policy_decisions": sum(r.engine.policy.decisions
                                    for r in fleet.replicas),
            "flush_fractions": [r.engine.batcher.flush_fraction
                                for r in fleet.replicas],
            "fill_slots": [r.engine.batcher.fill_slots
                           for r in fleet.replicas],
            "replay_wall_s": wall_s,
            "launches": {k: v for k, v in counts.items() if v}}
    runs["modelled"] = ("replicas_4's rps_modelled: one replica timeline "
                        "stands for one card; its flushes ran on this "
                        "one card")
    return runs, launches


def _fleet_http(model: FlowGNN) -> dict:
    """A live 2-replica fleet over HTTP on the one card: 512 one-function
    POSTs from 16 threads (a 429 retried after its Retry-After), r1
    taken out of rotation and brought back mid-traffic (``/healthz`` 503
    degraded, then 200 ok), then rolled with ``roll_replica``; every
    function answered, the replica sections summing to ``/metrics``,
    compiles flat, the launches those of the flushes."""
    from deepdfa_tpu_torch.serve.http import ServeHTTPServer

    fleet = ServeFleet.build(model, ServeConfig(adaptive_flush=True),
                             n_replicas=FLEET_HTTP_REPLICAS)
    fleet.warmup()
    captured = fleet.graphs_captured
    server = ServeHTTPServer(("127.0.0.1", 0), fleet)
    server.start_pump()
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    bodies = [{"functions": [fn]} for fn in _functions(synthetic_bigvul(
        FLEET_HTTP_POSTS, model.config.feature, seed=SEED + 3))]
    lat_ms = [0.0] * len(bodies)
    results = [None] * len(bodies)
    retries = [0]
    done = [0]
    lock = threading.Lock()
    cursor = iter(range(len(bodies)))

    def client():
        while True:
            with lock:
                i = next(cursor, None)
            if i is None:
                return
            t0 = time.perf_counter()
            while True:
                status, headers, body = _http(base, "/score", bodies[i])
                if status != 429:
                    break
                with lock:
                    retries[0] += 1
                time.sleep(float(headers["Retry-After"]))
            lat_ms[i] = (time.perf_counter() - t0) * 1e3
            results[i] = (status, body)
            with lock:
                done[0] += 1

    clients = [threading.Thread(target=client)
               for _ in range(FLEET_HTTP_CLIENTS)]

    def wait_for(n):
        while done[0] < n and any(c.is_alive() for c in clients):
            time.sleep(0.005)

    try:
        _, _, m0 = _http(base, "/metrics")
        over0 = model.over_gate_dispatches
        reset_launch_counts()
        t0 = time.perf_counter()
        for c in clients:
            c.start()
        wait_for(len(bodies) // 3)
        fleet.begin_replica_drain("r1")
        mid_status, _, mid = _http(base, "/healthz")
        drained = fleet.await_replica_drained("r1", deadline_s=30.0)
        fleet.restore_replica("r1")
        after_status, _, after = _http(base, "/healthz")
        wait_for(2 * len(bodies) // 3)
        rolled = fleet.roll_replica("r1", deadline_s=30.0)
        for c in clients:
            c.join(timeout=300)
        wall_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = launch_counts()
        _, _, m1 = _http(base, "/metrics")
        end_status, _, end = _http(base, "/healthz")
    finally:
        server.shutdown()
        server.server_close()
    answered = sum(1 for r in results if r is not None and r[0] == 200
                   and "prob" in r[1]["results"][0])
    sections = {name: sum(m[name] for m in m1["replicas"].values())
                for name in ServingStats.COUNTERS}
    flushes = m1["batches"] - m0["batches"]
    over = model.over_gate_dispatches - over0
    if (answered != len(bodies) or any(c.is_alive() for c in clients)
            or (mid_status, mid["status"]) != (503, "degraded")
            or mid["fleet"]["replicas"]["r1"]["status"] != "draining"
            or (after_status, after["status"]) != (200, "ok")
            or (end_status, end["status"]) != (200, "ok")
            or not drained or not rolled
            or any(m1[k] != v for k, v in sections.items())
            or m1["compiles"] != m0["compiles"]
            or fleet.compiles_after_warmup != 0 or m1["failures"]
            or m1["compiles_after_warmup"] != 0
            or fleet.graphs_captured != captured
            or launches["persistent_fwd_kernel"] + over != flushes
            or not all(m["batches"] for m in m1["replicas"].values())):
        raise AssertionError(
            f"fleet over HTTP: {answered} of {len(bodies)} answered, "
            f"healthz {mid_status} {mid['status']} during the drain, "
            f"{after_status} {after['status']} after, {end_status} at the "
            f"end; drained {drained}, rolled {rolled}; /metrics {m1} "
            f"against its sections {sections}; launches {launches} over "
            f"{flushes} flushes ({over} over the gate)")
    return dict(replicas=FLEET_HTTP_REPLICAS, clients=FLEET_HTTP_CLIENTS,
                posts=len(bodies), retries_429=retries[0], wall_s=wall_s,
                requests_per_s=len(bodies) / wall_s,
                latency_p50_ms=statistics.median(lat_ms),
                latency_p99_ms=float(np.percentile(lat_ms, 99)),
                server_p99_ms=m1["latency_p99_ms"], flushes=flushes,
                replica_batches={rid: m["batches"] for rid, m in
                                 m1["replicas"].items()},
                policy_decisions=[r.engine.policy.decisions
                                  for r in fleet.replicas],
                compiles=m1["compiles"], graphs_captured=captured,
                graph_pool_bytes=m1["graph_pool_bytes"], launches=launches)


def phase_fleet() -> dict:
    """The serving fleet on the card (phase 30): offline parity with one
    engine, the reference's fleet bench at 1 and 4 replicas, a live
    2-replica fleet over HTTP with a roll; the published FlowGNN
    (persistent lane, f32) from ``SEED``."""
    model = FlowGNN(FlowGNNConfig(message_impl="persistent"), device="cuda",
                    seed=SEED)
    parity = _fleet_parity(model)
    bench, bench_launches = _fleet_bench(model)
    root = tempfile.mkdtemp(prefix="fleet_run_")
    try:
        with telemetry.run_scope(root):
            live = _fleet_http(model)
        events = _run_events(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    # The roll's trace: r1 drained and restored mid-traffic, then rolled.
    roll = [(e["name"], e["attrs"]["replica"]) for e in events
            if e["name"].startswith("fleet.replica_")]
    if roll != [("fleet.replica_drain", "r1"),
                ("fleet.replica_restore", "r1")] * 2 \
            or len(_named(events, "lifecycle.lame_duck")) != 2:
        raise AssertionError(f"fleet roll events {roll}")
    live["roll_events"] = roll
    live["flush_spans"] = len(_named(events, "serve.flush"))
    launches = {k: parity["launches"][k] + bench_launches.get(k, 0)
                + live["launches"][k] for k in parity["launches"]}
    rec = dict(phase="fleet", parity=parity, bench=bench, http=live,
               launches=launches)
    emit(**rec)
    return rec


# ---------------------------------------------------------------------------
# Serving as captured CUDA graphs
# ---------------------------------------------------------------------------

# Every (lane, bucket) pair the engine captures: the gnn lane on each
# message lane at f32 and bf16, and the combined lane (codebert-base,
# block 512) at f32, each at the published FlowGNN width.
SERVE_GRAPH_LANES = tuple(("gnn", impl, dtype)
                          for impl in ("persistent", "fused", "band",
                                       "segment")
                          for dtype in ("float32", "bfloat16")) + (
    ("combined", "persistent", "float32"),)
SERVE_GRAPH_REPS = 20
SERVE_GRAPH_TRACE = 200
# Pairs of flushes (one off, one on) of the spans' cost, a slot count.
SPAN_COST_PAIRS = 300
# Profiler launches (by __global__ name) of one counted launch of each
# counter: the bf16 per-step forward is two passes after the weights'
# prep, the bf16 sweep one after it.
SERVE_PROFILE_LAUNCHES = {
    "persistent_fwd_kernel": {"persistent_fwd_kernel": 1},
    "fused_step_kernel": {"fused_step_kernel": 1},
    "persistent_fwd_kernel_bf16": {"persistent_fwd_kernel_bf16": 1},
    "fused_step_kernel_bf16": {"fused_step_kernel_bf16": 2},
    "fwd_bf16_prep_kernel": {"fused_step_kernel_bf16": 1,
                             "persistent_fwd_kernel_bf16": 1},
    "flash_fwd_kernel": {"flash_fwd_kernel": 1},
    "segment_sum_kernel": {"segment_sum_kernel": 1},
    "segment_sum_kernel_bf16": {"segment_sum_kernel_bf16": 1},
}


def _graphs_engine(lane: str, impl: str, dtype: str) -> tuple:
    """(engine, its virtual clock): the published FlowGNN on ``impl`` at
    ``dtype`` from ``SEED``; for the combined lane also DeepDFA+LineVul
    at codebert-base width from ``TEXT_SEED`` with the hashing
    tokenizer."""
    cfg = FlowGNNConfig(message_impl=impl, dtype=dtype)
    model = FlowGNN(cfg, device="cuda", seed=SEED)
    clock = VirtualClock()
    kw = {}
    if lane == "combined":
        enc = EncoderConfig()
        kw = dict(combined_model=LineVul(
            enc, dataclasses.replace(cfg, encoder_mode=True), device="cuda",
            seed=TEXT_SEED), tokenizer=HashingCodeTokenizer(enc.vocab_size))
    return ServeEngine(model, ServeConfig(), clock=clock, device="cuda",
                       **kw), clock


def _graph_inputs(engine: ServeEngine, lane: str, n: int, seed: int):
    """(graphs as admission leaves them, token rows) of ``n`` functions."""
    made = synthetic_bigvul(n, engine.model.config.feature, seed=seed)
    graphs = [engine._normalize_graph(g) for g in made]
    if lane != "combined":
        return graphs, []
    codes = [t["code"] for t in attach_synthetic_text(
        [dict(g) for g in made], seed=TEXT_SEED)]
    return graphs, [encode_function(c, engine.tokenizer,
                                    engine.config.block_size) for c in codes]


def _wall_ms(fn, reps: int) -> float:
    """Median host ms of ``fn`` (a flush, ended by its host transfer)."""
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def _stream_ms(engine: ServeEngine, fn, reps: int) -> float:
    """Median device ms of ``fn`` on the engine's stream, between two
    CUDA events."""
    out = []
    with engine._on_stream():
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end))
    return statistics.median(out)


def _profile_held(what: str, fn, n: int) -> dict:
    """``n`` calls of ``fn`` under torch.profiler: each port kernel name's
    launches (by its ``__global__`` name) equal to what its counters moved
    by (``SERVE_PROFILE_LAUNCHES``), name by name. A session that records
    no device activity, or other counts (the profiler has dropped
    launches late in a long process), is run again, up to
    ``PROFILE_SESSIONS`` in all. Returns the names' launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    last = "no device activity"
    for _ in range(PROFILE_SESSIONS):
        before = launch_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        after = launch_counts()
        seen, device = {}, False
        for evt in prof.key_averages():
            if "cuda" not in str(evt.device_type).lower():
                continue
            device = True
            found = re.search(r"(\w+)(<[^(]*>)?\(", evt.key)
            if found and found.group(1) in PORT_KERNELS:
                seen[found.group(1)] = seen.get(found.group(1), 0) \
                    + int(evt.count)
        if not device:
            continue
        want = {name: sum(m * (after[c] - before[c]) for c, m in per.items())
                for name, per in SERVE_PROFILE_LAUNCHES.items()}
        want = {name: v for name, v in want.items() if v}
        if seen == want:
            return seen
        last = f"the profiler saw {seen}, the launch counters give {want}"
    raise AssertionError(f"{what}: {last} ({PROFILE_SESSIONS} sessions)")


def _eager_flush(engine: ServeEngine, lane: str, graphs, slots, ids):
    """The lane's forward op by op on a fresh device copy of the packed
    batch: the host probabilities a replay must equal bit for bit."""
    gb, ids_t = engine._pack(lane, graphs, slots, ids)
    with engine._on_stream():
        return engine._forward(
            lane, gb.to(engine.device),
            None if ids_t is None else ids_t.to(engine.device)).cpu()


def _graph_pairs(engine: ServeEngine, lane: str, impl: str,
                 dtype: str) -> list:
    """Each of the lane's buckets: the replay bit for bit the eager
    forward on a full batch and on a partial one after it; eager and
    replay flush wall and device ms (medians of ``SERVE_GRAPH_REPS``)."""
    reps = SERVE_GRAPH_REPS
    pairs = []
    for slots in engine.config.slot_buckets:
        full = _graph_inputs(engine, lane, slots, SEED + 40 + slots)
        part = _graph_inputs(engine, lane, max(1, slots // 3),
                             SEED + 80 + slots)
        for graphs, ids in (full, part):
            got = engine.forward(lane, graphs, slots, ids)
            want = _eager_flush(engine, lane, graphs, slots, ids)
            if not torch.equal(got, want):
                raise AssertionError(
                    f"{lane}/{impl}/{dtype}, {slots} slots, {len(graphs)} "
                    f"graphs: the replay is not the eager forward bit for "
                    f"bit (max |diff| {(got - want).abs().max().item()})")
        graphs, ids = full
        gb, ids_t = engine._pack(lane, graphs, slots, ids)
        key = (lane, slots, None if gb.band_adj is None
               else gb.band_adj.vals.dtype)
        prog = engine._programs[key]
        dev = gb.to(engine.device)
        dev_ids = None if ids_t is None else ids_t.to(engine.device)
        with torch.inference_mode():
            eager_dev = _stream_ms(
                engine, lambda: engine._forward(lane, dev, dev_ids), reps)
        with engine._on_stream():
            prog.staged.stage(gb, ids_t)
        replay_dev = _stream_ms(engine, prog.graph.replay, reps)
        eager_wall = _wall_ms(
            lambda: _eager_flush(engine, lane, graphs, slots, ids), reps)
        replay_wall = _wall_ms(lambda: engine.forward(
            lane, graphs, slots, ids), reps)
        pairs.append(dict(
            lane=lane, message_impl=impl, dtype=dtype, slots=slots,
            bits_equal_full=True, bits_equal_partial=True,
            partial_graphs=len(part[0]),
            eager_flush_ms=eager_wall, replay_flush_ms=replay_wall,
            eager_device_ms=eager_dev, replay_device_ms=replay_dev,
            staged_bytes=prog.staged.nbytes))
    return pairs


def _paired_ms(off: list[float], on: list[float]) -> dict:
    """The on-off difference of paired flush walls: its median with the
    median's 95 % interval (order statistics of the sorted differences),
    its quartiles, the share of pairs where on was slower, and the medians
    of the two walls."""
    diff = sorted(b - a for a, b in zip(off, on))
    n = len(diff)
    half = 0.98 * math.sqrt(n)
    q1, _, q3 = statistics.quantiles(diff, n=4)
    return dict(
        pairs=n, off_ms=statistics.median(off), on_ms=statistics.median(on),
        cost_ms=statistics.median(diff),
        cost_ci95_ms=[diff[max(int(n / 2 - half), 0)],
                      diff[min(int(math.ceil(n / 2 + half)), n - 1)]],
        cost_q1_ms=q1, cost_q3_ms=q3,
        on_slower_share=sum(d > 0 for d in diff) / n)


def _span_cost(engine: ServeEngine) -> dict:
    """The flush wall (``_run_batch``, packing to the answers) on the
    engine's gnn lane at 1 and 16 slots, with telemetry off
    (``DEEPDFA_TELEMETRY=0``'s switch) and with the run active, flush by
    flush: ``SPAN_COST_PAIRS`` pairs, one flush off and one on, the order
    alternating pair by pair (:func:`_paired_ms`)."""
    out = {}
    for slots in (1, 16):
        graphs, _ = _graph_inputs(engine, "gnn", slots, SEED + 160 + slots)
        reqs = [ServeRequest(rid=i, key=f"span{i}", graph=g, lane="gnn",
                             arrival=0.0, deadline_s=1.0,
                             t_submit=telemetry.now())
                for i, g in enumerate(graphs)]
        walls: dict[str, list[float]] = {"off": [], "on": []}
        try:
            for i in range(SPAN_COST_PAIRS):
                for mode in ("off", "on")[::1 if i % 2 == 0 else -1]:
                    telemetry.set_enabled(False if mode == "off" else None)
                    t0 = time.perf_counter()
                    engine._run_batch("gnn", reqs)
                    walls[mode].append((time.perf_counter() - t0) * 1e3)
        finally:
            telemetry.set_enabled(None)
        if any("prob" not in r.result for r in reqs):
            raise AssertionError(f"span cost flush: {reqs[0].result}")
        out[str(slots)] = _paired_ms(walls["off"], walls["on"])
    return out


def phase_serve_graphs(_arg=None) -> dict:
    """Phase 31 with a telemetry run active (a temporary directory): the
    captures' ``serve.compile`` spans fence after ``capture_end``, every
    flush of the traces is a fenced ``serve.flush`` span, and nothing is
    dropped; plus the spans' cost on the persistent lane's flush wall."""
    root = tempfile.mkdtemp(prefix="serve_graphs_run_")
    try:
        with telemetry.run_scope(root):
            rec = _serve_graphs()
            drops = telemetry.drop_count()
        events = _run_events(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    compiles = _named(events, "serve.compile")
    flushes = _named(events, "serve.flush")
    want_flushes = sum(e["trace_flushes"] for e in rec["engines"].values()) \
        + 2 * SPAN_COST_PAIRS
    captured = sum(e["captured"] for e in rec["engines"].values())
    if (drops or len(compiles) != captured or len(flushes) != want_flushes
            or not all(s.get("fenced") for s in compiles + flushes)
            or any("error" in s for s in compiles + flushes)):
        raise AssertionError(
            f"serve_graphs trace: {drops} drops, {len(compiles)} compile "
            f"spans for {captured} captures, {len(flushes)} flush spans for "
            f"{want_flushes} flushes")
    rec["trace"] = dict(compile_spans=len(compiles), flush_spans=len(flushes),
                        drops=drops)
    emit(phase="serve_graphs", span_cost=rec["span_cost"], **rec["trace"])
    return rec


def _serve_graphs() -> dict:
    """Phase 31: serving as captured CUDA graphs, in a process of its own
    (fresh profiler state). For each engine of ``SERVE_GRAPH_LANES``:
    warmup captures every (lane, bucket) pair once; each pair's replay
    equals the eager forward bit for bit on a full batch and on a partial
    batch after it, with eager and replay flush wall and device ms; 20
    replays of the 16-slot pair under torch.profiler, each port kernel
    name's launches equal to its counters'; then ``bursty_trace(200,
    seed=1)`` replayed on the engine's virtual clock with nothing captured
    after warmup; the graph pool's bytes."""
    launches = {k: 0 for k in REPLACES}
    engines = {}
    for lane, impl, dtype in SERVE_GRAPH_LANES:
        name = f"{lane}/{impl}/{dtype}"
        before = launch_counts()
        engine, clock = _graphs_engine(lane, impl, dtype)
        t0 = time.perf_counter()
        warmed = engine.warmup()
        warm_s = time.perf_counter() - t0
        n_pairs = len(engine.warm_buckets())
        if warmed != n_pairs or engine.graphs_captured != n_pairs:
            raise AssertionError(f"{name}: warmup built {warmed} programs, "
                                 f"captured {engine.graphs_captured}, of "
                                 f"{n_pairs} pairs")
        pairs = _graph_pairs(engine, lane, impl, dtype)
        graphs, ids = _graph_inputs(engine, lane, 16, SEED + 120)
        profile = _profile_held(
            name, lambda: engine.forward(lane, graphs, 16, ids),
            SERVE_GRAPH_REPS)
        captured = engine.graphs_captured
        trace = bursty_trace(SERVE_GRAPH_TRACE, engine.model.config.feature,
                             seed=1, with_code=lane == "combined")
        out = replay(engine, trace, clock)
        m = out["metrics"]
        lanes_seen = {r.result.get("model") for r in out["requests"]}
        if (engine.compiles_after_warmup != 0
                or engine.graphs_captured != captured
                or m["completed"] != SERVE_GRAPH_TRACE or m["failures"]
                or lanes_seen != {lane}):
            raise AssertionError(f"{name}: over the bursty trace {m}, lanes "
                                 f"{lanes_seen}, captured "
                                 f"{engine.graphs_captured} (was {captured})")
        if (lane, impl, dtype) == ("gnn", "persistent", "float32"):
            span_cost = _span_cost(engine)
        torch.cuda.synchronize()
        after = launch_counts()
        for k in launches:
            launches[k] += after[k] - before[k]
        engines[name] = dict(
            warmup_s=warm_s, captured=captured,
            graph_pool_bytes=engine.graph_pool_bytes,
            profile_launches=profile, trace_flushes=m["batches"],
            compiles_after_warmup=engine.compiles_after_warmup)
        telemetry.flush()
        for rec in pairs:
            emit(phase="serve_graphs", **rec)
        emit(phase="serve_graphs", engine=name, **engines[name])
        del engine
        torch.cuda.empty_cache()
    return dict(launches=launches, engines=engines, span_cost=span_cost)


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
    """The kernels a graph encoder of ``graph_cfg.message_impl`` launches
    over the batches fit_text makes of ``indices`` (train: a gradient
    through the encoder; else forward only, as an evaluation or a frozen
    encoder runs it), the bf16 instances for a bf16 encoder. A persistent
    batch over its gate (at the encoder's dtype) runs the fused kernel per
    step (``FlowGNN._message_pass``); the segment lane aggregates with
    ``segment_sum_kernel`` each step, the tile lane with
    ``tile_spmm_kernel`` each step forward and backward; where no gradient
    flows the pooling's per-graph sums are one ``segment_sum_kernel``
    launch (f32 at either dtype)."""
    k, hidden = graph_cfg.n_steps, graph_cfg.ggnn_hidden
    impl = graph_cfg.message_impl
    dtype = getattr(torch, graph_cfg.dtype)
    sfx = "_bf16" if dtype == torch.bfloat16 else ""
    gate = (fused_gnn.persistent_bwd_smem_ok if train
            else fused_gnn.persistent_smem_ok)
    rng = (np.random.default_rng(shuffle_seed) if shuffle_seed is not None
           else None)
    out = dict.fromkeys(REPLACES, 0)
    for b in text_loop.text_graph_batches(
            data, indices, tcfg.batch_size if train else tcfg.eval_batch_size,
            shuffle_rng=rng, build_band_adj=graph_cfg.uses_band_adj,
            build_tile_adj=graph_cfg.uses_tile_adj, **kw):
        if not train:
            out["segment_sum_kernel"] += 1
        if impl == "segment":
            out["segment_sum_kernel" + sfx] += k
            continue
        if impl == "tile":
            out["tile_spmm_kernel" + sfx] += k * (2 if train else 1)
            continue
        if impl == "band":
            continue
        if impl == "persistent" and gate(b.graphs.band_adj, hidden, dtype):
            names = (["persistent_fwd_kernel", "persistent_fwd_hist_kernel",
                      "persistent_bwd_kernel", "step_weight_grad_kernel"]
                     if train else ["persistent_fwd_kernel"])
            for name in names:
                out[name + sfx] += 1
        else:
            names = (["fused_step_kernel", "fused_step_bwd_kernel",
                      "step_weight_grad_kernel"] if train
                     else ["fused_step_kernel"])
            for name in names:
                out[name + sfx] += k
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
               device_idle_share=_idle_share(profile, breakdown),
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
    timings.update(timed("kernels_bf16", phase_kernels_bf16, model))
    for k, v in timed("serve_bf16", phase_serve_bf16)["launches"].items():
        path_launches[k] += v
    timings.update(timed("train_kernels", phase_train_kernels, model))
    timings.update(timed("tile_kernels", phase_tile_kernels))
    train_f32 = {}
    for impl in ("persistent", "fused", "tile"):
        train_f32[impl] = timed(f"train_{impl}", phase_train, impl)
        for k, v in train_f32[impl]["launches"].items():
            path_launches[k] += v
    timings.update(timed("attention_kernels", phase_attention_kernels))
    timings.update(timed("attention_kernels_bf16", phase_attention_kernels,
                         torch.bfloat16))
    for phase, fn, args in (
            ("fit_text", phase_fit_text, ()),
            ("fit_text_vs_cpu", phase_fit_text_vs_cpu, ()),
            ("fit_text_vs_cpu_tile", phase_fit_text_vs_cpu, ("tile",)),
            ("fit_text_bf16_graph", phase_fit_text_bf16_graph, ()),
            ("fit_text_long", phase_fit_text_long, ()),
            ("recipe", phase_recipe, ()),
            ("inputs", phase_inputs, ()),
            ("serve_http", phase_serve_http, ()),
            ("replay", phase_replay, ()),
            ("fleet", phase_fleet, ()),
            ("codet5", phase_codet5, ()),
            ("fit_text_bf16", phase_fit_text_bf16, ()),
            ("fit_text_long_bf16", phase_fit_text_long_bf16, ()),
            ("codet5_bf16", phase_codet5_bf16, ())):
        for k, v in timed(phase, fn, *args)["launches"].items():
            path_launches[k] += v
    # Phases 27-28 run last, so every earlier phase keeps its place in
    # the process's run: with them ahead of the attention phases, the
    # profiler recorded no device time at all in those phases' short
    # windows, three sessions running (the same phases after a short
    # history in a fresh process recorded every window). Phase 28 also
    # profiles in a fresh process.
    timings.update(timed("train_kernels_bf16", phase_train_kernels_bf16,
                         model))
    f32_lanes = {impl: dict(device_busy_ms=rec["step_profile"][
        "device_busy_ms"], graphs_per_s=rec["graphs_per_s"])
        for impl, rec in train_f32.items()}
    for k, v in timed("train_bf16", _phase_in_child, "train_bf16",
                      f32_lanes)["launches"].items():
        path_launches[k] += v
    for k, v in timed("serve_graphs", _phase_in_child, "serve_graphs",
                      {})["launches"].items():
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
                                       "blocks_per_sm_pass1",
                                       "blocks_per_sm_pass2", "smem_bytes",
                                       "smem_bytes_pass1", "smem_bytes_pass2",
                                       "f32_kernel_ms", "elements_differing",
                                       "scan_bits_equal", "fold_bits_equal",
                                       "one_step_ms", "stages",
                                       "rows_per_split", "plain_bits_equal",
                                       "mode", "lanes", "checked",
                                       "floor_ms", "plan_given_ms",
                                       "plan_ms")
               if key in t}})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def child_main(name: str, arg: str) -> int:
    """A phase of ``CHILD_PHASES`` in this process, its result as the
    last line."""
    if not torch.cuda.is_available():
        return 1
    _full_f32()
    print(json.dumps(CHILD_PHASES[name](json.loads(arg))), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--phase":
        sys.exit(child_main(sys.argv[2], sys.argv[3]))
    sys.exit(main())
