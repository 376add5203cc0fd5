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
   times from CUDA events and the least time the card could take.
4. Serve, persistent lane: ``ServeEngine`` with random weights from a
   seed, 64 requests and 16 duplicates through submit/pump/drain, kernel
   launches counted over that run, probabilities held against the same
   engine on the CPU.
5. Serve, fused lane: the same with ``message_impl="fused"``.
6. Every kernel of the train path against its plain version at the
   training shape (a batch as ``fit`` packs it: 256 graphs, N = 16384
   rows, H = 128, 5 steps): the two forward kernels, then the backward
   ones with times and bounds; ``persistent_fwd_hist_kernel``'s
   ``h_k`` bit for bit against ``persistent_fwd_kernel`` run for k steps,
   and ``persistent_bwd_kernel`` plus ``step_weight_grad_kernel`` bit for
   bit against the scan of ``fused_step_bwd_kernel``.
7. Train, persistent lane: ``train.loop.fit`` on the card (published
   widths, ``DataConfig(batch_size=256)``, ``TrainConfig`` defaults but
   one epoch: 9 steps and a validation pass), launches counted over the
   run; the same initial weights and batches through the port on the
   CPU, per-step losses compared; then a step-time breakdown (CUDA
   events) and each kernel's device ms a step (``torch.profiler``).
8. Train, fused lane: the same with ``message_impl="fused"``.

Every number goes on a line of its own before the last; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from deepdfa_tpu_torch.cli import load_dataset
from deepdfa_tpu_torch.core.config import DataConfig, FlowGNNConfig, TrainConfig
from deepdfa_tpu_torch.data.sampling import epoch_indices
from deepdfa_tpu_torch.data.splits import make_splits
from deepdfa_tpu_torch.data.synthetic import synthetic_bigvul
from deepdfa_tpu_torch.graphs.batch import batch_graphs, pad_budget_for
from deepdfa_tpu_torch.models.flowgnn import FlowGNN
from deepdfa_tpu_torch.ops import _build, fused_gnn
from deepdfa_tpu_torch.ops.tile import DEFAULT_TILE, align_to_tile
from deepdfa_tpu_torch.serve import ServeConfig, ServeEngine
from deepdfa_tpu_torch.serve.engine import bucket_batch
from deepdfa_tpu_torch.train import loop

SEED = 0
N_REQUESTS = 64
N_DUPLICATES = 16
# Published H100 SXM peaks at the full 700 W (NVIDIA data sheet): f32
# outside the tensor cores, and HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
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
# Train steps under torch.profiler a lane, and the kernels it reports.
PROFILE_STEPS = 5
PROFILE_TOP = 8
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
    t_ops = cost["flops"] / PEAK_F32_FLOPS
    t_bytes = cost["bytes"] / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


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
                           bound_by=bound_by, flops=cost["flops"],
                           bytes=cost["bytes"], launches=launches,
                           launches_per_forward=per_forward)
                emit(phase="kernels", **rec)
                if shape == "serving":
                    serving[name] = rec
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

    fused_gnn.reset_launch_counts()
    t0 = time.perf_counter()
    handles = []
    for g in reqs:
        handles.append(engine.submit(g))
        engine.pump()
    dups = [engine.submit(g) for g in reqs[:N_DUPLICATES]]
    engine.drain()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = fused_gnn.launch_counts()

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
    examples = load_dataset(f"synthetic:{N_TRAIN_EXAMPLES}", feature,
                            seed=seed)
    return examples, make_splits(examples, mode="random", seed=seed)


def _training_batch(model: FlowGNN):
    """The first batch of fit's first epoch at the published sizes."""
    examples, splits = _train_data(model.config.feature, TrainConfig().seed)
    train = splits["train"]
    idx = epoch_indices([examples[i]["label"] for i in train], 0,
                        seed=DataConfig().seed)
    batches = loop._batches(examples, train[idx], DataConfig(),
                            list(model.subkeys), DataConfig().batch_size,
                            build_band_adj=True)
    return next(iter(batches)).to("cuda")


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
                   **extra):
            before = fused_gnn.launch_counts()[name]
            kernel_ms = _time_ms(kernel, iters, reps)
            launches = fused_gnn.launch_counts()[name] - before
            plain_ms = _time_ms(plain, iters, reps)
            cost = fused_gnn.kernel_cost(adj, hidden, steps, kernel=name)
            bound_ms, bound_by = _bound(cost)
            rec = dict(kernel=name, shape="training", n_rows=h.shape[0],
                       hidden=hidden, bandwidth=adj.bandwidth,
                       row_groups=adj.row_groups.numel() - 1,
                       max_group_rows=adj.max_group_rows, nnz=cost["nnz"],
                       steps=steps, max_abs_err=err, tol=tol,
                       kernel_ms=kernel_ms, plain_ms=plain_ms,
                       bound_us=bound_ms * 1e3, bound_by=bound_by,
                       flops=cost["flops"], bytes=cost["bytes"],
                       timing_launches=launches, **extra)
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
               STEP_TOL)
        err = _check("persistent_fwd_kernel@training",
                     fused_gnn.persistent_unroll(params, h, adj, k_steps,
                                                 packed=packed),
                     fused_gnn.persistent_reference(params, h, adj, k_steps),
                     UNROLL_TOL)
        record("persistent_fwd_kernel", err,
               lambda: fused_gnn.persistent_unroll(params, h, adj, k_steps,
                                                   packed=packed),
               lambda: fused_gnn.persistent_reference(params, h, adj,
                                                      k_steps),
               k_steps, UNROLL_TOL)

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
            1, STEP_TOL)

        # persistent_fwd_hist_kernel: h_1..h_{K-1}; each h_k bit for bit
        # the persistent forward's after k steps.
        hist = fused_gnn.persistent_hist(params, h, adj, k_steps, packed)
        want = fused_gnn.persistent_hist_reference(params, h, adj, k_steps)
        err = _check("persistent_fwd_hist_kernel", hist, want, UNROLL_TOL)
        _same_bits("persistent_fwd_hist_kernel vs persistent_fwd_kernel",
                   list(hist), [fused_gnn.persistent_unroll(
                       params, h, adj, k, packed) for k in range(1, k_steps)])
        out["persistent_fwd_hist_kernel"] = record(
            "persistent_fwd_hist_kernel", err,
            lambda: fused_gnn.persistent_hist(params, h, adj, k_steps,
                                              packed),
            lambda: fused_gnn.persistent_hist_reference(params, h, adj,
                                                        k_steps),
            k_steps, UNROLL_TOL)

        # persistent_bwd_kernel: the reverse sweep over the kernel's hist.
        rows = fused_gnn.persistent_bwd_rows(params, h, hist, adj, g, k_steps,
                                             packed)
        want = fused_gnn.persistent_bwd_rows_reference(params, h, hist, adj,
                                                       g, k_steps)
        err = max(_check(f"persistent_bwd_kernel[{i}]", a, b, UNROLL_TOL)
                  for i, (a, b) in enumerate(zip(rows, want)))
        # ... and bit for bit the scan of fused_step_bwd_kernel.
        gs, scan = g, [None] * k_steps
        for s in reversed(range(k_steps)):
            hs = h if s == 0 else hist[s - 1]
            gs, *scan[s] = fused_gnn.fused_step_bwd_rows(params, hs, adj, gs,
                                                         packed)
        _same_bits("persistent_bwd_kernel vs scan of fused_step_bwd_kernel",
                   rows, [gs] + [torch.stack([c[j] for c in scan])
                                 for j in range(3)])
        out["persistent_bwd_kernel"] = record(
            "persistent_bwd_kernel", err,
            lambda: fused_gnn.persistent_bwd_rows(params, h, hist, adj, g,
                                                  k_steps, packed),
            lambda: fused_gnn.persistent_bwd_rows_reference(
                params, h, hist, adj, g, k_steps),
            k_steps, UNROLL_TOL, iters=5)

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
        out["step_weight_grad_kernel"] = record(
            "step_weight_grad_kernel", err,
            lambda: fused_gnn.step_weight_grads(h, hist, x, dp, dmsg,
                                                k_steps),
            lambda: fused_gnn.step_weight_grad_reference(h, hist, x, dp,
                                                         dmsg, k_steps),
            k_steps, dict(rel=GRAD_TOL), iters=5, max_rel_err=rel)
    return out


def _step_breakdown(model: FlowGNN, batch, reps: int = 10) -> dict:
    """Median device ms of one train step's parts on one batch (CUDA
    events around the forward with the loss, the backward and the AdamW
    step, as make_train_step runs them) and its host wall ms."""
    cfg = TrainConfig()
    opt = loop.make_optimizer(model.parameters(), cfg)
    labels, mask = loop._labels_for(model, batch)
    parts = {"forward_ms": [], "backward_ms": [], "optimizer_ms": [],
             "step_wall_ms": []}
    for _ in range(reps + 2):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        opt.zero_grad(set_to_none=True)
        loss = loop.bce_with_logits(model(batch), labels, mask)
        ev[1].record()
        loss.backward()
        ev[2].record()
        opt.step()
        ev[3].record()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        for key, a, b in (("forward_ms", 0, 1), ("backward_ms", 1, 2),
                          ("optimizer_ms", 2, 3)):
            parts[key].append(ev[a].elapsed_time(ev[b]))
        parts["step_wall_ms"].append(wall)
    return {k: statistics.median(v[2:]) for k, v in parts.items()}


def _profile_step(model: FlowGNN, batch) -> dict:
    """Device ms a train step by kernel: ``PROFILE_STEPS`` steps of
    ``make_train_step`` under ``torch.profiler`` after three warm-up
    steps; the ``PROFILE_TOP`` kernels with the most device time, and the
    device-busy ms a step (the sum over every kernel; overlapping kernels
    would count twice, and this path runs one stream)."""
    from torch.profiler import ProfilerActivity, profile

    step = loop.make_train_step(
        model, loop.make_optimizer(model.parameters(), TrainConfig()),
        TrainConfig())
    for _ in range(3):
        step(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_STEPS):
            step(batch)
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
            kernels.append((us / 1e3 / PROFILE_STEPS, evt.key,
                            evt.count / PROFILE_STEPS))
    if not kernels:
        raise AssertionError("torch.profiler recorded no device time")
    kernels.sort(reverse=True)
    return {"device_busy_ms": sum(k[0] for k in kernels),
            "top_kernels": [{"name": name[:90], "ms": ms, "calls": calls}
                            for ms, name, calls in kernels[:PROFILE_TOP]]}


def phase_train(impl: str) -> dict:
    cfg = FlowGNNConfig(message_impl=impl)
    train_cfg = dataclasses.replace(TrainConfig(), max_epochs=TRAIN_EPOCHS)
    data_cfg = DataConfig(batch_size=256)
    examples, splits = _train_data(cfg.feature, train_cfg.seed)
    model = FlowGNN(cfg, device="cuda", seed=SEED)
    cpu_model = FlowGNN(cfg, device="cpu")
    cpu_model.load_state_dict({k: v.cpu()
                               for k, v in model.state_dict().items()})

    fused_gnn.reset_launch_counts()
    t0 = time.perf_counter()
    _, history = loop.fit(model, examples, splits, train_cfg, data_cfg)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = fused_gnn.launch_counts()

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
                             f"{diffs.max():.3e} > {TRAIN_LOSS_TOL}")
    val_diff = abs(history["epochs"][-1]["val_loss"]
                   - cpu_history["epochs"][-1]["val_loss"])
    steps = len(losses)
    if impl == "persistent":
        need = ("persistent_fwd_kernel", "persistent_fwd_hist_kernel",
                "persistent_bwd_kernel", "step_weight_grad_kernel")
        exact = ({"persistent_bwd_kernel": steps}
                 if model.over_gate_dispatches == 0 else {})
    else:
        need = ("fused_step_kernel", "fused_step_bwd_kernel",
                "step_weight_grad_kernel")
        exact = {"fused_step_bwd_kernel": cfg.n_steps * steps}
    if any(launches[k] == 0 for k in need) or any(
            launches[k] != v for k, v in exact.items()):
        raise AssertionError(f"{impl} train lane: launches {launches} over "
                             f"{steps} steps")

    batch = _training_batch(model)
    breakdown = _step_breakdown(model, batch)
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


def main() -> int:
    name = phase_device()
    phase_build()
    model = FlowGNN(FlowGNNConfig(message_impl="persistent"), device="cuda",
                    seed=SEED)
    timings = phase_kernels(model)
    path_launches = {k: 0 for k in REPLACES}
    for impl in ("persistent", "fused"):
        for k, v in phase_serve(impl)["launches"].items():
            path_launches[k] += v
    timings.update(phase_train_kernels(model))
    for impl in ("persistent", "fused"):
        for k, v in phase_train(impl)["launches"].items():
            path_launches[k] += v
    kernels = []
    for kname, replaces in REPLACES.items():
        t = timings[kname]
        if path_launches[kname] <= 0:
            raise AssertionError(f"{kname} never ran on the main path")
        kernels.append({
            "name": kname, "route": "cuda", "source": SOURCES[kname],
            "replaces": replaces, "launches": path_launches[kname],
            "max_abs_err": t["max_abs_err"], "ms": t["kernel_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_us"] / 1e3,
            "bound_by": t["bound_by"], "library_ms": None,
            **({"max_rel_err": t["max_rel_err"]} if "max_rel_err" in t
               else {})})
    # library_ms is null for every kernel: no single PyTorch call computes
    # a GRU gated graph step or its VJP.
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
