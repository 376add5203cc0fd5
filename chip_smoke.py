"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's serving path (``deepdfa_tpu_torch``; nothing of JAX)
at the published FlowGNN width and checks every hand-written kernel it
runs against that kernel's plain PyTorch version. Phases, in order; each
raises on failure and nothing is caught around one:

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

Every number goes on a line of its own before the last; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from deepdfa_tpu_torch.core.config import FlowGNNConfig
from deepdfa_tpu_torch.data.synthetic import synthetic_bigvul
from deepdfa_tpu_torch.graphs.batch import batch_graphs, pad_budget_for
from deepdfa_tpu_torch.models.flowgnn import FlowGNN
from deepdfa_tpu_torch.ops import _build, fused_gnn
from deepdfa_tpu_torch.ops.tile import DEFAULT_TILE, align_to_tile
from deepdfa_tpu_torch.serve import ServeConfig, ServeEngine
from deepdfa_tpu_torch.serve.engine import bucket_batch

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
# Each kernel's TPU counterpart (the Pallas kernel body it replaces).
REPLACES = {
    "fused_step_kernel": "deepdfa_tpu/ops/fused_gnn.py:271",
    "persistent_fwd_kernel": "deepdfa_tpu/ops/fused_gnn.py:626",
}
SOURCE = "deepdfa_tpu_torch/csrc/fused_gnn.cu"


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
    _build.load("fused_gnn")
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


def main() -> int:
    name = phase_device()
    phase_build()
    model = FlowGNN(FlowGNNConfig(message_impl="persistent"), device="cuda",
                    seed=SEED)
    timings = phase_kernels(model)
    path_launches = {}
    for impl, kernel in (("persistent", "persistent_fwd_kernel"),
                         ("fused", "fused_step_kernel")):
        path_launches[kernel] = phase_serve(impl)["launches"][kernel]
    kernels = []
    for kname, replaces in REPLACES.items():
        t = timings[kname]
        if path_launches[kname] <= 0:
            raise AssertionError(f"{kname} never ran on the main path")
        kernels.append({
            "name": kname, "route": "cuda", "source": SOURCE,
            "replaces": replaces, "launches": path_launches[kname],
            "max_abs_err": t["max_abs_err"], "ms": t["kernel_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_us"] / 1e3,
            "bound_by": t["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
