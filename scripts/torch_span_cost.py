"""Where the serve path's telemetry spends its time on a flush.

    python3 scripts/torch_span_cost.py [--device cuda] [--pairs 500] \\
        [--reps 200] [--out span_cost.json]

One warmed ``ServeEngine`` (the published FlowGNN from seed 0, the
persistent lane, f32; on the card every flush a CUDA graph replay) under
a telemetry run in a temporary directory. For 1 and 16 slots: the flush
wall (``_run_batch``: packing, the staged copy, the replay, the host
copy, the answers) with telemetry off and with the run active, flush by
flush: ``--pairs`` pairs, one flush off and one on, the order alternating
pair by pair; the paired on-off difference's median with the median's
95 % interval (order statistics), its quartiles, and the share of pairs
where on was slower. Then on the same host, the parts a run adds to a
flush, each the median of ``--reps``: the ``serve.flush`` span with its
mark, and one ``serve.request`` record with the engine's attributes.
Host clock (``time.perf_counter``), ms. Prints one JSON line with the
device's name; ``--out`` writes it too.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from deepdfa_tpu_torch import telemetry  # noqa: E402
from deepdfa_tpu_torch.core.config import FlowGNNConfig  # noqa: E402
from deepdfa_tpu_torch.data.synthetic import synthetic_bigvul  # noqa: E402
from deepdfa_tpu_torch.models.flowgnn import FlowGNN  # noqa: E402
from deepdfa_tpu_torch.serve import ServeConfig, ServeEngine  # noqa: E402
from deepdfa_tpu_torch.serve.batcher import ServeRequest  # noqa: E402
from deepdfa_tpu_torch.serve.replay import VirtualClock  # noqa: E402


def _median_ms(fn, reps: int) -> float:
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def _requests(engine: ServeEngine, n: int, seed: int):
    graphs = [engine._normalize_graph(g) for g in synthetic_bigvul(
        n, engine.model.config.feature, seed=seed)]
    return [ServeRequest(rid=i, key=f"cost{i}", graph=g, lane="gnn",
                         arrival=0.0, deadline_s=1.0,
                         t_submit=telemetry.now())
            for i, g in enumerate(graphs)]


def paired_ms(off, on) -> dict:
    """The on-off difference of paired walls: median, the median's 95 %
    interval, quartiles, the share of pairs where on was slower, and the
    medians of the two walls."""
    diff = sorted(b - a for a, b in zip(off, on))
    n = len(diff)
    half = 0.98 * math.sqrt(n)
    q1, _, q3 = statistics.quantiles(diff, n=4)
    return dict(
        pairs=n, flush_off_ms=statistics.median(off),
        flush_on_ms=statistics.median(on), cost_ms=statistics.median(diff),
        cost_ci95_ms=[diff[max(int(n / 2 - half), 0)],
                      diff[min(int(math.ceil(n / 2 + half)), n - 1)]],
        cost_q1_ms=q1, cost_q3_ms=q3,
        on_slower_share=sum(d > 0 for d in diff) / n)


def measure(device: str, pairs: int, reps: int) -> dict:
    engine = ServeEngine(FlowGNN(FlowGNNConfig(message_impl="persistent"),
                                 device=device, seed=0),
                         ServeConfig(), clock=VirtualClock(), device=device)
    engine.warmup()
    out = {"device": (torch.cuda.get_device_name(0) if device != "cpu"
                      else "cpu"), "pairs": pairs, "reps": reps}
    for slots in (1, 16):
        reqs = _requests(engine, slots, 160 + slots)
        walls = {"off": [], "on": []}
        try:
            for i in range(pairs):
                for mode in ("off", "on")[::1 if i % 2 == 0 else -1]:
                    telemetry.set_enabled(False if mode == "off" else None)
                    t0 = time.perf_counter()
                    engine._run_batch("gnn", reqs)
                    walls[mode].append((time.perf_counter() - t0) * 1e3)
        finally:
            telemetry.set_enabled(None)

        def span_marked():
            with telemetry.span("serve.flush", lane="gnn", n=slots) as sp:
                sp.mark()

        span_ms = _median_ms(span_marked, reps)
        r = reqs[0]

        def request_record():
            telemetry.record_span(
                "serve.request", r.t_submit, telemetry.now(), rid=r.rid,
                lane="gnn", cached=False, degraded=False, queue_ms=0.1,
                flush_ordinal=3)

        record_ms = _median_ms(request_record, reps)
        out[str(slots)] = dict(
            paired_ms(walls["off"], walls["on"]), span_ms=span_ms,
            request_record_ms=record_ms,
            parts_ms=span_ms + slots * record_ms)
        telemetry.flush()
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--pairs", type=int, default=500)
    p.add_argument("--reps", type=int, default=200)
    p.add_argument("--out", default=None)
    args = p.parse_args()
    if args.device != "cpu" and not torch.cuda.is_available():
        print("needs a CUDA device (or --device cpu)", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory() as root:
        with telemetry.run_scope(root):
            rec = measure(args.device, args.pairs, args.reps)
        rec["drops"] = telemetry.drop_count()
    line = json.dumps(rec)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
