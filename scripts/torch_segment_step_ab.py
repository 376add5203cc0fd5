"""Time a FlowGNN train step on the ``segment`` message lane, at f32 and
bf16, in two checkouts on one card, in turns.

    python3 scripts/torch_segment_step_ab.py OLD_DIR NEW_DIR [--out FILE]

Each checkout's own ``chip_smoke.py`` builds a seeded
``FlowGNN(message_impl="segment")`` at the published width on the card
and times ``make_train_step``'s step on the first training batch
(``_training_batch``: 256 graphs) with ``_gnn_step_breakdown``: the
median over 10 steps of the forward, backward and optimizer device ms
(CUDA events) and the step's host wall ms, after two warm-up steps that
also build any kernel library the step loads. Beside it, on the same
batch, each of these is timed twice, ``*_device_ms`` (CUDA events around
calls queued behind a device-side sleep: the card's time, ``_time_ms``)
and ``*_host_ms`` (the wall time of one call started on an idle card:
what the host spends to enqueue it, median of 20): the forward in the
step (``step_forward_*``: zero_grad, forward and loss as the breakdown
times them, its events beside the host's wall time to enqueue it,
median of 10), the forward alone
(``forward``), its message pass (``message_pass``: five steps), one
``segment_sum`` of the lane's messages into the receivers as a step
makes it (``segment_sum``: ``index_add_`` before the ordered kernel, the
plan and the kernel after), that call with the plan given
(``segment_sum_plan_given``) and the wrapper alone
(``segment_sum_rows``) where the checkout has them, and ``index_add_``
on the same rows (``index_add``). The checkouts run in a process each,
in the order OLD, NEW, NEW, OLD, so that a drift of the card or its host
over the call shows as a gap between the two runs of one checkout.
Prints one JSON object: the card's name and power limit and, for each
run, each dtype's numbers. Needs one NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

STEP = """
import inspect, statistics, time
import torch
import chip_smoke as cs
from deepdfa_tpu_torch.graphs import segment


def host_ms(fn, reps=20):
    for _ in range(3):
        fn()
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(out)


def step_forward(model, batch, reps=10):
    opt = cs.loop.make_optimizer(model.parameters(), cs.TrainConfig())
    labels, mask = cs.loop._labels_for(model, batch)
    host, events = [], []
    for _ in range(reps + 2):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        opt.zero_grad(set_to_none=True)
        loss = cs.loop.bce_with_logits(model(batch), labels, mask)
        ev[1].record()
        host.append((time.perf_counter() - t0) * 1e3)
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        events.append(ev[0].elapsed_time(ev[1]))
    return {"step_forward_host_ms": statistics.median(host[2:]),
            "step_forward_events_ms": statistics.median(events[2:])}


def timed(name, fn):
    return {name + "_device_ms": cs._time_ms(fn),
            name + "_host_ms": host_ms(fn)}


cs.phase_device()
for dtype in ("float32", "bfloat16"):
    model = cs.FlowGNN(cs.FlowGNNConfig(message_impl="segment", dtype=dtype),
                       device="cuda", seed=cs.SEED)
    batch = cs._training_batch(model)
    rec = dict(graphs=int(batch.graph_mask.sum()),
               edges=int(batch.edge_mask.sum()), rows=batch.max_edges,
               buckets=batch.max_nodes,
               **cs._gnn_step_breakdown(model, batch),
               **step_forward(model, batch))
    h = torch.cat([model.embeds[s](batch.node_feats[s])
                   for s in model.subkeys], dim=-1)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    msg = torch.randn((batch.max_edges, model.config.ggnn_hidden),
                      generator=gen, device="cuda").to(model.dtype)
    msg = torch.where(batch.edge_mask[:, None], msg, 0.0)
    params = inspect.signature(segment.segment_sum).parameters
    kw = {"mask": batch.edge_mask} if "mask" in params else {}
    keyed = torch.where(batch.edge_mask, batch.receivers.long(),
                        batch.max_nodes)
    rec.update(timed("forward", lambda: model(batch)))
    rec.update(timed("message_pass", lambda: model._message_pass(h, batch)))
    rec.update(timed("segment_sum", lambda: segment.segment_sum(
        msg, batch.receivers, batch.max_nodes, **kw)))
    if "plan" in params:
        plan = segment.segment_sum_plan(batch.receivers, batch.max_nodes,
                                        batch.edge_mask)
        rec.update(timed("segment_sum_plan_given", lambda: segment.segment_sum(
            msg, batch.receivers, batch.max_nodes, plan=plan)))
        rec.update(timed("segment_sum_rows", lambda: segment.segment_sum_rows(
            msg, plan)))
    rec.update(timed("index_add", lambda: torch.zeros(
        (batch.max_nodes + 1, msg.shape[1]), dtype=msg.dtype,
        device="cuda").index_add_(0, keyed, msg)))
    cs.emit(phase="segment_step", dtype=dtype, **rec)
"""


def run(checkout: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", STEP], cwd=checkout,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{checkout}: exit {proc.returncode}\n"
                           f"{proc.stderr[-4000:]}")
    out = {}
    for line in proc.stdout.splitlines():
        if line.startswith("{"):
            rec = json.loads(line)
            if rec.get("phase") == "segment_step":
                out[rec.pop("dtype")] = {k: v for k, v in rec.items()
                                         if k != "phase"}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--out", default=None,
                    help="also write the JSON object to this file")
    args = ap.parse_args()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    runs = [{"checkout": label,
             **run(os.path.abspath(getattr(args, label)))}
            for label in ("old", "new", "new", "old")]
    doc = json.dumps({"card": smi, "runs": runs})
    if args.out:
        with open(args.out, "w") as f:
            f.write(doc + "\n")
    print(doc)
    return 0


if __name__ == "__main__":
    sys.exit(main())
