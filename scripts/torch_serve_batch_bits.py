"""Whether a served probability on the card depends on the flush that
carries it.

    python3 scripts/torch_serve_batch_bits.py [--impl persistent] \\
        [--dtype float32] [--out chiprun_out/batch_bits.json]

The same 200 bursty requests (``bursty_trace(200, seed=1)``, the
published FlowGNN from seed 0, 8 slots) go through one ``ServeEngine``
and through a 2-replica ``ServeFleet`` on the card, each flush recorded;
``apart`` counts the served probabilities that differ. Then the FlowGNN
forward runs again stage by stage on both flushes of every request (the
embeddings, the message pass, the pooling gate, its softmax numerators
and denominator, the pooled vector, each head layer, the probability),
with the pooling's two sums over nodes taken three ways: ``matmul``
(the assignment-matrix products, which training runs), ``rows`` (per
graph, ``graphs.segment.segment_sum_rows`` over its rows in row order:
what serving runs) and ``f64`` (the assignment products in float64). For
each way, the requests whose probability differs between their two
flushes, and for those the first stage whose rows for that graph
differ, with each side's bucket and slot. Prints one JSON line;
``--out`` writes it too. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from deepdfa_tpu_torch.core.config import FlowGNNConfig  # noqa: E402
from deepdfa_tpu_torch.graphs.segment import (  # noqa: E402
    segment_onehot,
    segment_sum_plan,
    segment_sum_rows,
)
from deepdfa_tpu_torch.models.flowgnn import FlowGNN, _dense  # noqa: E402
from deepdfa_tpu_torch.serve import (  # noqa: E402
    ServeConfig,
    ServeEngine,
    ServeFleet,
)
from deepdfa_tpu_torch.serve.cache import content_hash  # noqa: E402
from deepdfa_tpu_torch.serve.engine import bucket_batch  # noqa: E402
from deepdfa_tpu_torch.serve.replay import bursty_trace  # noqa: E402


def _record_flushes(engine, log):
    """Wrap the engine's flush so each records (key -> (graphs, slots,
    slot index))."""
    inner = engine._run_batch

    def run(lane, reqs):
        slots = engine.config.bucket_for(len(reqs))
        graphs = [r.graph for r in reqs]
        for i, r in enumerate(reqs):
            log[r.key] = (graphs, slots, i)
        return inner(lane, reqs)

    engine._run_batch = run


def _pool(pooling, feat, batch, how):
    """GlobalAttentionPool's matmul form, its sums over nodes taken as
    ``how`` says: "matmul", "rows" (per graph, over its rows in row
    order) or "f64" (the assignment products in float64)."""
    gate = _dense(pooling.gate, feat, pooling.dtype)[:, 0]
    onehot = segment_onehot(batch.node_graph, batch.n_graphs,
                            mask=batch.node_mask)
    gate = torch.where(batch.node_mask, gate.float(), -torch.inf)
    shift = torch.where(onehot != 0, gate[None, :], -torch.inf).amax(dim=1)
    shift = torch.where(torch.isneginf(shift), 0.0, shift)
    stages = {"gate": gate}
    e = torch.where(batch.node_mask, torch.exp(gate - shift @ onehot), 0.0)
    weighted = feat * e[:, None].to(feat.dtype)
    if how == "matmul":
        denom = onehot @ e
        sums = onehot @ weighted.float()
    elif how == "f64":
        denom = (onehot.double() @ e.double()).float()
        sums = (onehot.double() @ weighted.double()).float()
    else:
        sums, denom = segment_sum_rows(
            (weighted.float(), e), segment_sum_plan(
                batch.node_graph, batch.n_graphs, batch.node_mask,
                indices_are_sorted=batch.node_graph_sorted))
    denom = torch.where(denom > 0, denom, 1.0)
    stages.update(e=e, denom=denom)
    stages["pooled"] = (sums / denom[:, None]).to(feat.dtype)
    return stages


def _stages(model, batch, how="matmul"):
    cfg = model.config
    with torch.inference_mode():
        feat_embed = torch.cat([model.embeds[k](batch.node_feats[k])
                                for k in model.subkeys], dim=-1)
        out = {"embed": feat_embed}
        ggnn = model._message_pass(feat_embed, batch)
        out["message"] = ggnn
        pooled = _pool(model.pooling, torch.cat([ggnn, feat_embed], -1),
                       batch, how)
        out.update(pooled)
        x = pooled["pooled"].float()
        last = cfg.num_output_layers - 1
        for i in range(cfg.num_output_layers):
            x = model.head[f"output_{i}"](x)
            if i != last:
                x = torch.relu(x)
            out[f"head_{i}"] = x
        out["prob"] = torch.sigmoid(x[:, 0])
    return out


def _rows(stages, batch, slot):
    """Each stage's values for the graph in ``slot``: its node rows for
    node stages, its row for graph stages."""
    nodes = ((batch.node_graph.long() == slot) & batch.node_mask).nonzero()[
        :, 0]
    rows = {}
    for name, t in stages.items():
        if t.shape[0] == batch.node_graph.shape[0]:
            rows[name] = t[nodes]
        else:
            rows[name] = t[slot]
    return rows


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--impl", default="persistent")
    p.add_argument("--dtype", default="float32")
    p.add_argument("--out", default=None)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    model = FlowGNN(FlowGNNConfig(message_impl=args.impl, dtype=args.dtype),
                    device="cuda", seed=0)
    config = ServeConfig(batch_slots=8)
    graphs = [e.graph for e in bursty_trace(200, model.config.feature,
                                            seed=1)]
    single = ServeEngine(model, config, device="cuda")
    fleet = ServeFleet.build(model, config, n_replicas=2)
    logs = ({}, {})
    _record_flushes(single, logs[0])
    for r in fleet.replicas:
        _record_flushes(r.engine, logs[1])
    single.warmup()
    fleet.warmup()
    want = [r["prob"] for r in single.score_sync(graphs)]
    got = [r["prob"] for r in fleet.score_sync(graphs)]
    band = model.config.uses_band_adj
    subkeys = single.required_subkeys
    served = [(i, abs(a - b)) for i, (a, b) in enumerate(zip(got, want))
              if a != b]
    report = {"device": torch.cuda.get_device_name(0), "impl": args.impl,
              "dtype": args.dtype, "requests": len(graphs),
              "apart": len(served),
              "max_abs_diff": max([d for _, d in served], default=0.0),
              "pooling_sums": {}}
    ways = {how: {"apart": 0, "first_stage_apart": {}, "requests": []}
            for how in ("matmul", "rows", "f64")}
    for g in graphs:
        key = content_hash(single._normalize_graph(g))
        sides = [logs[0][key], logs[1][key]]
        for how, way in ways.items():
            a, b = [_rows(_stages(model, batch, how), batch, slot)
                    for batch, slot in (
                        (bucket_batch(config, gs, slots, subkeys,
                                      band=band).to("cuda"), slot)
                        for gs, slots, slot in sides)]
            if torch.equal(a["prob"], b["prob"]):
                continue
            first = next(name for name in a
                         if not torch.equal(a[name], b[name]))
            way["apart"] += 1
            way["first_stage_apart"][first] = way[
                "first_stage_apart"].get(first, 0) + 1
            way["requests"].append({
                "single": {"bucket": sides[0][1], "slot": sides[0][2]},
                "fleet": {"bucket": sides[1][1], "slot": sides[1][2]},
                "first_stage_apart": first})
    report["pooling_sums"] = ways
    line = json.dumps(report)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
