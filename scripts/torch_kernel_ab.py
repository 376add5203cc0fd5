"""Time the port's GNN, tile SpMM and flash-attention kernels of two
checkouts on one card, in turns.

    python3 scripts/torch_kernel_ab.py OLD_DIR NEW_DIR [--out FILE]

Each checkout's own ``chip_smoke.py`` runs its device, build, ``kernels``
(the two GNN forward kernels at the serving and flagship shapes),
``kernels_bf16`` (their bf16 instances there, bf16 band values, and f32
ones at serving), ``train_kernels`` (the GNN kernels at the training
shape, the persistent
pair and the weight pass ``step_weight_grad_kernel`` among them),
``tile_kernels``, ``attention_kernels``, ``attention_kernels_bf16``
(the flash kernels' bf16 instances) and ``train_kernels_bf16`` (the GNN
backward's bf16 instances, the bf16 weight pass and the bf16 tile product
at the training shape, each beside the f32 kernel on the widened inputs)
phases in a process of its own, in
the order OLD, NEW, NEW, OLD, so that a drift of the card or its
host over the call shows as a gap between the two runs of one checkout.
Prints one JSON object: for each checkout and run, each kernel's
``kernel_ms``, ``plain_ms``, ``library_ms``, ``scan_ms`` (a persistent
kernel's per-step scan, where the checkout times it) and bound at each
shape (and over A and A^T for the tile product), and the card's name and
power limit; whether the fused flash backward gave the same output bits
in every run (``fused_bits_equal``), whether the flash forward's output
and lse did in the two runs of each checkout (``fwd_bits_equal``: each
run hashes them on chip_smoke's seeded T 512 inputs), the same at bf16
across the checkouts (``fused_bits_equal_bf16``, ``fwd_bits_equal_bf16``)
and within each (``*_bits_repeat_bf16``), and whether
``fused_step_kernel``'s output and ``fused_step_bwd_kernel``'s four
outputs on the training batch hashed equal in every run of both
checkouts (``gnn_step_bits_equal``). On the training batch at bf16 (h
the model's embeddings rounded, a seeded bf16 cotangent): the bf16
forward instances' outputs (``fused_step_kernel_bf16``'s,
``persistent_fwd_kernel_bf16``'s over 5 steps and its hist instance's),
expected to repeat within each checkout (``gnn_fwd_bits_repeat_bf16``)
and to equal across them, against a checkout from before their
tensor-core redesign too (``gnn_fwd_bits_equal_bf16``); and the bf16 backward
instances' and the bf16 weight pass's (``fused_step_bwd_kernel_bf16``'s
four outputs, ``persistent_bwd_kernel_bf16``'s over 5 steps on the plain
version's h_1..h_4), the same inputs in both checkouts, expected equal
across them (``gnn_bwd_bits_equal_bf16``) and to repeat within each
(``gnn_bwd_bits_repeat_bf16``); ``step_weight_grad_kernel_bf16``'s
gradients of those (``wgrad_bits_*_bf16``: against a checkout from
before its tensor-core redesign not equal, its sums in another order,
but repeating within each) and ``tile_spmm_kernel_bf16``'s output over A
and A^T on the tile lane's training lists (``tile_bits_*_bf16``, expected
equal and repeating: its sums keep their order). The ordered segment sums
as each checkout's callers make them at the serving bucket
(``segment_callers``: the pooling's forward where no gradient flows, and
the segment lane's message pass at f32 and bf16, device ms) and their
output bits, expected equal across the checkouts
(``segment_bits_equal``). Needs one NVIDIA GPU;
the checkouts build their kernels into their own trees.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

PHASES = ("import chip_smoke as cs; cs.phase_device(); cs.phase_build(); "
          "model = cs.FlowGNN(cs.FlowGNNConfig(message_impl='persistent'), "
          "device='cuda', seed=cs.SEED); cs.phase_kernels(model); "
          "cs.phase_kernels_bf16(model); "
          "cs.phase_train_kernels(model); "
          "cs.phase_tile_kernels(); cs.phase_attention_kernels(); "
          "cs.phase_attention_kernels(cs.torch.bfloat16); "
          "cs.phase_train_kernels_bf16(model); "
          # The fused flash backward's output bits, and the forward's, on
          # chip_smoke's seeded T 512 inputs.
          "import hashlib, torch; A = cs.attention; F = cs.fused_gnn; "
          "sha = lambda xs: hashlib.sha256(b''.join(x.cpu().contiguous()"
          ".view(torch.uint8).numpy().tobytes() for x in xs)).hexdigest(); "
          "q, k, v, m, g = cs._attn_inputs(cs.ATTN_TRAIN_SHAPE, cs.SEED); "
          "o, lse = A.flash_fwd_reference(q, k, v, m); "
          "out = A.flash_bwd_fused(q, k, v, m, g, lse, A.flash_delta(o, g)); "
          "cs.emit(phase='fused_bits', sha256=sha(out)); "
          "cs.emit(phase='fwd_bits', sha256=sha(A.flash_fwd(q, k, v, m))); "
          # The same at bf16.
          "q, k, v, g = (x.bfloat16() for x in (q, k, v, g)); "
          "o, lse = A.flash_fwd_reference(q, k, v, m); "
          "out = A.flash_bwd_fused(q, k, v, m, g, lse, A.flash_delta(o, g)); "
          "cs.emit(phase='fused_bits_bf16', sha256=sha(out)); "
          "cs.emit(phase='fwd_bits_bf16', sha256=sha(A.flash_fwd(q, k, v, "
          "m))); "
          # fused_step_kernel's and fused_step_bwd_kernel's outputs on the
          # training batch (embeddings of the seeded model, a seeded
          # cotangent).
          "torch.set_grad_enabled(False); "
          "b = cs._training_batch(model); adj = b.band_adj; "
          "h = torch.cat([model.embeds[s](b.node_feats[s]) "
          "for s in model.subkeys], dim=-1).detach().contiguous(); "
          "p = model.ggnn_step.step_params(); "
          "gn = torch.Generator(device='cuda').manual_seed(cs.SEED); "
          "gc = torch.randn(h.shape, generator=gn, device='cuda'); "
          "cs.emit(phase='gnn_step_bits', sha256=sha("
          "[F.fused_gate_step(p, h, adj)] + list(F.fused_step_bwd_rows("
          "p, h, adj, gc)))); "
          # At bf16: the forward instances, then the backward instances.
          "hb, gb = h.bfloat16(), gc.bfloat16(); "
          "hist = F.persistent_hist(p, hb, adj, 5); "
          "cs.emit(phase='gnn_fwd_bits_bf16', sha256=sha("
          "[F.fused_gate_step(p, hb, adj), F.persistent_unroll(p, hb, adj, "
          "5), hist])); "
          # The backward on the plain version's states: the same inputs
          # in both checkouts.
          "hp = F.persistent_hist_reference(p, hb, adj, 5); "
          "rows = F.persistent_bwd_rows(p, hb, hp, adj, gb, 5); "
          "cs.emit(phase='gnn_bwd_bits_bf16', sha256=sha("
          "list(F.fused_step_bwd_rows(p, hb, adj, gb)) + list(rows))); "
          # The bf16 weight pass on those rows, apart: its redesign sums
          # in another order.
          "cs.emit(phase='wgrad_bits_bf16', sha256=sha(list("
          "F.step_weight_grads(hb, hp, *rows[1:], 5, F.msg_dtype(adj, "
          "torch.bfloat16))))); "
          # The bf16 tile product over A and A^T on the tile lane's
          # training lists and a seeded bf16 msg.
          "tm = cs.FlowGNN(cs.FlowGNNConfig(message_impl='tile'), "
          "device='cpu'); "
          "tl = cs._training_batch(tm, device='cpu').tile_adj.to('cuda'); "
          "mb = torch.randn(hb.shape, generator=gn, device='cuda')"
          ".bfloat16(); "
          "cs.emit(phase='tile_bits_bf16', sha256=sha(["
          "cs.tile_spmm.tile_spmm(tl, mb), "
          "cs.tile_spmm.tile_spmm(tl.transposed(), mb)])); "
          # The segment sums as each checkout's callers make them, at the
          # serving bucket: the pooling's forward (its per-graph sums on
          # the card where no gradient flows) and the segment lane's
          # message pass (five aggregates), f32 and bf16.
          "import inspect; sb = cs._serving_batch(model); "
          "pf = torch.randn((sb.max_nodes, model.config.out_dim), "
          "generator=gn, device='cuda'); "
          "pkw = {'node_graph_sorted': sb.node_graph_sorted} if "
          "'node_graph_sorted' in inspect.signature("
          "model.pooling.forward).parameters else {}; "
          "pool = lambda: model.pooling(pf, sb.node_graph, sb.node_mask, "
          "sb.n_graphs, **pkw); "
          "sms = {dt: cs.FlowGNN(cs.FlowGNNConfig(message_impl='segment', "
          "dtype=dt), device='cuda', seed=cs.SEED) "
          "for dt in ('float32', 'bfloat16')}; "
          "sh = {dt: torch.cat([m.embeds[s](sb.node_feats[s]) "
          "for s in m.subkeys], dim=-1) for dt, m in sms.items()}; "
          "mp = {dt: (lambda m=m, x=sh[dt]: m._message_pass(x, sb)) "
          "for dt, m in sms.items()}; "
          "cs.emit(phase='segment_bits', sha256=sha([pool()] + "
          "[f() for f in mp.values()])); "
          "cs.emit(phase='segment_callers', pooling_ms=cs._time_ms(pool), "
          "**{f'message_pass_{dt}_ms': cs._time_ms(f) "
          "for dt, f in mp.items()})")
KEYS = ("kernel_ms", "plain_ms", "library_ms", "scan_ms", "bound_us",
        "max_abs_err", "blocks_per_sm", "cluster", "active_clusters",
        "f32_kernel_ms", "elements_differing", "smem_bytes",
        "smem_bytes_pass1", "smem_bytes_pass2", "blocks_per_sm_pass1",
        "blocks_per_sm_pass2", "one_step_ms", "transpose_ms", "cols",
        "mode", "floor_ms", "plan_given_ms", "plan_ms")


def run(checkout: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", PHASES], cwd=checkout,
                          capture_output=True, text=True, timeout=1200)
    if proc.returncode != 0:
        raise RuntimeError(f"{checkout}: exit {proc.returncode}\n"
                           f"{proc.stderr[-4000:]}")
    out = {}
    for line in proc.stdout.splitlines():
        if not line.startswith("{"):
            continue
        rec = json.loads(line)
        if rec.get("phase") == "device":
            out["device"] = rec["device"]
        elif rec.get("phase") in ("fused_bits", "fwd_bits",
                                  "fused_bits_bf16", "fwd_bits_bf16",
                                  "gnn_step_bits", "gnn_fwd_bits_bf16",
                                  "gnn_bwd_bits_bf16", "wgrad_bits_bf16",
                                  "tile_bits_bf16", "segment_bits"):
            out[f"{rec['phase']}_sha256"] = rec["sha256"]
        elif rec.get("phase") == "segment_callers":
            out["segment_callers"] = {k: v for k, v in rec.items()
                                      if k != "phase"}
        elif rec.get("phase") in ("kernels", "kernels_bf16", "train_kernels",
                                  "tile_kernels", "attention_kernels",
                                  "attention_kernels_bf16",
                                  "train_kernels_bf16"):
            where = rec.get("over") or rec.get("shape")
            if rec.get("band_vals"):  # train_kernels_bf16: by band values
                where = f"{where or 'training'}/{rec['band_vals']}_vals"
            out[f"{rec['kernel']}@{where}"] = {k: rec.get(k) for k in KEYS}
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
    runs = []
    for label in ("old", "new", "new", "old"):
        checkout = os.path.abspath(getattr(args, label))
        runs.append({"checkout": label, **run(checkout)})

    def hashes(key, label=None):
        return {run[key + "_sha256"] for run in runs
                if label in (None, run["checkout"])}

    result = {"nvidia_smi": smi, "runs": runs,
              "fused_bits_equal": len(hashes("fused_bits")) == 1,
              "fwd_bits_equal": {label: len(hashes("fwd_bits", label)) == 1
                                 for label in ("old", "new")},
              "fused_bits_equal_bf16": len(hashes("fused_bits_bf16")) == 1,
              "fwd_bits_equal_bf16": len(hashes("fwd_bits_bf16")) == 1,
              **{f"{key}_repeat_bf16": {
                  label: len(hashes(key, label)) == 1
                  for label in ("old", "new")}
                 for key in ("fused_bits_bf16", "fwd_bits_bf16")},
              # Against a checkout from before the bf16 weight pass's
              # tensor-core redesign: every other kernel keeps its bits on
              # the same inputs (the GNN forward's tensor-core sums round
              # as the reference's FMA chain does, as the SIMT design's
              # did); each checkout repeats its own.
              "expected": {"fused_bits_equal": True,
                           "fused_bits_equal_bf16": True,
                           "fwd_bits_equal_bf16": True,
                           "repeat_bf16": True,
                           "gnn_fwd_bits_equal_bf16": True,
                           "gnn_fwd_bits_repeat_bf16": True,
                           "gnn_bwd_bits_equal_bf16": True,
                           "gnn_bwd_bits_repeat_bf16": True,
                           # The bf16 weight pass's tensor-core sums take
                           # another order than the TF32 design's (within
                           # GRAD_TOL of the plain version, checked in the
                           # runs); each checkout repeats its own. The
                           # tile product's sums keep their order.
                           "wgrad_bits_equal_bf16": False,
                           "wgrad_bits_repeat_bf16": True,
                           "tile_bits_equal_bf16": True,
                           "tile_bits_repeat_bf16": True,
                           # The segment sums add each bucket's rows in
                           # row order in every design.
                           "segment_bits_equal": True},
              "gnn_step_bits_equal": len({run["gnn_step_bits_sha256"]
                                          for run in runs}) == 1,
              "gnn_fwd_bits_equal_bf16": len(hashes("gnn_fwd_bits_bf16"))
              == 1,
              "gnn_bwd_bits_equal_bf16": len(hashes("gnn_bwd_bits_bf16"))
              == 1,
              "wgrad_bits_equal_bf16": len(hashes("wgrad_bits_bf16")) == 1,
              "tile_bits_equal_bf16": len(hashes("tile_bits_bf16")) == 1,
              "segment_bits_equal": len(hashes("segment_bits")) == 1,
              **{f"{key}_repeat_bf16": {
                  label: len(hashes(f"{key}_bf16", label)) == 1
                  for label in ("old", "new")}
                 for key in ("gnn_fwd_bits", "gnn_bwd_bits", "wgrad_bits",
                             "tile_bits")}}
    text = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
