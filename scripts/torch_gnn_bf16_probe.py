"""The GNN forward kernels' bf16 instances at the serving, flagship and
training shapes, against their plain versions and each other, timed
beside the f32 kernels on the same inputs.

    python3 scripts/torch_gnn_bf16_probe.py     # from the repository root

Builds the kernels (printing ptxas's register and spill lines), then for
each shape (chip_smoke.py's serving bucket, flagship batch and training
batch, the published FlowGNN at seed 0) and for bf16 and f32 band values
prints one JSON line: ``fused_step_kernel_bf16`` against its plain
version (``step``: elements that differ, largest difference), five of
its launches against five plain steps (``scan5_vs_plain``),
``persistent_fwd_kernel_bf16`` against that scan bit for bit
(``pers_eq_scan``) and against its plain version, its cluster size and
occupancy, the per-step instance's launch geometry, and the times (CUDA
events, ``chip_smoke._time_ms``) of both instances, their f32 kernels on
the widened inputs and the plain step. Needs one NVIDIA GPU.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as C  # noqa: E402
from deepdfa_tpu_torch.core.config import FlowGNNConfig  # noqa: E402
from deepdfa_tpu_torch.models.flowgnn import FlowGNN  # noqa: E402
from deepdfa_tpu_torch.ops import _build, fused_gnn as F  # noqa: E402


def stats(got, want) -> dict:
    g, w = got.float(), want.float()
    d = (g - w).abs()
    ulp = d / w.abs().clamp_min(1e-30)
    return dict(neq=int((g != w).sum()), n=g.numel(), max_abs=float(d.max()),
                max_rel_nonzero=float(ulp[w != 0].max())
                if bool((w != 0).any()) else 0.0,
                over=int((d > 2 ** -7 * w.abs() + 1e-6).sum()))


def main() -> None:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    t0 = time.time()
    info = _build.build_all()
    print("build s", time.time() - t0)
    for line in info["fused_gnn"][1].splitlines():
        if "bf16" in line or "registers" in line or "spill" in line:
            print(line.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    model = FlowGNN(FlowGNNConfig(message_impl="persistent"), device="cuda",
                    seed=0)
    params = model.ggnn_step.step_params()
    p16 = F.packed_weights(params, torch.bfloat16)
    p32 = F.packed_weights(params)
    with torch.inference_mode():
        for shape, batch in (("serving", C._serving_batch(model)),
                             ("flagship", C._flagship_batch(model)),
                             ("training", C._training_batch(model))):
            adj0 = batch.band_adj
            h32 = torch.cat([model.embeds[k](batch.node_feats[k])
                             for k in model.subkeys], -1).contiguous()
            h = h32.bfloat16()
            for vals in ("bf16", "f32"):
                adj = adj0 if vals == "bf16" else dataclasses.replace(
                    adj0, vals=adj0.vals.float())
                r = {}
                step = F.fused_gate_step(params, h, adj, packed=p16)
                r["step"] = stats(step, F.fused_step_reference(params, h,
                                                               adj))
                scan = h
                for _ in range(5):
                    scan = F.fused_gate_step(params, scan, adj, packed=p16)
                # x as the kernels compute it (the bf16 backward's pass 1
                # runs the forward's device functions) against the plain
                # version's x.
                x = F.fused_step_bwd_rows(params, h, adj, h, packed=p16)[1]
                r["x"] = stats(x, F._gates_bf16(p16, h, adj)[0])
                r["scan5_vs_plain"] = stats(scan, F.persistent_reference(
                    params, h, adj, 5))
                if F.persistent_smem_ok(adj, 128, torch.bfloat16):
                    pers = F.persistent_unroll(params, h, adj, 5, packed=p16)
                    torch.cuda.synchronize()
                    r["pers_eq_scan"] = bool(torch.equal(pers, scan))
                    r["pers_vs_plain"] = stats(pers, F.persistent_reference(
                        params, h, adj, 5))
                    sms = torch.cuda.get_device_properties(
                        0).multi_processor_count
                    cl = F.persistent_cluster_size(adj, 128, sms,
                                                   torch.bfloat16)
                    r["cluster"] = cl
                    r["occ"] = F.persistent_occupancy(
                        adj, 128, "persistent_fwd_kernel_bf16", cl)
                    r["pers_ms"] = C._time_ms(lambda: F.persistent_unroll(
                        params, h, adj, 5, packed=p16))
                    r["pers32_ms"] = C._time_ms(lambda: F.persistent_unroll(
                        params, h32, adj, 5, packed=p32))
                r["geo"] = F.step_geometry(adj, 128, "fused_step_kernel_bf16")
                r["step_ms"] = C._time_ms(lambda: F.fused_gate_step(
                    params, h, adj, packed=p16))
                r["step32_ms"] = C._time_ms(lambda: F.fused_gate_step(
                    params, h32, adj, packed=p32))
                r["plain_step_ms"] = C._time_ms(
                    lambda: F.fused_step_reference(params, h, adj))
                print(shape, vals, json.dumps(r), flush=True)
    print("counts", F.launch_counts())


if __name__ == "__main__":
    main()
