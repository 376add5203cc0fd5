"""chip_smoke.py's bf16 training phases alone, in one young process.

    python3 scripts/torch_train_bf16_phases.py     # from the repository root

Builds the kernels, then runs ``train_kernels_bf16`` (the bf16 backward
instances and tile product at the training shape against their plain
versions, the weight pass's 5 steps bit for bit the fold of one-step
calls, the persistent sweeps bit for bit the per-step scans, each timed
beside its bound, plain version, f32 kernel and library call), the f32
persistent and fused train lanes (the base of the bf16 lanes' device
ms), ``train_bf16`` (``fit`` at bf16 on the persistent, fused, tile and
band lanes against the CPU, each step's device ms by kernel) and
``fit_text_bf16_graph`` (DeepDFA+LineVul with a bf16 graph encoder on
the persistent lane against the CPU), as chip_smoke.py runs them;
chip_smoke's JSON records on stdout, then each phase's seconds. About 3
minutes with the build. Needs one NVIDIA GPU.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.getcwd())
import chip_smoke as C  # noqa: E402
from deepdfa_tpu_torch.core.config import FlowGNNConfig  # noqa: E402
from deepdfa_tpu_torch.models.flowgnn import FlowGNN  # noqa: E402


def main() -> int:
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    timed("device", C.phase_device)
    timed("build", C.phase_build)
    model = FlowGNN(FlowGNNConfig(message_impl="persistent"), device="cuda",
                    seed=C.SEED)
    timed("train_kernels_bf16", C.phase_train_kernels_bf16, model)
    f32 = {}
    for impl in ("persistent", "fused"):
        rec = timed(f"train_{impl}", C.phase_train, impl)
        f32[impl] = dict(device_busy_ms=rec["step_profile"]["device_busy_ms"],
                         graphs_per_s=rec["graphs_per_s"])
    timed("train_bf16", C.phase_train_bf16, f32)
    timed("fit_text_bf16_graph", C.phase_fit_text_bf16_graph)
    print(json.dumps({"seconds": seconds}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
