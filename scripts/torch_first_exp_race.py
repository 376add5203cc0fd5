"""Count how often the first forward of a fresh process disagrees with the
second, on the CPU, at a given number of torch intra-op threads.

    python3 scripts/torch_first_exp_race.py [--runs 400] [--threads 1 2]
                                            [--workers 8]

Each run is a process of its own: the port's tiny RoBERTa encoder (random
weights from seed 0, ``attention_impl="flash"``, whose plain attention
takes ``torch.exp`` of scores masked at NEG_INF) runs the same batch twice
and reports whether the two outputs are the same bits, and the largest
difference. A run that disagrees shows MKL's ``vmsExp`` racing on its
first use across threads (see ``tests/test_torch_linevul.py``,
``_one_thread``). Prints one JSON object: per thread count, the runs, the
runs that disagreed and their largest difference. Needs no GPU and no
JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RUN = r"""
import dataclasses, json, sys
import numpy as np, torch
torch.set_num_threads(int(sys.argv[1]))
from deepdfa_tpu_torch.models import transformer
cfg = dataclasses.replace(transformer.EncoderConfig.tiny(vocab_size=512),
                          attention_impl="flash")
enc = transformer.RobertaEncoder(cfg, torch.Generator().manual_seed(0))
rng = np.random.default_rng(0)
ids = rng.integers(4, 512, size=(4, 24))
ids[:, 0] = 0
for row, n in enumerate(rng.integers(12, 24, size=4)):
    ids[row, n:] = 1
ids = torch.from_numpy(ids)
first, second = enc(ids)[0].detach(), enc(ids)[0].detach()
print(json.dumps({"same": bool(torch.equal(first, second)),
                  "max_diff": float((first - second).abs().max())}))
"""


def one(threads: int) -> dict:
    out = subprocess.run([sys.executable, "-c", RUN, str(threads)], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise RuntimeError(out.stderr[-2000:])
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=400)
    ap.add_argument("--threads", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--workers", type=int, default=8)
    args = ap.parse_args()
    result = {}
    for threads in args.threads:
        with ThreadPoolExecutor(args.workers) as pool:
            runs = list(pool.map(one, [threads] * args.runs))
        bad = [r["max_diff"] for r in runs if not r["same"]]
        result[f"threads_{threads}"] = {"runs": len(runs),
                                        "disagreed": len(bad),
                                        "max_diff": max(bad, default=0.0)}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
