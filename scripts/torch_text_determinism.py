"""Which reducing ops of the DeepDFA+LineVul and DeepDFA+CodeT5 train
steps repeat their bits on the card.

    python3 scripts/torch_text_determinism.py [--reps 8] [--out det.json]

Runs each op of the text train steps that reduces many values into one
``--reps`` times in one process on inputs at the steps' shapes (T 512,
batch 16, the token ids of ``synthetic:120``'s first training rows), by
default and once under ``torch.use_deterministic_algorithms(True)``: how
many distinct results each op gives, whether the mode changes its bits
or raises, and its median time (CUDA events).

- LineVul (codebert-base width): the three embedding tables' backward,
  LayerNorm's backward, the linears' products of every shape, the loss's
  gather backward.
- CodeT5 (codet5-base width, pad id 0): the shared embedding's backward
  over the encoder's ids and over the decoder's (``shift_right``; the
  upstream gradient is nonzero where the source mask is, as the loss
  reads it), the relative position bias table's backward over the
  [512, 512] bucket grid, the last-</s> gather's backward; and for the
  three, the fixed-order sum ``models/t5.py`` takes for the position
  bias table's gradient (the product with ``segment_onehot``'s one-hot
  matrix) beside ``index_put_(accumulate=True)``.

Prints the card's name and power limit, then one JSON object, the ops
table. Run it from the root of the checkout. Needs one CUDA device;
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys


def _ops(reps: int) -> dict:
    """Each candidate op ``reps`` times by default, once under
    deterministic mode: the distinct output digests of each."""
    import torch
    import torch.nn.functional as F

    sys.path.insert(0, os.getcwd())
    from deepdfa_tpu_torch.core.config import FeatureSpec
    from deepdfa_tpu_torch.data.combined import load_combined_dataset
    from deepdfa_tpu_torch.data.text import HashingCodeTokenizer

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    data, splits, _ = load_combined_dataset(
        "synthetic:120", FeatureSpec(), HashingCodeTokenizer(50265), 512,
        seed=1)
    ids = torch.from_numpy(data["input_ids"][splits["train"][:16]]).long()
    ids = ids.to(dev)
    mask = (ids != 1).long()
    positions = torch.clamp(torch.cumsum(mask, 1) * mask + 1, max=513)
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=g)

    # Upstream gradients vanish on padded tokens, as the loss's do.
    grad_x = randn(16, 512, 768) * mask[..., None]
    x = randn(16, 512, 768)
    ln = torch.nn.LayerNorm(768).to(dev)
    flat = randn(8192, 768)
    wide = randn(8192, 3072)
    logits = randn(16, 2)
    labels = torch.randint(0, 2, (16,), device=dev, generator=g)

    def embedding_backward(table_rows, index):
        def run():
            table = torch.zeros(table_rows, 768, device=dev,
                                requires_grad=True)
            F.embedding(index, table).backward(grad_x)
            return [table.grad]
        return run

    def layernorm_backward():
        xi = x.clone().requires_grad_(True)
        ln.zero_grad()
        ln(xi).backward(grad_x)
        return [xi.grad, ln.weight.grad, ln.bias.grad]

    def linear_backward(inp, n_out):
        w = (randn(n_out, inp.shape[1]) * inp.shape[1] ** -0.5
             ).requires_grad_(True)
        gout = randn(inp.shape[0], n_out)

        def run():
            xi = inp.clone().requires_grad_(True)
            w.grad = None
            F.linear(xi, w).backward(gout)
            return [xi.grad, w.grad]
        return run

    def loss_backward():
        li = logits.clone().requires_grad_(True)
        picked = torch.log_softmax(li, -1).gather(1, labels[:, None])
        (-picked.sum()).backward()
        return [li.grad]

    ops = {
        "embedding_backward_word": embedding_backward(50265, ids),
        "embedding_backward_position": embedding_backward(514, positions),
        "embedding_backward_token_type": embedding_backward(
            1, torch.zeros_like(ids)),
        "layernorm_backward": layernorm_backward,
        "linear_backward_768_768": linear_backward(flat, 768),
        "linear_backward_768_3072": linear_backward(flat, 3072),
        "linear_backward_3072_768": linear_backward(wide, 768),
        "loss_gather_backward": loss_backward,
    }

    ops.update(_t5_ops(dev, randn, g))

    def digest(tensors):
        torch.cuda.synchronize()
        h = hashlib.sha256()
        for t in tensors:
            h.update(t.detach().cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    def median_ms(run):
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return sorted(times)[len(times) // 2]

    table = {}
    for name, run in ops.items():
        default = [digest(run()) for _ in range(reps)]
        ms = median_ms(run)
        torch.use_deterministic_algorithms(True)
        try:
            det = digest(run())
        except RuntimeError as e:
            det = "raises: " + str(e).splitlines()[0][:200]
        finally:
            torch.use_deterministic_algorithms(False)
        table[name] = {"default_distinct": len(set(default)),
                       "deterministic_same_as_default": det in default,
                       "deterministic": det, "ms": ms}
    return table


def _t5_ops(dev, randn, g) -> dict:
    """The CodeT5 step's reducing ops at codet5-base width (see the
    module docstring), each a callable returning its gradients."""
    import torch
    import torch.nn.functional as F

    from deepdfa_tpu_torch.core.config import FeatureSpec
    from deepdfa_tpu_torch.data.combined import load_combined_dataset
    from deepdfa_tpu_torch.data.text import HashingT5Tokenizer
    from deepdfa_tpu_torch.graphs.segment import segment_onehot
    from deepdfa_tpu_torch.models import t5

    cfg = t5.T5Config.codet5_base()
    data, splits, _ = load_combined_dataset(
        "synthetic:120", FeatureSpec(), HashingT5Tokenizer(cfg.vocab_size),
        512, style="t5", seed=1)
    ids = torch.from_numpy(data["input_ids"][splits["train"][:16]]).long()
    ids = ids.to(dev)
    mask = ids != cfg.pad_token_id
    dec = t5.shift_right(ids, cfg.decoder_start_token_id)
    grad = randn(16, 512, cfg.d_model) * mask[..., None]
    buckets = t5._bucket_grid(512, 512, True, 32, 128, dev)
    grad_bias = randn(512, 512, cfg.num_heads)
    hidden = randn(16, 512, cfg.d_model)
    grad_vec = randn(16, cfg.d_model)

    def embedding_backward(rows, index, upstream, how):
        def run():
            table = torch.zeros(rows, upstream.shape[-1], device=dev,
                                requires_grad=True)
            if how == "F.embedding":
                F.embedding(index, table).backward(upstream)
                return [table.grad]
            flat = upstream.reshape(-1, upstream.shape[-1])
            if how == "index_put_":
                out = torch.zeros(rows, flat.shape[1], device=dev)
                return [out.index_put_((index.reshape(-1),), flat,
                                       accumulate=True)]
            return [segment_onehot(index.reshape(-1), rows) @ flat]
        return run

    def eos_gather_backward():
        h = hidden.clone().requires_grad_(True)
        t5.last_eos_vector(h, ids, cfg.eos_token_id).backward(grad_vec)
        return [h.grad]

    ops = {}
    for how in ("F.embedding", "index_put_", "segment_onehot"):
        tag = how.replace(".", "_").rstrip("_")
        ops[f"t5_shared_encoder_{tag}"] = embedding_backward(
            cfg.vocab_size, ids, grad, how)
        ops[f"t5_shared_decoder_{tag}"] = embedding_backward(
            cfg.vocab_size, dec, grad, how)
        ops[f"t5_position_bias_{tag}"] = embedding_backward(
            cfg.relative_attention_num_buckets, buckets, grad_bias, how)
    ops["t5_eos_gather_backward"] = eos_gather_backward
    return ops


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--reps", type=int, default=8,
                   help="repetitions of each op")
    p.add_argument("--out", default=None)
    args = p.parse_args()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    report = {"gpu": smi, "ops": _ops(args.reps)}
    print(json.dumps(report), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
