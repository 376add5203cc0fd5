"""Deterministic synthetic Big-Vul-like graphs (port of
``deepdfa_tpu/data/synthetic.py``).

The generator draws from the same ``np.random.default_rng`` stream in
the same order as the reference, so one seed gives byte-identical graphs
in both packages (tests/test_torch_batch.py). Graphs have 8-48 nodes,
mostly-linear control flow with a few branch/back edges, and a planted
taint -> sink chain on the ``api`` subkey in the positives.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from deepdfa_tpu_torch.core.config import ALL_SUBKEYS, FeatureSpec


def synthetic_bigvul(
    num_examples: int = 200,
    feature: FeatureSpec = FeatureSpec(),
    positive_fraction: float = 0.5,
    seed: int = 0,
    min_nodes: int = 8,
    max_nodes: int = 48,
) -> List[Dict]:
    """A list of graph dicts compatible with ``batch_graphs``."""
    rng = np.random.default_rng(seed)
    vocab = feature.input_dim
    taint = 2
    sink = 3

    out: List[Dict] = []
    for i in range(num_examples):
        vul = int(rng.random() < positive_fraction)
        n = int(rng.integers(min_nodes, max_nodes + 1))
        senders = list(range(n - 1))
        receivers = list(range(1, n))
        for _ in range(max(1, n // 8)):
            a, b = rng.integers(0, n, size=2)
            if a != b:
                senders.append(int(a))
                receivers.append(int(b))
        feats = {
            k: rng.integers(4, vocab, size=n).astype(np.int64)
            for k in ALL_SUBKEYS
        }
        # ~40% non-definitions (0 on every subkey); a few UNKNOWN (1).
        nondef = rng.random(n) < 0.4
        for k in ALL_SUBKEYS:
            feats[k][nondef] = 0
            feats[k][(rng.random(n) < 0.05) & ~nondef] = 1

        node_vuln = np.zeros(n, np.int32)
        if vul:
            chain = rng.choice(n - 3, size=1)[0]
            chain_nodes = [chain, chain + 1, chain + 2]
            feats["api"][chain_nodes[0]] = taint
            feats["api"][chain_nodes[1]] = taint
            feats["api"][chain_nodes[2]] = sink
            node_vuln[chain_nodes] = 1
        else:
            if n >= 6 and rng.random() < 0.7:
                feats["api"][0] = taint
                feats["api"][n - 1] = sink

        # A node nonzero on ANY subkey is a definition: its other subkeys
        # read UNKNOWN (1), never 0.
        is_def = np.zeros(n, bool)
        for k in ALL_SUBKEYS:
            is_def |= feats[k] != 0
        for k in ALL_SUBKEYS:
            feats[k][is_def & (feats[k] == 0)] = 1

        s_arr = np.asarray(senders, np.int32)
        r_arr = np.asarray(receivers, np.int32)

        # Kill-free reaching definitions over the CFG.
        df_in = np.zeros(n, bool)
        df_out = is_def.copy()
        for _ in range(n):
            new_in = df_in.copy()
            np.logical_or.at(new_in, r_arr, df_out[s_arr])
            new_out = is_def | new_in
            if np.array_equal(new_in, df_in) and np.array_equal(new_out, df_out):
                break
            df_in, df_out = new_in, new_out

        out.append(
            {
                "id": i,
                "num_nodes": n,
                "senders": s_arr,
                "receivers": r_arr,
                "vuln": node_vuln,
                "feats": feats,
                "label": vul,
                "df_in": df_in.astype(np.int32),
                "df_out": df_out.astype(np.int32),
                "project": int(rng.integers(0, 10)),
            }
        )
    return out
