"""Train/val/test partitioning (copy of ``deepdfa_tpu/data/splits.py``).

Split modes: "fixed" (an id->partition table), "random" (80/10/10,
seed-deterministic) and "cross-project" (no project spans splits). The
numpy RNG streams are the reference's, so a seed gives the same indices
in both packages (tests/test_torch_train.py).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np


def make_splits(
    examples: Sequence[Mapping],
    mode: str = "random",
    seed: int = 0,
    fixed: Optional[Mapping[int, str]] = None,
    fractions=(0.8, 0.1, 0.1),
) -> Dict[str, np.ndarray]:
    """Return {"train": idx[], "val": idx[], "test": idx[]} into ``examples``."""
    n = len(examples)
    if mode == "fixed":
        if fixed is None:
            raise ValueError("fixed split requires an id->partition mapping")
        out = {"train": [], "val": [], "test": []}
        for i, ex in enumerate(examples):
            part = fixed.get(int(ex["id"]))
            if part in out:
                out[part].append(i)
        return {k: np.asarray(v, np.int64) for k, v in out.items()}

    if mode == "random":
        rng = np.random.default_rng(seed)
        perm = rng.permutation(n)
        n_train = int(n * fractions[0])
        n_val = int(n * fractions[1])
        return {
            "train": perm[:n_train],
            "val": perm[n_train: n_train + n_val],
            "test": perm[n_train + n_val:],
        }

    if mode == "cross-project":
        rng = np.random.default_rng(seed)
        projects = sorted({str(ex.get("project", "")) for ex in examples})
        if len(projects) < 3:
            raise ValueError(
                f"cross-project split needs >= 3 distinct projects, "
                f"got {projects!r}")
        perm = rng.permutation(len(projects))
        projects = [projects[i] for i in perm]
        # Every partition keeps >= 1 project.
        n_train = max(1, min(int(len(projects) * fractions[0]),
                             len(projects) - 2))
        n_val = max(1, min(int(len(projects) * fractions[1]),
                           len(projects) - n_train - 1))
        train_p = set(projects[:n_train])
        val_p = set(projects[n_train: n_train + n_val])
        out = {"train": [], "val": [], "test": []}
        for i, ex in enumerate(examples):
            p = str(ex.get("project", ""))
            key = ("train" if p in train_p
                   else ("val" if p in val_p else "test"))
            out[key].append(i)
        return {k: np.asarray(v, np.int64) for k, v in out.items()}

    raise ValueError(f"unknown split mode: {mode}")


def assert_no_leakage(splits: Mapping[str, np.ndarray]) -> None:
    """No example in two partitions."""
    train = set(splits["train"].tolist())
    val = set(splits["val"].tolist())
    test = set(splits["test"].tolist())
    assert not (train & val), "train/val leakage"
    assert not (train & test), "train/test leakage"
    assert not (val & test), "val/test leakage"
