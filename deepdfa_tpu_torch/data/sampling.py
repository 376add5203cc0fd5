"""Per-epoch class rebalancing (copy of ``deepdfa_tpu/data/sampling.py``).

Every epoch keeps all positives and draws ``factor * n_positive``
negatives without replacement from a fresh numpy RNG seeded by
``(seed, epoch)``; oversampling draws positives with replacement. The
same stream as the reference, so the indices agree byte for byte.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def epoch_indices(
    labels: Sequence[int],
    epoch: int,
    seed: int = 0,
    undersample_factor: Optional[float] = 1.0,
    oversample_factor: Optional[float] = None,
    shuffle: bool = True,
) -> np.ndarray:
    labels = np.asarray(labels)
    idx = np.arange(len(labels))
    rng = np.random.default_rng((seed, epoch))
    if undersample_factor is None and oversample_factor is None:
        return rng.permutation(idx) if shuffle else idx
    pos = idx[labels == 1]
    neg = idx[labels == 0]
    if undersample_factor is not None:
        k = min(len(neg), int(len(pos) * undersample_factor))
        neg = rng.choice(neg, size=k, replace=False)
    if oversample_factor is not None:
        pos = rng.choice(pos, size=int(len(pos) * oversample_factor),
                         replace=True)
    out = np.concatenate([pos, neg])
    return rng.permutation(out) if shuffle else np.sort(out)
