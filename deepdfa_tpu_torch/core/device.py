"""Device resolution (the port's counterpart of ``core/backend.py``).

The port's entry points run on the card. ``None`` means ``cuda``; a
machine without CUDA raises instead of moving the work to the CPU
behind the caller's back. The CPU runs only when asked for by name —
the tests do, and there every kernel wrapper takes its plain version.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None``/"cuda"/"cuda:N" -> that CUDA device (raises without
    CUDA); "cpu" -> the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested (the default) but CUDA is not "
            "available; pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    return dev
