"""Carry FlowGNN parameters from the JAX package into the port.

``flowgnn_from_flax`` maps a flax FlowGNN parameter tree (nested dicts
of numpy-convertible arrays, with or without the outer ``"params"``) to
a ``state_dict`` of :class:`deepdfa_tpu_torch.models.flowgnn.FlowGNN`:

- ``embed_{key}/embedding``            -> ``embeds.{key}.embedding``
- ``ggnn_step/edge_linear/{kernel,bias}`` -> ``ggnn_step.edge_linear``
- ``ggnn_step/gru/{ir,iz,in,hr,hz,hn}`` -> ``ggnn_step.gru.{name}``;
  flax's GRU has no hidden-side r/z bias, and neither has the port, so
  ``hr``/``hz`` carry a kernel only
- ``pooling/gate``                     -> ``pooling.gate``
- ``_head/output_{i}``                 -> ``head.output_{i}``

flax ``Dense`` kernels are ``[in, out]``; torch ``Linear`` weights are
``[out, in]``, so every kernel is transposed.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))  # an owned copy


def _dense(prefix: str, p: Mapping, out: Dict[str, torch.Tensor]) -> None:
    out[f"{prefix}.weight"] = _tensor(np.asarray(p["kernel"]).T)
    if "bias" in p:
        out[f"{prefix}.bias"] = _tensor(p["bias"])


def flowgnn_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """A torch ``state_dict`` from a flax FlowGNN parameter tree."""
    params = tree["params"] if "params" in tree else tree
    out: Dict[str, torch.Tensor] = {}
    for name, sub in params.items():
        if name.startswith("embed_"):
            out[f"embeds.{name[len('embed_'):]}.embedding"] = _tensor(
                sub["embedding"])
        elif name == "ggnn_step":
            _dense("ggnn_step.edge_linear", sub["edge_linear"], out)
            for gate, p in sub["gru"].items():
                _dense(f"ggnn_step.gru.{gate}", p, out)
        elif name == "pooling":
            _dense("pooling.gate", sub["gate"], out)
        elif name == "_head":
            for layer, p in sub.items():
                _dense(f"head.{layer}", p, out)
        else:
            raise ValueError(f"unexpected FlowGNN param subtree {name!r}")
    return out
