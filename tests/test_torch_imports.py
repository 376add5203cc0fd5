"""The port stands alone: it imports with jax, flax, optax and orbax
blocked, loads no module of the JAX package, names none in its sources,
and keeps the JAX package's configuration dataclasses field for field."""

import dataclasses
import json
import os
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "deepdfa_tpu_torch")

_BLOCKED_IMPORT = r"""
import importlib, json, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax", "orbax"):
    sys.modules[name] = None  # any import of them now raises ImportError
import deepdfa_tpu_torch
names = ["deepdfa_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(deepdfa_tpu_torch.__path__,
                                          "deepdfa_tpu_torch.")]
for name in names:
    importlib.import_module(name)
importlib.import_module("chip_smoke")
loaded = sorted(m for m in sys.modules
                if m == "deepdfa_tpu" or m.startswith("deepdfa_tpu."))
print(json.dumps({"modules": names, "reference_loaded": loaded}))
"""


def test_port_imports_with_jax_blocked_and_loads_no_reference_module():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["reference_loaded"] == []
    for name in ("deepdfa_tpu_torch.cli", "deepdfa_tpu_torch.ops.fused_gnn",
                 "deepdfa_tpu_torch.ops._build",
                 "deepdfa_tpu_torch.ops.tile_spmm",
                 "deepdfa_tpu_torch.serve.engine",
                 "deepdfa_tpu_torch.models.convert",
                 "deepdfa_tpu_torch.train.loop",
                 "deepdfa_tpu_torch.train.checkpoint",
                 "deepdfa_tpu_torch.data.splits",
                 "deepdfa_tpu_torch.data.sampling",
                 "deepdfa_tpu_torch.ops.attention",
                 "deepdfa_tpu_torch.models.transformer",
                 "deepdfa_tpu_torch.models.linevul",
                 "deepdfa_tpu_torch.data.text",
                 "deepdfa_tpu_torch.data.combined",
                 "deepdfa_tpu_torch.train.text_loop"):
        assert name in report["modules"]


def _port_sources():
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith((".py", ".cu", ".cuh")):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


# The module name must match exactly: deepdfa_tpu_torch starts with
# deepdfa_tpu.
_REFERENCE_IMPORT = re.compile(
    r"^\s*(import\s+deepdfa_tpu(\s|\.|,|$)|from\s+deepdfa_tpu[. ])", re.M)
_JAX_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|orbax)\b",
                         re.M)


def test_no_port_source_imports_the_reference_or_jax():
    sources = list(_port_sources())
    assert len(sources) > 20
    for path in sources:
        with open(path) as f:
            text = f.read()
        assert not _REFERENCE_IMPORT.search(text), path
        assert not _JAX_IMPORT.search(text), path


@pytest.mark.parametrize("line,hit", [
    ("import deepdfa_tpu", True), ("import deepdfa_tpu.ops", True),
    ("from deepdfa_tpu.ops import band_spmm", True),
    ("from deepdfa_tpu import native", True),
    ("from deepdfa_tpu_torch.ops import band_spmm", False),
    ("import deepdfa_tpu_torch", False)])
def test_reference_import_pattern_matches_the_name_exactly(line, hit):
    assert bool(_REFERENCE_IMPORT.search(line)) == hit


def _fields(cls):
    out = {}
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING:
            out[f.name] = f.default
        else:
            out[f.name] = dataclasses.asdict(f.default_factory())
    return out


@pytest.mark.parametrize("name", ["FeatureSpec", "FlowGNNConfig",
                                  "DataConfig", "TrainConfig",
                                  "TransformerTrainConfig"])
def test_config_dataclasses_match_the_reference(name):
    pytest.importorskip("jax")
    from deepdfa_tpu.core import config as jcfg
    from deepdfa_tpu_torch.core import config as pcfg

    assert _fields(getattr(pcfg, name)) == _fields(getattr(jcfg, name))
    assert pcfg.ALL_SUBKEYS == jcfg.ALL_SUBKEYS


@pytest.mark.parametrize("impl", ["segment", "band", "fused", "persistent",
                                  "tile"])
@pytest.mark.parametrize("concat_all", [True, False])
def test_config_properties_match_the_reference(impl, concat_all):
    pytest.importorskip("jax")
    from deepdfa_tpu.core import config as jcfg
    from deepdfa_tpu_torch.core import config as pcfg

    j = jcfg.FlowGNNConfig(feature=jcfg.FeatureSpec(concat_all=concat_all),
                           message_impl=impl)
    p = pcfg.FlowGNNConfig(feature=pcfg.FeatureSpec(concat_all=concat_all),
                           message_impl=impl)
    for prop in ("input_dim", "uses_band_adj", "uses_tile_adj",
                 "embedding_dim", "ggnn_hidden", "out_dim"):
        assert getattr(p, prop) == getattr(j, prop), prop
    assert tuple(pcfg.subkeys_for(p.feature)) == tuple(
        jcfg.subkeys_for(j.feature))
    assert pcfg.DataConfig().max_edges == jcfg.DataConfig().max_edges


def test_device_defaults_to_cuda_and_raises_without_it(monkeypatch):
    from deepdfa_tpu_torch.core.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for asked in (None, "cuda", "cuda:0", torch.device("cuda")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(asked)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda")
