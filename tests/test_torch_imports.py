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


# The libraries the card's host lacks: the port's readers of real inputs
# (JSONL corpora, MSR CSVs, BPE assets, HF weights, YAML configs) use the
# standard library, numpy and torch in their place.
_HOST_LACKS = ("pandas", "tokenizers", "transformers", "safetensors", "yaml",
               "regex")
_ALL_BLOCKED_IMPORT = _BLOCKED_IMPORT.replace(
    '("jax", "jaxlib", "flax", "optax", "orbax")',
    repr(("jax", "jaxlib", "flax", "optax", "orbax") + _HOST_LACKS))


def test_port_imports_with_the_missing_host_libraries_blocked():
    assert _ALL_BLOCKED_IMPORT != _BLOCKED_IMPORT
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _ALL_BLOCKED_IMPORT],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["reference_loaded"] == []
    for name in ("deepdfa_tpu_torch.contracts.schema",
                 "deepdfa_tpu_torch.contracts.quarantine",
                 "deepdfa_tpu_torch.contracts.ingest",
                 "deepdfa_tpu_torch.contracts.gauntlet",
                 "deepdfa_tpu_torch.core.yaml_subset",
                 "deepdfa_tpu_torch.data.bpe",
                 "deepdfa_tpu_torch.models.pretrained"):
        assert name in report["modules"]


_READERS_RUN = r"""
import json, os, sys, tempfile
for name in %r:
    sys.modules[name] = None
import torch
from deepdfa_tpu_torch.contracts import load_examples_jsonl, write_examples_jsonl
from deepdfa_tpu_torch.core.config import FeatureSpec, build_configs
from deepdfa_tpu_torch.data.combined import _read_text_csvs
from deepdfa_tpu_torch.data.synthetic import synthetic_bigvul
from deepdfa_tpu_torch.data.text import load_bpe_tokenizer
from deepdfa_tpu_torch.models.pretrained import load_pretrained, write_safetensors
d = tempfile.mkdtemp()
write_examples_jsonl(synthetic_bigvul(4, FeatureSpec()), os.path.join(d, "c.jsonl"))
exs, rep = load_examples_jsonl(os.path.join(d, "c.jsonl"), ["api"])
cfg = build_configs([os.path.join(%r, "configs", "default.yaml")], ["train.seed=3"])
import csv
for s in ("train", "val"):
    with open(os.path.join(d, s + ".csv"), "w", newline="") as f:
        csv.writer(f).writerows([["i", "func", "target"], [1, 'a\n"b"', 1]])
rows, pos = _read_text_csvs(d)
json.dump({"<s>": 0, "<pad>": 1, "</s>": 2, "a": 3, "b": 4, "ab": 5},
          open(os.path.join(d, "t-vocab.json"), "w"))
open(os.path.join(d, "t-merges.txt"), "w").write("#version: 0.2\na b\n")
tok = load_bpe_tokenizer(d)
os.mkdir(os.path.join(d, "hf"))
json.dump({"model_type": "roberta", "vocab_size": 8, "hidden_size": 4,
           "num_hidden_layers": 1, "num_attention_heads": 1,
           "intermediate_size": 8, "max_position_embeddings": 6,
           "type_vocab_size": 1}, open(os.path.join(d, "hf", "config.json"), "w"))
names = ["embeddings.word_embeddings.weight", "embeddings.position_embeddings.weight",
         "embeddings.token_type_embeddings.weight"]
shapes = [(8, 4), (6, 4), (1, 4)]
sd = {n: torch.ones(s) for n, s in zip(names, shapes)}
for ln in ("embeddings.LayerNorm", "encoder.layer.0.attention.output.LayerNorm",
           "encoder.layer.0.output.LayerNorm"):
    sd[ln + ".weight"] = torch.ones(4); sd[ln + ".bias"] = torch.zeros(4)
for lin, (o, i) in (("attention.self.query", (4, 4)), ("attention.self.key", (4, 4)),
                    ("attention.self.value", (4, 4)), ("attention.output.dense", (4, 4)),
                    ("intermediate.dense", (8, 4)), ("output.dense", (4, 8))):
    sd[f"encoder.layer.0.{lin}.weight"] = torch.ones(o, i)
    sd[f"encoder.layer.0.{lin}.bias"] = torch.zeros(o)
write_safetensors(os.path.join(d, "hf", "model.safetensors"), sd)
kind, enc, params = load_pretrained(os.path.join(d, "hf"))
print(json.dumps({"loaded": rep["loaded"], "seed": cfg["train"].seed,
                  "rows": len(rows), "code": rows[0]["code"],
                  "tokens": tok.tokenize("ab a"), "kind": kind,
                  "params": len(params)}))
"""


def test_readers_run_with_the_missing_host_libraries_blocked():
    env = dict(os.environ, PYTHONPATH=REPO)
    code = _READERS_RUN % (_HOST_LACKS, REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report == {"loaded": 4, "seed": 3, "rows": 2, "code": 'a\n"b"',
                      "tokens": ["ab", "a"], "kind": "roberta",
                      "params": 21}


_HOST_LACKS_IMPORT = re.compile(
    r"^\s*(import|from)\s+(%s)\b" % "|".join(_HOST_LACKS), re.M)


def test_no_port_source_imports_a_missing_host_library():
    for path in _port_sources():
        with open(path) as f:
            assert not _HOST_LACKS_IMPORT.search(f.read()), path


def test_serving_and_input_modules_import_with_everything_blocked():
    """The flagship forward, the C++ batcher's binding, the dbize reader,
    the gauntlet, the combined lane and the HTTP transport import with
    jax, the reference and the libraries the card's host lacks blocked,
    and importing the batcher builds nothing."""
    env = dict(os.environ, PYTHONPATH=REPO)
    code = _ALL_BLOCKED_IMPORT + (
        "from deepdfa_tpu_torch import native\n"
        "assert native._lib is None\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["reference_loaded"] == []
    for name in ("deepdfa_tpu_torch.entry", "deepdfa_tpu_torch.native",
                 "deepdfa_tpu_torch.etl.legacy_cache",
                 "deepdfa_tpu_torch.contracts.gauntlet",
                 "deepdfa_tpu_torch.models.infer",
                 "deepdfa_tpu_torch.serve.engine",
                 "deepdfa_tpu_torch.serve.http",
                 "deepdfa_tpu_torch.serve.replay"):
        assert name in report["modules"]


_T5_RUN = r"""
import json, os, sys, tempfile
for name in %r:
    sys.modules[name] = None
import torch
from deepdfa_tpu_torch.models import t5
from deepdfa_tpu_torch.models.convert import t5_to_hf
from deepdfa_tpu_torch.models.pretrained import (load_pretrained,
                                                 write_safetensors)
cfg = t5.T5Config.tiny()
model = t5.DefectModel(cfg, device="cpu")
ids = torch.tensor([[1, 5, 6, 2, 0, 0]])
logits = model(ids)
d = tempfile.mkdtemp()
write_safetensors(os.path.join(d, "model.safetensors"),
                  t5_to_hf(model.t5.state_dict(), cfg))
json.dump({"model_type": "t5", "vocab_size": 128, "d_model": 32, "d_kv": 8,
           "d_ff": 64, "num_layers": 2, "num_heads": 4, "eos_token_id": 2,
           "decoder_start_token_id": 0},
          open(os.path.join(d, "config.json"), "w"))
kind, got, params = load_pretrained(d)
loaded = sorted(m for m in sys.modules
                if m == "deepdfa_tpu" or m.startswith("deepdfa_tpu."))
print(json.dumps({"shape": list(logits.shape), "kind": kind,
                  "same": got == cfg, "params": len(params),
                  "reference_loaded": loaded}))
"""


def test_t5_imports_and_runs_with_everything_blocked():
    """``models/t5.py`` and its HF reader import and run with jax, the
    reference, transformers, safetensors and the host's other missing
    libraries blocked: a DefectModel forward, and a T5 directory written
    by the port's own writer read back."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _ALL_BLOCKED_IMPORT],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert "deepdfa_tpu_torch.models.t5" in report["modules"]
    blocked = ("jax", "jaxlib", "flax", "optax", "orbax") + _HOST_LACKS
    out = subprocess.run([sys.executable, "-c", _T5_RUN % (blocked,)],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report == {"shape": [1, 2], "kind": "t5", "same": True,
                      "params": 47, "reference_loaded": []}
