"""The kernel build's cache key: every header a CUDA source includes joins
that library's hash (``ops/_build.HEADERS``), so editing a shared header
rebuilds each library that includes it and no stale library loads. No
nvcc is needed: the includes are read from the sources."""

import os
import re

import pytest

from deepdfa_tpu_torch.ops import _build

_INCLUDE = re.compile(r'^\s*#include\s+"([^"]+)"', re.M)


def _included(rel: str) -> set:
    """The local headers ``rel`` includes, directly or through another."""
    seen = set()
    todo = [rel]
    while todo:
        path = os.path.join(_build._PKG, todo.pop())
        with open(path) as f:
            for name in _INCLUDE.findall(f.read()):
                header = os.path.join(os.path.dirname(os.path.relpath(
                    path, _build._PKG)), name)
                if header not in seen:
                    seen.add(header)
                    todo.append(header)
    return seen


@pytest.mark.parametrize("library", sorted(_build.SOURCES))
def test_headers_list_every_include(library):
    assert set(_build.HEADERS[library]) == _included(_build.SOURCES[library])


def test_shared_header_edit_changes_both_flash_hashes(tmp_path, monkeypatch):
    # A copy of the package's sources with one byte of the shared 3xTF32
    # header changed: both flash libraries and the GNN backward (its weight
    # pass) get a new name, the others not.
    for rel in {*_build.SOURCES.values(),
                *(h for hs in _build.HEADERS.values() for h in hs)}:
        dst = tmp_path / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        with open(os.path.join(_build._PKG, rel), "rb") as f:
            dst.write_bytes(f.read())
    monkeypatch.setattr(_build, "_PKG", str(tmp_path))
    before = {name: _build.library_path(name) for name in _build.SOURCES}
    header = tmp_path / "csrc" / "tf32_mma.cuh"
    header.write_bytes(header.read_bytes() + b"\n")
    after = {name: _build.library_path(name) for name in _build.SOURCES}
    changed = {name for name in before if before[name] != after[name]}
    assert changed == {"flash_attn", "flash_bwd_fused", "fused_gnn_bwd"}


@pytest.mark.parametrize("header", sorted({h for hs in _build.HEADERS.values()
                                           for h in hs}))
def test_header_edit_rebuilds_the_libraries_that_include_it(
        tmp_path, monkeypatch, header):
    # One byte more in a header renames exactly the libraries whose
    # sources include it (group_step.cuh: both GNN libraries).
    for rel in {*_build.SOURCES.values(),
                *(h for hs in _build.HEADERS.values() for h in hs)}:
        dst = tmp_path / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        with open(os.path.join(_build._PKG, rel), "rb") as f:
            dst.write_bytes(f.read())
    monkeypatch.setattr(_build, "_PKG", str(tmp_path))
    before = {name: _build.library_path(name) for name in _build.SOURCES}
    (tmp_path / header).write_bytes((tmp_path / header).read_bytes() + b"\n")
    changed = {name for name in before
               if before[name] != _build.library_path(name)}
    assert changed == {name for name in _build.SOURCES
                       if header in _build.HEADERS[name]}
    assert changed
