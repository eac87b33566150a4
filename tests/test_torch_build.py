"""How the port's CUDA kernels are built, checked on the CPU (no nvcc here).

``repro_torch.kernels._build`` names each library by a hash of its source,
of the shared headers ``csrc/*.cuh`` and of the flags, so an edited source
or header is rebuilt and a stale library is never loaded.
"""
import re
import shutil

from repro_torch.kernels import _build


def _paths():
    return {name: _build.lib_path(name) for name in _build.SOURCES}


def test_an_edited_header_renames_every_library(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = _paths()
    assert len(set(before.values())) == len(_build.SOURCES)
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = _paths()
    assert all(after[name] != before[name] for name in _build.SOURCES)
    # a new header counts too
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert all(p != after[name] for name, p in _paths().items())


def test_an_edited_source_renames_its_own_library_only(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = _paths()
    src = csrc / "flash_attention_mma.cu"
    src.write_text(src.read_text() + "\n")
    after = _paths()
    assert [name for name in _build.SOURCES if after[name] != before[name]] == [
        "flash_attention_mma"]
    assert _paths() == after  # the name is a pure function of the files


def test_sources_include_only_shared_headers_of_csrc():
    """Every quoted include of a kernel source is a ``csrc/*.cuh`` header
    (which lib_path hashes); both tensor-core flash kernels share
    ``hopper.cuh``."""
    included = {}
    for name in _build.SOURCES:
        text = (_build.CSRC / f"{name}.cu").read_text()
        included[name] = re.findall(r'^#include "([^"]+)"', text, flags=re.M)
        for header in included[name]:
            assert header.endswith(".cuh") and (_build.CSRC / header).is_file(), (name, header)
    assert "hopper.cuh" in included["flash_attention_mma"]
    assert "hopper.cuh" in included["flash_attention_mma_bwd"]


def test_flash_mma_ablation_switches_splice_into_the_kernel_source():
    """``tools/flash_mma_ablations.py`` splices its switches into the forward
    kernel's source at fixed anchors; each anchor still matches once."""
    import importlib.util

    path = _build.CSRC.parents[3] / "tools" / "flash_mma_ablations.py"
    spec = importlib.util.spec_from_file_location("flash_mma_ablations", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    src = tool.variant_source()
    for flag in ("NO_S", "NO_PV", "NO_EXP", "HEAD_MAJOR", "FORCE_W", "STG", "MB", "QREG_ALL",
                 "TRACE"):
        assert f"#ifdef {flag}" in src or f"#ifndef {flag}" in src, flag
    assert src.count("TR(") >= 7 and "read_trace" in src
    # every directive stands on a line of its own
    assert all(line in ("#else", "#endif") or line.split()[0] in ("#ifdef", "#ifndef", "#define",
                                                                  "#include", "#pragma")
               for line in src.splitlines() if line.startswith("#"))
