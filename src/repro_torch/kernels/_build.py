"""Build the CUDA kernels with nvcc at first use and load them with ctypes.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface (no PyTorch headers, so a build takes seconds, not minutes), under
``build/repro_torch_kernels/`` at the root of the checkout. A library's file
name carries a hash of its source and flags, so an edited source is rebuilt
and a stale library is never loaded. ``build_all`` starts one nvcc per source
at once; ``load`` builds one on demand. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("flash_attention", "flash_attention_mma", "tome_scores", "decode_attention",
           "decode_attention_mma")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                           "repro_torch CUDA kernels are built on the machine "
                           "with the card")
    return nvcc


def lib_path(name: str) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str) -> tuple[subprocess.Popen, pathlib.Path, pathlib.Path] | None:
    out = lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = out.with_suffix(".log")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return proc, tmp, log


def _finish(name: str, job) -> None:
    proc, tmp, log = job
    output, _ = proc.communicate()
    log.write_bytes(output)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
                           + output.decode(errors="replace"))
    os.replace(tmp, lib_path(name))  # atomic: a concurrent loader never sees half a file


def build_all() -> float:
    """Build every kernel library that is not built yet, one nvcc per source,
    all started together. Returns the wall seconds spent."""
    t0 = time.perf_counter()
    jobs = {name: _start(name) for name in SOURCES}
    for name, job in jobs.items():
        if job is not None:
            _finish(name, job)
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """nvcc's output for a built library (ptxas register/shared-memory use)."""
    log = lib_path(name).with_suffix(".log")
    return log.read_text(errors="replace") if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        job = _start(name)
        if job is not None:
            _finish(name, job)
        lib = _LOADED[name] = ctypes.CDLL(str(lib_path(name)))
    return lib
