"""Build the port's CUDA sources at first use and load them with ctypes.

Each `csrc/*.cu` file has a plain C interface and is compiled by `nvcc` for
`sm_90a` into its own shared library under `captra_tpu_torch/_build/`,
named by a hash of the source and the flags, so an edited source rebuilds.
Nothing here runs at import time: `nvcc` is looked up and run only when a
kernel is first needed, so the package imports on hosts with no toolkit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

_loaded: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}     # source name -> nvcc output (ptxas -v)
build_seconds: dict[str, float] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "built from csrc/ on a host with the CUDA toolkit")
    return found


def _target(name: str) -> tuple[str, str]:
    src = os.path.join(CSRC_DIR, name)
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(name)[0]
    return src, os.path.join(BUILD_DIR, f"{stem}-{digest.hexdigest()[:16]}.so")


def build(names: list[str]) -> None:
    """Compile every named source that has no current library, one `nvcc`
    process per source, all started together."""
    todo = [(n, src, lib) for n in names for src, lib in [_target(n)]
            if not os.path.exists(lib)]
    if not todo:
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name, src, lib in todo:
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, src]
        procs.append((name, lib, tmp, time.perf_counter(),
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, lib, tmp, t0, proc in procs:
        out, _ = proc.communicate()
        build_seconds[name] = time.perf_counter() - t0
        build_log[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
            continue
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>`, built first if needed."""
    if name not in _loaded:
        build([name])
        _loaded[name] = ctypes.CDLL(_target(name)[1])
    return _loaded[name]
