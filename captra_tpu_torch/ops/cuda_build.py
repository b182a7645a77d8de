"""Build the port's native sources at first use and load them with ctypes.

Each `csrc/` file has a plain C interface and is compiled into its own
shared library under `captra_tpu_torch/_build/`, named by a hash of the
source and the flags, so an edited source rebuilds: a `.cu` file by `nvcc`
for `sm_90a` (the card's kernels), a `.cpp` file by `g++` (the host data
core of `data/native.py`).  Nothing here runs at import time: a compiler is
looked up and run only when a library is first needed, so the package
imports on hosts with no toolkit.  A failed build raises with the
compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")
# the host core: no FMA contraction, so its sums round as the JAX package's
# build of the same source does
HOST_FLAGS = ("-O3", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}     # source name -> compiler output
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


def _gxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: the port's host data core is "
                           "built from csrc/ with g++")
    return found


def _compiler(name: str):
    """(the compiler's lookup, its flags) for `csrc/<name>`, by its
    extension."""
    ext = os.path.splitext(name)[1]
    if ext == ".cu":
        return _nvcc, NVCC_FLAGS
    if ext == ".cpp":
        return _gxx, HOST_FLAGS
    raise ValueError(f"no compiler for {name}")


def _target(name: str) -> tuple[str, str]:
    src = os.path.join(CSRC_DIR, name)
    flags = _compiler(name)[1]
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode())
    stem = os.path.splitext(name)[0]
    return src, os.path.join(BUILD_DIR, f"{stem}-{digest.hexdigest()[:16]}.so")


def build(names: list[str]) -> None:
    """Compile every named source that has no current library, one compiler
    process per source, all started together; the output of each goes into
    `build_log[name]`."""
    todo = [(n, src, lib) for n in names for src, lib in [_target(n)]
            if not os.path.exists(lib)]
    if not todo:
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for name, src, lib in todo:
        tmp = f"{lib}.{os.getpid()}.tmp"
        find, flags = _compiler(name)
        cmd = [find(), *flags, "-o", tmp, src]
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
        raise RuntimeError("build failed for " + "\n".join(failed))


def ptxas_usage(name: str) -> list[str]:
    """One line per kernel of `build_log[name]` (`ptxas -v`): its name and
    template arguments, registers, and spill stores and loads."""
    usage, kernel = {}, None
    for line in build_log.get(name, "").splitlines():
        m = re.search(r"(?:Function properties for|entry function) '?(\S+?)'?"
                      r"(?: for|$)", line)
        if m:
            kernel = _kernel_name(m.group(1))
            usage.setdefault(kernel, ["", ""])
        elif kernel and "spill" in line:
            usage[kernel][1] = line.split("stack frame, ")[-1].strip()
        elif kernel and "Used" in line:
            usage[kernel][0] = line[line.index("Used"):].split(",")[0]
    return [f"{k}: {regs}; {spill}" for k, (regs, spill) in usage.items()]


def _kernel_name(mangled: str) -> str:
    """`fps_cta_kernel<512, 8>` from its mangled name (the mangled name
    itself if it does not parse)."""
    m = re.search(r"\d+([a-z_]+_kernel)(I(?:Li\d+E)+E)?", mangled)
    if not m:
        return mangled
    args = re.findall(r"Li(\d+)E", m.group(2) or "")
    return m.group(1) + (f"<{', '.join(args)}>" if args else "")


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>`, built first if needed (one
    thread at a time: loader threads may ask together)."""
    with _lock:
        if name not in _loaded:
            build([name])
            _loaded[name] = ctypes.CDLL(_target(name)[1])
        return _loaded[name]
