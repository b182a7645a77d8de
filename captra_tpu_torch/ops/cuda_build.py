"""Build the port's native sources at first use and load them with ctypes;
the one seam behind the hand-written CUDA kernels.

Each `csrc/` file has a plain C interface and is compiled into its own
shared library under `captra_tpu_torch/_build/`, named by a hash of the
source and the flags, so an edited source rebuilds: a `.cu` file by `nvcc`
for `sm_90a` (the card's kernels), a `.cpp` file by `g++` (the host data
core of `data/native.py`).  Nothing here runs at import time: a compiler is
looked up and run only when a library is first needed, so the package
imports on hosts with no toolkit.  A failed build raises with the
compiler's output.

Every kernel module (`fps`, `sa_mlp`, `neighbors`) describes its source's C
entries to one `Kernels` and launches through it: the source is built and
bound at first use, its constants checked against the wrapper's, a kernel
launched on the current stream of its tensors' device, a non-zero return
raised with the library's own error string, and each launch counted in the
one registry `launch_counts` (and in the tracer counter the kernel
registered, `utils/profiling.count`).  `takes_kernel` is the one rule that
sends an input to a kernel or to its plain twin.  A new kernel module
plugs in here and nowhere else: the tracking step's CUDA graph reads only
the registry.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from collections.abc import Mapping

import torch

from captra_tpu_torch.utils import profiling

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
    """`fps_cta_kernel<512, 8>` or `sa_mlp_kernel<true>` from its mangled
    name (the mangled name itself if it does not parse)."""
    m = re.search(r"\d+([a-z_]+_kernel)(I(?:L[ib]\d+E)+E)?", mangled)
    if not m:
        return mangled
    args = [v if t == "i" else ("false", "true")[int(v)]
            for t, v in re.findall(r"L([ib])(\d+)E", m.group(2) or "")]
    return m.group(1) + (f"<{', '.join(args)}>" if args else "")


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>`, built first if needed (one
    thread at a time: loader threads may ask together)."""
    with _lock:
        if name not in _loaded:
            build([name])
            _loaded[name] = ctypes.CDLL(_target(name)[1])
        return _loaded[name]


INT, PTR = ctypes.c_int, ctypes.c_void_p


def bind(source: str, entries: dict[str, tuple],
         expect: dict[str, int] | None = None) -> ctypes.CDLL:
    """`load(source)` with each C entry's restype and argtypes set from
    `entries` (entry -> (restype, *argtypes)).  `expect` maps entries that
    take nothing and return an int to the values the wrapper was written
    for; a library built with others raises with both tuples."""
    expect = expect or {}
    lib = load(source)
    for name, (restype, *argtypes) in {**dict.fromkeys(expect, (INT,)),
                                       **entries}.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    built = tuple(getattr(lib, name)() for name in expect)
    if built != tuple(expect.values()):
        raise RuntimeError(f"{source} was built with ({', '.join(expect)}) "
                           f"{built}, the wrapper expects "
                           f"{tuple(expect.values())}")
    return lib


# ---------------------------------------------------------------------------
# the hand-written kernels' seam
# ---------------------------------------------------------------------------

# every registered kernel -> its launches since `reset_launch_counts`
launch_counts: dict[str, int] = {}


def reset_launch_counts() -> None:
    launch_counts.update(dict.fromkeys(launch_counts, 0))


def count(kernel: str, counter: str | None = None) -> None:
    """Count one launch of `kernel`, and one in the tracer counter
    `counter` (None: none)."""
    launch_counts[kernel] += 1
    if counter:
        profiling.count(counter)


def takes_kernel(*tensors) -> bool:
    """Whether inputs go to a hand-written kernel: float32 CUDA tensors
    that take no gradient do (None stands for no tensor), any other input
    goes to the kernel's plain twin."""
    return all(t is None or (t.is_cuda and t.dtype == torch.float32
                             and not t.requires_grad) for t in tensors)


def check_operands(kernel: str, *tensors: torch.Tensor, ints=()) -> None:
    """Raise unless every tensor is contiguous, on the first one's CUDA
    device, and of float32 (int64 for those in `ints`): a kernel reads its
    operands by pointer."""
    device = tensors[0].device
    if device.type != "cuda":
        raise ValueError(f"{kernel}: tensors must be on CUDA, got {device}")
    for t in tensors:
        want = torch.int64 if any(t is i for i in ints) else torch.float32
        if t.dtype is not want:
            raise TypeError(f"{kernel}: expected {want}, got {t.dtype}")
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"{kernel}: every tensor must be contiguous and "
                             f"on {device}, got one on {t.device} with "
                             f"strides {t.stride()}")


class _Counts(Mapping):
    """`launch_counts` of some kernels, read live."""

    def __init__(self, names: tuple):
        self.names = names

    def __getitem__(self, name: str) -> int:
        if name not in self.names:
            raise KeyError(name)
        return launch_counts[name]

    def __iter__(self):
        return iter(self.names)

    def __len__(self) -> int:
        return len(self.names)


class Kernels:
    """The hand-written kernels of `csrc/<source>`.  `kernels` maps each
    kernel's name to its C entry and the argtypes it takes before the
    stream; an entry returns 0, or an error code that the entry `error`
    spells out.  `queries` are further entries (entry -> (restype,
    *argtypes)), `expect` is `bind`'s.  Each kernel is registered in
    `launch_counts`, and each launch adds one to the tracer counter
    `counter` (None: none; a dict: each kernel's own, none for a kernel it
    leaves out).  `launch_counts` here is the registry's view of these
    kernels."""

    def __init__(self, source: str, kernels: dict[str, tuple], error: str,
                 queries: dict[str, tuple] | None = None,
                 expect: dict[str, int] | None = None,
                 counter: str | dict[str, str] | None = None):
        self.source, self.kernels, self.error = source, kernels, error
        self.expect, self.counter = expect, counter
        self.counters = (counter if isinstance(counter, dict)
                         else dict.fromkeys(kernels, counter))
        self.argtypes = {entry: (INT, *args, PTR)
                         for entry, *args in kernels.values()}
        self.argtypes[error] = (ctypes.c_char_p, INT)
        self.argtypes.update(queries or {})
        launch_counts.update(dict.fromkeys(kernels, 0))
        self.launch_counts = _Counts(tuple(kernels))

    @functools.cached_property
    def lib(self) -> ctypes.CDLL:
        """The bound library, built first if needed."""
        return bind(self.source, self.argtypes, self.expect)

    def launch(self, kernel: str, device: torch.device, *args) -> None:
        """Launch `kernel` with `args` on the current stream of `device`,
        raise with the library's error string on a non-zero return, and
        count the launch."""
        lib = self.lib
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream().cuda_stream
            err = getattr(lib, self.kernels[kernel][0])(*args, stream)
        if err != 0:
            msg = getattr(lib, self.error)(err).decode()
            raise RuntimeError(f"{kernel} launch failed: {msg} ({err})")
        count(kernel, self.counters.get(kernel))
