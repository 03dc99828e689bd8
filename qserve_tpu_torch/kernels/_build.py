"""Build and load the port's CUDA kernels; count their launches.

Every `csrc/*.cu` file is one shared library with a plain C interface
(`csrc/*.cuh` are headers they share). At
first use all of them are compiled together, one `nvcc` process per source
started at once, into `build/` beside this file (listed in .gitignore), and
loaded with ctypes. Pointers cross as `c_void_p`; every entry point returns
the `cudaError_t` of its launch, and `check` raises on anything but 0. A
failed build raises too: nothing falls back to the plain versions.

`LAUNCHES` counts, per kernel, the launches the wrappers made. A wrapper adds
one where it launches its kernel and nowhere else, so a run that resets the
counts before driving the engine can show which kernels carried it.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas=-v",
]

LAUNCHES: Dict[str, int] = collections.Counter()

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[tuple, ctypes._CFuncPtr] = {}


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


def reset_launch_counts() -> None:
    LAUNCHES.clear()


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources():
    return sorted(f for f in os.listdir(CSRC) if f.endswith(".cu"))


def _target(src: str) -> str:
    """build/<stem>-<digest>.so; the digest covers the source and every
    csrc/*.cuh, so an edit to a shared header rebuilds each library."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for name in [src, *headers]:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read() + b"\0")
    return os.path.join(BUILD_DIR, f"{src[:-3]}-{h.hexdigest()[:16]}.so")


def build_all() -> Dict[str, str]:
    """Compile every csrc/*.cu not yet built, all nvcc processes at once.
    Returns {stem: path to .so}. Raises with the compiler's output if any
    source fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    targets = {src[:-3]: _target(src) for src in _sources()}
    procs = {}
    for stem, so in targets.items():
        if os.path.exists(so):
            continue
        log = open(so[:-3] + ".log", "w")
        procs[stem] = (
            subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", so + ".tmp",
                 os.path.join(CSRC, stem + ".cu")],
                stdout=log, stderr=subprocess.STDOUT,
            ),
            log,
        )
    failed = []
    for stem, (proc, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc != 0:
            with open(log.name) as f:
                failed.append(f"{stem}.cu (nvcc rc {rc}):\n{f.read()}")
        else:
            os.replace(targets[stem] + ".tmp", targets[stem])
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return targets


def library(stem: str) -> ctypes.CDLL:
    """The loaded library of csrc/<stem>.cu, building every kernel first if
    needed."""
    lib = _libs.get(stem)
    if lib is not None:
        return lib
    with _lock:
        if stem not in _libs:
            targets = build_all()
            _libs[stem] = ctypes.CDLL(targets[stem])
        return _libs[stem]


def function(stem: str, name: str, argtypes) -> ctypes._CFuncPtr:
    """csrc/<stem>.cu's C entry point `name`, returning its cudaError_t."""
    fn = _fns.get((stem, name))
    if fn is None:
        fn = getattr(library(stem), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[(stem, name)] = fn
    return fn


def check(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {rc}")


def check_operands(operands) -> None:
    """Each (tensor, dtype, shape, name): on the card, typed, shaped, dense.
    Every wrapper checks its operands with it before a launch."""
    for t, dt, shape, what in operands:
        if not t.is_cuda or t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(
                f"{what}: want CUDA {dt} {shape}, got {t.device} {t.dtype} "
                f"{tuple(t.shape)}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{what} must be contiguous")


P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_longlong
F = ctypes.c_float


def stream() -> int:
    """PyTorch's current CUDA stream of the current device, as a raw handle
    (the call every launch makes: the raw getter skips building a Stream
    object)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())
