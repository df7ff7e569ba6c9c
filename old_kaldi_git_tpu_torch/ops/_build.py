"""Build and load the CUDA C++ kernels under ops/csrc/.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by nvcc
into its own shared library, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/lib<name>-<hash>.so csrc/<name>.cu

No PyTorch header is included, so a source builds in seconds.  Libraries go
into `build/` beside the package (an ignored directory), named by a hash of
their source, the headers under csrc/ (`*.cuh`) and the flags, so an edited
source or header never meets a stale library.  A build or
load failure raises: there is no other path for a CUDA tensor.

This module is imported only by the CUDA branch of the kernel wrappers.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Iterable, List, Sequence, Tuple

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build",
)
KERNEL_SOURCES = ("gather", "mfcc", "gmm")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_entries: Dict[Tuple[str, str], object] = {}  # (source, symbol) → bound C entry
build_seconds: float = 0.0  # wall time this process spent in nvcc


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels cannot be built on this machine")


def _lib_path(name: str) -> Tuple[str, str]:
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    headers = sorted(h for h in os.listdir(CSRC_DIR) if h.endswith(".cuh"))
    for path in [src] + [os.path.join(CSRC_DIR, h) for h in headers]:
        with open(path, "rb") as f:
            digest.update(f.read())
    return src, os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def build(names: Iterable[str] = KERNEL_SOURCES) -> List[str]:
    """Compile every missing library, one nvcc per source, all started
    together.  Returns the library paths.  The compiler's report (registers,
    shared memory, spills per kernel) is kept beside each library as
    `<lib>.log`."""
    global build_seconds
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    paths = []
    for name in names:
        src, lib = _lib_path(name)
        paths.append(lib)
        if os.path.exists(lib):
            continue
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
        procs.append((name, lib, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failures = []
    for name, lib, tmp, cmd, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{' '.join(cmd)}\n{out}")
            continue
        with open(f"{lib}.log", "w") as f:
            f.write(out)
        os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
    if procs:
        build_seconds += time.perf_counter() - t0
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return paths


def bind(name: str, symbol: str, argtypes: Sequence[type], restype: type = ctypes.c_int):
    """The C entry point `symbol` of csrc/<name>.cu with its argument types
    declared (a pointer passed without `c_void_p` would be cut to 32 bits).
    A launching entry returns `cudaGetLastError()` as an int.  The first
    call builds every kernel source at once, so that their compiles
    overlap."""
    fn = _entries.get((name, symbol))
    if fn is None:
        build()
        fn = getattr(ctypes.CDLL(_lib_path(name)[1]), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = restype
        _entries[(name, symbol)] = fn
    return fn


def check_launch(err: int, what: str) -> None:
    """Raise when a C entry reported a refused launch (too much shared
    memory, a bad grid): such a launch never runs and a later synchronise
    does not report it."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error code {err}")


def build_logs() -> Dict[str, str]:
    """Compiler reports of the libraries built so far, by source name."""
    logs = {}
    for name in KERNEL_SOURCES:
        path = _lib_path(name)[1] + ".log"
        if os.path.exists(path):
            with open(path) as f:
                logs[name] = f.read()
    return logs
