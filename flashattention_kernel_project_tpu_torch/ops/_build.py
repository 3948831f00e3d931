"""Builds native code into the package's build/ directory and loads it.

The CUDA kernels (csrc/*.cu) are compiled by nvcc for sm_90a, one nvcc
process per source, all started together, and linked into one shared
library with a plain C interface, at first use, and loaded with ctypes. A
plain C interface keeps PyTorch's headers out of the build, so nvcc takes
seconds rather than minutes. The library is rebuilt when a source or header
is newer than it, under a file lock, because several processes may build at
once. Nothing here runs when the package is imported.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import glob
import os
import shutil
import subprocess
from typing import Callable, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    # registers, shared memory and spills per kernel go to build/<library>.log
    "-Xptxas=-v",
)

# A build is a list of stages run in order; the commands of a stage run
# at once.
Stages = list[list[list[str]]]


def _stale(out: str, sources: Sequence[str]) -> bool:
    if not os.path.exists(out):
        return True
    built = os.path.getmtime(out)
    return any(os.path.getmtime(src) > built for src in sources)


def _run_stage(argvs: list[list[str]], log) -> None:
    procs = [subprocess.Popen(argv, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for argv in argvs]
    failed = []
    for argv, proc in zip(argvs, procs):
        out, err = proc.communicate()
        log.write(" ".join(argv) + "\n" + out + err)
        if proc.returncode != 0:
            failed.append(f"{argv[-1]} (exit {proc.returncode}):\n{err}")
    if failed:
        raise RuntimeError("build failed: " + "\n".join(failed))


def build(
    name: str,
    sources: Sequence[str],
    command: Callable[[str], Stages],
) -> str:
    """Build build/`name` with the stages `command(out_path)` unless the
    library is newer than every source. The compilers' output goes to
    build/`name`.log. Returns the library's path. Raises RuntimeError with
    the compiler's stderr if a command fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, name)
    with open(os.path.join(BUILD_DIR, "lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _stale(out, sources):
            tmp = f"{out}.{os.getpid()}.tmp"
            with open(os.path.join(BUILD_DIR, name + ".log"), "w") as log:
                for stage in command(tmp):
                    _run_stage(stage, log)
            os.replace(tmp, out)
    return out


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def kernel_sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


@functools.cache
def library() -> ctypes.CDLL:
    """The kernels' shared library, built if missing or stale."""
    sources = kernel_sources()
    headers = sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    objs = [os.path.join(BUILD_DIR, os.path.basename(src) + ".o")
            for src in sources]
    path = build(
        "libfkp_kernels.so", sources + headers,
        lambda out: [
            [[nvcc(), *NVCC_FLAGS, "-c", src, "-o", obj]
             for src, obj in zip(sources, objs)],
            [[nvcc(), "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
              *objs, "-o", out]],
        ],
    )
    lib = ctypes.CDLL(path)
    lib.fkp_error_string.restype = ctypes.c_char_p
    lib.fkp_error_string.argtypes = [ctypes.c_int]
    return lib


def kernel(name: str, argtypes: list) -> Callable[..., int]:
    """A C entry point of the library; every one returns cudaGetLastError()
    after its launch. Pointers and the stream are ctypes.c_void_p."""
    fn = getattr(library(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error (a refused launch
    never runs, and synchronising does not report it)."""
    if rc != 0:
        msg = library().fkp_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")
