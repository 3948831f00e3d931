"""Builds native code into the package's build/ directory and loads it.

The CUDA kernels (csrc/*.cu) are compiled by nvcc for sm_90a into one
shared library with a plain C interface, at first use, and loaded with
ctypes. A plain C interface keeps PyTorch's headers out of the build, so
nvcc takes seconds rather than minutes. The library is rebuilt when a source
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
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # registers, shared memory and spills per kernel go to build/nvcc.log
    "-Xptxas=-v",
)


def _stale(out: str, sources: Sequence[str]) -> bool:
    if not os.path.exists(out):
        return True
    built = os.path.getmtime(out)
    return any(os.path.getmtime(src) > built for src in sources)


def build(
    name: str,
    sources: Sequence[str],
    command: Callable[[str], list[str]],
) -> str:
    """Compile `sources` into build/`name` with `command(out_path)` unless
    the library is newer than every source. Returns the library's path.
    Raises RuntimeError with the compiler's stderr if the build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, name)
    with open(os.path.join(BUILD_DIR, "lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _stale(out, sources):
            tmp = f"{out}.{os.getpid()}.tmp"
            argv = command(tmp)
            proc = subprocess.run(argv, capture_output=True, text=True)
            log = os.path.join(BUILD_DIR, name + ".log")
            with open(log, "w") as f:
                f.write(" ".join(argv) + "\n" + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"building {name} failed (exit {proc.returncode}):\n"
                    f"{proc.stderr}"
                )
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
    path = build(
        "libfkp_kernels.so", sources,
        lambda out: [nvcc(), *NVCC_FLAGS, "-o", out, *sources],
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
