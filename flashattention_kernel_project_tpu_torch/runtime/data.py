"""Token data loading for the training path.

Counterpart of flashattention_kernel_project_tpu/runtime/data.py, with the
same API and batches. `TokenLoader` streams [batch, seq_len+1] uint32 crops
(inputs + next-token labels, one-token overlap) from a flat packed-token
file (nanoGPT-style .bin). The native backend is this package's own
runtime/dataloader.cpp, a copy of the JAX package's (mmap + a prefetch
thread pool with a bounded ready queue), compiled with g++ into this
package's build/ directory at first use; a numpy memmap fallback gives the
same API where no compiler is available. This is host input, not a device
path.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

from flashattention_kernel_project_tpu_torch.ops import _build

DATALOADER_SRC = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "dataloader.cpp"
)


@functools.cache
def _load():
    """The native loader's library, or None where it cannot be built."""
    try:
        so = _build.build(
            "libdataloader.so", [DATALOADER_SRC],
            lambda out: [[["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                           "-pthread", DATALOADER_SRC, "-o", out]]],
        )
    except (RuntimeError, OSError):
        return None
    lib = ctypes.CDLL(so)
    u64, i64, i32 = ctypes.c_uint64, ctypes.c_int64, ctypes.c_int32
    lib.dl_open_region.argtypes = [
        ctypes.c_char_p, i64, i64, u64, i32, i32, i64, i64,
    ]
    lib.dl_open_region.restype = ctypes.c_void_p
    lib.dl_next.argtypes = [
        ctypes.c_void_p,
        np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
    ]
    lib.dl_next.restype = i32
    lib.dl_n_tokens.argtypes = [ctypes.c_void_p]
    lib.dl_n_tokens.restype = i64
    lib.dl_close.argtypes = [ctypes.c_void_p]
    lib.dl_close.restype = None
    return lib


def write_token_file(path: str, tokens: np.ndarray) -> None:
    """Write a flat uint32 packed-token file (the loader's input format)."""
    np.asarray(tokens, dtype=np.uint32).tofile(path)


class TokenLoader:
    """Iterator of [batch, seq_len+1] uint32 batches from a token file.

    shuffle=True draws random crops (training); False walks the file
    sequentially with a one-token label overlap per row (eval), with one
    prefetch worker so that batches come in file order. Use
    `inputs, labels = batch[:, :-1], batch[:, 1:]`.

    shard=(rank, world) gives each data-parallel rank a disjoint contiguous
    region of the file (crops never cross regions). native=None takes the
    native backend where it builds, True requires it (RuntimeError if it
    does not build), False takes the numpy one.
    """

    def __init__(
        self,
        path: str,
        batch: int,
        seq_len: int,
        *,
        seed: int = 0,
        n_threads: int = 2,
        shuffle: bool = True,
        shard: tuple[int, int] = (0, 1),
        native: bool | None = None,
    ):
        self.path = path
        self.batch = batch
        self.seq_len = seq_len
        self._handle = None
        rank, world = shard
        if not 0 <= rank < world:
            raise ValueError(f"shard {shard}: need 0 <= rank < world")
        file_tokens = os.path.getsize(path) // 4
        lo = rank * file_tokens // world
        hi = (rank + 1) * file_tokens // world
        if hi - lo < seq_len + 1:
            raise OSError(
                f"{path}: shard {shard} has {hi - lo} tokens < row "
                f"{seq_len + 1}"
            )
        self.shard = shard
        self._lib = _load() if native in (None, True) else None
        if native is True and self._lib is None:
            raise RuntimeError("native dataloader unavailable (no g++?)")
        if self._lib is not None:
            if not shuffle:
                n_threads = 1  # keep file order deterministic
            self._handle = self._lib.dl_open_region(
                path.encode(), batch, seq_len, seed + rank, n_threads,
                int(shuffle), lo, hi,
            )
            if not self._handle:
                raise OSError(f"dl_open failed for {path}")
            self.n_tokens = int(self._lib.dl_n_tokens(self._handle))
        else:
            self._mm = np.memmap(path, dtype=np.uint32, mode="r")
            self.n_tokens = int(self._mm.shape[0])
            self._rng = np.random.default_rng(seed + rank)
            self._cursor = 0
            self._shuffle = shuffle
        self._lo, self._hi = lo, hi

    @property
    def native(self) -> bool:
        return self._handle is not None

    def next_batch(self) -> np.ndarray:
        row = self.seq_len + 1
        out = np.empty((self.batch, row), np.uint32)
        if self._handle is not None:
            if self._lib.dl_next(self._handle, out) != 0:
                raise RuntimeError("dataloader stopped")
            return out
        n_starts = self._hi - row - self._lo + 1
        for b in range(self.batch):
            if self._shuffle:
                start = self._lo + int(self._rng.integers(0, n_starts))
            else:
                start = self._lo + (self._cursor % n_starts)
                self._cursor += self.seq_len
            out[b] = self._mm[start : start + row]
        return out

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        return self.next_batch()

    def close(self) -> None:
        if self._handle is not None:
            self._lib.dl_close(self._handle)
            self._handle = None

    def __del__(self):
        self.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
