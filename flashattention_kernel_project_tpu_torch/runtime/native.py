"""ctypes bindings of the native host code: the fp64 C++ oracle and the
continuous-batching core.

Counterpart of flashattention_kernel_project_tpu/runtime/native.py. The C++
sources are this package's own runtime/oracle.cpp and runtime/scheduler.cpp,
copies of the JAX package's, so that a change to the reference never changes
the port; each is compiled with g++ into this package's build/ directory at
first use. Where no compiler is available, the oracle's functions take the
numpy oracles of utils/oracles.py and the core a behaviour-identical Python
implementation of the same state machine: these are host references and
bookkeeping, not device paths.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

from flashattention_kernel_project_tpu_torch.ops import _build
from flashattention_kernel_project_tpu_torch.utils import oracles as np_oracles

_DIR = os.path.dirname(os.path.abspath(__file__))
ORACLE_SRC = os.path.join(_DIR, "oracle.cpp")
SCHEDULER_SRC = os.path.join(_DIR, "scheduler.cpp")


def _gxx(src: str, name: str):
    """build/`name` from `src` with g++, loaded; None where it cannot be
    built."""
    try:
        so = _build.build(
            name, [src],
            lambda out: [[["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                           "-pthread", src, "-o", out]]],
        )
    except (RuntimeError, OSError):
        return None
    return ctypes.CDLL(so)


# ---------------------------------------------------------------------------
# The fp64 C++ oracle (runtime/oracle.cpp): threaded over rows, for checks
# at the ladder's full sizes, where numpy's float64 loops are slow
# ---------------------------------------------------------------------------

@functools.cache
def _load_oracle():
    lib = _gxx(ORACLE_SRC, "liboracle.so")
    if lib is None:
        return None
    i64, i32, f32 = ctypes.c_int64, ctypes.c_int32, ctypes.c_float
    ptr = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    for fn in (lib.gemm_f32, lib.softmax_f32, lib.gqa_attention_f32):
        fn.restype = None
    lib.gemm_f32.argtypes = [ptr, ptr, ptr, i64, i64, i64]
    lib.softmax_f32.argtypes = [ptr, ptr, i64, i64]
    lib.gqa_attention_f32.argtypes = [
        ptr, ptr, ptr, ptr, i64, i64, i64, i64, i64, i64, f32, i32, i64,
    ]
    return lib


def available() -> bool:
    """Whether the oracle runs natively (else its functions take numpy)."""
    return _load_oracle() is not None


def gemm(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """C = A @ B in float64, as float32; leading batch dims go to numpy."""
    lib = _load_oracle()
    if lib is None or a.ndim != 2:
        return np_oracles.gemm(a, b)
    a = np.ascontiguousarray(a, np.float32)
    b = np.ascontiguousarray(b, np.float32)
    m, k = a.shape
    n = b.shape[1]
    c = np.empty((m, n), np.float32)
    lib.gemm_f32(a, b, c, m, k, n)
    return c


def softmax(x: np.ndarray) -> np.ndarray:
    """Row softmax over the last axis in float64, as float32."""
    lib = _load_oracle()
    if lib is None:
        return np_oracles.softmax(x)
    x2 = np.ascontiguousarray(x, np.float32).reshape(-1, x.shape[-1])
    y = np.empty_like(x2)
    lib.softmax_f32(x2, y, x2.shape[0], x2.shape[1])
    return y.reshape(x.shape)


def gqa_attention(
    q: np.ndarray,
    k: np.ndarray,
    v: np.ndarray,
    *,
    scale: float | None = None,
    causal: bool = False,
    q_offset: int = 0,
) -> np.ndarray:
    """utils.oracles.gqa_attention (no window) in float64, as float32."""
    lib = _load_oracle()
    if lib is None:
        return np_oracles.gqa_attention(
            q, k, v, scale=scale, causal=causal, q_offset=q_offset
        )
    b, hq, n, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / np.sqrt(d)
    q = np.ascontiguousarray(q, np.float32)
    k = np.ascontiguousarray(k, np.float32)
    v = np.ascontiguousarray(v, np.float32)
    o = np.empty((b, hq, n, d), np.float32)
    lib.gqa_attention_f32(
        q, k, v, o, b, hq, hkv, n, s, d, float(scale), int(causal), q_offset
    )
    return o


# ---------------------------------------------------------------------------
# The continuous-batching core (runtime/scheduler.cpp)
# ---------------------------------------------------------------------------

@functools.cache
def _load_scheduler():
    """The native core's library, or None where it cannot be built."""
    lib = _gxx(SCHEDULER_SRC, "libscheduler.so")
    if lib is None:
        return None
    i32, i64, vp = ctypes.c_int32, ctypes.c_int64, ctypes.c_void_p
    lib.cbs_create.restype = vp
    lib.cbs_create.argtypes = [i32, i32, i32]
    lib.cbs_destroy.restype = None
    lib.cbs_destroy.argtypes = [vp]
    lib.cbs_bucket.restype = i32
    lib.cbs_bucket.argtypes = [vp, i32]
    lib.cbs_submit.restype = i64
    lib.cbs_submit.argtypes = [vp, i32, i32]
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.cbs_fill.restype = i32
    lib.cbs_fill.argtypes = [vp, i64p, i32p, i32p, i32]
    lib.cbs_on_token.restype = i32
    lib.cbs_on_token.argtypes = [vp, i32, i32, i32]
    lib.cbs_active.restype = i32
    lib.cbs_active.argtypes = [vp]
    lib.cbs_pending.restype = i32
    lib.cbs_pending.argtypes = [vp]
    lib.cbs_slot_uid.restype = i64
    lib.cbs_slot_uid.argtypes = [vp, i32]
    lib.cbs_cancel.restype = i32
    lib.cbs_cancel.argtypes = [vp, i64]
    return lib


def scheduler_available() -> bool:
    return _load_scheduler() is not None


class BatchSchedulerCore:
    """Continuous-batching bookkeeping: request admission, slot allocation,
    per-slot budget/EOS tracking, prompt-length bucketing. Backed by the
    native C++ core when it builds, else by the same state machine in
    Python (`native=False` forces that, for tests)."""

    def __init__(self, n_slots: int, max_len: int, granule: int = 64,
                 native: bool = True):
        self.n_slots = n_slots
        self.max_len = max_len
        self.granule = granule
        self._lib = _load_scheduler() if native else None
        self._h = None
        if self._lib is not None:
            self._h = ctypes.c_void_p(
                self._lib.cbs_create(n_slots, max_len, granule)
            )
        else:
            self._slots = [None] * n_slots  # [uid, generated, max_new]
            self._pending = []
            self._next_uid = 0

    def __del__(self):
        if getattr(self, "_lib", None) is not None and getattr(self, "_h", None):
            self._lib.cbs_destroy(self._h)
            self._h = None

    @property
    def native(self) -> bool:
        return self._lib is not None

    def bucket(self, n: int) -> int:
        if self._lib is not None:
            return int(self._lib.cbs_bucket(self._h, n))
        b = max(self.granule, -(-n // self.granule) * self.granule)
        return min(b, self.max_len)

    def submit(self, prompt_len: int, max_new: int) -> int:
        """Queue a request; returns uid or -1 if it can never fit."""
        if self._lib is not None:
            return int(self._lib.cbs_submit(self._h, prompt_len, max_new))
        if prompt_len + max_new > self.max_len:
            return -1
        uid = self._next_uid
        self._next_uid += 1
        self._pending.append((uid, prompt_len, max_new))
        return uid

    def fill(self) -> list[tuple[int, int, int]]:
        """Admit pending requests into free slots (FIFO).
        Returns [(uid, slot, prompt_bucket), ...]."""
        if self._lib is not None:
            cap = self.n_slots
            uids = np.empty(cap, np.int64)
            slots = np.empty(cap, np.int32)
            buckets = np.empty(cap, np.int32)
            n = int(self._lib.cbs_fill(self._h, uids, slots, buckets, cap))
            return [
                (int(uids[i]), int(slots[i]), int(buckets[i]))
                for i in range(n)
            ]
        out = []
        for i in range(self.n_slots):
            if not self._pending:
                break
            if self._slots[i] is not None:
                continue
            uid, plen, max_new = self._pending.pop(0)
            self._slots[i] = [uid, 0, max_new]
            out.append((uid, i, self.bucket(plen)))
        return out

    def on_token(self, slot: int, token: int, eos: int = -1) -> bool:
        """Record a generated token; True (and the slot is freed) when the
        request just finished (budget exhausted or EOS)."""
        if self._lib is not None:
            return bool(self._lib.cbs_on_token(self._h, slot, token, eos))
        s = self._slots[slot]
        if s is None:
            return False
        s[1] += 1
        done = s[1] >= s[2] or (eos >= 0 and token == eos)
        if done:
            self._slots[slot] = None
        return done

    def active(self) -> int:
        if self._lib is not None:
            return int(self._lib.cbs_active(self._h))
        return sum(s is not None for s in self._slots)

    def pending(self) -> int:
        if self._lib is not None:
            return int(self._lib.cbs_pending(self._h))
        return len(self._pending)

    def slot_uid(self, slot: int) -> int:
        if self._lib is not None:
            return int(self._lib.cbs_slot_uid(self._h, slot))
        s = self._slots[slot]
        return -1 if s is None else s[0]

    def cancel(self, uid: int) -> int:
        """Cancel a request: 1 = removed from the pending queue, 2 =
        evicted from its slot (caller frees device state), 0 = unknown."""
        if self._lib is not None:
            return int(self._lib.cbs_cancel(self._h, uid))
        for i, p in enumerate(self._pending):
            if p[0] == uid:
                self._pending.pop(i)
                return 1
        for i, s in enumerate(self._slots):
            if s is not None and s[0] == uid:
                self._slots[i] = None
                return 2
        return 0
