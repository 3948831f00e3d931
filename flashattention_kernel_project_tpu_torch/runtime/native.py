"""ctypes binding of the native continuous-batching core.

Counterpart of the scheduler half of
flashattention_kernel_project_tpu/runtime/native.py. The C++ source is
this package's own runtime/scheduler.cpp, a copy of the JAX package's, so
that a change to the reference never changes the port; it is compiled with
g++ into this package's build/ directory at first use. Where no compiler is
available, a behaviour-identical Python implementation of the same state
machine takes over: this is host bookkeeping, not a device path.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

from flashattention_kernel_project_tpu_torch.ops import _build

SCHEDULER_SRC = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "scheduler.cpp"
)


@functools.cache
def _load_scheduler():
    """The native core's library, or None where it cannot be built."""
    try:
        so = _build.build(
            "libscheduler.so", [SCHEDULER_SRC],
            lambda out: [[["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                           "-pthread", SCHEDULER_SRC, "-o", out]]],
        )
    except (RuntimeError, OSError):
        return None
    lib = ctypes.CDLL(so)
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
