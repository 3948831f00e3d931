"""Fail-fast retry for the serving path.

Counterpart of flashattention_kernel_project_tpu/utils/health.py
(`is_transient_error`, `with_retries`). The JAX package retries remote
worker restarts, which its runtime reports as UNAVAILABLE and which rerun
cleanly because its programs are pure. The port differs in two ways:

- A CUDA error is never transient. After an illegal address or a failed
  launch the CUDA context is unusable, and rerunning cannot help.
- The port updates the KV cache in place. A step that failed part-way may
  already have written some layers' K/V rows and not others, so rerunning
  it would append those rows twice. Only an error raised before the step
  touched the device is safe to retry, and no CUDA error is one.
"""

from __future__ import annotations

import time
from typing import Any, Callable

# fragments of a transient runtime fault (a remote worker restart or a
# dropped connection), safe to retry after a cooldown
_TRANSIENT_MARKERS = (
    "UNAVAILABLE",
    "worker process crashed or restarted",
    "socket closed",
    "connection reset",
    "DEADLINE_EXCEEDED",
)

# any error from the CUDA runtime or a kernel launch names CUDA
_CUDA_MARKERS = ("cuda", "cublas", "cudnn", "nccl")


def is_transient_error(err: BaseException) -> bool:
    msg = str(err).lower()
    if any(marker in msg for marker in _CUDA_MARKERS):
        return False
    return any(marker.lower() in msg for marker in _TRANSIENT_MARKERS)


def with_retries(
    fn: Callable[..., Any],
    *args: Any,
    max_retries: int = 2,
    cooldown_s: float = 5.0,
    on_retry: Callable[[int, BaseException], None] | None = None,
    **kwargs: Any,
) -> Any:
    """Run `fn`, retrying transient faults with a cooldown; every other
    error, and every CUDA error, raises at once."""
    attempt = 0
    while True:
        try:
            return fn(*args, **kwargs)
        except Exception as e:  # noqa: BLE001 - classified below
            if not is_transient_error(e) or attempt >= max_retries:
                raise
            attempt += 1
            if on_retry is not None:
                on_retry(attempt, e)
            time.sleep(cooldown_s)
