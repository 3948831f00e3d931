"""A liveness probe and fail-fast retry for the serving path.

Counterpart of flashattention_kernel_project_tpu/utils/health.py
(`device_healthcheck`, `is_transient_error`, `with_retries`; its
`is_deleted_buffer_error` has no counterpart, since torch donates no
buffers to a call). The JAX package retries remote
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

import concurrent.futures
import time
from typing import Any, Callable

import torch

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


def device_healthcheck(timeout_s: float = 30.0, device: str = "cuda") -> dict:
    """A cheap liveness probe: a 128 x 128 float32 product on `device`,
    forced to completion, under a deadline.

    Returns {"ok": bool, "latency_s": float, "device": str, "error": str?}
    ("device" names the card, or "cpu"); it never raises. The product runs
    on a worker thread, so that the deadline holds even if a wedged card
    never returns; on a GPU the thread synchronizes the device before it
    reads the sum. The CPU is probed only when the caller asks for it."""
    t0 = time.perf_counter()

    def probe():
        dev = torch.device(device)
        if dev.type == "cuda":
            name = torch.cuda.get_device_name(dev)
        else:
            name = str(dev)
        x = torch.ones(128, 128, dtype=torch.float32, device=dev)
        total = (x @ x).sum()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return abs(float(total) - 128.0 * 128 * 128) < 1.0, name

    ex = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    try:
        ok, name = ex.submit(probe).result(timeout=timeout_s)
        return {"ok": ok, "latency_s": time.perf_counter() - t0, "device": name}
    except concurrent.futures.TimeoutError:
        return {"ok": False, "latency_s": time.perf_counter() - t0,
                "device": "unknown",
                "error": f"healthcheck exceeded {timeout_s}s (device wedged?)"}
    except Exception as e:  # noqa: BLE001 - a probe must not raise
        return {"ok": False, "latency_s": time.perf_counter() - t0,
                "device": "unknown", "error": f"{type(e).__name__}: {e}"}
    finally:
        ex.shutdown(wait=False)


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
