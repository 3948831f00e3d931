"""Error metrics as assertions (numpy only), and worlds of spawned ranks.

Counterpart of flashattention_kernel_project_tpu/utils/testing.py: the
reference's two verification metrics, max-abs-diff for GEMMs and relative
L2 for attention; the numerics gate is <= 1e-2 max-abs against the fp32
oracle at matching bit-width (BASELINE.md). `run_ranks` runs a function on
a gloo world of spawned processes, where JAX's tests force a host device
count: the mesh tests and chip_smoke.py's mesh phase use it.
"""

from __future__ import annotations

import numpy as np


def max_abs_diff(actual, expected) -> float:
    return float(np.max(np.abs(np.asarray(actual, np.float64)
                               - np.asarray(expected, np.float64))))


def rel_l2(actual, expected) -> float:
    a = np.asarray(actual, np.float64)
    e = np.asarray(expected, np.float64)
    denom = np.linalg.norm(e.ravel())
    return float(np.linalg.norm((a - e).ravel()) / max(denom, 1e-30))


def assert_max_abs(actual, expected, tol: float = 1e-2, msg: str = ""):
    d = max_abs_diff(actual, expected)
    assert d <= tol, f"max-abs-diff {d:.3e} > {tol:.1e} {msg}"


def assert_rel_l2(actual, expected, tol: float = 1e-2, msg: str = ""):
    d = rel_l2(actual, expected)
    assert d <= tol, f"rel-L2 {d:.3e} > {tol:.1e} {msg}"


def _rank_main(fn, rank, world, store_path, args, results):
    """One rank of `run_ranks`: a gloo process group over a FileStore, one
    thread, a 60 s collective timeout; fn's result (or its traceback) goes
    to `results`."""
    import datetime
    import traceback

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(store_path, world), rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=60))
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn, world: int, *args, tmpdir: str, timeout: float = 120.0):
    """Run fn(rank, world, *args) in `world` spawned processes joined by a
    gloo process group (a FileStore under `tmpdir`: no TCP port, so
    concurrent worlds cannot collide). fn must be a module-level function
    and its arguments and result picklable. Returns the ranks' results in
    rank order; raises RuntimeError with a failed rank's traceback, or
    TimeoutError when the ranks have not all reported within `timeout`
    seconds. Every rank is killed before this returns or raises, so a hung
    rank fails the caller instead of hanging it."""
    import multiprocessing as mp
    import os
    import queue
    import time
    import uuid

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    store = os.path.join(tmpdir, f"store-{uuid.uuid4().hex}")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, store, args, results), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + timeout
    try:
        while len(got) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"ranks {sorted(set(range(world)) - set(got))}"
                                   f" did not finish in {timeout} s")
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in got]
                if dead:
                    raise RuntimeError(f"ranks {dead} died without a result")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{out}")
            got[rank] = out
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    return [got[r] for r in range(world)]
