#!/usr/bin/env python3
"""How many device events of a traced CUDA-graph dispatch a torch.profiler
window keeps, window after window, in one process on one card.

    python3 tools/trace_windows.py [OUT_DIR]

Six rounds of four traced dispatches (8 replays of a graph of 30 chained
bf16 4096^3 matmuls), with 64 marker kernels (torch.cuda._sleep) before
the dispatch, after it, both or neither, and 20 short profiles of eager
calls between rounds. Prints, for each window, the matmul and marker
kernels it holds against those launched, the matmuls' span, and where
the markers sit. Windows whose matmul count differs from 30 a replay, and
the first two, are kept gzipped under OUT_DIR (by default a new temporary
directory). cuBLAS may launch more than one kernel a matmul: on an NVIDIA
H100 80GB HBM3 at 700 W every window held 480 of "240", two a matmul, so
a window that loses events shows as a count below the others.
"""
import collections
import gzip
import json
import os
import sys
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile


def chained_graph(dev):
    a = torch.randn(4096, 4096, device=dev, dtype=torch.bfloat16) / 64
    x0 = torch.randn(4096, 4096, device=dev, dtype=torch.bfloat16)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        x0 @ a
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        y = x0
        for _ in range(30):
            y = y @ a
    torch.cuda.synchronize()
    return g, a, x0


def session(out, g, i, head=0, tail=0, replays=8, keep=False):
    path = f"{out}/s{i:02d}.json"
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(0.1)
        for _ in range(head):
            torch.cuda._sleep(1000)
        for _ in range(replays):
            g.replay()
        for _ in range(tail):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(0.1)
    prof.export_chrome_trace(path)
    with open(path) as f:
        ev = json.load(f)["traceEvents"]
    dv = [e for e in ev if e.get("ph") == "X"
          and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    names = collections.Counter(("spin" if "spin" in e["name"] else "gemm") for e in dv)
    spins = sorted(e["ts"] for e in dv if "spin" in e["name"])
    gemms = sorted(e["ts"] for e in dv if "spin" not in e["name"])
    span = (max(e["ts"] + e["dur"] for e in dv if "spin" not in e["name"])
            - min(gemms)) if gemms else 0
    where = ""
    if gemms and spins:
        where = (f"spins before first gemm {sum(s < gemms[0] for s in spins)}, "
                 f"after last {sum(s > gemms[-1] for s in spins)}")
    launches = sum(1 for e in ev if e.get("name") == "cudaGraphLaunch")
    print(f"session {i:2d} head {head:3d} tail {tail:3d}: gemm {names['gemm']}/"
          f"{30 * replays}, spin {names['spin']}/{head + tail}, span "
          f"{span / 1e3:.2f} ms, cudaGraphLaunch {launches} | {where}", flush=True)
    if not keep and names["gemm"] == 30 * replays:
        os.remove(path)
    else:
        with open(path, "rb") as f, gzip.open(path + ".gz", "wb") as z:
            z.write(f.read())
        os.remove(path)


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    out = sys.argv[1] if len(sys.argv) > 1 else tempfile.mkdtemp(prefix="trace_windows_")
    os.makedirs(out, exist_ok=True)
    dev = torch.device("cuda", 0)
    g, a, x0 = chained_graph(dev)
    i = 0
    t0 = time.time()
    for _ in range(6):
        for head, tail in ((0, 0), (0, 64), (64, 0), (64, 64)):
            session(out, g, i, head, tail, keep=(i < 2))
            i += 1
        # age the process: many short profiles of eager calls
        for _ in range(20):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
                (x0 @ a).sum().item()
    print(f"{time.time() - t0:.1f} s; kept traces under {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
