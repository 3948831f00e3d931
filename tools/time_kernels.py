#!/usr/bin/env python3
"""Time the causal attention kernels of one checkout of the PyTorch port.

    python3 tools/time_kernels.py ROOT

ROOT is a directory holding flashattention_kernel_project_tpu_torch/ (the
repository root, or an unpacked `git archive` of another commit). The
kernels build there at first use. Prints one line: ms per call (CUDA
events, the median of 7 runs of a few calls each, eager) of the forward at
1x16/4 heads x 512 and x 4096 tokens (d 128, causal), the fixed-max
forward at 1x16/4 x 4096 (d 128, and d 64 packed), dK/dV and dq at 4x16/4
x 4096 (and, where the checkout has it, dK/dV with the fused dq), the
ragged forward at the serving chunk (T 256, kv_len 768, q_offset 512) and
the split-KV decode partials at B8 S2048. To compare two
commits, time both on one card in turns (parent, change, change, parent):

    for r in parent . . parent; do python3 tools/time_kernels.py $r; done

The 512-token forward and the decode run for tens of microseconds, so the
host's launch cost dominates their eager times; chip_smoke.py times them
from CUDA graphs.
"""

import os
import statistics
import sys


def main() -> int:
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else ".")
    sys.path.insert(0, root)
    import torch

    from flashattention_kernel_project_tpu_torch.ops import _build
    from flashattention_kernel_project_tpu_torch.ops import flash_attention as fa
    from flashattention_kernel_project_tpu_torch.ops import flash_decode as fd

    if not fa.__file__.startswith(root):
        raise SystemExit(f"imported {fa.__file__}, not the package under {root}")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    _build.library()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).bfloat16()

    def ms(fn, iters=10, reps=7):
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end) / iters)
        return statistics.median(out)

    scale = 128 ** -0.5
    res = {}
    for n in (512, 4096):
        q, k, v = randn(1, 16, n, 128), randn(1, 4, n, 128), randn(1, 4, n, 128)
        res[f"fwd{n}"] = ms(lambda: fa._fwd(q, k, v, True, scale, 0))
    res["fixed4096"] = ms(lambda: fa._fwd(q, k, v, True, scale, 0, disc=fa.FIXED))
    q, k, v = randn(1, 16, 4096, 64), randn(1, 4, 4096, 64), randn(1, 4, 4096, 64)
    res["packed4096"] = ms(lambda: fa._fwd(q, k, v, True, 64 ** -0.5, 0,
                                           disc=fa.FIXED, pack=True))
    q, do = randn(4, 16, 4096, 128), randn(4, 16, 4096, 128)
    k, v = randn(4, 4, 4096, 128), randn(4, 4, 4096, 128)
    o, lse = fa._fwd(q, k, v, True, scale, 0)
    if hasattr(fa, "_bwd_rows"):  # the Hopper backward: padded lse2 and delta
        args = (q, k, v, do, *fa._bwd_rows(lse, o, do), True, scale, 0)
        res["fused"] = ms(lambda: fa._fused_cuda(*args), iters=3)
    else:  # the mma.sync kernels of earlier commits
        args = (q, k, v, do, lse, (o.float() * do.float()).sum(-1), True, scale, 0)
    res["dkdv"] = ms(lambda: fa._dkdv_cuda(*args), iters=3)
    res["dq"] = ms(lambda: fa._dq_cuda(*args), iters=3)
    q, k, v = randn(1, 16, 256, 128), randn(1, 4, 2304, 128), randn(1, 4, 2304, 128)
    lens = torch.tensor([768], dtype=torch.int32, device=dev)
    offs = torch.tensor([512], dtype=torch.int32, device=dev)
    res["ragged"] = ms(lambda: fa._fwd_ragged(q, k, v, lens, offs, True, scale))
    q, k, v = randn(8, 16, 128), randn(8, 4, 2048, 128), randn(8, 4, 2048, 128)
    lens = torch.tensor([0, 74, 245, 1109, 1123, 7, 1082, 2048], dtype=torch.int32,
                        device=dev)
    res["decode"] = ms(lambda: fd._decode_partials_cuda(q, k, v, lens, 9, 228, scale),
                       iters=50)
    print(f"{sys.argv[1] if len(sys.argv) > 1 else '.'} ({torch.cuda.get_device_name(0)}): "
          + " ".join(f"{name} {t:.4f}" for name, t in res.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
