#!/usr/bin/env python3
"""Compare builds of the dense attention forward (kernels 1 and 2) on one
card, in turns.

    python3 tools/ab_dense_fwd.py [NAME=CSRC_DIR[:FLAG,...] ...]

Each NAME=CSRC_DIR builds that directory's flash_fwd*.cu and common.cu
(with the nvcc flags after ':', e.g. -DNAME=1) into a library of its own
under flashattention_kernel_project_tpu_torch/build/ab/, beside this
checkout's kernels ("this"). CSRC_DIR is a csrc/ directory: this
checkout's, another commit's from an unpacked `git archive`, or a copy
with an edited header. Every build's entry fkp_flash_fwd is held against
_fwd_plain (O rel-L2 1e-2, LSE 1e-3) at tile-edge shapes in the three
disciplines, then timed from CUDA graphs at bench.py's shape (causal and
full), d=64, the training band and the 512 serving prefill, the builds in
turns (forward, then reverse order, the minimum of the two), beside SDPA.
"""

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

LOG2E = 1.4426950408889634
CHECKS = [  # b, hq, hkv, n, s, d, causal, q_offset, window, sinks
    (2, 4, 2, 200, 333, 128, False, 0, 0, 0),
    (2, 4, 2, 200, 333, 64, True, 133, 0, 0),
    (1, 4, 1, 1000, 1000, 128, True, 0, 0, 0),
    (1, 4, 2, 1024, 1024, 128, True, 0, 256, 200),
    (1, 2, 1, 100, 100, 128, True, -50, 0, 0),
]
TIMES = [  # n, d, causal, window, sinks at 1 x 16/4 heads
    (4096, 128, True, 0, 0), (4096, 128, False, 0, 0), (4096, 64, True, 0, 0),
    (4096, 128, True, 1024, 64), (512, 128, True, 0, 0),
]


def build(name, csrc, flags, nvcc, nvcc_flags, out_dir):
    """The entry fkp_flash_fwd of a library built from csrc's dense
    forward sources."""
    srcs = sorted(f for f in os.listdir(csrc)
                  if f.startswith("flash_fwd") and f.endswith(".cu")
                  and f not in ("flash_fwd_q.cu", "flash_fwd_ragged.cu"))
    objs = [os.path.join(out_dir, f"{name}.{f}.o") for f in srcs + ["common.cu"]]
    procs = [subprocess.Popen([nvcc, *nvcc_flags, *flags, "-c",
                               os.path.join(csrc, f), "-o", o],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for f, o in zip(srcs + ["common.cu"], objs)]
    for p in procs:
        out, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"{name}: build failed\n{out[-4000:]}")
    lib = os.path.join(out_dir, f"lib{name}.so")
    subprocess.run([nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
                    *objs, "-o", lib], check=True)
    fn = ctypes.CDLL(lib).fkp_flash_fwd
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp] * 8 + [i32] * 6 + [ctypes.c_float] + [i32] * 5 + [vp]
    fn.restype = i32
    return fn


def main() -> int:
    import torch

    from flashattention_kernel_project_tpu_torch.ops import _build
    from flashattention_kernel_project_tpu_torch.ops import flash_attention as fa
    from flashattention_kernel_project_tpu_torch.utils import platform

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    _build.library()
    out_dir = os.path.join(_build.BUILD_DIR, "ab")
    os.makedirs(out_dir, exist_ok=True)
    entries = {"this": fa._kernel("fkp_flash_fwd", 8, 5)}
    for spec in sys.argv[1:]:
        name, _, rest = spec.partition("=")
        csrc, _, flags = rest.partition(":")
        entries[name] = build(name, os.path.abspath(csrc),
                              [f for f in flags.split(",") if f], _build.nvcc(),
                              _build.NVCC_FLAGS, out_dir)
    dev = torch.device("cuda", 0)

    def run(fn, q, k, v, causal, q_off, win, sinks, disc, k_max):
        b, hq, n, d = q.shape
        o = torch.empty_like(q)
        lse = torch.empty((b, hq, n), dtype=torch.float32, device=dev)
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), None if k_max is None else k_max.data_ptr(),
                None, None, b, hq, k.shape[1], n, k.shape[2], d,
                float(d ** -0.5 * LOG2E), int(causal), q_off, win, sinks, disc,
                torch.cuda.current_stream().cuda_stream)
        _build.check(rc, "fkp_flash_fwd")
        return o, lse

    gen = torch.Generator(device=dev).manual_seed(3)
    for b, hq, hkv, n, s, d, causal, q_off, win, sinks in CHECKS:
        q, k, v = cs._qkv(gen, dev, b, hq, hkv, n, s, d)
        for disc in (fa.ONLINE, fa.FIXED, fa.HYBRID):
            k_max = fa.k_max_norm(k) if disc == fa.HYBRID else None
            args = (causal, q_off, win, sinks, disc, k_max)
            po, plse = fa._fwd_plain(q, k, v, causal, d ** -0.5, q_off, win,
                                     sinks, disc, k_max)
            for name, fn in entries.items():
                o, lse = run(fn, q, k, v, *args)
                err = cs._rel_l2(o, po)
                lerr = float((lse - plse).abs().max())
                if not (err <= cs.O_TOL and lerr <= cs.LSE_TOL):
                    raise SystemExit(f"{name} b{b} hq{hq} n{n} s{s} d{d} "
                                     f"causal={causal} q_offset={q_off} "
                                     f"window={win} disc {disc}: O rel-L2 "
                                     f"{err:.3e}, LSE max-abs {lerr:.3e}")
    print(f"{len(entries)} builds held to plain at {len(CHECKS)} shapes x 3 "
          f"disciplines | {platform.card_label()}", flush=True)
    for n, d, causal, win, sinks in TIMES:
        q, k, v = cs._qkv(gen, dev, 1, 16, 4, n, n, d)
        k_max = fa.k_max_norm(k)
        parts = []
        for disc in (fa.ONLINE, fa.FIXED, fa.HYBRID):
            args = (causal, 0, win, sinks, disc,
                    k_max if disc == fa.HYBRID else None)
            ms = {}
            for name in [*entries, *reversed(entries)]:
                t = cs.time_ms(lambda fn=entries[name]: run(fn, q, k, v, *args),
                               dev, graph=True)
                ms[name] = min(ms.get(name, t), t)
            parts.append(f"disc {disc}: " + " ".join(f"{nm} {t:.4f}"
                                                       for nm, t in ms.items()))
        mask = cs.band_mask(n, n, 0, win, sinks, dev) if win else None
        sdpa = cs.time_ms(cs.sdpa_fn(q, k, v, mask=mask,
                                     causal=causal and not win), dev, graph=True)
        print(f"1x16/4x{n}x{d} causal={causal} window={win} sinks={sinks}: "
              f"SDPA {sdpa:.4f} ms | " + " | ".join(parts), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
