#!/usr/bin/env python3
"""Compare builds of the attention backward (kernels 4 and 5) on one card,
in turns.

    python3 tools/ab_bwd.py [NAME=CSRC_DIR[:FLAG,...] ...]

Each NAME=CSRC_DIR builds that directory's backward sources (and
common.cu), with the nvcc flags after ':' (e.g. csrc/flash_bwd_sm90.cuh's
probes: -DFKP_BWD_PROBE=1 for the fused dq without its reduce-adds, 2 for
no dq product at all), into a library of its own under
flashattention_kernel_project_tpu_torch/build/ab/, beside this checkout's
kernels ("this"). CSRC_DIR is a csrc/ directory: this checkout's, or
another commit's from an unpacked `git archive`. A directory with
flash_bwd_sm90.cuh is called as this tree's entries take their inputs
(lse * log2(e) and delta padded to 64 rows; a dq_accum for the fused
schedule), one with flash_bwd_dkdv.cu as the earlier mma.sync kernels
took theirs (the natural-log lse, delta unpadded; the two-kernel schedule
only). Every build but a probe is held against `_bwd_plain` (rel-L2 1e-2
for dq, dk and dv) at ragged, offset and windowed shapes in each schedule
it has, then each schedule of each build is timed from CUDA graphs at the
training shape (4 x 16/4 heads x 4096 x 128, causal), at bench.py's b = 1,
at d = 64 and in the training band (window 1024, 64 sinks), in turns
(forward, then reverse order, the minimum of the two), beside SDPA's
backward (chip_smoke.py's `sdpa_backward_ms`; in the band,
with the band as a boolean mask).
"""

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

CHECKS = [  # b, hq, hkv, n, s, d, causal, q_offset, window, sinks
    (1, 4, 1, 200, 333, 128, False, 0, 0, 0),
    (2, 8, 2, 300, 700, 64, True, 400, 0, 0),
    (1, 4, 2, 1024, 1024, 128, True, 0, 256, 200),
    (1, 16, 4, 1024, 1024, 128, True, 0, 0, 0),
]
# b, n (= s), d, window, sinks; 16/4 heads, causal
TIMES = [(4, 4096, 128, 0, 0), (1, 4096, 128, 0, 0), (4, 4096, 64, 0, 0),
         (4, 4096, 128, 1024, 64)]
NEW_SOURCES = ("flash_bwd.cu", "flash_bwd_kv64.cu", "flash_bwd_kv128.cu",
               "flash_bwd_fused64.cu", "flash_bwd_fused128.cu",
               "flash_bwd_dq64.cu", "flash_bwd_dq128.cu")
OLD_SOURCES = ("flash_bwd_dkdv.cu", "flash_bwd_dq.cu")


def build(name, csrc, flags, nvcc, nvcc_flags, out_dir):
    """(the entries of a library built from csrc's backward sources,
    whether it takes this tree's inputs)."""
    new = os.path.exists(os.path.join(csrc, "flash_bwd_sm90.cuh"))
    srcs = [*(NEW_SOURCES if new else OLD_SOURCES), "common.cu"]
    objs = [os.path.join(out_dir, f"{name}.{f}.o") for f in srcs]
    procs = [subprocess.Popen([nvcc, *nvcc_flags, *flags, "-c",
                               os.path.join(csrc, f), "-o", o],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for f, o in zip(srcs, objs)]
    for p in procs:
        out, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"{name}: build failed\n{out[-4000:]}")
        print(f"{name}: " + " | ".join(line.strip() for line in out.splitlines()
                                       if "spill" in line and "0 bytes spill" not in line)
              [-2000:], flush=True)
    lib = os.path.join(out_dir, f"lib{name}.so")
    subprocess.run([nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
                    *objs, "-o", lib], check=True)
    cdll = ctypes.CDLL(lib)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    tail = [i32] * 6 + [ctypes.c_float] + [i32] * 4 + [vp]
    dkdv, dq = cdll.fkp_flash_bwd_dkdv, cdll.fkp_flash_bwd_dq
    dkdv.argtypes = [vp] * (9 if new else 8) + tail
    dq.argtypes = [vp] * 7 + tail
    dkdv.restype = dq.restype = i32
    return (dkdv, dq), new


def schedules(entry, q, k, v, o, lse, do, band):
    """{schedule: a closure giving (dq, dk, dv)} for one build: "fused"
    (this tree's kernel A with dq_accum) where it has it, "two-kernel"."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import _build
    from flashattention_kernel_project_tpu_torch.ops import flash_attention as fa

    if entry == "this":
        return {"fused": lambda: fa._bwd(q, k, v, o, lse, do, *band, fuse_dq=True),
                "two-kernel": lambda: fa._bwd(q, k, v, o, lse, do, *band,
                                              fuse_dq=False)}
    (dkdv, dq_fn), new = entry
    causal, scale, q_offset, window, sinks = band
    b, hq, n, d = q.shape
    dims = (b, hq, k.shape[1], n, k.shape[2], d, float(scale), int(causal),
            int(q_offset), int(window), int(sinks))

    def run(dq_accum):
        stream = torch.cuda.current_stream().cuda_stream
        if new:
            lse2, delta = fa._bwd_rows(lse, o, do)
        else:
            lse2, delta = lse, (o.float() * do.float()).sum(-1)
        ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
               lse2.data_ptr(), delta.data_ptr())
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        acc = () if not new else (None if dq_accum is None else dq_accum.data_ptr(),)
        _build.check(dkdv(*ins, dk.data_ptr(), dv.data_ptr(), *acc, *dims, stream),
                     "fkp_flash_bwd_dkdv")
        if dq_accum is not None:
            return (dq_accum * scale).to(q.dtype), dk, dv
        dqt = torch.empty_like(q)
        _build.check(dq_fn(*ins, dqt.data_ptr(), *dims, stream), "fkp_flash_bwd_dq")
        return dqt, dk, dv

    out = {"two-kernel": lambda: run(None)}
    if new:
        out["fused"] = lambda: run(torch.zeros(q.shape, dtype=torch.float32,
                                               device=q.device))
    return out


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
    entries = {"this": "this"}
    probes = set()
    for spec in sys.argv[1:]:
        name, _, rest = spec.partition("=")
        csrc, _, flags = rest.partition(":")
        if "FKP_BWD_PROBE" in flags:
            probes.add(name)
        entries[name] = build(name, os.path.abspath(csrc),
                              [f for f in flags.split(",") if f], _build.nvcc(),
                              _build.NVCC_FLAGS, out_dir)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(7)

    def inputs(b, hq, hkv, n, s, d):
        q, do = (torch.randn(b, hq, n, d, generator=gen, device=dev).bfloat16()
                 for _ in range(2))
        k, v = (torch.randn(b, hkv, s, d, generator=gen, device=dev).bfloat16()
                for _ in range(2))
        return q, k, v, do

    held = 0
    for b, hq, hkv, n, s, d, causal, q_off, win, sinks in CHECKS:
        q, k, v, do = inputs(b, hq, hkv, n, s, d)
        band = (causal, d ** -0.5, q_off, win, sinks)
        o, lse = fa._fwd(q, k, v, *band)
        plain = fa._bwd_plain(q, k, v, o, lse, do, *band)
        for name, entry in entries.items():
            if name in probes:
                continue
            for sched, fn in schedules(entry, q, k, v, o, lse, do, band).items():
                got = fn()
                torch.cuda.synchronize()
                errs = [cs._rel_l2(g, p) for g, p in zip(got, plain)]
                if not max(errs) <= cs.O_TOL or not all(torch.isfinite(g).all()
                                                        for g in got):
                    raise SystemExit(f"{name} {sched} b{b} hq{hq} hkv{hkv} n{n} "
                                     f"s{s} d{d} {band}: rel-L2 {errs}")
                held += 1
    print(f"{held} build-schedule-shape cases held to plain at {len(CHECKS)} "
          f"shapes | {platform.card_label()}", flush=True)
    for b, n, d, win, sinks in TIMES:
        q, k, v, do = inputs(b, 16, 4, n, n, d)
        band = (True, d ** -0.5, 0, win, sinks)
        o, lse = fa._fwd(q, k, v, *band)
        fns = {f"{name} {sched}": fn for name, entry in entries.items()
               for sched, fn in schedules(entry, q, k, v, o, lse, do, band).items()}
        ms = {}
        for key in [*fns, *reversed(fns)]:
            t = cs.time_ms(fns[key], dev, graph=True)
            ms[key] = min(ms.get(key, t), t)
        mask = cs.band_mask(n, n, 0, win, sinks, dev) if win else None
        sdpa, how = cs.sdpa_backward_ms(q, k, v, do, mask, not win, dev)
        pairs = b * 16 * cs.band_pairs(n, n, 0, win, sinks)
        five = cs.bound(10 * d * pairs, cs.nbytes(q, k, v, o, lse, do, q, k, v))
        print(f"{b}x16/4x{n}x{d} causal, window {win}, sinks {sinks}: 5-product "
              f"bound {five['bound_ms']:.4f} ms, "
              f"SDPA backward {sdpa:.4f} ({how}) | " + " | ".join(
                  f"{key} {t:.4f} ({t / sdpa:.2f}x, {five['bound_ms'] / t:.1%})"
                  for key, t in ms.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
