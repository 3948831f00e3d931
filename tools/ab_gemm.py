#!/usr/bin/env python3
"""Compare builds of the bf16 GEMM (kernels 13 and 14) on one card, in
turns.

    python3 tools/ab_gemm.py [NAME=CSRC_DIR[:FLAG,...] ...]

Each NAME=CSRC_DIR builds that directory's gemm.cu (with gemm_sm90.cu where
the directory has it) and common.cu, with the nvcc flags after ':' (e.g.
csrc/gemm_sm90.cuh's probes: -DFKP_GEMM_PROBE=1, 2 or 3 for the loads
alone, the products alone, no epilogue), into a library of its own under
flashattention_kernel_project_tpu_torch/build/ab/, beside this checkout's
kernels ("this"). CSRC_DIR is a csrc/ directory: this checkout's, or
another commit's from an unpacked `git archive`. A build with
gemm_sm90.cu is called on the wgmma path (fkp_gemm's path 2), one without
it on its aligned mma.sync path (1), as that commit's ops/gemm.py called
it. Every build but a probe (-DFKP_GEMM_PROBE=1 or 2: the loads or the
products alone, gemm_sm90.cuh) is held against `_matmul_plain` at
tile-edge shapes, bf16
and f32 out (bf16 rel-L2 1e-2; f32 rel-L2 2e-5 and max-abs 1e-2), then
timed from CUDA graphs at 4096^3 -> bf16 and -> f32, 8 x 1024^3 -> bf16
and 2048^3 -> bf16, the builds in turns (forward, then reverse order, the
minimum of the two), beside torch.matmul or torch.bmm.
"""

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

CHECKS = [  # batch, m, k, n
    (1, 200, 136, 72), (1, 1000, 1000, 1000), (3, 200, 520, 264),
    (1, 129, 8, 4104), (2, 1100, 328, 2056), (4, 520, 72, 4104),
]
TIMES = [(1, 4096, 4096, 4096), (8, 1024, 1024, 1024), (1, 2048, 2048, 2048)]


def build(name, csrc, flags, nvcc, nvcc_flags, out_dir):
    """(fkp_gemm of a library built from csrc's GEMM sources, its path)."""
    srcs = [f for f in ("gemm.cu", "gemm_sm90.cu", "common.cu")
            if os.path.exists(os.path.join(csrc, f))]
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
                                       if "gemm_sm90_kernel" in line
                                       or "spill" in line)[-2000:], flush=True)
    lib = os.path.join(out_dir, f"lib{name}.so")
    subprocess.run([nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
                    *objs, "-o", lib], check=True)
    fn = ctypes.CDLL(lib).fkp_gemm
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp] * 5 + [i32] * 8 + [vp]
    fn.restype = i32
    return fn, 2 if "gemm_sm90.cu" in srcs else 1


def main() -> int:
    import torch

    from flashattention_kernel_project_tpu_torch.ops import _build
    from flashattention_kernel_project_tpu_torch.ops import gemm as g
    from flashattention_kernel_project_tpu_torch.utils import platform

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    _build.library()
    out_dir = os.path.join(_build.BUILD_DIR, "ab")
    os.makedirs(out_dir, exist_ok=True)
    entries = {"this": (g._gemm_kernel(), g.PATH_SM90)}
    probes = set()
    for spec in sys.argv[1:]:
        name, _, rest = spec.partition("=")
        csrc, _, flags = rest.partition(":")
        if "FKP_GEMM_PROBE" in flags:
            probes.add(name)
        entries[name] = build(name, os.path.abspath(csrc),
                              [f for f in flags.split(",") if f], _build.nvcc(),
                              _build.NVCC_FLAGS, out_dir)
    dev = torch.device("cuda", 0)
    bf, f32 = torch.bfloat16, torch.float32

    def run(entry, a, b, out):
        fn, path = entry
        c = torch.empty((a.shape[0], a.shape[1], b.shape[2]), dtype=out, device=dev)
        rc = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), None, None, a.shape[0],
                a.shape[1], b.shape[2], a.shape[2], 1, int(out == bf), 0, path,
                torch.cuda.current_stream().cuda_stream)
        _build.check(rc, "fkp_gemm")
        return c

    gen = torch.Generator(device=dev).manual_seed(5)
    for batch, m, k, n in CHECKS:
        a = torch.randn(batch, m, k, generator=gen, device=dev).to(bf)
        b = torch.randn(batch, k, n, generator=gen, device=dev).to(bf)
        for out in (bf, f32):
            want = g._matmul_plain(a, b, out)
            for name, entry in entries.items():
                if name in probes:
                    continue
                got = run(entry, a, b, out)
                torch.cuda.synchronize()
                err = cs._rel_l2(got, want)
                max_abs = float((got.float() - want.float()).abs().max())
                ok = (err <= cs.BF16_TOL if out == bf else
                      err <= cs.GEMM_F32_TOL and max_abs <= cs.GEMM_MAX_ABS)
                if not ok or not torch.isfinite(got).all():
                    raise SystemExit(f"{name} {batch}x{m}x{k}x{n} -> {out}: rel-L2 "
                                     f"{err:.3e}, max-abs {max_abs:.3e}")
    print(f"{len(entries) - len(probes)} builds held to plain at {len(CHECKS)} shapes, bf16 and "
          f"f32 out | {platform.card_label()}", flush=True)
    for batch, m, k, n in TIMES:
        a = torch.randn(batch, m, k, generator=gen, device=dev).to(bf)
        b = torch.randn(batch, k, n, generator=gen, device=dev).to(bf)
        outs = (bf, f32) if batch == 1 and m == 4096 else (bf,)
        flops = 2 * batch * m * k * n
        for out in outs:
            ms = {}
            for name in [*entries, *reversed(entries)]:
                t = cs.time_ms(lambda e=entries[name]: run(e, a, b, out), dev,
                               graph=True)
                ms[name] = min(ms.get(name, t), t)
            lib = cs.time_ms(lambda: torch.bmm(a, b), dev, graph=True)
            bnd = cs.bound(flops, cs.nbytes(a, b) + batch * m * n * (2 if out == bf else 4))
            print(f"{batch}x{m}x{k}x{n} -> {'bf16' if out == bf else 'f32'}: "
                  f"bound {bnd['bound_ms']:.4f} ms, torch.bmm (bf16 out) "
                  f"{lib:.4f} | " + " | ".join(
                      f"{nm} {t:.4f} ({t / lib:.2f}x, {bnd['bound_ms'] / t:.1%})"
                      for nm, t in ms.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
