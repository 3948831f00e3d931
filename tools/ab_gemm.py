#!/usr/bin/env python3
"""Compare builds of the GEMM (kernels 13 and 14), of the fused-epilogue
GEMM (kernel 15), of the softmax-epilogue GEMM (kernels 16 and 17) or of
the 8-bit GEMMs (kernels 19 and 20) on one card, in turns.

    python3 tools/ab_gemm.py [bf16|f32|epilogue|softmax|w8|i8] [NAME=CSRC_DIR[:FLAG,...] ...]

Each NAME=CSRC_DIR builds that directory's gemm.cu (with gemm_sm90.cu and
gemm_f32_sm90.cu where the directory has them) and common.cu, with the nvcc
flags after ':' (e.g. csrc/gemm_sm90.cuh's probes: -DFKP_GEMM_PROBE=1, 2 or
3 for the loads alone, the products alone, no epilogue), into a library of
its own under flashattention_kernel_project_tpu_torch/build/ab/, beside
this checkout's kernels ("this"). CSRC_DIR is a csrc/ directory: this
checkout's, or another commit's from an unpacked `git archive`. A build is
called on the path that commit's ops/gemm.py took for the operands: bf16 on
the wgmma path (fkp_gemm's path 2) where it has gemm_sm90.cu, f32 on the
f32 wgmma path (3) where it has gemm_f32_sm90.cu, else on the aligned
mma.sync / FFMA path (1).

bf16 (the default runs both parts): every build but a probe
(-DFKP_GEMM_PROBE=1 or 2: the loads or the products alone, gemm_sm90.cuh)
is held against `_matmul_plain` at tile-edge shapes, bf16 and f32 out (bf16
rel-L2 1e-2; f32 rel-L2 2e-5 and max-abs 1e-2), then timed from CUDA graphs
at 4096^3 -> bf16 and -> f32, 8 x 1024^3 -> bf16 and 2048^3 -> bf16, the
builds in turns (forward, then reverse order, the minimum of the two),
beside torch.matmul or torch.bmm.

f32: f32 operands, held the same way at the tile-edge shapes and N = 100
(an f32 wgmma build also against `_matmul_f32_split_plain`, chip_smoke.py's
SPLIT_TOL), then timed at 2048^3 and 1024^3 -> f32 in turns beside
torch.matmul f32 (TF32 off), from a warm L2 (CUDA graphs) and from a cold
one (each call after a 128 MB write, less the write's time).

epilogue (only when named): kernel 15, C = ReLU(A @ B + bias) +
residual, on the builds of the default mode. A build whose fkp_gemm takes
the epilogue on its wgmma paths (this checkout's; found by one small call)
is called there, another (a parent commit's) on its aligned mma.sync /
FFMA path (1). Every build but a probe is held at EPI_CHECKS (bf16 and f32
operands, bias and residual as f32 and bf16, bf16 and f32 out) against
`_fused_epilogue_plain` (bf16 out rel-L2 1e-2; f32 out as the f32 mode,
an f32 wgmma build also against chip_smoke.py's `fused_split_plain`), then
timed at 4096^3 bf16 -> bf16 and -> f32 and at 2048^3 f32 -> f32, from a
warm L2 (CUDA graphs) and a cold one (each call after a 128 MB write, less
the write's time), the builds in turns, beside the unfused PyTorch calls of
the same function (chip_smoke.py's `unfused_epilogue`; f32: torch.matmul
f32 with TF32 off, + bias, relu_, + residual) and this build's GEMM alone
(kernel 13, or the f32 wgmma kernel), with the bound.

softmax (only when named): each NAME=CSRC_DIR builds that directory's
gemm_softmax.cu (with gemm_softmax_sm90.cu where it has it) and common.cu,
and "this" is this checkout's csrc/ built the same way; a build with
gemm_softmax_sm90.cu is called on the wgmma path (2), another on its
aligned mma.sync kernels. csrc/gemm_softmax_sm90.cuh's probes:
-DFKP_GEMM_PROBE=3 (no epilogue: the products alone with their loads) and
4 (the epilogue without the finish's rescale). Every build but a probe is
held at tile-edge shapes, bf16 and f32 out, the rows form against
`_softmax_epilogue_plain` (rel-L2 1e-2, rows summing to 1) and the
resident form, with its gated rows launch after it as the wrapper makes
it, against `_softmax_epilogue_resident_plain` (rel-L2 1e-2, witness 0);
then both forms are timed at config 3 (32 x 2048^3, scale 0.125) -> bf16
and -> f32, at the aligned ragged shapes 3x96x128x160 and
2x1088x256x200 -> bf16 and at 32x2048x2048x256 -> bf16 (N <= 256 with
more bands than half the SMs), from a warm L2 (CUDA graphs) and a cold one (each
call after a 128 MB write, less the write's time), the builds in turns,
beside the unfused torch.bmm + torch.softmax and, at config 3, this
checkout's wgmma GEMM alone (kernel 13) at the same shape.

w8 and i8 (only when named): each NAME=CSRC_DIR builds that directory's
8-bit sources (gemm_w8.cu, gemm_i8.cu, with gemm_w8_sm90.cu and
gemm_i8_sm90.cu where it has them) and common.cu, and "this" is this
checkout's csrc/ built the same way. A build with the wgmma sources is
called on them (kernel 19 with this checkout's `w8_plan`, kernel 20 with
its transposing pass), another on its aligned mma.sync kernels (a parent
commit's), each with its own C arguments. Probes (-DFKP_GEMM_PROBE):
gemm_w8_sm90.cu's 1 (the loads alone), 2 (the products alone), 7 (no
widening); gemm_i8_sm90.cu's 1, 2 and 3 (no epilogue). Every build but a
probe is held first at the tile-edge shapes (I8_CHECKS / W8_CHECKS; bf16
and f32 out; kernel 19 rel-L2 1e-2 for bf16, 2e-5 and max-abs 1e-2 for
f32, with an f32 x rounded first; kernel 20 bit-equal to
`_matmul_i8_plain`). Then w8 times kernel 19 at 4096^3 and at the decode
shape (8 x 2048 x 11008), int8 and e4m3 weights, -> bf16, beside the
engine's three calls (cast, torch.matmul, scale); i8 times kernel 20 at
4096^3 -> f32 (a new build's whole call: the transposing pass and the
GEMM), this build's GEMM alone and its transposing pass alone, beside
torch._int_mm + scales with B row-major and column-major and torch._int_mm
alone (column-major B; not the same function, a yardstick). Both from a
warm L2 (CUDA graphs, the builds in turns) and from a cold one (each call
after a 128 MB write, less the write's time), with the bound.
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
F32_CHECKS = CHECKS + [(1, 200, 132, 100)]
TIMES = [(1, 4096, 4096, 4096), (8, 1024, 1024, 1024), (1, 2048, 2048, 2048)]
F32_TIMES = [2048, 1024]
FLUSH_MB = 128  # written before a call timed from a cold L2 (the H100's holds 50)
SOURCES = ("gemm.cu", "gemm_sm90.cu", "gemm_f32_sm90.cu", "common.cu")


def compile_library(name, csrc, sources, flags, nvcc, nvcc_flags, out_dir, show):
    """(the library built from those of `sources` that csrc has, one nvcc
    process a source, all at once, then linked; the sources it has).
    Prints each compile's lines that `show` picks."""
    srcs = [f for f in sources if os.path.exists(os.path.join(csrc, f))]
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
                                       if show(line))[-3000:], flush=True)
    lib = os.path.join(out_dir, f"lib{name}.so")
    subprocess.run([nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
                    *objs, "-o", lib], check=True)
    return ctypes.CDLL(lib), srcs


def build(name, csrc, flags, nvcc, nvcc_flags, out_dir):
    """(fkp_gemm of a library built from csrc's GEMM sources, its path for
    bf16 operands, its path for f32 operands)."""
    lib, srcs = compile_library(
        name, csrc, SOURCES, flags, nvcc, nvcc_flags, out_dir,
        lambda line: "gemm_sm90_kernel" in line or "gemm_f32_sm90_kernel" in line
        or "spill" in line)
    fn = lib.fkp_gemm
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp] * 5 + [i32] * 8 + [vp]
    fn.restype = i32
    return fn, 2 if "gemm_sm90.cu" in srcs else 1, 3 if "gemm_f32_sm90.cu" in srcs else 1


EPI_CHECKS = [  # m, k, n (batch 1): the tiles' edges of both kernels
    (200, 136, 72), (1000, 1000, 1000), (129, 8, 4104), (2100, 72, 2056),
    (200, 132, 100)]
EPI_TIMES = [(4096, "bf16"), (2048, "f32")]


def epilogue_part(entries, probes, dev, label):
    """Kernel 15's builds held at EPI_CHECKS, then timed at EPI_TIMES
    (module docstring)."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import _build
    from flashattention_kernel_project_tpu_torch.ops import gemm as g

    bf, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(15)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def call(fn, path, a, b, bias, res, out):
        m, k = a.shape
        n = b.shape[1]
        c = torch.empty((m, n), dtype=out, device=dev)
        rc = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                None if bias is None else bias.data_ptr(),
                None if res is None else res.data_ptr(), 1, m, n, k,
                int(a.dtype == bf), int(out == bf), int(bias is not None), path, stream())
        return rc, c

    # a build's path for each operand type: its wgmma path where its
    # fkp_gemm takes the epilogue there, else the aligned core's
    paths = {}
    for name, (fn, p16, p32) in entries.items():
        x = torch.zeros(8, 8, dtype=bf, device=dev)
        z = torch.zeros(8, device=dev)
        rc, _ = call(fn, p16, x, x, z, torch.zeros(8, 8, device=dev), f32)
        torch.cuda.synchronize()
        paths[name] = {bf: p16, f32: p32} if rc == 0 else {bf: 1, f32: 1}
    print("epilogue paths (bf16, f32 operands): " + ", ".join(
        f"{name} {p[bf]}/{p[f32]}" for name, p in paths.items()), flush=True)

    def run(name, a, b, bias, res, out):
        rc, c = call(entries[name][0], paths[name][a.dtype], a, b, bias, res, out)
        _build.check(rc, f"{name} fkp_gemm")
        return c

    held = [name for name in entries if name not in probes]
    for m, k, n in EPI_CHECKS:
        for dt in (bf, f32):
            if dt == bf and n % 8:
                continue
            a = torch.randn(m, k, generator=gen, device=dev).to(dt)
            b = torch.randn(k, n, generator=gen, device=dev).to(dt)
            for side in (f32, bf):
                bias = torch.randn(n, generator=gen, device=dev).to(side)
                res = torch.randn(m, n, generator=gen, device=dev).to(side)
                for out in (bf, f32):
                    want = g._fused_epilogue_plain(a, b, bias, res, out)
                    split = cs.fused_split_plain(a, b, bias, res, out) if dt == f32 else None
                    for name in held:
                        got = run(name, a, b, bias.float(), res.float(), out)
                        torch.cuda.synchronize()
                        what = (f"{name} epilogue {'bf16' if dt == bf else 'f32'} {m}x{k}x{n}"
                                f" ({str(side)[6:]} bias) -> {'bf16' if out == bf else 'f32'}")
                        try:
                            cs._hold_gemm(what, got, want, out,
                                          split if paths[name][f32] == 3 else None)
                        except AssertionError as err:
                            raise SystemExit(str(err))
    print(f"{len(held)} builds held to plain at the epilogue's tile-edge shapes, bf16 "
          f"and f32 operands and out | {label}", flush=True)

    scratch = torch.empty(FLUSH_MB << 20, dtype=torch.uint8, device=dev)
    flush = lambda: scratch.fill_(1)  # noqa: E731
    this = entries["this"][0]
    for size, kind in EPI_TIMES:
        dt = bf if kind == "bf16" else f32
        a = torch.randn(size, size, generator=gen, device=dev).to(dt)
        b = torch.randn(size, size, generator=gen, device=dev).to(dt)
        bias = torch.randn(size, generator=gen, device=dev)
        res = torch.randn(size, size, generator=gen, device=dev)
        for out in (bf, f32) if dt == bf else (f32,):
            fns = {name: (lambda name=name: run(name, a, b, bias, res, out))
                   for name in entries}
            if dt == bf:
                fns["unfused calls"] = cs.unfused_epilogue(a, b, bias, res, out)
            else:
                fns["unfused calls"] = lambda: (torch.matmul(a, b) + bias).relu_().add_(res)
            alone = "kernel 13 alone" if dt == bf else "the f32 wgmma kernel alone"
            fns[alone] = lambda: _build.check(
                call(this, 2 if dt == bf else 3, a, b, None, None, out)[0], "fkp_gemm")
            warm = cs.time_turns(fns, dev)
            cold = cs.time_turns({"flush": flush, **{
                key: (lambda f=f: (flush(), f())) for key, f in fns.items()}}, dev)
            passes = 1 if dt == bf else 6  # the f32 kernel's six bf16 products
            bnd = cs.bound(passes * 2 * size ** 3, cs.nbytes(a, b, bias, res)
                           + size * size * (2 if out == bf else 4))
            for how, ms, less in (("warm L2", warm, 0.0), ("cold L2", cold, cold["flush"])):
                lib = ms["unfused calls"] - less
                print(f"fused epilogue {kind} {size}^3 -> {'bf16' if out == bf else 'f32'}, "
                      f"{how}" + (f" (less the {FLUSH_MB} MB write's {less:.4f} ms)"
                                  if less else "")
                      + f": bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}) | " + " | ".join(
                          f"{key} {ms[key] - less:.4f} ({lib / (ms[key] - less):.2f}x under "
                          f"the unfused calls, {bnd['bound_ms'] / (ms[key] - less):.1%})"
                          for key in fns) + f" | {label}", flush=True)


SOFTMAX_SOURCES = ("gemm_softmax.cu", "gemm_softmax_sm90.cu", "common.cu")
SOFTMAX_CHECKS = [  # batch, m, k, n: the band's rows and the N tiles' edges
    (1, 1, 8, 8), (3, 96, 128, 160), (2, 1088, 256, 200), (1, 129, 72, 4104),
    (2, 127, 2048, 264), (3, 128, 72, 248), (1, 1024, 256, 128)]
SOFTMAX_TIMES = [(32, 2048, 2048, 2048), (3, 96, 128, 160), (2, 1088, 256, 200),
                 (32, 2048, 2048, 256)]
SCALE = 0.125


def build_softmax(name, csrc, flags, nvcc, nvcc_flags, out_dir):
    """(fkp_gemm_softmax, fkp_gemm_softmax_resident, whether the build has
    the wgmma kernel) of a library built from csrc's softmax sources."""
    cdll, srcs = compile_library(
        f"sm_{name}", csrc, SOFTMAX_SOURCES, flags, nvcc, nvcc_flags, out_dir,
        lambda line: "Used" in line or "spill" in line or "serialized" in line)
    new = "gemm_softmax_sm90.cu" in srcs
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    rows, res = cdll.fkp_gemm_softmax, cdll.fkp_gemm_softmax_resident
    tail = [i32] * 4 + [ctypes.c_float, i32, i32, vp]
    rows.argtypes = [vp] * (6 if new else 5) + tail
    res.argtypes = [vp] * 5 + tail
    rows.restype = res.restype = i32
    return rows, res, new


def softmax_part(entries, probes, dev, label):
    """The softmax builds held at SOFTMAX_CHECKS, then timed at
    SOFTMAX_TIMES (module docstring)."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import _build
    from flashattention_kernel_project_tpu_torch.ops import gemm as g

    bf, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(21)
    scale_log2 = SCALE * 1.4426950408889634

    def run(entry, a, b, bias, out, resident):
        rows, res, new = entry
        batch, m, k = a.shape
        n = b.shape[2]
        c = torch.empty((batch, m, n), dtype=out, device=dev)
        args = (batch, m, n, k, scale_log2, int(out == bf), 2 if new else 1,
                torch.cuda.current_stream().cuda_stream)
        gate = None
        if resident:
            witness = torch.zeros((), dtype=torch.int32, device=dev)
            _build.check(res(a.data_ptr(), b.data_ptr(), bias.data_ptr(), c.data_ptr(),
                             witness.data_ptr(), *args), "fkp_gemm_softmax_resident")
            gate = witness.data_ptr()
            run.witness = witness
        ws = ([torch.empty(batch * m * -(-n // 128), device=dev).data_ptr()]
              if new else [])
        _build.check(rows(a.data_ptr(), b.data_ptr(), bias.data_ptr(), c.data_ptr(),
                          gate, *ws, *args), "fkp_gemm_softmax")
        return c

    def inputs(batch, m, k, n):
        return (torch.randn(batch, m, k, generator=gen, device=dev).to(bf),
                torch.randn(batch, k, n, generator=gen, device=dev).to(bf),
                torch.randn(n, generator=gen, device=dev))

    for batch, m, k, n in SOFTMAX_CHECKS:
        a, b, bias = inputs(batch, m, k, n)
        for out in (bf, f32):
            rows_want = g._softmax_epilogue_plain(a, b, bias, SCALE, out)
            res_want = g._softmax_epilogue_resident_plain(a, b, bias, SCALE, out)[0]
            for name, entry in entries.items():
                if name in probes:
                    continue
                for resident, want in ((False, rows_want), (True, res_want)):
                    got = run(entry, a, b, bias, out, resident)
                    torch.cuda.synchronize()
                    what = (f"{name} {'resident' if resident else 'rows'} "
                            f"{batch}x{m}x{k}x{n} -> {'bf16' if out == bf else 'f32'}")
                    err = cs._rel_l2(got, want)
                    dev_sum = float((got.float().sum(-1) - 1.0).abs().max())
                    if not (torch.isfinite(got).all() and err <= cs.BF16_TOL
                            and dev_sum <= cs.RESIDENT_ROW_RTOL):
                        raise SystemExit(f"{what}: rel-L2 {err:.3e}, rows sum to 1 "
                                         f"+- {dev_sum:.3e}")
                    if resident and int(run.witness):
                        raise SystemExit(f"{what}: witness {int(run.witness)}")
    print(f"{len(entries) - len(probes)} softmax builds held to plain at the "
          f"tile-edge shapes, rows and resident, bf16 and f32 out | {label}",
          flush=True)

    scratch = torch.empty(FLUSH_MB << 20, dtype=torch.uint8, device=dev)
    flush = lambda: scratch.fill_(1)  # noqa: E731
    gemm13 = build("gemm13", _build.CSRC, [], _build.nvcc(), _build.NVCC_FLAGS,
                   os.path.join(_build.BUILD_DIR, "ab"))
    for batch, m, k, n in SOFTMAX_TIMES:
        a, b, bias = inputs(batch, m, k, n)
        config3 = (batch, m, k, n) == SOFTMAX_TIMES[0]
        iters = 10 if config3 else 50
        for out in (bf, f32) if config3 else (bf,):
            oname = "bf16" if out == bf else "f32"
            fns = {}
            for resident in (False, True):
                form = "resident" if resident else "rows"
                for name, entry in entries.items():
                    fns[f"{name} {form}"] = (
                        lambda e=entry, r=resident: run(e, a, b, bias, out, r))
            fns["bmm + softmax"] = lambda: torch.softmax(
                torch.bmm(a, b).float() * SCALE + bias, dim=-1).to(out)
            if config3:
                fn13 = gemm13[0]

                def gemm_alone():
                    c = torch.empty((batch, m, n), dtype=out, device=dev)
                    _build.check(fn13(a.data_ptr(), b.data_ptr(), c.data_ptr(), None,
                                      None, batch, m, n, k, 1, int(out == bf), 0, 2,
                                      torch.cuda.current_stream().cuda_stream), "fkp_gemm")
                fns["GEMM alone (kernel 13)"] = gemm_alone
            warm = {}
            for _ in range(2):  # in turns: forward, then reverse order
                for key in list(fns) if not warm else reversed(list(fns)):
                    t = cs.time_ms(fns[key], dev, iters, graph=True)
                    warm[key] = min(warm.get(key, t), t)
            cold = cs.time_turns({"flush": flush, **{
                key: (lambda f=f: (flush(), f())) for key, f in fns.items()}}, dev,
                iters=iters)
            bnd = cs.bound(2 * batch * m * n * k,
                           cs.nbytes(a, b, bias) + batch * m * n * (2 if out == bf else 4))
            for what, ms, less in (("warm L2", warm, 0.0),
                                   ("cold L2", cold, cold["flush"])):
                lib = ms["bmm + softmax"] - less
                print(f"softmax epilogue {batch}x{m}x{k}x{n} -> {oname}, {what}"
                      + (f" (less the {FLUSH_MB} MB write's {less:.4f} ms)" if less else "")
                      + f": bound {bnd['bound_ms']:.4f} ms | " + " | ".join(
                          f"{key} {ms[key] - less:.4f} ({lib / (ms[key] - less):.2f}x "
                          f"under bmm + softmax, {bnd['bound_ms'] / (ms[key] - less):.1%})"
                          for key in fns) + f" | {label}", flush=True)


EIGHT_SOURCES = ("gemm_w8.cu", "gemm_w8_sm90.cu", "gemm_i8.cu", "gemm_i8_sm90.cu",
                 "common.cu")
W8_CHECKS = cs.W8_EDGES + [(8, 2048, 11008)]  # m, k, n
I8_CHECKS = cs.I8_EDGES + [(300, 4096, 528)]
W8_TIMES = [(4096, 4096, 4096), (8, 2048, 11008)]
I8_TIMES = [(4096, 4096, 4096)]


def build_8bit(name, csrc, flags, nvcc, nvcc_flags, out_dir):
    """The 8-bit entries of a library built from csrc's 8-bit sources, as
    (w8, i8, new): w8(x, w_q, w_scale, out) and i8(a_q, a_scale, b_q,
    b_scale, out) call it as that commit's ops/quant.py does on aligned
    operands; new: whether it has the wgmma sources."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import _build
    from flashattention_kernel_project_tpu_torch.ops import quant as qt

    cdll, srcs = compile_library(
        f"q_{name}", csrc, EIGHT_SOURCES, flags, nvcc, nvcc_flags, out_dir,
        lambda line: "Used" in line or "spill" in line or "serialized" in line)
    new = "gemm_w8_sm90.cu" in srcs and "gemm_i8_sm90.cu" in srcs
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    if new:
        w8_fn, i8_fn, tr_fn = (cdll.fkp_gemm_w8_sm90, cdll.fkp_gemm_i8_sm90,
                               cdll.fkp_gemm_i8_transpose)
        w8_fn.argtypes = [vp] * 4 + [i32] * 7 + [vp]
        i8_fn.argtypes = [vp] * 5 + [i32] * 4 + [vp]
        tr_fn.argtypes = [vp] * 2 + [i32] * 2 + [vp]
        tr_fn.restype = i32
    else:
        w8_fn, i8_fn = cdll.fkp_gemm_w8, cdll.fkp_gemm_i8
        w8_fn.argtypes = [vp] * 4 + [i32] * 6 + [vp]
        i8_fn.argtypes = [vp] * 5 + [i32] * 5 + [vp]
    w8_fn.restype = i8_fn.restype = i32
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def w8(x, wq, ws, out):
        m, k = x.shape
        n = wq.shape[1]
        c = torch.empty((m, n), dtype=out, device=x.device)
        fp8, bf = int(wq.dtype == torch.float8_e4m3fn), int(out == torch.bfloat16)
        tail = (list(qt.w8_plan(m, n, sms)) if new else [1]) + [stream()]
        _build.check(w8_fn(x.data_ptr(), wq.data_ptr(), ws.data_ptr(), c.data_ptr(),
                           m, n, k, fp8, bf, *tail), f"{name} w8")
        return c

    def transpose(b):
        bt = torch.empty((b.shape[1], b.shape[0]), dtype=torch.int8, device=b.device)
        _build.check(tr_fn(b.data_ptr(), bt.data_ptr(), b.shape[0], b.shape[1],
                           stream()), f"{name} transpose")
        return bt

    def i8(a, a_s, b, b_s, out, bt=None):
        m, k = a.shape
        n = b.shape[1]
        c = torch.empty((m, n), dtype=out, device=a.device)
        bf = int(out == torch.bfloat16)
        if new:
            bt = transpose(b) if bt is None else bt
            rc = i8_fn(a.data_ptr(), bt.data_ptr(), a_s.data_ptr(), b_s.data_ptr(),
                       c.data_ptr(), m, n, k, bf, stream())
        else:
            rc = i8_fn(a.data_ptr(), b.data_ptr(), a_s.data_ptr(), b_s.data_ptr(),
                       c.data_ptr(), m, n, k, bf, 1, stream())
        _build.check(rc, f"{name} i8")
        return c

    i8.transpose = transpose if new else None
    return w8, i8, new


def eight_bit_part(kind, entries, probes, dev, label):
    """The 8-bit builds held at W8_CHECKS or I8_CHECKS, then timed at
    W8_TIMES or I8_TIMES (module docstring)."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import quant as qt
    from flashattention_kernel_project_tpu_torch.utils import platform

    bf, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(22)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def weights(k, n, fmt):
        w = rand(k, n)
        return qt.quantize_int8(w, axis=0) if fmt == "int8" else qt.quantize_fp8_weights(w)

    held = [name for name in entries if name not in probes]
    if kind == "w8":
        for i, (m, k, n) in enumerate(W8_CHECKS):
            x = rand(m, k).to(bf)
            for fmt in ("int8", "fp8"):
                wq, ws = weights(k, n, fmt)
                for out in (bf, f32):
                    want = qt._matmul_w8_plain(x, wq, ws, out)
                    for name in held:
                        got = entries[name][0](x, wq, ws, out)
                        torch.cuda.synchronize()
                        try:
                            cs._hold_gemm(f"{name} w8 {fmt} {m}x{k}x{n}", got, want, out)
                        except AssertionError as err:
                            raise SystemExit(f"{err} -> {out}")
    else:
        for m, k, n in I8_CHECKS:
            a_q, a_s = qt.quantize_int8(rand(m, k), axis=1)
            b_q, b_s = qt.quantize_int8(rand(k, n), axis=0)
            for out in (f32, bf):
                want = qt._matmul_i8_plain(a_q, a_s, b_q, b_s, out)
                for name in held:
                    got = entries[name][1](a_q, a_s, b_q, b_s, out)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        raise SystemExit(f"{name} i8 {m}x{k}x{n} -> {out}: not bit-equal "
                                         f"to plain (rel-L2 {cs._rel_l2(got, want):.3e})")
    print(f"{len(held)} builds held to plain at the {kind} tile-edge shapes, bf16 and "
          f"f32 out | {label}", flush=True)

    scratch = torch.empty(FLUSH_MB << 20, dtype=torch.uint8, device=dev)
    flush = lambda: scratch.fill_(1)  # noqa: E731
    cases = []  # (what, fns, flops, bytes, peak)
    if kind == "w8":
        for m, k, n in W8_TIMES:
            x = rand(m, k).to(bf)
            for fmt in ("int8", "fp8"):
                wq, ws = weights(k, n, fmt)
                fns = {name: (lambda e=e, x=x, wq=wq, ws=ws: e[0](x, wq, ws, bf))
                       for name, e in entries.items()}
                fns["cast + matmul + scale"] = (
                    lambda x=x, wq=wq, ws=ws: (torch.matmul(x, wq.to(bf)) * ws).to(bf))
                plan = qt.w8_plan(m, n, torch.cuda.get_device_properties(0)
                                  .multi_processor_count)
                cases.append((f"w8 {fmt} {m}x{k}x{n} -> bf16 (tiles {plan})", fns, 2 * m * k * n, cs.nbytes(x, wq, ws) + 2 * m * n,
                              platform.H100_BF16_FLOPS))
    else:
        for m, k, n in I8_TIMES:
            a_q, a_s = qt.quantize_int8(rand(m, k), axis=1)
            b_q, b_s = qt.quantize_int8(rand(k, n), axis=0)
            b_col = b_q.t().contiguous().t()
            fns = {name: (lambda e=e: e[1](a_q, a_s, b_q, b_s, f32))
                   for name, e in entries.items()}
            this = entries["this"][1]
            bt = this.transpose(b_q)
            fns["this: GEMM alone"] = lambda: this(a_q, a_s, b_q, b_s, f32, bt=bt)
            fns["this: transposing pass alone"] = lambda: this.transpose(b_q)
            fns["_int_mm + scales (B row-major)"] = (
                lambda: (torch._int_mm(a_q, b_q).float() * a_s * b_s))
            fns["_int_mm + scales (B column-major)"] = (
                lambda: (torch._int_mm(a_q, b_col).float() * a_s * b_s))
            fns["_int_mm alone (B column-major)"] = lambda: torch._int_mm(a_q, b_col)
            cases.append((f"i8 {m}x{k}x{n} -> f32 (transposing pass bound "
                          f"{cs.bound(0, 2 * k * n)['bound_ms']:.4f} ms)", fns,
                          2 * m * k * n, cs.nbytes(a_q, a_s, b_q, b_s) + 4 * m * n,
                          platform.H100_INT8_OPS))
    for what, fns, flops, nbytes, peak in cases:
        warm = cs.time_turns(fns, dev)
        cold = cs.time_turns({"flush": flush, **{
            key: (lambda f=f: (flush(), f())) for key, f in fns.items()}}, dev)
        bnd = cs.bound(flops, nbytes, peak)
        for how, ms, less in (("warm L2", warm, 0.0), ("cold L2", cold, cold["flush"])):
            print(f"{what}, {how}" + (f" (less the {FLUSH_MB} MB write's {less:.4f} ms)"
                                      if less else "")
                  + f": bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}) | " + " | ".join(
                      f"{key} {ms[key] - less:.4f} ({bnd['bound_ms'] / (ms[key] - less):.1%})"
                      for key in fns) + f" | {label}", flush=True)


def main() -> int:
    import torch

    from flashattention_kernel_project_tpu_torch.ops import _build
    from flashattention_kernel_project_tpu_torch.ops import gemm as g
    from flashattention_kernel_project_tpu_torch.utils import platform

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    args = sys.argv[1:]
    parts = ("bf16", "f32")
    if args and args[0] in (*parts, "epilogue", "softmax", "w8", "i8"):
        parts, args = (args[0],), args[1:]
    torch.backends.cuda.matmul.allow_tf32 = False
    out_dir = os.path.join(_build.BUILD_DIR, "ab")
    os.makedirs(out_dir, exist_ok=True)
    if parts == ("softmax",):
        entries, probes = {}, set()
        for spec in [f"this={_build.CSRC}", *args]:
            name, _, rest = spec.partition("=")
            csrc, _, flags = rest.partition(":")
            if "FKP_GEMM_PROBE" in flags:
                probes.add(name)
            entries[name] = build_softmax(name, os.path.abspath(csrc),
                                          [f for f in flags.split(",") if f],
                                          _build.nvcc(), _build.NVCC_FLAGS, out_dir)
        softmax_part(entries, probes, torch.device("cuda", 0), platform.card_label())
        return 0
    if parts in (("w8",), ("i8",)):
        entries, probes = {}, set()
        for spec in [f"this={_build.CSRC}", *args]:
            name, _, rest = spec.partition("=")
            csrc, _, flags = rest.partition(":")
            if "FKP_GEMM_PROBE" in flags:
                probes.add(name)
            entries[name] = build_8bit(name, os.path.abspath(csrc),
                                       [f for f in flags.split(",") if f],
                                       _build.nvcc(), _build.NVCC_FLAGS, out_dir)
        eight_bit_part(parts[0], entries, probes, torch.device("cuda", 0),
                       platform.card_label())
        return 0
    _build.library()
    entries = {"this": (g._gemm_kernel(), g.PATH_SM90, g.PATH_SM90_F32)}
    probes = set()
    for spec in args:
        name, _, rest = spec.partition("=")
        csrc, _, flags = rest.partition(":")
        if "FKP_GEMM_PROBE" in flags:
            probes.add(name)
        entries[name] = build(name, os.path.abspath(csrc),
                              [f for f in flags.split(",") if f], _build.nvcc(),
                              _build.NVCC_FLAGS, out_dir)
    dev = torch.device("cuda", 0)
    bf, f32 = torch.bfloat16, torch.float32
    label = platform.card_label()
    if parts == ("epilogue",):
        epilogue_part(entries, probes, dev, label)
        return 0

    def run(entry, a, b, out):
        fn, bf16_path, f32_path = entry
        c = torch.empty((a.shape[0], a.shape[1], b.shape[2]), dtype=out, device=dev)
        rc = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), None, None, a.shape[0],
                a.shape[1], b.shape[2], a.shape[2], int(a.dtype == bf), int(out == bf),
                0, bf16_path if a.dtype == bf else f32_path,
                torch.cuda.current_stream().cuda_stream)
        _build.check(rc, "fkp_gemm")
        return c

    gen = torch.Generator(device=dev).manual_seed(5)
    for dt in (bf, f32):
        kind = "bf16" if dt == bf else "f32"
        if kind not in parts:
            continue
        for batch, m, k, n in CHECKS if dt == bf else F32_CHECKS:
            a = torch.randn(batch, m, k, generator=gen, device=dev).to(dt)
            b = torch.randn(batch, k, n, generator=gen, device=dev).to(dt)
            for out in (bf, f32):
                want = g._matmul_plain(a, b, out)
                split = g._matmul_f32_split_plain(a, b, out) if dt == f32 else None
                for name, entry in entries.items():
                    if name in probes:
                        continue
                    got = run(entry, a, b, out)
                    torch.cuda.synchronize()
                    try:
                        cs._hold_gemm(f"{name} {kind} {batch}x{m}x{k}x{n}", got, want,
                                      out, split if entry[2] == 3 and dt == f32 else None)
                    except AssertionError as err:
                        raise SystemExit(f"{err} -> {out}")
        print(f"{len(entries) - len(probes)} builds held to plain at the {kind} "
              f"tile-edge shapes, bf16 and f32 out | {label}", flush=True)
    if "bf16" in parts:
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
    if "f32" in parts:
        scratch = torch.empty(FLUSH_MB << 20, dtype=torch.uint8, device=dev)
        flush = lambda: scratch.fill_(1)  # noqa: E731
        for size in F32_TIMES:
            a = torch.randn(1, size, size, generator=gen, device=dev)
            b = torch.randn(1, size, size, generator=gen, device=dev)
            fns = {**{name: (lambda e=entry: run(e, a, b, f32))
                      for name, entry in entries.items()},
                   "torch.matmul": lambda: torch.matmul(a, b)}
            warm = cs.time_turns(fns, dev)
            cold = cs.time_turns({"flush": flush, **{
                key: (lambda f=f: (flush(), f())) for key, f in fns.items()}}, dev)
            flops = 2 * size ** 3
            bnd = cs.bound(6 * flops, cs.nbytes(a, b) + 4 * size * size)
            ffma = cs.bound(flops, cs.nbytes(a, b) + 4 * size * size,
                            platform.H100_FP32_FLOPS)
            for what, ms, less in (("warm L2", warm, 0.0), ("cold L2", cold, cold["flush"])):
                lib = ms["torch.matmul"] - less
                print(f"f32 {size}^3 -> f32, {what}"
                      + (f" (less the {FLUSH_MB} MB write's {less:.4f} ms)" if less else "")
                      + f": bound {bnd['bound_ms']:.4f} ms (six bf16 products), FFMA "
                      f"bound {ffma['bound_ms']:.4f} | " + " | ".join(
                          f"{nm} {ms[nm] - less:.4f} ({(ms[nm] - less) / lib:.2f}x "
                          f"torch.matmul, {bnd['bound_ms'] / (ms[nm] - less):.1%})"
                          for nm in fns) + f" | {label}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
