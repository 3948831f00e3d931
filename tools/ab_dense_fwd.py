#!/usr/bin/env python3
"""Compare builds of the dense attention forward (kernels 1 and 2), or of
its stage probes copy, qk, pv, the softmax chain, qk_kt and qk_packed (rows
22 and 23), on one card, in turns.

    python3 tools/ab_dense_fwd.py [probes] [NAME=CSRC_DIR[:FLAG,...] ...]

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

probes: each NAME=CSRC_DIR (and "this", this checkout's csrc/) builds its
probes.cu (with probes_sm90.cu where it has it) and common.cu; each stage
is called on probes_sm90.cu's entry where the build's entry takes it (the
Hopper forward's block: copy, qk and pv wherever the build has that
source, qk_kt and qk_packed where it has kProbeQKT, the chain where it has
kProbeChain), else on probes.cu's fkp_probe (an older commit's template,
with its own arguments), the kernel alone on operands built before (K^T,
the packed q and K). Every build is held to the plain versions (copy and
chain within 1e-6 relative, the products rel-L2 1e-5) at PROBE_CHECKS
(qk_packed at d / 2), then timed at profile_attention.py's shape (1 x 16/4
x 4096 x 128, non-causal, block_k 512) and at d = 64, the builds in turns
beside this checkout's fused forward (stable and stable=False) at the same
shape; qk_packed at d / 2 (block_k 512), the products of qk at d. Printed:
each stage against its bound (the function's; pv's also with p's bf16 pair,
two products; qk_packed's over its packed products and over the unpacked
ones; the chain's the exp2 unit's, 16 a clock an SM at the card's highest
SM clock, one exp2 a score and one a block_k tile's rescale, as
chip_smoke.py's), the forward's split (copy, qk, pv and chain against the
fused forward: the products' sum, the fused time outside them and the
chain's time beside it), and this checkout's whole calls of qk_kt_probe
and qk_packed_probe (the torch transpose or packing included) beside the
transpose and the packing alone.
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


PROBE_CHECKS = [  # b, hq, hkv, n, s, d, block_k
    (1, 16, 4, 4096, 4096, 128, 512), (2, 4, 2, 192, 320, 128, 64),
    (2, 4, 2, 192, 320, 64, 64), (1, 16, 4, 1024, 1024, 64, 128),
    (4, 16, 4, 192, 320, 128, 64)]
PROBE_TIMES = [128, 64]  # d at 1 x 16/4 x 4096, non-causal
STAGES = {"copy": 0, "qk": 1, "pv": 2, "chain": 3, "qk_kt": 4, "qk_packed": 5}


def build_probes(name, csrc, flags, nvcc, nvcc_flags, out_dir):
    """probe(stage, q, k, v, block_k, out, sizes) over a library built from
    csrc's probe sources, sizes (hq, hkv, n, s, d) as ops/probes.py's
    probe_sizes gives them: probes_sm90.cu's entry for the stages it takes,
    else probes.cu's (without block_k since probes_sm90.cu exists, with it
    before)."""
    srcs = [f for f in ("probes.cu", "probes_sm90.cu", "common.cu")
            if os.path.exists(os.path.join(csrc, f))]
    objs = [os.path.join(out_dir, f"pr_{name}.{f}.o") for f in srcs]
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
                                       if "Used" in line or "spill" in line)[-2000:],
              flush=True)
    lib = os.path.join(out_dir, f"libpr_{name}.so")
    subprocess.run([nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
                    *objs, "-o", lib], check=True)
    cdll = ctypes.CDLL(lib)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    sm90_stages = set()
    if "probes_sm90.cu" in srcs:
        with open(os.path.join(csrc, "probes_sm90.cu")) as f:
            text = f.read()
        sm90_stages = ({0, 1, 2} | ({4, 5} if "kProbeQKT" in text else set())
                       | ({3} if "kProbeChain" in text else set()))
        cdll.fkp_probe_sm90.argtypes = [vp] * 4 + [i32] * 8 + [vp]
        cdll.fkp_probe_sm90.restype = i32
    if hasattr(cdll, "fkp_probe"):  # the older template's entry
        cdll.fkp_probe.argtypes = [vp] * 4 + [i32] * (7 if sm90_stages else 8) + [
            ctypes.c_float, vp]
        cdll.fkp_probe.restype = i32

    def probe(stage, q, k, v, block_k, out, sizes):
        import torch

        args = [q.data_ptr(), k.data_ptr(), 0 if v is None else v.data_ptr(),
                out.data_ptr(), q.shape[0], *sizes, stage]
        stream = torch.cuda.current_stream().cuda_stream
        if stage in sm90_stages:
            rc = cdll.fkp_probe_sm90(*args, block_k, stream)
        elif sm90_stages:
            rc = cdll.fkp_probe(*args, 0.0, stream)
        else:
            rc = cdll.fkp_probe(*args, block_k, 0.0, stream)
        if rc:
            raise SystemExit(f"{name} probe stage {stage}: CUDA error {rc}")
        return out
    return probe


def probes_main(specs) -> int:
    """The probes mode (module docstring)."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import _build
    from flashattention_kernel_project_tpu_torch.ops import flash_attention as fa
    from flashattention_kernel_project_tpu_torch.ops import probes as pr
    from flashattention_kernel_project_tpu_torch.utils import platform

    _build.library()
    out_dir = os.path.join(_build.BUILD_DIR, "ab")
    os.makedirs(out_dir, exist_ok=True)
    entries = {}
    for spec in [f"this={_build.CSRC}", *specs]:
        name, _, rest = spec.partition("=")
        csrc, _, flags = rest.partition(":")
        entries[name] = build_probes(name, os.path.abspath(csrc),
                                     [f for f in flags.split(",") if f], _build.nvcc(),
                                     _build.NVCC_FLAGS, out_dir)
    dev = torch.device("cuda", 0)
    label = platform.card_label()
    clock = cs.max_sm_clock_hz()
    gen = torch.Generator(device=dev).manual_seed(23)

    def inputs(b, hq, hkv, n, s, d):
        return (torch.randn(b, hq, n, d, generator=gen, device=dev).bfloat16(),
                torch.randn(b, hkv, s, d, generator=gen, device=dev).bfloat16(),
                torch.randn(b, hkv, s, d, generator=gen, device=dev).bfloat16())

    def operands(stage, q, k, v, block_k):
        """The kernel's operands for the caller's q, k, v (K^T for qk_kt, the
        packed q and K for qk_packed), and its sizes."""
        sizes = pr.probe_sizes(STAGES[stage], q, k)
        if stage == "qk_kt":
            return (q, k.transpose(-1, -2).contiguous(), None), sizes
        if stage == "qk_packed":
            return (*pr._pack(q, k, block_k), None), sizes
        return (q, k, v), sizes

    def run(name, stage, ops, sizes, block_k):
        out = torch.empty(ops[0].shape[0], sizes[0], sizes[2], sizes[4],
                          dtype=torch.float32, device=dev)
        return entries[name](STAGES[stage], *ops, block_k, out, sizes)

    def halves(q, k, v):
        """q, k, v cut to half their width: qk_packed's inputs, whose
        packed width is d."""
        return [t[..., :t.shape[-1] // 2].contiguous() for t in (q, k, v)]

    for b, hq, hkv, n, s, d, block_k in PROBE_CHECKS:
        q, k, v = inputs(b, hq, hkv, n, s, d)
        qh, kh, vh = halves(q, k, v)
        plain = dict(copy=pr._copy_plain(q, k, v, block_k), qk=pr._qk_plain(q, k),
                     pv=pr._pv_plain(q, v), chain=pr._chain_plain(q, s, block_k),
                     qk_kt=pr._qk_plain(q, k),
                     qk_packed=pr._packed_plain(qh, kh).reshape(b, hkv // 2, -1, d))
        for stage, want in plain.items():
            ops = operands(stage, *((qh, kh, vh) if stage == "qk_packed" else (q, k, v)),
                           block_k)
            for name in entries:
                got = run(name, stage, *ops, block_k)
                torch.cuda.synchronize()
                if stage in ("copy", "chain"):
                    err = float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())
                    ok = err <= cs.EXACT_RTOL
                else:
                    err = cs._rel_l2(got, want)
                    ok = err <= cs.SUM_ORDER_TOL
                if not (ok and torch.isfinite(got).all()):
                    raise SystemExit(f"{name} {stage} {b}x{hq}/{hkv}x{n}x{s}x{d} "
                                     f"block_k {block_k}: error {err:.3e}")
    print(f"{len(entries)} builds' {', '.join(STAGES)} held to plain at "
          f"{len(PROBE_CHECKS)} shapes (qk_packed at d / 2) | {label}", flush=True)
    for d in PROBE_TIMES:
        q, k, v = inputs(1, 16, 4, 4096, 4096, d)
        qh, kh, vh = halves(q, k, v)
        ops = {stage: operands(stage, *((qh, kh, vh) if stage == "qk_packed"
                                        else (q, k, v)), 512)
               for stage in STAGES}
        fns = {f"{name} {stage}": (lambda name=name, stage=stage:
                                   run(name, stage, *ops[stage], 512))
               for name in entries for stage in STAGES}
        fns["fused forward"] = lambda: fa.flash_attention(q, k, v, causal=False)
        fns["fused forward, stable=False"] = lambda: fa.flash_attention(
            q, k, v, causal=False, stable=False)
        fns["this qk_kt_probe"] = lambda: pr.qk_kt_probe(q, k, v, block_q=512,
                                                         block_k=512)
        fns["this qk_packed_probe"] = lambda: pr.qk_packed_probe(
            qh, kh, block_q=256, block_k=512)
        fns["transpose"] = lambda: k.transpose(-1, -2).contiguous()
        fns["pack"] = lambda: pr._pack(qh, kh, 512)
        ms = cs.time_turns(fns, dev)
        flops = 2 * 16 * 4096 * 4096 * d
        out_bytes = 4 * q.numel()
        bnd = {"copy": cs.bound(0, 2 * cs.nbytes(k) + out_bytes),
               "qk": cs.bound(flops, cs.nbytes(q, k) + out_bytes),
               "pv": cs.bound(flops, cs.nbytes(v) + out_bytes + 2 * 16 * 4096),
               "qk_kt": cs.bound(flops, cs.nbytes(q, k) + out_bytes),
               "qk_packed": cs.bound(flops, cs.nbytes(qh, kh) + out_bytes)}
        t_exp = (16 * 4096 * (4096 + 4096 // 512) / (cs.MUFU_PER_SM_CLK * platform.H100_SMS
                                                     * clock) * 1e3)
        bnd["chain"] = dict(bound_ms=max(t_exp, cs.bound(0, 2 * 16 * 4096 + out_bytes)["bound_ms"]))
        pair = cs.bound(2 * flops, 0)["bound_ms"]
        unpacked = cs.bound(flops // 2, cs.nbytes(qh, kh) + out_bytes)["bound_ms"]
        fused = ms["fused forward"]

        def note(name, stage):
            t, b_ = ms[f"{name} {stage}"], bnd[stage]["bound_ms"]
            extra = (f"; {pair / t:.1%} of the pair's {pair:.4f}" if stage == "pv" else
                     f"; {unpacked / t:.1%} of the unpacked {unpacked:.4f}"
                     if stage == "qk_packed" else "")
            return f"{stage} {t:.4f} ms ({b_ / t:.1%} of its bound {b_:.4f}{extra})"
        for name in entries:
            total = sum(ms[f"{name} {stage}"] for stage in ("copy", "qk", "pv"))
            products = ms[f"{name} qk"] + ms[f"{name} pv"]
            print(f"probes 1x16/4x4096x{d} (qk_packed at d {d // 2}), block_k 512, "
                  f"{name}, kernels alone: "
                  + " | ".join(note(name, stage) for stage in STAGES)
                  + f" | copy + qk + pv {total:.4f} vs the fused forward {fused:.4f} "
                  f"(stable=False {ms['fused forward, stable=False']:.4f}) | split: "
                  f"copy {ms[f'{name} copy']:.4f}, qk + pv {products:.4f} "
                  f"({products / fused:.1%} of the fused), the fused outside the "
                  f"products {fused - products:.4f}, the chain alone "
                  f"{ms[f'{name} chain']:.4f} | {label}", flush=True)
        print(f"whole calls at d {d} (qk_packed d {d // 2}, block_q 256), this: "
              f"qk_kt_probe {ms['this qk_kt_probe']:.4f} ms (K^T in torch alone "
              f"{ms['transpose']:.4f}), qk_packed_probe {ms['this qk_packed_probe']:.4f} "
              f"ms (the packing alone {ms['pack']:.4f}) | {label}", flush=True)
    return 0


def main() -> int:
    import torch

    from flashattention_kernel_project_tpu_torch.ops import _build
    from flashattention_kernel_project_tpu_torch.ops import flash_attention as fa
    from flashattention_kernel_project_tpu_torch.utils import platform

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    if sys.argv[1:2] == ["probes"]:
        return probes_main(sys.argv[2:])
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
