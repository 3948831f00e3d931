#!/usr/bin/env python3
"""Compare builds of the 8-bit linear decode (kernel 7) and the dense 8-bit
forward (kernel 1 over an int8 or e4m3 cache), or of the int8 x int8
decode (kernel 8), on one card, in turns.

    python3 tools/ab_8bit.py [--profile] [NAME=CSRC_DIR[:FLAG,...] ...]
    python3 tools/ab_8bit.py mxu [NAME=CSRC_DIR[:FLAG,...] ...]

Builds this checkout's kernels (the package's library, "this") and, for
each NAME=CSRC_DIR, that directory's 8-bit decode and dense 8-bit forward
sources with common.cu into a library of its own under
flashattention_kernel_project_tpu_torch/build/ab/, with the nvcc flags
after ':', printing ptxas's register and spill lines for their kernels.
CSRC_DIR is a csrc/ directory: another commit's from an unpacked `git
archive`, or this checkout's with a probe flag (-DFKP_RAGGED_PROBE=2: the
8-bit forward's byte tiles loaded and left unwidened, its output
unchecked; a probe is timed, not held). A directory with flash_decode_q.cu is called as
this tree's decode takes its inputs (fkp_flash_decode_q_out: one launch,
the split merge on the card, `q_n_splits`); one without it as the earlier
kernel 7 was (flash_decode.cu's fkp_flash_decode_q: the partials at
`_core_n_splits`, then `merge_partials`, a reshape and a cast in plain
torch: that tree's whole call). Every dense forward is called through
fkp_flash_fwd_q, whose C signature has not changed.

Every build is held against the plain versions at each timed shape (O
rel-L2 1e-2, LSE 1e-3), then timed from CUDA graphs in turns (in order,
then in reverse, the smaller of the two), with the L2 warm (the same
inputs call after call) and cold (a 64 MiB write between calls, whose own
time is taken off):
- the decode's whole call at the serving shape (B 8, 16/4 heads, S 2048,
  d 128, chip_smoke.py's lengths), int8 and e4m3; at 8192 keys (every
  length 8192, int8); with the serving window (256, 4 sinks, int8); at
  the most splits (one sequence of 65536 keys, 8/1 heads, int8, d 128
  and 64);
- the dense forward at 1 x 16/4 x 4096 x 128 causal, int8 in the three
  disciplines and e4m3 fixed-max, and BASELINE config 5 (1 x 32/8 x 32768
  x 128, int8, causal, fixed-max; warm only).
With --profile, an int8 linear decode step of the serving model (B 8,
every length 600, chip_smoke.py's `profile_decode_steps` shape) through
each build's decode, in turns: its device time and device operations a
step from torch.profiler.

mxu: kernel 8 (flash_decode_int8(mxu=True)). Each NAME=CSRC_DIR builds
that directory's flash_decode_mxu.cu with common.cu; a build with the
entry fkp_flash_decode_mxu_out is called as this tree's decode takes its
inputs (one launch, the split merge on the card), one without it as the
earlier kernel was (its partials, then `merge_partials`, a reshape and a
cast in plain torch: that tree's whole call). At chip_smoke.py's DEC_I8
shapes (run_all.py's 8192-key rung, the serving shape and its window, and
B66 at 8192 keys, where the default split is cut to fit shared memory),
`mxu_n_splits` and `mxu_block_s`, every build's partials are held to
`_decode_partials_mxu_plain` (m and y bit for bit, l within 1e-6
relative) and its whole call to `merge_partials` of them (rel-L2 1e-3),
then timed from CUDA graphs in turns, warm and cold L2 as above: each
build's whole call and its kernel alone (the partials), this checkout's
(the package's own wrappers, "this") and kernel 7's whole call
(mxu=False, `q_n_splits`) on the same cache.
"""

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

LOG2E = 1.4426950408889634
SERVING = (8, 16, 4, 2048, 128)
LONG = (8, 16, 4, 8192, 128)
# one sequence of 65536 keys, 8/1 heads: the most splits q_n_splits gives
# (396 at d 128, 512 at d 64), the split merge's largest work
MANY = [(1, 8, 1, 65536, 128), (1, 8, 1, 65536, 64)]
WINDOW = ([100, 255, 256, 257, 700, 1500, 2000, 2048], 256, 4)
DENSE = (1, 16, 4, 4096, 128)
CONFIG5 = (1, 32, 8, 32768, 128)
KERNELS = ("flash_decode_q", "flash_fwd_q")  # kernels whose ptxas lines print


def build(name, csrc, flags, out_dir):
    """{"decode": a whole-call maker, "fwd": fkp_flash_fwd_q} of a library
    built from csrc's 8-bit decode and dense 8-bit forward sources."""
    from flashattention_kernel_project_tpu_torch.ops import _build

    new = os.path.exists(os.path.join(csrc, "flash_decode_q.cu"))
    srcs = sorted(f for f in os.listdir(csrc)
                  if (f.startswith("flash_fwd_q") or f.startswith("flash_decode_q")
                      if new else f in ("flash_decode.cu", "flash_fwd_q.cu"))
                  and f.endswith(".cu")) + ["common.cu"]
    objs = [os.path.join(out_dir, f"{name}.{f}.o") for f in srcs]
    procs = [subprocess.Popen([_build.nvcc(), *_build.NVCC_FLAGS, *flags, "-c",
                               os.path.join(csrc, f), "-o", o],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for f, o in zip(srcs, objs)]
    return new, lambda: _link(name, new, procs, objs, out_dir)


def _link(name, new, procs, objs, out_dir):
    from flashattention_kernel_project_tpu_torch.ops import _build

    kernel = ""
    for p in procs:
        out, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"{name}: build failed\n{out[-6000:]}")
        for line in out.splitlines():
            kernel = _ptxas_line(name, kernel, line)
    lib = os.path.join(out_dir, f"lib{name}.so")
    subprocess.run([_build.nvcc(), "-shared", "-gencode",
                    "arch=compute_90a,code=sm_90a", *objs, "-o", lib], check=True)
    cdll = ctypes.CDLL(lib)
    cdll.fkp_error_string.restype = ctypes.c_char_p
    cdll.fkp_error_string.argtypes = [ctypes.c_int]
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    tail = [i32] * 7 + [ctypes.c_float] + [i32] * 3 + [vp]
    if new:
        dec = cdll.fkp_flash_decode_q_out
        dec.argtypes = [vp] * 10 + tail
    else:
        dec = cdll.fkp_flash_decode_q
        dec.argtypes = [vp] * 9 + tail
    dec.restype = i32
    fwd = cdll.fkp_flash_fwd_q
    fwd.argtypes = [vp] * 9 + [i32] * 6 + [ctypes.c_float] + [i32] * 6 + [vp]
    fwd.restype = i32
    return dict(decode=_decode_maker(cdll, dec, new), fwd=_fwd_maker(cdll, fwd))


def _ptxas_line(name, kernel, line):
    """Prints a ptxas register or spill line of one of KERNELS' instances
    (its template arguments read by chip_smoke.py's parsers, or the
    mangled name of an earlier kernel); returns the entry the lines are
    about."""
    if "Compiling entry function" in line:
        return line.split("'")[1]
    if any(k in kernel for k in KERNELS) and ("registers" in line or "spill" in line):
        inst = cs.dec_q_instance(kernel) or cs.fwd_q_instance(kernel) or kernel
        print(f"{name}: {cs.mangled_name(kernel)[0]}{inst}: "
              f"{line.split(':', 1)[-1].strip()}", flush=True)
    return kernel


def _check(cdll, rc, what):
    if rc != 0:
        raise SystemExit(f"{what}: CUDA error {rc} "
                         f"({cdll.fkp_error_string(rc).decode()})")


def _decode_maker(cdll, fn, new):
    """decode(q, k, ks, v, vs, lengths, window, sinks): a closure making
    one whole 8-bit decode call through the build, as its tree made it."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import flash_decode as fd

    def decode(q, k, ks, v, vs, lengths, window=0, sinks=0):
        b, hq, d = q.shape
        hkv, s = k.shape[1], k.shape[2]
        g = hq // hkv
        fp8 = int(k.dtype == torch.float8_e4m3fn)
        ptrs = [x.data_ptr() for x in (q, k, ks, v, vs, lengths)]
        stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
        if new:
            n = fd.q_n_splits(b, hkv, s, d)
            block_s = fd.default_block_s(s, n)

            def run():
                out = torch.empty_like(q)
                _ws, work = fd._split_workspace(q, hkv, n)
                _check(cdll, fn(*ptrs, out.data_ptr(), *work, b, hq, hkv, s, d,
                                n, block_s, d ** -0.5, window, sinks, fp8,
                                stream()), "fkp_flash_decode_q_out")
                return out
            return run
        n = fd._core_n_splits(b, hkv, s)
        block_s = -(-s // n)

        def run_old():
            m = torch.empty((b, hkv, n, g, 1), dtype=torch.float32,
                            device=q.device)
            l = torch.empty_like(m)
            y = torch.empty((b, hkv, n, g, d), dtype=torch.float32,
                            device=q.device)
            _check(cdll, fn(*ptrs, m.data_ptr(), l.data_ptr(), y.data_ptr(), b,
                            hq, hkv, s, d, n, block_s, d ** -0.5, window, sinks,
                            fp8, stream()), "fkp_flash_decode_q")
            return fd.merge_partials(m, l, y).reshape(b, hq, d).to(q.dtype)
        return run_old
    return decode


def _fwd_maker(cdll, fn):
    """fwd(q, k, ks, v, vs, causal, disc, k_max): a closure making one
    dense 8-bit forward call through the build: (O, LSE)."""
    import torch

    def fwd(q, k, ks, v, vs, causal, disc, k_max=None):
        b, hq, n, d = q.shape

        def run():
            o = torch.empty_like(q)
            lse = torch.empty((b, hq, n), dtype=torch.float32, device=q.device)
            _check(cdll, fn(q.data_ptr(), k.data_ptr(), ks.data_ptr(),
                            v.data_ptr(), vs.data_ptr(), o.data_ptr(),
                            lse.data_ptr(),
                            None if k_max is None else k_max.data_ptr(), None,
                            b, hq, k.shape[1], n, k.shape[2], d,
                            float(d ** -0.5 * LOG2E), int(causal), 0, 0, 0,
                            disc, int(k.dtype == torch.float8_e4m3fn),
                            torch.cuda.current_stream().cuda_stream),
                   "fkp_flash_fwd_q")
            return o, lse
        return run
    return fwd


def turns(fns, dev, cold, iters=20):
    """Each closure's ms from CUDA graphs in turns; cold: a 64 MiB write
    before each call (L2 is 50 MB), its own time taken off."""
    import torch

    if not cold:
        return cs.time_turns(fns, dev, iters)
    junk = torch.empty(16 << 20, dtype=torch.float32, device=dev)
    flush = lambda: junk.fill_(1.0)  # noqa: E731
    with_flush = {k: (lambda f=f: (flush(), f())[1]) for k, f in fns.items()}
    ms = cs.time_turns({**with_flush, "flush": flush}, dev, iters)
    return {k: ms[k] - ms["flush"] for k in fns}


def build_mxu(name, csrc, flags, out_dir):
    """(whole, partials) call makers over a library built from csrc's
    kernel 8: each maker takes a call's arguments as
    `_decode_partials_mxu_plain` does and returns a closure of one call."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import _build
    from flashattention_kernel_project_tpu_torch.ops import flash_decode as fd

    srcs = ("flash_decode_mxu.cu", "common.cu")
    objs = [os.path.join(out_dir, f"mxu_{name}.{f}.o") for f in srcs]
    procs = [subprocess.Popen([_build.nvcc(), *_build.NVCC_FLAGS, *flags, "-c",
                               os.path.join(csrc, f), "-o", o],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for f, o in zip(srcs, objs)]
    for p in procs:
        out, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"{name}: build failed\n{out[-6000:]}")
        print(f"{name}: " + " | ".join(line.split(":", 1)[-1].strip()
                                       for line in out.splitlines()
                                       if "Used" in line or "spill" in line)[-3000:],
              flush=True)
    lib = os.path.join(out_dir, f"libmxu_{name}.so")
    subprocess.run([_build.nvcc(), "-shared", "-gencode",
                    "arch=compute_90a,code=sm_90a", *objs, "-o", lib], check=True)
    cdll = ctypes.CDLL(lib)
    cdll.fkp_error_string.restype = ctypes.c_char_p
    cdll.fkp_error_string.argtypes = [ctypes.c_int]
    vp = ctypes.c_void_p
    tail = [ctypes.c_int] * 7 + [ctypes.c_float] + [ctypes.c_int] * 2 + [vp]
    part_fn = cdll.fkp_flash_decode_mxu
    part_fn.argtypes = [vp] * 9 + tail
    part_fn.restype = ctypes.c_int
    new = hasattr(cdll, "fkp_flash_decode_mxu_out")
    if new:
        out_fn = cdll.fkp_flash_decode_mxu_out
        out_fn.argtypes = [vp] * 10 + tail
        out_fn.restype = ctypes.c_int
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def partials(q, k, ks, v, vs, lengths, n, block_s, sm_scale, window, sinks):
        b, hq, d = q.shape
        hkv, s = k.shape[1], k.shape[2]
        g = hq // hkv
        ptrs = [x.data_ptr() for x in (q, k, ks, v, vs, lengths)]

        def run():
            m = torch.empty((b, hkv, n, g, 1), dtype=torch.float32, device=q.device)
            l = torch.empty_like(m)
            y = torch.empty((b, hkv, n, g, d), dtype=torch.float32, device=q.device)
            _check(cdll, part_fn(*ptrs, m.data_ptr(), l.data_ptr(), y.data_ptr(), b,
                                 hq, hkv, s, d, n, block_s, sm_scale, window, sinks,
                                 stream()), "fkp_flash_decode_mxu")
            return m, l, y
        return run

    def whole(q, k, ks, v, vs, lengths, n, block_s, sm_scale, window, sinks):
        b, hq, d = q.shape
        hkv, s = k.shape[1], k.shape[2]
        if not new:
            part = partials(q, k, ks, v, vs, lengths, n, block_s, sm_scale, window,
                            sinks)
            return lambda: fd.merge_partials(*part()).reshape(b, hq, d).to(q.dtype)
        ptrs = [x.data_ptr() for x in (q, k, ks, v, vs, lengths)]

        def run():
            out = torch.empty_like(q)
            _ws, work = fd._split_workspace(q, hkv, n)
            _check(cdll, out_fn(*ptrs, out.data_ptr(), *work, b, hq, hkv, s, d, n,
                                block_s, sm_scale, window, sinks, stream()),
                   "fkp_flash_decode_mxu_out")
            return out
        return run
    return whole, partials


def mxu_main(specs) -> int:
    """The mxu mode (module docstring)."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import _build
    from flashattention_kernel_project_tpu_torch.ops import flash_decode as fd
    from flashattention_kernel_project_tpu_torch.utils import platform

    out_dir = os.path.join(_build.BUILD_DIR, "ab")
    os.makedirs(out_dir, exist_ok=True)
    _build.library()
    builds = {"this": (lambda *a: lambda: fd._decode_mxu_cuda(*a),
                       lambda *a: lambda: fd._decode_partials_mxu_cuda(*a))}
    for spec in specs:
        name, _, rest = spec.partition("=")
        csrc, _, flags = rest.partition(":")
        builds[name] = build_mxu(name, os.path.abspath(csrc),
                                 [f for f in flags.split(",") if f], out_dir)
    label = platform.card_label()
    print(label, flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(37)
    for b, hq, hkv, s, d, lens, band in cs.DEC_I8:
        q = torch.randn(b, hq, d, generator=gen, device=dev).bfloat16()
        if lens == "full":
            lengths = torch.full((b,), s, dtype=torch.int32, device=dev)
        else:
            lengths = torch.randint(1, s, (b,), generator=gen, device=dev,
                                    dtype=torch.int32)
            lengths[0], lengths[-1] = 0, s
        cache = (*cs.quantized(gen, dev, (b, hkv, s, d), "int8"),
                 *cs.quantized(gen, dev, (b, hkv, s, d), "int8"))
        window, sinks = band or (0, 0)
        n = fd.mxu_n_splits(b, hkv, s, hq // hkv, d)
        block_s = fd.mxu_block_s(s, n)
        args = (q, *cache, lengths, n, block_s, d ** -0.5, window, sinks)
        plain = fd._decode_partials_mxu_plain(*args)
        fns = {}
        for name, (whole, partials) in builds.items():
            fns[f"{name} whole"] = whole(*args)
            fns[f"{name} kernel"] = partials(*args)
            cs.hold_mxu(f"{name} at b{b} s{s} window {window}",
                        fns[f"{name} kernel"](), plain, fns[f"{name} whole"](),
                        lengths, n)
        n7 = fd.q_n_splits(b, hkv, s, d)
        args7 = (*args[:6], n7, fd.default_block_s(s, n7), *args[8:])
        fns["kernel 7 whole"] = lambda args7=args7: fd._decode_q_cuda(*args7)
        live = (cs._live_keys(lengths.tolist(), window or None, sinks) if window
                else int(lengths.clamp(max=s).sum()))
        bnd = cs.bound(4 * live * hq * d, cs.nbytes(q, q) + cs.bytes_8bit(live, hkv, d),
                       platform.H100_INT8_OPS)
        what = (f"b{b} {hq}/{hkv} s{s} d{d} {n} splits of {block_s} window {window} "
                f"sinks {sinks}")
        for cold in (False, True):
            ms = turns(fns, dev, cold, iters=50)
            print(f"kernel 8 {what} ({'cold' if cold else 'warm'} L2): bound "
                  f"{bnd['bound_ms']:.4f} ms | " + " | ".join(
                      f"{k} {t:.4f} ms ({bnd['bound_ms'] / t:.1%})"
                      for k, t in ms.items()) + f" [{label}]", flush=True)
    return 0


def main() -> int:
    import torch

    from flashattention_kernel_project_tpu_torch.ops import _build
    from flashattention_kernel_project_tpu_torch.ops import flash_attention as fa
    from flashattention_kernel_project_tpu_torch.ops import flash_decode as fd
    from flashattention_kernel_project_tpu_torch.utils import platform

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    args = sys.argv[1:]
    if args[:1] == ["mxu"]:
        return mxu_main(args[1:])
    profile = "--profile" in args
    out_dir = os.path.join(_build.BUILD_DIR, "ab")
    os.makedirs(out_dir, exist_ok=True)
    pending, probes = {}, set()
    for spec in (a for a in args if a != "--profile"):
        name, _, rest = spec.partition("=")
        csrc, _, flags = rest.partition(":")
        if "FKP_RAGGED_PROBE" in flags:
            probes.add(name)
        pending[name] = build(name, os.path.abspath(csrc),
                              [f for f in flags.split(",") if f], out_dir)[1]
    this_lib = _build.library()  # this checkout's, while the others compile
    kernel = ""
    with open(os.path.join(_build.BUILD_DIR, "libfkp_kernels.so.log")) as f:
        for line in f:
            kernel = _ptxas_line("this", kernel, line)
    builds = {"this": dict(
        decode=lambda q, k, ks, v, vs, lengths, window=0, sinks=0:
            lambda: fd.flash_decode_int8(q, k, ks, v, vs, lengths,
                                         window=window or None, sinks=sinks),
        fwd=_fwd_maker(this_lib, fa._kernel("fkp_flash_fwd_q", 9, 6)))}
    builds.update({name: link() for name, link in pending.items()})
    label = platform.card_label()
    print(label, flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(31)

    def cache(b, hkv, s, d, fmt):
        return (*cs.quantized(gen, dev, (b, hkv, s, d), fmt),
                *cs.quantized(gen, dev, (b, hkv, s, d), fmt))

    # the decode: held, then timed warm and cold
    b, hq, hkv, s, d = SERVING
    q = torch.randn(b, hq, d, generator=gen, device=dev).bfloat16()
    serving = torch.randint(1, s, (b,), generator=gen, device=dev,
                            dtype=torch.int32)
    serving[0], serving[-1] = 0, s
    lens, window, sinks = WINDOW
    cases = []
    for fmt in cs.FMTS:
        cases.append((f"serving b{b} {hq}/{hkv} s{s} d{d} {fmt}", q,
                      cache(b, hkv, s, d, fmt), serving, 0, 0))
    cases.append((f"serving b{b} {hq}/{hkv} s{s} d{d} int8 window {window} "
                  f"sinks {sinks}", q, cases[0][2],
                  torch.tensor(lens, dtype=torch.int32, device=dev), window, sinks))
    b, hq, hkv, s, d = LONG
    cases.append((f"8192 keys b{b} {hq}/{hkv} d{d} int8", q,
                  cache(b, hkv, s, d, "int8"),
                  torch.full((b,), s, dtype=torch.int32, device=dev), 0, 0))
    for b, hq, hkv, s, d in MANY:
        cases.append((f"many splits b{b} {hq}/{hkv} s{s} d{d} int8",
                      torch.randn(b, hq, d, generator=gen, device=dev).bfloat16(),
                      cache(b, hkv, s, d, "int8"),
                      torch.full((b,), s, dtype=torch.int32, device=dev), 0, 0))
    for what, q_, c, lengths, win, snk in cases:
        s, d = c[0].shape[2], q_.shape[-1]
        n = fd.q_n_splits(q_.shape[0], c[0].shape[1], s, d)
        plain = fd._decode_q_plain(q_, *c, lengths, n, fd.default_block_s(s, n),
                                   d ** -0.5, win, snk)
        fns = {}
        for name, bld in builds.items():
            fns[name] = bld["decode"](q_, *c, lengths, win, snk)
            err = cs._rel_l2(fns[name](), plain)
            if not err <= cs.O_TOL:
                raise SystemExit(f"{name} decode at {what}: rel-L2 {err:.3e}")
        live = (cs._live_keys(lengths.tolist(), win, snk) if win
                else int(lengths.clamp(max=s).sum()))
        bnd = cs.bound(4 * live * q_.shape[1] * d,
                       cs.nbytes(q_, q_) + cs.bytes_8bit(live, c[0].shape[1], d))
        for cold in (False, True):
            ms = turns(fns, dev, cold, iters=50)
            print(f"decode {what} ({'cold' if cold else 'warm'} L2): bound "
                  f"{bnd['bound_ms']:.4f} ms | " + " | ".join(
                      f"{k} {t:.4f} ms ({bnd['bound_ms'] / t:.1%})"
                      for k, t in ms.items()) + f" [{label}]", flush=True)

    # the dense forward
    b, hq, hkv, n, d = DENSE
    qd = torch.randn(b, hq, n, d, generator=gen, device=dev).bfloat16()
    for fmt, discs in (("int8", (fa.FIXED, fa.ONLINE, fa.HYBRID)),
                       ("fp8", (fa.FIXED,))):
        c = cache(b, hkv, n, d, fmt)
        k_max = fa.k_max_norm(c[0], c[1])
        for disc in discs:
            km = k_max if disc == fa.HYBRID else None
            po, plse = fa._fwd_q_plain(qd, *c, True, d ** -0.5, 0, 0, 0, disc, km)
            fns = {}
            for name, bld in builds.items():
                fns[name] = bld["fwd"](qd, *c, True, disc, km)
                if name in probes:
                    continue
                o, lse = fns[name]()
                err = cs._rel_l2(o, po)
                lerr = float((lse - plse).abs().max())
                if not (err <= cs.O_TOL and lerr <= cs.LSE_TOL):
                    raise SystemExit(f"{name} forward {fmt} disc {disc}: O "
                                     f"rel-L2 {err:.3e}, LSE {lerr:.3e}")
            del po, plse
            flops = 4 * hq * d * cs.visible_pairs(n, n, 0, True)
            for cold in (False, True):
                ms = turns(fns, dev, cold, iters=10)
                print(f"dense 8-bit forward 1x{hq}/{hkv}x{n}x{d} causal {fmt} "
                      f"disc {disc} ({'cold' if cold else 'warm'} L2): " + " | ".join(
                          f"{k} {t:.4f} ms ({flops / t / 1e9:.1f} TFLOP/s)"
                          for k, t in ms.items()) + f" [{label}]", flush=True)
    b, hq, hkv, n, d = CONFIG5
    qc = torch.randn(b, hq, n, d, generator=gen, device=dev).bfloat16()
    c = cache(b, hkv, n, d, "int8")
    tail = 512
    po, _ = fa._fwd_q_plain(qc[:, :, -tail:].contiguous(), *c, True, d ** -0.5,
                            n - tail, 0, 0, fa.FIXED)
    fns = {}
    for name, bld in builds.items():
        fns[name] = bld["fwd"](qc, *c, True, fa.FIXED)
        if name in probes:
            continue
        err = cs._rel_l2(fns[name]()[0][:, :, -tail:], po)
        if not err <= cs.O_TOL:
            raise SystemExit(f"{name} config 5: the last {tail} rows rel-L2 {err:.3e}")
    del po
    ms = cs.time_turns(fns, dev, iters=3)
    flops = 4 * hq * d * cs.visible_pairs(n, n, 0, True)
    print(f"config 5 1x{hq}/{hkv}x{n}x{d} int8 causal fixed-max: " + " | ".join(
        f"{k} {t:.3f} ms ({flops / t / 1e9:.1f} TFLOP/s)" for k, t in ms.items())
        + f" [{label}]", flush=True)
    del qc, c, fns
    if profile:
        profile_steps(builds, dev, label)
    return 0


def profile_steps(builds, dev, label, batch=8, length=600, steps=5):
    """An int8 linear decode step of the serving model through each
    build's decode, in turns (in order, then in reverse, the smaller device
    time of the two): device ms and device operations a step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from flashattention_kernel_project_tpu_torch.models import engine
    from flashattention_kernel_project_tpu_torch.models import transformer as tfm
    from flashattention_kernel_project_tpu_torch.ops import flash_decode as fd

    cfg = tfm.TransformerConfig(**cs.SERVING, dtype=torch.bfloat16)
    params = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    dec = engine.fuse_decode_params(cfg, params)
    tok = torch.zeros(batch, dtype=torch.int32, device=dev)
    cache = engine.init_cache(cfg, batch, 2048, dev, quantized=True)
    own = fd._decode_q_cuda

    def through(bld):
        def call(q, k, ks, v, vs, lengths, n_splits, block_s, sm_scale,
                 window=0, sinks=0):
            return bld["decode"](q, k, ks, v, vs, lengths, window, sinks)()
        return call

    results = {}
    order = list(builds)
    for name in order + order[::-1]:
        fd._decode_q_cuda = own if name == "this" else through(builds[name])
        try:
            cache.lengths.fill_(length)
            engine.decode_step(cfg, dec, tok, cache)  # warm-up
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(steps):
                    cache.lengths.fill_(length)
                    engine.decode_step(cfg, dec, tok, cache)
                torch.cuda.synchronize()
        finally:
            fd._decode_q_cuda = own
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        ops = sum(e.count for e in events) / steps
        ms = sum(e.self_device_time_total for e in events) / 1e3 / steps
        if ops:
            best = results.get(name)
            results[name] = (min(ms, best[0]) if best else ms, ops)
    for name, (ms, ops) in results.items():
        print(f"int8 linear decode step (B {batch}, lengths {length}, "
              f"{cfg.n_layers} layers) through {name}: {ms:.4f} ms of device "
              f"time, {ops:.1f} device operations a step [{label}]", flush=True)


if __name__ == "__main__":
    sys.exit(main())
