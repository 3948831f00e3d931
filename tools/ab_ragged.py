#!/usr/bin/env python3
"""Compare builds of the ragged forward (kernel 3, bf16 and 8-bit) and of
the stream copy probe (kernel 23's stream_copy_probe) on one card, in
turns.

    python3 tools/ab_ragged.py [NAME=CSRC_DIR[:FLAG,...] ...] [--threshold] [--profile ROOT ...]

Builds this checkout's ragged sources (csrc/flash_fwd_ragged*.cu,
ragged_slab*.cu) and probes.cu, with common.cu, into a library of its own
under flashattention_kernel_project_tpu_torch/build/ab/, prints each
source's compile seconds and ptxas's register and spill lines for its
instances, and runs the port's wrappers on it ("this"). Each NAME=CSRC_DIR
builds that directory's sources the same way, with the nvcc flags after
':': a directory with ragged_slab.cu is called as this tree's entries take
their inputs (its slab and wgmma routes, each on the shapes its plan gives
it), one without it as the earlier kernel was (csrc/flash_fwd_ragged.cu on
flash_fwd_core.cuh's mma.sync ragged flavour, its C entries' arguments).
The probe flags (PROBES; any other -D flag is refused):
-DFKP_SLAB_PROBE=2 sends every slab call to the general instances (causal,
the band and fixed-max as runtime arguments); such a build compiles the
slab sources alone and runs the verify's causal online calls alone.
-DFKP_RAGGED_PROBE=2 leaves the wgmma route's 8-bit tiles unwidened (timed,
not checked); such a build compiles the wgmma route's sources alone and
runs its calls alone. CSRC_DIR is a csrc/ directory: this checkout's, or
another commit's from an unpacked `git archive`.

It holds every build against the plain version at each timed shape
(rel-L2 1e-2) and times from CUDA graphs, in turns (in order, then in
reverse, the smaller of the two), each build's whole call beside SDPA with
the ragged mask (the same function, a yardstick never on the port's path),
from a warm L2 and then from a cold one (each call after a 128 MB write,
less the write's time): the linear speculative verify (chip_smoke.py's
RAGGED_VERIFY: B 8, 16/4 heads, T 5, S_max 2048, d 128) over bf16, int8
and e4m3 caches (beside this build's paged extend, kernel 11, on the same
K/V cut into pages of 128), with window 256 and 4 sinks, and fixed-max; the serving
chunk (1 x 16/4, T 256, S_max 2304, kv_len 768, q_offset 512) in the same
flavours; and the route threshold's neighbours T 8, 9, 16, 32, 64 and
96 (bf16, each through both routes of this build). Then the stream copy (out = x + 1
over 8192 x 4096, f32 and bf16) of each build in turns with x + 1. With
--threshold, in place of those shapes, the threshold's grid through both
routes, bf16, 16/4 heads, T 5, 8, 10, 12, 14, 16, 24 and 32 (and 48, 64,
96 at B 1): short rows, 512 keys cached a row at B 1, 2, 4 and 8 (S_max
2304, the serving chunk's cache); long rows, 1500 keys cached at B 1 and
the verify's lengths at B 8 (S_max 2048); then the stream copy.

With --profile ROOT (a checkout, e.g. an unpacked parent): one linear
speculative round (chip_smoke.py's serving model and draft, B 8, prompts
of 600, spec_k 4) and one chunked prefill (the serving model, a chunk of
256 tokens onto 512 cached, one sequence) under torch.profiler, run by the
package of ROOT and of this checkout in turns (ROOT, this, this, ROOT), each
in a process of its own that builds its tree's kernels: device time and
device operations a round and a chunk.
"""

import ctypes
import importlib.util
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEW_SOURCES = ("flash_fwd_ragged.cu", "flash_fwd_ragged_fixed.cu",
               "flash_fwd_ragged_q.cu", "flash_fwd_ragged_fp8.cu",
               "ragged_slab.cu", "ragged_slab_q.cu", "ragged_slab_fp8.cu",
               "probes.cu",
               "paged_extend.cu", "paged_extend_q.cu", "common.cu")
WGMMA_SOURCES = ("flash_fwd_ragged.cu", "flash_fwd_ragged_fixed.cu",
                 "flash_fwd_ragged_q.cu", "flash_fwd_ragged_fp8.cu", "common.cu")
SLAB_SOURCES = ("ragged_slab.cu", "ragged_slab_q.cu", "ragged_slab_fp8.cu",
                "common.cu")
OLD_SOURCES = ("flash_fwd_ragged.cu", "probes.cu", "common.cu")
PROBES = {"-DFKP_SLAB_PROBE=2": SLAB_SOURCES, "-DFKP_RAGGED_PROBE=2": WGMMA_SOURCES}
FLUSH_MB = 128  # written before a call timed from a cold L2 (the H100's holds 50)
LOG2E = 1.4426950408889634
STREAM = (8192, 4096)  # run_all.py's stream-copy rung


def _smoke():
    """This checkout's chip_smoke.py as a module (whatever package the
    process imports)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_ab", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # its dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


def build(name, csrc, flags, out_dir):
    """(a library built from csrc's ragged and probe sources, or from the
    sources a probe flag names, whether it has this tree's entries). Prints
    each source's compile seconds (all at once, one nvcc each) and its
    kernels' ptxas lines."""
    from flashattention_kernel_project_tpu_torch.ops import _build

    new = os.path.exists(os.path.join(csrc, "ragged_slab.cu"))
    srcs = NEW_SOURCES if new else OLD_SOURCES
    for f in flags:
        if f.startswith("-D") and f not in PROBES:
            raise SystemExit(f"{name}: no probe {f}; the probes are {sorted(PROBES)}")
        srcs = PROBES.get(f, srcs)
    objs = [os.path.join(out_dir, f"{name}.{f}.o") for f in srcs]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([_build.nvcc(), *_build.NVCC_FLAGS, *flags, "-c",
                               os.path.join(csrc, f), "-o", o],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for f, o in zip(srcs, objs)]
    kernel = ""
    for f, p in zip(srcs, procs):
        out, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"{name}: build failed\n{out[-6000:]}")
        print(f"{name}: {f} compiled in {time.perf_counter() - t0:.1f} s "
              f"(sources started together), "
              f"{out.count('Compiling entry function')} kernel instances",
              flush=True)
        for line in out.splitlines():
            if "Compiling entry function" in line:
                kernel = line.split("'")[1]
            elif (f != "common.cu" and ("registers" in line or "spill" in line)
                  and ("ragged" in kernel or "stream_copy" in kernel)):
                print(f"{name}: {kernel}: {line.split(':', 1)[-1].strip()}",
                      flush=True)
    lib = os.path.join(out_dir, f"lib{name}.so")
    subprocess.run([_build.nvcc(), "-shared", "-gencode",
                    "arch=compute_90a,code=sm_90a", *objs, "-o", lib], check=True)
    cdll = ctypes.CDLL(lib)
    cdll.fkp_error_string.restype = ctypes.c_char_p
    cdll.fkp_error_string.argtypes = [ctypes.c_int]
    return cdll, new


def call(entry, cache, q, kv_lens, q_offsets, causal, window, sinks, fixed,
         route=None):
    """A closure making one ragged forward call through a build: this
    tree's layout on its planned route (or `route`, "slab" or "wgmma"), or
    the earlier kernel's C entries. cache: (k, v) bf16 or (k_q, k_scale,
    v_q, v_scale)."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import _build
    from flashattention_kernel_project_tpu_torch.ops import paged_decode as pd

    cdll, new = entry
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    quant = len(cache) == 4
    k, ks, v, vs = cache if quant else (cache[0], None, cache[1], None)
    b, hq, t, d = q.shape
    hkv, s_max = k.shape[1], k.shape[2]
    scale = d ** -0.5 * LOG2E
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    if not new:
        if quant:
            fn = cdll.fkp_flash_fwd_ragged_q
            fn.argtypes = [vp] * 8 + [i32] * 6 + [f32] + [i32] * 5 + [vp]
        else:
            fn = cdll.fkp_flash_fwd_ragged
            fn.argtypes = [vp] * 6 + [i32] * 6 + [f32] + [i32] * 4 + [vp]
        fn.restype = i32

        def run_old():
            o = torch.empty_like(q)
            head = ([k.data_ptr(), ks.data_ptr(), v.data_ptr(), vs.data_ptr()]
                    if quant else [k.data_ptr(), v.data_ptr()])
            tail = [int(k.dtype == torch.float8_e4m3fn)] if quant else []
            _build.check(fn(q.data_ptr(), *head, o.data_ptr(), kv_lens.data_ptr(),
                            q_offsets.data_ptr(), b, hq, hkv, t, s_max, d, scale,
                            int(causal), window, sinks, int(fixed), *tail,
                            torch.cuda.current_stream().cuda_stream), "old ragged")
            return o
        return run_old
    plan = pd.ragged_plan(b, hq, hkv, t, s_max, d, quant)
    route = route or plan.route
    if route != plan.route:  # the other route at this shape
        if route == pd.RAGGED_SLAB:
            rows = hq // hkv * t
            block_rows = pd.extend_block_rows(rows)
            tiles = -(-rows // block_rows)
            n = pd.extend_n_splits(b, hkv, tiles, s_max, d)
            plan = pd.RaggedPlan(route, block_rows, tiles, n,
                                 pd.default_block_s(s_max, n))
        else:
            plan = pd.RaggedPlan(route, 64, -(-t // 64), 1, plan.block_s)
    kv_type = (2 if k.dtype == torch.float8_e4m3fn else 1) if quant else 0
    if route == pd.RAGGED_SLAB:
        fn = cdll.fkp_ragged_slab
        fn.argtypes = [vp] * 11 + [i32] * 9 + [f32] + [i32] * 5 + [vp]
        fn.restype = i32
        cells = b * hkv * plan.row_tiles * plan.n_splits * plan.block_rows

        def run_slab():
            o = torch.empty_like(q)
            work = [None] * 3
            if plan.n_splits > 1:
                ws = torch.empty(cells * (d + 2), dtype=torch.float32,
                                 device=q.device)
                work = [ws[:cells], ws[cells:2 * cells], ws[2 * cells:]]
            _build.check(fn(q.data_ptr(), k.data_ptr(), ptr(ks), v.data_ptr(),
                            ptr(vs), kv_lens.data_ptr(), q_offsets.data_ptr(),
                            o.data_ptr(), *map(ptr, work), b, hq, hkv, t, s_max,
                            d, plan.n_splits, plan.block_s, plan.block_rows,
                            scale, int(causal), window, sinks, int(fixed),
                            kv_type, torch.cuda.current_stream().cuda_stream),
                         "slab route")
            return o
        return run_slab
    fn = cdll.fkp_flash_fwd_ragged
    fn.argtypes = [vp] * 8 + [i32] * 6 + [f32] + [i32] * 6 + [vp]
    fn.restype = i32

    def run_wgmma():
        o = torch.empty_like(q)
        _build.check(fn(q.data_ptr(), k.data_ptr(), ptr(ks), v.data_ptr(),
                        ptr(vs), o.data_ptr(), kv_lens.data_ptr(),
                        q_offsets.data_ptr(), b, hq, hkv, t, s_max, d, scale,
                        int(causal), window, sinks, int(fixed), kv_type,
                        plan.block_rows, torch.cuda.current_stream().cuda_stream),
                     "wgmma route")
        return o
    return run_wgmma


def kernels(specs, threshold=False):
    """Build this checkout's ragged forward and stream copy and each
    NAME=CSRC_DIR's, then hold and time them in turns (with threshold, the
    threshold's grid in place of the verify's and the chunk's shapes)."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import _build
    from flashattention_kernel_project_tpu_torch.ops import flash_attention as fa
    from flashattention_kernel_project_tpu_torch.ops import paged_decode as pd
    from flashattention_kernel_project_tpu_torch.utils import platform

    cs = _smoke()
    out_dir = os.path.join(_build.BUILD_DIR, "ab")
    os.makedirs(out_dir, exist_ok=True)
    entries = {"this": build("this", _build.CSRC, [], out_dir)}
    _build.library = lambda: entries["this"][0]  # the port's wrappers: this build
    slab_only, wgmma_only = set(), set()  # the probes' builds
    for spec in specs:
        name, _, rest = spec.partition("=")
        csrc, _, flags = rest.partition(":")
        if "FKP_RAGGED_PROBE" in flags:  # unwidened: timed, not checked
            wgmma_only.add(name)
        if "FKP_SLAB_PROBE" in flags:
            slab_only.add(name)
        entries[name] = build(name, os.path.abspath(csrc),
                              [f for f in flags.split(",") if f], out_dir)
    label = platform.card_label()
    print(label, flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(61)
    scratch = torch.empty(FLUSH_MB << 20, dtype=torch.uint8, device=dev)
    flush = lambda: scratch.fill_(1)  # noqa: E731
    b, hq, hkv, t, s_max, lens, offs, d = cs.RAGGED_VERIFY
    chunk = (1, 16, 4, 256, 2304, [768], [512], 128)
    cases = []  # (what, shape, fmt, window, sinks, fixed, routes)
    for shape, where in ((cs.RAGGED_VERIFY, "verify"), (chunk, "chunk")):
        for fmt in (None, "int8", "fp8"):
            cases.append((where, shape, fmt, 0, 0, False, None))
        for fmt in (None, "int8"):
            cases.append((where, shape, fmt, 256, 4, False, None))
            cases.append((where, shape, fmt, 0, 0, True, None))
    for tt in (8, 9, 16, 32, 64, 96):  # the route threshold's neighbours
        cases.append((f"T {tt}", (1, 16, 4, tt, 2304, [512 + tt], [512], 128),
                      None, 0, 0, False, ("slab", "wgmma")))
    if threshold:  # the threshold's grid: short rows and long ones
        cases = []
        for bb in (1, 2, 4, 8):
            for tt in (5, 8, 10, 12, 14, 16, 24, 32) + ((48, 64, 96) if bb == 1 else ()):
                cases.append((f"B {bb} T {tt}, 512 cached",
                              (bb, 16, 4, tt, 2304, [512 + tt] * bb, [512] * bb, 128),
                              None, 0, 0, False, ("slab", "wgmma")))
        for tt in (5, 8, 10, 12, 14, 16, 24, 32):
            cases.append((f"B 1 T {tt}, 1500 cached",
                          (1, 16, 4, tt, 2048, [1500 + tt], [1500], 128),
                          None, 0, 0, False, ("slab", "wgmma")))
            old = [min(n, 2048 - tt) for n in cs.RAGGED_VERIFY[6]]
            cases.append((f"B 8 T {tt}, the verify's lengths",
                          (8, 16, 4, tt, 2048, [n + tt for n in old], old, 128),
                          None, 0, 0, False, ("slab", "wgmma")))
    for what, shape, fmt, window, sinks, fixed, routes in cases:
        b, hq, hkv, t, s_max, lens, offs, d = shape
        q = torch.randn(b, hq, t, d, generator=gen, device=dev).bfloat16()
        kv_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
        q_offsets = torch.tensor(offs, dtype=torch.int32, device=dev)
        if fmt is None:
            cache = tuple(torch.randn(b, hkv, s_max, d, generator=gen,
                                      device=dev).bfloat16() for _ in range(2))
            yard = cache
            plain = fa._fwd_ragged_plain(q, *cache, kv_lens, q_offsets, True,
                                         d ** -0.5, window, sinks,
                                         fa.FIXED if fixed else fa.ONLINE)
            live = 2 * sum(lens) * hkv * d * 2
        else:
            kq, ks = cs.quantized(gen, dev, (b, hkv, s_max, d), fmt)
            vq, vs = cs.quantized(gen, dev, (b, hkv, s_max, d), fmt)
            cache = (kq, ks, vq, vs)
            yard = (cs.dequantized_bf16(kq, ks), cs.dequantized_bf16(vq, vs))
            plain = fa._fwd_ragged_q_plain(q, *cache, kv_lens, q_offsets, True,
                                           d ** -0.5, window, sinks,
                                           fa.FIXED if fixed else fa.ONLINE)
            live = cs.bytes_8bit(sum(lens), hkv, d)
        band = f", window {window}, {sinks} sinks" if window else ""
        name = (f"{what} {fmt or 'bf16'}{band}{', fixed-max' if fixed else ''} "
                f"(b{b} {hq}/{hkv} t{t} s_max{s_max} d{d} kv_lens {lens} "
                f"q_offsets {offs})")
        fns = {}
        for key, entry in entries.items():
            plan = pd.ragged_plan(b, hq, hkv, t, s_max, d, fmt is not None)
            if (key in slab_only and (what != "verify" or window or fixed)) or (
                    key in wgmma_only and not routes
                    and plan.route != pd.RAGGED_WGMMA):
                continue
            mine = ((pd.RAGGED_WGMMA,) if key in wgmma_only and routes
                    else routes if entry[1] else None)
            for route in mine or (None,):
                fn = call(entry, cache, q, kv_lens, q_offsets, True, window,
                          sinks, fixed, route)
                got = fn()
                torch.cuda.synchronize()
                err = cs._rel_l2(got, plain)
                if key not in wgmma_only and (not err <= cs.O_TOL
                                             or not torch.isfinite(got).all()):
                    raise SystemExit(f"{key} at {name}: rel-L2 {err:.3e}")
                tag = f"{key} ({route})" if route else key
                print(f"{tag} at {name}: rel-L2 {err:.3e}", flush=True)
                fns[tag] = fn
        if what == "verify" and not window and not fixed:
            # kernel 11 on the same K/V cut into pages of 128, q offsets
            # kv_lens - T as the paged verify's
            fns["this kernel 11 (pages of 128)"] = kernel11(q, cache, kv_lens,
                                                            q_offsets, plain, cs)
        mask = fa._ragged_mask(t, s_max, kv_lens, q_offsets, True, window, sinks)
        fns["SDPA + mask"] = cs.sdpa_fn(q, *yard, mask=mask)
        plan = pd.ragged_plan(b, hq, hkv, t, s_max, d, fmt is not None)
        if window:
            pairs = hq * sum(cs.band_pairs(t, n, off, window, sinks)
                             for n, off in zip(lens, offs))
        else:
            pairs = hq * sum(cs.visible_pairs(t, n, off, True)
                             for n, off in zip(lens, offs))
        bnd = cs.bound(4 * d * pairs, cs.nbytes(q, q, kv_lens, q_offsets) + live)
        ms = cs.time_turns(fns, dev)
        print(f"{name}: this plan {tuple(plan)}, bound {bnd['bound_ms']:.4f} ms "
              f"({bnd['bound_by']}) | "
              + " | ".join(f"{key} {v:.4f} ({bnd['bound_ms'] / v:.1%} of the "
                           f"bound)" for key, v in ms.items())
              + f" [{label}]", flush=True)
        cold = cs.time_turns({"flush": flush, **{
            key: (lambda f=f: (flush(), f())) for key, f in fns.items()}}, dev)
        print(f"{name}: from a cold L2 (each call after a {FLUSH_MB} MB write, "
              f"less the write's {cold['flush']:.4f} ms) | "
              + " | ".join(f"{key} {v - cold['flush']:.4f}"
                           for key, v in cold.items() if key != "flush")
              + f" [{label}]", flush=True)
    stream(entries, cs, dev, gen, label)


def kernel11(q, cache, kv_lens, q_offsets, plain, cs, page=128):
    """A closure making one call of this build's paged extend (kernel 11)
    over the linear cache cut into pages of `page` rows (a copy, made
    here), held to `plain` first."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import paged_decode as pd

    b, hkv, s_max, d = cache[0].shape
    n = s_max // page

    def pages(x):  # [b, hkv, s_max, w] -> [b * n, hkv, page, w]
        return (x.reshape(b, hkv, n, page, x.shape[-1]).permute(0, 2, 1, 3, 4)
                .reshape(b * n, hkv, page, x.shape[-1]).contiguous())

    def scale_pages(x):  # [b, hkv, s_max, 1] -> lane-major [b * n, hkv, 1, page]
        return pages(x).transpose(-1, -2).contiguous()

    pools = (tuple(pages(x) for x in cache) if len(cache) == 2 else
             (pages(cache[0]), scale_pages(cache[1]), pages(cache[2]),
              scale_pages(cache[3])))
    table = torch.arange(b * n, dtype=torch.int32, device=q.device).reshape(b, n)
    fn = lambda: pd._extend_cuda(q, pools, table, kv_lens, q_offsets,  # noqa: E731
                                 q.shape[-1] ** -0.5, None, whole=True)
    err = cs._rel_l2(fn(), plain)
    if not err <= cs.O_TOL:
        raise SystemExit(f"kernel 11 over pages of {page}: rel-L2 {err:.3e}")
    return fn


def stream(entries, cs, dev, gen, label):
    """The stream copy of each build, bit-equal to x + 1, timed in turns
    with x + 1 at STREAM, f32 and bf16."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import _build

    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(*STREAM, generator=gen, device=dev).to(dtype)
        fns = {}
        for key, (cdll, _) in entries.items():
            if not hasattr(cdll, "fkp_stream_copy"):
                continue
            fn = cdll.fkp_stream_copy
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                           ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int

            def run(fn=fn, key=key):
                out = torch.empty_like(x)
                _build.check(fn(x.data_ptr(), out.data_ptr(), x.numel(),
                                int(dtype == torch.bfloat16),
                                torch.cuda.current_stream().cuda_stream), key)
                return out
            if not torch.equal(run(), x + 1):
                raise SystemExit(f"{key}: the stream copy differs from x + 1")
            fns[f"{key} stream copy"] = run
        fns["x + 1"] = lambda: x + 1
        bnd = cs.bound(0, 2 * x.numel() * x.element_size())
        ms = cs.time_turns(fns, dev)
        print(f"stream copy {tuple(x.shape)} {dtype} (bit-equal to x + 1): bound "
              f"{bnd['bound_ms']:.4f} ms | "
              + " | ".join(f"{key} {v:.4f} ({bnd['bound_ms'] / v:.1%})"
                           for key, v in ms.items()) + f" [{label}]", flush=True)


def profile_run(root):
    """One linear speculative round and one chunked prefill under
    torch.profiler through the package of `root` (this process imports
    it): device time and device operations of each."""
    sys.path.insert(0, root)
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from flashattention_kernel_project_tpu_torch.models import engine
    from flashattention_kernel_project_tpu_torch.models import transformer as tfm
    from flashattention_kernel_project_tpu_torch.ops import _build
    from flashattention_kernel_project_tpu_torch.utils import platform

    assert _build.CSRC.startswith(os.path.abspath(root)), _build.CSRC
    cs = _smoke()
    _build.library()
    label = platform.card_label()
    tree = os.path.relpath(root, ROOT) if root != ROOT else "this"
    dev = torch.device("cuda", 0)
    cfg = tfm.TransformerConfig(**cs.SERVING, dtype=torch.bfloat16)
    params = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    dcfg = tfm.TransformerConfig(**cs.DRAFT, dtype=torch.bfloat16)
    dparams = tfm.init_params(dcfg, torch.Generator(device=dev).manual_seed(1), dev)
    cs.profile_spec_round(dev, cfg, params, dcfg, dparams, f"{tree}; {label}",
                          paged=False)
    cache = engine.init_cache(cfg, 1, 2304, dev)
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (1, 256)).astype(np.int64)).to(dev)

    def chunk():
        cache.lengths.fill_(512)
        engine.extend(cfg, params, tokens, cache)

    for _ in range(2):
        chunk()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            chunk()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kinds = cs.device_ms_by_kind(prof)
    busy = sum(kinds.values())
    print(f"chunked prefill ({tree}: 256 tokens onto 512 cached, 1 sequence, "
          f"{cfg.n_layers} layers): {busy / 3:.3f} ms of device time a chunk, "
          f"{len(events) / 3:.0f} device operations a chunk | "
          + ", ".join(f"{k} {v / 3:.3f} ms" for k, v in
                      sorted(kinds.items(), key=lambda kv: -kv[1]))
          + f" [{label}]", flush=True)


def main() -> int:
    import torch

    args = sys.argv[1:]
    if args[:1] == ["--profile-run"]:
        profile_run(os.path.abspath(args[1]))
        return 0
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    roots = []
    while "--profile" in args:
        i = args.index("--profile")
        roots.append(os.path.abspath(args[i + 1]))
        del args[i:i + 2]
    threshold = "--threshold" in args
    args = [a for a in args if a != "--threshold"]
    sys.path.insert(0, ROOT)
    kernels(args, threshold)
    for other in roots:  # other, this, this, other: each its own process
        for root in (other, ROOT, ROOT, other):
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--profile-run", root], check=True, cwd=root)
    return 0


if __name__ == "__main__":
    sys.exit(main())
