#!/usr/bin/env python3
"""Compare builds of the paged decode (kernels 9/10 and 12, bf16 and 8-bit)
on one card, in turns.

    python3 tools/ab_paged_decode.py [NAME=CSRC_DIR[:FLAG,...] ...] [--slices ROOT ...]

Builds this checkout's decode sources (csrc/paged_decode*.cu, with
common.cu) into a library of its own under
flashattention_kernel_project_tpu_torch/build/ab/, prints each source's
compile seconds and ptxas's register and spill lines for its instances,
and runs the port's wrappers on it ("this"). Each NAME=CSRC_DIR builds that
directory's decode the same way, with the nvcc flags after ':': a directory
with paged_decode_qi8.cu is called as this tree's entries take their inputs
(one launch, the split merge on the card, this tree's split plan; a probe,
timed and not checked, with paged_extend_sm90.cuh's flags
-DFKP_EXT_PROBE=1: the last block arrives and does not merge,
-DFKP_DEC_PROBE=2: the loads alone, -DFKP_DEC_PROBE=3: the loads and the
8-bit widening, no products), one
without it as the earlier kernel was (csrc/paged_decode.cu on
decode_core.cuh: the splits' partials of its own split plan, pages per
split for about two blocks an SM, then the plain merge_partials, reshape
and cast that its wrapper ran after the kernel). CSRC_DIR is a csrc/
directory: this checkout's, or another commit's from an unpacked `git
archive`.

It holds every build against the plain version at each timed shape
(rel-L2 1e-2; the int8 score product 1e-3) and times from CUDA graphs, in
turns (in order, then in reverse, the smaller of the two): each build's
whole call and its kernel alone (the split partials) beside SDPA on the K/V
already gathered into a linear cache with the length mask (a yardstick, not
the same function: the gather is left out), then each build's whole call
from a cold L2 (after a 128 MB write, less the write's time), over a bf16, an int8 and an
e4m3 pool (SDPA on the dequantized rows) and with the int8 score product,
at the serving shape (chip_smoke.py's PDEC_SERVING: B 8, 16/4 heads, d 128,
pages of 128, 16 a row, ragged lengths), at chip_smoke.py's AB_PAGED (64
pages of 128 a row, every length 8192), at pages of 16 (128 a row, the
serving lengths) and at the profiled decode step's pool (5 pages of 128 a
row, every length 600).

With --slices ROOT (a checkout, e.g. an unpacked parent): the paged serving
slice and the int8 paged serving slice (chip_smoke.py's 32 serving requests
sharing a 384-token prefix, prefix cache, prefill in chunks of 256) and
profiled decode steps (linear, paged, int8 linear, int8 paged at B 8),
run by the package of ROOT and of this checkout in turns (ROOT, this,
this, ROOT), each in a process of its own that builds its tree's kernels:
tok/s, device time a step and the device's busy share.
"""

import ctypes
import importlib.util
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    """This checkout's chip_smoke.py as a module (whatever package the
    process imports)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_ab", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # its dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


NEW_SOURCES = ("paged_decode.cu", "paged_decode_deep.cu", "paged_decode_q.cu",
               "paged_decode_q_deep.cu", "paged_decode_qi8.cu", "common.cu")
OLD_SOURCES = ("paged_decode.cu", "paged_decode_slots3.cu",
               "paged_decode_slots4.cu", "common.cu")
SERVING_LENS = [1, 127, 128, 129, 700, 1500, 2048, 0]
FLUSH_MB = 128  # written before a call timed from a cold L2 (the H100's holds 50)
SHAPES = (  # (b, hq, hkv, d, page, max_pages, lengths)
    (8, 16, 4, 128, 128, 16, SERVING_LENS),
    (8, 16, 4, 128, 128, 64, [8192] * 8),
    (8, 16, 4, 128, 16, 128, SERVING_LENS),
    (8, 16, 4, 128, 128, 5, [600] * 8),  # chip_smoke.py's profiled decode step
)


def build(name, csrc, flags, out_dir):
    """(a library built from csrc's decode sources, whether it has this
    tree's entries). Prints each source's compile seconds (all at once, one
    nvcc each) and its kernels' ptxas lines."""
    from flashattention_kernel_project_tpu_torch.ops import _build

    new = os.path.exists(os.path.join(csrc, "paged_decode_qi8.cu"))
    srcs = NEW_SOURCES if new else OLD_SOURCES
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
            elif f != "common.cu" and ("registers" in line or "spill" in line):
                print(f"{name}: {kernel}: {line.split(':', 1)[-1].strip()}",
                      flush=True)
    lib = os.path.join(out_dir, f"lib{name}.so")
    subprocess.run([_build.nvcc(), "-shared", "-gencode",
                    "arch=compute_90a,code=sm_90a", *objs, "-o", lib], check=True)
    cdll = ctypes.CDLL(lib)
    cdll.fkp_error_string.restype = ctypes.c_char_p
    cdll.fkp_error_string.argtypes = [ctypes.c_int]
    return cdll, new


def old_pages_per_split(b, hkv, max_pages):
    """The earlier kernel's split plan (its wrapper's gather_pages_per_split):
    pages per split for about two blocks an SM."""
    from flashattention_kernel_project_tpu_torch.utils.platform import H100_SMS

    want = -(-2 * H100_SMS // max(b * hkv, 1))
    return -(-max_pages // max(1, min(want, max_pages)))


def calls(cs, entry, q, pools, table, lengths, q_int8=False):
    """(the whole call, the kernel alone) through a build, as closures (cs:
    this checkout's chip_smoke.py)."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import _build
    from flashattention_kernel_project_tpu_torch.ops import flash_decode as fd
    from flashattention_kernel_project_tpu_torch.ops import paged_decode as pd

    b, hq, d = q.shape
    n_pages, hkv, page, _ = pools[0].shape
    max_pages = table.shape[1]
    if entry == "this":
        kw = {"q_int8": True} if q_int8 else {}
        _, block_s = pd.decode_plan(b, hkv, page, max_pages, d)
        whole = cs.pdec_whole(q, pools, table, lengths, **kw)
        return whole, lambda: pd._decode_cuda(q, pools, table, lengths, block_s,
                                              d ** -0.5, False, q_int8=q_int8)
    cdll, new = entry
    quant = len(pools) == 4
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    ptrs = [x.data_ptr() for x in (q, *pools, table, lengths)]
    if new:
        _, block_s = pd.decode_plan(b, hkv, page, max_pages, d)
        fn = cdll.fkp_paged_decode_q if quant else cdll.fkp_paged_decode
        fn.argtypes = ([vp] * (len(ptrs) + 4) + [i32] * 9 + [ctypes.c_float]
                       + [i32] * (3 if quant else 2) + [vp])
        fn.restype = i32
        n = -(-max_pages * page // block_s)

        def run(whole):
            out = torch.empty_like(q) if whole else None
            cells = b * hkv * n * 16
            ws = torch.empty(cells * (d + 2), dtype=torch.float32, device=q.device)
            work = [ws[:cells], ws[cells:2 * cells], ws[2 * cells:]]
            tail = ([int(pools[0].dtype == torch.float8_e4m3fn), int(q_int8), 2]
                    if quant else [2, 0])
            _build.check(fn(*ptrs, out.data_ptr() if whole else None,
                            *(w.data_ptr() for w in work), b, hq, hkv, page, d,
                            max_pages, n_pages, n, block_s,
                            d ** -0.5 * 1.4426950408889634, *tail, stream()),
                         "paged_decode")
            return out if whole else work
        return lambda: run(True), lambda: run(False)
    pps = old_pages_per_split(b, hkv, max_pages)
    n = -(-max_pages // pps)
    g = hq // hkv
    name = ("fkp_paged_decode_qi8" if q_int8 else "fkp_paged_decode_q") if quant \
        else "fkp_paged_decode"
    fn = getattr(cdll, name)
    fn.argtypes = ([vp] * (len(ptrs) + 3) + [i32] * 8 + [ctypes.c_float]
                   + [i32] * (1 if q_int8 else 2) + [vp])
    fn.restype = i32
    scale = d ** -0.5 * (1.4426950408889634 if q_int8 else 1.0)
    tail = ([2] if q_int8 else [int(pools[0].dtype == torch.float8_e4m3fn), 2]) \
        if quant else [2, 0]

    def partials():
        m = torch.empty((b, hkv, n, g, 1), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
        y = torch.empty((b, hkv, n, g, d), dtype=torch.float32, device=q.device)
        _build.check(fn(*ptrs, m.data_ptr(), l.data_ptr(), y.data_ptr(), b, hq,
                        hkv, page, d, max_pages, n, pps, scale, *tail, stream()),
                     name)
        return m, l, y
    return (lambda: fd.merge_partials(*partials()).reshape(b, hq, d).to(q.dtype),
            partials)


def kernels(specs):
    """Build this checkout's decode and each NAME=CSRC_DIR's, then hold and
    time them in turns at the serving shape, AB_PAGED and pages of 16."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import _build
    from flashattention_kernel_project_tpu_torch.ops import flash_decode as fd
    from flashattention_kernel_project_tpu_torch.ops import paged_decode as pd
    from flashattention_kernel_project_tpu_torch.utils import platform

    cs = _smoke()
    out_dir = os.path.join(_build.BUILD_DIR, "ab")
    os.makedirs(out_dir, exist_ok=True)
    this, _ = build("this", _build.CSRC, [], out_dir)
    _build.library = lambda: this  # the port's wrappers launch this build
    entries = {"this": "this"}
    probes = set()
    for spec in specs:
        name, _, rest = spec.partition("=")
        csrc, _, flags = rest.partition(":")
        if "_PROBE" in flags:
            probes.add(name)
        entries[name] = build(name, os.path.abspath(csrc),
                              [f for f in flags.split(",") if f], out_dir)
    label = platform.card_label()
    print(label, flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(59)
    scratch = torch.empty(FLUSH_MB << 20, dtype=torch.uint8, device=dev)
    flush = lambda: scratch.fill_(1)  # noqa: E731
    for b, hq, hkv, d, page, max_pages, lens in SHAPES:
        live = sum(min(n, max_pages * page) for n in lens)
        n_splits, block_s = pd.decode_plan(b, hkv, page, max_pages, d)
        for fmt in ("bf16", "int8", "q_int8", "fp8"):
            q = torch.randn(b, hq, d, generator=gen, device=dev).bfloat16()
            if fmt == "bf16":
                _, k, v, table, lengths = cs._paged_case(gen, dev, b, hq, hkv, d,
                                                         page, max_pages, lens)
                pools = yard = (k, v)
                live_bytes = 2 * live * hkv * d * 2
            else:
                pools, table = cs._paged_8bit_case(
                    gen, dev, "fp8" if fmt == "fp8" else "int8", b, hkv, d,
                    page, max_pages, lens)
                lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
                yard = (cs.dequantized_bf16(*pools[:2]),
                        cs.dequantized_bf16(*pools[2:]))
                live_bytes = cs.bytes_8bit(live, hkv, d)
            q_int8 = fmt == "q_int8"
            plain = fd.merge_partials(*cs.pdec_plain(
                q, pools, table, lengths, block_s, d ** -0.5, q_int8=q_int8))
            plain = plain.reshape(b, hq, d)
            tol = cs.QI8_VS_PLAIN_TOL if q_int8 else cs.O_TOL
            what = (f"{fmt} b{b} {hq}/{hkv} d{d} page{page} max_pages{max_pages} "
                    f"lengths {lens}")
            fns = {"SDPA yardstick": cs.pdec_yardstick(q, *yard, table, lengths)}
            for name, entry in entries.items():
                whole, kernel = calls(cs, entry, q, pools, table, lengths, q_int8)
                if name not in probes:
                    got = whole()
                    torch.cuda.synchronize()
                    err = cs._rel_l2(got, plain.to(got.dtype))
                    if not err <= tol or not torch.isfinite(got).all():
                        raise SystemExit(f"{name} at {what}: rel-L2 {err:.3e}")
                    print(f"{name} at {what}: rel-L2 {err:.3e}", flush=True)
                fns[f"{name} call"] = whole
                fns[f"{name} kernel"] = kernel
            ms = cs.time_turns(fns, dev)
            bnd = cs.bound(4 * live * hq * d,
                           cs.nbytes(q, q, table, lengths) + live_bytes)
            print(f"{what}: this plan {n_splits} splits of {block_s}, bound "
                  f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}) | "
                  + " | ".join(f"{key} {v:.4f} ({bnd['bound_ms'] / v:.1%} of the "
                               f"bound)" for key, v in ms.items())
                  + f" [{label}]", flush=True)
            # the same calls from a cold L2, as a decode step's layers find
            # it: each after a write of more bytes than the L2 holds, less
            # that write's own time
            cold = cs.time_turns({"flush": flush, **{
                key: (lambda f=f: (flush(), f())) for key, f in fns.items()
                if key.endswith(" call")}}, dev)
            print(f"{what}: from a cold L2 (each call after a {FLUSH_MB} MB "
                  f"write, less the write's {cold['flush']:.4f} ms) | "
                  + " | ".join(f"{key} {v - cold['flush']:.4f}"
                               for key, v in cold.items() if key != "flush")
                  + f" [{label}]", flush=True)


def slice_run(root):
    """The paged and the int8 paged serving slices and profiled decode
    steps, through the package of `root` (this process imports it)."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from flashattention_kernel_project_tpu_torch.models import transformer as tfm
    from flashattention_kernel_project_tpu_torch.ops import _build
    from flashattention_kernel_project_tpu_torch.utils import platform

    assert _build.CSRC.startswith(os.path.abspath(root)), _build.CSRC
    cs = _smoke()
    _build.library()
    label = platform.card_label()
    dev = torch.device("cuda", 0)
    cfg = tfm.TransformerConfig(**cs.SERVING, dtype=torch.bfloat16)
    params = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    prompts = cs.serving_prompts(cfg, 32)
    system = np.random.default_rng(1).integers(0, cfg.vocab_size, 384)
    with_system = [np.concatenate([system, p]).astype(np.int32) for p in prompts]
    tree = os.path.relpath(root, ROOT) if root != ROOT else "this"
    for quantized in (False, True):
        tag = f"{'int8 ' if quantized else ''}paged slice, {tree}"
        cs.serve(dev, cfg, params, with_system, 64,
                 ("paged_decode_q",) if quantized else ("paged_decode",),
                 label, tag, max_batch=8, max_len=2048, paged=True,
                 page_size=128, prefix_cache=True, prefill_chunk=256,
                 quantized_cache=quantized)
    cs.profile_decode_steps(dev, cfg, params, f"{tree}; {label}",
                            one_attention_op=root == ROOT)


def main() -> int:
    import torch

    args = sys.argv[1:]
    if args[:1] == ["--slice-run"]:
        slice_run(os.path.abspath(args[1]))
        return 0
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    roots = []
    while "--slices" in args:
        i = args.index("--slices")
        roots.append(os.path.abspath(args[i + 1]))
        del args[i:i + 2]
    sys.path.insert(0, ROOT)
    kernels(args)
    for other in roots:  # other, this, this, other: each its own process
        for root in (other, ROOT, ROOT, other):
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--slice-run", root], check=True, cwd=root)
    return 0


if __name__ == "__main__":
    sys.exit(main())
