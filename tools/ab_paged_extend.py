#!/usr/bin/env python3
"""Compare builds of the paged extend (kernel 11, bf16 and 8-bit) on one
card, in turns.

    python3 tools/ab_paged_extend.py [NAME=CSRC_DIR[:FLAG,...] ...] [--slices ROOT ...]

Builds this checkout's extend sources (csrc/paged_extend.cu and
paged_extend_q.cu, with common.cu) into a library of its own under
flashattention_kernel_project_tpu_torch/build/ab/, prints ptxas's register
and spill lines for their instances, and runs the port's wrappers on it
("this"). Each NAME=CSRC_DIR builds that directory's extend the same way,
with the nvcc flags after ':': a directory with paged_extend_sm90.cuh is
called as this tree's entries take their inputs (one launch, the split
merge on the card, this tree's split plan; with the flag
-DFKP_EXT_PROBE=1 the last block of a row arrives and does not merge, a
probe timed and not checked), one without it as the earlier
kernel was (csrc/paged_extend.cu on flash_fwd_core.cuh's paged flavour: one
block per row tile, KV head and batch row, its C entries' arguments).
CSRC_DIR is a csrc/ directory: this checkout's, or another commit's from an
unpacked `git archive`.

It holds every build against the plain version at each timed shape
(rel-L2 1e-2) and times from CUDA graphs, in turns (in order, then in
reverse, the smaller of the two): each build's whole call and this
build's kernel alone (its split partials) beside SDPA on the K/V already
gathered into a linear cache with the verify's causal-offset mask (a
yardstick, not the same function: the gather is left out), over a bf16,
an int8 and an e4m3 pool (SDPA on the dequantized rows), at the serving
verify (chip_smoke.py's EXT_SERVING: B 8, 16/4 heads, T 5, d 128, pages of
128, 16 a row) and at pages of 16 (128 a row).

With --slices ROOT (a checkout, e.g. an unpacked parent): the paged
speculative slice and the int8 paged speculative slice (chip_smoke.py's
32 serving requests, bench_spec.py's draft, spec_k 4) and one profiled
speculative round over each pool, run by the package of ROOT and of this
checkout in turns (ROOT, this, this, ROOT), each in a process of its own
that builds its tree's kernels: tok/s, device time a round and the
device's busy share.
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


NEW_SOURCES = ("paged_extend.cu", "paged_extend_q.cu", "common.cu")
OLD_SOURCES = ("paged_extend.cu", "common.cu")
PAGE16 = (8, 16, 4, 128, 16, 128, 5, [0, 1, 12, 15, 16, 700, 1500, 2043])


def build(name, csrc, flags, out_dir):
    """(a library built from csrc's extend sources, whether it has this
    tree's entries). Prints each source's compile seconds (all at once, one
    nvcc each) and its kernels' ptxas lines."""
    from flashattention_kernel_project_tpu_torch.ops import _build

    new = os.path.exists(os.path.join(csrc, "paged_extend_sm90.cuh"))
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


def whole_call(entry, q, pools, table, new_lengths, old_lengths):
    """A closure making one whole extend call through a build."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import _build
    from flashattention_kernel_project_tpu_torch.ops import paged_decode as pd

    d = q.shape[-1]
    if entry == "this":
        return lambda: pd._extend_cuda(q, pools, table, new_lengths,
                                       old_lengths, d ** -0.5, None, whole=True)
    cdll, new = entry
    quant = len(pools) == 4
    b, hq, t, _ = q.shape
    n_pages, hkv, page, _ = pools[0].shape
    max_pages = table.shape[1]
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fn = cdll.fkp_paged_extend_q if quant else cdll.fkp_paged_extend
    ptrs = [x.data_ptr() for x in (q, *pools, table, new_lengths, old_lengths)]
    tail = ([i32] if quant else []) + [vp]
    fp8 = [int(pools[0].dtype == torch.float8_e4m3fn)] if quant else []
    if new:
        rows, tiles, n, block_s = pd.extend_plan(q.shape, hkv, page, max_pages)
        fn.argtypes = [vp] * (len(ptrs) + 4) + [i32] * 11 + [ctypes.c_float] + tail
        fn.restype = i32

        def run():
            out = torch.empty_like(q)
            cells = b * hkv * tiles * n * rows
            ws = torch.empty(cells * (d + 2), dtype=torch.float32, device=q.device)
            work = ([ws[:cells].data_ptr(), ws[cells:2 * cells].data_ptr(),
                     ws[2 * cells:].data_ptr()] if n > 1 else [None] * 3)
            _build.check(fn(*ptrs, out.data_ptr(), *work, b, hq, hkv, t, page, d,
                            max_pages, n_pages, n, block_s, rows,
                            d ** -0.5 * 1.4426950408889634, *fp8,
                            torch.cuda.current_stream().cuda_stream), "extend")
            return out
        return run
    fn.argtypes = [vp] * (len(ptrs) + 1) + [i32] * 7 + [ctypes.c_float] + tail
    fn.restype = i32

    def run_old():
        out = torch.empty_like(q)
        _build.check(fn(*ptrs, out.data_ptr(), b, hq, hkv, t, page, d,
                        max_pages, d ** -0.5 * 1.4426950408889634, *fp8,
                        torch.cuda.current_stream().cuda_stream), "extend")
        return out
    return run_old


def kernels(specs):
    """Build this checkout's extend and each NAME=CSRC_DIR's, then hold and
    time them in turns at the serving verify and at pages of 16."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import _build
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
        if "FKP_EXT_PROBE" in flags:
            probes.add(name)
        entries[name] = build(name, os.path.abspath(csrc),
                              [f for f in flags.split(",") if f], out_dir)
    label = platform.card_label()
    print(label, flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(53)
    for shape in (cs.EXT_SERVING, PAGE16):
        b, hq, hkv, d, page, max_pages, t, old = shape
        new = [n + t for n in old]
        pairs = hq * sum(cs.visible_pairs(t, n, off, True) for n, off in zip(new, old))
        rows, tiles, n_splits, block_s = pd.extend_plan((b, hq, t, d), hkv, page,
                                                        max_pages)
        for fmt in (None, "int8", "fp8"):
            q, pools, table, new_lengths, old_lengths = cs._ext_case(
                gen, dev, fmt, b, hq, hkv, d, page, max_pages, t, old)
            plain = cs.ext_plain(q, pools, table, new_lengths, old_lengths,
                                 d ** -0.5)
            what = (f"{fmt or 'bf16'} b{b} {hq}/{hkv} t{t} d{d} page{page} "
                    f"max_pages{max_pages}")
            for name, entry in entries.items():
                if name in probes:
                    continue
                got = whole_call(entry, q, pools, table, new_lengths, old_lengths)()
                torch.cuda.synchronize()
                err = cs._rel_l2(got, plain)
                if not err <= cs.O_TOL or not torch.isfinite(got).all():
                    raise SystemExit(f"{name} at {what}: rel-L2 {err:.3e}")
                print(f"{name} at {what}: rel-L2 {err:.3e}", flush=True)
            if fmt is None:
                yard, live_bytes = pools, 2 * sum(new) * hkv * d * 2
            else:
                yard = (cs.dequantized_bf16(*pools[:2]),
                        cs.dequantized_bf16(*pools[2:]))
                live_bytes = cs.bytes_8bit(sum(new), hkv, d)
            fns = {"SDPA yardstick": cs.ext_yardstick(q, *yard, table, new_lengths,
                                                      old_lengths),
                   "this kernel": lambda: pd._extend_cuda(
                       q, pools, table, new_lengths, old_lengths, d ** -0.5,
                       None, whole=False),
                   **{f"{name} call": whole_call(entry, q, pools, table,
                                                 new_lengths, old_lengths)
                      for name, entry in entries.items()}}
            ms = cs.time_turns(fns, dev)
            bnd = cs.bound(4 * d * pairs, cs.nbytes(q, q, table, new_lengths,
                                                    old_lengths) + live_bytes)
            print(f"{what}: {n_splits} splits of {block_s}, {tiles} row tile(s) of "
                  f"{rows}, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}) | "
                  + " | ".join(f"{key} {v:.4f} ({bnd['bound_ms'] / v:.1%} of the "
                               f"bound)" for key, v in ms.items())
                  + f" [{label}]", flush=True)


def slice_run(root):
    """The two paged speculative slices and a profiled round over each
    pool, through the package of `root` (this process imports it)."""
    sys.path.insert(0, root)
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
    dcfg = tfm.TransformerConfig(**cs.DRAFT, dtype=torch.bfloat16)
    dparams = tfm.init_params(dcfg, torch.Generator(device=dev).manual_seed(1), dev)
    prompts = cs.serving_prompts(cfg, 32)
    tree = os.path.relpath(root, ROOT) if root != ROOT else "this"
    for quantized in (False, True):
        tag = f"{'int8 ' if quantized else ''}spec slice (paged), {tree}"
        kw = dict(max_batch=8, max_len=2048, paged=True, page_size=128,
                  draft_cfg=dcfg, draft_params=dparams, spec_k=cs.SPEC_K,
                  quantized_cache=quantized)
        cs.serve(dev, cfg, params, prompts, 64,
                 ("paged_extend_q",) if quantized else ("paged_extend",),
                 label, tag, **kw)
        cs.profile_spec_round(dev, cfg, params, dcfg, dparams,
                              f"{tree}; {label}", quantized=quantized)


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
