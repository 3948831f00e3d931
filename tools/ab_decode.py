#!/usr/bin/env python3
"""Compare builds of the bf16 linear decode (kernel 6) on one card, in
turns.

    python3 tools/ab_decode.py [NAME=CSRC_DIR[:FLAG,...] ...]

Builds this checkout's decode sources (csrc/flash_decode_sm90.cu and
common.cu) into a library of its own under
flashattention_kernel_project_tpu_torch/build/ab/, prints ptxas's register
and spill lines for the decode's instances, and runs the port's
`flash_decode` on it ("this"). Each NAME=CSRC_DIR builds that directory's
decode the same way, with the nvcc flags after ':' (e.g.
csrc/flash_decode_sm90.cuh's probe -DFKP_DEC_PROBE=1: the last block of a
row arrives and does not merge; a probe is timed, not checked): a directory with
flash_decode_sm90.cu is called as this tree's entry takes its inputs (one
launch, the split merge on the card, this tree's split rule), one without
it as the earlier kernel was (csrc/flash_decode.cu's partials at the
8-bit decodes' split rule, then `merge_partials`, a reshape and a cast in
plain torch: that tree's whole call). CSRC_DIR is a csrc/ directory: this
checkout's, or another commit's from an unpacked `git archive`.

It holds this build against the plain version at the edges of the tiles
and splits (chip_smoke.py's `dec_edges`) and every build but a probe at
each timed shape (rel-L2 1e-2), and times from CUDA graphs, in turns (in order, then in reverse, the
smaller of the two): each build's whole call and this build's kernel
alone (its partials) beside SDPA at the serving shape (B 8, 16/4 heads, S
2048, d 128, chip_smoke.py's lengths, SDPA with a length mask), with the
serving window (256, 4 sinks; SDPA with the band mask) and at run_all.py's
streaming rung (B 256, 8/1 heads, S 4096, every length 4096), there beside
kernel 21 (streaming_decode: the same kernel at one split) and SDPA, and
at the most splits the rule gives (one sequence of 65536 keys, 8/1 heads,
d 128 and 64: 264 and 512 splits).
"""

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

NEW_SOURCES = ("flash_decode_sm90.cu", "common.cu")
OLD_SOURCES = ("flash_decode.cu", "common.cu")
SERVING = (8, 16, 4, 2048, 128)
WINDOW = ([100, 255, 256, 257, 700, 1500, 2000, 2048], 256, 4)
RUNG = (256, 8, 1, 4096, 128)
# one sequence of 65536 keys, 8/1 heads: the most splits the rule gives (264
# at d 128, 512 at d 64), the split merge's largest work
MANY = [(1, 8, 1, 65536, 128), (1, 8, 1, 65536, 64)]


def build(name, csrc, flags, out_dir):
    """(a library built from csrc's decode sources, whether it has this
    tree's entries)."""
    from flashattention_kernel_project_tpu_torch.ops import _build

    new = os.path.exists(os.path.join(csrc, "flash_decode_sm90.cu"))
    srcs = NEW_SOURCES if new else OLD_SOURCES
    objs = [os.path.join(out_dir, f"{name}.{f}.o") for f in srcs]
    procs = [subprocess.Popen([_build.nvcc(), *_build.NVCC_FLAGS, *flags, "-c",
                               os.path.join(csrc, f), "-o", o],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for f, o in zip(srcs, objs)]
    kernel = ""
    for p in procs:
        out, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"{name}: build failed\n{out[-6000:]}")
        for line in out.splitlines():
            if "Compiling entry function" in line:
                kernel = cs.mangled_name(line.split("'")[1])[0]
                args = cs.template_args(kernel, 3)(line.split("'")[1])
            elif "decode" in kernel and "sm90" in kernel and (
                    "registers" in line or "spill" in line):
                print(f"{name}: {kernel}{args}: {line.split(':', 1)[-1].strip()}",
                      flush=True)
    lib = os.path.join(out_dir, f"lib{name}.so")
    subprocess.run([_build.nvcc(), "-shared", "-gencode",
                    "arch=compute_90a,code=sm_90a", *objs, "-o", lib], check=True)
    cdll = ctypes.CDLL(lib)
    cdll.fkp_error_string.restype = ctypes.c_char_p
    cdll.fkp_error_string.argtypes = [ctypes.c_int]
    return cdll, new


def whole_call(entry, q, k, v, lengths, window, sinks):
    """A closure making one whole decode call through a build."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import _build
    from flashattention_kernel_project_tpu_torch.ops import flash_decode as fd

    if entry == "this":
        return lambda: fd.flash_decode(q, k, v, lengths, window=window or None,
                                       sinks=sinks)
    cdll, new = entry
    b, hq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    g = hq // hkv
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    tail = [i32] * 7 + [ctypes.c_float, i32, i32, vp]
    if new:
        fn = cdll.fkp_flash_decode_out
        fn.argtypes, fn.restype = [vp] * 8 + tail, i32
        n = fd.default_n_splits(b, hkv, s, d)
        block_s = fd.default_block_s(s, n)

        def run():
            out = torch.empty_like(q)
            _ws, work = fd._split_workspace(q, hkv, n)
            _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            lengths.data_ptr(), out.data_ptr(), *work, b, hq,
                            hkv, s, d, n, block_s, d ** -0.5, window, sinks,
                            torch.cuda.current_stream().cuda_stream),
                         "fkp_flash_decode_out")
            return out
        return run
    fn = cdll.fkp_flash_decode
    fn.argtypes, fn.restype = [vp] * 7 + tail, i32
    n = fd._core_n_splits(b, hkv, s)
    block_s = -(-s // n)

    def run_old():
        m = torch.empty((b, hkv, n, g, 1), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
        y = torch.empty((b, hkv, n, g, d), dtype=torch.float32, device=q.device)
        _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        lengths.data_ptr(), m.data_ptr(), l.data_ptr(),
                        y.data_ptr(), b, hq, hkv, s, d, n, block_s, d ** -0.5,
                        window, sinks, torch.cuda.current_stream().cuda_stream),
                     "fkp_flash_decode")
        return fd.merge_partials(m, l, y).reshape(b, hq, d).to(q.dtype)
    return run_old


def main() -> int:
    import torch

    from flashattention_kernel_project_tpu_torch.ops import _build
    from flashattention_kernel_project_tpu_torch.ops import flash_decode as fd
    from flashattention_kernel_project_tpu_torch.ops import streaming as st
    from flashattention_kernel_project_tpu_torch.utils import platform

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    out_dir = os.path.join(_build.BUILD_DIR, "ab")
    os.makedirs(out_dir, exist_ok=True)
    this, _ = build("this", _build.CSRC, [], out_dir)
    _build.library = lambda: this  # the port's wrappers launch this build
    entries = {"this": "this"}
    probes = set()
    for spec in sys.argv[1:]:
        name, _, rest = spec.partition("=")
        csrc, _, flags = rest.partition(":")
        if "FKP_DEC_PROBE" in flags:
            probes.add(name)
        entries[name] = build(name, os.path.abspath(csrc),
                              [f for f in flags.split(",") if f], out_dir)
    label = platform.card_label()
    print(label, flush=True)
    dev = torch.device("cuda", 0)
    cs.dec_edges(dev, label)

    def serving_inputs(b, hq, hkv, s, d, seed=11):
        gen = torch.Generator(device=dev).manual_seed(seed)
        q = torch.randn(b, hq, d, generator=gen, device=dev).bfloat16()
        k = torch.randn(b, hkv, s, d, generator=gen, device=dev).bfloat16()
        v = torch.randn(b, hkv, s, d, generator=gen, device=dev).bfloat16()
        lengths = torch.randint(1, s, (b,), generator=gen, device=dev,
                                dtype=torch.int32)
        lengths[0] = 0
        lengths[-1] = s
        return q, k, v, lengths

    def held(q, k, v, lengths, window, sinks, what):
        b, hq, d = q.shape
        s = k.shape[2]
        plain = fd._decode_plain(q, k, v, lengths, 1, s, d ** -0.5, window, sinks)
        for name, entry in entries.items():
            if name in probes:
                continue
            got = whole_call(entry, q, k, v, lengths, window, sinks)()
            torch.cuda.synchronize()
            err = cs._rel_l2(got, plain)
            if not err <= cs.O_TOL or not torch.isfinite(got).all():
                raise SystemExit(f"{name} at {what}: rel-L2 {err:.3e}")
            print(f"{name} at {what}: rel-L2 {err:.3e}", flush=True)

    def timed(what, q, k, v, lengths, window, sinks, library, extra=None):
        b, hq, d = q.shape
        s = k.shape[2]
        n = fd.default_n_splits(b, k.shape[1], s, d)
        args = (q, k, v, lengths, n, fd.default_block_s(s, n), d ** -0.5,
                window, sinks)
        fns = {"SDPA": library,
               "this kernel": lambda: fd._decode_partials_cuda(*args),
               **{f"{name} call": whole_call(entry, q, k, v, lengths, window, sinks)
                  for name, entry in entries.items()},
               **(extra or {})}
        ms = cs.time_turns(fns, dev)
        live = cs._live_keys(lengths.tolist(), window, sinks) if window else int(
            lengths.clamp(max=s).sum())
        bnd = cs.bound(4 * live * hq * d, cs.nbytes(q, q) + 2 * live * k.shape[1] * d * 2)
        print(f"{what}: {n} splits, bound {bnd['bound_ms']:.4f} ms | " + " | ".join(
            f"{key} {t:.4f} ({t / ms['SDPA']:.2f}x SDPA, {bnd['bound_ms'] / t:.1%})"
            for key, t in ms.items()) + f" [{label}]", flush=True)

    b, hq, hkv, s, d = SERVING
    q, k, v, lengths = serving_inputs(*SERVING)
    held(q, k, v, lengths, 0, 0, "the serving shape")
    mask = torch.arange(s, device=dev)[None, :] < lengths[:, None]
    timed(f"serving b{b} {hq}/{hkv} s{s} d{d}", q, k, v, lengths, 0, 0,
          cs.sdpa_fn(q[:, :, None], k, v, mask=mask[:, None, None]))
    lens, window, sinks = WINDOW
    wl = torch.tensor(lens, dtype=torch.int32, device=dev)
    held(q, k, v, wl, window, sinks, "the serving window")
    col = torch.arange(s, device=dev)[None, :]
    band = (col < wl[:, None]) & ((col >= wl[:, None] - window) | (col < sinks))
    timed(f"serving b{b} {hq}/{hkv} s{s} d{d} window {window} sinks {sinks}",
          q, k, v, wl, window, sinks,
          cs.sdpa_fn(q[:, :, None], k, v, mask=band[:, None, None]))
    b, hq, hkv, s, d = RUNG
    gen = torch.Generator(device=dev).manual_seed(21)
    q = torch.randn(b, hq, d, generator=gen, device=dev).bfloat16()
    k = torch.randn(b, hkv, s, d, generator=gen, device=dev).bfloat16()
    v = torch.randn(b, hkv, s, d, generator=gen, device=dev).bfloat16()
    full = torch.full((b,), s, dtype=torch.int32, device=dev)
    held(q, k, v, full, 0, 0, "the B 256 rung")
    timed(f"streaming rung b{b} {hq}/{hkv} s{s} d{d}", q, k, v, full, 0, 0,
          cs.sdpa_fn(q[:, :, None], k, v),
          extra={"kernel 21": lambda: st.streaming_decode(q, k, v, full)})
    for b, hq, hkv, s, d in MANY:
        q = torch.randn(b, hq, d, generator=gen, device=dev).bfloat16()
        k = torch.randn(b, hkv, s, d, generator=gen, device=dev).bfloat16()
        v = torch.randn(b, hkv, s, d, generator=gen, device=dev).bfloat16()
        full = torch.full((b,), s, dtype=torch.int32, device=dev)
        held(q, k, v, full, 0, 0, f"{s} keys at d {d}")
        timed(f"many splits b{b} {hq}/{hkv} s{s} d{d}", q, k, v, full, 0, 0,
              cs.sdpa_fn(q[:, :, None], k, v))
    return 0


if __name__ == "__main__":
    sys.exit(main())
