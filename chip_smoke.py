#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one Hopper GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ (at first use) and holds each
against its plain PyTorch version in bf16 at the shapes its path gives it,
with its bound and the time of one PyTorch library call that computes the
same function (scaled_dot_product_attention, where there is one). Then it
drives the port's main paths at full width, with random weights from a
seed:
  - serving: 32 requests through models.serving.Scheduler at the serving
    configuration of benchmarks/bench_serving.py (8 layers, d_model 2048,
    16 q heads x 128, 4 KV heads, d_ff 5504, vocab 32000, bf16, batch 8,
    max_len 2048) three times: the default mode (linear cache), the paged
    mode (page pool of 128-row pages, a shared 384-token prefix through the
    prefix cache, prefill in chunks of 256) and multi_step=4; then cached
    decoding against a full forward, over the linear and the paged cache;
  - speculative decoding at benchmarks/bench_spec.py's configuration (the
    serving model as the target, a 2-layer draft with half its d_ff):
    speculative_generate against generate with bench_spec's gates, then
    the 32 requests through Scheduler(draft_cfg=...) on the linear cache,
    on the page pool, and on the page pool with the target as its own
    draft, each against the plain greedy tokens;
  - training: 5 sgd_train_steps at the configuration of
    benchmarks/bench_train.py (the same widths, 4 layers, batch 4, seq
    4096) on batches from the native TokenLoader, then the trained params
    through save_checkpoint / restore_checkpoint and the Scheduler.
Every phase raises on failure, so the script exits non-zero if any check
fails. It needs one card and prints no result without CUDA. Its last line
is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
One more training step runs under torch.profiler: its device time by
kind of kernel and its ten largest kernels are printed.
Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
PKG = "flashattention_kernel_project_tpu_torch"

# the serving configuration of benchmarks/bench_serving.py
SERVING = dict(vocab_size=32000, d_model=2048, n_layers=8, n_heads=16,
               n_kv_heads=4, d_head=128, d_ff=5504)
# the draft of benchmarks/bench_spec.py:63-65 (2 layers, d_ff // 2), seed 1
DRAFT = dict(SERVING, n_layers=2, d_ff=SERVING["d_ff"] // 2)
SPEC_K = 4
# the training configuration of benchmarks/bench_train.py:37-41 at its
# default depth, batch and sequence length
TRAIN = dict(SERVING, n_layers=4)
TRAIN_BATCH, TRAIN_SEQ = 4, 4096
# bench_train.py times its steps at lr 1e-4, where most bf16 weight updates
# round away; 0.1 (the JAX package's own test lr) lowers the loss in 5 steps
TRAIN_LR = 0.1
LADDER = ([32, 64, 128, 256, 512], [0.35, 0.3, 0.2, 0.1, 0.05])
O_TOL = 1e-2      # rel-L2 of attention outputs (tests/test_flash_attention.py:34)
LSE_TOL = 1e-3    # rtol and atol of the LSE (tests/test_flash_attention.py:56)
# rel-L2 of cached-decode logits against a full forward. The bf16 model has
# a floor here: two evaluations that differ only in f32 summation order end
# about 1e-2 apart, because every bf16 rounding turns a tiny difference into
# a whole-ulp one and the layers compound it (ROADMAP.md, section C). 2e-2
# is two ulps of bf16: wrong positions, masks or cache rows give errors of
# order 1.
LOGITS_TOL = 2e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, device, iters: int = 10, reps: int = 5,
            graph: bool = False) -> float:
    """Median per-call milliseconds over `reps` runs of `iters` calls, from
    CUDA events on a GPU (after a warm-up call). graph=True captures the
    `iters` calls into one CUDA graph and times its replays: the device's
    time alone, where an eager loop of a kernel that runs for tens of
    microseconds measures the host's cost of issuing it."""
    import torch

    fn()
    run = lambda: [fn() for _ in range(iters)]  # noqa: E731
    if device.type == "cuda" and graph:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            run()
        run = g.replay
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / iters)
        else:
            t0 = time.perf_counter()
            run()
            times.append((time.perf_counter() - t0) * 1e3 / iters)
    return statistics.median(times)


def time_pair(kernel_fn, plain_fn, device, iters=10, graph=True):
    """Kernel and plain times measured in turns (plain, kernel, kernel,
    plain) so that both see the same clocks; by default from CUDA graphs
    (device time, see time_ms)."""
    p1 = time_ms(plain_fn, device, iters, graph=graph)
    k1 = time_ms(kernel_fn, device, iters, graph=graph)
    k2 = time_ms(kernel_fn, device, iters, graph=graph)
    p2 = time_ms(plain_fn, device, iters, graph=graph)
    return min(k1, k2), min(p1, p2)


def _rel_l2(a, b) -> float:
    from flashattention_kernel_project_tpu_torch.utils.testing import rel_l2

    return rel_l2(a.float().cpu().numpy(), b.float().cpu().numpy())


def bound(flops: float, nbytes: float) -> dict:
    """The least time the card could take for work of `flops` bf16
    operations moving `nbytes` of device memory (each input read once, each
    output written once): the larger of the two times at the H100's
    published peaks, and which of the two sets it."""
    from flashattention_kernel_project_tpu_torch.utils import platform

    t_ops = flops / platform.H100_BF16_FLOPS * 1e3
    t_bytes = nbytes / platform.H100_HBM_BYTES_PER_S * 1e3
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def visible_pairs(n: int, kv_len: int, q_offset: int, causal: bool) -> int:
    """(query, key) pairs that n queries at positions q_offset.. see among
    kv_len keys: the score and PV work an attention call must do."""
    if not causal:
        return n * kv_len
    seen = np.clip(np.arange(n) + q_offset + 1, 0, kv_len)
    return int(seen.sum())


def sdpa_fn(q, k, v, *, mask=None, causal=False):
    """A closure making one call of torch's scaled_dot_product_attention on
    the kernel's inputs: the library yardstick (library_ms), never on the
    port's path. GQA through enable_gqa; where the installed torch lacks it,
    K and V are expanded to the q heads here, before the timed call (and the
    run says so)."""
    import torch
    import torch.nn.functional as F

    try:
        F.scaled_dot_product_attention(
            torch.zeros(1, 2, 1, 8), *(torch.zeros(1, 1, 1, 8) for _ in range(2)),
            enable_gqa=True)
        kw = dict(enable_gqa=True)
    except TypeError:
        log("library: this torch lacks enable_gqa; K/V are expanded to the q "
            "heads before the timed SDPA call")
        group = q.shape[1] // k.shape[1]
        k, v = (x.repeat_interleave(group, dim=1) for x in (k, v))
        kw = {}
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  is_causal=causal, **kw)


def phase_forward(device, shapes, label):
    """The forward kernel against `_fwd_plain`, bf16, at each
    (b, hq, hkv, n, s, d, causal, q_offset); returns its JSON entry."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import flash_attention as fa
    from flashattention_kernel_project_tpu_torch.utils import oracles

    gen = torch.Generator(device=device).manual_seed(7)
    entry = dict(name="flash_fwd", route="cuda",
                 source=f"{PKG}/csrc/flash_fwd.cu",
                 replaces="flashattention_kernel_project_tpu/ops/flash_attention.py:92",
                 max_abs_err=0.0)
    for i, (b, hq, hkv, n, s, d, causal, q_offset) in enumerate(shapes):
        q = torch.randn(b, hq, n, d, generator=gen, device=device).bfloat16()
        k = torch.randn(b, hkv, s, d, generator=gen, device=device).bfloat16()
        v = torch.randn(b, hkv, s, d, generator=gen, device=device).bfloat16()
        scale = d ** -0.5
        o, lse = fa.flash_attention_with_lse(q, k, v, causal=causal,
                                             q_offset=q_offset)
        po, plse = fa._fwd_plain(q, k, v, causal, scale, q_offset)
        if device.type == "cuda":
            torch.cuda.synchronize()
        assert o.shape == q.shape and o.dtype == torch.bfloat16
        assert torch.isfinite(o).all() and torch.isfinite(lse).all()
        err = _rel_l2(o, po)
        max_abs = float((o.float() - po.float()).abs().max())
        entry["max_abs_err"] = max(entry["max_abs_err"], max_abs)
        if not err <= O_TOL:
            raise AssertionError(f"flash_fwd O rel-L2 {err:.3e} > {O_TOL}")
        torch.testing.assert_close(lse, plse, rtol=LSE_TOL, atol=LSE_TOL)
        if b * hq * n * s <= 4 * 256 * 256:
            # a small input also against the float64 numpy oracle
            exp = oracles.gqa_attention(
                *(x.float().cpu().numpy() for x in (q, k, v)),
                causal=causal, q_offset=q_offset)
            oerr = _rel_l2(o, torch.from_numpy(exp))
            if not oerr <= O_TOL:
                raise AssertionError(f"flash_fwd vs oracle rel-L2 {oerr:.3e}")
        ms, plain_ms = time_pair(
            lambda: fa.flash_attention_with_lse(q, k, v, causal=causal,
                                                q_offset=q_offset),
            lambda: fa._fwd_plain(q, k, v, causal, scale, q_offset), device)
        flops = 4 * b * hq * n * s * d * (0.5 if causal and n == s else 1.0)
        log(f"flash_fwd b{b} hq{hq} hkv{hkv} n{n} s{s} d{d} causal={causal} "
            f"q_offset={q_offset}: O rel-L2 {err:.3e}, max-abs {max_abs:.3e}, "
            f"LSE ok | kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s) "
            f"vs plain {plain_ms:.4f} ms [{label}]")
        if i == 1:  # the slice's prefill shape stands for the kernel
            assert causal and n == s and q_offset == 0
            library_ms = time_ms(sdpa_fn(q, k, v, causal=True), device, graph=True)
            work = 4 * b * hq * d * visible_pairs(n, s, q_offset, causal)
            entry.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                         **bound(work, nbytes(q, k, v, o, lse)),
                         shape=f"b{b} hq{hq} hkv{hkv} n{n} s{s} d{d} causal")
            log(f"flash_fwd at the entry's shape: bound {entry['bound_ms']:.4f}"
                f" ms ({entry['bound_by']}), SDPA {library_ms:.4f} ms")
    return entry


def phase_decode(device, b, hq, hkv, s, d, label):
    """The decode kernel against `_decode_partials_plain` through the same
    merge, bf16, ragged lengths with one slot empty and one full."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import flash_decode as fd

    gen = torch.Generator(device=device).manual_seed(11)
    q = torch.randn(b, hq, d, generator=gen, device=device).bfloat16()
    k = torch.randn(b, hkv, s, d, generator=gen, device=device).bfloat16()
    v = torch.randn(b, hkv, s, d, generator=gen, device=device).bfloat16()
    lengths = torch.randint(1, s, (b,), generator=gen, device=device,
                            dtype=torch.int32)
    lengths[0] = 0
    lengths[-1] = s
    n_splits = fd.default_n_splits(b, hkv, s)
    block_s = -(-s // n_splits)
    scale = d ** -0.5

    def plain():
        return fd.merge_partials(*fd._decode_partials_plain(
            q, k, v, lengths, n_splits, block_s, scale)).reshape(b, hq, d)

    o = fd.flash_decode(q, k, v, lengths)
    po = plain()
    if device.type == "cuda":
        torch.cuda.synchronize()
    assert o.shape == q.shape and torch.isfinite(o).all()
    assert float(o[0].float().abs().max()) == 0.0  # the empty slot
    err = _rel_l2(o, po)
    max_abs = float((o.float() - po.float()).abs().max())
    if not err <= O_TOL:
        raise AssertionError(f"flash_decode rel-L2 {err:.3e} > {O_TOL}")
    op_ms, op_plain_ms = time_pair(lambda: fd.flash_decode(q, k, v, lengths),
                                   plain, device, iters=50)
    # the kernel alone against the plain partials (no merge, no cast)
    part_args = (q, k, v, lengths, n_splits, block_s, scale)
    kernel_parts = (fd._decode_partials_cuda if device.type == "cuda"
                    else fd._decode_partials_plain)  # a CPU rehearsal
    ms, plain_ms = time_pair(lambda: kernel_parts(*part_args),
                             lambda: fd._decode_partials_plain(*part_args),
                             device, iters=50)
    live = int(lengths.sum())
    gbytes = 2 * live * hkv * d * 2 / 1e9  # K and V rows read
    # the decode's work: q, the live K/V rows and o; QK and PV per live key
    bnd = bound(4 * live * hq * d, nbytes(q, o) + 2 * live * hkv * d * 2)
    mask = (torch.arange(s, device=device)[None, :] < lengths[:, None])
    library_ms = time_ms(sdpa_fn(q[:, :, None], k, v, mask=mask[:, None, None]),
                         device, iters=50, graph=True)
    log(f"flash_decode b{b} hq{hq} hkv{hkv} s{s} d{d} n_splits={n_splits} "
        f"lengths={lengths.tolist()}: rel-L2 {err:.3e}, max-abs {max_abs:.3e} "
        f"| kernel {ms:.4f} ms ({gbytes / ms * 1e3:.1f} GB/s of live K/V) vs "
        f"plain partials {plain_ms:.4f} ms | with the merge: {op_ms:.4f} ms "
        f"vs plain {op_plain_ms:.4f} ms | bound {bnd['bound_ms']:.4f} ms "
        f"({bnd['bound_by']}), SDPA with a length mask {library_ms:.4f} ms "
        f"[{label}]")
    return dict(name="flash_decode", route="cuda",
                source=f"{PKG}/csrc/flash_decode.cu",
                replaces="flashattention_kernel_project_tpu/ops/flash_decode.py:38",
                max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, **bnd,
                shape=f"b{b} hq{hq} hkv{hkv} s{s} d{d} n_splits{n_splits}")


def phase_ragged(device, shapes, label):
    """The ragged forward kernel against `_fwd_ragged_plain`, bf16, at each
    (b, hq, hkv, t, s_max, kv_lens, q_offsets, d, causal); the first shape
    (the slice's prefill chunk) stands for the kernel. Returns its JSON
    entry."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(17)
    entry = dict(name="flash_fwd_ragged", route="cuda",
                 source=f"{PKG}/csrc/flash_fwd_ragged.cu",
                 replaces="flashattention_kernel_project_tpu/ops/flash_attention.py:1582",
                 max_abs_err=0.0)
    for i, (b, hq, hkv, t, s, lens, offs, d, causal) in enumerate(shapes):
        q = torch.randn(b, hq, t, d, generator=gen, device=device).bfloat16()
        k = torch.randn(b, hkv, s, d, generator=gen, device=device).bfloat16()
        v = torch.randn(b, hkv, s, d, generator=gen, device=device).bfloat16()
        kv_lens = torch.tensor(lens, dtype=torch.int32, device=device)
        q_offsets = torch.tensor(offs, dtype=torch.int32, device=device)
        scale = d ** -0.5
        args = (q, k, v, kv_lens, q_offsets)
        o = fa.flash_attention_ragged(*args, causal=causal)
        po = fa._fwd_ragged_plain(*args, causal, scale)
        torch.cuda.synchronize()
        assert o.shape == q.shape and o.dtype == torch.bfloat16
        assert torch.isfinite(o).all()
        for row, n_kv in enumerate(lens):
            if n_kv == 0 and float(o[row].float().abs().max()) != 0.0:
                raise AssertionError(f"ragged row {row} sees no key but is not 0")
        err = _rel_l2(o, po)
        max_abs = float((o.float() - po.float()).abs().max())
        entry["max_abs_err"] = max(entry["max_abs_err"], max_abs)
        if not err <= O_TOL:
            raise AssertionError(f"flash_fwd_ragged rel-L2 {err:.3e} > {O_TOL}")
        ms, plain_ms = time_pair(
            lambda: fa._fwd_ragged(*args, causal, scale),
            lambda: fa._fwd_ragged_plain(*args, causal, scale), device)
        # SDPA over the same cache buffers with the equivalent boolean mask
        mask = fa._ragged_mask(t, s, kv_lens, q_offsets, causal)
        library_ms = time_ms(sdpa_fn(q, k, v, mask=mask), device, graph=True)
        pairs = hq * sum(visible_pairs(t, n_kv, off, causal)
                         for n_kv, off in zip(lens, offs))
        live_kv = 2 * sum(lens) * hkv * d * q.element_size()
        bnd = bound(4 * d * pairs, nbytes(q, o, kv_lens, q_offsets) + live_kv)
        log(f"flash_fwd_ragged b{b} hq{hq} hkv{hkv} t{t} s_max{s} d{d} "
            f"kv_lens={lens} q_offsets={offs} causal={causal}: rel-L2 "
            f"{err:.3e}, max-abs {max_abs:.3e} | kernel {ms:.4f} ms "
            f"({4 * d * pairs / ms / 1e9:.1f} TFLOP/s) vs plain {plain_ms:.4f} "
            f"ms, SDPA with the mask {library_ms:.4f} ms | bound "
            f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}) [{label}]")
        if i == 0:
            entry.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms, **bnd,
                         shape=f"b{b} hq{hq} hkv{hkv} t{t} s_max{s} d{d} "
                               f"kv_lens{lens} q_offsets{offs} causal")
    return entry


def _paged_case(gen, device, b, hq, hkv, d, page, max_pages, lens):
    """A pool of b * max_pages + 1 pages with random K/V, each row's pages
    taken in order from a seeded permutation of the pool (page 0 is the
    junk page that the dead table entries name)."""
    import torch

    n_pages = b * max_pages + 1
    q = torch.randn(b, hq, d, generator=gen, device=device).bfloat16()
    k = torch.randn(n_pages, hkv, page, d, generator=gen, device=device).bfloat16()
    v = torch.randn(n_pages, hkv, page, d, generator=gen, device=device).bfloat16()
    perm = (torch.randperm(n_pages - 1, generator=gen, device=device) + 1).tolist()
    table = torch.zeros(b, max_pages, dtype=torch.int32)
    for row, n in enumerate(lens):
        used = -(-n // page)
        table[row, :used] = torch.tensor(perm[row * max_pages:row * max_pages + used])
    lengths = torch.tensor(lens, dtype=torch.int32, device=device)
    return q, k, v, table.to(device), lengths


def phase_paged_decode(device, shapes, label):
    """The paged decode kernel in both schedules (gather=False: one page a
    split; True: splits sized for occupancy) against `_paged_partials_plain`
    through the same merge, bf16, at each (b, hq, hkv, d, page, max_pages,
    lengths); the first shape (the slice's) stands for the kernel. Returns
    its JSON entry (no single PyTorch call computes a paged decode, so its
    library_ms is null)."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import flash_decode as fd
    from flashattention_kernel_project_tpu_torch.ops import paged_decode as pd

    gen = torch.Generator(device=device).manual_seed(19)
    entry = dict(name="paged_decode", route="cuda",
                 source=f"{PKG}/csrc/paged_decode.cu",
                 replaces="flashattention_kernel_project_tpu/ops/paged_decode.py:107",
                 max_abs_err=0.0, library_ms=None)
    for i, (b, hq, hkv, d, page, max_pages, lens) in enumerate(shapes):
        q, k, v, table, lengths = _paged_case(gen, device, b, hq, hkv, d, page,
                                              max_pages, lens)
        scale = d ** -0.5
        times = {}
        for gather in (False, True):
            pps = pd.gather_pages_per_split(b, hkv, max_pages) if gather else 1
            part_args = (q, k, v, table, lengths, pps, scale)
            o = pd.paged_flash_decode(q, k, v, table, lengths, gather=gather)
            po = fd.merge_partials(*pd._paged_partials_plain(*part_args))
            po = po.reshape(b, hq, d)
            torch.cuda.synchronize()
            assert o.shape == q.shape and torch.isfinite(o).all()
            for row, n in enumerate(lens):
                if n == 0 and float(o[row].float().abs().max()) != 0.0:
                    raise AssertionError(f"paged row {row} is empty but not 0")
            err = _rel_l2(o, po)
            max_abs = float((o.float() - po.float()).abs().max())
            entry["max_abs_err"] = max(entry["max_abs_err"], max_abs)
            if not err <= O_TOL:
                raise AssertionError(
                    f"paged_decode gather={gather} rel-L2 {err:.3e} > {O_TOL}")
            times[gather] = time_pair(
                lambda: pd._paged_partials_cuda(*part_args),
                lambda: pd._paged_partials_plain(*part_args), device, iters=50)
            log(f"paged_decode b{b} hq{hq} hkv{hkv} d{d} page{page} "
                f"max_pages{max_pages} lengths={lens} gather={gather} "
                f"({-(-max_pages // pps)} splits of {pps} pages): rel-L2 "
                f"{err:.3e}, max-abs {max_abs:.3e} | kernel {times[gather][0]:.4f}"
                f" ms vs plain partials {times[gather][1]:.4f} ms [{label}]")
        live = sum(lens)
        bnd = bound(4 * live * hq * d,
                    nbytes(q, o, table, lengths) + 2 * live * hkv * d * 2)
        log(f"paged_decode bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}: "
            f"q, the live K/V rows, the table and o); no single PyTorch call "
            f"computes a paged decode, so there is no library time")
        if i == 0:
            ms, plain_ms = times[True]
            entry.update(ms=ms, plain_ms=plain_ms, gather_false_ms=times[False][0],
                         **bnd, shape=f"b{b} hq{hq} hkv{hkv} d{d} page{page} "
                                      f"max_pages{max_pages} lengths{lens}")
    return entry


def phase_paged_extend(device, shapes, label):
    """The paged extend kernel (the paged speculative verify) against
    `_paged_extend_plain`, bf16, at each (b, hq, hkv, d, page, max_pages, t,
    old lengths); the first shape (the slice's verify) stands for the
    kernel, with its bound. Returns its JSON entry (no single PyTorch call
    attends over a paged cache, so its library_ms is null)."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import paged_decode as pd

    gen = torch.Generator(device=device).manual_seed(29)
    entry = dict(name="paged_extend", route="cuda",
                 source=f"{PKG}/csrc/paged_extend.cu",
                 replaces="flashattention_kernel_project_tpu/ops/paged_decode.py:397",
                 max_abs_err=0.0, library_ms=None)
    for i, (b, hq, hkv, d, page, max_pages, t, old) in enumerate(shapes):
        new = [n + t for n in old]
        _, k, v, table, new_lengths = _paged_case(gen, device, b, hq, hkv, d,
                                                  page, max_pages, new)
        q = torch.randn(b, hq, t, d, generator=gen, device=device).bfloat16()
        old_lengths = torch.tensor(old, dtype=torch.int32, device=device)
        args = (q, k, v, table, new_lengths, old_lengths, d ** -0.5)
        tiles = -(-(hq // hkv) * t // 64)
        o = pd.paged_flash_extend(q, k, v, table, new_lengths, old_lengths)
        po = pd._paged_extend_plain(*args)
        torch.cuda.synchronize()
        assert o.shape == q.shape and o.dtype == torch.bfloat16
        assert torch.isfinite(o).all()
        err = _rel_l2(o, po)
        max_abs = float((o.float() - po.float()).abs().max())
        entry["max_abs_err"] = max(entry["max_abs_err"], max_abs)
        if not err <= O_TOL:
            raise AssertionError(f"paged_extend rel-L2 {err:.3e} > {O_TOL}")
        ms, plain_ms = time_pair(lambda: pd._paged_extend_cuda(*args),
                                 lambda: pd._paged_extend_plain(*args), device,
                                 iters=50)
        # q, the live K/V rows, the table, both lengths and o; QK and PV
        # (4*d operations) per visible (row, key) pair
        pairs = hq * sum(visible_pairs(t, n, off, True)
                         for n, off in zip(new, old))
        bnd = bound(4 * d * pairs,
                    nbytes(q, o, table, new_lengths, old_lengths)
                    + 2 * sum(new) * hkv * d * q.element_size())
        log(f"paged_extend b{b} hq{hq} hkv{hkv} d{d} page{page} "
            f"max_pages{max_pages} t{t} old_lengths={old} (G*T = "
            f"{hq // hkv * t} rows: {tiles} query tile(s) of 64, the wrapper "
            f"takes it): rel-L2 {err:.3e}, max-abs {max_abs:.3e} | kernel "
            f"{ms:.4f} ms vs plain {plain_ms:.4f} ms | bound "
            f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}); no PyTorch call "
            f"attends over a paged cache, so there is no library time [{label}]")
        if i == 0:
            entry.update(ms=ms, plain_ms=plain_ms, **bnd,
                         shape=f"b{b} hq{hq} hkv{hkv} d{d} page{page} "
                               f"max_pages{max_pages} t{t} old_lengths{old}")
    return entry


def phase_backward(device, shapes, label, entry_shape):
    """The two backward kernels against `_bwd_plain`, bf16, on the same
    (o, lse) from the forward kernel, at each (b, hq, hkv, n, s, d, causal,
    q_offset); small shapes also against the float64 oracle. Returns the
    kernels' JSON entries, timed at shapes[entry_shape]."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import flash_attention as fa
    from flashattention_kernel_project_tpu_torch.utils import oracles

    gen = torch.Generator(device=device).manual_seed(13)
    src = "flashattention_kernel_project_tpu/ops/flash_attention.py"
    dkdv = dict(name="flash_bwd_dkdv", route="cuda",
                source=f"{PKG}/csrc/flash_bwd_dkdv.cu", replaces=f"{src}:1949",
                max_abs_err=0.0)
    dq_e = dict(name="flash_bwd_dq", route="cuda",
                source=f"{PKG}/csrc/flash_bwd_dq.cu", replaces=f"{src}:2203",
                max_abs_err=0.0)
    for i, (b, hq, hkv, n, s, d, causal, q_offset) in enumerate(shapes):
        q, do = (torch.randn(b, hq, n, d, generator=gen, device=device).bfloat16()
                 for _ in range(2))
        k, v = (torch.randn(b, hkv, s, d, generator=gen, device=device).bfloat16()
                for _ in range(2))
        scale = d ** -0.5
        o, lse = fa._fwd(q, k, v, causal, scale, q_offset)
        grads = fa._bwd(q, k, v, o, lse, do, causal, scale, q_offset)
        plain = fa._bwd_plain(q, k, v, o, lse, do, causal, scale, q_offset)
        torch.cuda.synchronize()
        errs = []
        for name, got, want in zip(("dq", "dk", "dv"), grads, plain):
            assert got.shape == want.shape and got.dtype == torch.bfloat16
            assert torch.isfinite(got).all(), f"{name} is not finite"
            err = _rel_l2(got, want)
            if not err <= O_TOL:
                raise AssertionError(f"backward {name} rel-L2 {err:.3e} > {O_TOL}")
            errs.append(err)
            max_abs = float((got.float() - want.float()).abs().max())
            entry = dq_e if name == "dq" else dkdv
            entry["max_abs_err"] = max(entry["max_abs_err"], max_abs)
        del plain
        oracle = ""
        if b * hq * n * s <= 16 * 1024 * 1024:
            exp = oracles.gqa_attention_grads(
                *(x.float().cpu().numpy() for x in (q, k, v, do)),
                causal=causal, q_offset=q_offset)
            oerrs = [_rel_l2(got, torch.from_numpy(want))
                     for got, want in zip(grads, exp)]
            if not max(oerrs) <= O_TOL:
                raise AssertionError(f"backward vs float64 oracle rel-L2 {oerrs}")
            oracle = " | vs float64 " + " ".join(f"{e:.2e}" for e in oerrs)
        del grads
        args = (q, k, v, do, lse, (o.float() * do.float()).sum(-1), causal,
                scale, q_offset)
        iters = 1 if b * hq * n * s > 16 * 1024 * 1024 else 10
        p1 = time_ms(lambda: fa._bwd_plain(q, k, v, o, lse, do, causal, scale,
                                           q_offset), device, iters)
        kv_ms = time_ms(lambda: fa._dkdv_cuda(*args), device, iters)
        dq_ms = time_ms(lambda: fa._dq_cuda(*args), device, iters)
        bwd_ms = time_ms(lambda: fa._bwd(q, k, v, o, lse, do, causal, scale,
                                         q_offset), device, iters)
        p2 = time_ms(lambda: fa._bwd_plain(q, k, v, o, lse, do, causal, scale,
                                           q_offset), device, iters)
        plain_ms = min(p1, p2)
        flops = 10 * b * hq * n * s * d * (0.5 if causal and n == s else 1.0)
        log(f"flash_bwd b{b} hq{hq} hkv{hkv} n{n} s{s} d{d} causal={causal} "
            f"q_offset={q_offset}: rel-L2 dq {errs[0]:.2e} dk {errs[1]:.2e} "
            f"dv {errs[2]:.2e}{oracle} | dkdv {kv_ms:.4f} ms, dq {dq_ms:.4f} "
            f"ms, _bwd with delta {bwd_ms:.4f} ms "
            f"({flops / bwd_ms / 1e9:.1f} TFLOP/s) vs plain {plain_ms:.4f} ms "
            f"[{label}]")
        if i == entry_shape:
            shape = f"b{b} hq{hq} hkv{hkv} n{n} s{s} d{d} causal={causal}"
            # the library: autograd's backward through one SDPA call, which
            # gives dq, dk and dv together (both rows carry its time)
            qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
            out = sdpa_fn(qg, kg, vg, causal=causal)()
            library_ms = time_ms(lambda: torch.autograd.grad(
                out, (qg, kg, vg), do, retain_graph=True), device, iters)
            del out, qg, kg, vg
            # dK/dV: S, dP, dV, dK; dq: S, dP, dQ (2*d operations each per
            # visible pair); each reads q, k, v, do, lse, delta
            pairs = b * hq * visible_pairs(n, s, q_offset, causal)
            reads = nbytes(q, k, v, do, lse, lse)
            dkdv.update(ms=kv_ms, plain_ms=plain_ms, library_ms=library_ms,
                        **bound(8 * d * pairs, reads + nbytes(k, v)), shape=shape)
            dq_e.update(ms=dq_ms, plain_ms=plain_ms, library_ms=library_ms,
                        **bound(6 * d * pairs, reads + nbytes(q)), shape=shape)
            log(f"flash_bwd at the entries' shape: bound dkdv "
                f"{dkdv['bound_ms']:.4f} ms ({dkdv['bound_by']}), dq "
                f"{dq_e['bound_ms']:.4f} ms ({dq_e['bound_by']}), SDPA "
                f"backward {library_ms:.4f} ms")
    return dkdv, dq_e


def motif_corpus(cfg, n_tokens=1 << 17, motif_len=512):
    """A random motif tiled (examples/train_and_serve.py's toy corpus), so
    that a few steps can lower the loss."""
    motif = np.random.default_rng(0).integers(0, cfg.vocab_size, motif_len)
    return np.resize(motif, n_tokens).astype(np.uint32)


def phase_train(device, cfg, params, corpus, batch, seq, lr, steps, label):
    """bench_train.py's training loop in the port: a seeded token file
    streamed through the native TokenLoader, one warm-up and `steps` timed
    sgd_train_steps. Every loss finite, the first within 1.0 of
    ln(vocab), a fixed held-out batch's loss lower after the steps, and
    (on a GPU) the forward and both backward kernels launched; then one
    step profiled. Returns the trained params and the kernels' launch
    counts."""
    import shutil
    import tempfile

    import torch

    from flashattention_kernel_project_tpu_torch.models import transformer as tfm
    from flashattention_kernel_project_tpu_torch.ops import flash_attention as fa
    from flashattention_kernel_project_tpu_torch.runtime.data import (
        TokenLoader,
        write_token_file,
    )

    tmp = tempfile.mkdtemp(prefix="fkp_smoke_")
    try:
        path = os.path.join(tmp, "tokens.bin")
        write_token_file(path, corpus)
        starts = np.random.default_rng(1).integers(0, len(corpus) - seq, batch)
        held = torch.from_numpy(np.stack([corpus[i:i + seq] for i in starts])
                                .astype(np.int32)).to(device)
        with torch.no_grad():
            held0 = float(tfm.loss_fn(cfg, params, held))
        with TokenLoader(path, batch, seq, seed=0, native=True) as loader:
            def tokens():
                return torch.from_numpy(
                    loader.next_batch()[:, :-1].astype(np.int32)).to(device)

            params, loss = tfm.sgd_train_step(cfg, params, tokens(), lr)  # warm-up
            losses = [float(loss)]
            if not abs(losses[0] - np.log(cfg.vocab_size)) < 1.0:
                raise AssertionError(f"step-0 loss {losses[0]:.4f} is not within"
                                     f" 1.0 of ln({cfg.vocab_size})")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fa._fwd.launches = 0
            fa._bwd.launches = 0
            times = []
            for _ in range(steps):
                toks = tokens()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                params, loss = tfm.sgd_train_step(cfg, params, toks, lr)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
                losses.append(float(loss))
            launches = dict(flash_fwd=fa._fwd.launches,
                            flash_bwd=fa._bwd.launches)
            peak = torch.cuda.max_memory_allocated()
            profile_step(cfg, params, tokens(), lr, label)
        with torch.no_grad():
            held1 = float(tfm.loss_fn(cfg, params, held))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not held1 < held0:
        raise AssertionError(f"held-out loss did not fall: {held0} -> {held1}")
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    n_params = sum(x.numel() for x in tfm._leaves(params).values())
    ms = statistics.median(times)
    tok = batch * seq
    log(f"train: {cfg.n_layers} layers x d_model {cfg.d_model}, batch {batch}"
        f" x seq {seq}, SGD lr {lr}: losses " + " ".join(f"{x:.4f}" for x in losses)
        + f" | held-out {held0:.4f} -> {held1:.4f}")
    log(f"train: {ms:.2f} ms/step (median of {steps}; "
        + " ".join(f"{t:.2f}" for t in times) + f"), {tok / ms * 1e3:.0f} tok/s, "
        f"{6 * n_params * tok / ms / 1e9:.1f} TFLOP/s (6 x {n_params} params "
        f"x tokens), peak {peak / 2**30:.2f} GiB | launches {launches} [{label}]")
    return params, launches


def profile_step(cfg, params, tokens, lr, label):
    """One more training step under torch.profiler: device time by kind of
    kernel, and the largest kernels by name, printed."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from flashattention_kernel_project_tpu_torch.models import transformer as tfm

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tfm.sgd_train_step(cfg, params, tokens, lr)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    kinds, by_name = {}, {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        name = e.key
        ours = re.search(r"flash_\w+_kernel", name)  # this repo's kernels
        if ours:
            kind = ours.group(0)
        elif "sgemm" in name or "gemm_f32" in name:
            kind = "f32 GEMM (lm_head)"
        elif "gemm" in name or "nvjet" in name:
            kind = "bf16 GEMM"
        elif "SoftMax" in name:
            kind = "softmax (cross-entropy)"
        else:
            kind = "elementwise, copies, reductions"
        ms = e.self_device_time_total / 1e3
        kinds[kind] = kinds.get(kind, 0.0) + ms
        by_name[name[:70]] = by_name.get(name[:70], 0.0) + ms
    total = sum(kinds.values())
    log(f"train profile, one step: {total:.2f} ms of device time in "
        f"{wall:.2f} ms of wall (profiled) | " + ", ".join(
            f"{k} {v:.2f} ms ({100 * v / total:.1f}%)"
            for k, v in sorted(kinds.items(), key=lambda kv: -kv[1]))
        + f" [{label}]")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        log(f"train profile: {ms:8.2f} ms  {name}")


def phase_checkpoint(device, cfg, params, corpus, label):
    """save_checkpoint the trained params, restore them bit for bit, and
    serve 4 requests of 32 new tokens from the restored params."""
    import shutil
    import tempfile

    import torch

    from flashattention_kernel_project_tpu_torch.models.checkpoint import (
        restore_checkpoint,
        save_checkpoint,
    )
    from flashattention_kernel_project_tpu_torch.models.serving import Scheduler
    from flashattention_kernel_project_tpu_torch.models.transformer import _leaves

    tmp = tempfile.mkdtemp(prefix="fkp_ckpt_")
    try:
        t0 = time.perf_counter()
        path = save_checkpoint(os.path.join(tmp, "ck"), params, step=6,
                               config=cfg)
        state = restore_checkpoint(path, params_template=params)
        io_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    restored = _leaves(state["params"])
    for name, x in _leaves(params).items():
        y = restored[name]
        if y.dtype != x.dtype or y.device != x.device or not torch.equal(x, y):
            raise AssertionError(f"checkpoint leaf {name} differs after restore")
    if state["step"] != 6 or state["config"]["dtype"] != "bfloat16":
        raise AssertionError(f"checkpoint meta {state['step']} {state['config']}")
    sched = Scheduler(cfg, state["params"], max_batch=4, max_len=256)
    prompts = [corpus[i * 700:i * 700 + n].astype(np.int32)
               for i, n in enumerate((32, 48, 64, 100))]
    uids = [sched.submit(p, max_new_tokens=32) for p in prompts]
    out = sched.run()
    torch.cuda.synchronize()
    for u in uids:
        if len(out[u]) != 32 or not all(0 <= t < cfg.vocab_size for t in out[u]):
            raise AssertionError(f"request {u} returned {out[u]}")
    log(f"checkpoint: {len(restored)} leaves saved and restored bit-equal in "
        f"{io_s:.2f} s; 4 requests x 32 tokens served from the restored "
        f"params at {sched.metrics().tok_per_s:.1f} tok/s [{label}]")


def serving_prompts(cfg, n_requests, ladder=LADDER):
    """bench_serving.py's prompt mix at seed 0."""
    rng = np.random.default_rng(0)
    lens = rng.choice(ladder[0], size=n_requests, p=ladder[1])
    return [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32)
            for n in lens]


def _counters():
    """The launch counters of every kernel wrapper, by kernel name."""
    from flashattention_kernel_project_tpu_torch.ops import flash_attention as fa
    from flashattention_kernel_project_tpu_torch.ops import flash_decode as fd
    from flashattention_kernel_project_tpu_torch.ops import paged_decode as pd

    return dict(flash_fwd=fa._fwd, flash_fwd_ragged=fa.flash_attention_ragged,
                flash_decode=fd.flash_decode, paged_decode=pd.paged_flash_decode,
                paged_extend=pd.paged_flash_extend, flash_bwd=fa._bwd)


def serve(device, cfg, params, prompts, max_new, kernels, label, tag, **kw):
    """Serve `prompts` through Scheduler(**kw) after a warm-up run on a
    throwaway scheduler, with every launch counter set to 0 just before.
    Every request must return max_new in-vocab tokens, and (on a GPU) each
    kernel named in `kernels` must have launched. Returns (scheduler,
    tokens in submission order, launches by kernel)."""
    import torch

    from flashattention_kernel_project_tpu_torch.models.serving import Scheduler

    # warm-up on a throwaway scheduler: allocator, cuBLAS handles
    warm = Scheduler(cfg, params, **kw)
    warm.submit(prompts[0][:8], max_new_tokens=4)
    warm.run()
    del warm
    if device.type == "cuda":
        torch.cuda.synchronize()

    sched = Scheduler(cfg, params, **kw)
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    uids = [sched.submit(p, max_new_tokens=max_new) for p in prompts]
    out = sched.run()
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    for u in uids:
        if len(out[u]) != max_new:
            raise AssertionError(f"request {u} returned {len(out[u])} tokens")
        if not all(0 <= t < cfg.vocab_size for t in out[u]):
            raise AssertionError(f"request {u} returned out-of-vocab tokens")
    if device.type == "cuda" and not all(launches[k] for k in kernels):
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    m = sched.metrics()
    opts = ", ".join(  # a draft's config by its depth and width, not its params
        f"{k}={v.n_layers} layers d_ff {v.d_ff}" if k == "draft_cfg" else f"{k}={v}"
        for k, v in kw.items() if k != "draft_params")
    log(f"{tag}: {len(prompts)} requests x {max_new} new tokens, {opts}, "
        f"prompt lengths {sorted(len(p) for p in prompts)}")
    log(f"{tag}: {m.tokens} tokens in {m.wall_s:.3f} s = {m.tok_per_s:.1f} "
        f"tok/s | TTFT mean {m.ttft_s_mean * 1e3:.1f} ms p95 "
        f"{m.ttft_s_p95 * 1e3:.1f} ms | latency mean "
        f"{m.latency_s_mean * 1e3:.1f} ms p95 {m.latency_s_p95 * 1e3:.1f} ms"
        f" | kernel launches {launches} [{label}]")
    return sched, [out[u] for u in uids], launches


def phase_slice(device, cfg, params, prompts, max_batch, max_len, max_new,
                label):
    """The default Scheduler (linear cache, bucketed prefill): the forward
    and the linear decode kernel must have launched."""
    return serve(device, cfg, params, prompts, max_new,
                 ("flash_fwd", "flash_decode"), label, "slice",
                 max_batch=max_batch, max_len=max_len)


def phase_paged_slice(device, cfg, params, prompts, max_batch, max_len,
                      max_new, linear, label):
    """The paged, prefix-cached, chunked Scheduler: the ragged forward and
    the paged decode must have launched and the linear decode not; some
    inserts must have reused the shared prefix's pages; after the run every
    page is back in the pool and the prefix index is empty. `linear` is the
    default Scheduler's metrics from the same run, printed beside."""
    sched, tokens, launches = serve(
        device, cfg, params, prompts, max_new,
        ("flash_fwd_ragged", "paged_decode"), label, "paged slice",
        max_batch=max_batch, max_len=max_len, paged=True, page_size=128,
        prefix_cache=True, prefill_chunk=256)
    if device.type == "cuda" and launches["flash_decode"]:
        raise AssertionError(f"the paged path ran the linear decode: {launches}")
    if not sched.prefix_hits > 0:
        raise AssertionError("no insert reused the shared prefix's pages")
    if sched._pool.free_pages != sched._n_pages - 1:
        raise AssertionError(f"{sched._pool.free_pages} of {sched._n_pages - 1}"
                             " pages back in the pool")
    if sched._prefix_index or sched._page_refs:
        raise AssertionError("prefix index or page references left over")
    m = sched.metrics()
    log(f"paged slice: {sched.prefix_hits} of {len(prompts)} inserts reused "
        f"the shared prefix's pages; pool fully recycled "
        f"({sched._pool.free_pages} free of {sched._n_pages}, page 0 junk)")
    log(f"paged slice vs linear slice (same run): {m.tok_per_s:.1f} vs "
        f"{linear.tok_per_s:.1f} tok/s | TTFT mean {m.ttft_s_mean * 1e3:.1f} vs"
        f" {linear.ttft_s_mean * 1e3:.1f} ms, p95 {m.ttft_s_p95 * 1e3:.1f} vs "
        f"{linear.ttft_s_p95 * 1e3:.1f} ms | latency mean "
        f"{m.latency_s_mean * 1e3:.1f} vs {linear.latency_s_mean * 1e3:.1f} ms,"
        f" p95 {m.latency_s_p95 * 1e3:.1f} vs {linear.latency_s_p95 * 1e3:.1f}"
        f" ms [{label}]")
    return launches


def phase_multi_step(device, cfg, params, prompts, max_batch, max_len, max_new,
                     single, label):
    """The linear Scheduler with 4 decode steps a round on the serving
    prompts; the fraction of its greedy tokens equal to the multi_step=1
    run's (`single`, in submission order) is printed."""
    sched, tokens, launches = serve(
        device, cfg, params, prompts, max_new, ("flash_fwd", "flash_decode"),
        label, "multi_step slice", max_batch=max_batch, max_len=max_len,
        multi_step=4)
    same = np.mean([a == b for x, y in zip(tokens, single)
                    for a, b in zip(x, y)])
    log(f"multi_step slice: {sched.metrics().tok_per_s:.1f} tok/s; greedy "
        f"tokens equal to the multi_step=1 run: {same:.4f} [{label}]")
    return launches


class NearTie:
    """bench_spec.py:119-175's near-tie audit for one model: a divergence
    between two greedy streams at position t is allowed only where the
    model's own top-2 logits after the common prefix lie within
    max(8 eps, 1e-3), eps being the largest logit difference between two
    evaluations of one prefix (fresh prefill vs prefill + one decode
    step)."""

    def __init__(self, cfg, params, prefix):
        from flashattention_kernel_project_tpu_torch.models import engine

        self.cfg, self.params = cfg, params
        full = self.last_logits(prefix)
        cache = engine.init_cache(cfg, 1, len(prefix) + 1, params["embed"].device)
        engine.prefill(cfg, params, self._tokens(prefix[:-1]), cache)
        step, _ = engine.decode_step(cfg, engine.fuse_decode_params(cfg, params),
                                     self._tokens(prefix[-1:])[0], cache)
        self.eps = float((full - step[0]).abs().max())
        self.bound = max(8.0 * self.eps, 1e-3)

    def _tokens(self, seq):
        import torch

        return torch.as_tensor(np.asarray(seq, np.int32)[None],
                               device=self.params["embed"].device)

    def last_logits(self, prefix):
        """[V] f32 logits after `prefix`, from a fresh prefill."""
        from flashattention_kernel_project_tpu_torch.models import engine

        cache = engine.init_cache(self.cfg, 1, len(prefix) + 1,
                                  self.params["embed"].device)
        logits, _ = engine.prefill(self.cfg, self.params, self._tokens(prefix),
                                   cache)
        return logits[0]

    def gap(self, prefix) -> float:
        top2 = self.last_logits(prefix).topk(2).values
        return float(top2[0] - top2[1])

    def audit(self, streams, refs, prefixes, what):
        """For each pair of token streams, the agreement window (the first
        divergence, or the stream's length) and the top1-top2 gap there;
        raises if a gap exceeds the bound. Returns (windows, gaps)."""
        windows, gaps = [], []
        for got, want, prefix in zip(streams, refs, prefixes):
            diff = [j for j, (a, b) in enumerate(zip(got, want)) if a != b]
            windows.append(diff[0] if diff else len(want))
            if diff:
                gaps.append(self.gap(list(prefix) + list(want[:diff[0]])))
        big = [g for g in gaps if g > self.bound]
        if big:
            raise AssertionError(
                f"{what}: divergence at a non-near-tie site: top1-top2 gaps "
                f"{big} exceed {self.bound:.2e} (8 x eps {self.eps:.2e})")
        return windows, gaps


def phase_spec_generate(device, cfg, params, draft_cfg, draft_params, batch,
                        prompt_len, max_new, label):
    """bench_spec.py in the port: speculative_generate (spec_k 4) and
    generate on `batch` seeded prompts, one warm-up each, then its gates:
    the first 16 tokens of every row equal (bench_spec.py:98-117), and the
    near-tie audit at every row's first divergence. The forward, the ragged
    forward (the verify) and the linear decode (the draft) must launch."""
    import torch

    from flashattention_kernel_project_tpu_torch.models import engine

    gen = torch.Generator(device=device).manual_seed(2)
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=gen,
                           device=device, dtype=torch.int32)
    counters = _counters()

    def timed(fn):
        fn()  # warm-up
        torch.cuda.synchronize()
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (out.cpu().numpy(), time.perf_counter() - t0,
                {name: c.launches for name, c in counters.items()})

    plain, dt_plain, _ = timed(lambda: engine.generate(
        cfg, params, prompt, max_new_tokens=max_new))
    spec, dt_spec, launches = timed(lambda: engine.speculative_generate(
        cfg, params, prompt, draft_cfg=draft_cfg, draft_params=draft_params,
        spec_k=SPEC_K, max_new_tokens=max_new))
    if device.type == "cuda" and not all(
            launches[k] for k in ("flash_fwd", "flash_fwd_ragged", "flash_decode")):
        raise AssertionError(f"a kernel of the spec path never launched: {launches}")
    assert spec.shape == plain.shape == (batch, prompt_len + max_new)
    if not ((spec >= 0) & (spec < cfg.vocab_size)).all():
        raise AssertionError("speculative_generate returned out-of-vocab tokens")
    agree = 0  # bench_spec.py's window: leading columns equal in every row
    for a, b in zip(plain.T, spec.T):
        if not (a == b).all():
            break
        agree += 1
    if agree < min(16, plain.shape[1]):
        raise AssertionError(f"speculative tokens diverged at column {agree}")
    tie = NearTie(cfg, params, plain[0, :prompt_len + 1])
    windows, gaps = tie.audit(spec[:, prompt_len:], plain[:, prompt_len:],
                              plain[:, :prompt_len], "speculative_generate")
    rounds = launches["flash_fwd_ragged"] // cfg.n_layers
    toks = batch * max_new
    log(f"spec generate: batch {batch} x prompt {prompt_len} + {max_new} new, "
        f"draft {draft_cfg.n_layers} layers d_ff {draft_cfg.d_ff}, spec_k "
        f"{SPEC_K}: plain {toks / dt_plain:.1f} tok/s, spec "
        f"{toks / dt_spec:.1f} tok/s | greedy-agree {agree}/{plain.shape[1]} "
        f"columns; generated tokens equal to plain up to {windows} per row | "
        f"{rounds} verify rounds: {(max_new - 1) / max(rounds, 1):.3f} "
        f"committed tokens per round (the slowest row) | near-tie eps "
        f"{tie.eps:.2e}, bound {tie.bound:.2e}, gaps at divergences "
        f"{[f'{g:.2e}' for g in gaps]} | launches {launches} [{label}]")
    return tie


def phase_spec_slice(device, cfg, params, draft_cfg, draft_params, prompts,
                     max_batch, max_len, max_new, single, linear, tie, label):
    """The 32 serving requests through the speculative Scheduler (spec_k 4)
    three ways: (i) the draft on the linear cache, (ii) on the page pool,
    (iii) the page pool with the target as its own draft, where every draft
    should be accepted. (i) must launch the ragged forward and the linear
    decode, (ii) and (iii) the paged extend and not the paged decode; the
    pools end fully recycled. Greedy tokens against `single` (the plain
    run): every first divergence must pass the near-tie audit. (iii) must
    commit more than 2 tokens per slot and verify round. Returns (ii)'s
    launches."""
    runs = (("spec slice (linear)", draft_cfg, draft_params, {},
             ("flash_fwd", "flash_fwd_ragged", "flash_decode")),
            ("spec slice (paged)", draft_cfg, draft_params,
             dict(paged=True, page_size=128), ("flash_fwd", "paged_extend")),
            ("spec slice (paged, draft = target)", cfg, params,
             dict(paged=True, page_size=128), ("flash_fwd", "paged_extend")))
    out = {}
    for tag, dcfg, dparams, kw, kernels in runs:
        sched, tokens, launches = serve(
            device, cfg, params, prompts, max_new, kernels, label, tag,
            max_batch=max_batch, max_len=max_len, draft_cfg=dcfg,
            draft_params=dparams, spec_k=SPEC_K, **kw)
        if kw.get("paged"):
            if device.type == "cuda" and launches["paged_decode"]:
                raise AssertionError(f"{tag} ran the paged decode: {launches}")
            if sched._pool.free_pages != sched._n_pages - 1:
                raise AssertionError(f"{tag}: {sched._pool.free_pages} of "
                                     f"{sched._n_pages - 1} pages back")
        windows, gaps = tie.audit(tokens, single, prompts, tag)
        same = np.mean([a == b for x, y in zip(tokens, single)
                        for a, b in zip(x, y)])
        per_round = sched.spec_committed / max(sched.spec_slot_rounds, 1)
        m = sched.metrics()
        log(f"{tag}: greedy tokens equal to the plain run {same:.4f}; "
            f"agreement windows {windows}; gaps at divergences "
            f"{[f'{g:.2e}' for g in gaps]} (bound {tie.bound:.2e}) | "
            f"{per_round:.3f} committed tokens per slot per verify round "
            f"({sched.spec_committed} over {sched.spec_slot_rounds} "
            f"slot-rounds) | vs the plain slice (same run): {m.tok_per_s:.1f} "
            f"vs {linear.tok_per_s:.1f} tok/s, TTFT mean "
            f"{m.ttft_s_mean * 1e3:.1f} vs {linear.ttft_s_mean * 1e3:.1f} ms, "
            f"latency mean {m.latency_s_mean * 1e3:.1f} vs "
            f"{linear.latency_s_mean * 1e3:.1f} ms [{label}]")
        out[tag] = (launches, per_round)
    _, per_round = out["spec slice (paged, draft = target)"]
    if not 2.0 < per_round <= SPEC_K + 1:
        raise AssertionError(f"draft = target committed {per_round:.3f} tokens "
                             "per slot and round, not above 2")
    return out["spec slice (paged)"][0]


def device_ms_by_kind(prof) -> dict:
    """Device milliseconds of a torch.profiler window by kind of kernel:
    this repo's attention kernels by name (the forward core's flavours
    0, 1, 2 as flash_fwd, flash_fwd_ragged, paged_extend), the GEMMs, the
    cache appends and the rest."""
    from torch.autograd import DeviceType

    flavours = {"0": "flash_fwd", "1": "flash_fwd_ragged", "2": "paged_extend"}
    kinds = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        key = e.key
        fwd = re.search(r"flash_fwd_kernel<\d+, (\d)>", key)
        ours = re.search(r"(paged|flash)_decode_kernel", key)
        if fwd:
            kind = flavours[fwd.group(1)]
        elif ours:
            kind = ours.group(0)
        elif "sgemm" in key or "gemm_f32" in key:
            kind = "f32 GEMM (lm_head)"
        elif "gemm" in key or "nvjet" in key:
            kind = "bf16 GEMM"
        elif "index" in key or "scatter" in key:
            kind = "cache append (index_put)"
        else:
            kind = "elementwise, copies, reductions"
        kinds[kind] = kinds.get(kind, 0.0) + e.self_device_time_total / 1e3
    return kinds


def profile_decode_steps(device, cfg, params, label, batch=8, length=600,
                         steps=20, window=5):
    """Where a decode step's time goes, the linear cache against the paged
    one, at the serving batch (`batch` slots of `length` tokens): host
    milliseconds a step with one host sync a step (the Scheduler's pattern),
    then `window` steps under torch.profiler: device time by kind and the
    device's busy share of the window's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from flashattention_kernel_project_tpu_torch.models import engine

    dec = engine.fuse_decode_params(cfg, params)
    pages = -(-(length + steps + window + 1) // 128)
    linear = engine.init_cache(cfg, batch, 2048, device)
    paged = engine.init_paged_cache(cfg, batch, batch * pages + 1, device,
                                    page_size=128, max_pages_per_seq=pages)
    paged.block_tables.copy_(torch.arange(1, batch * pages + 1, device=device,
                                          dtype=torch.int32).view(batch, pages))
    for cache in (linear, paged):
        cache.lengths.fill_(length)
    tok = torch.zeros(batch, dtype=torch.int32, device=device)
    for name, step, cache in (
            ("linear", engine.decode_step, linear),
            ("paged", engine.decode_step_paged, paged)):
        step(cfg, dec, tok, cache)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, _ = step(cfg, dec, tok, cache)
            logits.argmax(-1).cpu()
        host_ms = (time.perf_counter() - t0) * 1e3 / steps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(window):
                logits, _ = step(cfg, dec, tok, cache)
                logits.argmax(-1).cpu()
            wall = (time.perf_counter() - t0) * 1e3
        kinds = device_ms_by_kind(prof)
        busy = sum(kinds.values())
        log(f"{name} decode step (B={batch}, lengths {length}): {host_ms:.3f} ms"
            f" a step on the host clock; profiled {window} steps: {busy / window:.3f}"
            f" ms of device time a step, busy {100 * busy / wall:.1f}% of "
            f"{wall / window:.3f} ms | " + ", ".join(
                f"{k} {v / window:.3f} ms ({100 * v / busy:.1f}%)"
                for k, v in sorted(kinds.items(), key=lambda kv: -kv[1]))
            + f" [{label}]")


def profile_spec_round(device, cfg, params, draft_cfg, draft_params, label,
                       batch=8, length=600, rounds=10, window=3):
    """Where a speculative round's time goes on the page pool: `batch`
    requests of `length` prompt tokens in the paged speculative Scheduler;
    host milliseconds a round (each ends in the host's accept), then
    `window` rounds under torch.profiler: device time by kind and the
    device's busy share of the window's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from flashattention_kernel_project_tpu_torch.models.serving import Scheduler

    sched = Scheduler(cfg, params, max_batch=batch, max_len=2048, paged=True,
                      page_size=128, draft_cfg=draft_cfg,
                      draft_params=draft_params, spec_k=SPEC_K)
    rng = np.random.default_rng(3)
    for _ in range(batch):  # a budget no round can spend
        sched.submit(rng.integers(0, cfg.vocab_size, length).astype(np.int32),
                     max_new_tokens=(SPEC_K + 1) * (rounds + window + 2))
    sched._fill_slots()
    sched._decode_once()  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(rounds):
        sched._decode_once()
    host_ms = (time.perf_counter() - t0) * 1e3 / rounds
    committed = sched.spec_committed
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(window):
            sched._decode_once()
        wall = (time.perf_counter() - t0) * 1e3
    committed = (sched.spec_committed - committed) / (batch * window)
    kinds = device_ms_by_kind(prof)
    busy = sum(kinds.values())
    log(f"paged spec round (B={batch}, prompts {length}, spec_k {SPEC_K}, draft "
        f"{draft_cfg.n_layers} layers): {host_ms:.3f} ms a round on the host "
        f"clock; profiled {window} rounds ({committed:.2f} tokens a slot a "
        f"round): {busy / window:.3f} ms of device time a round, busy "
        f"{100 * busy / wall:.1f}% of {wall / window:.3f} ms | " + ", ".join(
            f"{k} {v / window:.3f} ms ({100 * v / busy:.1f}%)"
            for k, v in sorted(kinds.items(), key=lambda kv: -kv[1]))
        + f" [{label}]")


def phase_paged_consistency(device, cfg, params, n_prompt, n_shared, chunk,
                            n_steps, label):
    """Two prompts of n_prompt tokens, the second sharing the first's
    n_shared-token prefix. The first is prefilled through `extend` chunks
    into a batch-1 cache and paged_insert'ed; the second is built from
    cache_from_pages of the shared pages plus an `extend` of its suffix.
    Then n_steps greedy decode_step_paged steps of both; every step's
    logits against a full forward over the same tokens."""
    import torch

    from flashattention_kernel_project_tpu_torch.models import engine
    from flashattention_kernel_project_tpu_torch.models import transformer as tfm

    page = 128
    gen = torch.Generator(device=device).manual_seed(23)
    prompts = torch.randint(0, cfg.vocab_size, (2, n_prompt), generator=gen,
                            device=device, dtype=torch.int32)
    prompts[1, :n_shared] = prompts[0, :n_shared]
    max_pages = -(-(n_prompt + n_steps) // page)
    cache = engine.init_paged_cache(cfg, 2, 2 * max_pages + 1, device,
                                    page_size=page, max_pages_per_seq=max_pages)
    shared = list(range(1, n_shared // page + 1))
    rows = [list(range(1, max_pages + 1)),
            shared + list(range(max_pages + 1, 2 * max_pages + 1 - len(shared)))]

    def extend_from(cache1, seq, start):
        for j0 in range(start, n_prompt, chunk):
            nj = min(chunk, n_prompt - j0)
            part = torch.zeros(1, chunk, dtype=torch.int32, device=device)
            part[0, :nj] = prompts[seq, j0:j0 + nj]
            n = torch.full((1,), nj, dtype=torch.int32, device=device)
            logits, cache1 = engine.extend(cfg, params, part, cache1, n=n)
        return logits, cache1

    first = []
    for seq in range(2):
        if seq == 0:
            cache1 = engine.init_cache(cfg, 1, n_prompt + chunk, device)
            logits, cache1 = extend_from(cache1, seq, 0)
        else:
            cache1 = engine.cache_from_pages(cfg, cache, shared, n_shared,
                                             n_prompt + chunk)
            logits, cache1 = extend_from(cache1, seq, n_shared)
        first.append(logits[0])
        engine.paged_insert(cache, seq, rows[seq],
                            [x[0, :, :n_prompt] for x in cache1.k],
                            [x[0, :, :n_prompt] for x in cache1.v], n_prompt,
                            start_page=0 if seq == 0 else len(shared))
    dec = engine.fuse_decode_params(cfg, params)
    steps = [torch.stack(first)]
    toks = [steps[0].argmax(-1).to(torch.int32)]
    for _ in range(n_steps):
        logits, cache = engine.decode_step_paged(cfg, dec, toks[-1], cache)
        steps.append(logits)
        toks.append(logits.argmax(-1).to(torch.int32))
    seq_all = torch.cat([prompts, torch.stack(toks[:-1], dim=1)], dim=1)
    full = tfm.forward(cfg, params, seq_all)[:, n_prompt - 1:]
    cached = torch.stack(steps, dim=1)
    assert cached.shape == full.shape and torch.isfinite(cached).all()
    errs = [[_rel_l2(cached[s, i], full[s, i]) for i in range(n_steps + 1)]
            for s in range(2)]
    log(f"paged consistency: 2 prompts of {n_prompt} (the second sharing "
        f"{n_shared} tokens = {len(shared)} pages through cache_from_pages), "
        f"extend chunks of {chunk} + {n_steps} decode_step_paged steps vs "
        f"forward: logits rel-L2 max {max(map(max, errs)):.3e} (first prompt "
        f"{max(errs[0]):.3e}, prefix path {max(errs[1]):.3e}) [{label}]")
    if not max(map(max, errs)) <= LOGITS_TOL:
        raise AssertionError(f"paged decode logits rel-L2 "
                             f"{max(map(max, errs)):.3e} > {LOGITS_TOL}")


def phase_consistency(device, cfg, params, n_prompt, n_steps, label):
    """prefill + n_steps greedy decode_steps for 2 prompts; each step's
    logits against a full forward over the same tokens."""
    import torch

    from flashattention_kernel_project_tpu_torch.models import engine
    from flashattention_kernel_project_tpu_torch.models import transformer as tfm

    gen = torch.Generator(device=device).manual_seed(5)
    prompt = torch.randint(0, cfg.vocab_size, (2, n_prompt), generator=gen,
                           device=device, dtype=torch.int32)
    cache = engine.init_cache(cfg, 2, n_prompt + n_steps + 1, device)
    logits, cache = engine.prefill(cfg, params, prompt, cache)
    dec = engine.fuse_decode_params(cfg, params)
    steps = [logits]
    toks = [logits.argmax(-1).to(torch.int32)]
    for _ in range(n_steps):
        logits, cache = engine.decode_step(cfg, dec, toks[-1], cache)
        steps.append(logits)
        toks.append(logits.argmax(-1).to(torch.int32))
    seq = torch.cat([prompt, torch.stack(toks[:-1], dim=1)], dim=1)
    full = tfm.forward(cfg, params, seq)[:, n_prompt - 1:]  # [2, steps+1, V]
    cached = torch.stack(steps, dim=1)
    assert cached.shape == full.shape and torch.isfinite(cached).all()
    errs = [_rel_l2(cached[:, i], full[:, i]) for i in range(n_steps + 1)]
    same = (cached.argmax(-1) == full.argmax(-1)).float().mean().item()
    log(f"consistency: prefill + {n_steps} decode steps vs forward, 2 prompts "
        f"of {n_prompt}: logits rel-L2 max {max(errs):.3e} mean "
        f"{sum(errs) / len(errs):.3e}, equal greedy tokens {same:.3f} [{label}]")
    log("consistency: rel-L2 per step " + " ".join(f"{e:.2e}" for e in errs))
    if not max(errs) <= LOGITS_TOL:
        raise AssertionError(f"decode logits rel-L2 {max(errs):.3e} > {LOGITS_TOL}")


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, PKG)):
        print(f"{PKG}/ not found beside chip_smoke.py: run it from a checkout "
              "of the repository", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs on a Hopper GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from flashattention_kernel_project_tpu_torch.models import transformer as tfm
    from flashattention_kernel_project_tpu_torch.ops import _build
    from flashattention_kernel_project_tpu_torch.utils import platform

    # 1. device
    name = platform.require_hopper()
    label = platform.card_label()
    log(f"device: {name}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(label)
    device = torch.device("cuda", 0)

    # 2. kernels against their plain versions
    t0 = time.perf_counter()
    _build.library()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s from "
        f"{[os.path.relpath(s, ROOT) for s in _build.kernel_sources()]}")
    with open(os.path.join(_build.BUILD_DIR, "libfkp_kernels.so.log")) as f:
        kernel = ""  # the mangled name of the entry ptxas reports on
        for line in f:
            entry = re.search(r"Compiling entry function '.*?([a-z_]+_kernel)"
                              r"(?:I((?:Li\d+E)+))?", line)
            if entry:  # e.g. flash_fwd_kernel<128,2>
                args = re.findall(r"\d+", entry.group(2) or "")
                kernel = entry.group(1) + (f"<{','.join(args)}>" if args else "")
            if "registers" in line or "spill" in line:
                log(f"ptxas: {kernel}: " + line.split(":", 1)[-1].strip())
    fwd = phase_forward(device, [
        (1, 16, 4, 4096, 4096, 128, True, 0),  # bench.py's shape
        (1, 16, 4, 512, 512, 128, True, 0),    # the slice's longest prefill
        (1, 16, 4, 1024, 1024, 64, True, 0),   # d=64
        (2, 4, 2, 200, 333, 128, False, 0),    # ragged, non-causal
        (2, 4, 2, 200, 333, 128, True, 133),   # ragged, causal, q_offset
    ], label)
    dec = phase_decode(device, 8, 16, 4, 2048, 128, label)
    ragged = phase_ragged(device, [
        # the third chunk of a 768-token prompt at chunk 256 (the slice's)
        (1, 16, 4, 256, 2304, [768], [512], 128, True),
        # per-row raggedness and an empty row
        (4, 16, 4, 64, 1024, [64, 300, 1000, 0], [0, 236, 936, 0], 128, True),
        (2, 4, 2, 200, 512, [333, 512], [133, 312], 64, True),
        (4, 16, 4, 64, 1024, [64, 300, 1000, 0], [0, 236, 936, 0], 128, False),
    ], label)
    paged = phase_paged_decode(device, [
        # the slice's pool: 16 pages of 128 a slot, 129 pages
        (8, 16, 4, 128, 128, 16, [1, 127, 128, 129, 700, 1500, 2048, 0]),
        (4, 8, 2, 64, 16, 19, [5, 16, 300, 0]),
    ], label)
    extend = phase_paged_extend(device, [
        # the slice's verify (T = spec_k + 1): page edges, a full table, a
        # row with no prefix
        (8, 16, 4, 128, 128, 16, 5, [0, 1, 124, 127, 128, 700, 1500, 2043]),
        (4, 8, 2, 64, 16, 19, 3, [0, 14, 300, 5]),
        # G = 8, T = 9: a folded group of 72 rows, two query tiles
        (2, 16, 2, 128, 64, 16, 9, [33, 900]),
    ], label)

    # 3. the serving slices at the serving configuration: the default
    # Scheduler, the paged one (a page pool, a shared 384-token system
    # prompt through the prefix cache, prefill in chunks of 256) and
    # multi_step=4, each with every launch counter at 0 before it
    cfg = tfm.TransformerConfig(**SERVING, dtype=torch.bfloat16)
    params = tfm.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device)
    prompts = serving_prompts(cfg, 32)
    sched, single, launches = phase_slice(
        device, cfg, params, prompts, max_batch=8, max_len=2048, max_new=64,
        label=label)
    fwd["launches"] = launches["flash_fwd"]
    dec["launches"] = launches["flash_decode"]
    system = np.random.default_rng(1).integers(0, cfg.vocab_size, 384)
    paged_launches = phase_paged_slice(
        device, cfg, params,
        [np.concatenate([system, p]).astype(np.int32) for p in prompts],
        max_batch=8, max_len=2048, max_new=64, linear=sched.metrics(),
        label=label)
    ragged["launches"] = paged_launches["flash_fwd_ragged"]
    paged["launches"] = paged_launches["paged_decode"]
    phase_multi_step(device, cfg, params, prompts, max_batch=8, max_len=2048,
                     max_new=64, single=single, label=label)

    # 4. speculative decoding at bench_spec.py's configuration: the serving
    # model as the target, the 2-layer draft; then the serving slice through
    # the speculative Scheduler, linear, paged, and paged with draft = target
    draft_cfg = tfm.TransformerConfig(**DRAFT, dtype=torch.bfloat16)
    draft_params = tfm.init_params(
        draft_cfg, torch.Generator(device=device).manual_seed(1), device)
    tie = phase_spec_generate(device, cfg, params, draft_cfg, draft_params,
                              batch=4, prompt_len=128, max_new=128, label=label)
    spec_launches = phase_spec_slice(
        device, cfg, params, draft_cfg, draft_params, prompts, max_batch=8,
        max_len=2048, max_new=64, single=single, linear=sched.metrics(),
        tie=tie, label=label)
    extend["launches"] = spec_launches["paged_extend"]
    profile_spec_round(device, cfg, params, draft_cfg, draft_params, label)
    del draft_params

    # 5. cached decode against a full forward: the linear cache, then the
    # paged cache with a prefix shared through cache_from_pages
    phase_consistency(device, cfg, params, n_prompt=128, n_steps=16,
                      label=label)
    phase_paged_consistency(device, cfg, params, n_prompt=640, n_shared=512,
                            chunk=256, n_steps=16, label=label)
    profile_decode_steps(device, cfg, params, label)
    del params, sched

    # 6. the backward kernels against their plain version
    bwd = phase_backward(device, [
        (1, 16, 4, 4096, 4096, 128, True, 0),  # bench.py's shape
        (4, 16, 4, 4096, 4096, 128, True, 0),  # the training step's shape
        (1, 16, 4, 1024, 1024, 64, True, 0),   # d=64
        (2, 4, 2, 200, 333, 128, False, 0),    # ragged, non-causal
        (2, 4, 2, 200, 333, 128, True, 133),   # ragged, causal, q_offset
    ], label, entry_shape=1)

    # 7. training at the bench_train.py configuration
    cfg = tfm.TransformerConfig(**TRAIN, dtype=torch.bfloat16)
    params = tfm.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device)
    corpus = motif_corpus(cfg)
    params, train_launches = phase_train(
        device, cfg, params, corpus, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR, steps=5,
        label=label)
    for entry in bwd:
        entry["launches"] = train_launches["flash_bwd"]

    # 8. train -> checkpoint -> restore -> serve
    phase_checkpoint(device, cfg, params, corpus, label)

    print(json.dumps({"kernels": [fwd, dec, *bwd, ragged, paged, extend]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
