#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one Hopper GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ (at first use) and holds each
against its plain PyTorch version in bf16 at the shapes its path gives it,
with its bound and the time of one PyTorch library call that computes the
same function (scaled_dot_product_attention, where there is one); the
8-bit kernels (int8 and e4m3 caches) likewise, each beside the bf16 kernel
on its dequantized cache. Then it drives the port's main paths at full
width, with random weights from a seed:
  - serving: 32 requests through models.serving.Scheduler at the serving
    configuration of benchmarks/bench_serving.py (8 layers, d_model 2048,
    16 q heads x 128, 4 KV heads, d_ff 5504, vocab 32000, bf16, batch 8,
    max_len 2048) three times: the default mode (linear cache), the paged
    mode (page pool of 128-row pages, a shared 384-token prefix through the
    prefix cache, prefill in chunks of 256) and multi_step=4;
  - speculative decoding at benchmarks/bench_spec.py's configuration (the
    serving model as the target, a 2-layer draft with half its d_ff):
    speculative_generate against generate with bench_spec's gates, then
    the 32 requests through Scheduler(draft_cfg=...) on the linear cache,
    on the page pool, and on the page pool with the target as its own
    draft, each against the plain greedy tokens;
  - the int8 cache of bench_serving.py --int8: the 32 requests through
    Scheduler(quantized_cache=True) linear, paged (the same prefix and
    chunks), multi_step=4 and speculative over the page pool and the
    linear cache, each beside its bf16 run; then cached decoding against a
    full forward over the bf16, int8 and e4m3 caches, linear and paged,
    and one decode step with int8 weights;
  - the sliding window with attention sinks: the band kernels (forward,
    ragged bf16 and 8-bit, the linear decodes, the backward) against their
    plain versions over the same band, each beside the kernel without a
    window, with the band's pairs as the bound and SDPA with a boolean
    band mask as the library call; benchmarks/run_all.py's 32K forward
    with a 4096 window and 64 sinks beside the causal one (at most 0.4x
    the time); the serving model with window 256 and 4 sinks through the
    Scheduler five ways (default, multi_step=4, paged + prefix + chunks,
    int8 in chunks, speculative on the linear cache with a windowed
    draft), each with its windowed launch counters; cached decode against
    a windowed full forward past the window (bf16, int8, e4m3);
  - training: 5 sgd_train_steps at the configuration of
    benchmarks/bench_train.py (the same widths, 4 layers, batch 4, seq
    4096) on batches from the native TokenLoader, then the trained params
    through save_checkpoint / restore_checkpoint and the Scheduler; then 5
    steps with a window of 1024 and 64 sinks, beside the causal ms/step;
  - the fixed-max and "auto" disciplines: kernel 1's fixed-max instances
    at bench.py's shape (causal and full), a ragged one and run_all.py's
    32K windowed rungs (window 4096, with and without 64 sinks, every row
    against plain), the packed d=64 forward (kernel 2's counterpart) at
    run_all.py's d64 rung, the hybrid at bench.py's shape and the d64
    `_auto` rung on bounded inputs, on q x +-60 (equal to the stable
    kernel within 1e-6), on mixed tiles and with a cached or over-estimated
    k_max, kernel 3's fixed-max instances (bf16, int8, e4m3) at the
    serving chunk, the dense 8-bit forward in each discipline and at
    BASELINE.json config 5 (32/8 heads, 32K tokens, int8, the last 512
    rows against plain), each against its plain version and timed beside
    the stable kernel; bench.py's headline call (stable="auto" with a
    cached k_max) with its TFLOP/s and share of 989; the serving model
    with attn_stable=False through the Scheduler three ways (default,
    prefill_chunk=256, int8 in chunks), its tokens audited against the
    stable runs, and its cached decode against a full forward; the JAX
    package's default model (d_head 64, attn_stable=False) serving 8
    requests and taking 5 SGD steps through the packed forward;
  - the GEMM and softmax ladder through the ops API, its own path with
    every launch counter at 0 before it: benchmarks/run_all.py's GEMM rungs
    (matmul bf16 4096^3 to bf16 and to f32, f32 2048^3, batched bf16
    8 x 1024^3, the fused epilogue at 4096^3) and softmax rungs (8192 x
    4096 and 4096 x 512 f32, and a bf16 input), BASELINE.json config 3 (the
    softmax-epilogue GEMM at 32 x 2048^3, bf16) and configs 1 and 2 (matmul
    f32 and matmul_bf16 at 1024^3, then softmax, held on the host against
    the fp64 oracle at max-abs 1e-2), run_all.py's 8-bit GEMM rungs
    (weight-only int8 and e4m3 at 4096^3, int8 x int8 at 4096^3, bit-equal
    to plain), config 3 through the resident fixed-max form (witness 0;
    inputs scaled by 40 must fall back to kernel 16's output bit for bit)
    and run_all.py's streaming decode (B 256, 8/1 heads, S 4096, d 128),
    with ragged shapes; every output against its plain version, each
    kernel timed beside it, its bound and the library call (torch.matmul,
    torch.bmm, torch.softmax, float32 products without TF32; SDPA for the
    streaming decode) or the multi-call baseline (run_all.py's unfused bmm
    + softmax, the engine's cast-and-matmul for 8-bit weights,
    torch._int_mm and the scales), and the port's kernel 16 beside the
    resident form, its split decode beside the streaming one;
  - the int8 x int8 decodes and the fixed-max range guard, each its own
    path with the counters at 0 before it: flash_decode_int8(mxu=True)
    (kernel 8) at run_all.py's decode rung (B 8, 16/4 heads, S 8192, d
    128) and at the serving shape with and without window 256 + 4 sinks,
    paged_flash_decode_quant(q_int8=True) at run_all.py's paged rung
    (page 128, 64 pages a row) and the serving pool, each against its
    plain version, against the kernel without the option (kernel 7 or
    12) and timed beside it and the bf16 kernel on the dequantized cache;
    q_int8=True on e4m3 pages and with gather=False must run the ordinary
    kernel bit for bit; kernel 8's partials must equal its plain version's
    bit for bit in m and y, its whole call (one launch, the split merge on
    the card) the merged plain partials (bit for bit at one split), also at
    its tile and split edges; _fwd(guard=True) at bench.py's shape, the d64
    rung (packed, a row counted once for a KV pair) and
    _fwd_q_cuda(guard=True) over an int8 cache: count 0 with O and LSE
    bit-equal to the unguarded kernel on bounded inputs, 1 on the JAX
    test's crafted row, plain's count on q x 60, timed beside the
    unguarded kernel;
  - the stage probes and the paged gather's probe options, each its own
    path with the counters at 0 before it: benchmarks/profile_attention.py's
    breakdown at its shape (1 x 16/4 heads x 4096 x 128 bf16, non-causal,
    block_q = block_k = 512): the copy, qk, pv and softmax-chain probes
    and qk_kt, each against its plain version, timed beside it and its
    bound, and kernel 1 stable and stable=False at the same shape, with
    the sum of the stages against the fused kernel; run_all.py's probe
    rungs (qk and pv at d64, qk_packed at d64, the stream copy at 8192 x
    4096 f32 beside torch's x + 1); qk_kt at d 64 and 128 and qk_packed at
    d 32 and 64 held to plain also at the tails of the Hopper block, and
    each one's kernel alone and whole call timed beside qk at the same
    flops; the chain's exp2 count in the SASS of its Hopper instance;
    then ab_paged_int8.py's slots 2, 3 and 4 over its int8 and bf16 pools
    (each depth bit-equal to slots 2) and copy_only (bit-equal to its plain
    version), timed beside kernel 10;
  - the dense forward (kernels 1 and 2, csrc/flash_fwd_sm90.cuh: wgmma,
    TMA and a K/V ring): its 24 instances built with no spill and no
    wgmma serialized by ptxas, HGMMA and UTMALDG and no HMMA.16816 in
    their SASS; every discipline at the edges of its tiles (64- and
    128-row query blocks, 128-key tiles: n and s off the tile, q_offset
    with n < s, rows before the first key, sinks wider than a tile, d 64
    and 128) against the plain version and, at most 4 x 256 x 256 pairs,
    the float64 oracle; the
    hybrid with one breaching warp a warpgroup; and its time at bench.py's
    shape (each discipline, causal and full), d=64 (stable, packed,
    hybrid), the training band and the serving prefill, each in turns with
    SDPA from CUDA graphs, with its bound and factor;
  - the bf16 GEMM (kernels 13 and 14, csrc/gemm_sm90.cuh: wgmma, TMA and a
    K ring): its two instances (128 x 256 and 128 x 128 tiles) built with
    no spill and no wgmma serialized by ptxas, HGMMA and UTMALDG and no
    HMMA.16816 in their SASS; on the ladder's path the aligned bf16 rungs
    (4096^3, 8 x 1024^3, K = 136) must take it and the others (f32, K =
    130, the epilogue) must not; matmul and batched_matmul at the edges of
    its tiles (M, N off the tile, K not a multiple of 64 and K < 64, batch
    3, more tiles than SMs, both tile widths), bf16 and f32 out, against
    the plain version; and its time at 4096^3 (bf16 and f32 out) and
    8 x 1024^3, each in turns with torch.matmul or torch.bmm from CUDA
    graphs, with its bound and factor;
  - the backward (kernels 4 and 5, csrc/flash_bwd_sm90.cuh: kernel A, dK
    and dV and in the fused-dq schedule dQ's partials, summed by TMA
    reduce-adds; csrc/flash_bwd_dq_sm90.cuh: kernel B, dQ alone): its 12
    instances built with no spill and no wgmma serialized by ptxas, HGMMA
    and UTMALDG and no HMMA.16816 in their SASS; both dq schedules at the
    edges of its tiles (kernel A's 128-key blocks and 64-row query tiles,
    kernel B's 128-row blocks and 64-key tiles: n and s off the tiles,
    q_offset with n < s, rows before the first key with dq = 0 exactly,
    sinks wider than a tile, d 64 and 128, GQA groups 1-8) against the
    plain version and, at most 4 x 256 x 256 pairs, the float64 oracle;
    and `_bwd` in each schedule at the training shape, bench.py's b = 1,
    d = 64 and the training band, in turns with SDPA's backward, from
    CUDA graphs, with its bounds (5 and 7 products) and factor; the
    training phases count which schedule trained;
  - the bf16 linear decode (kernel 6, csrc/flash_decode_sm90.cuh: 64-key
    tiles through a TMA ring, both products on mma.sync, splits sized for
    any batch, the split merge on the card): its 16 instances built with
    no spill, UTMALDG and HMMA.16816 in their SASS; the whole call and the
    kernel's partials against the plain version at the serving shape and
    at the edges of its tiles and splits (lengths about a tile with S off
    the tile and above S, every G at d 64 and 128, a caller's splits off
    the tile, one split, a window of 70 with 66 sinks cutting a split in
    two); at most two device operations a call (torch.profiler); the kernel
    alone, the whole call and SDPA with a length mask in turns from CUDA
    graphs, and with the serving window beside SDPA with the band mask;
  - the paged extend (kernel 11, csrc/paged_extend_sm90.cuh: TMA boxes
    that follow the block table into a ring of 64-key tiles, both products
    on mma.sync, splits over the pages, the split merge on the card): its
    18 instances built with no spill, UTMALDG and HMMA.16816 in their
    SASS; the whole call and the kernel's partials against the plain
    version over bf16, int8 and e4m3 pools at the serving verify and at
    the edges of its tiles, boxes, row slabs and splits (pages of 16 to
    128, G 1-8 with T 1, 5 and 9, old length 0, lengths at tile, page and
    split edges and at the table's capacity, splits with no live key, a
    table of mostly dead entries); one device operation a call, a CUDA
    graph's replay bit-equal; the kernel alone, the whole call and SDPA on
    the K/V gathered into a linear cache (a yardstick, not the same
    function) in turns from CUDA graphs; a profiled speculative round over
    the int8 pool beside the bf16 one;
  - the 8-bit linear decode (kernel 7, the same header's 8-bit kernel:
    byte tiles widened in registers, the split merge on the card): its 32
    instances built with no spill, UTMALDG and HMMA.16816 and no local
    load or store in their SASS; the whole call and the kernel's partials
    against the plain version, int8 and e4m3, at the serving shape, with
    the serving window and at the edges of its tiles and splits; one
    device operation a call and a graph's replay bit-equal; one launch a
    layer in the profiled int8 linear decode step;
  - the dense 8-bit forward (flash_fwd_sm90.cuh's block body over widened
    byte tiles, 64- and 128-row blocks): its 32 instances built with no
    spill, HGMMA and UTMALDG and no HMMA.16816 in their SASS; O, LSE and
    the guard's count against the plain version at its row-block and tile
    edges in the three disciplines, int8 and e4m3;
  - serving over a device mesh (phase_mesh): two ranks spawned on the
    one card, one process each, joined by gloo (NCCL refuses two ranks on
    one GPU); the serving model through Scheduler(mesh=) (linear in
    chunks of 256, paged with the prefix cache, paged int8, speculative
    linear and paged) and Scheduler(seq_mesh=) (bf16, int8), 8 requests x
    64 tokens each, the tokens equal on both ranks and held to the
    single-device Scheduler by the near-tie audit; the TP and SP engines'
    logits against the single-device engine's; seq_sharded_decode at B 8,
    16/4 heads, S 8192, d 128 against flash_decode. Its times are two
    ranks sharing one card over gloo, not a multi-device speed;
  - training over a device mesh (phase_mesh_train), two ranks the
    same way: ring attention (causal, windowed, trainable) and Ulysses at
    1 x 16/4 x 8192 x 128 and the 8-bit ring at BASELINE config 5's
    shape against the single-device kernels (outputs and gradients), then
    bench_train.py's model and batch through the CP, TP, AdamW and
    pipeline steps, 3 steps each: the first loss against loss_fn, the SGD
    steps' params against sgd_train_step's, losses falling, replicated
    params bit-equal on both ranks, each path's launches as its schedule
    predicts;
  - expert parallelism and sharded checkpoints over a device mesh
    (phase_mesh_moe, last), two ranks the same way, on bench_train.py
    --moe-experts 8's model: make_ep_moe on 4 x 4096 hidden states
    against moe_ffn (output and gradients); the TP SGD and AdamW steps'
    MoE branch (data 1 x model 2, remat), 3 steps each, held as the dense
    ones are, the AdamW run saved as a sharded checkpoint
    (torch.distributed.checkpoint) before its last step, restored into the
    mesh to retake it bit for bit and onto one device equal to the ranks'
    shards; Scheduler(seq_mesh=) over the model (bf16, int8), 8 requests x
    64 tokens, against the same Scheduler on one rank by the near-tie
    audit, and the SP decode logits against the single-device engine's;
  - the benchmark harness (phase_benchmarking, last): utils.benchmarking's
    benchmark_chained, benchmark_device, benchmark and capture_trace on
    bench.py's headline call and the serving decode, each against time_ms
    from CUDA graphs.
Every phase logs its seconds as it ends, and the run's end logs them all
on one line with the total, then the kernels line (each kernel's contract
keys; its whole entry is logged earlier on a "kernel detail" line).
Every phase raises on failure, so the script exits non-zero if any check
fails. It needs one card, checks first that the card answers
(utils.health.device_healthcheck), and prints no result without CUDA. Its
last line is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
One more training step, a speculative round and decode steps over each
cache run under torch.profiler: device time by kind is printed.
Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import json
import os
import re
import statistics
import sys
import tempfile
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
# the same against an 8-bit cache, whose quantization adds its own error:
# the JAX suite's bound for 8-bit logits (tests/test_model.py:190, 219),
# set on a float32 model. On the bf16 model the 8-bit cache's error comes on
# top of the bf16 floor, so by the triangle inequality the gate there is
# this bound plus the floor the bf16 cache shows on the same path in the
# same run.
QUANT_LOGITS_TOL = 5e-2


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


def bound(flops: float, nbytes: float, peak: float | None = None) -> dict:
    """The least time the card could take for work of `flops` operations
    (at `peak` operations a second: by default the bf16 tensor-core rate)
    moving `nbytes` of device memory (each input read once, each output
    written once): the larger of the two times at the H100's published
    peaks, and which of the two sets it."""
    from flashattention_kernel_project_tpu_torch.utils import platform

    t_ops = flops / (peak or platform.H100_BF16_FLOPS) * 1e3
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
                 source=f"{PKG}/csrc/flash_fwd_sm90.cuh",
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


# The dense forward's instances: one source a discipline (kDisc 0, 1, 2)
SM90_OBJECTS = {0: "flash_fwd.cu", 1: "flash_fwd_fixed.cu", 2: "flash_fwd_hybrid.cu"}
SM90_KERNEL = "flash_fwd_sm90_kernel"


def mangled_name(sym: str) -> tuple[str, str]:
    """(the innermost name, what follows it) of a mangled symbol, e.g.
    ("flash_fwd_sm90_kernel", "ILi128ELb0ELi0EEEv...") for
    "_ZN8fkp_sm9021flash_fwd_sm90_kernelILi128ELb0ELi0EEEv..."."""
    i = 3 if sym.startswith("_ZN") else 2
    name = ""
    while i < len(sym) and sym[i].isdigit():
        j = i
        while sym[j].isdigit():
            j += 1
        name, i = sym[j:j + int(sym[i:j])], j + int(sym[i:j])
    return name, sym[i:]


def template_args(kernel: str, count: int):
    """A reader of `kernel`'s symbols: its first `count` integer template
    arguments, or None for another symbol."""
    def read(sym: str):
        name, rest = mangled_name(sym)
        if name != kernel:
            return None
        return tuple(int(a) for a in re.findall(r"L[ib](\d+)E", rest)[:count])
    return read


def sm90_instance(sym: str):
    """(d, band, disc, block rows) of a flash_fwd_sm90_kernel instance's
    symbol, or None for another symbol."""
    name, rest = mangled_name(sym)
    if name != SM90_KERNEL:
        return None
    return tuple(int(a) for a in re.findall(r"L[ib](\d+)E", rest)[:4])


def dense_rows(n: int, hq: int, b: int, sms: int) -> int:
    """The query rows of the dense forward's blocks for a call, as its entry
    picks them (block_rows in csrc/flash_fwd_sm90.cuh): 64 where a grid of
    64-row blocks fits in one wave of the card's SMs, else 128."""
    return 64 if -(-n // 64) * hq * b <= sms else 128


SASS = {}  # object file -> its `cuobjdump -sass` text (dump_sass)


def _cuobjdump() -> str:
    from flashattention_kernel_project_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        raise AssertionError(f"no cuobjdump beside nvcc ({tool}): the SASS "
                             "gates cannot run")
    return tool


def dump_sass(objs) -> None:
    """`cuobjdump -sass` of each object file, one process each, all started
    together (the gates read them from SASS)."""
    import concurrent.futures
    import subprocess

    tool = _cuobjdump()
    run = lambda obj: subprocess.run(  # noqa: E731
        [tool, "-sass", obj], check=True, capture_output=True, text=True,
        timeout=300).stdout
    with concurrent.futures.ThreadPoolExecutor(max(1, os.cpu_count() or 1)) as ex:
        SASS.update(zip(objs, ex.map(run, objs)))


def sass_of(obj: str) -> str:
    if obj not in SASS:
        dump_sass([obj])
    return SASS[obj]


def wgmma_gate(build_log: str, kernel: str, instance, objects: dict, want: set,
               need=("HGMMA", "UTMALDG"), forbid=("HMMA.16816",), frame=True):
    """The instances of a wgmma kernel as ptxas and the SASS show them: each
    compiled (`want`, as `instance` reads them from a symbol), none
    spilling (frame=False: nor with a stack frame), none with wgmma
    instructions serialized by ptxas, and each in
    the object of its source (objects: source -> whether an instance
    belongs there) with the opcodes of `need` (by default HGMMA, wgmma, and
    UTMALDG, TMA loads) and none of `forbid` (by default HMMA.16816,
    mma.sync). Raises otherwise; cuobjdump must sit beside nvcc. Returns
    {instance: SASS counts of HGMMA, UTMALDG, HMMA.16816 and the opcodes of
    `need` and `forbid`}."""
    from flashattention_kernel_project_tpu_torch.ops import _build

    spills, current = {}, None
    for line in build_log.splitlines():
        props = re.search(r"(?:Compiling entry function '|Function properties "
                          r"for )([^'\s]+)", line)
        if props:  # a spill line follows the function it is about
            current = instance(props.group(1))
        elif current is not None and "spill stores" in line:
            spills[current] = line.strip()
            current = None
        if "serialized" in line and kernel in line:
            raise AssertionError(f"ptxas serialized wgmma: {line.strip()}")
    if set(spills) != want:
        raise AssertionError(f"{kernel} instances built: {sorted(spills)}")
    for inst, line in sorted(spills.items()):
        if not re.search(r"\b0 bytes spill stores, 0 bytes spill loads", line):
            raise AssertionError(f"{kernel}{inst} spills: {line}")
        if not frame and not re.search(r"\b0 bytes stack frame", line):
            raise AssertionError(f"{kernel}{inst} has a stack frame: {line}")
    counts = {}
    for src, belongs in objects.items():
        sass = sass_of(os.path.join(_build.BUILD_DIR, src + ".o"))
        for section in sass.split("Function : ")[1:]:
            inst = instance(section.split("\n", 1)[0].strip())
            if inst is None:
                continue
            if not belongs(inst):
                raise AssertionError(f"{kernel}{inst} built in {src}")
            ops = {op: section.count(op) for op in {"HGMMA", "UTMALDG",
                                                      "HMMA.16816", *need, *forbid}}
            if not all(ops[op] for op in need) or any(ops[op] for op in forbid):
                raise AssertionError(f"{kernel}{inst} in {src}: {ops}")
            counts[inst] = ops
    if set(counts) != want:
        raise AssertionError(f"{kernel} instances in the SASS: {sorted(counts)}")
    return counts


def phase_fwd_sm90_build(build_log: str, label):
    """The dense forward's 24 instances (d 64 and 128, without and with a
    band, in the three disciplines, in blocks of 64 and 128 query rows)
    through `wgmma_gate`, each discipline's in its own source's object."""
    want = {(d, w, c, rows) for d in (64, 128) for w in (0, 1)
            for c in (0, 1, 2) for rows in (64, 128)}
    counts = wgmma_gate(
        build_log, SM90_KERNEL, sm90_instance,
        {src: (lambda inst, disc=disc: inst[2] == disc)
         for disc, src in SM90_OBJECTS.items()}, want)
    log(f"dense forward: 24 instances (d, band, disc, rows) built with no spill and no "
        f"serialized wgmma; SASS (HGMMA, UTMALDG, HMMA.16816): "
        + ", ".join(f"{inst}: {c['HGMMA']}/{c['UTMALDG']}/{c['HMMA.16816']}"
                    for inst, c in sorted(counts.items())) + f" [{label}]")


# The bf16 GEMM's wgmma instances (csrc/gemm_sm90.cuh): tiles of 128 x kBN,
# plain (kEpi 0) and with the fused epilogue (kEpi 1, kernel 15)
GEMM_SM90_OBJECT = "gemm_sm90.cu"
GEMM_SM90_KERNEL = "gemm_sm90_kernel"
GEMM_SM90_TILES = (128, 256)
gemm_sm90_instance = template_args(GEMM_SM90_KERNEL, 2)  # (kBN, kEpi)


def phase_gemm_sm90_build(build_log: str, label):
    """The bf16 GEMM's four wgmma instances (128 x 256 and 128 x 128 tiles,
    plain and with the fused epilogue) through `wgmma_gate`, in
    gemm_sm90.cu's object; with their registers from ptxas (the consumers
    run at most 232 after setmaxnreg)."""
    want = {(n, epi) for n in GEMM_SM90_TILES for epi in (0, 1)}
    counts = wgmma_gate(build_log, GEMM_SM90_KERNEL, gemm_sm90_instance,
                        {GEMM_SM90_OBJECT: lambda inst: True}, want)
    regs = ptxas_registers(build_log, gemm_sm90_instance)
    log("bf16 GEMM: 4 wgmma instances (128 x kBN, kEpi: 1 the fused epilogue) built "
        "with no spill and no serialized wgmma; SASS (HGMMA, UTMALDG, HMMA.16816), "
        "registers at launch: "
        + ", ".join(f"{inst}: {c['HGMMA']}/{c['UTMALDG']}/{c['HMMA.16816']}, "
                    f"{regs.get(inst)}" for inst, c in sorted(counts.items()))
        + f" [{label}]")


# The f32 GEMM's wgmma kernel (csrc/gemm_f32_sm90.cuh): tiles of 128 x 128,
# plain (kEpi 0) and with the fused epilogue (kEpi 1, kernel 15)
GEMM_F32_OBJECT = "gemm_f32_sm90.cu"
GEMM_F32_KERNEL = "gemm_f32_sm90_kernel"
GEMM_F32_TILE = 128
gemm_f32_instance = template_args(GEMM_F32_KERNEL, 1)  # (kEpi,)


def phase_gemm_f32_build(build_log: str, label):
    """The f32 GEMM's two wgmma instances (plain and with the fused
    epilogue) through `wgmma_gate`, in gemm_f32_sm90.cu's object: HGMMA
    and UTMALDG in their SASS, no HMMA.16816 and no FFMA (the split
    subtracts, the products are the tensor cores', the promotion and the
    epilogue add), no spill, no serialized wgmma; with their registers
    from ptxas."""
    counts = wgmma_gate(build_log, GEMM_F32_KERNEL, gemm_f32_instance,
                        {GEMM_F32_OBJECT: lambda inst: True}, {(0,), (1,)},
                        forbid=("HMMA.16816", "FFMA"))
    regs = ptxas_registers(build_log, gemm_f32_instance)
    log("f32 GEMM: 2 wgmma instances (128 x 128 tiles; kEpi 0, 1 the fused "
        "epilogue) built with no spill and no serialized wgmma; SASS (HGMMA, "
        "UTMALDG, HMMA.16816, FFMA), registers at launch: "
        + ", ".join(f"{inst}: {c['HGMMA']}/{c['UTMALDG']}/{c['HMMA.16816']}/"
                    f"{c['FFMA']}, {regs.get(inst)}" for inst, c in sorted(counts.items()))
        + f" [{label}]")


# The softmax-epilogue GEMM's wgmma instances (csrc/gemm_softmax_sm90.cuh):
# (tile width, resident)
GEMM_SOFTMAX_OBJECT = "gemm_softmax_sm90.cu"
GEMM_SOFTMAX_KERNEL = "gemm_softmax_sm90_kernel"


def phase_gemm_softmax_build(build_log: str, label):
    """Kernels 16 and 17's four wgmma instances (128 x 128 and 128 x 256
    tiles, rows and resident) through `wgmma_gate`, in
    gemm_softmax_sm90.cu's object: no spill, no stack frame, no serialized
    wgmma; HGMMA, UTMALDG (A's, B's and C's boxes) and UTMASTG (C's boxes
    back) and no HMMA.16816 in each; with their registers from ptxas."""
    instance = template_args(GEMM_SOFTMAX_KERNEL, 2)
    counts = wgmma_gate(build_log, GEMM_SOFTMAX_KERNEL, instance,
                        {GEMM_SOFTMAX_OBJECT: lambda inst: True},
                        {(n, r) for n in (128, 256) for r in (0, 1)},
                        need=("HGMMA", "UTMALDG", "UTMASTG"), frame=False)
    regs = ptxas_registers(build_log, instance)
    log("softmax-epilogue GEMM: 4 wgmma instances (kBN, resident) built with no "
        "spill, no stack frame and no serialized wgmma; SASS (HGMMA, UTMALDG, "
        "UTMASTG, HMMA.16816), registers at launch: "
        + ", ".join(f"{inst}: {c['HGMMA']}/{c['UTMALDG']}/{c['UTMASTG']}/"
                    f"{c['HMMA.16816']}, {regs.get(inst)}"
                    for inst, c in sorted(counts.items())) + f" [{label}]")


# The 8-bit GEMMs' wgmma kernels: kernel 19 (csrc/gemm_w8_sm90.cu, (weight
# type, tile rows of x, consumer warpgroups)) and kernel 20
# (csrc/gemm_i8_sm90.cu, tile columns)
GEMM_W8_OBJECT = "gemm_w8_sm90.cu"
GEMM_W8_KERNEL = "gemm_w8_sm90_kernel"
GEMM_W8_INSTANCES = {(fmt, rows, wg) for fmt in ("int8", "e4m3")
                     for rows, wg in ((256, 2), (128, 2), (64, 1), (16, 1))}
GEMM_I8_OBJECT = "gemm_i8_sm90.cu"
GEMM_I8_KERNEL = "gemm_i8_sm90_kernel"


def gemm_w8_instance(sym: str):
    """(weight type, kBM, kWG) of a gemm_w8_sm90_kernel instance's symbol,
    or None for another symbol."""
    name, rest = mangled_name(sym)
    if name != GEMM_W8_KERNEL:
        return None
    rows, wg = (int(a) for a in re.findall(r"L[ib](\d+)E", rest)[:2])
    return ("e4m3" if "fp8" in rest else "int8", rows, wg)


def phase_gemm_8bit_build(build_log: str, label):
    """Kernels 19 and 20's wgmma instances through `wgmma_gate`: kernel 19's
    eight (int8 and e4m3 weights x tiles of 256 x 128, 128 x 128, 64 x 64
    and 16 x 64: rows of x x columns of C) with HGMMA and UTMALDG, kernel
    20's two (128 x 256 and 128 x 128) with IGMMA (int8 wgmma) and
    UTMALDG, each in its source's object, none with HMMA.16816 or
    IMMA.16832 (mma.sync), no spill, no serialized wgmma; with their
    registers from ptxas."""
    forbid = ("HMMA.16816", "IMMA.16832")
    w8 = wgmma_gate(build_log, GEMM_W8_KERNEL, gemm_w8_instance,
                    {GEMM_W8_OBJECT: lambda inst: True}, GEMM_W8_INSTANCES,
                    forbid=forbid)
    i8_instance = template_args(GEMM_I8_KERNEL, 1)
    i8 = wgmma_gate(build_log, GEMM_I8_KERNEL, i8_instance,
                    {GEMM_I8_OBJECT: lambda inst: True}, {(128,), (256,)},
                    need=("IGMMA", "UTMALDG"), forbid=forbid)
    w8_regs = ptxas_registers(build_log, gemm_w8_instance)
    i8_regs = ptxas_registers(build_log, i8_instance)
    log("8-bit GEMMs: kernel 19's 8 wgmma instances (weights, kBM, kWG) and kernel "
        "20's 2 (kBN) built with no spill and no serialized wgmma; SASS (HGMMA or "
        "IGMMA, UTMALDG; no HMMA.16816, IMMA.16832), registers at launch: "
        + ", ".join(f"{inst}: {c['HGMMA']}/{c['UTMALDG']}, {w8_regs.get(inst)}"
                    for inst, c in sorted(w8.items())) + "; "
        + ", ".join(f"{inst[0]}: {c['IGMMA']}/{c['UTMALDG']}, {i8_regs.get(inst)}"
                    for inst, c in sorted(i8.items())) + f" [{label}]")


def gemm8_launches() -> tuple:
    """(the 8-bit GEMMs' wgmma launches so far, over the three wrappers;
    kernel 20's transposing passes so far)."""
    from flashattention_kernel_project_tpu_torch.ops import quant as qt

    return (qt.matmul_int8_weights.sm90_launches + qt.matmul_fp8_weights.sm90_launches
            + qt.matmul_int8.sm90_launches, qt.matmul_int8.transpose_launches)


def sm90_launches() -> int:
    """The launches of the bf16 wgmma GEMM so far, over its three
    wrappers."""
    from flashattention_kernel_project_tpu_torch.ops import gemm as g

    return (g.matmul.sm90_launches + g.batched_matmul.sm90_launches
            + g.matmul_fused_epilogue.sm90_launches)


def f32x_launches() -> int:
    """The launches of the f32 wgmma GEMM so far, over its three
    wrappers."""
    from flashattention_kernel_project_tpu_torch.ops import gemm as g

    return (g.matmul.f32x_launches + g.batched_matmul.f32x_launches
            + g.matmul_fused_epilogue.f32x_launches)


def gemm_tile_n(batch: int, m: int, n: int) -> int:
    """The tile width (128 or 256) the wgmma GEMM's entry picks for a call
    of this shape on this card (csrc/gemm_sm90.cu)."""
    import ctypes

    from flashattention_kernel_project_tpu_torch.ops import _build

    return _build.kernel("fkp_gemm_sm90_tile_n", [ctypes.c_int] * 3)(batch, m, n)


def softmax_tile_n(batch: int, m: int, n: int) -> int:
    """The tile width (128 or 256) the softmax epilogue's wgmma kernel
    picks for a call of this shape on this card (csrc/gemm_softmax_sm90.cu)."""
    import ctypes

    from flashattention_kernel_project_tpu_torch.ops import _build

    return _build.kernel("fkp_gemm_softmax_sm90_tile_n", [ctypes.c_int] * 3)(batch, m, n)


# (batch, m, k, n) at the edges of the wgmma GEMM's 128-row tiles, 64-deep
# slices and 128- or 256-column tiles: M, N off the tile, K not a multiple
# of 64 and K < 64, batch 3 with a ragged M, an N tile of 8 live columns,
# more tiles than SMs (a block walks several, the ring's phase carried
# across them)
GEMM_TILE_SHAPES = [
    (1, 200, 136, 72), (1, 1000, 1000, 1000), (3, 200, 520, 264),
    (1, 129, 8, 4104), (2, 1100, 328, 2056), (4, 520, 72, 4104),
]


# kernel 15 on 128 x 256 tiles at their edges: M off the 128-row tiles, N
# ending 8 columns into a 256-column tile, K off the 64-deep slices (153
# tiles of 128 x 256, more than half the SMs)
EPILOGUE_WIDE_SHAPES = [(1, 2100, 72, 2056)]


# the f32 wgmma GEMM at the same edges, with N = 100 (a multiple of 4, not
# of 8: bf16 out in pairs of columns) and batch 3 at K = 132
GEMM_F32_TILE_SHAPES = GEMM_TILE_SHAPES + [(1, 200, 132, 100), (3, 200, 132, 72)]
# the f32 wgmma GEMM against its split's plain version (the same six
# products summed in another order): rel-L2, ten times under GEMM_F32_TOL
# (f32 out) and BF16_TOL (bf16 out, where a sum on a rounding edge may
# round the other way)
SPLIT_TOL = 2e-6
SPLIT_BF16_TOL = 1e-3


def _hold_gemm(what, got, want, out, split=None):
    """One GEMM output against `_matmul_plain` (bf16: rel-L2 BF16_TOL; f32:
    GEMM_F32_TOL and GEMM_MAX_ABS) and, for the f32 wgmma kernel, against
    `_matmul_f32_split_plain` (SPLIT_TOL, bf16 out SPLIT_BF16_TOL). Returns
    a line for the log."""
    import torch

    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite output")
    err = _rel_l2(got, want)
    max_abs = float((got.float() - want.float()).abs().max())
    ok = (err <= BF16_TOL if out == torch.bfloat16
          else err <= GEMM_F32_TOL and max_abs <= GEMM_MAX_ABS)
    line = f"rel-L2 {err:.3e}, max-abs {max_abs:.3e}"
    if split is not None:
        err_split = _rel_l2(got, split)
        ok = ok and err_split <= (SPLIT_BF16_TOL if out == torch.bfloat16 else SPLIT_TOL)
        line += f", against the split's plain version rel-L2 {err_split:.3e}"
    if not ok:
        raise AssertionError(f"{what}: {line}")
    return line


# (batch, m, k, n) at the edges of the softmax-epilogue wgmma kernel's
# 128-row bands, 64-deep slices and 128- or 256-column tiles shared by a
# pair of CTAs: M 1, 127, 128, 129; N 8 (one live 8-column block, one tile:
# the second CTA has none), 248, 256, 264 (a second tile of one 8-column
# block), 4104 (17 or 33 tiles, the running max over many); K 8, 72, 2048;
# batch 1-3; 3x129x2048x4104 takes 256-column tiles, the rest 128, and
# 3x2944x72x256 has more bands than half the SMs with N <= 256 (where
# kernel 13's tile_n would pick 256, one tile a band)
SOFTMAX_TILE_SHAPES = [
    (1, 1, 8, 8), (2, 127, 72, 248), (3, 128, 2048, 256), (1, 129, 8, 264),
    (2, 1, 72, 4104), (1, 127, 2048, 8), (2, 128, 8, 264), (3, 127, 8, 256),
    (1, 129, 72, 248), (2, 1, 2048, 256), (3, 128, 72, 4104), (3, 129, 2048, 4104),
    (3, 2944, 72, 256),
]
# rel-L2 of the wgmma kernel's f32 outputs, against either plain version:
# they read up to 6.6e-6 at K 2048 (the products' sums in another order);
# an e rounded to bf16 before the rescale would read ~1e-3
SOFTMAX_F32_TOL = 2e-5
# rel-L2 of the wgmma kernel's bf16 outputs against its rounding order,
# by resident: rows against `_softmax_epilogue_tiles_plain`, read up to
# 1.9e-4 at the tile-edge shapes (the plain version: 5e-4 to 2.6e-3 where
# K or N is large); resident against its plain version, which is its
# rounding order too, read up to 8.7e-4 (1 / l rounded to bf16 moves a
# whole row by an ulp where the order of l's sum tips it)
SOFTMAX_MIRROR_TOL = {False: 5e-4, True: 2e-3}


def phase_softmax_tiles(device, label, shapes=SOFTMAX_TILE_SHAPES):
    """Kernels 16 and 17 on the wgmma kernel (csrc/gemm_softmax_sm90.cuh)
    at the edges of its bands and tiles, through
    batched_matmul_softmax_epilogue, rows and resident, to bf16 and to f32:
    each call must take the wgmma kernel (`.sm90_launches` rises by one for
    a rows call, by two for a resident one and its gated rows launch), the
    witness must stay 0, and each output is held by the ladder's gates
    against its plain version (`_softmax_epilogue_plain`,
    `_softmax_epilogue_resident_plain`, which is also the resident
    kernel's rounding order); a rows output also against the kernel's
    rounding order (`_softmax_epilogue_tiles_plain` at the tile width the
    kernel took), within SOFTMAX_MIRROR_TOL, and an f32 output within
    SOFTMAX_F32_TOL of both. Both tile widths must occur."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import gemm as g

    gen = torch.Generator(device=device).manual_seed(16)
    bf, f32 = torch.bfloat16, torch.float32
    fn = g.batched_matmul_softmax_epilogue
    sc = CONFIG3["scale"]
    widths = set()
    for batch, m, k, n in shapes:
        a = torch.randn(batch, m, k, generator=gen, device=device).to(bf)
        b = torch.randn(batch, k, n, generator=gen, device=device).to(bf)
        bias = torch.randn(n, generator=gen, device=device)
        tile = softmax_tile_n(batch, m, n)
        widths.add(tile)
        for out in (bf, f32):
            name = "f32" if out == f32 else "bf16"
            for resident in (False, True):
                before = fn.sm90_launches
                got = fn(a, b, bias, scale=sc, out_dtype=out, resident=resident)
                took = fn.sm90_launches - before
                what = (f"softmax epilogue {'resident' if resident else 'rows'} "
                        f"{batch}x{m}x{k}x{n} -> {name} (128 x {tile} tiles)")
                if took != 1 + resident:
                    raise AssertionError(f"{what}: {took} wgmma launches, "
                                         f"{1 + resident} expected")
                if resident:
                    want = g._softmax_epilogue_resident_plain(a, b, bias, sc, out)[0]
                    mirror, gate = want, "resident"
                    if int(fn.witness):
                        raise AssertionError(f"{what}: witness {int(fn.witness)}")
                else:
                    want = g._softmax_epilogue_plain(a, b, bias, sc, out)
                    mirror = g._softmax_epilogue_tiles_plain(a, b, bias, sc, out, tile)
                    gate = f"rows {name}"
                torch.cuda.synchronize()
                rung = Rung("gemm_softmax", what, None, None, gate, 0, 0, 0)
                line = _hold_ladder(rung, got, want, dict(max_abs_err=0.0))
                err_plain, err = _rel_l2(got, want), _rel_l2(got, mirror)
                limit = SOFTMAX_F32_TOL if out == f32 else SOFTMAX_MIRROR_TOL[resident]
                if not (err <= limit and (out == bf or err_plain <= limit)):
                    raise AssertionError(f"{what}: {line}; against the kernel's rounding "
                                         f"order rel-L2 {err:.3e} (limit {limit})")
                log(f"{what}: {line}; against the kernel's rounding order rel-L2 "
                    f"{err:.3e} (limit {limit}) [{label}]")
    if widths != {128, 256}:
        raise AssertionError(f"the softmax tile-edge shapes took tile widths {sorted(widths)}")


def phase_gemm_tiles(device, label, shapes=GEMM_TILE_SHAPES,
                     f32_shapes=GEMM_F32_TILE_SHAPES):
    """The wgmma GEMMs (kernels 13 and 14) at the edges of their tiles,
    through matmul (batch 1) and batched_matmul, bf16 operands on the bf16
    kernel and f32 operands on the f32 one, to bf16 and to f32, against
    `_matmul_plain` and (f32 operands) `_matmul_f32_split_plain`
    (`_hold_gemm`). Each call must take its wgmma kernel (its counter
    rises by one), and the bf16 shapes must take both tile widths. Kernel
    15 (matmul_fused_epilogue) the same way at the batch-1 shapes and
    EPILOGUE_WIDE_SHAPES, against `_fused_epilogue_plain` and (f32
    operands) `fused_split_plain`, bias and residual as f32 and bf16. Then the f32
    kernel on inf and NaN operands (its non-finite entries torch.matmul
    f32's) and on operands whose lower pieces are bf16 subnormals (logged:
    whether the tensor cores keep them)."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import gemm as g

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=device).manual_seed(97)
    bf, f32 = torch.bfloat16, torch.float32
    for dt, cases, counter, tiles in (
            (bf, shapes, sm90_launches, set(GEMM_SM90_TILES)),
            (f32, f32_shapes, f32x_launches, {GEMM_F32_TILE})):
        widths = set()
        kind = "bf16" if dt == bf else "f32"
        for batch, m, k, n in cases:
            a = torch.randn(batch, m, k, generator=gen, device=device).to(dt)
            b = torch.randn(batch, k, n, generator=gen, device=device).to(dt)
            tile = gemm_tile_n(batch, m, n) if dt == bf else GEMM_F32_TILE
            widths.add(tile)
            for out in (bf, f32):
                before = counter()
                if batch == 1:
                    got = g.matmul(a[0], b[0], out_dtype=out)[None]
                else:
                    got = g.batched_matmul(a, b, out_dtype=out)
                took = counter() - before
                want = g._matmul_plain(a, b, out)
                split = g._matmul_f32_split_plain(a, b, out) if dt == f32 else None
                torch.cuda.synchronize()
                what = (f"wgmma GEMM {kind} {batch}x{m}x{k}x{n} -> "
                        f"{'bf16' if out == bf else 'f32'} (128 x {tile} tiles)")
                if took != 1:
                    raise AssertionError(f"{what}: {took} {kind} wgmma launches "
                                         f"for one call")
                log(f"{what}: {_hold_gemm(what, got, want, out, split)} [{label}]")
        if widths != tiles:
            raise AssertionError(f"the {kind} tile-edge shapes took tile widths "
                                 f"{sorted(widths)}")

    # kernel 15 on the same kernels at their batch-1 edges (and a bf16 one
    # on 128 x 256 tiles, N ending 8 columns into a tile): bias and
    # residual given as f32 and as bf16, each call on its wgmma kernel
    fn = g.matmul_fused_epilogue
    for dt, cases, count, tiles in (
            (bf, shapes + EPILOGUE_WIDE_SHAPES, lambda: fn.sm90_launches,
             set(GEMM_SM90_TILES)),
            (f32, f32_shapes, lambda: fn.f32x_launches, {GEMM_F32_TILE})):
        widths = set()
        kind = "bf16" if dt == bf else "f32"
        for batch, m, k, n in cases:
            if batch != 1:
                continue
            a = torch.randn(m, k, generator=gen, device=device).to(dt)
            b = torch.randn(k, n, generator=gen, device=device).to(dt)
            tile = gemm_tile_n(1, m, n) if dt == bf else GEMM_F32_TILE
            widths.add(tile)
            for side in (f32, bf):
                bias = torch.randn(n, generator=gen, device=device).to(side)
                res = torch.randn(m, n, generator=gen, device=device).to(side)
                for out in (bf, f32):
                    before = count()
                    got = fn(a, b, bias, res, out_dtype=out)
                    took = count() - before
                    want = g._fused_epilogue_plain(a, b, bias, res, out)
                    split = fused_split_plain(a, b, bias, res, out) if dt == f32 else None
                    torch.cuda.synchronize()
                    what = (f"fused epilogue {kind} {m}x{k}x{n}, {str(side)[6:]} bias and "
                            f"residual -> {'bf16' if out == bf else 'f32'} (128 x {tile} "
                            f"tiles)")
                    if took != 1:
                        raise AssertionError(f"{what}: {took} {kind} wgmma launches "
                                             f"for one call")
                    log(f"{what}: {_hold_gemm(what, got, want, out, split)} [{label}]")
        if widths != tiles:
            raise AssertionError(f"the {kind} fused-epilogue edge shapes took tile "
                                 f"widths {sorted(widths)}")

    # inf and NaN: B has bf16 values (zero lower pieces), a row of ones and
    # zeros, where an inf met a zero piece would give NaN
    a = torch.randn(200, 132, generator=gen, device=device)
    b = torch.randn(132, 72, generator=gen, device=device)
    b[:8] = b[:8].bfloat16().float()
    b[8] = 1.0
    b[9, ::3] = 0.0
    a[3, 8], a[5, 9], a[7, 2], a[7, 8], a[11, 4] = (float("inf"), -float("inf"),
                                                    float("inf"), -float("inf"),
                                                    float("nan"))
    b[8, 5], b[2, 6], b[9, 7], b[0, 30] = -float("inf"), float("inf"), float("nan"), float("inf")
    before = f32x_launches()
    got = g.matmul(a, b)
    want = torch.matmul(a, b)
    torch.cuda.synchronize()
    same = all(torch.equal(t(got), t(want))
               for t in (torch.isnan, torch.isposinf, torch.isneginf))
    fin = torch.isfinite(want)
    err = _rel_l2(got[fin], want[fin])
    log(f"f32 wgmma GEMM 200x132x72 with inf and NaN operands: "
        f"{int((~fin).sum())} non-finite entries, the same as torch.matmul f32's: "
        f"{same}; the finite ones rel-L2 {err:.3e} [{label}]")
    if f32x_launches() != before + 1 or not same or not err <= GEMM_F32_TOL:
        raise AssertionError("the f32 wgmma GEMM on inf and NaN operands")
    # A times 2^-120: its mid and lo pieces are bf16 subnormals (the products
    # stay normal f32); a flushed piece would cost ~2^-9 of the product
    a = torch.randn(256, 512, generator=gen, device=device) * 2.0 ** -120
    b = torch.randn(512, 256, generator=gen, device=device)
    got = g.matmul(a, b)
    split = g._matmul_f32_split_plain(a, b, f32)
    want = g._matmul_plain(a, b, f32)
    torch.cuda.synchronize()
    err, err_split = _rel_l2(got, want), _rel_l2(got, split)
    log(f"f32 wgmma GEMM 256x512x256, A times 2^-120 (bf16-subnormal lower "
        f"pieces): rel-L2 {err:.3e} against plain, {err_split:.3e} against the "
        f"split's plain version: the tensor cores "
        f"{'keep' if err_split <= SPLIT_TOL else 'do not keep'} bf16 subnormals "
        f"[{label}]")


def ffma_core(a, b):
    """A closure making one call of the FFMA core (gemm_core.cuh's f32 tile,
    fkp_gemm's aligned path) on f32 a [M, K] @ b [K, N], f32 out: the kernel
    the aligned f32 calls took before the f32 wgmma kernel, called
    directly as a yardstick (no launch counter)."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import _build
    from flashattention_kernel_project_tpu_torch.ops import gemm as g

    m, k = a.shape
    n = b.shape[1]
    c = torch.empty(m, n, dtype=torch.float32, device=a.device)

    def run():
        rc = g._gemm_kernel()(a.data_ptr(), b.data_ptr(), c.data_ptr(), None, None,
                              1, m, n, k, 0, 0, 0, g.PATH_ALIGNED,
                              torch.cuda.current_stream(a.device).cuda_stream)
        _build.check(rc, "gemm (FFMA core)")
        return c
    return run


# the f32 wgmma GEMM's error against the fp64 oracle at two depths: (m, k, n)
GEMM_F32_ORACLE = [(512, 2048, 512), (256, 8192, 256)]


def phase_gemm_f32_times(device, label):
    """The f32 wgmma GEMM at run_all.py's f32 rung (2048^3) and BASELINE
    config 1's shape (1024^3), f32 -> f32, in turns with torch.matmul f32
    (TF32 off) and the FFMA core on the same inputs (`ffma_core`), from CUDA
    graphs, with its bound (six bf16 products at 989 TFLOP/s) and the FFMA
    bound (2*M*N*K at 67 TFLOP/s) beside it; then the error against the
    fp64 oracle (native.gemm) at K = 2048 and K = 8192, of the kernel,
    torch.matmul, the FFMA core and the split's plain version, the
    kernel's held to GEMM_F32_TOL and GEMM_MAX_ABS. Returns {case: row}."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import gemm as g
    from flashattention_kernel_project_tpu_torch.runtime import native
    from flashattention_kernel_project_tpu_torch.utils import platform
    from flashattention_kernel_project_tpu_torch.utils.testing import max_abs_diff

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=device).manual_seed(103)
    rows = {}
    for size in (2048, 1024):
        a = torch.randn(size, size, generator=gen, device=device)
        b = torch.randn(size, size, generator=gen, device=device)
        before = f32x_launches()
        c = g.matmul(a, b)
        if f32x_launches() != before + 1:
            raise AssertionError(f"f32 GEMM {size}^3: the call took another kernel")
        ms = time_turns({"kernel": lambda: g.matmul(a, b),
                         "torch.matmul": lambda: torch.matmul(a, b),
                         "ffma": ffma_core(a, b)}, device)
        flops = 2 * size ** 3
        bnd = bound(6 * flops, nbytes(a, b, c))
        ffma = bound(flops, nbytes(a, b, c), platform.H100_FP32_FLOPS)
        name = f"{size}^3 f32"
        rows[name] = dict(ms=ms["kernel"], library_ms=ms["torch.matmul"],
                          ffma_ms=ms["ffma"], factor=ms["kernel"] / ms["torch.matmul"],
                          bound_share=bnd["bound_ms"] / ms["kernel"],
                          ffma_bound_ms=ffma["bound_ms"], **bnd)
        log(f"f32 wgmma GEMM {name}: {ms['kernel']:.4f} ms, "
            f"torch.matmul f32 {ms['torch.matmul']:.4f} ms "
            f"({ms['kernel'] / ms['torch.matmul']:.2f}x), the FFMA core "
            f"{ms['ffma']:.4f} ms; bound {bnd['bound_ms']:.4f} ms (six bf16 "
            f"products; {100 * bnd['bound_ms'] / ms['kernel']:.1f}% of it), FFMA "
            f"bound {ffma['bound_ms']:.4f} ms; {flops / ms['kernel'] / 1e9:.1f} "
            f"TFLOP/s of f32 product [{label}]")
    for m, k, n in GEMM_F32_ORACLE:
        a = torch.randn(m, k, generator=gen, device=device)
        b = torch.randn(k, n, generator=gen, device=device)
        outs = {"kernel": g.matmul(a, b), "torch.matmul": torch.matmul(a, b),
                "ffma": ffma_core(a, b)(),
                "split plain": g._matmul_f32_split_plain(a, b, torch.float32)}
        torch.cuda.synchronize()
        exact = native.gemm(a.cpu().numpy(), b.cpu().numpy())
        err = {key: (float(np.linalg.norm(v.cpu().numpy() - exact) / np.linalg.norm(exact)),
                     max_abs_diff(v.cpu().numpy(), exact)) for key, v in outs.items()}
        rows[f"oracle {m}x{k}x{n}"] = {key: dict(rel_l2=e, max_abs=x)
                                       for key, (e, x) in err.items()}
        log(f"f32 GEMM {m}x{k}x{n} against the fp64 oracle (rel-L2, max-abs): "
            + ", ".join(f"{key} {e:.3e} / {x:.3e}" for key, (e, x) in err.items())
            + f" [{label}]")
        e, x = err["kernel"]
        if not (e <= GEMM_F32_TOL and x <= GEMM_MAX_ABS):
            raise AssertionError(f"f32 wgmma GEMM {m}x{k}x{n}: rel-L2 {e:.3e}, "
                                 f"max-abs {x:.3e} against the fp64 oracle")
    return rows


def phase_gemm_sm90_times(device, label):
    """The wgmma GEMM's time at run_all.py's rungs (4096^3 bf16 -> bf16 and
    -> f32, 8 x 1024^3 bf16 -> bf16), each in turns with torch.matmul or
    torch.bmm (bf16 out) on the same inputs, from CUDA graphs, with its
    bound (2*M*N*K flops at 989 TFLOP/s, or the bytes), factor and share
    of the bound. Returns {case: row}."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import gemm as g

    gen = torch.Generator(device=device).manual_seed(101)
    bf, f32 = torch.bfloat16, torch.float32
    a = torch.randn(4096, 4096, generator=gen, device=device).to(bf)
    b = torch.randn(4096, 4096, generator=gen, device=device).to(bf)
    ab = torch.randn(8, 1024, 1024, generator=gen, device=device).to(bf)
    bb = torch.randn(8, 1024, 1024, generator=gen, device=device).to(bf)
    cases = [
        ("4096^3 -> bf16", lambda: g.matmul(a, b, out_dtype=bf),
         lambda: torch.matmul(a, b), (a, b), bf, 1),
        ("4096^3 -> f32", lambda: g.matmul(a, b, out_dtype=f32),
         lambda: torch.matmul(a, b), (a, b), f32, 1),
        ("8 x 1024^3 -> bf16", lambda: g.batched_matmul(ab, bb, out_dtype=bf),
         lambda: torch.bmm(ab, bb), (ab, bb), bf, 8),
    ]
    rows = {}
    for name, kernel, library, (x, y), out, batch in cases:
        before = sm90_launches()
        c = kernel()
        if sm90_launches() != before + 1:
            raise AssertionError(f"wgmma GEMM {name}: the call took another kernel")
        ms, lib_ms = time_pair(kernel, library, device)
        flops = 2 * x.numel() * y.shape[-1]
        bnd = bound(flops, nbytes(x, y, c))
        tile = gemm_tile_n(batch, x.shape[-2], y.shape[-1])
        rows[name] = dict(ms=ms, library_ms=lib_ms, factor=ms / lib_ms,
                          bound_share=bnd["bound_ms"] / ms, tile_n=tile, **bnd)
        log(f"wgmma GEMM {name} (128 x {tile} tiles): {ms:.4f} ms, "
            f"{'torch.bmm' if batch > 1 else 'torch.matmul'} (bf16 out) "
            f"{lib_ms:.4f} ms ({ms / lib_ms:.2f}x), bound {bnd['bound_ms']:.4f} ms "
            f"({bnd['bound_by']}; {100 * bnd['bound_ms'] / ms:.1f}% of it), "
            f"{flops / ms / 1e9:.1f} TFLOP/s [{label}]")
    return rows


# (b, hq, hkv, n, s, d, causal, q_offset, window, sinks) at the edges of the
# dense forward's 128-row and 128-key tiles
FWD_TILE_SHAPES = [
    (1, 2, 1, 200, 333, 128, False, 0, 0, 0),    # n, s not multiples of 128
    (2, 4, 2, 200, 333, 64, False, 0, 0, 0),
    (1, 4, 2, 1000, 1000, 128, True, 0, 0, 0),   # 1000 causal
    (1, 2, 1, 130, 300, 64, True, 170, 0, 0),    # q_offset with n < s
    (1, 4, 2, 300, 700, 128, True, 400, 0, 0),
    (1, 4, 2, 1024, 1024, 128, True, 0, 256, 200),  # sinks wider than a tile
    (1, 4, 2, 1024, 1024, 64, True, 0, 256, 200),
    (1, 2, 1, 256, 256, 64, True, 0, 100, 150),
    (1, 2, 1, 100, 100, 128, True, -50, 0, 0),   # rows before the first key
]


def phase_fwd_tiles(device, label, shapes=FWD_TILE_SHAPES):
    """The dense forward (kernels 1 and 2) at the edges of its tiles (query
    blocks of 64 or 128 rows, 128-key tiles), in each discipline, against
    `_fwd_plain` (O rel-L2 O_TOL, LSE LSE_TOL) and, at most 4 x 256 x 256
    (query, key) pairs, O against the float64 oracle. Each shape runs as
    given (64-row blocks: its grid fits one wave of the SMs) and again
    with enough batch rows that it does not (128-row blocks). Then the
    hybrid on mixed inputs, where one warp's 16 rows of each 64-row
    warpgroup breach the fixed-max bound (q x 60) and the rest are
    bounded, at d 128 and 64."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import flash_attention as fa
    from flashattention_kernel_project_tpu_torch.utils import oracles

    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(83)
    names = {fa.ONLINE: "stable", fa.FIXED: "fixed-max", fa.HYBRID: "hybrid"}
    worst = {name: 0.0 for name in names.values()}
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    runs = []
    for b, hq, hkv, n, s, d, causal, q_off, win, sinks in shapes:
        wide = sms // (-(-n // 64) * hq) + 1  # batch rows past one wave
        if dense_rows(n, hq, b, sms) != 64:
            raise AssertionError(f"tile shape n{n} hq{hq} b{b} is past one wave")
        runs += [(b, hq, hkv, n, s, d, causal, q_off, win, sinks),
                 (wide, hq, hkv, n, s, d, causal, q_off, win, sinks)]
    for b, hq, hkv, n, s, d, causal, q_off, win, sinks in runs:
        q, k, v = _qkv(gen, device, b, hq, hkv, n, s, d)
        small = b * hq * n * s <= 4 * 256 * 256
        exp = None
        if small:
            exp = torch.from_numpy(oracles.gqa_attention(
                *(x.float().cpu().numpy() for x in (q, k, v)), causal=causal,
                q_offset=q_off, window=win or None, sinks=sinks))
        for disc, name in names.items():
            k_max = fa.k_max_norm(k) if disc == fa.HYBRID else None
            args = (q, k, v, causal, d ** -0.5, q_off, win, sinks, disc, k_max)
            o, lse = fa._fwd(*args)
            po, plse = fa._fwd_plain(*args)
            torch.cuda.synchronize()
            what = (f"flash_fwd ({name}) b{b} hq{hq} hkv{hkv} n{n} s{s} d{d} "
                    f"causal={causal} q_offset={q_off} window={win} sinks={sinks} "
                    f"rows={dense_rows(n, hq, b, sms)}")
            if not (torch.isfinite(o).all() and torch.isfinite(lse).all()):
                raise AssertionError(f"{what}: non-finite output")
            err = _rel_l2(o, po)
            if not err <= O_TOL:
                raise AssertionError(f"{what}: O rel-L2 {err:.3e} > {O_TOL}")
            torch.testing.assert_close(lse, plse, rtol=LSE_TOL, atol=LSE_TOL)
            worst[name] = max(worst[name], err)
            if exp is not None:
                oerr = _rel_l2(o, exp)
                if not oerr <= O_TOL:
                    raise AssertionError(f"{what}: rel-L2 {oerr:.3e} from the "
                                         "float64 oracle")
    checks = []
    for d, b in ((128, 1), (128, 3), (64, 1), (64, 3)):  # 64- and 128-row blocks
        hq, hkv, n = 4, 2, 1024
        q, k, v = _qkv(gen, device, b, hq, hkv, n, n, d)
        r = torch.arange(n, device=device) % 128
        breach = ((r >= 16) & (r < 32)) | ((r >= 96) & (r < 112))
        q = torch.where(breach[:, None], q.float() * 60.0, q.float()).bfloat16()
        k_max = fa.k_max_norm(k)
        share = float(fa._fixed_rows(q, d ** -0.5, fa.HYBRID, k_max).float().mean())
        if not 0.0 < share < 1.0:
            raise AssertionError(f"hybrid mixed inputs at d={d}: fixed-max share "
                                 f"{share}")
        args = (q, k, v, True, d ** -0.5, 0, 0, 0, fa.HYBRID, k_max)
        o, lse = fa._fwd(*args)
        po, plse = fa._fwd_plain(*args)
        err = _rel_l2(o, po)
        if not err <= O_TOL:
            raise AssertionError(f"hybrid mixed inputs at d={d}: O rel-L2 {err:.3e}")
        torch.testing.assert_close(lse, plse, rtol=LSE_TOL, atol=LSE_TOL)
        checks.append(f"d={d} rows={dense_rows(n, hq, b, sms)} {err:.3e} "
                      f"({share:.3f} of the rows fixed-max)")
    log(f"dense forward at tile edges ({len(shapes)} shapes, each in blocks of 64 "
        f"and 128 rows, three disciplines; the oracle at <= 4x256x256 pairs): "
        f"worst O rel-L2 vs plain "
        + ", ".join(f"{name} {e:.3e}" for name, e in worst.items())
        + "; LSE ok; hybrid with one breaching warp a warpgroup: "
        + ", ".join(checks) + f" ({time.perf_counter() - t0:.1f} s) [{label}]")


def phase_fwd_sm90_times(device, label):
    """The dense forward's time at the shapes its callers give it, each in
    turns with SDPA at the same shape (the windowed case: SDPA with the
    band as a boolean mask), from CUDA graphs: every discipline at bench.py's
    shape (1 x 16/4 heads x 4096 x 128, causal; stable and fixed-max also
    non-causal, profile_attention.py's shape), d=64 (stable, kernel 2's
    packed fixed-max call, hybrid), the training band (4096, window 1024,
    64 sinks) and the serving prefill (512). Each with its bound (the
    visible pairs' 4*d flops at 989 TFLOP/s, or the bytes), its factor
    against SDPA and its share of the bound. Returns {case: row}."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(89)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    cases = [  # name, (n, d, causal, window, sinks), disc, pack
        ("stable", (4096, 128, True, 0, 0), fa.ONLINE, False),
        ("fixed-max", (4096, 128, True, 0, 0), fa.FIXED, False),
        ("hybrid (headline)", (4096, 128, True, 0, 0), fa.HYBRID, False),
        ("stable, full", (4096, 128, False, 0, 0), fa.ONLINE, False),
        ("fixed-max, full", (4096, 128, False, 0, 0), fa.FIXED, False),
        ("stable d=64", (4096, 64, True, 0, 0), fa.ONLINE, False),
        ("packed d=64 (kernel 2)", (4096, 64, True, 0, 0), fa.FIXED, True),
        ("hybrid d=64", (4096, 64, True, 0, 0), fa.HYBRID, False),
        ("stable, window 1024 + 64 sinks", (4096, 128, True, 1024, 64),
         fa.ONLINE, False),
        ("stable, serving prefill 512", (512, 128, True, 0, 0), fa.ONLINE, False),
        ("fixed-max, serving prefill 512", (512, 128, True, 0, 0), fa.FIXED,
         False),
    ]
    inputs, rows = {}, {}
    for name, shape, disc, pack in cases:
        n, d, causal, win, sinks = shape
        if shape not in inputs:
            inputs[shape] = _qkv(gen, device, 1, 16, 4, n, n, d)
        q, k, v = inputs[shape]
        k_max = fa.k_max_norm(k) if disc == fa.HYBRID else None
        kernel = lambda: fa._fwd(q, k, v, causal, d ** -0.5, 0, win, sinks,  # noqa: E731
                                 disc, k_max, pack)
        mask = band_mask(n, n, 0, win, sinks, device) if win else None
        ms, sdpa_ms = time_pair(kernel, sdpa_fn(q, k, v, mask=mask,
                                                causal=causal and not win),
                                device)
        pairs = 16 * band_pairs(n, n, 0, win, sinks) if causal else 16 * n * n
        o, lse = kernel()
        bnd = bound(4 * d * pairs, nbytes(q, k, v, o, lse))
        rows[name] = dict(ms=ms, sdpa_ms=sdpa_ms, factor=ms / sdpa_ms,
                          bound_share=bnd["bound_ms"] / ms, **bnd)
        log(f"dense forward, {name} (1x16/4x{n}x{d}, blocks of "
            f"{dense_rows(n, 16, 1, sms)} rows): {ms:.4f} ms, SDPA "
            f"{sdpa_ms:.4f} ms ({ms / sdpa_ms:.2f}x), bound "
            f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}; "
            f"{100 * bnd['bound_ms'] / ms:.1f}% of it), "
            f"{4 * d * pairs / ms / 1e9:.1f} TFLOP/s [{label}]")
    log(f"dense forward timed at {len(cases)} cases in "
        f"{time.perf_counter() - t0:.1f} s")
    return rows


# The bf16 linear decode's instances (csrc/flash_decode_sm90.cuh: d, G,
# window), built in flash_decode_sm90.cu's object
DEC_OBJECT = "flash_decode_sm90.cu"
DEC_KERNEL = "flash_decode_sm90_kernel"
DEC_SOURCE = f"{PKG}/csrc/flash_decode_sm90.cuh"
# (b, hq, hkv, s, d, lengths, n_splits, window, sinks) at the edges of the
# decode's 64-key tiles and splits: lengths about a tile with S off the
# tile and one above S (clamped), every G at both d (the default splits:
# two of 128 keys, merged on the card); a caller's 3 splits of 67 keys;
# one split (normalised in the block); 300 splits of 2 keys (the merge
# holds 256 splits at a time); a window of 70 with 66 sinks, both wider
# than a tile, at 2 splits of 150 keys (the length-200 row's first split
# holds the sinks and the band's start with a gap: two ranges), at 3 and
# at the default
EDGE_LENS = [0, 1, 63, 64, 65, 127, 200, 999]
WIN_LENS = [0, 1, 50, 66, 136, 137, 200, 250, 300]
DEC_EDGE_SHAPES = (
    [(8, hq, hkv, 200, d, EDGE_LENS, None, 0, 0)
     for d in (64, 128) for hq, hkv in ((2, 2), (4, 2), (16, 4), (8, 1))]
    + [(8, 16, 4, 200, d, EDGE_LENS, 3, 0, 0) for d in (64, 128)]
    + [(8, 16, 4, 200, 128, EDGE_LENS, 1, 0, 0),
       (2, 8, 1, 600, 64, [599, 600], 300, 0, 0)]
    + [(9, hq, hkv, 300, d, WIN_LENS, n, 70, 66)
       for hq, hkv, d in ((2, 2, 64), (8, 1, 128), (16, 4, 128))
       for n in (None, 2, 3)])


def phase_dec_sm90_build(build_log: str, label):
    """The bf16 decode's 16 instances (d 64 and 128, G 1, 2, 4 and 8,
    without and with a window) through `wgmma_gate` with mma.sync in place
    of wgmma: built with no spill, in flash_decode_sm90.cu's object, with
    UTMALDG (the TMA ring) and HMMA.16816 (both products) in each SASS."""
    counts = wgmma_gate(build_log, DEC_KERNEL, template_args(DEC_KERNEL, 3),
                        {DEC_OBJECT: lambda inst: True},
                        {(d, g, w) for d in (64, 128) for g in (1, 2, 4, 8)
                         for w in (0, 1)},
                        need=("UTMALDG", "HMMA.16816"), forbid=())
    log("bf16 decode: 16 instances (d, G, window) built with no spill; SASS "
        "(UTMALDG, HMMA.16816): "
        + ", ".join(f"{inst}: {c['UTMALDG']}/{c['HMMA.16816']}"
                    for inst, c in sorted(counts.items())) + f" [{label}]")


# kernel 7, the 8-bit linear decode (flash_decode_sm90.cuh's 8-bit kernel):
# int8 instances in flash_decode_q.cu, e4m3 in flash_decode_q_fp8.cu
DEC_Q_KERNEL = "flash_decode_q_sm90_kernel"
DEC_Q_OBJECTS = {"flash_decode_q.cu": "int8", "flash_decode_q_fp8.cu": "e4m3"}
DEC_Q_SOURCE = f"{PKG}/csrc/flash_decode_q.cu"


def dec_q_instance(sym: str):
    """(d, G, cache, window) of a flash_decode_q_sm90_kernel instance's
    symbol, or None for another symbol."""
    name, rest = mangled_name(sym)
    if name != DEC_Q_KERNEL:
        return None
    m = re.match(r"ILi(\d+)ELi(\d+)E(a|13__nv_fp8_e4m3)Lb([01])E", rest)
    return (int(m.group(1)), int(m.group(2)),
            "int8" if m.group(3) == "a" else "e4m3", int(m.group(4)))


def phase_dec_q_build(build_log: str, label):
    """Kernel 7's 32 instances (d 64 and 128, G 1, 2, 4 and 8, int8 and
    e4m3, without and with a window) through `wgmma_gate` with mma.sync in
    place of wgmma: built with no spill, each type in its source's object,
    with UTMALDG (the TMA ring) and HMMA.16816 (both products) and no
    local load or store in each SASS."""
    counts = wgmma_gate(build_log, DEC_Q_KERNEL, dec_q_instance,
                        {src: (lambda inst, kv=kv: inst[2] == kv)
                         for src, kv in DEC_Q_OBJECTS.items()},
                        {(d, g, kv, w) for d in (64, 128) for g in (1, 2, 4, 8)
                         for kv in DEC_Q_OBJECTS.values() for w in (0, 1)},
                        need=("UTMALDG", "HMMA.16816"), forbid=("LDL", "STL"))
    regs = ptxas_registers(build_log, dec_q_instance)
    log("8-bit linear decode (kernel 7): 32 instances (d, G, cache, window) "
        "built with no spill, no local load or store; SASS (UTMALDG, "
        "HMMA.16816): " + ", ".join(
            f"{inst}: {c['UTMALDG']}/{c['HMMA.16816']}"
            for inst, c in sorted(counts.items()))
        + "; registers: " + ", ".join(f"{inst}: {r}" for inst, r in sorted(regs.items()))
        + f" [{label}]")


def time_turns(fns: dict, device, iters: int = 50) -> dict:
    """Each closure's ms from CUDA graphs, measured in turns: in order and
    then in reverse order, the smaller of its two."""
    first = {k: time_ms(f, device, iters, graph=True) for k, f in fns.items()}
    second = {k: time_ms(fns[k], device, iters, graph=True)
              for k in reversed(list(fns))}
    return {k: min(first[k], second[k]) for k in fns}


def graph_device_ops(fn) -> list:
    """The device operations (kernels, memsets, copies) one call of fn
    enqueues, read from the nodes of a CUDA graph that captures the call
    (through the driver's cuGraphGetNodes / cuGraphNodeGetType), after a
    warm-up call. Exact and independent of CUPTI; nodes are named by
    type only."""
    import ctypes

    import torch

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        fn()
    torch.cuda.synchronize()
    cu = ctypes.CDLL("libcuda.so.1")
    graph = ctypes.c_void_p(g.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(graph, None, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * max(n.value, 1))()
    if cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    kinds = {0: "kernel", 1: "memcpy", 2: "memset"}  # CUgraphNodeType
    ops = []
    for node in nodes[:n.value]:
        kind = ctypes.c_int(-1)
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) != 0:
            raise RuntimeError("cuGraphNodeGetType failed")
        if kind.value in kinds:
            ops.append(f"graph {kinds[kind.value]} node")
    del g
    return ops


def device_ops(fn) -> list:
    """The names of the device operations (kernels, memsets, copies) one
    call of fn enqueues, from torch.profiler, after a warm-up call. A
    profiling window that records no device operation at all (seen in a
    process that had profiled many times before, on calls whose kernel
    ran) is taken again, up to three times; if none records one, the
    operations are counted from the nodes of a CUDA graph that captures
    the call (`graph_device_ops`), which is exact."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ops = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        if ops:
            return ops
        log("device_ops: the profiler recorded no device operation; again")
    ops = graph_device_ops(fn)
    log(f"device_ops: counted from a captured CUDA graph's nodes: {ops}")
    return ops


def dec_edges(device, label, shapes=DEC_EDGE_SHAPES):
    """flash_decode (one launch, the splits merged on the card) and the
    kernel's partials through `merge_partials` against the plain version at
    `shapes` (rel-L2 1e-2); a row of length 0 exactly 0; a length above S
    bit-equal to S. Returns the largest max-abs error."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import flash_decode as fd

    gen = torch.Generator(device=device).manual_seed(13)
    worst = 0.0
    for b, hq, hkv, s, d, lens, n_splits, window, sinks in shapes:
        q = torch.randn(b, hq, d, generator=gen, device=device).bfloat16()
        k = torch.randn(b, hkv, s, d, generator=gen, device=device).bfloat16()
        v = torch.randn(b, hkv, s, d, generator=gen, device=device).bfloat16()
        lengths = torch.tensor(lens, dtype=torch.int32, device=device)
        kw = dict(n_splits=n_splits, window=window or None, sinks=sinks)
        n = n_splits or fd.default_n_splits(b, hkv, s, d)
        block_s = fd.default_block_s(s, n) if n_splits is None else -(-s // n)
        args = (q, k, v, lengths, n, block_s, d ** -0.5, window, sinks)
        o = fd.flash_decode(q, k, v, lengths, **kw)
        merged = fd.merge_partials(*fd._decode_partials_cuda(*args)).reshape(b, hq, d)
        po = fd._decode_plain(*args)
        clamped = fd.flash_decode(q, k, v, lengths.clamp(max=s), **kw)
        torch.cuda.synchronize()
        what = (f"flash_decode edge b{b} hq{hq} hkv{hkv} s{s} d{d} {n} splits "
                f"of {block_s} lengths {lens} window {window} sinks {sinks}")
        assert o.shape == q.shape and torch.isfinite(o).all(), what
        for name, got in (("whole call", o), ("kernel partials + plain merge", merged)):
            err = _rel_l2(got, po)
            if not err <= O_TOL:
                raise AssertionError(f"{what}: {name} rel-L2 {err:.3e} > {O_TOL}")
        empty = [i for i, n_b in enumerate(lens) if n_b == 0]
        if any(float(o[i].float().abs().max()) != 0.0 for i in empty):
            raise AssertionError(f"{what}: a row of length 0 is not 0")
        if not torch.equal(o, clamped):
            raise AssertionError(f"{what}: a length above S differs from S")
        worst = max(worst, float((o.float() - po.float()).abs().max()))
        log(f"{what}: rel-L2 {_rel_l2(o, po):.3e} (partials "
            f"{_rel_l2(merged, po):.3e}) [{label}]")
    return worst


# (b, hq, hkv, s, d, lengths, n_splits, window, sinks) at the edges of
# kernel 7's tiles and splits: lengths 0, 1, 63, 64, 65 and S with S off the
# tile, G 1, 2, 4 and 8, d 64 and 128, the default splits (whole tiles), a
# caller's three (off the tile), a window wider than a tile with sinks past
# one, and one split
DEC_Q_EDGE_SHAPES = (
    [(6, hq, hkv, 200, d, [0, 1, 63, 64, 65, 200], n, window, sinks)
     for d in (64, 128) for hq, hkv in ((2, 2), (4, 2), (4, 1), (8, 1))
     for n, window, sinks in ((None, 0, 0), (3, 0, 0), (None, 70, 66))]
    + [(3, 8, 8, 301, 128, [301, 300, 17], 1, 0, 0)])


def dec_q_edges(device, label, shapes=DEC_Q_EDGE_SHAPES):
    """Kernel 7 (flash_decode_int8, one launch, the splits merged on the
    card) and its partials through `merge_partials` against the plain
    version at `shapes`, int8 and e4m3 (rel-L2 1e-2); a row of length 0
    exactly 0; a length above S bit-equal to S. Returns the largest max-abs
    error."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import flash_decode as fd

    gen = torch.Generator(device=device).manual_seed(17)
    worst = 0.0
    for fmt in FMTS:
        for b, hq, hkv, s, d, lens, n_splits, window, sinks in shapes:
            q = torch.randn(b, hq, d, generator=gen, device=device).bfloat16()
            k, ks = quantized(gen, device, (b, hkv, s, d), fmt)
            v, vs = quantized(gen, device, (b, hkv, s, d), fmt)
            lengths = torch.tensor(lens, dtype=torch.int32, device=device)
            kw = dict(n_splits=n_splits, window=window or None, sinks=sinks)
            n = n_splits or fd.q_n_splits(b, hkv, s, d)
            block_s = fd.default_block_s(s, n) if n_splits is None else -(-s // n)
            args = (q, k, ks, v, vs, lengths, n, block_s, d ** -0.5, window,
                    sinks)
            o = fd.flash_decode_int8(q, k, ks, v, vs, lengths, **kw)
            merged = fd.merge_partials(*fd._decode_partials_q_cuda(*args))
            po = fd._decode_q_plain(*args)
            over = fd.flash_decode_int8(q, k, ks, v, vs, lengths + s, **kw)
            at_s = fd.flash_decode_int8(q, k, ks, v, vs,
                                        torch.full_like(lengths, s), **kw)
            torch.cuda.synchronize()
            what = (f"flash_decode_q {fmt} edge b{b} hq{hq} hkv{hkv} s{s} d{d} "
                    f"{n} splits of {block_s} lengths {lens} window {window} "
                    f"sinks {sinks}")
            assert o.shape == q.shape and torch.isfinite(o).all(), what
            for name, got in (("whole call", o), ("kernel partials + plain merge",
                                                  merged.reshape(b, hq, d))):
                err = _rel_l2(got, po)
                if not err <= O_TOL:
                    raise AssertionError(f"{what}: {name} rel-L2 {err:.3e} > {O_TOL}")
            if any(float(o[i].float().abs().max()) != 0.0
                   for i, n_b in enumerate(lens) if n_b == 0):
                raise AssertionError(f"{what}: a row of length 0 is not 0")
            if not torch.equal(over, at_s):
                raise AssertionError(f"{what}: a length above S differs from S")
            worst = max(worst, float((o.float() - po.float()).abs().max()))
            log(f"{what}: rel-L2 {_rel_l2(o, po):.3e} (partials "
                f"{_rel_l2(merged.reshape(b, hq, d), po):.3e}) [{label}]")
    return worst


def phase_decode(device, b, hq, hkv, s, d, label):
    """The bf16 decode (csrc/flash_decode_sm90.cuh) against the plain
    version: at the serving shape, ragged lengths with one slot empty and
    one full, then at the edges of its tiles and splits (`dec_edges`); the
    device operations of one call (at most two, the split merge on the
    card); the kernel alone (its partials), the whole call and SDPA with a
    length mask timed in turns from CUDA graphs."""
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
    n_splits = fd.default_n_splits(b, hkv, s, d)
    block_s = fd.default_block_s(s, n_splits)
    args = (q, k, v, lengths, n_splits, block_s, d ** -0.5)

    o = fd.flash_decode(q, k, v, lengths)
    po = fd._decode_plain(*args)
    if device.type == "cuda":
        torch.cuda.synchronize()
    assert o.shape == q.shape and torch.isfinite(o).all()
    assert float(o[0].float().abs().max()) == 0.0  # the empty slot
    err = _rel_l2(o, po)
    max_abs = float((o.float() - po.float()).abs().max())
    if not err <= O_TOL:
        raise AssertionError(f"flash_decode rel-L2 {err:.3e} > {O_TOL}")
    if device.type != "cuda":  # a CPU rehearsal: the plain path alone
        return dict(name="flash_decode", max_abs_err=max_abs)
    max_abs = max(max_abs, dec_edges(device, label))
    ops = device_ops(lambda: fd.flash_decode(q, k, v, lengths))
    if not 1 <= len(ops) <= 2:
        raise AssertionError(f"one flash_decode call ran {len(ops)} device "
                             f"operations (at most 2): {ops}")
    graph_ops = graph_device_ops(lambda: fd.flash_decode(q, k, v, lengths))
    if not 1 <= len(graph_ops) <= 2:
        raise AssertionError(f"a captured flash_decode call holds "
                             f"{len(graph_ops)} device operations (at most 2): "
                             f"{graph_ops}")
    mask = (torch.arange(s, device=device)[None, :] < lengths[:, None])
    times = time_turns({
        "sdpa": sdpa_fn(q[:, :, None], k, v, mask=mask[:, None, None]),
        "kernel": lambda: fd._decode_partials_cuda(*args),
        "call": lambda: fd.flash_decode(q, k, v, lengths)}, device)
    plain_ms = time_ms(lambda: fd._decode_plain(*args), device, iters=50,
                       graph=True)
    live = int(lengths.sum())
    gbytes = 2 * live * hkv * d * 2 / 1e9  # K and V rows read
    # the decode's work: q, the live K/V rows and o; QK and PV per live key
    bnd = bound(4 * live * hq * d, nbytes(q, o) + 2 * live * hkv * d * 2)
    log(f"flash_decode b{b} hq{hq} hkv{hkv} s{s} d{d} {n_splits} splits of "
        f"{block_s} lengths={lengths.tolist()}: rel-L2 {err:.3e}, max-abs "
        f"{max_abs:.3e} (the edge shapes included) | device operations of a "
        f"call: {ops} | in turns from CUDA graphs: kernel (partials) "
        f"{times['kernel']:.4f} ms ({gbytes / times['kernel'] * 1e3:.1f} GB/s "
        f"of live K/V), whole call {times['call']:.4f} ms, SDPA with a length "
        f"mask {times['sdpa']:.4f} ms ({times['call'] / times['sdpa']:.2f}x) | "
        f"plain {plain_ms:.4f} ms | bound {bnd['bound_ms']:.4f} ms "
        f"({bnd['bound_by']}, {bnd['bound_ms'] / times['call']:.1%} of the "
        f"call) [{label}]")
    return dict(name="flash_decode", route="cuda", source=DEC_SOURCE,
                replaces="flashattention_kernel_project_tpu/ops/flash_decode.py:38",
                max_abs_err=max_abs, ms=times["call"], kernel_ms=times["kernel"],
                plain_ms=plain_ms, library_ms=times["sdpa"], **bnd,
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
                 slab_source=f"{PKG}/csrc/ragged_slab.cu",
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
    ragged_verify(device, entry, None, label)
    ragged_edges(device, entry, None, label)
    return entry


# The ragged forward's two routes (ops.paged_decode.ragged_plan): chunks of
# T < 9 on the slab route (csrc/ragged_slab.cu, the paged extend's block
# over the linear cache), longer ones on the wgmma route
# (csrc/flash_fwd_ragged.cu, the dense forward's kernel in its ragged
# flavour). RAGGED_VERIFY is the linear speculative verify (T = spec_k + 1)
# at the serving cache (S_max 2048) with EXT_SERVING's old lengths as the
# q offsets: (b, hq, hkv, t, s_max, kv_lens, q_offsets, d).
_VERIFY_OLD = [0, 1, 124, 127, 128, 700, 1500, 2043]
RAGGED_VERIFY = (8, 16, 4, 5, 2048, [n + 5 for n in _VERIFY_OLD], _VERIFY_OLD,
                 128)
# (b, hq, hkv, t, s_max, kv_lens, q_offsets, d) at the edges of each route's
# tiles and splits: kv_len 0, 1, 63, 64, 65, at a split boundary (the
# verify's 8 splits of 256; 1000 rows: 8 splits of 128) and at S_max, S_max
# not a multiple of 64, q offsets before the cache and off kv_len - T, G 16
# x T 8 (two row tiles of the slab route), T 1, d 64 on both routes, the
# threshold's neighbours T 8 (slab) and 9 (wgmma), short chunks on the
# wgmma route (G 8 x T 9, T 15, 16), blocks of 128 rows, a chunk of 200
# over 333 rows
RAGGED_EDGES = (
    (8, 16, 4, 5, 2048, [0, 1, 63, 64, 65, 256, 257, 2048],
     [-5, -4, 58, 59, 60, 251, 252, 2043], 128),
    (8, 16, 4, 5, 1000, [0, 1, 63, 64, 65, 128, 129, 1000],
     [-3, 0, 60, 30, 60, 123, 100, 995], 128),
    (4, 16, 4, 9, 1000, [0, 65, 500, 1000], [-9, 10, 200, 991], 64),
    (2, 16, 2, 9, 1024, [1, 1024], [0, 1015], 128),
    (2, 32, 2, 8, 1024, [1, 1024], [0, 1016], 128),
    (4, 16, 4, 8, 1000, [0, 65, 500, 1000], [-8, 10, 200, 992], 64),
    (1, 16, 4, 8, 2304, [520], [512], 128),
    (1, 16, 4, 9, 2304, [521], [512], 128),
    (8, 16, 4, 1, 2048, [1, 63, 64, 65, 256, 257, 1500, 2048],
     [0, 62, 63, 64, 255, 256, 1499, 2047], 128),
    (1, 16, 4, 15, 2304, [527], [512], 128),
    (2, 16, 4, 16, 2304, [528, 0], [512, -16], 128),
    (6, 16, 4, 64, 1000, [0, 1, 63, 64, 65, 1000], [-64, -63, 0, 0, 1, 936], 128),
    (2, 16, 4, 200, 333, [333, 65], [133, -135], 64),
    (8, 16, 4, 256, 2048, [256, 300, 511, 512, 513, 1000, 1500, 2048],
     [0, 44, 255, 256, 257, 744, 1244, 1792], 128),
    (2, 4, 2, 100, 333, [333, 65], [233, -35], 64),
)
# the flavours each edge shape runs: causal; not causal; a band of 70 keys
# with 66 sinks (a sink tile and a band that cuts a 64-key tile); fixed-max
RAGGED_FLAVOURS = (dict(), dict(causal=False), dict(window=70, sinks=66),
                   dict(stable=False))


def _ragged_inputs(gen, device, shape, fmt):
    """(q, cache, kv_lens, q_offsets) of a ragged call at `shape`: cache
    (k, v) bf16, or (k_q, k_scale, v_q, v_scale) in `fmt`."""
    import torch

    b, hq, hkv, t, s, lens, offs, d = shape
    q = torch.randn(b, hq, t, d, generator=gen, device=device).bfloat16()
    if fmt is None:
        cache = tuple(torch.randn(b, hkv, s, d, generator=gen,
                                  device=device).bfloat16() for _ in range(2))
    else:
        cache = (*quantized(gen, device, (b, hkv, s, d), fmt),
                 *quantized(gen, device, (b, hkv, s, d), fmt))
    return (q, cache, torch.tensor(lens, dtype=torch.int32, device=device),
            torch.tensor(offs, dtype=torch.int32, device=device))


def _ragged_fns(q, cache, kv_lens, q_offsets, kw):
    """(the wrapper's call, its plain version, the wrapper) of a ragged call
    with flash_attention_ragged's keywords `kw`."""
    from flashattention_kernel_project_tpu_torch.ops import flash_attention as fa

    causal = kw.get("causal", True)
    window, sinks = fa._band(causal, kw.get("window"), kw.get("sinks", 0))
    disc = fa._ragged_discipline(kw.get("stable", True))
    rest = (kv_lens, q_offsets, causal, q.shape[-1] ** -0.5, window, sinks, disc)
    if len(cache) == 2:
        wrapper = fa.flash_attention_ragged
        return ((lambda: wrapper(q, *cache, kv_lens, q_offsets, **kw)),
                (lambda: fa._fwd_ragged_plain(q, *cache, *rest)), wrapper)
    wrapper = fa.flash_attention_ragged_kv_quant
    return ((lambda: wrapper(q, *cache, kv_lens, q_offsets, **kw)),
            (lambda: fa._fwd_ragged_q_plain(q, *cache, *rest)), wrapper)


def ragged_hold(what, o, po, kv_lens, q_offsets, kw):
    """A ragged call's output against its plain version, batch row by batch
    row (rel-L2 O_TOL where the row sees a key), every query row that sees
    no key exactly 0. Returns the largest max-abs error."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import flash_attention as fa

    torch.cuda.synchronize()
    assert o.shape == po.shape and o.dtype == torch.bfloat16, what
    if not torch.isfinite(o).all():
        raise AssertionError(f"{what}: non-finite output")
    causal = kw.get("causal", True)
    window, sinks = fa._band(causal, kw.get("window"), kw.get("sinks", 0))
    sees = fa._ragged_mask(o.shape[2], int(kv_lens.max().clamp(min=1)) + 1,
                           kv_lens, q_offsets, causal, window, sinks).any(-1)
    dead = ~sees.expand(-1, o.shape[1], -1)  # [B, Hq, T]: rows that see no key
    if dead.any() and float(o[dead].float().abs().max()) != 0.0:
        raise AssertionError(f"{what}: a row that sees no key is not 0")
    for row in range(o.shape[0]):
        if dead[row].all():
            continue
        err = _rel_l2(o[row], po[row])
        if not err <= O_TOL:
            raise AssertionError(f"{what}: batch row {row} rel-L2 {err:.3e} > {O_TOL}")
    return float((o.float() - po.float()).abs().max())


def _route_counted(wrapper, plan, before):
    """Whether the call made since `before` (the wrapper's (slab, wgmma)
    counts) went down the plan's route, one launch."""
    from flashattention_kernel_project_tpu_torch.ops import paged_decode as pd

    slab, wgmma = wrapper.slab_launches - before[0], wrapper.wgmma_launches - before[1]
    return (slab, wgmma) == ((1, 0) if plan.route == pd.RAGGED_SLAB else (0, 1))


def ragged_edges(device, entry, fmt, label, flavours=RAGGED_FLAVOURS,
                 shapes=RAGGED_EDGES):
    """Both routes of the ragged forward at the edges of their tiles and
    splits (`shapes`) in each of `flavours`, over a bf16 cache (fmt None) or
    an 8-bit one: each call down the route its plan names (its counters),
    held to plain by `ragged_hold`; folds the max-abs error into `entry`."""
    from flashattention_kernel_project_tpu_torch.ops import paged_decode as pd

    import torch

    gen = torch.Generator(device=device).manual_seed(67)
    routes = {}
    for shape in shapes:
        b, hq, hkv, t, s, lens, offs, d = shape
        q, cache, kv_lens, q_offsets = _ragged_inputs(gen, device, shape, fmt)
        plan = pd.ragged_plan(b, hq, hkv, t, s, d, fmt is not None)
        for kw in flavours:
            call, plain, wrapper = _ragged_fns(q, cache, kv_lens, q_offsets, kw)
            before = (wrapper.slab_launches, wrapper.wgmma_launches)
            o = call()
            what = (f"ragged edge {fmt or 'bf16'} {plan.route} b{b} {hq}/{hkv} "
                    f"t{t} s_max{s} d{d} kv_lens {lens} q_offsets {offs} {kw}")
            if not _route_counted(wrapper, plan, before):
                raise AssertionError(f"{what}: not counted on the {plan.route} route")
            entry["max_abs_err"] = max(entry["max_abs_err"], ragged_hold(
                what, o, plain(), kv_lens, q_offsets, kw))
            routes[plan.route] = routes.get(plan.route, 0) + 1
    log(f"ragged edges {fmt or 'bf16'}: {len(shapes)} shapes x {len(flavours)} "
        f"flavours held to plain (rows that see no key exactly 0), calls by "
        f"route {routes} [{label}]")


def ragged_verify(device, entry, fmt, label, **kw):
    """The linear speculative verify (RAGGED_VERIFY) through the ragged
    forward with flash_attention_ragged's keywords `kw`: held to plain, the
    slab route (its counter), one device operation a call (torch.profiler
    and a captured CUDA graph's nodes), a CUDA graph's replay bit-equal,
    and the call, plain and SDPA with the ragged mask timed in turns from
    CUDA graphs, beside its bound; into `entry` as verify_*."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import flash_attention as fa
    from flashattention_kernel_project_tpu_torch.ops import paged_decode as pd

    gen = torch.Generator(device=device).manual_seed(71)
    b, hq, hkv, t, s, lens, offs, d = RAGGED_VERIFY
    q, cache, kv_lens, q_offsets = _ragged_inputs(gen, device, RAGGED_VERIFY, fmt)
    plan = pd.ragged_plan(b, hq, hkv, t, s, d, fmt is not None)
    call, plain, wrapper = _ragged_fns(q, cache, kv_lens, q_offsets, kw)
    what = f"ragged verify {fmt or 'bf16'} {kw or ''}".rstrip()
    before = (wrapper.slab_launches, wrapper.wgmma_launches)
    o = call()
    if plan.route != pd.RAGGED_SLAB or not _route_counted(wrapper, plan, before):
        raise AssertionError(f"{what}: not on the slab route ({plan})")
    max_abs = ragged_hold(what, o, plain(), kv_lens, q_offsets, kw)
    entry["max_abs_err"] = max(entry["max_abs_err"], max_abs)
    ops = device_ops(call)
    graph_ops = graph_device_ops(call)
    if len(ops) != 1 or len(graph_ops) != 1:
        raise AssertionError(f"{what}: a call ran {ops} (a captured call "
                             f"{graph_ops}); one device operation expected")
    if not graph_bit_equal(call):
        raise AssertionError(f"{what}: a CUDA graph's replay differs")
    window, sinks = fa._band(True, kw.get("window"), kw.get("sinks", 0))
    mask = fa._ragged_mask(t, s, kv_lens, q_offsets, True, window, sinks)
    yard = cache if fmt is None else (dequantized_bf16(*cache[:2]),
                                      dequantized_bf16(*cache[2:]))
    times = time_turns({"call": call, "plain": plain,
                        "sdpa": sdpa_fn(q, *yard, mask=mask)}, device)
    if window:
        pairs = hq * sum(band_pairs(t, n, off, window, sinks)
                         for n, off in zip(lens, offs))
        live = sum(min(n, max(sinks, 0)) + n - max(off - window + 1, sinks, 0)
                   for n, off in zip(lens, offs))
    else:
        pairs = hq * sum(visible_pairs(t, n, off, True) for n, off in zip(lens, offs))
        live = sum(lens)
    kv_bytes = (2 * live * hkv * d * 2 if fmt is None
                else bytes_8bit(live, hkv, d))
    bnd = bound(4 * d * pairs, nbytes(q, o, kv_lens, q_offsets) + kv_bytes)
    log(f"{what} (b{b} {hq}/{hkv} t{t} s_max{s} d{d} kv_lens {lens}): "
        f"{plan.route} route, {plan.n_splits} splits of {plan.block_s}, "
        f"{plan.row_tiles} row tile(s) of {plan.block_rows} | max-abs "
        f"{max_abs:.3e} | device operations of a call {ops} (captured: "
        f"{graph_ops}); a CUDA graph replays it bit-equal | in turns from CUDA "
        f"graphs: call {times['call']:.4f} ms, plain {times['plain']:.4f} ms, "
        f"SDPA with the ragged mask {times['sdpa']:.4f} ms | bound "
        f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}, "
        f"{bnd['bound_ms'] / times['call']:.1%} of the call) [{label}]")
    entry.update(verify_ms=times["call"], verify_plain_ms=times["plain"],
                 verify_library_ms=times["sdpa"],
                 verify_bound_ms=bnd["bound_ms"], verify_bound_by=bnd["bound_by"],
                 verify_shape=f"b{b} hq{hq} hkv{hkv} t{t} s_max{s} d{d} "
                              f"kv_lens{lens} q_offsets{offs} {kw}")


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
        used = min(-(-n // page), max_pages)  # a length may pass the capacity
        table[row, :used] = torch.tensor(perm[row * max_pages:row * max_pages + used])
    lengths = torch.tensor(lens, dtype=torch.int32, device=device)
    return q, k, v, table.to(device), lengths


# The paged decode's instances (csrc/paged_extend_sm90.cuh's
# paged_decode_sm90_kernel: d, pool type, ring depth, mode 0 attention, 1
# the int8 score product, 2 the copy probe), by the source that builds them:
# (pool types, depths, modes)
PDEC_KERNEL = "paged_decode_sm90_kernel"
PDEC_SOURCE = f"{PKG}/csrc/paged_decode.cu"
PDEC_OBJECTS = {
    "paged_decode.cu": (("bf16",), (2,), (0, 2)),
    "paged_decode_deep.cu": (("bf16",), (3, 4), (0,)),
    "paged_decode_q.cu": (("int8", "e4m3"), (2,), (0,)),
    "paged_decode_q_deep.cu": (("int8", "e4m3"), (3, 4), (0,)),
    "paged_decode_qi8.cu": (("int8",), (2, 3, 4), (1,)),
}


def pdec_instance(sym: str):
    """(d, pool type, ring depth, mode) of a paged_decode_sm90_kernel
    instance's symbol, or None for another symbol."""
    name, rest = mangled_name(sym)
    if name != PDEC_KERNEL:
        return None
    m = re.match(r"ILi(\d+)E(13__nv_bfloat16|a|13__nv_fp8_e4m3)Li(\d+)ELi(\d+)E",
                 rest)
    return int(m.group(1)), EXT_TYPES[m.group(2)], int(m.group(3)), int(m.group(4))


def ptxas_registers(build_log: str, instance) -> dict:
    """{instance: registers a thread} from ptxas's lines in the build log."""
    regs, current = {}, None
    for line in build_log.splitlines():
        props = re.search(r"Compiling entry function '([^']+)'", line)
        if props:
            current = instance(props.group(1))
        elif current is not None and "registers" in line:
            regs[current] = int(re.search(r"Used (\d+) registers", line).group(1))
            current = None
    return regs


def phase_dec_paged_build(build_log: str, label):
    """The paged decode's 26 instances (d 64 and 128; bf16, int8 and e4m3
    pools at ring depths 2, 3 and 4; the int8 score product at each depth;
    the copy probe at depth 2) through `wgmma_gate` with mma.sync in place
    of wgmma: built with no spill (every instance, the serving path's depth
    2 among them), each in its source's object, UTMALDG (the TMA ring) in
    each SASS, HMMA.16816 in each but the copy probe's (none there) and
    IMMA.16832 (the int8 score product) in the q_int8 instances; ptxas's
    registers by depth."""
    from flashattention_kernel_project_tpu_torch.ops import _build

    want = {(d, kv, depth, mode) for kvs, depths, modes in PDEC_OBJECTS.values()
            for d in (64, 128) for kv in kvs for depth in depths for mode in modes}
    objects = {src: (lambda inst, spec=spec: inst[1] in spec[0]
                     and inst[2] in spec[1] and inst[3] in spec[2])
               for src, spec in PDEC_OBJECTS.items()}
    counts = wgmma_gate(build_log, PDEC_KERNEL, pdec_instance, objects, want,
                        need=("UTMALDG",), forbid=())
    for inst, c in sorted(counts.items()):
        if (c["HMMA.16816"] == 0) != (inst[3] == 2):
            raise AssertionError(f"{PDEC_KERNEL}{inst}: HMMA.16816 {c['HMMA.16816']}")
    imma = {}
    for d in (64, 128):
        for depth in (2, 3, 4):
            imma[(d, depth)] = sass_counts(
                os.path.join(_build.BUILD_DIR, "paged_decode_qi8.cu.o"),
                f"{PDEC_KERNEL}ILi{d}EaLi{depth}ELi1E", ("IMMA.16832",))["IMMA.16832"]
    if not all(imma.values()):
        raise AssertionError(f"the int8 score product's IMMA.16832 counts: {imma}")
    regs = ptxas_registers(build_log, pdec_instance)
    log(f"paged decode: {len(want)} instances (d, pool, depth, mode) built with "
        f"no spill; SASS (UTMALDG, HMMA.16816): "
        + ", ".join(f"{inst}: {c['UTMALDG']}/{c['HMMA.16816']}"
                    for inst, c in sorted(counts.items()))
        + f"; IMMA.16832 of q_int8 (d, depth): {imma}; registers: "
        + ", ".join(f"{inst}: {r}" for inst, r in sorted(regs.items()))
        + f" [{label}]")


# (b, hq, hkv, d, page, max_pages, lengths) at the edges of the decode's
# tiles, boxes and splits: pages of 16 to 128 (48, 80, 112: tiles across
# pages) with lengths about a tile's edge, a page's edge and past the
# capacity; G 1, 2, 4 and 8 at d 64 and 128 about the gather plan's split
# edge (4 splits of 128 keys); the serving pool at the edges of its 8
# splits of 256 keys; a table of 64 pages (gather=False: 64 splits); B *
# Hkv past the card's blocks (one split). Each runs in both schedules.
PDEC_EDGE_SHAPES = (
    [(8, 16, 4, 128, page, 1024 // page,
      [0, 1, 63, 64, 65, page - 1, page + 1, 1024 // page * page + 7])
     for page in (16, 32, 48, 64, 80, 96, 112, 128)]
    + [(4, hq, hkv, d, 64, 8, [0, 127, 128, 513])
       for hq, hkv in ((4, 4), (8, 4), (16, 4), (16, 2)) for d in (64, 128)]
    + [(8, 16, 4, 128, 128, 16, [255, 256, 257, 511, 512, 513, 2047, 2048]),
       (2, 16, 4, 128, 128, 64, [0, 8191]),
       (66, 16, 4, 64, 16, 8, [0] + [7 * i % 129 for i in range(1, 66)])])
# the 8-bit pools at a subset: pages 16, 48 and 128, G 1 and 8, d 64, one
# split
PDEC_EDGE_SHAPES_8BIT = (
    [(6, 16, 4, 128, page, 1024 // page,
      [0, 63, 65, page + 1, 700, 1024 // page * page + 7])
     for page in (16, 48, 128)]
    + [(4, 4, 4, 64, 64, 8, [0, 127, 128, 513]),
       (4, 16, 2, 64, 64, 8, [0, 127, 128, 513]),
       (66, 16, 4, 64, 16, 8, [0] + [7 * i % 129 for i in range(1, 66)])])


def pdec_plain(q, pools, *rest, q_int8=False):
    """The decode's plain split partials over a bf16 or an 8-bit pool."""
    from flashattention_kernel_project_tpu_torch.ops import paged_decode as pd

    if len(pools) == 2:
        return pd._paged_partials_plain(q, *pools, *rest)
    plain = pd._paged_partials_qi8_plain if q_int8 else pd._paged_partials_q_plain
    return plain(q, *pools, *rest)


def pdec_whole(q, pools, table, lengths, **kw):
    """A closure making one public call of the paged decode."""
    from flashattention_kernel_project_tpu_torch.ops import paged_decode as pd

    if len(pools) == 2:
        return lambda: pd.paged_flash_decode(q, *pools, table, lengths, **kw)
    return lambda: pd.paged_flash_decode_quant(q, *pools, table, lengths, **kw)


def pdec_edges(device, label, fmt=None, shapes=PDEC_EDGE_SHAPES):
    """The paged decode's whole call (one launch, the splits merged on the
    card) and the kernel's split partials through `merge_partials` against
    the plain version at `shapes`, in both schedules (rel-L2 O_TOL; with
    the int8 score product, int8 gather=True, QI8_VS_PLAIN_TOL); rows of
    length 0 exactly 0; a length past the capacity bit-equal to the
    capacity. Over a bf16 pool (fmt None) or an 8-bit one. Returns the
    largest max-abs error."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import flash_decode as fd
    from flashattention_kernel_project_tpu_torch.ops import paged_decode as pd

    gen = torch.Generator(device=device).manual_seed(41)
    worst = 0.0
    for b, hq, hkv, d, page, max_pages, lens in shapes:
        q = torch.randn(b, hq, d, generator=gen, device=device).bfloat16()
        if fmt is None:
            _, k, v, table, lengths = _paged_case(gen, device, b, hq, hkv, d,
                                                  page, max_pages, lens)
            pools = (k, v)
        else:
            pools, table = _paged_8bit_case(gen, device, fmt, b, hkv, d, page,
                                            max_pages, lens)
            lengths = torch.tensor(lens, dtype=torch.int32, device=device)
        capped = lengths.clamp(max=max_pages * page)
        runs = [(g, False) for g in (True, False)]
        if fmt == "int8":
            runs.append((True, True))
        for gather, q_int8 in runs:
            kw = dict(gather=gather, **({"q_int8": True} if q_int8 else {}))
            n, block_s = pd.decode_plan(b, hkv, page, max_pages, d, gather)
            o = pdec_whole(q, pools, table, lengths, **kw)()
            rest = (table, lengths, block_s, d ** -0.5)
            parts = pd._decode_cuda(q, pools, *rest, False, q_int8=q_int8)
            po = fd.merge_partials(*pdec_plain(q, pools, *rest, q_int8=q_int8))
            po = po.reshape(b, hq, d)
            merged = fd.merge_partials(*parts).reshape(b, hq, d)
            same = torch.equal(o, pdec_whole(q, pools, table, capped, **kw)())
            torch.cuda.synchronize()
            what = (f"paged_decode edge {fmt or 'bf16'}{' q_int8' if q_int8 else ''} "
                    f"b{b} hq{hq} hkv{hkv} d{d} page{page} max_pages{max_pages} "
                    f"gather={gather} ({n} splits of {block_s}) lengths "
                    f"{lens if len(lens) <= 8 else str(lens[:8])[:-1] + ', ...]'}")
            assert o.shape == q.shape and o.dtype == q.dtype, what
            tol = QI8_VS_PLAIN_TOL if q_int8 else O_TOL
            for name, got in (("whole call", o), ("kernel partials + plain merge",
                                                  merged)):
                err = _rel_l2(got, po.to(got.dtype))
                if not torch.isfinite(got).all() or not err <= tol:
                    raise AssertionError(f"{what}: {name} rel-L2 {err:.3e} > {tol}")
            if any(float(o[i].float().abs().max()) != 0.0
                   for i, n_b in enumerate(lens) if n_b == 0):
                raise AssertionError(f"{what}: a row of length 0 is not 0")
            if not same:
                raise AssertionError(f"{what}: a length past the capacity "
                                     f"differs from the capacity")
            worst = max(worst, float((o.float() - po.float()).abs().max()))
            log(f"{what}: rel-L2 {_rel_l2(o, po):.3e} (partials "
                f"{_rel_l2(merged, po):.3e}) [{label}]")
    return worst


def pdec_yardstick(q, k_pages, v_pages, table, lengths):
    """SDPA (enable_gqa) with the length mask over the K/V already gathered
    into a linear cache: a yardstick only, not the same function (the
    gather is left out), never on the port's path."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import paged_decode as pd

    k, v = pd._linear_rows(k_pages, table), pd._linear_rows(v_pages, table)
    col = torch.arange(k.shape[2], device=q.device)
    mask = col[None] < lengths[:, None]
    return sdpa_fn(q[:, :, None], k, v, mask=mask[:, None, None])


def pdec_measure(device, entry, q, pools, table, lengths, what, label,
                 q_int8=False):
    """At one shape: the kernel's partials against plain, one device
    operation a call (torch.profiler, and the nodes of a captured CUDA
    graph), a CUDA graph's replay bit-equal to the eager call, ring depths
    3 and 4 bit-equal to 2, and the kernel alone (its split partials), the
    whole call and the SDPA yardstick in turns from CUDA graphs, beside
    plain; into `entry`."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import flash_decode as fd
    from flashattention_kernel_project_tpu_torch.ops import paged_decode as pd

    b, hq, d = q.shape
    hkv, page = pools[0].shape[1], pools[0].shape[2]
    _, block_s = pd.decode_plan(b, hkv, page, table.shape[1], d)
    rest = (table, lengths, block_s, d ** -0.5)
    po = fd.merge_partials(*pdec_plain(q, pools, *rest, q_int8=q_int8))
    kernel = lambda: pd._decode_cuda(q, pools, *rest, False, q_int8=q_int8)  # noqa: E731
    err = _rel_l2(fd.merge_partials(*kernel()), po)
    tol = QI8_VS_PLAIN_TOL if q_int8 else O_TOL
    if not err <= tol:
        raise AssertionError(f"{what}: kernel partials rel-L2 {err:.3e} > {tol}")
    kw = {"q_int8": True} if q_int8 else {}
    whole = pdec_whole(q, pools, table, lengths, **kw)
    ops = device_ops(whole)
    if len(ops) != 1:
        raise AssertionError(f"{what}: one call ran {len(ops)} device "
                             f"operations (one expected): {ops}")
    graph_ops = graph_device_ops(whole)
    if len(graph_ops) != 1:
        raise AssertionError(f"{what}: a captured call holds {len(graph_ops)} "
                             f"device operations (one expected): {graph_ops}")
    if not graph_bit_equal(whole):
        raise AssertionError(f"{what}: a CUDA graph's replay differs")
    base = whole()
    same = {n: torch.equal(pdec_whole(q, pools, table, lengths, slots=n, **kw)(),
                           base) for n in (3, 4)}
    if not all(same.values()):
        raise AssertionError(f"{what}: ring depths 3, 4 not bit-equal to 2: {same}")
    if len(pools) == 2:
        yard_pools = pools
    else:
        yard_pools = (dequantized_bf16(*pools[:2]), dequantized_bf16(*pools[2:]))
    times = time_turns({
        "yardstick": pdec_yardstick(q, *yard_pools, table, lengths),
        "kernel": kernel, "call": whole}, device)
    plain_ms = time_ms(lambda: pdec_plain(q, pools, *rest, q_int8=q_int8),
                       device, iters=20, graph=True)
    log(f"{what}: partials rel-L2 {err:.3e} | device operations of a call: "
        f"{ops} (a captured call: {graph_ops}); a CUDA graph replays it "
        f"bit-equal; slots 3 and 4 bit-equal to 2 | in turns from CUDA graphs: "
        f"kernel (partials) {times['kernel']:.4f} ms, whole call "
        f"{times['call']:.4f} ms, SDPA on the K/V gathered into a linear cache "
        f"with the length mask {times['yardstick']:.4f} ms (a yardstick, not "
        f"the same function: the gather is left out) | plain partials "
        f"{plain_ms:.4f} ms [{label}]")
    entry.update(ms=times["call"], kernel_ms=times["kernel"], plain_ms=plain_ms,
                 yardstick_sdpa_ms=times["yardstick"])


def phase_paged_decode(device, shapes, label):
    """The paged decode (csrc/paged_decode.cu: paged_extend_sm90.cuh's block
    at T = 1) over a bf16 pool in both schedules against
    `_paged_partials_plain` through `merge_partials`, at each (b, hq, hkv,
    d, page, max_pages, lengths), then at the edges of its tiles, boxes and
    splits (`pdec_edges`); the first shape (the slice's) stands for the
    kernel: its partials, one device operation a call, a CUDA graph's
    replay, slots 3 and 4, and its times in turns (`pdec_measure`), with
    its bound. Returns its JSON entry (no single PyTorch call attends over
    a paged cache, so its library_ms is null)."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import flash_decode as fd
    from flashattention_kernel_project_tpu_torch.ops import paged_decode as pd

    gen = torch.Generator(device=device).manual_seed(19)
    entry = dict(name="paged_decode", route="cuda", source=PDEC_SOURCE,
                 replaces="flashattention_kernel_project_tpu/ops/paged_decode.py:107",
                 max_abs_err=0.0, library_ms=None)
    for i, (b, hq, hkv, d, page, max_pages, lens) in enumerate(shapes):
        q, k, v, table, lengths = _paged_case(gen, device, b, hq, hkv, d, page,
                                              max_pages, lens)
        times = {}
        for gather in (False, True):
            n, block_s = pd.decode_plan(b, hkv, page, max_pages, d, gather)
            part_args = (q, k, v, table, lengths, block_s, d ** -0.5)
            o = pd.paged_flash_decode(q, k, v, table, lengths, gather=gather)
            po = fd.merge_partials(*pd._paged_partials_plain(*part_args))
            po = po.reshape(b, hq, d)
            torch.cuda.synchronize()
            assert o.shape == q.shape and torch.isfinite(o).all()
            for row, n_b in enumerate(lens):
                if n_b == 0 and float(o[row].float().abs().max()) != 0.0:
                    raise AssertionError(f"paged row {row} is empty but not 0")
            err = _rel_l2(o, po)
            max_abs = float((o.float() - po.float()).abs().max())
            entry["max_abs_err"] = max(entry["max_abs_err"], max_abs)
            if not err <= O_TOL:
                raise AssertionError(
                    f"paged_decode gather={gather} rel-L2 {err:.3e} > {O_TOL}")
            times[gather] = time_ms(lambda: pd.paged_flash_decode(
                q, k, v, table, lengths, gather=gather), device, iters=50,
                graph=True)
            log(f"paged_decode b{b} hq{hq} hkv{hkv} d{d} page{page} "
                f"max_pages{max_pages} lengths={lens} gather={gather} ({n} "
                f"splits of {block_s}): rel-L2 {err:.3e}, max-abs {max_abs:.3e} "
                f"| whole call {times[gather]:.4f} ms [{label}]")
        live = sum(min(n_b, max_pages * page) for n_b in lens)
        bnd = bound(4 * live * hq * d,
                    nbytes(q, o, table, lengths) + 2 * live * hkv * d * 2)
        log(f"paged_decode bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}: "
            f"q, the live K/V rows, the table and o); no single PyTorch call "
            f"computes a paged decode, so there is no library time")
        if i == 0:
            what = (f"paged_decode b{b} hq{hq} hkv{hkv} d{d} page{page} "
                    f"max_pages{max_pages} lengths={lens}")
            pdec_measure(device, entry, q, (k, v), table, lengths, what, label)
            entry.update(gather_false_ms=times[False], **bnd,
                         shape=f"b{b} hq{hq} hkv{hkv} d{d} page{page} "
                               f"max_pages{max_pages} lengths{lens}")
            log(f"{what}: whole call {entry['ms']:.4f} ms, "
                f"{bnd['bound_ms'] / entry['ms']:.1%} of its bound [{label}]")
    entry["max_abs_err"] = max(entry["max_abs_err"], pdec_edges(device, label))
    return entry


# The paged extend's instances (csrc/paged_extend_sm90.cuh: d, folded rows
# a block, pool type), the bf16 ones in paged_extend.cu's object, the 8-bit
# ones in paged_extend_q.cu's
EXT_KERNEL = "paged_extend_sm90_kernel"
EXT_SOURCE = f"{PKG}/csrc/paged_extend_sm90.cuh"
EXT_TYPES = {"13__nv_bfloat16": "bf16", "a": "int8", "13__nv_fp8_e4m3": "e4m3"}
EXT_OBJECTS = {"paged_extend.cu": ("bf16",), "paged_extend_q.cu": ("int8", "e4m3")}


def ext_instance(sym: str):
    """(d, block rows, pool type) of a paged_extend_sm90_kernel instance's
    symbol, or None for another symbol."""
    name, rest = mangled_name(sym)
    if name != EXT_KERNEL:
        return None
    m = re.match(r"ILi(\d+)ELi(\d+)E(13__nv_bfloat16|a|13__nv_fp8_e4m3)E", rest)
    return int(m.group(1)), int(m.group(2)), EXT_TYPES[m.group(3)]


def phase_ext_sm90_build(build_log: str, label):
    """The paged extend's 18 instances (d 64 and 128, 16, 32 and 64 folded
    rows a block, bf16, int8 and e4m3 pools) through `wgmma_gate` with
    mma.sync in place of wgmma: built with no spill, each pool type in its
    source's object, with UTMALDG (the TMA boxes) and HMMA.16816 (both
    products) in each SASS."""
    counts = wgmma_gate(
        build_log, EXT_KERNEL, ext_instance,
        {src: (lambda inst, kinds=kinds: inst[2] in kinds)
         for src, kinds in EXT_OBJECTS.items()},
        {(d, r, kv) for d in (64, 128) for r in (16, 32, 64)
         for kv in EXT_TYPES.values()},
        need=("UTMALDG", "HMMA.16816"), forbid=())
    log("paged extend: 18 instances (d, rows, pool) built with no spill; SASS "
        "(UTMALDG, HMMA.16816): "
        + ", ".join(f"{inst}: {c['UTMALDG']}/{c['HMMA.16816']}"
                    for inst, c in sorted(counts.items())) + f" [{label}]")


RAGGED_KERNEL = "flash_fwd_ragged_sm90_kernel"
RAGGED_OBJECTS = {"flash_fwd_ragged.cu": ("bf16", (0,)),
                  "flash_fwd_ragged_fixed.cu": ("bf16", (1,)),
                  "flash_fwd_ragged_q.cu": ("int8", (0, 1)),
                  "flash_fwd_ragged_fp8.cu": ("e4m3", (0, 1))}
SLAB_KERNEL = "ragged_slab_sm90_kernel"
SLAB_OBJECTS = {"ragged_slab.cu": ("bf16",), "ragged_slab_q.cu": ("int8",),
                "ragged_slab_fp8.cu": ("e4m3",)}


def ragged_instance(sym: str):
    """(d, band, disc, block rows, cache type) of a
    flash_fwd_ragged_sm90_kernel instance's symbol, or None."""
    name, rest = mangled_name(sym)
    if name != RAGGED_KERNEL:
        return None
    m = re.match(r"ILi(\d+)ELb(\d)ELi(\d)ELi(\d+)E(13__nv_bfloat16|a|13__nv_fp8_e4m3)E",
                 rest)
    return (int(m.group(1)), int(m.group(2)), int(m.group(3)), int(m.group(4)),
            EXT_TYPES[m.group(5)])


# the dense forward over an 8-bit cache (flash_fwd_sm90.cuh's block body
# behind flash_fwd_q_sm90_kernel), by source: (cache type, disciplines)
FWD_Q_KERNEL = "flash_fwd_q_sm90_kernel"
FWD_Q_OBJECTS = {"flash_fwd_q.cu": ("int8", 0), "flash_fwd_q_fixed.cu": ("int8", 1),
                 "flash_fwd_q_hybrid.cu": ("int8", 2), "flash_fwd_q_fp8.cu": ("e4m3", 0),
                 "flash_fwd_q_fp8_fixed.cu": ("e4m3", 1),
                 "flash_fwd_q_fp8_hybrid.cu": ("e4m3", 2)}


def fwd_q_instance(sym: str):
    """(d, band, disc, block rows, cache type) of a flash_fwd_q_sm90_kernel
    instance's symbol, or None."""
    name, rest = mangled_name(sym)
    if name != FWD_Q_KERNEL:
        return None
    m = re.match(r"ILi(\d+)ELb(\d)ELi(\d)ELi(\d+)E(a|13__nv_fp8_e4m3)E", rest)
    return (int(m.group(1)), int(m.group(2)), int(m.group(3)), int(m.group(4)),
            EXT_TYPES[m.group(5)])


def phase_fwd_q_build(build_log: str, label):
    """The dense 8-bit forward's 32 instances (d 64 and 128, without and
    with a band, the three disciplines, int8 and e4m3, in blocks of 64
    rows, and of 128 without a band online and fixed-max) through
    `wgmma_gate`: each in its source's object (one cache type and
    discipline a source), none spilling, none with a stack frame or a
    local load or store, each with HGMMA and UTMALDG and no HMMA.16816 (the
    mma.sync body is gone)."""
    want = {(d, w, c, rows, kv) for d in (64, 128) for w in (0, 1)
            for c in (0, 1, 2)
            for rows in ((64, 128) if c < 2 and not w else (64,))
            for kv in ("int8", "e4m3")}
    counts = wgmma_gate(
        build_log, FWD_Q_KERNEL, fwd_q_instance,
        {src: (lambda inst, kv=kv, disc=disc: inst[4] == kv and inst[2] == disc)
         for src, (kv, disc) in FWD_Q_OBJECTS.items()}, want,
        forbid=("HMMA.16816", "LDL", "STL"))
    frames = no_stack_frames(build_log, fwd_q_instance)
    regs = ptxas_registers(build_log, fwd_q_instance)
    log(f"dense 8-bit forward: {len(counts)} instances (d, band, disc, rows, "
        f"cache) built with no spill and no stack frame ({frames} frames of 0 "
        f"bytes), no local load or store; SASS HGMMA/UTMALDG: "
        + ", ".join(f"{inst}: {c['HGMMA']}/{c['UTMALDG']}"
                    for inst, c in sorted(counts.items()))
        + "; registers: " + ", ".join(f"{inst}: {r}" for inst, r in sorted(regs.items()))
        + f" [{label}]")


def slab_instance(sym: str):
    """(d, block rows, cache type, call: 1 plain, 2 general) of a
    ragged_slab_sm90_kernel instance's symbol, or None."""
    name, rest = mangled_name(sym)
    if name != SLAB_KERNEL:
        return None
    m = re.match(r"ILi(\d+)ELi(\d+)E(13__nv_bfloat16|a|13__nv_fp8_e4m3)Li(\d)E",
                 rest)
    return (int(m.group(1)), int(m.group(2)), EXT_TYPES[m.group(3)],
            int(m.group(4)))


def no_stack_frames(build_log: str, instance) -> int:
    """The instances `instance` reads from the build log, each with a stack
    frame of 0 bytes (no local memory), or raise. Returns their count."""
    seen, current = 0, None
    for line in build_log.splitlines():
        props = re.search(r"(?:Compiling entry function '|Function properties "
                          r"for )([^'\s]+)", line)
        if props:
            current = instance(props.group(1))
        elif current is not None and "bytes stack frame" in line:
            if not re.search(r"\b0 bytes stack frame", line):
                raise AssertionError(f"{current}: local memory: {line.strip()}")
            seen += 1
            current = None
    return seen


def phase_ragged_build(build_log: str, label):
    """Kernel 3's two routes as ptxas and the SASS show them: the wgmma
    route's 32 instances (d 64 and 128, without and with a band, online and
    fixed-max; bf16 in blocks of 64 and 128 rows, int8 and e4m3 in 64) with
    HGMMA and UTMALDG and no HMMA.16816 in each, the slab route's 36 (d,
    16, 32 or 64 folded rows, bf16, int8 and e4m3, the plain and the
    general call) with UTMALDG and HMMA.16816; each in its source's
    object, none spilling, none with a stack frame or a local load or store
    (LDL, STL)."""
    want = {(d, w, c, rows, kv) for d in (64, 128) for w in (0, 1)
            for kv, (discs, rowss) in (("bf16", ((0, 1), (64, 128))),
                                       ("int8", ((0, 1), (64,))),
                                       ("e4m3", ((0, 1), (64,))))
            for c in discs for rows in rowss}
    counts = wgmma_gate(
        build_log, RAGGED_KERNEL, ragged_instance,
        {src: (lambda inst, kv=kv, discs=discs: inst[4] == kv and inst[2] in discs)
         for src, (kv, discs) in RAGGED_OBJECTS.items()}, want,
        forbid=("HMMA.16816", "LDL", "STL"))
    slab = wgmma_gate(
        build_log, SLAB_KERNEL, slab_instance,
        {src: (lambda inst, kinds=kinds: inst[2] in kinds)
         for src, kinds in SLAB_OBJECTS.items()},
        {(d, r, kv, call) for d in (64, 128) for r in (16, 32, 64)
         for kv in EXT_TYPES.values() for call in (1, 2)},
        need=("UTMALDG", "HMMA.16816"), forbid=("LDL", "STL"))
    frames = (no_stack_frames(build_log, ragged_instance)
              + no_stack_frames(build_log, slab_instance))
    regs = {**ptxas_registers(build_log, ragged_instance),
            **ptxas_registers(build_log, slab_instance)}
    log(f"ragged forward: wgmma route {len(counts)} instances (d, band, disc, "
        f"rows, cache), slab route {len(slab)} (d, rows, cache, call), built with no "
        f"spill and no stack frame ({frames} frames of 0 bytes), no local "
        f"load or store; SASS HGMMA/UTMALDG: "
        + ", ".join(f"{inst}: {c['HGMMA']}/{c['UTMALDG']}"
                    for inst, c in sorted(counts.items()))
        + "; UTMALDG/HMMA.16816: "
        + ", ".join(f"{inst}: {c['UTMALDG']}/{c['HMMA.16816']}"
                    for inst, c in sorted(slab.items()))
        + "; registers: " + ", ".join(f"{inst}: {r}" for inst, r in sorted(regs.items()))
        + f" [{label}]")


# (b, hq, hkv, d, page, max_pages, t, old lengths, n_splits) at the edges
# of the extend's tiles, boxes, row slabs and splits: pages of 16 to 128
# (48: a tile across two pages) with chunks ending on a tile edge (new 64),
# past it (65), on a page edge, across it, across a split edge (the
# default splits of 128 keys), at the table's capacity and from old 0;
# G 1, 2, 4 and 8 with T 1, 5 and 9 (1 to 72 folded rows: one slab, two,
# three, four, two row tiles); d 64; a caller's 16 splits of 64 keys (most
# with no live key), 3, and one (normalised in the block); a table of 64
# pages a row with most entries dead (32 default splits)
EXT_EDGE_SHAPES = (
    [(8, 16, 4, 128, page, 1024 // page, 5,
      [0, 59, 60, page - 5, page - 3, 123, 126, 1024 // page * page - 5], None)
     for page in (16, 32, 48, 64, 128)]
    + [(4, hq, hkv, 128, 64, 8, t, [0, 61, 130, 512 - t], None)
       for hq, hkv in ((4, 4), (8, 4), (16, 4), (16, 2)) for t in (1, 5, 9)]
    + [(4, 16, 4, 64, 16, 16, 5, [0, 59, 126, 251], None),
       (2, 16, 2, 64, 32, 8, 9, [0, 247], None)]
    + [(4, 16, 4, 128, 128, 8, 5, [0, 10, 300, 1019], n) for n in (16, 3, 1)]
    + [(2, 16, 4, 128, 128, 64, 5, [0, 300], None)])
# the 8-bit pools at a subset: pages 16, 48 and 128, two row tiles, d 64,
# splits with no live key, one split
EXT_EDGE_SHAPES_8BIT = (
    [(6, 16, 4, 128, page, 1024 // page, 5,
      [0, 59, 60, page - 3, 126, 1024 // page * page - 5], None)
     for page in (16, 48, 128)]
    + [(2, 16, 2, 128, 64, 8, 9, [0, 503], None),
       (4, 16, 4, 64, 16, 16, 5, [0, 59, 126, 251], None)]
    + [(4, 16, 4, 128, 128, 8, 5, [0, 10, 300, 1019], n) for n in (16, 1)])


def _ext_case(gen, device, fmt, b, hq, hkv, d, page, max_pages, t, old):
    """(q, pools, table, new_lengths, old_lengths) of an extend call: a pool
    of b * max_pages + 1 pages (bf16 (k, v), or 8-bit (k, k_scale, v,
    v_scale)) with each row's pages for old + t keys from a seeded
    permutation, as _paged_case."""
    import torch

    new = [n + t for n in old]
    if fmt is None:
        _, k, v, table, new_lengths = _paged_case(gen, device, b, hq, hkv, d,
                                                  page, max_pages, new)
        pools = (k, v)
    else:
        pools, table = _paged_8bit_case(gen, device, fmt, b, hkv, d, page,
                                        max_pages, new)
        new_lengths = torch.tensor(new, dtype=torch.int32, device=device)
    q = torch.randn(b, hq, t, d, generator=gen, device=device).bfloat16()
    old_lengths = torch.tensor(old, dtype=torch.int32, device=device)
    return q, pools, table, new_lengths, old_lengths


def ext_plain(q, pools, *rest):
    """The extend's plain version for a bf16 or an 8-bit pool."""
    from flashattention_kernel_project_tpu_torch.ops import paged_decode as pd

    return (pd._paged_extend_plain if len(pools) == 2
            else pd._paged_extend_q_plain)(q, *pools, *rest)


def ext_edges(device, label, fmt=None, shapes=EXT_EDGE_SHAPES):
    """The extend's whole call (one launch, the splits merged on the card)
    and the kernel's split partials through `merge_partials` against the
    plain version at `shapes` (rel-L2 1e-2), over a bf16 pool (fmt None) or
    an 8-bit one. Returns the largest max-abs error."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import paged_decode as pd

    gen = torch.Generator(device=device).manual_seed(37)
    worst = 0.0
    for b, hq, hkv, d, page, max_pages, t, old, n_splits in shapes:
        q, pools, table, new_lengths, old_lengths = _ext_case(
            gen, device, fmt, b, hq, hkv, d, page, max_pages, t, old)
        call = (q, pools, table, new_lengths, old_lengths, d ** -0.5, n_splits)
        o = pd._extend_cuda(*call, whole=True)
        merged = pd._merge_extend(pd._extend_cuda(*call, whole=False), q)
        po = ext_plain(q, pools, table, new_lengths, old_lengths, d ** -0.5)
        torch.cuda.synchronize()
        rows, tiles, n, block_s = pd.extend_plan(q.shape, hkv, page, max_pages,
                                                 n_splits)
        what = (f"paged_extend edge {fmt or 'bf16'} b{b} hq{hq} hkv{hkv} d{d} "
                f"page{page} max_pages{max_pages} t{t} old {old}: {n} splits "
                f"of {block_s}, {tiles} row tile(s) of {rows}")
        assert o.shape == q.shape and torch.isfinite(o).all(), what
        for name, got in (("whole call", o), ("kernel partials + plain merge", merged)):
            err = _rel_l2(got, po)
            if not torch.isfinite(got).all() or not err <= O_TOL:
                raise AssertionError(f"{what}: {name} rel-L2 {err:.3e} > {O_TOL}")
        worst = max(worst, float((o.float() - po.float()).abs().max()))
        log(f"{what}: rel-L2 {_rel_l2(o, po):.3e} (partials "
            f"{_rel_l2(merged, po):.3e}) [{label}]")
    return worst


def graph_bit_equal(fn) -> bool:
    """Whether one call of fn captured in a CUDA graph and replayed twice
    gives its eager output bit for bit."""
    import torch

    want = fn().clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        got = fn()
    g.replay()
    g.replay()
    torch.cuda.synchronize()
    return torch.equal(want, got)


def ext_yardstick(q, k_pages, v_pages, table, new_lengths, old_lengths):
    """SDPA (enable_gqa) with the verify's causal-offset mask over the K/V
    already gathered into a linear cache: a yardstick only, not the same
    function (the gather is left out), never on the port's path."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import paged_decode as pd

    k, v = pd._linear_rows(k_pages, table), pd._linear_rows(v_pages, table)
    t = q.shape[2]
    col = torch.arange(k.shape[2], device=q.device)
    pos = old_lengths[:, None] + torch.arange(t, device=q.device)[None, :]
    mask = (col[None, None] < new_lengths[:, None, None]) & (
        col[None, None] <= pos[:, :, None])
    return sdpa_fn(q, k, v, mask=mask[:, None])


def ext_measure(device, entry, q, pools, table, new_lengths, old_lengths,
                what, label):
    """At the serving verify: the kernel's partials against plain, one
    device operation a call, a CUDA graph's replay bit-equal, and the
    kernel alone (its partials), the whole call and the SDPA yardstick in
    turns from CUDA graphs, beside plain; into `entry`."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import paged_decode as pd

    d = q.shape[-1]
    call = (q, pools, table, new_lengths, old_lengths, d ** -0.5, None)
    po = ext_plain(q, pools, table, new_lengths, old_lengths, d ** -0.5)
    merged = pd._merge_extend(pd._extend_cuda(*call, whole=False), q)
    err = _rel_l2(merged, po)
    if not err <= O_TOL:
        raise AssertionError(f"{what}: kernel partials rel-L2 {err:.3e} > {O_TOL}")
    whole = lambda: pd._extend_cuda(*call, whole=True)  # noqa: E731
    ops = device_ops(whole)
    if len(ops) != 1:
        raise AssertionError(f"{what}: one call ran {len(ops)} device "
                             f"operations (one expected): {ops}")
    graph_ops = graph_device_ops(whole)
    if len(graph_ops) != 1:
        raise AssertionError(f"{what}: a captured call holds {len(graph_ops)} "
                             f"device operations (one expected): {graph_ops}")
    if not graph_bit_equal(whole):
        raise AssertionError(f"{what}: a CUDA graph's replay differs")
    if len(pools) == 2:
        yard_pools = pools
    else:
        yard_pools = (dequantized_bf16(*pools[:2]), dequantized_bf16(*pools[2:]))
    times = time_turns({
        "yardstick": ext_yardstick(q, *yard_pools, table, new_lengths, old_lengths),
        "kernel": lambda: pd._extend_cuda(*call, whole=False),
        "call": whole}, device)
    plain_ms = time_ms(lambda: ext_plain(q, pools, table, new_lengths,
                                         old_lengths, d ** -0.5),
                       device, iters=50, graph=True)
    log(f"{what}: partials rel-L2 {err:.3e} | device operations of a call: "
        f"{ops} (a captured call: {graph_ops}); a CUDA graph replays it "
        f"bit-equal | in turns from CUDA "
        f"graphs: kernel (partials) {times['kernel']:.4f} ms, whole call "
        f"{times['call']:.4f} ms, SDPA on the K/V gathered into a linear "
        f"cache with the verify's mask {times['yardstick']:.4f} ms (a "
        f"yardstick, not the same function: the gather is left out) | plain "
        f"{plain_ms:.4f} ms [{label}]")
    entry.update(ms=times["call"], kernel_ms=times["kernel"], plain_ms=plain_ms,
                 yardstick_sdpa_ms=times["yardstick"])


# the serving verify (T = spec_k + 1) at the slice's pool: page edges, a
# full table, a row with no prefix
EXT_SERVING = (8, 16, 4, 128, 128, 16, 5, [0, 1, 124, 127, 128, 700, 1500, 2043])


def phase_paged_extend(device, shapes, label):
    """The paged extend (the paged speculative verify, csrc/
    paged_extend_sm90.cuh) against `_paged_extend_plain`, bf16, at each
    (b, hq, hkv, d, page, max_pages, t, old lengths), then at the edges of
    its tiles, boxes and splits (`ext_edges`); the first shape (the slice's
    verify) stands for the kernel: its partials, one device operation a
    call, a CUDA graph's replay, and its times in turns (`ext_measure`),
    with its bound. Returns its JSON entry (no single PyTorch call attends
    over a paged cache, so its library_ms is null)."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import paged_decode as pd

    gen = torch.Generator(device=device).manual_seed(29)
    entry = dict(name="paged_extend", route="cuda", source=EXT_SOURCE,
                 replaces="flashattention_kernel_project_tpu/ops/paged_decode.py:397",
                 max_abs_err=0.0, library_ms=None)
    for i, (b, hq, hkv, d, page, max_pages, t, old) in enumerate(shapes):
        q, (k, v), table, new_lengths, old_lengths = _ext_case(
            gen, device, None, b, hq, hkv, d, page, max_pages, t, old)
        args = (q, k, v, table, new_lengths, old_lengths, d ** -0.5)
        rows, tiles, n_splits, block_s = pd.extend_plan(q.shape, hkv, page,
                                                        max_pages)
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
        # q, the live K/V rows, the table, both lengths and o; QK and PV
        # (4*d operations) per visible (row, key) pair
        new = [n + t for n in old]
        pairs = hq * sum(visible_pairs(t, n, off, True)
                         for n, off in zip(new, old))
        bnd = bound(4 * d * pairs,
                    nbytes(q, o, table, new_lengths, old_lengths)
                    + 2 * sum(new) * hkv * d * q.element_size())
        what = (f"paged_extend b{b} hq{hq} hkv{hkv} d{d} page{page} "
                f"max_pages{max_pages} t{t} old_lengths={old} (G*T = "
                f"{hq // hkv * t} rows: {tiles} row tile(s) of {rows}, "
                f"{n_splits} splits of {block_s})")
        if i == 0:
            ext_measure(device, entry, q, (k, v), table, new_lengths,
                        old_lengths, what, label)
            entry.update(**bnd, shape=f"b{b} hq{hq} hkv{hkv} d{d} page{page} "
                                      f"max_pages{max_pages} t{t} old_lengths{old}")
            ms = entry["ms"]
        else:
            ms = time_ms(lambda: pd._paged_extend_cuda(*args), device, iters=50,
                         graph=True)
        log(f"{what}: rel-L2 {err:.3e}, max-abs {max_abs:.3e} | whole call "
            f"{ms:.4f} ms | bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}, "
            f"{bnd['bound_ms'] / ms:.1%} of the call); no PyTorch call attends "
            f"over a paged cache, so there is no library time [{label}]")
    entry["max_abs_err"] = max(entry["max_abs_err"], ext_edges(device, label))
    return entry


FMTS = ("int8", "fp8")  # the 8-bit cache formats; int8 is the Scheduler's
TPU = "flashattention_kernel_project_tpu/ops"


def quantized(gen, device, shape, fmt, lane_major=False):
    """Random normal K or V of `shape` quantized per token (last axis) to
    `fmt`: (8-bit values, f32 scales [..., 1], or lane-major [..., 1, n]
    for a page pool)."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import quant

    x = torch.randn(*shape, generator=gen, device=device)
    vals, scales = quant.quantizer_for(quant.cache_dtype(fmt))(x, axis=-1)
    if lane_major:
        scales = scales.transpose(-1, -2).contiguous()
    return vals, scales


def dequantized_bf16(vals, scales):
    """An 8-bit cache or pool as bf16 (scales of either layout): the bf16
    kernel's input at the same shape and lengths."""
    if scales.shape[-1] != 1:
        scales = scales.transpose(-1, -2)
    return (vals.float() * scales).bfloat16()


def bytes_8bit(live, hkv, d):
    """Device bytes of `live` keys' K and V in an 8-bit cache: a byte an
    element and two f32 scales a key and head."""
    return live * hkv * (2 * d + 8)


def _live_keys(lens, window, sinks):
    """Keys the decode of each length attends, summed: all of them, or the
    band of the last `window` and the first `sinks`."""
    if window is None:
        return sum(lens)
    return sum(min(n, window) + min(sinks, max(n - window, 0)) for n in lens)


def kernel_8bit_check(name, got, want, entry, fmt):
    """rel-L2 of an 8-bit kernel's output against its plain version, held
    to O_TOL; folds the max-abs error into `entry`."""
    import torch

    torch.cuda.synchronize()
    assert got.shape == want.shape and torch.isfinite(got).all()
    err = _rel_l2(got, want)
    max_abs = float((got.float() - want.float()).abs().max())
    entry["max_abs_err"] = max(entry["max_abs_err"], max_abs)
    if not err <= O_TOL:
        raise AssertionError(f"{name} {fmt} rel-L2 {err:.3e} > {O_TOL}")
    return err, max_abs


def phase_decode_8bit(device, b, hq, hkv, s, d, label):
    """Kernel 7, the 8-bit linear decode (flash_decode_sm90.cuh's 8-bit
    kernel), against `_decode_partials_q_plain` through `merge_partials`,
    int8 and e4m3: at the serving shape, ragged lengths with one slot empty
    and one full, then at its tile and split edges (`dec_q_edges`); one
    device operation a call and a CUDA graph's replay bit-equal; the whole
    call and the kernel alone (its partials) timed in turns from CUDA
    graphs, beside the plain version and the bf16 decode's whole call on
    the dequantized cache. Returns its JSON entry, timed on int8 (no
    PyTorch call attends over an 8-bit cache with scales: library_ms is
    null)."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import flash_decode as fd

    gen = torch.Generator(device=device).manual_seed(31)
    entry = dict(name="flash_decode_q", route="cuda", source=DEC_Q_SOURCE,
                 replaces=f"{TPU}/flash_decode.py:102", max_abs_err=0.0,
                 library_ms=None)
    q = torch.randn(b, hq, d, generator=gen, device=device).bfloat16()
    lengths = torch.randint(1, s, (b,), generator=gen, device=device,
                            dtype=torch.int32)
    lengths[0] = 0
    lengths[-1] = s
    n_splits = fd.q_n_splits(b, hkv, s, d)
    block_s = fd.default_block_s(s, n_splits)
    live = int(lengths.sum())
    for fmt in FMTS:
        k, ks = quantized(gen, device, (b, hkv, s, d), fmt)
        v, vs = quantized(gen, device, (b, hkv, s, d), fmt)
        args = (q, k, ks, v, vs, lengths, n_splits, block_s, d ** -0.5)
        o = fd.flash_decode_int8(q, k, ks, v, vs, lengths)
        po = fd._decode_q_plain(*args)
        err, max_abs = kernel_8bit_check("flash_decode_q", o, po, entry, fmt)
        assert float(o[0].float().abs().max()) == 0.0  # the empty slot

        def call():
            return fd.flash_decode_int8(q, k, ks, v, vs, lengths)

        ops, graph_ops = device_ops(call), graph_device_ops(call)
        if len(ops) != 1 or len(graph_ops) != 1:
            raise AssertionError(f"flash_decode_q {fmt}: one call ran {ops} (a "
                                 f"captured call: {graph_ops}); one expected")
        if not graph_bit_equal(call):
            raise AssertionError(f"flash_decode_q {fmt}: a CUDA graph's replay "
                                 f"differs")
        times = time_turns({
            "call": call,
            "kernel": lambda: fd._decode_partials_q_cuda(*args)}, device)
        plain_ms = time_ms(lambda: fd._decode_q_plain(*args), device, iters=50,
                           graph=True)
        kb, vb = dequantized_bf16(k, ks), dequantized_bf16(v, vs)
        bf16_ms = time_ms(lambda: fd.flash_decode(q, kb, vb, lengths), device,
                          iters=50, graph=True)
        del kb, vb
        bnd = bound(4 * live * hq * d, nbytes(q, o) + bytes_8bit(live, hkv, d))
        log(f"flash_decode_q {fmt} b{b} hq{hq} hkv{hkv} s{s} d{d} {n_splits} "
            f"splits of {block_s} lengths={lengths.tolist()}: rel-L2 {err:.3e}, "
            f"max-abs {max_abs:.3e} | one device operation a call ({ops}; "
            f"captured: {graph_ops}), a CUDA graph's replay bit-equal | in "
            f"turns from CUDA graphs: whole call {times['call']:.4f} ms "
            f"({bytes_8bit(live, hkv, d) / times['call'] / 1e6:.1f} GB/s of live "
            f"K/V and scales, {bnd['bound_ms'] / times['call']:.1%} of its bound "
            f"{bnd['bound_ms']:.4f} ms, {bnd['bound_by']}), kernel (partials) "
            f"{times['kernel']:.4f} ms | plain {plain_ms:.4f} ms | the bf16 "
            f"decode on the dequantized cache {bf16_ms:.4f} ms [{label}]")
        if fmt == "int8":
            entry.update(ms=times["call"], kernel_ms=times["kernel"],
                         plain_ms=plain_ms, bf16_ms=bf16_ms, **bnd,
                         shape=f"b{b} hq{hq} hkv{hkv} s{s} d{d} n_splits{n_splits}")
        else:
            entry["fp8_ms"] = times["call"]
    entry["max_abs_err"] = max(entry["max_abs_err"], dec_q_edges(device, label))
    return entry


def _paged_8bit_case(gen, device, fmt, b, hkv, d, page, max_pages, lens):
    """An 8-bit pool (values and lane-major scale pages) of b * max_pages + 1
    pages, each row's pages in order from a seeded permutation, as
    _paged_case."""
    import torch

    n_pages = b * max_pages + 1
    k, ks = quantized(gen, device, (n_pages, hkv, page, d), fmt, lane_major=True)
    v, vs = quantized(gen, device, (n_pages, hkv, page, d), fmt, lane_major=True)
    perm = (torch.randperm(n_pages - 1, generator=gen, device=device) + 1).tolist()
    table = torch.zeros(b, max_pages, dtype=torch.int32)
    for row, n in enumerate(lens):
        used = min(-(-n // page), max_pages)  # a length may pass the capacity
        table[row, :used] = torch.tensor(perm[row * max_pages:row * max_pages + used])
    return (k, ks, v, vs), table.to(device)


def phase_paged_decode_8bit(device, b, hq, hkv, d, page, max_pages, lens, label):
    """The 8-bit paged decode (csrc/paged_decode_q.cu's instances of
    paged_extend_sm90.cuh's block) in both schedules against
    `_paged_partials_q_plain` through the same merge, int8 and e4m3, each
    with its partials, one device operation a call, a CUDA graph's replay,
    slots 3 and 4 and its times in turns (`pdec_measure`), and the bf16
    kernel timed on the dequantized pool in the same call; then at the
    edges (`pdec_edges`, with the int8 score product over the int8 pool).
    Returns its JSON entry, timed on int8 with gather=True (library_ms
    null)."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import flash_decode as fd
    from flashattention_kernel_project_tpu_torch.ops import paged_decode as pd

    gen = torch.Generator(device=device).manual_seed(37)
    entry = dict(name="paged_decode_q", route="cuda", source=PDEC_SOURCE,
                 replaces=f"{TPU}/paged_decode.py:824", max_abs_err=0.0,
                 library_ms=None)
    q = torch.randn(b, hq, d, generator=gen, device=device).bfloat16()
    lengths = torch.tensor(lens, dtype=torch.int32, device=device)
    live = sum(lens)
    for fmt in FMTS:
        pools, table = _paged_8bit_case(gen, device, fmt, b, hkv, d, page,
                                        max_pages, lens)
        kb, vb = dequantized_bf16(*pools[:2]), dequantized_bf16(*pools[2:])
        times = {}
        for gather in (False, True):
            n, block_s = pd.decode_plan(b, hkv, page, max_pages, d, gather)
            args = (q, *pools, table, lengths, block_s, d ** -0.5)
            o = pd.paged_flash_decode_quant(q, *pools, table, lengths,
                                            gather=gather)
            po = fd.merge_partials(*pd._paged_partials_q_plain(*args))
            err, max_abs = kernel_8bit_check("paged_decode_q", o,
                                             po.reshape(b, hq, d), entry, fmt)
            for row, n_b in enumerate(lens):
                if n_b == 0 and float(o[row].float().abs().max()) != 0.0:
                    raise AssertionError(f"paged row {row} is empty but not 0")
            times[gather] = time_ms(lambda: pd.paged_flash_decode_quant(
                q, *pools, table, lengths, gather=gather), device, iters=50,
                graph=True)
            log(f"paged_decode_q {fmt} b{b} hq{hq} hkv{hkv} d{d} page{page} "
                f"max_pages{max_pages} lengths={lens} gather={gather} ({n} "
                f"splits of {block_s}): rel-L2 {err:.3e}, max-abs {max_abs:.3e} "
                f"| whole call {times[gather]:.4f} ms [{label}]")
        what = (f"paged_decode_q {fmt} b{b} hq{hq} hkv{hkv} d{d} page{page} "
                f"max_pages{max_pages} lengths={lens}")
        timed = {}
        pdec_measure(device, timed, q, pools, table, lengths, what, label)
        bf16_ms = time_ms(lambda: pd.paged_flash_decode(q, kb, vb, table, lengths),
                          device, iters=50, graph=True)
        bnd = bound(4 * live * hq * d,
                    nbytes(q, o, table, lengths) + bytes_8bit(live, hkv, d))
        log(f"{what}: whole call {timed['ms']:.4f} ms "
            f"({bnd['bound_ms'] / timed['ms']:.1%} of its bound "
            f"{bnd['bound_ms']:.4f} ms, {bnd['bound_by']}) | the bf16 kernel on "
            f"the dequantized pool {bf16_ms:.4f} ms [{label}]")
        if fmt == "int8":
            entry.update(timed, bf16_ms=bf16_ms, gather_false_ms=times[False],
                         **bnd, shape=f"b{b} hq{hq} hkv{hkv} d{d} page{page} "
                                      f"max_pages{max_pages} lengths{lens}")
        else:
            entry.update(fp8_ms=timed["ms"], fp8_kernel_ms=timed["kernel_ms"])
        entry["max_abs_err"] = max(entry["max_abs_err"], pdec_edges(
            device, label, fmt, PDEC_EDGE_SHAPES_8BIT))
    return entry


def phase_ragged_8bit(device, b, hq, hkv, t, s, lens, offs, d, label):
    """The 8-bit ragged forward against `_fwd_ragged_q_plain`, int8 and
    e4m3, at the slice's chunk shape; the bf16 kernel timed on the
    dequantized cache in the same call. Returns its JSON entry, timed on
    int8 (library_ms null)."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(41)
    entry = dict(name="flash_fwd_ragged_q", route="cuda",
                 source=f"{PKG}/csrc/flash_fwd_ragged.cu",
                 slab_source=f"{PKG}/csrc/ragged_slab.cu",
                 replaces=f"{TPU}/flash_attention.py:1582", max_abs_err=0.0,
                 library_ms=None)
    q = torch.randn(b, hq, t, d, generator=gen, device=device).bfloat16()
    kv_lens = torch.tensor(lens, dtype=torch.int32, device=device)
    q_offsets = torch.tensor(offs, dtype=torch.int32, device=device)
    pairs = hq * sum(visible_pairs(t, n, off, True) for n, off in zip(lens, offs))
    for fmt in FMTS:
        k, ks = quantized(gen, device, (b, hkv, s, d), fmt)
        v, vs = quantized(gen, device, (b, hkv, s, d), fmt)
        args = (q, k, ks, v, vs, kv_lens, q_offsets, True, d ** -0.5)
        o = fa.flash_attention_ragged_kv_quant(*args[:7])
        err, max_abs = kernel_8bit_check("flash_fwd_ragged_q", o,
                                         fa._fwd_ragged_q_plain(*args), entry, fmt)
        ms, plain_ms = time_pair(lambda: fa._fwd_ragged_q_cuda(*args),
                                 lambda: fa._fwd_ragged_q_plain(*args), device)
        kb, vb = dequantized_bf16(k, ks), dequantized_bf16(v, vs)
        bf16_ms = time_ms(lambda: fa._fwd_ragged(q, kb, vb, kv_lens, q_offsets,
                                                 True, d ** -0.5),
                          device, graph=True)
        bnd = bound(4 * d * pairs, nbytes(q, o, kv_lens, q_offsets)
                    + bytes_8bit(sum(lens), hkv, d))
        log(f"flash_fwd_ragged_q {fmt} b{b} hq{hq} hkv{hkv} t{t} s_max{s} d{d} "
            f"kv_lens={lens} q_offsets={offs}: rel-L2 {err:.3e}, max-abs "
            f"{max_abs:.3e} | kernel {ms:.4f} ms "
            f"({4 * d * pairs / ms / 1e9:.1f} TFLOP/s) vs plain {plain_ms:.4f} "
            f"ms | the bf16 kernel on the dequantized cache {bf16_ms:.4f} ms | "
            f"bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}) [{label}]")
        if fmt == "int8":
            entry.update(ms=ms, plain_ms=plain_ms, bf16_ms=bf16_ms, **bnd,
                         shape=f"b{b} hq{hq} hkv{hkv} t{t} s_max{s} d{d} "
                               f"kv_lens{lens} q_offsets{offs} causal")
        else:
            entry["fp8_ms"] = ms
    fp8 = dict(entry, max_abs_err=0.0)
    ragged_verify(device, fp8, "fp8", label)
    ragged_verify(device, entry, "int8", label)
    entry["fp8_verify_ms"] = fp8["verify_ms"]
    for fmt in FMTS:
        ragged_edges(device, entry, fmt, label)
    entry["max_abs_err"] = max(entry["max_abs_err"], fp8["max_abs_err"])
    return entry


def phase_paged_extend_8bit(device, shapes, label):
    """The 8-bit paged extend against `_paged_extend_q_plain`, int8 and
    e4m3, at each (b, hq, hkv, d, page, max_pages, t, old lengths), then at
    the edges of its tiles, boxes and splits (`ext_edges`); the bf16
    kernel timed on the dequantized pool in the same call. The first shape
    (the slice's verify) stands for the kernel: its partials, one device
    operation a call, a CUDA graph's replay and its times in turns
    (`ext_measure`). Returns its JSON entry, timed on int8 (library_ms
    null)."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import paged_decode as pd

    gen = torch.Generator(device=device).manual_seed(43)
    entry = dict(name="paged_extend_q", route="cuda", source=EXT_SOURCE,
                 replaces=f"{TPU}/paged_decode.py:397", max_abs_err=0.0,
                 library_ms=None)
    for i, (b, hq, hkv, d, page, max_pages, t, old) in enumerate(shapes):
        new = [n + t for n in old]
        pairs = hq * sum(visible_pairs(t, n, off, True) for n, off in zip(new, old))
        for fmt in FMTS:
            q, pools, table, new_lengths, old_lengths = _ext_case(
                gen, device, fmt, b, hq, hkv, d, page, max_pages, t, old)
            args = (q, *pools, table, new_lengths, old_lengths, d ** -0.5)
            o = pd.paged_flash_extend(q, pools[0], pools[2], table, new_lengths,
                                      old_lengths, k_scale_pages=pools[1],
                                      v_scale_pages=pools[3])
            err, max_abs = kernel_8bit_check("paged_extend_q", o,
                                             pd._paged_extend_q_plain(*args),
                                             entry, fmt)
            kb, vb = dequantized_bf16(*pools[:2]), dequantized_bf16(*pools[2:])
            bf16_args = (q, kb, vb, table, new_lengths, old_lengths, d ** -0.5)
            what = (f"paged_extend_q {fmt} b{b} hq{hq} hkv{hkv} d{d} page{page} "
                    f"max_pages{max_pages} t{t} old_lengths={old}")
            if i == 0:
                sub = {}
                ext_measure(device, sub, q, pools, table, new_lengths,
                            old_lengths, what, label)
                ms = sub["ms"]
            else:
                ms = time_ms(lambda: pd._paged_extend_q_cuda(*args), device,
                             iters=50, graph=True)
            bf16_ms = time_ms(lambda: pd._paged_extend_cuda(*bf16_args), device,
                              iters=50, graph=True)
            bnd = bound(4 * d * pairs,
                        nbytes(q, o, table, new_lengths, old_lengths)
                        + bytes_8bit(sum(new), hkv, d))
            log(f"{what}: rel-L2 {err:.3e}, max-abs {max_abs:.3e} | whole call "
                f"{ms:.4f} ms | the bf16 kernel on the dequantized pool "
                f"{bf16_ms:.4f} ms | bound {bnd['bound_ms']:.4f} ms "
                f"({bnd['bound_by']}, {bnd['bound_ms'] / ms:.1%} of the call) "
                f"[{label}]")
            if i == 0 and fmt == "int8":
                entry.update(sub, bf16_ms=bf16_ms, **bnd,
                             shape=f"b{b} hq{hq} hkv{hkv} d{d} page{page} "
                                   f"max_pages{max_pages} t{t} old_lengths{old}")
            elif i == 0:
                entry.update(fp8_ms=ms, fp8_kernel_ms=sub["kernel_ms"])
    for fmt in FMTS:
        entry["max_abs_err"] = max(entry["max_abs_err"], ext_edges(
            device, label, fmt, EXT_EDGE_SHAPES_8BIT))
    return entry


def bwd_entries(src_suffix=""):
    """The JSON entries of rows 4 (kernel A, csrc/flash_bwd_sm90.cuh) and 5
    (kernel B, csrc/flash_bwd_dq_sm90.cuh), `src_suffix` after their
    names."""
    src = f"{TPU}/flash_attention.py"
    return (dict(name=f"flash_bwd_dkdv{src_suffix}", route="cuda",
                 source=f"{PKG}/csrc/flash_bwd_sm90.cuh", replaces=f"{src}:1949",
                 max_abs_err=0.0),
            dict(name=f"flash_bwd_dq{src_suffix}", route="cuda",
                 source=f"{PKG}/csrc/flash_bwd_dq_sm90.cuh", replaces=f"{src}:2203",
                 max_abs_err=0.0))


def hold_bwd(what, grads, plain, entries, fuse):
    """dq, dk and dv of one `_bwd` call against plain: bf16, finite,
    rel-L2 within O_TOL; the max-abs errors go to the entries (kernel A's
    dk and dv and, fused, its dq; else kernel B's dq). Returns the
    rel-L2s."""
    import torch

    errs = []
    for name, got, want in zip(("dq", "dk", "dv"), grads, plain):
        assert got.shape == want.shape and got.dtype == torch.bfloat16
        if not torch.isfinite(got).all():
            raise AssertionError(f"{what}: {name} is not finite")
        err = _rel_l2(got, want)
        if not err <= O_TOL:
            raise AssertionError(f"{what}: {name} rel-L2 {err:.3e} > {O_TOL}")
        errs.append(err)
        entry = entries[1] if name == "dq" and not fuse else entries[0]
        entry["max_abs_err"] = max(entry["max_abs_err"],
                                   float((got.float() - want.float()).abs().max()))
    return errs


def phase_backward(device, shapes, label, entry_shape):
    """The backward in both dq schedules against `_bwd_plain`, bf16, on the
    same (o, lse) from the forward kernel, at each (b, hq, hkv, n, s, d,
    causal, q_offset); small shapes also against the float64 oracle.
    Returns the kernels' JSON entries (row 4: kernel A, row 5: kernel B),
    timed at shapes[entry_shape]: kernel A alone and with the fused dq,
    kernel B, each against its bound."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import flash_attention as fa
    from flashattention_kernel_project_tpu_torch.utils import oracles

    gen = torch.Generator(device=device).manual_seed(13)
    dkdv, dq_e = entries = bwd_entries()
    for i, (b, hq, hkv, n, s, d, causal, q_offset) in enumerate(shapes):
        q, do = (torch.randn(b, hq, n, d, generator=gen, device=device).bfloat16()
                 for _ in range(2))
        k, v = (torch.randn(b, hkv, s, d, generator=gen, device=device).bfloat16()
                for _ in range(2))
        scale = d ** -0.5
        o, lse = fa._fwd(q, k, v, causal, scale, q_offset)
        plain = fa._bwd_plain(q, k, v, o, lse, do, causal, scale, q_offset)
        shape = (f"b{b} hq{hq} hkv{hkv} n{n} s{s} d{d} causal={causal} "
                 f"q_offset={q_offset}")
        small = b * hq * n * s <= 16 * 1024 * 1024
        exp = (oracles.gqa_attention_grads(
            *(x.float().cpu().numpy() for x in (q, k, v, do)), causal=causal,
            q_offset=q_offset) if small else None)
        line = []
        for fuse in (True, False):
            grads = fa._bwd(q, k, v, o, lse, do, causal, scale, q_offset,
                            fuse_dq=fuse)
            torch.cuda.synchronize()
            errs = hold_bwd(f"backward (fuse_dq={fuse}) {shape}", grads, plain,
                            entries, fuse)
            oracle = ""
            if exp is not None:
                oerrs = [_rel_l2(got, torch.from_numpy(want))
                         for got, want in zip(grads, exp)]
                if not max(oerrs) <= O_TOL:
                    raise AssertionError(f"backward (fuse_dq={fuse}) vs float64 "
                                         f"oracle rel-L2 {oerrs}")
                oracle = " | vs float64 " + " ".join(f"{e:.2e}" for e in oerrs)
            line.append(f"fuse_dq={fuse}: rel-L2 dq {errs[0]:.2e} dk {errs[1]:.2e} "
                        f"dv {errs[2]:.2e}{oracle}")
            del grads
        del plain, exp
        args = (q, k, v, do, *fa._bwd_rows(lse, o, do), causal, scale, q_offset)
        iters = 1 if not small else 10
        p1 = time_ms(lambda: fa._bwd_plain(q, k, v, o, lse, do, causal, scale,
                                           q_offset), device, iters)
        kv_ms = time_ms(lambda: fa._dkdv_cuda(*args), device, iters)
        fused_ms = time_ms(lambda: fa._fused_cuda(*args), device, iters)
        dq_ms = time_ms(lambda: fa._dq_cuda(*args), device, iters)
        bwd_ms = time_ms(lambda: fa._bwd(q, k, v, o, lse, do, causal, scale,
                                         q_offset), device, iters)
        p2 = time_ms(lambda: fa._bwd_plain(q, k, v, o, lse, do, causal, scale,
                                           q_offset), device, iters)
        plain_ms = min(p1, p2)
        pairs = b * hq * visible_pairs(n, s, q_offset, causal)
        log(f"flash_bwd {shape}: " + "; ".join(line) + f" | kernel A {kv_ms:.4f} "
            f"ms, with the fused dq {fused_ms:.4f} ms, kernel B {dq_ms:.4f} ms, "
            f"_bwd (default, with delta) {bwd_ms:.4f} ms "
            f"({10 * d * pairs / bwd_ms / 1e9:.1f} TFLOP/s at 5 products) vs "
            f"plain {plain_ms:.4f} ms [{label}]")
        if i == entry_shape:
            # the library: autograd's backward through one SDPA call, which
            # gives dq, dk and dv together (both rows carry its time)
            qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
            out = sdpa_fn(qg, kg, vg, causal=causal)()
            library_ms = time_ms(lambda: torch.autograd.grad(
                out, (qg, kg, vg), do, retain_graph=True), device, iters)
            del out, qg, kg, vg
            # kernel A: S, dP, dV, dK (and dQ fused); kernel B: S, dP, dQ
            # (2*d operations each per visible pair); each reads q, k, v,
            # do, lse, delta
            reads = nbytes(q, k, v, do, lse, lse)
            fused = bound(10 * d * pairs, reads + nbytes(k, v) + 2 * nbytes(q))
            dkdv.update(ms=kv_ms, plain_ms=plain_ms, library_ms=library_ms,
                        **bound(8 * d * pairs, reads + nbytes(k, v)), shape=shape,
                        fused_ms=fused_ms, fused_bound_ms=fused["bound_ms"])
            dq_e.update(ms=dq_ms, plain_ms=plain_ms, library_ms=library_ms,
                        **bound(6 * d * pairs, reads + nbytes(q)), shape=shape)
            log(f"flash_bwd at the entries' shape: bound kernel A "
                f"{dkdv['bound_ms']:.4f} ms ({dkdv['bound_by']}; "
                f"{100 * dkdv['bound_ms'] / kv_ms:.1f}% of it), with the fused "
                f"dq {fused['bound_ms']:.4f} ms "
                f"({100 * fused['bound_ms'] / fused_ms:.1f}%), kernel B "
                f"{dq_e['bound_ms']:.4f} ms ({dq_e['bound_by']}; "
                f"{100 * dq_e['bound_ms'] / dq_ms:.1f}%), SDPA backward "
                f"{library_ms:.4f} ms")
    return dkdv, dq_e


# The backward's wgmma instances: kernel A (csrc/flash_bwd_sm90.cuh) by
# (d, band, kFuseDq), each (d, kFuseDq) in a source of its own; kernel B
# (csrc/flash_bwd_dq_sm90.cuh) by (d, band), each d in its own
BWD_KERNEL = "flash_bwd_sm90_kernel"
BWD_DQ_KERNEL = "flash_bwd_dq_sm90_kernel"
BWD_OBJECTS = {"flash_bwd_kv64.cu": (64, 0), "flash_bwd_kv128.cu": (128, 0),
               "flash_bwd_fused64.cu": (64, 1), "flash_bwd_fused128.cu": (128, 1)}
BWD_DQ_OBJECTS = {"flash_bwd_dq64.cu": 64, "flash_bwd_dq128.cu": 128}


def phase_bwd_sm90_build(build_log: str, label):
    """The backward's 12 wgmma instances through `wgmma_gate`: kernel A's 8
    (d 64 and 128, without and with a band, without and with the fused
    dq), each (d, kFuseDq) in its own source's object, and kernel B's 4
    (d, band), each d in its own."""
    a = wgmma_gate(build_log, BWD_KERNEL, template_args(BWD_KERNEL, 3),
                   {src: (lambda inst, df=df: (inst[0], inst[2]) == df)
                    for src, df in BWD_OBJECTS.items()},
                   {(d, w, fu) for d in (64, 128) for w in (0, 1) for fu in (0, 1)})
    b = wgmma_gate(build_log, BWD_DQ_KERNEL, template_args(BWD_DQ_KERNEL, 2),
                   {src: (lambda inst, d=d: inst[0] == d)
                    for src, d in BWD_DQ_OBJECTS.items()},
                   {(d, w) for d in (64, 128) for w in (0, 1)})
    log("backward: kernel A's 8 instances (d, band, fused dq) and kernel B's 4 "
        "(d, band) built with no spill and no serialized wgmma; SASS (HGMMA, "
        "UTMALDG, HMMA.16816): "
        + ", ".join(f"A{inst}: {c['HGMMA']}/{c['UTMALDG']}/{c['HMMA.16816']}"
                    for inst, c in sorted(a.items())) + "; "
        + ", ".join(f"B{inst}: {c['HGMMA']}/{c['UTMALDG']}/{c['HMMA.16816']}"
                    for inst, c in sorted(b.items())) + f" [{label}]")


# (b, hq, hkv, n, s, d, causal, q_offset, window, sinks) at the edges of the
# backward's tiles: kernel A's 128-key blocks and 64-row query tiles,
# kernel B's 128-row blocks and 64-key tiles; GQA groups 1, 2, 4 and 8
BWD_TILE_SHAPES = [
    (1, 2, 1, 200, 333, 128, False, 0, 0, 0),    # n, s off the tiles
    (2, 4, 1, 200, 333, 64, False, 0, 0, 0),
    (1, 4, 4, 130, 300, 64, True, 170, 0, 0),    # q_offset with n < s
    (1, 4, 2, 300, 700, 128, True, 400, 0, 0),
    (1, 4, 2, 1024, 1024, 128, True, 0, 256, 200),  # sinks wider than a tile
    (1, 4, 2, 1024, 1024, 64, True, 0, 256, 200),
    (1, 8, 1, 256, 256, 64, True, 0, 100, 150),
    (1, 2, 1, 100, 100, 128, True, -50, 0, 0),   # rows before the first key
    (1, 8, 1, 300, 300, 64, True, -70, 0, 0),
    (2, 4, 1, 520, 520, 128, True, 0, 0, 0),     # more tiles than one block
]


def phase_bwd_tiles(device, label, shapes=BWD_TILE_SHAPES):
    """The backward (kernels A and B) at the edges of its tiles, in both dq
    schedules, against `_bwd_plain` (rel-L2 O_TOL) and, at most 4 x 256 x
    256 (query, key) pairs without a window, the float64 oracle; each call
    counted in its schedule's counter, and dq exactly 0 for the rows that
    see no key."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import flash_attention as fa
    from flashattention_kernel_project_tpu_torch.utils import oracles

    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(67)
    worst = {True: 0.0, False: 0.0}
    entries = bwd_entries()
    n_oracle = 0
    for b, hq, hkv, n, s, d, causal, q_off, win, sinks in shapes:
        q, do = (torch.randn(b, hq, n, d, generator=gen, device=device).bfloat16()
                 for _ in range(2))
        k, v = (torch.randn(b, hkv, s, d, generator=gen, device=device).bfloat16()
                for _ in range(2))
        band = (causal, d ** -0.5, q_off, win, sinks)
        o, lse = fa._fwd(q, k, v, *band)
        plain = fa._bwd_plain(q, k, v, o, lse, do, *band)
        exp = None
        if not win and b * hq * n * s <= 4 * 256 * 256:
            exp = oracles.gqa_attention_grads(
                *(x.float().cpu().numpy() for x in (q, k, v, do)), causal=causal,
                q_offset=q_off)
            n_oracle += 1
        for fuse in (True, False):
            what = (f"backward (fuse_dq={fuse}) b{b} hq{hq} hkv{hkv} n{n} s{s} "
                    f"d{d} causal={causal} q_offset={q_off} window={win} "
                    f"sinks={sinks}")
            before = fa._bwd.fused_launches, fa._bwd.split_launches
            grads = fa._bwd(q, k, v, o, lse, do, *band, fuse_dq=fuse)
            torch.cuda.synchronize()
            took = (fa._bwd.fused_launches - before[0],
                    fa._bwd.split_launches - before[1])
            if took != ((1, 0) if fuse else (0, 1)):
                raise AssertionError(f"{what}: schedule counters moved by {took}")
            errs = hold_bwd(what, grads, plain, entries, fuse)
            worst[fuse] = max(worst[fuse], *errs)
            if exp is not None:
                oerrs = [_rel_l2(got, torch.from_numpy(want))
                         for got, want in zip(grads, exp)]
                if not max(oerrs) <= O_TOL:
                    raise AssertionError(f"{what}: rel-L2 {oerrs} from the "
                                         "float64 oracle")
            if q_off < 0 and grads[0][:, :, :min(-q_off, n)].any():
                raise AssertionError(f"{what}: dq of a row that sees no key is "
                                     "not 0")
    log(f"backward at tile edges ({len(shapes)} shapes, both dq schedules; the "
        f"oracle at {n_oracle} shapes of <= 4x256x256 pairs): worst rel-L2 vs "
        f"plain fused {worst[True]:.3e}, two-kernel {worst[False]:.3e}; dq = 0 "
        f"exactly where a row sees no key ({time.perf_counter() - t0:.1f} s) "
        f"[{label}]")


def sdpa_backward_ms(q, k, v, do, mask, causal, device):
    """SDPA's backward on (q, k, v, do): the time of one forward and
    backward through autograd less that of the forward alone, both from
    CUDA graphs (the capture holds the autograd graph's own ops), or eager
    where the capture fails; returns (ms, how it was timed)."""
    import torch

    fwd = sdpa_fn(q, k, v, mask=mask, causal=causal)
    qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
    both = sdpa_fn(qg, kg, vg, mask=mask, causal=causal)
    step = lambda: torch.autograd.grad(both(), (qg, kg, vg), do)  # noqa: E731
    try:
        return time_ms(step, device, graph=True) - time_ms(fwd, device, graph=True), \
            "CUDA graphs"
    except RuntimeError as e:
        log(f"SDPA's forward and backward did not capture ({e}); timed eager")
        torch.cuda.synchronize()
        return time_ms(step, device) - time_ms(fwd, device), "eager"


def phase_bwd_sm90_times(device, label):
    """`_bwd` in each dq schedule in turns with SDPA's backward (forward
    and backward less the forward), from CUDA graphs: the training shape
    (4 x 16/4 heads x 4096 x 128, causal), bench.py's b = 1, d = 64 and the
    training band (window 1024, 64 sinks; SDPA with the band as a boolean
    mask). Each with its bounds (10*d flops a visible pair for the fused
    schedule's 5 products, 14*d for the two-kernel one's 7, at 989
    TFLOP/s, or the bytes), factor against SDPA and share of the bound,
    and the time of the plain torch around the kernels (`_bwd_rows`).
    Returns {case: row}."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(71)
    cases = [  # name, (b, n, d, window, sinks)
        ("training shape", (4, 4096, 128, 0, 0)),
        ("bench.py's b=1", (1, 4096, 128, 0, 0)),
        ("d=64", (4, 4096, 64, 0, 0)),
        (f"training band ({TRAIN_WINDOW}, {TRAIN_SINKS} sinks)",
         (4, 4096, 128, TRAIN_WINDOW, TRAIN_SINKS)),
    ]
    rows = {}
    for name, (b, n, d, win, sinks) in cases:
        q, do = (torch.randn(b, 16, n, d, generator=gen, device=device).bfloat16()
                 for _ in range(2))
        k, v = (torch.randn(b, 4, n, d, generator=gen, device=device).bfloat16()
                for _ in range(2))
        band = (True, d ** -0.5, 0, win, sinks)
        o, lse = fa._fwd(q, k, v, *band)
        mask = band_mask(n, n, 0, win, sinks, device) if win else None
        sdpa1, how = sdpa_backward_ms(q, k, v, do, mask, not win, device)
        ms = {}
        for fuse in (True, False, False, True):
            t = time_ms(lambda: fa._bwd(q, k, v, o, lse, do, *band, fuse_dq=fuse),
                        device, graph=True)
            ms[fuse] = min(ms.get(fuse, t), t)
        sdpa2, _ = sdpa_backward_ms(q, k, v, do, mask, not win, device)
        sdpa = min(sdpa1, sdpa2)
        # the plain torch `_bwd` runs around its kernels: lse * log2(e),
        # delta = rowsum(o * do) in float32, their pads
        rows_ms = time_ms(lambda: fa._bwd_rows(lse, o, do), device, graph=True)
        pairs = b * 16 * band_pairs(n, n, 0, win, sinks)
        moved = nbytes(q, k, v, o, lse, do) + nbytes(q, k, v)
        five, seven = bound(10 * d * pairs, moved), bound(14 * d * pairs, moved)
        rows[name] = dict(fused_ms=ms[True], split_ms=ms[False], sdpa_ms=sdpa,
                          sdpa_timed=how, torch_ms=rows_ms,
                          bound5_ms=five["bound_ms"], bound7_ms=seven["bound_ms"])
        log(f"backward, {name} ({b}x16/4x{n}x{d}): fused {ms[True]:.4f} ms "
            f"({ms[True] / sdpa:.2f}x SDPA, {100 * five['bound_ms'] / ms[True]:.1f}% "
            f"of the 5-product bound), two-kernel {ms[False]:.4f} ms "
            f"({ms[False] / sdpa:.2f}x, {100 * seven['bound_ms'] / ms[False]:.1f}% of "
            f"the 7-product bound), SDPA backward {sdpa:.4f} ms ({how}; "
            f"{100 * five['bound_ms'] / sdpa:.1f}% of the 5-product bound); bounds "
            f"{five['bound_ms']:.4f} / {seven['bound_ms']:.4f} ms "
            f"({five['bound_by']}); of which plain torch (lse2, delta) "
            f"{rows_ms:.4f} ms [{label}]")
    log(f"backward timed at {len(cases)} cases in {time.perf_counter() - t0:.1f} s")
    return rows


def motif_corpus(cfg, n_tokens=1 << 17, motif_len=512):
    """A random motif tiled (examples/train_and_serve.py's toy corpus), so
    that a few steps can lower the loss."""
    motif = np.random.default_rng(0).integers(0, cfg.vocab_size, motif_len)
    return np.resize(motif, n_tokens).astype(np.uint32)


def phase_train(device, cfg, params, corpus, batch, seq, lr, steps, label,
                kernels=None, profile=None):
    """bench_train.py's training loop in the port: a seeded token file
    streamed through the native TokenLoader, one warm-up and `steps` timed
    sgd_train_steps. Every loss finite, the first within 1.0 of
    ln(vocab), a fixed held-out batch's loss lower after the steps, and
    (on a GPU) the forward and both backward kernels launched (with the
    config's window, if it has one; `kernels` names the counters to read
    instead); then one step profiled (by `profile`, profile_step's
    signature; profile_step by default). Returns the trained params, the
    kernels' launch counts and the median ms/step."""
    import shutil
    import tempfile

    import torch

    from flashattention_kernel_project_tpu_torch.models import transformer as tfm
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
            reset_counters()
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
            launches = {k: read_counters()[k] for k in kernels or (
                ("flash_fwd/window", "flash_bwd/window") if cfg.attn_window
                else ("flash_fwd", "flash_bwd"))}
            schedules = {k: read_counters()[k]
                         for k in ("flash_bwd", "flash_bwd/fused", "flash_bwd/split")}
            peak = torch.cuda.max_memory_allocated()
            (profile or profile_step)(cfg, params, tokens(), lr, label)
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
    # every backward in the default schedule (kernel A with its fused dq, or
    # kernel A then kernel B)
    from flashattention_kernel_project_tpu_torch.ops import flash_attention as fa

    taken = "flash_bwd/fused" if fa._FUSE_DQ_DEFAULT else "flash_bwd/split"
    if not schedules[taken] == schedules["flash_bwd"] > 0:
        raise AssertionError(f"the backward did not train in {taken}: {schedules}")
    launches.update(schedules)
    n_params = sum(x.numel() for x in tfm._leaves(params).values())
    ms = statistics.median(times)
    tok = batch * seq
    log(f"train: {cfg.n_layers} layers x d_model {cfg.d_model}, d_head "
        f"{cfg.d_head}, batch {batch} x seq {seq}, window {cfg.attn_window}, "
        f"sinks {cfg.attn_sinks}, attn_stable {cfg.attn_stable}, SGD "
        f"lr {lr}: losses " + " ".join(f"{x:.4f}" for x in losses)
        + f" | held-out {held0:.4f} -> {held1:.4f}")
    log(f"train: {ms:.2f} ms/step (median of {steps}; "
        + " ".join(f"{t:.2f}" for t in times) + f"), {tok / ms * 1e3:.0f} tok/s, "
        f"{6 * n_params * tok / ms / 1e9:.1f} TFLOP/s (6 x {n_params} params "
        f"x tokens), peak {peak / 2**30:.2f} GiB | launches {launches} [{label}]")
    return params, launches, ms


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
    from flashattention_kernel_project_tpu_torch.ops import gemm as g
    from flashattention_kernel_project_tpu_torch.ops import paged_decode as pd
    from flashattention_kernel_project_tpu_torch.ops import probes as pr
    from flashattention_kernel_project_tpu_torch.ops import quant as qt
    from flashattention_kernel_project_tpu_torch.ops import softmax as sm
    from flashattention_kernel_project_tpu_torch.ops import streaming as st

    return dict(flash_fwd=fa._fwd, flash_fwd_ragged=fa.flash_attention_ragged,
                flash_decode=fd.flash_decode, paged_decode=pd.paged_flash_decode,
                paged_extend=pd.paged_flash_extend, flash_bwd=fa._bwd,
                flash_decode_q=fd.flash_decode_int8,
                paged_decode_q=pd.paged_flash_decode_quant,
                flash_fwd_ragged_q=fa.flash_attention_ragged_kv_quant,
                paged_extend_q=pd.paged_flash_extend_quant,
                flash_fwd_q=fa.flash_attention_kv_quant, gemm=g.matmul,
                gemm_batched=g.batched_matmul,
                gemm_fused_epilogue=g.matmul_fused_epilogue,
                gemm_softmax=g.batched_matmul_softmax_epilogue,
                softmax=sm.softmax, gemm_w8=qt.matmul_int8_weights,
                gemm_w8_fp8=qt.matmul_fp8_weights, gemm_i8=qt.matmul_int8,
                streaming_decode=st.streaming_decode, probe_copy=pr.copy_probe,
                probe_qk=pr.qk_probe, probe_pv=pr.pv_probe,
                probe_chain=pr.softmax_chain_probe, probe_qk_kt=pr.qk_kt_probe,
                probe_qk_packed=pr.qk_packed_probe,
                probe_stream_copy=pr.stream_copy_probe)


# the counters a wrapper keeps beside `.launches` (its online launches, or
# all of them), by the suffix read_counters gives them
COUNTER_KINDS = dict(window="window_launches", fixed="fixed_launches",
                     hybrid="hybrid_launches", packed="packed_launches",
                     resident="resident_launches", fallback="fallback_launches",
                     mxu="mxu_launches", q_int8="q_int8_launches",
                     guard="guard_launches", slots="slots_launches",
                     transpose="transpose_launches",
                     copy_only="copy_only_launches", sm90="sm90_launches",
                     f32x="f32x_launches",
                     fused="fused_launches", split="split_launches",
                     slab="slab_launches", wgmma="wgmma_launches")


def reset_counters():
    """Every launch counter to 0, those by window and discipline too."""
    for fn in _counters().values():
        fn.launches = 0
        for attr in COUNTER_KINDS.values():
            if hasattr(fn, attr):
                setattr(fn, attr, 0)


def read_counters() -> dict:
    """Launches by kernel name: "<name>" counts the wrapper's online (or
    only) launches; a wrapper that also counts its launches with a sliding
    window, in the fixed-max or hybrid discipline, or through the packed
    forward adds them as "<name>/window", "/fixed", "/hybrid", "/packed";
    the softmax-epilogue GEMM its resident (one-sweep) launches and the
    gated rows launches after them as "/resident" and "/fallback"."""
    out = {}
    for name, fn in _counters().items():
        out[name] = fn.launches
        for kind, attr in COUNTER_KINDS.items():
            if hasattr(fn, attr):
                out[f"{name}/{kind}"] = getattr(fn, attr)
    return out


SLICE_METRICS = {}  # tag -> ServingMetrics of each slice served in this run
SLICE_TOKENS = {}   # tag -> its tokens, in submission order


def serve(device, cfg, params, prompts, max_new, kernels, label, tag, **kw):
    """Serve `prompts` through Scheduler(**kw) after a warm-up run on a
    throwaway scheduler, with every launch counter set to 0 just before.
    Every request must return max_new in-vocab tokens, and (on a GPU) each
    kernel named in `kernels` must have launched ("<name>/window": with a
    sliding window). Returns (scheduler,
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
    reset_counters()
    uids = [sched.submit(p, max_new_tokens=max_new) for p in prompts]
    out = sched.run()
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = read_counters()
    for u in uids:
        if len(out[u]) != max_new:
            raise AssertionError(f"request {u} returned {len(out[u])} tokens")
        if not all(0 <= t < cfg.vocab_size for t in out[u]):
            raise AssertionError(f"request {u} returned out-of-vocab tokens")
    if device.type == "cuda" and not all(launches[k] for k in kernels):
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    m = SLICE_METRICS[tag] = sched.metrics()
    SLICE_TOKENS[tag] = [out[u] for u in uids]
    opts = ", ".join(  # a draft's config by its depth and width, not its params
        f"{k}={v.n_layers} layers d_ff {v.d_ff}" if k == "draft_cfg" else f"{k}={v}"
        for k, v in kw.items() if k != "draft_params")
    log(f"{tag}: {len(prompts)} requests x {max_new} new tokens, {opts}, "
        f"prompt lengths {sorted(len(p) for p in prompts)}")
    log(f"{tag}: {m.tokens} tokens in {m.wall_s:.3f} s = {m.tok_per_s:.1f} "
        f"tok/s | TTFT mean {m.ttft_s_mean * 1e3:.1f} ms p95 "
        f"{m.ttft_s_p95 * 1e3:.1f} ms | latency mean "
        f"{m.latency_s_mean * 1e3:.1f} ms p95 {m.latency_s_p95 * 1e3:.1f} ms"
        f" | kernel launches { {k: n for k, n in launches.items() if n} } "
        f"[{label}]")
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
        ("flash_fwd_ragged", "flash_fwd_ragged/wgmma", "paged_decode"), label,
        "paged slice",
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
    step, over an int8 cache when `quantized`, which then counts the
    cache's own error)."""

    def __init__(self, cfg, params, prefix, quantized=False):
        from flashattention_kernel_project_tpu_torch.models import engine

        self.cfg, self.params = cfg, params
        full = self.last_logits(prefix)
        cache = engine.init_cache(cfg, 1, len(prefix) + 1, params["embed"].device,
                                  quantized=quantized)
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
             ("flash_fwd", "flash_fwd_ragged", "flash_fwd_ragged/slab",
              "flash_decode")),
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


def pool_bytes(cache) -> int:
    """Device bytes of a paged cache's pools (values and any scale pages)."""
    pools = cache.k_pages + cache.v_pages
    if cache.quantized:
        pools = pools + cache.k_scale_pages + cache.v_scale_pages
    return nbytes(*pools)


def phase_8bit_slices(device, cfg, params, draft_cfg, draft_params, prompts,
                      system, max_batch, max_len, max_new, label):
    """The serving requests through Scheduler(quantized_cache=True), the
    int8 cache of bench_serving.py --int8, five ways: (i) linear, (ii) the
    paged, prefix-cached, chunked mode with the shared system prompt,
    (iii) multi_step=4, whose tokens must equal (i)'s, (iv) speculative on
    the page pool and (v) speculative on the linear cache, both with the
    bench_spec draft. Each must launch its mode's 8-bit kernels (and not
    the bf16 one they replace); the paged runs give every page back; every
    divergence of (iv) and (v) from (i) must be a near-tie of the int8
    path. Each is printed beside the bf16 slice of the same mode from this
    run, and the paged pool's bytes beside the bf16 pool's. Returns the
    launches of each run by its tag."""
    base = dict(max_batch=max_batch, max_len=max_len, quantized_cache=True)
    spec = dict(draft_cfg=draft_cfg, draft_params=draft_params, spec_k=SPEC_K)
    paged = dict(paged=True, page_size=128)
    with_system = [np.concatenate([system, p]).astype(np.int32) for p in prompts]
    runs = (  # tag, prompts, options, kernels that must launch, that must not, bf16 tag
        ("int8 slice (linear)", prompts, {}, ("flash_fwd", "flash_decode_q"),
         ("flash_decode",), "slice"),
        ("int8 slice (paged)", with_system,
         dict(paged, prefix_cache=True, prefill_chunk=256),
         ("flash_fwd_ragged", "paged_decode_q"), ("paged_decode", "flash_decode"),
         "paged slice"),
        ("int8 slice (multi_step=4)", prompts, dict(multi_step=4),
         ("flash_fwd", "flash_decode_q"), ("flash_decode",), "multi_step slice"),
        ("int8 spec slice (paged)", prompts, dict(spec, **paged),
         ("flash_fwd", "paged_extend_q", "flash_decode"),
         ("paged_extend", "paged_decode_q"), "spec slice (paged)"),
        ("int8 spec slice (linear)", prompts, spec,
         ("flash_fwd", "flash_fwd_ragged_q", "flash_fwd_ragged_q/slab",
          "flash_decode"),
         ("flash_fwd_ragged",), "spec slice (linear)"),
    )
    out, tokens = {}, {}
    tie = None
    for tag, reqs, kw, kernels, absent, bf16_tag in runs:
        sched, tokens[tag], launches = serve(device, cfg, params, reqs, max_new,
                                             kernels, label, tag, **base, **kw)
        if any(launches[k] for k in absent):
            raise AssertionError(f"{tag} ran a bf16 kernel it replaces: {launches}")
        if not sched.cache.quantized:
            raise AssertionError(f"{tag}: the batch cache is not 8-bit")
        if kw.get("paged"):
            if sched._pool.free_pages != sched._n_pages - 1:
                raise AssertionError(f"{tag}: {sched._pool.free_pages} of "
                                     f"{sched._n_pages - 1} pages back")
            if kw.get("prefix_cache") and not sched.prefix_hits > 0:
                raise AssertionError(f"{tag}: no insert reused the prefix's pages")
            bf16_bytes = nbytes(*sched.cache.k_pages, *sched.cache.v_pages) * 2
            log(f"{tag}: pool of {sched._n_pages} pages of 128 rows: "
                f"{pool_bytes(sched.cache) / 2**20:.1f} MiB (int8 values and f32 "
                f"scales) vs {bf16_bytes / 2**20:.1f} MiB for the same pages in "
                f"bf16; prefix reuse {sched.prefix_hits} of {len(reqs)}")
        detail = ""
        if tag == "int8 slice (multi_step=4)":
            same = np.mean([a == b for x, y in zip(tokens[tag],
                                                   tokens["int8 slice (linear)"])
                            for a, b in zip(x, y)])
            if same != 1.0:
                raise AssertionError(f"{tag}: tokens equal to multi_step=1 only "
                                     f"{same:.4f}")
            detail = "; tokens equal to (i) 1.0000"
        if "spec" in tag:
            ref = tokens["int8 slice (linear)"]
            if tie is None:
                tie = NearTie(cfg, params, list(prompts[0]) + ref[0][:1],
                              quantized=True)
            windows, gaps = tie.audit(tokens[tag], ref, prompts, tag)
            same = np.mean([a == b for x, y in zip(tokens[tag], ref)
                            for a, b in zip(x, y)])
            per_round = sched.spec_committed / max(sched.spec_slot_rounds, 1)
            detail = (f"; tokens equal to (i) {same:.4f}, {len(gaps)} divergences,"
                      f" all near-ties (gaps {[f'{g:.2e}' for g in gaps]}, bound "
                      f"{tie.bound:.2e} = max(8 x eps {tie.eps:.2e}, 1e-3)); "
                      f"{per_round:.3f} committed tokens a slot-round")
        m, ref = SLICE_METRICS[tag], SLICE_METRICS[bf16_tag]
        log(f"{tag} vs the bf16 {bf16_tag} (same run): {m.tok_per_s:.1f} vs "
            f"{ref.tok_per_s:.1f} tok/s | TTFT mean {m.ttft_s_mean * 1e3:.1f} vs "
            f"{ref.ttft_s_mean * 1e3:.1f} ms, p95 {m.ttft_s_p95 * 1e3:.1f} vs "
            f"{ref.ttft_s_p95 * 1e3:.1f} ms | latency mean "
            f"{m.latency_s_mean * 1e3:.1f} vs {ref.latency_s_mean * 1e3:.1f} ms, "
            f"p95 {m.latency_s_p95 * 1e3:.1f} vs {ref.latency_s_p95 * 1e3:.1f} ms"
            f"{detail} [{label}]")
        out[tag] = launches
        del sched
    return out


def phase_int8_weights(device, cfg, params, label):
    """One decode step with int8 weight-only parameters
    (quantize_decode_params) against the bf16 step from the same cache, at
    tests/test_model.py:92-111's 5e-2, and the weight bytes a step reads."""
    import torch

    from flashattention_kernel_project_tpu_torch.models import engine

    gen = torch.Generator(device=device).manual_seed(47)
    prompt = torch.randint(0, cfg.vocab_size, (8, 128), generator=gen,
                           device=device, dtype=torch.int32)
    cache = engine.init_cache(cfg, 8, 130, device)
    logits, cache = engine.prefill(cfg, params, prompt, cache)
    nxt = logits.argmax(-1).to(torch.int32)
    fused = engine.fuse_decode_params(cfg, params)
    q8 = engine.quantize_decode_params(cfg, fused)
    lengths = cache.lengths.clone()
    lf, _ = engine.decode_step(cfg, fused, nxt, cache)
    cache.lengths.copy_(lengths)
    lq, _ = engine.decode_step(cfg, q8, nxt, cache)
    torch.cuda.synchronize()
    err = _rel_l2(lq, lf)
    same = (lq.argmax(-1) == lf.argmax(-1)).float().mean().item()
    wb = nbytes(*fused["layers"].values(), fused["embed"])
    wq = nbytes(*q8["layers"].values(), q8["lm_head_q"], q8["lm_head_s"])
    log(f"int8 weights: decode step (B=8, 128-token prompts) vs the bf16 step: "
        f"logits rel-L2 {err:.3e} (bound 5e-2), equal greedy tokens {same:.3f} "
        f"| layer and head weights a step reads {wq / 2**20:.1f} MiB vs "
        f"{wb / 2**20:.1f} MiB in bf16 [{label}]")
    if not err <= 5e-2:
        raise AssertionError(f"int8-weight decode logits rel-L2 {err:.3e} > 5e-2")


def device_ms_by_kind(prof) -> dict:
    """Device milliseconds of a torch.profiler window by kind of kernel:
    this repo's attention kernels by name (the Hopper forward as flash_fwd,
    the ragged forward's routes as flash_fwd_ragged (wgmma) and
    ragged_slab; the mma.sync core's flavours of earlier commits 0, 1 as
    flash_fwd, flash_fwd_ragged, 2 as the paged extend, which
    tools/ab_ragged.py and ab_paged_extend.py run), the GEMMs, the cache
    appends and the rest."""
    from torch.autograd import DeviceType

    flavours = {"0": "flash_fwd", "1": "flash_fwd_ragged", "2": "paged_extend"}
    kinds = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        key = e.key
        fwd = re.search(r"flash_fwd(_q)?_kernel<\d+, (\d)", key)
        ours = re.search(r"(paged|flash)_(decode|extend)(_q)?(_sm90)?_kernel", key)
        sm90 = re.search(r"(flash_fwd|flash_fwd_q|flash_fwd_ragged|ragged_slab)"
                         r"_sm90_kernel", key)
        if sm90:
            kind = sm90.group(1)
        elif fwd:
            kind = flavours[fwd.group(2)] + ("_q" if fwd.group(1) else "")
        elif ours:
            kind = ours.group(0).replace("_kernel", "")
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
                         steps=20, window=5, one_attention_op=True):
    """Where a decode step's time goes, the linear cache against the paged
    one, bf16 and int8, at the serving batch (`batch` slots of `length`
    tokens): host milliseconds a step with one host sync a step (the
    Scheduler's pattern), then `window` steps under torch.profiler: device
    time by kind and the device's busy share of the window's wall time.
    With one_attention_op a step must run its attention as one device
    operation a layer (the paged decode, the bf16 or the 8-bit linear
    decode, its splits merged on the card)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from flashattention_kernel_project_tpu_torch.models import engine

    dec = engine.fuse_decode_params(cfg, params)
    pages = -(-(length + steps + window + 1) // 128)
    tok = torch.zeros(batch, dtype=torch.int32, device=device)
    for name, step, quantized in (
            ("linear", engine.decode_step, False),
            ("paged", engine.decode_step_paged, False),
            ("int8 linear", engine.decode_step, True),
            ("int8 paged", engine.decode_step_paged, True)):
        if step is engine.decode_step:
            cache = engine.init_cache(cfg, batch, 2048, device,
                                      quantized=quantized)
        else:
            cache = engine.init_paged_cache(
                cfg, batch, batch * pages + 1, device, page_size=128,
                max_pages_per_seq=pages, quantized=quantized)
            cache.block_tables.copy_(torch.arange(
                1, batch * pages + 1, device=device,
                dtype=torch.int32).view(batch, pages))
        cache.lengths.fill_(length)
        step(cfg, dec, tok, cache)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, _ = step(cfg, dec, tok, cache)
            logits.argmax(-1).cpu()
        host_ms = (time.perf_counter() - t0) * 1e3 / steps
        for _ in range(3):  # a window that records no device operation: again
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(window):
                    logits, _ = step(cfg, dec, tok, cache)
                    logits.argmax(-1).cpu()
                wall = (time.perf_counter() - t0) * 1e3
            ops = sum(e.count for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA)
            if ops:
                break
        kinds = device_ms_by_kind(prof)
        busy = sum(kinds.values())
        attn_kernel = (PDEC_KERNEL if step is engine.decode_step_paged
                       else DEC_Q_KERNEL if quantized else DEC_KERNEL)
        if one_attention_op:
            attn = sum(e.count for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA and attn_kernel in e.key)
            log(f"{name} decode step: {attn} {attn_kernel} launches in {window} "
                f"steps of {cfg.n_layers} layers (one a layer expected) [{label}]")
            if attn != window * cfg.n_layers:
                raise AssertionError(f"{name} decode step: {attn} {attn_kernel} "
                                     f"launches, {window * cfg.n_layers} expected")
        log(f"{name} decode step (B={batch}, lengths {length}): {ops / window:.1f} "
            f"device operations a step | {host_ms:.3f} ms"
            f" a step on the host clock; profiled {window} steps: {busy / window:.3f}"
            f" ms of device time a step, busy {100 * busy / wall:.1f}% of "
            f"{wall / window:.3f} ms | " + ", ".join(
                f"{k} {v / window:.3f} ms ({100 * v / busy:.1f}%)"
                for k, v in sorted(kinds.items(), key=lambda kv: -kv[1]))
            + f" [{label}]")


def profile_spec_round(device, cfg, params, draft_cfg, draft_params, label,
                       batch=8, length=600, rounds=10, window=3,
                       quantized=False, paged=True):
    """Where a speculative round's time goes on the page pool (the linear
    cache with paged=False; an int8 one with `quantized`): `batch` requests
    of `length` prompt tokens in the speculative Scheduler; host
    milliseconds a round (each ends in the host's accept), then `window`
    rounds under torch.profiler: device time by kind, device operations a
    round and the device's busy share of the window's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from torch.autograd import DeviceType

    from flashattention_kernel_project_tpu_torch.models.serving import Scheduler

    pool = dict(paged=True, page_size=128) if paged else {}
    sched = Scheduler(cfg, params, max_batch=batch, max_len=2048, **pool,
                      draft_cfg=draft_cfg,
                      draft_params=draft_params, spec_k=SPEC_K,
                      quantized_cache=quantized)
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
    n_ops = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
    log(f"{'int8 ' if quantized else ''}{'paged' if paged else 'linear'} spec "
        f"round (B={batch}, prompts "
        f"{length}, spec_k {SPEC_K}, draft "
        f"{draft_cfg.n_layers} layers): {host_ms:.3f} ms a round on the host "
        f"clock; profiled {window} rounds ({committed:.2f} tokens a slot a "
        f"round): {busy / window:.3f} ms of device time a round, "
        f"{n_ops / window:.0f} device operations a round, busy "
        f"{100 * busy / wall:.1f}% of {wall / window:.3f} ms | " + ", ".join(
            f"{k} {v / window:.3f} ms ({100 * v / busy:.1f}%)"
            for k, v in sorted(kinds.items(), key=lambda kv: -kv[1]))
        + f" [{label}]")


def phase_paged_consistency(device, cfg, params, n_prompt, n_shared, chunk,
                            n_steps, label, quantized=False, tol=LOGITS_TOL):
    """Two prompts of n_prompt tokens, the second sharing the first's
    n_shared-token prefix. The first is prefilled through `extend` chunks
    into a batch-1 cache and paged_insert'ed; the second is built from
    cache_from_pages of the shared pages plus an `extend` of its suffix.
    Then n_steps greedy decode_step_paged steps of both; every step's
    logits against a full forward over the same tokens. `quantized`: an
    int8 pool (the prefix hit then dequantizes the shared pages)."""
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
                                    page_size=page, max_pages_per_seq=max_pages,
                                    quantized=quantized)
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
    tag = "paged consistency (int8 pool)" if quantized else "paged consistency"
    log(f"{tag}: 2 prompts of {n_prompt} (the second sharing "
        f"{n_shared} tokens = {len(shared)} pages through cache_from_pages), "
        f"extend chunks of {chunk} + {n_steps} decode_step_paged steps vs "
        f"forward: logits rel-L2 max {max(map(max, errs)):.3e} (first prompt "
        f"{max(errs[0]):.3e}, prefix path {max(errs[1]):.3e}) [{label}]")
    if not max(map(max, errs)) <= tol:
        raise AssertionError(f"{tag}: decode logits rel-L2 "
                             f"{max(map(max, errs)):.3e} > {tol}")
    return max(map(max, errs))


@contextlib.contextmanager
def moe_choices(pin=None):
    """Within the block, each call of models/moe.py's _top_k_choices (one a
    MoE layer, in call order) appends (router log-probabilities [T, E],
    choices [T, k]) to the list it yields. With pin(call, logp, choices) ->
    choices, a call routes its tokens to the experts pin returns in place
    of its own, the gates being their probabilities renormalized, as
    _top_k_choices computes them."""
    import torch

    from flashattention_kernel_project_tpu_torch.models import moe

    orig, calls = moe._top_k_choices, []

    def traced(probs, top_k):
        gates, masks, aux = orig(probs, top_k)
        choices = torch.stack([m.argmax(-1) for m in masks], dim=-1)
        if pin is not None:
            new = pin(len(calls), probs.log(), choices)
            if not torch.equal(new, choices):
                masks = [moe._one_hot(new[:, j], probs.shape[1], probs.dtype)
                         for j in range(top_k)]
                g = probs.gather(1, new)
                gates = g / g.sum(dim=-1, keepdim=True).clamp_min(1e-9)
                choices = new
        calls.append((probs.log(), choices))
        return gates, masks, aux

    moe._top_k_choices = traced
    try:
        yield calls
    finally:
        moe._top_k_choices = orig


class RoutePin:
    """The routing audit of an MoE model's cached decode against its full
    forward. Top-k routing is discontinuous: where a token's k-th and
    (k+1)-th router choices are near-tied, the bf16 floor between the two
    paths flips its experts, and its output moves by a gate times the
    difference of two experts, far past the floor. So the forward takes,
    at every token and layer, the experts the decode chose (its prefill
    for the prompt's positions, its steps after), and every such pin must
    be a near-tie by NearTie's rule: the decode's top-k margin (k-th minus
    (k+1)-th router log-probability) within max(8 eps, 1e-3), eps being
    the largest router log-probability difference between the two paths
    over the tokens and layers where they chose alike. The logits are
    then held to the gate unchanged, every step and row."""

    def __init__(self, cfg, dec_calls, n_prompt, n_steps):
        import torch

        n_layers, self.k = cfg.n_layers, cfg.moe_top_k
        self.n_prompt, self.flips, self.eps = n_prompt, [], 0.0
        self.want = []  # per layer: (log-probs [2, L, E], choices [2, L, k])
        for layer in range(n_layers):
            steps = [dec_calls[n_layers * i + layer]
                     for i in range(1, n_steps + 1)]
            self.want.append(tuple(
                torch.cat([dec_calls[layer][j].view(2, n_prompt, -1)]
                          + [c[j][:, None] for c in steps], dim=1)
                for j in (0, 1)))

    def __call__(self, layer, logp, choices):
        import torch

        want_lp, want = self.want[layer]
        lp, got = logp.view(*want_lp.shape), choices.view(*want.shape)
        differ = (got.sort(-1).values != want.sort(-1).values).any(-1)
        dz = (lp - want_lp).abs().amax(-1)  # [2, L]
        if (~differ).any():
            self.eps = max(self.eps, float(dz[~differ].max()))
        for row, pos in differ.nonzero().tolist():
            top = want_lp[row, pos].topk(self.k + 1).values
            self.flips.append((row, pos - self.n_prompt + 1, layer,
                               float(top[self.k - 1] - top[self.k]),
                               float(dz[row, pos])))
        return torch.where(differ[..., None], want, got).view(choices.shape)

    def audit(self, tag):
        """Raises where a pin is not at a near-tie; returns the bound."""
        bound = max(8.0 * self.eps, 1e-3)
        wide = [f for f in self.flips if not f[3] <= bound]
        if wide:
            raise AssertionError(
                f"{tag}: the decode and the forward route apart at a top-k "
                f"margin past {bound:.2e} (8 x eps {self.eps:.2e}): (row, "
                f"step, layer, margin, router log-prob difference) {wide}")
        return bound


def phase_consistency(device, cfg, params, n_prompt, n_steps, label,
                      quant_fmt=None, tol=LOGITS_TOL, what=""):
    """prefill + n_steps greedy decode_steps for 2 prompts; each step's
    logits against a full forward over the same tokens. With quant_fmt
    ("int8" or "fp8") the cache is 8-bit, and generate(quantized_cache=True,
    quant_fmt=...) must give the same greedy tokens. An MoE model decodes
    from its split parameters (the fused layout has no MoE form), and its
    forward takes the decode's experts where they are near-tied (RoutePin:
    its tokens' experts are otherwise a discontinuous function of the bf16
    floor)."""
    import torch

    from flashattention_kernel_project_tpu_torch.models import engine
    from flashattention_kernel_project_tpu_torch.models import transformer as tfm

    gen = torch.Generator(device=device).manual_seed(5)
    prompt = torch.randint(0, cfg.vocab_size, (2, n_prompt), generator=gen,
                           device=device, dtype=torch.int32)
    q8 = dict(quantized=True, quant_fmt=quant_fmt) if quant_fmt else {}
    cache = engine.init_cache(cfg, 2, n_prompt + n_steps + 1, device, **q8)
    moe_model = bool(cfg.moe_experts)
    with moe_choices() as dec_calls:
        logits, cache = engine.prefill(cfg, params, prompt, cache)
        dec = params if moe_model else engine.fuse_decode_params(cfg, params)
        steps = [logits]
        toks = [logits.argmax(-1).to(torch.int32)]
        for _ in range(n_steps):
            logits, cache = engine.decode_step(cfg, dec, toks[-1], cache)
            steps.append(logits)
            toks.append(logits.argmax(-1).to(torch.int32))
    seq = torch.cat([prompt, torch.stack(toks[:-1], dim=1)], dim=1)
    pin = RoutePin(cfg, dec_calls, n_prompt, n_steps) if moe_model else None
    with moe_choices(pin):
        full = tfm.forward(cfg, params, seq)[:, n_prompt - 1:]  # [2, steps+1, V]
    cached = torch.stack(steps, dim=1)
    assert cached.shape == full.shape and torch.isfinite(cached).all()
    errs = [_rel_l2(cached[:, i], full[:, i]) for i in range(n_steps + 1)]
    same = (cached.argmax(-1) == full.argmax(-1)).float().mean().item()
    tag = f"consistency ({quant_fmt} cache)" if quant_fmt else "consistency"
    if cfg.attn_window:
        tag = f"window {tag}"
    tag += what
    log(f"{tag}: prefill + {n_steps} decode steps vs forward, 2 prompts "
        f"of {n_prompt}, window {cfg.attn_window}, sinks {cfg.attn_sinks}: logits rel-L2 max {max(errs):.3e} mean "
        f"{sum(errs) / len(errs):.3e}, equal greedy tokens {same:.3f} [{label}]")
    log(f"{tag}: rel-L2 per step " + " ".join(f"{e:.2e}" for e in errs))
    if pin is not None:
        bound = pin.audit(tag)
        log(f"{tag}: the forward took the decode's experts at {len(pin.flips)}"
            f" (token, layer) of its own choosing, each a near-tie (margin <= "
            f"{bound:.2e}, 8 x eps {pin.eps:.2e}): (row, step (< 0: a prompt "
            f"position), layer, margin, router log-prob difference) "
            f"{[(r, i, l, f'{m:.2e}', f'{d:.2e}') for r, i, l, m, d in pin.flips]}")
    if not max(errs) <= tol:
        raise AssertionError(f"{tag}: decode logits rel-L2 {max(errs):.3e} > {tol}")
    if quant_fmt:
        out = engine.generate(cfg, params, prompt, max_new_tokens=n_steps + 1,
                              quantized_cache=True, quant_fmt=quant_fmt)
        if not torch.equal(out[:, n_prompt:], torch.stack(toks, dim=1)):
            raise AssertionError(f"{tag}: generate's tokens differ from the "
                                 "decode steps'")
        log(f"{tag}: generate(quantized_cache=True, quant_fmt={quant_fmt!r}) "
            f"gives the decode steps' {n_steps + 1} tokens a row")
    return max(errs)


# ---------------------------------------------------------------------------
# Sliding window and attention sinks: the band kernels against their plain
# versions, the band skip, the windowed serving slices and training.
# ---------------------------------------------------------------------------

# the serving model with Mistral's sliding window, cut to 256 keys so that it
# bites at max_len 2048, and StreamingLLM's four sinks
SERVING_WINDOW, SERVING_SINKS = 256, 4
# the training model with benchmarks/run_all.py:252's 64 sinks
TRAIN_WINDOW, TRAIN_SINKS = 1024, 64
# run_all.py:239-258's long-context case: 32K tokens, a 4K window, 64 sinks
LONG = dict(n=32768, window=4096, sinks=64)


def band_pairs(n, kv_len, q_offset, window, sinks) -> int:
    """(query, key) pairs that n causal queries at positions q_offset.. see
    among kv_len keys under a window (window 0: all causal keys): the band
    [pos - window + 1, pos] and the sink keys below it."""
    if not window:
        return visible_pairs(n, kv_len, q_offset, True)
    pos = np.arange(n) + q_offset
    hi = np.clip(pos + 1, 0, kv_len)         # keys [0, hi) are causal
    lo = np.clip(pos - window + 1, 0, None)  # the band [lo, hi)
    sink = np.minimum(np.minimum(sinks, lo), hi)
    return int((np.clip(hi - lo, 0, None) + sink).sum())


def band_mask(n, s, q_offset, window, sinks, device):
    """[n, s] bool: the forward's band mask, for SDPA's attn_mask."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import flash_attention as fa

    rows = torch.arange(n, device=device)[:, None] + q_offset
    return fa._band_mask(rows, torch.arange(s, device=device), window, sinks)


def _window_entry(name, source, replaces):
    return dict(name=f"{name} (window)", route="cuda", source=f"{PKG}/csrc/{source}",
                replaces=f"{TPU}/{replaces}", max_abs_err=0.0)


def phase_window_forward(device, shapes, label, entry_shape):
    """The forward kernel with a window and sinks against `_fwd_plain` over
    the same band, bf16, at each (b, hq, hkv, n, s, d, q_offset, window,
    sinks): O within O_TOL, the band LSE within LSE_TOL; timed beside the
    kernel without a window, and SDPA with the boolean band mask. The bound
    counts the band's pairs. Returns the entry timed at
    shapes[entry_shape]."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(43)
    entry = _window_entry("flash_fwd", "flash_fwd_sm90.cuh", "flash_attention.py:92")
    for i, (b, hq, hkv, n, s, d, q_off, window, sinks) in enumerate(shapes):
        q = torch.randn(b, hq, n, d, generator=gen, device=device).bfloat16()
        k = torch.randn(b, hkv, s, d, generator=gen, device=device).bfloat16()
        v = torch.randn(b, hkv, s, d, generator=gen, device=device).bfloat16()
        scale = d ** -0.5
        band = (True, scale, q_off, window, sinks)
        o, lse = fa.flash_attention_with_lse(q, k, v, causal=True, q_offset=q_off,
                                             window=window, sinks=sinks)
        po, plse = fa._fwd_plain(q, k, v, *band)
        torch.cuda.synchronize()
        assert torch.isfinite(o).all() and torch.isfinite(lse).all()
        err = _rel_l2(o, po)
        max_abs = float((o.float() - po.float()).abs().max())
        entry["max_abs_err"] = max(entry["max_abs_err"], max_abs)
        if not err <= O_TOL:
            raise AssertionError(f"windowed flash_fwd O rel-L2 {err:.3e} > {O_TOL}")
        torch.testing.assert_close(lse, plse, rtol=LSE_TOL, atol=LSE_TOL)
        del po, plse
        ms, plain_ms = time_pair(lambda: fa._fwd(q, k, v, *band),
                                 lambda: fa._fwd_plain(q, k, v, *band), device)
        causal_ms = time_ms(lambda: fa._fwd(q, k, v, True, scale, q_off), device,
                            graph=True)
        library_ms = time_ms(
            sdpa_fn(q, k, v, mask=band_mask(n, s, q_off, window, sinks, device)),
            device, graph=True)
        pairs = b * hq * band_pairs(n, s, q_off, window, sinks)
        bnd = bound(4 * d * pairs, nbytes(q, k, v, o, lse))
        shape = (f"b{b} hq{hq} hkv{hkv} n{n} s{s} d{d} q_offset{q_off} "
                 f"window{window} sinks{sinks}")
        log(f"flash_fwd (window) {shape}: O rel-L2 {err:.3e}, max-abs "
            f"{max_abs:.3e}, LSE ok | kernel {ms:.4f} ms "
            f"({4 * d * pairs / ms / 1e9:.1f} TFLOP/s over the band's "
            f"{pairs / (b * hq * visible_pairs(n, s, q_off, True)):.3f}x of the "
            f"causal pairs) vs the same kernel without a window {causal_ms:.4f} "
            f"ms, plain {plain_ms:.4f} ms, SDPA with the band mask "
            f"{library_ms:.4f} ms | bound {bnd['bound_ms']:.4f} ms "
            f"({bnd['bound_by']}) [{label}]")
        if i == entry_shape:
            entry.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                         causal_ms=causal_ms, **bnd, shape=shape)
    return entry


def phase_band_skip(device, label, b=1, hq=16, hkv=4, d=128):
    """run_all.py's long-context forward (32K tokens, window 4096, 64 sinks)
    timed beside the same kernel without a window, in turns: the band has
    0.24x the causal pairs, and the windowed call must take at most 0.4x
    the time (the key tiles outside the band are never visited). The last
    512 rows of the windowed output and LSE against `_fwd_plain` of those
    rows (the whole plain forward would need 64 GB of scores)."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import flash_attention as fa

    n, window, sinks = LONG["n"], LONG["window"], LONG["sinks"]
    gen = torch.Generator(device=device).manual_seed(47)
    q = torch.randn(b, hq, n, d, generator=gen, device=device).bfloat16()
    k = torch.randn(b, hkv, n, d, generator=gen, device=device).bfloat16()
    v = torch.randn(b, hkv, n, d, generator=gen, device=device).bfloat16()
    scale = d ** -0.5
    o, lse = fa._fwd(q, k, v, True, scale, 0, window, sinks)
    tail = 512
    po, plse = fa._fwd_plain(q[:, :, -tail:].contiguous(), k, v, True, scale,
                             n - tail, window, sinks)
    torch.cuda.synchronize()
    err = _rel_l2(o[:, :, -tail:], po)
    if not err <= O_TOL:
        raise AssertionError(f"32K windowed forward rel-L2 {err:.3e} > {O_TOL}")
    torch.testing.assert_close(lse[:, :, -tail:], plse, rtol=LSE_TOL, atol=LSE_TOL)
    del po, plse
    windowed = lambda: fa._fwd(q, k, v, True, scale, 0, window, sinks)  # noqa: E731
    causal = lambda: fa._fwd(q, k, v, True, scale, 0)  # noqa: E731
    w1 = time_ms(windowed, device, iters=3, graph=True)
    c1 = time_ms(causal, device, iters=3, graph=True)
    c2 = time_ms(causal, device, iters=3, graph=True)
    w2 = time_ms(windowed, device, iters=3, graph=True)
    w_ms, c_ms = min(w1, w2), min(c1, c2)
    pairs = band_pairs(n, n, 0, window, sinks)
    share = pairs / visible_pairs(n, n, 0, True)
    ratio = w_ms / c_ms
    bnd = bound(4 * d * b * hq * pairs, nbytes(q, k, v, o, lse))
    log(f"band skip: b{b} hq{hq} hkv{hkv} n{n} d{d}, window {window}, sinks "
        f"{sinks}: the last {tail} rows rel-L2 {err:.3e} vs plain, LSE ok | "
        f"windowed {w_ms:.4f} ms vs causal {c_ms:.4f} ms = {ratio:.3f}x for "
        f"{share:.3f}x of the pairs | windowed "
        f"{4 * d * b * hq * pairs / w_ms / 1e9:.1f} TFLOP/s, causal "
        f"{4 * d * b * hq * visible_pairs(n, n, 0, True) / c_ms / 1e9:.1f} "
        f"TFLOP/s | bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}) [{label}]")
    if not ratio <= 0.4:
        raise AssertionError(f"the windowed 32K forward took {ratio:.3f}x the "
                             "causal one (gate 0.4x): the band is not skipped")


def phase_window_fixed(device, label, b=1, hq=16, hkv=4, d=128, chunk=2048):
    """run_all.py's 32K fixed-max windowed rungs (`_win4k_fast`, window
    4096, and `_win4k_sinks64_fast`, 64 sinks too) through
    flash_attention(stable=False) and its _with_lse, with the launches of
    those calls; every row of each, O and LSE, against `_fwd_plain`
    (fixed-max) taken `chunk` query rows at a time (all rows at once would
    need 64 GB of scores). The rung with sinks timed beside the online
    windowed kernel in turns, the chunked plain version, and SDPA with the
    band mask (memory-efficient backend, K/V expanded to the q heads)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from flashattention_kernel_project_tpu_torch.ops import flash_attention as fa

    n, window = LONG["n"], LONG["window"]
    gen = torch.Generator(device=device).manual_seed(53)
    q, k, v = _qkv(gen, device, b, hq, hkv, n, n, d)
    scale = d ** -0.5
    entry = _disc_entry("flash_fwd (fixed, window)", "flash_fwd_sm90.cuh",
                        "flash_attention.py:92")

    def plain(sinks):
        parts = [fa._fwd_plain(q[:, :, i:i + chunk], k, v, True, scale, i,
                               window, sinks, fa.FIXED)
                 for i in range(0, n, chunk)]
        return (torch.cat([o for o, _ in parts], dim=2),
                torch.cat([lse for _, lse in parts], dim=2))

    checks = []
    reset_counters()
    for sinks in (0, LONG["sinks"]):
        o = fa.flash_attention(q, k, v, causal=True, stable=False,
                               window=window, sinks=sinks)
        _, lse = fa.flash_attention_with_lse(q, k, v, causal=True, stable=False,
                                             window=window, sinks=sinks)
        po, plse = plain(sinks)
        err = _hold(f"32K windowed fixed-max, sinks {sinks}", entry, o, po, lse,
                    plse)
        checks.append(f"sinks {sinks}: O rel-L2 {err:.3e}, LSE ok")
        del po, plse
    torch.cuda.synchronize()
    launches = read_counters()
    if launches["flash_fwd/fixed"] != 4 or launches["flash_fwd/window"] != 4:
        raise AssertionError(f"the windowed fixed-max calls launched {launches}")
    entry["launches"] = launches["flash_fwd/fixed"]
    band = (q, k, v, True, scale, 0, window, sinks)
    fixed = lambda: fa._fwd(*band, fa.FIXED)  # noqa: E731
    online = lambda: fa._fwd(*band)  # noqa: E731
    f1 = time_ms(fixed, device, iters=3, graph=True)
    s1 = time_ms(online, device, iters=3, graph=True)
    s2 = time_ms(online, device, iters=3, graph=True)
    f2 = time_ms(fixed, device, iters=3, graph=True)
    f_ms, s_ms = min(f1, f2), min(s1, s2)
    plain_ms = time_ms(lambda: plain(sinks), device, iters=1, reps=3)
    group = hq // hkv
    ke, ve = (x.repeat_interleave(group, dim=1) for x in (k, v))
    mask = band_mask(n, n, 0, window, sinks, device)

    def library():
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return F.scaled_dot_product_attention(q, ke, ve, attn_mask=mask)

    library_ms = time_ms(library, device, iters=3, graph=True)
    del ke, ve, mask
    pairs = b * hq * band_pairs(n, n, 0, window, sinks)
    bnd = bound(4 * d * pairs, nbytes(q, k, v, o, lse))
    shape = f"b{b} hq{hq} hkv{hkv} n{n} d{d} window{window} sinks{sinks}"
    log(f"flash_fwd (fixed, window) {shape}: " + "; ".join(checks) + " | "
        f"kernel {f_ms:.4f} ms ({4 * d * pairs / f_ms / 1e9:.1f} TFLOP/s over "
        f"the band) vs the online windowed kernel {s_ms:.4f} ms "
        f"({s_ms / f_ms:.3f}x), plain ({chunk}-row chunks) {plain_ms:.4f} ms, "
        f"SDPA with the band mask {library_ms:.4f} ms | bound "
        f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}) | launches "
        f"{entry['launches']} [{label}]")
    entry.update(ms=f_ms, plain_ms=plain_ms, online_ms=s_ms,
                 library_ms=library_ms, **bnd, shape=shape)
    return entry


def phase_window_ragged(device, b, hq, hkv, t, s, lens, offs, d, window, sinks,
                        label):
    """The ragged forward with a window and sinks against
    `_fwd_ragged_plain` over the same band, bf16, and its 8-bit form (int8
    and e4m3) against `_fwd_ragged_q_plain`, at the slice's chunk shape;
    each beside the kernel without a window. Returns the bf16 and the 8-bit
    (int8-timed) entries."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(53)
    entry = _window_entry("flash_fwd_ragged", "flash_fwd_ragged.cu",
                          "flash_attention.py:1582")
    entry_q = dict(_window_entry("flash_fwd_ragged_q", "flash_fwd_ragged.cu",
                                 "flash_attention.py:1582"), library_ms=None)
    q = torch.randn(b, hq, t, d, generator=gen, device=device).bfloat16()
    k = torch.randn(b, hkv, s, d, generator=gen, device=device).bfloat16()
    v = torch.randn(b, hkv, s, d, generator=gen, device=device).bfloat16()
    kv_lens = torch.tensor(lens, dtype=torch.int32, device=device)
    q_offsets = torch.tensor(offs, dtype=torch.int32, device=device)
    scale = d ** -0.5
    args = (q, k, v, kv_lens, q_offsets, True, scale)
    o = fa.flash_attention_ragged(*args[:5], window=window, sinks=sinks)
    err, max_abs = kernel_8bit_check("flash_fwd_ragged (window)", o,
                                     fa._fwd_ragged_plain(*args, window, sinks),
                                     entry, "bf16")
    ms, plain_ms = time_pair(lambda: fa._fwd_ragged(*args, window, sinks),
                             lambda: fa._fwd_ragged_plain(*args, window, sinks),
                             device)
    causal_ms = time_ms(lambda: fa._fwd_ragged(*args), device, graph=True)
    mask = fa._ragged_mask(t, s, kv_lens, q_offsets, True, window, sinks)
    library_ms = time_ms(sdpa_fn(q, k, v, mask=mask), device, graph=True)
    pairs = hq * sum(band_pairs(t, n, off, window, sinks)
                     for n, off in zip(lens, offs))
    # the live keys: the band of the chunk's rows and the sinks below it
    live = sum(min(n, max(sinks, 0)) + n - max(off - window + 1, sinks, 0)
               for n, off in zip(lens, offs))
    bnd = bound(4 * d * pairs, nbytes(q, o, kv_lens, q_offsets)
                + 2 * live * hkv * d * 2)
    shape = (f"b{b} hq{hq} hkv{hkv} t{t} s_max{s} d{d} kv_lens{lens} "
             f"q_offsets{offs} window{window} sinks{sinks}")
    log(f"flash_fwd_ragged (window) {shape}: rel-L2 {err:.3e}, max-abs "
        f"{max_abs:.3e} | kernel {ms:.4f} ms vs without a window {causal_ms:.4f}"
        f" ms, plain {plain_ms:.4f} ms, SDPA with the mask {library_ms:.4f} ms "
        f"| bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}) [{label}]")
    entry.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                 causal_ms=causal_ms, **bnd, shape=shape)
    for fmt in FMTS:
        kq, ks = quantized(gen, device, (b, hkv, s, d), fmt)
        vq, vs = quantized(gen, device, (b, hkv, s, d), fmt)
        qargs = (q, kq, ks, vq, vs, kv_lens, q_offsets, True, scale)
        o8 = fa.flash_attention_ragged_kv_quant(*qargs[:7], window=window,
                                                sinks=sinks)
        err, max_abs = kernel_8bit_check(
            "flash_fwd_ragged_q (window)", o8,
            fa._fwd_ragged_q_plain(*qargs, window, sinks), entry_q, fmt)
        ms, plain_ms = time_pair(
            lambda: fa._fwd_ragged_q_cuda(*qargs, window, sinks),
            lambda: fa._fwd_ragged_q_plain(*qargs, window, sinks), device)
        causal_ms = time_ms(lambda: fa._fwd_ragged_q_cuda(*qargs), device,
                            graph=True)
        bnd = bound(4 * d * pairs, nbytes(q, o8, kv_lens, q_offsets)
                    + bytes_8bit(live, hkv, d))
        log(f"flash_fwd_ragged_q (window) {fmt} {shape}: rel-L2 {err:.3e}, "
            f"max-abs {max_abs:.3e} | kernel {ms:.4f} ms vs without a window "
            f"{causal_ms:.4f} ms, plain {plain_ms:.4f} ms | bound "
            f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}) [{label}]")
        if fmt == "int8":
            entry_q.update(ms=ms, plain_ms=plain_ms, causal_ms=causal_ms, **bnd,
                           shape=shape)
        else:
            entry_q["fp8_ms"] = ms
    band = dict(window=window, sinks=sinks)
    ragged_verify(device, entry, None, label, **band)
    ragged_verify(device, entry_q, "int8", label, **band)
    ragged_edges(device, entry, None, label, flavours=(band, dict(window=1),
                                                       dict(window=64, sinks=1)))
    return entry, entry_q


def phase_window_decode(device, b, hq, hkv, s, d, lens, window, sinks, label):
    """The linear decodes with a window and sinks, bf16 and 8-bit (int8,
    e4m3), against their plain partials over the same band through the
    same merge, at lengths below, at and far above the window; each timed
    in turns beside the kernel without a window at the same lengths, which
    it must not exceed (5% for the timer's noise: both runs end on one
    split's keys). Returns the bf16 and the 8-bit (int8-timed) entries."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import flash_decode as fd

    gen = torch.Generator(device=device).manual_seed(59)
    entry = _window_entry("flash_decode", "flash_decode_sm90.cuh", "flash_decode.py:38")
    entry_q = dict(_window_entry("flash_decode_q", "flash_decode_q.cu",
                                 "flash_decode.py:102"), library_ms=None)
    q = torch.randn(b, hq, d, generator=gen, device=device).bfloat16()
    lengths = torch.tensor(lens, dtype=torch.int32, device=device)
    scale = d ** -0.5
    live = _live_keys(lens, window, sinks)
    cases = [("bf16", None)] + [(fmt, fmt) for fmt in FMTS]
    for tag, fmt in cases:
        # each kernel at its wrapper's default splits, whole tiles at the
        # blocks an SM holds of it
        n_splits = (fd.default_n_splits if fmt is None else fd.q_n_splits)(
            b, hkv, s, d)
        block_s = fd.default_block_s(s, n_splits)
        shape = (f"b{b} hq{hq} hkv{hkv} s{s} d{d} n_splits{n_splits} "
                 f"lengths{lens} window{window} sinks{sinks}")
        if fmt is None:
            k = torch.randn(b, hkv, s, d, generator=gen, device=device).bfloat16()
            v = torch.randn(b, hkv, s, d, generator=gen, device=device).bfloat16()
            cache = (k, v)
            wrapper, cuda, plain = (fd.flash_decode, fd._decode_partials_cuda,
                                    fd._decode_partials_plain)
            kv_bytes = 2 * live * hkv * d * 2
            ent = entry
        else:
            kq, ks = quantized(gen, device, (b, hkv, s, d), fmt)
            vq, vs = quantized(gen, device, (b, hkv, s, d), fmt)
            cache = (kq, ks, vq, vs)
            # the 8-bit decode's whole call, one launch
            wrapper, cuda, plain = (fd.flash_decode_int8, fd._decode_q_cuda,
                                    fd._decode_partials_q_plain)
            kv_bytes = bytes_8bit(live, hkv, d)
            ent = entry_q
        args = (q, *cache, lengths, n_splits, block_s, scale)
        o = wrapper(q, *cache, lengths, window=window, sinks=sinks)
        po = fd.merge_partials(*plain(*args, window, sinks)).reshape(b, hq, d)
        err, max_abs = kernel_8bit_check(ent["name"], o, po, ent, tag)
        ms, plain_ms = time_pair(lambda: cuda(*args, window, sinks),
                                 lambda: plain(*args, window, sinks), device,
                                 iters=50)
        full1 = time_ms(lambda: cuda(*args), device, iters=50, graph=True)
        win2 = time_ms(lambda: cuda(*args, window, sinks), device, iters=50,
                       graph=True)
        full2 = time_ms(lambda: cuda(*args), device, iters=50, graph=True)
        ms, full_ms = min(ms, win2), min(full1, full2)
        bnd = bound(4 * live * hq * d, nbytes(q, o) + kv_bytes)
        library = ""
        if fmt is None:
            # the whole call (the splits merged on the card) in turns with
            # SDPA over the band as a boolean mask
            col = torch.arange(s, device=device)[None, :]
            n_b = lengths[:, None]
            mask = (col < n_b) & ((col >= n_b - window) | (col < sinks))
            turns = time_turns({
                "sdpa": sdpa_fn(q[:, :, None], k, v, mask=mask[:, None, None]),
                "call": lambda: fd.flash_decode(q, k, v, lengths, window=window,
                                                sinks=sinks)}, device)
            ent["library_ms"], ent["call_ms"] = turns["sdpa"], turns["call"]
            library = (f", whole call {turns['call']:.4f} ms, SDPA with the band "
                       f"mask {turns['sdpa']:.4f} ms (in turns)")
        log(f"{ent['name']} {tag} {shape}: rel-L2 {err:.3e}, max-abs "
            f"{max_abs:.3e} | kernel {ms:.4f} ms vs without a window "
            f"{full_ms:.4f} ms, plain partials {plain_ms:.4f} ms{library} | "
            f"bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}) over {live} "
            f"live keys [{label}]")
        if not ms <= 1.05 * full_ms:
            raise AssertionError(f"{ent['name']} {tag}: windowed {ms:.4f} ms > "
                                 f"the full decode's {full_ms:.4f} ms")
        if fmt is not None:
            def call():
                return wrapper(q, *cache, lengths, window=window, sinks=sinks)

            ops = graph_device_ops(call)
            if len(ops) != 1 or not graph_bit_equal(call):
                raise AssertionError(f"{ent['name']} {tag} with a window: a "
                                     f"captured call holds {ops} (one expected), "
                                     f"or its replay differs")
        if fmt == "fp8":
            entry_q["fp8_ms"] = ms
        elif fmt is None:  # the row's time is the whole call's
            ent.update(ms=ent.pop("call_ms"), kernel_ms=ms, plain_ms=plain_ms,
                       causal_ms=full_ms, **bnd, shape=shape)
        else:
            ent.update(ms=ms, plain_ms=plain_ms, causal_ms=full_ms, **bnd,
                       shape=shape)
    return entry, entry_q


def phase_window_backward(device, b, hq, hkv, n, d, window, sinks, label):
    """The backward with a window and sinks in both dq schedules against
    `_bwd_plain` over the same band, on (o, lse) from the windowed forward
    kernel; dK and dV of the keys no row sees must be 0 exactly (with
    q_offset placing the queries past a gap), and the windowed backward
    must take less time than the same kernels without a window. Returns
    the two entries."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(61)
    dkdv, dq_e = entries = bwd_entries(" (window)")
    q, do = (torch.randn(b, hq, n, d, generator=gen, device=device).bfloat16()
             for _ in range(2))
    k, v = (torch.randn(b, hkv, n, d, generator=gen, device=device).bfloat16()
            for _ in range(2))
    scale = d ** -0.5
    band = (True, scale, 0, window, sinks)
    o, lse = fa._fwd(q, k, v, *band)
    plain = fa._bwd_plain(q, k, v, o, lse, do, *band)
    errs = {}
    for fuse in (True, False):
        grads = fa._bwd(q, k, v, o, lse, do, *band, fuse_dq=fuse)
        torch.cuda.synchronize()
        errs[fuse] = hold_bwd(f"windowed backward (fuse_dq={fuse})", grads, plain,
                              entries, fuse)
        del grads
    del plain
    # the last 64 queries with a window of 256: keys [sinks, n - 319) unseen
    qs = q[:, :, -64:].contiguous()
    os_, ls = fa._fwd(qs, k, v, True, scale, n - 64, 256, sinks)
    gap = slice(sinks, n - 64 - 255)
    for fuse in (True, False):
        _, dk0, dv0 = fa._bwd(qs, k, v, os_, ls, do[:, :, -64:].contiguous(), True,
                              scale, n - 64, 256, sinks, fuse_dq=fuse)
        if dk0[:, :, gap].any() or dv0[:, :, gap].any():
            raise AssertionError(f"dK/dV of keys no row sees are not 0 "
                                 f"(fuse_dq={fuse})")
    args = (q, k, v, do, *fa._bwd_rows(lse, o, do)) + band
    kv_ms = time_ms(lambda: fa._dkdv_cuda(*args), device)
    fused_ms = time_ms(lambda: fa._fused_cuda(*args), device)
    dq_ms = time_ms(lambda: fa._dq_cuda(*args), device)
    w1 = time_ms(lambda: fa._bwd(q, k, v, o, lse, do, *band), device)
    c1 = time_ms(lambda: fa._bwd(q, k, v, o, lse, do, True, scale, 0), device)
    c2 = time_ms(lambda: fa._bwd(q, k, v, o, lse, do, True, scale, 0), device)
    w2 = time_ms(lambda: fa._bwd(q, k, v, o, lse, do, *band), device)
    p1 = time_ms(lambda: fa._bwd_plain(q, k, v, o, lse, do, *band), device, 1)
    w_ms, c_ms = min(w1, w2), min(c1, c2)
    library_ms = None
    try:  # autograd's backward through one SDPA call with the band mask
        qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
        out = sdpa_fn(qg, kg, vg, mask=band_mask(n, n, 0, window, sinks, device))()
        library_ms = time_ms(lambda: torch.autograd.grad(
            out, (qg, kg, vg), do, retain_graph=True), device)
        del out, qg, kg, vg
    except RuntimeError as e:  # no SDPA backend takes this mask: no yardstick
        log(f"windowed backward: SDPA backward with the band mask failed: {e}")
    pairs = b * hq * band_pairs(n, n, 0, window, sinks)
    reads = nbytes(q, k, v, do, lse, lse)
    shape = f"b{b} hq{hq} hkv{hkv} n{n} s{n} d{d} window{window} sinks{sinks}"
    fused = bound(10 * d * pairs, reads + nbytes(k, v) + 2 * nbytes(q))
    dkdv.update(ms=kv_ms, plain_ms=p1, library_ms=library_ms,
                **bound(8 * d * pairs, reads + nbytes(k, v)), shape=shape,
                fused_ms=fused_ms, fused_bound_ms=fused["bound_ms"])
    dq_e.update(ms=dq_ms, plain_ms=p1, library_ms=library_ms,
                **bound(6 * d * pairs, reads + nbytes(q)), shape=shape)
    log(f"flash_bwd (window) {shape}: rel-L2 (dq, dk, dv) fused "
        + " ".join(f"{x:.2e}" for x in errs[True]) + ", two-kernel "
        + " ".join(f"{x:.2e}" for x in errs[False])
        + f"; dK/dV of the keys in the gap exactly 0 | kernel A {kv_ms:.4f} ms, "
        f"with the fused dq {fused_ms:.4f} ms, kernel B {dq_ms:.4f} ms, _bwd "
        f"(default) {w_ms:.4f} ms vs without a window {c_ms:.4f} ms "
        f"({w_ms / c_ms:.3f}x for "
        f"{pairs / (b * hq * visible_pairs(n, n, 0, True)):.3f}x of the pairs), "
        f"plain {p1:.4f} ms, SDPA backward with the band mask "
        f"{library_ms if library_ms is None else f'{library_ms:.4f}'} ms | "
        f"bound kernel A {dkdv['bound_ms']:.4f} ms, fused "
        f"{fused['bound_ms']:.4f} ms, kernel B {dq_e['bound_ms']:.4f} ms "
        f"[{label}]")
    if not w_ms < c_ms:
        raise AssertionError(f"the windowed backward took {w_ms:.4f} ms, not "
                             f"less than the causal {c_ms:.4f} ms")
    return dkdv, dq_e


@contextlib.contextmanager
def plain_attention():
    """Inside, the forward and the decodes run their plain PyTorch versions
    on CUDA tensors too (float32 attention on the card, no kernel): the
    reference that measures an 8-bit cache format's own error at a
    configuration, apart from the kernels'."""
    from flashattention_kernel_project_tpu_torch.ops import flash_attention as fa
    from flashattention_kernel_project_tpu_torch.ops import flash_decode as fd

    saved = fa._fwd, fd._decode_cuda, fd._decode_q_cuda

    def fwd(q, k, v, causal, sm_scale, q_offset, window=0, sinks=0,
            disc=fa.ONLINE, k_max=None, pack=False):
        return fa._fwd_plain(q, k, v, causal, sm_scale or q.shape[-1] ** -0.5,
                             q_offset, window, sinks, disc, k_max)

    fa._fwd = fwd
    fd._decode_cuda = fd._decode_plain
    fd._decode_q_cuda = fd._decode_q_plain
    try:
        yield
    finally:
        fa._fwd, fd._decode_cuda, fd._decode_q_cuda = saved


def phase_window_slices(device, cfg, params, draft_cfg, draft_params, prompts,
                        system, max_batch, max_len, max_new, label):
    """The serving requests through the windowed serving model five ways:
    (i) the default mode, (ii) multi_step=4, whose tokens must equal (i)'s,
    (iii) the paged, prefix-cached, chunked mode with the shared system
    prompt (its decode takes no window, as the JAX engine's paged decode),
    (iv) an int8 cache in chunks of 256 (the 8-bit ragged forward and
    decode), (v) speculative on the linear cache with a draft carrying the
    same window. Each must launch its windowed kernels; the pool ends
    recycled. Each is printed beside the unwindowed slice of the same mode
    from this run. Returns the launches of each run by its tag."""
    spec = dict(draft_cfg=draft_cfg, draft_params=draft_params, spec_k=SPEC_K)
    with_system = [np.concatenate([system, p]).astype(np.int32) for p in prompts]
    runs = (  # tag, prompts, options, kernels that must launch, unwindowed tag
        ("window slice", prompts, {}, ("flash_fwd/window", "flash_decode/window"),
         "slice"),
        ("window slice (multi_step=4)", prompts, dict(multi_step=4),
         ("flash_fwd/window", "flash_decode/window"), "multi_step slice"),
        ("window slice (paged)", with_system,
         dict(paged=True, page_size=128, prefix_cache=True, prefill_chunk=256),
         ("flash_fwd_ragged/window", "paged_decode"), "paged slice"),
        ("window slice (int8)", prompts,
         dict(quantized_cache=True, prefill_chunk=256),
         ("flash_fwd_ragged_q/window", "flash_decode_q/window"),
         "int8 slice (linear)"),
        ("window spec slice (linear)", prompts, spec,
         ("flash_fwd/window", "flash_fwd_ragged/window", "flash_decode/window"),
         "spec slice (linear)"),
    )
    out, tokens = {}, {}
    for tag, reqs, kw, kernels, ref_tag in runs:
        sched, tokens[tag], launches = serve(
            device, cfg, params, reqs, max_new, kernels, label, tag,
            max_batch=max_batch, max_len=max_len, **kw)
        detail = ""
        if kw.get("paged"):
            if sched._pool.free_pages != sched._n_pages - 1:
                raise AssertionError(f"{tag}: {sched._pool.free_pages} of "
                                     f"{sched._n_pages - 1} pages back")
            if sched._prefix_index or sched._page_refs:
                raise AssertionError(f"{tag}: prefix index or references left")
            if not sched.prefix_hits > 0:
                raise AssertionError(f"{tag}: no insert reused the prefix's pages")
            detail = (f"; prefix reuse {sched.prefix_hits} of {len(reqs)}, pool "
                      "fully recycled")
        if tag == "window slice (multi_step=4)":
            same = np.mean([a == b for x, y in zip(tokens[tag],
                                                   tokens["window slice"])
                            for a, b in zip(x, y)])
            if same != 1.0:
                raise AssertionError(f"{tag}: tokens equal to multi_step=1 only "
                                     f"{same:.4f}")
            detail = "; tokens equal to (i) 1.0000"
        if "spec" in tag:
            same = np.mean([a == b for x, y in zip(tokens[tag],
                                                   tokens["window slice"])
                            for a, b in zip(x, y)])
            per_round = sched.spec_committed / max(sched.spec_slot_rounds, 1)
            detail = (f"; greedy tokens equal to (i) {same:.4f}; {per_round:.3f}"
                      " committed tokens a slot-round")
        m, ref = SLICE_METRICS[tag], SLICE_METRICS[ref_tag]
        log(f"{tag} vs the unwindowed {ref_tag} (same run): {m.tok_per_s:.1f} vs "
            f"{ref.tok_per_s:.1f} tok/s | TTFT mean {m.ttft_s_mean * 1e3:.1f} vs "
            f"{ref.ttft_s_mean * 1e3:.1f} ms, p95 {m.ttft_s_p95 * 1e3:.1f} vs "
            f"{ref.ttft_s_p95 * 1e3:.1f} ms | latency mean "
            f"{m.latency_s_mean * 1e3:.1f} vs {ref.latency_s_mean * 1e3:.1f} ms"
            f"{detail} [{label}]")
        out[tag] = launches
        del sched
        if tag == "window slice":
            # the host's spread over a run (tens of percent) is of the order
            # of what the window changes: the causal and the windowed
            # default slice once more each, in turns, for a paired reading
            causal_cfg = dataclasses.replace(cfg, attn_window=None, attn_sinks=0)
            for again, c, kernels in (
                    ("slice (again)", causal_cfg, ("flash_fwd", "flash_decode")),
                    ("window slice (again)", cfg, runs[0][3])):
                serve(device, c, params, reqs, max_new, kernels, label, again,
                      max_batch=max_batch, max_len=max_len)
            rates = [SLICE_METRICS[t].tok_per_s for t in (
                "slice", "window slice", "slice (again)", "window slice (again)")]
            log(f"window slice in turns with the unwindowed default slice: "
                f"causal {rates[0]:.1f}, window {rates[1]:.1f}, causal "
                f"{rates[2]:.1f}, window {rates[3]:.1f} tok/s [{label}]")
    return out


# ---------------------------------------------------------------------------
# The fixed-max and "auto" disciplines: kernel 1's fixed-max and hybrid
# instances, kernel 2's counterpart (the packed d=64 forward), kernel 3's
# fixed-max instances, the dense 8-bit forward, bench.py's headline call,
# and the models with attn_stable=False served and trained.
# ---------------------------------------------------------------------------

# the JAX package's default TransformerConfig() (d_head 64, 16/4 heads)
JAX_DEFAULT = dict(vocab_size=32000, d_model=1024, n_layers=8, n_heads=16,
                   n_kv_heads=4, d_head=64, d_ff=2816)
# BASELINE.json config 5 (benchmarks/run_all.py:430-441): GQA 32/8, d 128,
# 32K tokens over an int8 KV cache, fixed-max
CONFIG5 = dict(hq=32, hkv=8, n=32768, d=128)
# "auto" where every block runs online, against stable=True
# (tests/test_flash_attention.py:135)
SAME_TOL = 1e-6
TURN_BLOCKS = 2  # stable-fixed-fixed-stable blocks of the default slice
PEAK_TFLOPS = 989.0  # bf16 dense, the H100 SXM at 700 W


def _disc_entry(name, source, replaces, library_ms=None):
    return dict(name=name, route="cuda", source=f"{PKG}/csrc/{source}",
                replaces=f"{TPU}/{replaces}", max_abs_err=0.0,
                library_ms=library_ms)


def _hold(what, entry, o, po, lse=None, plse=None):
    """kernel_8bit_check's O gate for any cache, and the LSE within
    LSE_TOL of the plain version's. Returns the O rel-L2."""
    import torch

    err, _ = kernel_8bit_check(what, o, po, entry, "O")
    if lse is not None:
        if not torch.isfinite(lse).all():
            raise AssertionError(f"{what}: non-finite LSE")
        torch.testing.assert_close(lse, plse, rtol=LSE_TOL, atol=LSE_TOL)
    return err


def _qkv(gen, device, b, hq, hkv, n, s, d):
    import torch

    return (torch.randn(b, hq, n, d, generator=gen, device=device).bfloat16(),
            torch.randn(b, hkv, s, d, generator=gen, device=device).bfloat16(),
            torch.randn(b, hkv, s, d, generator=gen, device=device).bfloat16())


def phase_fixed(device, shapes, label):
    """Kernel 1's fixed-max instances against `_fwd_plain` in the fixed
    discipline, bf16, O and LSE, at each (b, hq, hkv, n, s, d, causal,
    q_offset); each timed beside the stable kernel at the same shape and
    SDPA. The first shape (bench.py's) stands for the kernel."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(71)
    entry = _disc_entry("flash_fwd (fixed)", "flash_fwd_sm90.cuh", "flash_attention.py:92")
    for i, (b, hq, hkv, n, s, d, causal, q_off) in enumerate(shapes):
        q, k, v = _qkv(gen, device, b, hq, hkv, n, s, d)
        args = (q, k, v, causal, d ** -0.5, q_off, 0, 0, fa.FIXED)
        o, lse = fa.flash_attention_with_lse(q, k, v, causal=causal,
                                             q_offset=q_off, stable=False)
        po, plse = fa._fwd_plain(*args)
        err = _hold("flash_fwd (fixed)", entry, o, po, lse, plse)
        del po, plse
        ms, plain_ms = time_pair(lambda: fa._fwd(*args),
                                 lambda: fa._fwd_plain(*args), device)
        stable_ms = time_ms(lambda: fa._fwd(*args[:6]), device, graph=True)
        library_ms = time_ms(sdpa_fn(q, k, v, causal=causal) if q_off == 0 else
                             sdpa_fn(q, k, v, mask=band_mask(n, s, q_off, 0, 0,
                                                             device)),
                             device, graph=True)
        pairs = b * hq * visible_pairs(n, s, q_off, causal)
        bnd = bound(4 * d * pairs, nbytes(q, k, v, o, lse))
        shape = (f"b{b} hq{hq} hkv{hkv} n{n} s{s} d{d} causal={causal} "
                 f"q_offset={q_off}")
        log(f"flash_fwd (fixed) {shape}: O rel-L2 {err:.3e}, LSE ok | kernel "
            f"{ms:.4f} ms ({4 * d * pairs / ms / 1e9:.1f} TFLOP/s) vs the "
            f"stable kernel {stable_ms:.4f} ms ({stable_ms / ms:.3f}x), plain "
            f"{plain_ms:.4f} ms, SDPA {library_ms:.4f} ms | bound "
            f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}) [{label}]")
        if i == 0:
            entry.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                         stable_ms=stable_ms, **bnd, shape=shape)
    return entry


def phase_packed(device, b, hq, hkv, n, d, label):
    """Kernel 2's counterpart, the fixed-max d=64 forward that
    flash_attention(stable=False) takes by default at d = 64 with an even
    KV-head count, against `_fwd_plain` (fixed), O and LSE, at run_all.py's
    d64 rung (causal); timed beside the stable d=64 kernel and SDPA."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(73)
    entry = _disc_entry("flash_fwd_packed", "flash_fwd_sm90.cuh",
                        "flash_attention.py:710")
    q, k, v = _qkv(gen, device, b, hq, hkv, n, n, d)
    args = (q, k, v, True, d ** -0.5, 0)
    before = fa._fwd.packed_launches
    o, lse = fa.flash_attention_with_lse(q, k, v, causal=True, stable=False)
    if fa._fwd.packed_launches != before + 1:
        raise AssertionError("flash_attention(stable=False) at d=64 did not "
                             "take the packed forward")
    po, plse = fa._fwd_plain(*args, 0, 0, fa.FIXED)
    err = _hold("flash_fwd_packed", entry, o, po, lse, plse)
    del po, plse
    ms, plain_ms = time_pair(lambda: fa._fwd(*args, 0, 0, fa.FIXED, pack=True),
                             lambda: fa._fwd_plain(*args, 0, 0, fa.FIXED), device)
    stable_ms = time_ms(lambda: fa._fwd(*args), device, graph=True)
    library_ms = time_ms(sdpa_fn(q, k, v, causal=True), device, graph=True)
    pairs = b * hq * visible_pairs(n, n, 0, True)
    bnd = bound(4 * d * pairs, nbytes(q, k, v, o, lse))
    shape = f"b{b} hq{hq} hkv{hkv} n{n} s{n} d{d} causal"
    log(f"flash_fwd_packed {shape}: O rel-L2 {err:.3e}, LSE ok | kernel "
        f"{ms:.4f} ms ({4 * d * pairs / ms / 1e9:.1f} TFLOP/s) vs the stable "
        f"d=64 kernel {stable_ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
        f"{library_ms:.4f} ms | bound {bnd['bound_ms']:.4f} ms "
        f"({bnd['bound_by']}) [{label}]")
    entry.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                 stable_ms=stable_ms, **bnd, shape=shape)
    return entry


def phase_hybrid(device, b, hq, hkv, n, d, label):
    """Kernel 1's hybrid instance (stable="auto") at bench.py's shape or
    run_all.py's d64 `_auto` rung (causal): on bounded inputs against
    `_fwd_plain` routed by the same bound, O and LSE, with the launches of
    that call; with q x 60 and q x -60, where every block's bound breaches,
    equal to the stable kernel within SAME_TOL; on mixed tiles (every other
    64-row tile x 60) against the plain version; with k_max_norm(k) passed
    in, bit-equal to the call without; with k_max = 1e6 equal to the stable
    kernel within SAME_TOL. Timed on the bounded inputs beside the
    fixed-max and stable kernels and SDPA."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(79)
    entry = _disc_entry(f"flash_fwd (hybrid, d={d})", "flash_fwd_sm90.cuh",
                        "flash_attention.py:92")
    q, k, v = _qkv(gen, device, b, hq, hkv, n, n, d)
    scale = d ** -0.5
    k_max = fa.k_max_norm(k)

    def fixed_share(x, km):
        return float(fa._fixed_rows(x, scale, fa.HYBRID, km).float().mean())

    reset_counters()
    o, lse = fa.flash_attention_with_lse(q, k, v, causal=True, stable="auto")
    torch.cuda.synchronize()
    entry["launches"] = read_counters()["flash_fwd/hybrid"]
    po, plse = fa._fwd_plain(q, k, v, True, scale, 0, 0, 0, fa.HYBRID, k_max)
    err = _hold("flash_fwd (hybrid)", entry, o, po, lse, plse)
    del po, plse
    checks = [f"bounded O rel-L2 {err:.3e} ({fixed_share(q, k_max):.3f} of the "
              "rows fixed-max), LSE ok"]
    attend = lambda x, **kw: fa.flash_attention(x, k, v, causal=True, **kw)  # noqa: E731
    for mult in (60.0, -60.0):
        qx = (q.float() * mult).bfloat16()
        if fixed_share(qx, k_max) != 0.0:
            raise AssertionError(f"q x {mult}: a block passed the bound")
        same = _rel_l2(attend(qx, stable="auto"), attend(qx))
        if not same <= SAME_TOL:
            raise AssertionError(f"hybrid with q x {mult}: rel-L2 {same:.3e} "
                                 f"from the stable kernel > {SAME_TOL}")
        checks.append(f"q x {mult:+.0f} vs stable {same:.3e}")
    tiles = (torch.arange(n, device=device) // 64) % 2 == 0
    qm = torch.where(tiles[:, None], q.float() * 60.0, q.float()).bfloat16()
    om = attend(qm, stable="auto")
    pm = fa._fwd_plain(qm, k, v, True, scale, 0, 0, 0, fa.HYBRID, k_max)[0]
    errm = _hold("flash_fwd (hybrid), mixed tiles", entry, om, pm)
    checks.append(f"mixed tiles ({fixed_share(qm, k_max):.3f} fixed-max) vs "
                  f"plain {errm:.3e}, vs stable {_rel_l2(om, attend(qm)):.3e}")
    del om, pm
    if not torch.equal(attend(q, stable="auto", k_max=k_max),
                       attend(q, stable="auto")):
        raise AssertionError("hybrid with k_max_norm(k) is not bit-equal")
    over = _rel_l2(attend(q, stable="auto", k_max=1e6), attend(q))
    if not over <= SAME_TOL:
        raise AssertionError(f"hybrid with k_max 1e6: {over:.3e} from stable")
    checks.append(f"k_max_norm(k) bit-equal, k_max 1e6 vs stable {over:.3e}")
    args = (q, k, v, True, scale, 0, 0, 0)
    ms, plain_ms = time_pair(lambda: fa._fwd(*args, fa.HYBRID, k_max),
                             lambda: fa._fwd_plain(*args, fa.HYBRID, k_max),
                             device)
    fixed_ms = time_ms(lambda: fa._fwd(*args, fa.FIXED), device, graph=True)
    stable_ms = time_ms(lambda: fa._fwd(*args), device, graph=True)
    library_ms = time_ms(sdpa_fn(q, k, v, causal=True), device, graph=True)
    pairs = b * hq * visible_pairs(n, n, 0, True)
    bnd = bound(4 * d * pairs, nbytes(q, k, v, o, lse, k_max))
    shape = f"b{b} hq{hq} hkv{hkv} n{n} s{n} d{d} causal"
    log(f"flash_fwd (hybrid, d={d}) {shape}: " + "; ".join(checks) + f" | kernel "
        f"{ms:.4f} ms ({4 * d * pairs / ms / 1e9:.1f} TFLOP/s) vs fixed-max "
        f"{fixed_ms:.4f} ms, stable {stable_ms:.4f} ms, plain {plain_ms:.4f} "
        f"ms, SDPA {library_ms:.4f} ms | bound {bnd['bound_ms']:.4f} ms "
        f"({bnd['bound_by']}) [{label}]")
    entry.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                 fixed_ms=fixed_ms, stable_ms=stable_ms, **bnd, shape=shape)
    return entry


def phase_ragged_fixed(device, b, hq, hkv, t, s, lens, offs, d, label):
    """Kernel 3's fixed-max instances at the serving chunk: the bf16 ragged
    forward against `_fwd_ragged_plain` and the 8-bit one (int8, e4m3)
    against `_fwd_ragged_q_plain`, both fixed-max; each timed beside the
    online kernel on the same cache. Returns the bf16 and the 8-bit
    (int8-timed) entries."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(83)
    entry = _disc_entry("flash_fwd_ragged (fixed)", "flash_fwd_ragged.cu",
                        "flash_attention.py:1582")
    entry_q = _disc_entry("flash_fwd_ragged_q (fixed)", "flash_fwd_ragged.cu",
                          "flash_attention.py:1582")
    q, k, v = _qkv(gen, device, b, hq, hkv, t, s, d)
    kv_lens = torch.tensor(lens, dtype=torch.int32, device=device)
    q_offsets = torch.tensor(offs, dtype=torch.int32, device=device)
    args = (q, k, v, kv_lens, q_offsets, True, d ** -0.5)
    o = fa.flash_attention_ragged(*args[:5], stable=False)
    err = _hold("flash_fwd_ragged (fixed)", entry, o,
                fa._fwd_ragged_plain(*args, 0, 0, fa.FIXED))
    ms, plain_ms = time_pair(lambda: fa._fwd_ragged(*args, 0, 0, fa.FIXED),
                             lambda: fa._fwd_ragged_plain(*args, 0, 0, fa.FIXED),
                             device)
    online_ms = time_ms(lambda: fa._fwd_ragged(*args), device, graph=True)
    library_ms = time_ms(sdpa_fn(q, k, v, mask=fa._ragged_mask(
        t, s, kv_lens, q_offsets, True)), device, graph=True)
    pairs = hq * sum(visible_pairs(t, n, off, True) for n, off in zip(lens, offs))
    bnd = bound(4 * d * pairs, nbytes(q, o, kv_lens, q_offsets)
                + 2 * sum(lens) * hkv * d * 2)
    shape = (f"b{b} hq{hq} hkv{hkv} t{t} s_max{s} d{d} kv_lens{lens} "
             f"q_offsets{offs} causal")
    log(f"flash_fwd_ragged (fixed) {shape}: rel-L2 {err:.3e} | kernel {ms:.4f} "
        f"ms vs online {online_ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA with "
        f"the mask {library_ms:.4f} ms | bound {bnd['bound_ms']:.4f} ms "
        f"({bnd['bound_by']}) [{label}]")
    entry.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                 online_ms=online_ms, **bnd, shape=shape)
    for fmt in FMTS:
        kq, ks = quantized(gen, device, (b, hkv, s, d), fmt)
        vq, vs = quantized(gen, device, (b, hkv, s, d), fmt)
        qargs = (q, kq, ks, vq, vs, kv_lens, q_offsets, True, d ** -0.5)
        o8 = fa.flash_attention_ragged_kv_quant(*qargs[:7], stable=False)
        err, _ = kernel_8bit_check("flash_fwd_ragged_q (fixed)", o8,
                                   fa._fwd_ragged_q_plain(*qargs, 0, 0, fa.FIXED),
                                   entry_q, fmt)
        ms, plain_ms = time_pair(
            lambda: fa._fwd_ragged_q_cuda(*qargs, 0, 0, fa.FIXED),
            lambda: fa._fwd_ragged_q_plain(*qargs, 0, 0, fa.FIXED), device)
        online_ms = time_ms(lambda: fa._fwd_ragged_q_cuda(*qargs), device,
                            graph=True)
        bnd = bound(4 * d * pairs, nbytes(q, o8, kv_lens, q_offsets)
                    + bytes_8bit(sum(lens), hkv, d))
        log(f"flash_fwd_ragged_q (fixed) {fmt} {shape}: rel-L2 {err:.3e} | "
            f"kernel {ms:.4f} ms vs online {online_ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms | bound {bnd['bound_ms']:.4f} ms "
            f"({bnd['bound_by']}) [{label}]")
        if fmt == "int8":
            entry_q.update(ms=ms, plain_ms=plain_ms, online_ms=online_ms, **bnd,
                           shape=shape)
        else:
            entry_q["fp8_ms"] = ms
    ragged_verify(device, entry, None, label, stable=False)
    ragged_verify(device, entry_q, "int8", label, stable=False)
    return entry, entry_q


# (b, hq, hkv, n, s, d, causal, q_offset, window, sinks) at the edges of the
# dense 8-bit forward's row blocks and 64-key tiles: N and S on, under and
# past them, a q_offset, non-causal, a window wider than a tile with sinks
# past one, d 64 and 128; 4 q heads in 64-row blocks (their grid fits one
# wave of the SMs), 16 in 128-row ones
FWD_Q_EDGE_SHAPES = [
    (1, hq, 2, n, s, d, causal, off, window, sinks) for d in (64, 128)
    for hq, n, s, causal, off, window, sinks in (
        (4, 63, 63, True, 0, 0, 0), (4, 65, 130, True, 65, 0, 0),
        (4, 129, 129, True, 0, 0, 0), (4, 200, 333, False, 0, 0, 0),
        (4, 200, 333, True, 133, 0, 0), (4, 300, 300, True, 0, 100, 66),
        (4, 129, 700, True, 571, 70, 3), (16, 1100, 1100, True, 0, 0, 0),
        (16, 1025, 1000, False, 0, 0, 0), (16, 700, 900, True, 200, 300, 70))]


def fwd_q_edges(device, entry, label, shapes=FWD_Q_EDGE_SHAPES):
    """The dense 8-bit forward against `_fwd_q_plain` at `shapes`, int8 and
    e4m3, in the three disciplines: O within 1e-2, LSE within 1e-3 (the
    same rows with no key), and the fixed-max guard's count equal to the
    plain version's, on these inputs and on rows scaled past its range."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(83)
    for fmt in FMTS:
        for b, hq, hkv, n, s, d, causal, off, window, sinks in shapes:
            q = torch.randn(b, hq, n, d, generator=gen, device=device).bfloat16()
            cache = (*quantized(gen, device, (b, hkv, s, d), fmt),
                     *quantized(gen, device, (b, hkv, s, d), fmt))
            k_max = fa.k_max_norm(cache[0], cache[1])
            what = (f"flash_fwd_q {fmt} edge b{b} hq{hq} hkv{hkv} n{n} s{s} d{d} "
                    f"causal {causal} q_offset {off} window {window} sinks {sinks}")
            for disc in (fa.ONLINE, fa.FIXED, fa.HYBRID):
                args = (q, *cache, causal, d ** -0.5, off, window, sinks, disc,
                        k_max if disc == fa.HYBRID else None)
                o, lse = fa._fwd_q_cuda(*args)
                po, plse = fa._fwd_q_plain(*args)
                _hold(f"{what} disc {disc}", entry, o, po, lse, plse)
            for scale in (1.0, 40.0):  # bounded rows, then rows past the range
                args = (q * scale, *cache, causal, d ** -0.5, off, window, sinks,
                        fa.FIXED)
                bad = int(fa._fwd_q_cuda(*args, guard=True)[2])
                pbad = int(fa._fwd_q_plain(*args, guard=True)[2])
                if bad != pbad:
                    raise AssertionError(f"{what}: the guard counts {bad} rows "
                                         f"at q x {scale}, plain {pbad}")
            log(f"{what}: O, LSE and the guard's count hold in the three "
                f"disciplines [{label}]")


def phase_kv_quant(device, b, hq, hkv, n, d, label):
    """The dense 8-bit forward (flash_attention_kv_quant_with_lse,
    flash_fwd_sm90.cuh's block body over widened byte tiles) over int8 and
    e4m3 caches in each discipline against `_fwd_q_plain`, O and LSE, at
    run_all.py's 4K kvq rung (causal); each timed, beside the bf16
    fixed-max kernel on the dequantized cache; then at its blocks' and
    tiles' edges (`fwd_q_edges`). The int8 fixed-max time stands for the
    kernel (library_ms null: no PyTorch call attends an 8-bit cache)."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(89)
    entry = _disc_entry("flash_fwd_q", "flash_fwd_q.cu", "flash_attention.py:92")
    q = torch.randn(b, hq, n, d, generator=gen, device=device).bfloat16()
    pairs = b * hq * visible_pairs(n, n, 0, True)
    scale = d ** -0.5
    for fmt in FMTS:
        kq, ks = quantized(gen, device, (b, hkv, n, d), fmt)
        vq, vs = quantized(gen, device, (b, hkv, n, d), fmt)
        cache = (kq, ks, vq, vs)
        k_max = fa.k_max_norm(kq, ks)
        times = {}
        for stable, disc in ((True, fa.ONLINE), (False, fa.FIXED),
                             ("auto", fa.HYBRID)):
            o, lse = fa.flash_attention_kv_quant_with_lse(q, *cache, causal=True,
                                                          stable=stable)
            args = (q, *cache, True, scale, 0, 0, 0, disc,
                    k_max if disc == fa.HYBRID else None)
            po, plse = fa._fwd_q_plain(*args)
            err = _hold(f"flash_fwd_q {fmt} stable={stable}", entry, o, po, lse,
                        plse)
            del po, plse
            times[stable] = time_pair(lambda: fa._fwd_q_cuda(*args),
                                      lambda: fa._fwd_q_plain(*args), device)
            log(f"flash_fwd_q {fmt} stable={stable!r} b{b} hq{hq} hkv{hkv} n{n} "
                f"d{d} causal: O rel-L2 {err:.3e}, LSE ok | kernel "
                f"{times[stable][0]:.4f} ms "
                f"({4 * d * pairs / times[stable][0] / 1e9:.1f} TFLOP/s) vs "
                f"plain {times[stable][1]:.4f} ms [{label}]")
        kb, vb = dequantized_bf16(kq, ks), dequantized_bf16(vq, vs)
        bf16_ms = time_ms(lambda: fa._fwd(q, kb, vb, True, scale, 0, 0, 0,
                                          fa.FIXED), device, graph=True)
        bnd = bound(4 * d * pairs, nbytes(q, o, lse) + bytes_8bit(b * n, hkv, d))
        log(f"flash_fwd_q {fmt}: online {times[True][0]:.4f}, fixed-max "
            f"{times[False][0]:.4f}, auto {times['auto'][0]:.4f} ms vs the bf16 "
            f"fixed-max kernel on the dequantized cache {bf16_ms:.4f} ms | bound "
            f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}) [{label}]")
        if fmt == "int8":
            entry.update(ms=times[False][0], plain_ms=times[False][1],
                         online_ms=times[True][0], auto_ms=times["auto"][0],
                         bf16_ms=bf16_ms, **bnd,
                         shape=f"b{b} hq{hq} hkv{hkv} n{n} d{d} causal, fixed-max")
        else:
            entry["fp8_ms"] = times[False][0]
    fwd_q_edges(device, entry, label)
    return entry


def phase_config5(device, entry, label, tail=512):
    """BASELINE.json config 5 through flash_attention_kv_quant: 1 x 32/8
    heads x 32768 x 128 over an int8 cache, causal, fixed-max (run_all.py's
    rung); the last `tail` query rows held against `_fwd_q_plain` of those
    rows (the whole plain forward would need 128 GiB of scores); timed
    beside the online 8-bit kernel at the same shape. Returns the launches
    of the 8-bit dense forward in this phase."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import flash_attention as fa

    hq, hkv, n, d = (CONFIG5[x] for x in ("hq", "hkv", "n", "d"))
    gen = torch.Generator(device=device).manual_seed(97)
    q = torch.randn(1, hq, n, d, generator=gen, device=device).bfloat16()
    kq, ks = quantized(gen, device, (1, hkv, n, d), "int8")
    vq, vs = quantized(gen, device, (1, hkv, n, d), "int8")
    scale = d ** -0.5
    reset_counters()
    o = fa.flash_attention_kv_quant(q, kq, ks, vq, vs, causal=True, stable=False)
    torch.cuda.synchronize()
    launches = read_counters()
    po, _ = fa._fwd_q_plain(q[:, :, -tail:].contiguous(), kq, ks, vq, vs, True,
                            scale, n - tail, 0, 0, fa.FIXED)
    err = _hold("config 5", entry, o[:, :, -tail:], po)
    del po
    args = (q, kq, ks, vq, vs, True, scale, 0, 0, 0)
    f1 = time_ms(lambda: fa._fwd_q_cuda(*args, fa.FIXED), device, iters=3,
                 graph=True)
    s1 = time_ms(lambda: fa._fwd_q_cuda(*args), device, iters=3, graph=True)
    s2 = time_ms(lambda: fa._fwd_q_cuda(*args), device, iters=3, graph=True)
    f2 = time_ms(lambda: fa._fwd_q_cuda(*args, fa.FIXED), device, iters=3,
                 graph=True)
    f_ms, s_ms = min(f1, f2), min(s1, s2)
    flops = 4 * hq * d * visible_pairs(n, n, 0, True)
    bnd = bound(flops, nbytes(q, o) + 4 * n * hq + bytes_8bit(n, hkv, d))
    log(f"config 5: 1 x {hq}/{hkv} heads x {n} x {d}, int8 KV, causal, "
        f"fixed-max: the last {tail} rows rel-L2 {err:.3e} vs plain | kernel "
        f"{f_ms:.4f} ms ({flops / f_ms / 1e9:.1f} TFLOP/s) vs online "
        f"{s_ms:.4f} ms ({flops / s_ms / 1e9:.1f} TFLOP/s) | bound "
        f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}) | launches "
        f"{ {k: x for k, x in launches.items() if k.startswith('flash_fwd_q')} } "
        f"[{label}]")
    entry.update(config5_ms=f_ms, config5_online_ms=s_ms,
                 config5_bound_ms=bnd["bound_ms"])
    return sum(x for k, x in launches.items() if k.startswith("flash_fwd_q/")
               or k == "flash_fwd_q")


def phase_headline(device, entry, label):
    """bench.py's headline call in the port: flash_attention(q, k, v,
    causal=True, stable="auto", k_max=k_max_norm(k)) at 1 x 16/4 heads x
    4096 x 128, bf16, inputs from numpy's generator at seed 42 as bench.py
    draws them; its TFLOP/s with bench.py:79's FLOP count and its share of
    the card's 989, beside the stable and fixed-max calls, "auto" without
    a cached k_max, and SDPA, all timed in turns from CUDA graphs. The
    output is held against the plain version. Returns the hybrid launches
    of one headline call."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import flash_attention as fa

    B, H, HKV, N, D = 1, 16, 4, 4096, 128
    rng = np.random.default_rng(42)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .to(device).bfloat16()
               for shape in ((B, H, N, D), (B, HKV, N, D), (B, HKV, N, D)))
    k_max = fa.k_max_norm(k)
    call = lambda: fa.flash_attention(q, k, v, causal=True, stable="auto",  # noqa: E731
                                      k_max=k_max)
    reset_counters()
    o = call()
    torch.cuda.synchronize()
    launches = read_counters()["flash_fwd/hybrid"]
    if launches != 1:
        raise AssertionError(f"the headline call launched {launches} hybrid kernels")
    po = fa._fwd_plain(q, k, v, True, D ** -0.5, 0, 0, 0, fa.HYBRID, k_max)[0]
    err = _hold("headline", entry, o, po)
    del po
    flops = 4 * B * H * N * N * D * 0.5  # bench.py:79
    calls = dict(
        auto=call,
        stable=lambda: fa.flash_attention(q, k, v, causal=True),
        fixed=lambda: fa.flash_attention(q, k, v, causal=True, stable=False),
        auto_uncached=lambda: fa.flash_attention(q, k, v, causal=True,
                                                 stable="auto"),
        sdpa=sdpa_fn(q, k, v, causal=True))
    ms = {name: [] for name in calls}
    for order in (list(calls), list(calls)[::-1]):
        for name in order:
            ms[name].append(time_ms(calls[name], device, graph=True))
    ms = {name: min(t) for name, t in ms.items()}
    tf = {name: flops / t / 1e9 for name, t in ms.items()}
    log(f"headline (bench.py:70-79): flash_attention(causal=True, "
        f"stable=\"auto\", k_max=k_max_norm(k)) at {B}x{H}/{HKV}x{N}x{D} bf16: "
        f"O rel-L2 {err:.3e} vs plain | {ms['auto']:.4f} ms = "
        f"{tf['auto']:.1f} TFLOP/s, {100 * tf['auto'] / PEAK_TFLOPS:.1f}% of "
        f"{PEAK_TFLOPS:.0f} | stable {ms['stable']:.4f} ms ({tf['stable']:.1f}),"
        f" fixed-max {ms['fixed']:.4f} ms ({tf['fixed']:.1f}), auto without "
        f"k_max {ms['auto_uncached']:.4f} ms ({tf['auto_uncached']:.1f}), SDPA "
        f"{ms['sdpa']:.4f} ms ({tf['sdpa']:.1f} TFLOP/s) [{label}]")
    entry.update(headline_ms=ms["auto"], headline_tflops=tf["auto"])
    return launches


def phase_fixed_slices(device, cfg, params, prompts, max_batch, max_len,
                       max_new, tie, label):
    """The serving model with attn_stable=False through the Scheduler three
    ways: (i) the default mode, (ii) prefill in chunks of 256 (the ragged
    forward), (iii) an int8 cache in chunks of 256 (the 8-bit ragged
    forward and decode). Each must launch its fixed-max kernels and not
    their online forms; greedy tokens against the stable run of the same
    requests (the default slice, and the int8 linear slice for (iii)) with
    every first divergence a near-tie (`tie`; an int8 one for (iii)).
    Returns the launches of each run by its tag."""
    runs = (  # tag, options, must launch, must not, stable tag
        ("fixed slice", {}, ("flash_fwd/fixed", "flash_decode"),
         ("flash_fwd", "flash_fwd/hybrid"), "slice"),
        ("fixed slice (prefill_chunk=256)", dict(prefill_chunk=256),
         ("flash_fwd_ragged/fixed", "flash_decode"), ("flash_fwd_ragged",),
         "slice"),
        ("fixed slice (int8, prefill_chunk=256)",
         dict(quantized_cache=True, prefill_chunk=256),
         ("flash_fwd_ragged_q/fixed", "flash_decode_q"), ("flash_fwd_ragged_q",),
         "int8 slice (linear)"),
    )
    out = {}
    for tag, kw, kernels, absent, ref_tag in runs:
        sched, tokens, launches = serve(device, cfg, params, prompts, max_new,
                                        kernels, label, tag, max_batch=max_batch,
                                        max_len=max_len, **kw)
        if any(launches[k] for k in absent):
            raise AssertionError(f"{tag} ran an online forward: {launches}")
        ref = SLICE_TOKENS[ref_tag]
        audit = tie
        if kw.get("quantized_cache"):
            audit = NearTie(cfg, params, list(prompts[0]) + ref[0][:1],
                            quantized=True)
        windows, gaps = audit.audit(tokens, ref, prompts, tag)
        same = np.mean([a == b for x, y in zip(tokens, ref) for a, b in zip(x, y)])
        m, r = SLICE_METRICS[tag], SLICE_METRICS[ref_tag]
        log(f"{tag} vs the stable {ref_tag} (same run): {m.tok_per_s:.1f} vs "
            f"{r.tok_per_s:.1f} tok/s | TTFT mean {m.ttft_s_mean * 1e3:.1f} vs "
            f"{r.ttft_s_mean * 1e3:.1f} ms | tokens equal {same:.4f}, "
            f"{len(gaps)} divergences, all near-ties (gaps "
            f"{[f'{g:.2e}' for g in gaps]}, bound {audit.bound:.2e}) [{label}]")
        out[tag] = launches
        del sched
        if tag == "fixed slice":
            # the host's drift over a run is of the order of what the
            # discipline changes: the stable and the fixed-max default slice
            # again in blocks of stable, fixed, fixed, stable, for paired
            # readings
            stable_cfg = dataclasses.replace(cfg, attn_stable=True)
            turns = []
            for _ in range(TURN_BLOCKS):
                for what, c, must in (
                        ("stable", stable_cfg, ("flash_fwd", "flash_decode")),
                        ("fixed", cfg, kernels), ("fixed", cfg, kernels),
                        ("stable", stable_cfg, ("flash_fwd", "flash_decode"))):
                    again = f"{what} slice (turn {len(turns) + 1})"
                    serve(device, c, params, prompts, max_new, must, label,
                          again, max_batch=max_batch, max_len=max_len)
                    turns.append((what, SLICE_METRICS[again].tok_per_s))
            ratios = [(turns[i + 1][1] + turns[i + 2][1])
                      / (turns[i][1] + turns[i + 3][1])
                      for i in range(0, len(turns), 4)]
            log(f"fixed slice in turns with the stable default slice: "
                + ", ".join(f"{w} {r:.1f}" for w, r in turns) + " tok/s; "
                f"fixed / stable by block {[f'{x:.3f}' for x in ratios]} "
                f"[{label}]")
    return out


def phase_default_model(device, label):
    """The JAX package's default config (d_model 1024, 8 layers, 16/4 heads
    x 64, d_ff 2816) with attn_stable=False: 8 of the serving requests
    through the default Scheduler, whose prefill must take the packed
    forward (and no other dense one), then 5 SGD steps at batch 4 x 4096
    through the packed forward and the backward kernels, the loss finite
    and falling. Returns (the serving launches, the training launches)."""
    import torch

    from flashattention_kernel_project_tpu_torch.models import transformer as tfm

    cfg = tfm.TransformerConfig(**JAX_DEFAULT, attn_stable=False,
                                dtype=torch.bfloat16)
    params = tfm.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                             device)
    _, _, launches = serve(device, cfg, params, serving_prompts(cfg, 8), 64,
                           ("flash_fwd/packed", "flash_decode"), label,
                           "d64 fixed slice", max_batch=8, max_len=2048)
    if launches["flash_fwd"] or launches["flash_fwd/fixed"]:
        raise AssertionError(f"the d64 slice ran an unpacked forward: {launches}")
    _, train_launches, _ = phase_train(
        device, cfg, params, motif_corpus(cfg), TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR,
        steps=5, label=label, kernels=("flash_fwd/packed", "flash_bwd"))
    return launches, train_launches


# The GEMM and softmax ladder: benchmarks/run_all.py:44-162's GEMM and
# softmax rungs at their shapes and BASELINE.json configs 1-3, its 8-bit
# GEMM rungs, the resident softmax epilogue and the streaming decode
# (:521-530), with ragged shapes (tests/test_gemm.py:13, :65,
# tests/test_quant.py, tests/test_streaming.py) for the kernels' edges.
GEMM_F32_TOL = 2e-5   # rel-L2 of f32 GEMM outputs: TF32 would read ~5e-4
GEMM_MAX_ABS = 1e-2   # max-abs of f32 GEMM outputs (tests/test_gemm.py:19)
BF16_TOL = 1e-2       # rel-L2 of bf16 outputs, the JAX suite's bound
SOFTMAX_MAX_ABS = 1e-5  # the f32 row softmax (tests/test_softmax.py:23)
# softmax-epilogue rows sum to 1 within rtol 1e-3 (tests/test_gemm.py:80-82)
# in f32; a bf16 output rounds each p by up to 2^-9 of itself, which alone
# moves a row's sum by up to 2^-9, so bf16 rows are held to 2^-8
ROW_SUM_RTOL = {"f32": 1e-3, "bf16": 2.0 ** -8}
# the resident form's rows sum to 1 within 1e-2 (tests/test_gemm.py:105-107):
# e and 1/l are each rounded to the output type before their product
RESIDENT_ROW_RTOL = 1e-2
BASELINE_MAX_ABS = 1e-2  # BASELINE.json's target against the fp64 oracle
CONFIG3 = dict(b=32, n=2048, scale=0.125)


@dataclasses.dataclass
class Rung:
    """One call of the ladder through the ops API and how it is held: its
    kernel's entry name, the call, its plain version on the same inputs,
    the gate ("f32", "bf16", "softmax", "rows f32", "rows bf16",
    "resident": bf16 and rows summing to 1 within 1e-2, "exact": bit-equal,
    "decode": bf16 with the rows of empty sequences exactly 0), the
    function's operations and bytes (inputs read once, the output written
    once; the f32 wgmma kernel's six bf16 products) with the peak rate of
    their type, the one library call of the same
    function (or None), and whether its times stand for the kernel
    ("entry") or are logged beside it ("extra"). `unfused` is a multi-call
    baseline of the same function, `beside` other calls of it on the same
    inputs (name -> call: the port's other kernels, a baseline in another
    layout), each timed and logged; `graph` times from
    CUDA graphs (else eagerly, for calls of milliseconds)."""

    kernel: str
    label: str
    call: object
    plain: object
    gate: str
    flops: float
    nbytes: int
    peak: float
    library: object = None
    timed: str | None = None
    unfused: object = None  # e.g. run_all.py:131's two-call baseline (config 3)
    beside: dict | None = None
    graph: bool = True
    empty: tuple = ()  # the rows that must be exactly 0 ("decode")
    sm90: bool | None = None  # a GEMM call that must (not) take the bf16 wgmma kernel
    f32x: bool | None = None  # ... (not) take the f32 wgmma kernel
    entry: str | None = None  # the kernels-line entry it stands for, if not `kernel`
    split: object = None  # the f32 wgmma kernel's split plain version ("f32")
    # the softmax epilogue's wgmma launches the call must make (rows 1,
    # resident 2 with its gated rows launch; 0 on the mma.sync kernels)
    softmax_sm90: int | None = None
    # an 8-bit GEMM call that must (not) take its wgmma kernel (kernel 20's
    # with one transposing pass, of `transposed`, its B operand)
    gemm8_sm90: bool | None = None
    transposed: object = None


def fused_split_plain(a, b, bias, res, out):
    """Kernel 15's function on the f32 wgmma kernel's split product
    (`_matmul_f32_split_plain` in f32), for an f32 fused-epilogue call."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import gemm as g

    c = g._matmul_f32_split_plain(a, b, torch.float32) + bias.float()
    return (torch.relu(c) + res.float()).to(out)


def unfused_epilogue(a, b, bias, res, out):
    """A closure making the unfused PyTorch calls of kernel 15's function on
    bf16 a and b (a multi-call baseline, never on the port's path): the
    product to f32 by torch.mm's out_dtype where the installed torch takes
    it (else torch.matmul of the operands widened to f32, and the run says
    so), then + bias, relu_, + residual and the cast to `out`."""
    import torch

    try:
        torch.mm(a[:8, :8], b[:8, :8], out_dtype=torch.float32)
        product = lambda: torch.mm(a, b, out_dtype=torch.float32)  # noqa: E731
    except (TypeError, RuntimeError):
        log("library: this torch's mm takes no out_dtype; the unfused epilogue's "
            "product is torch.matmul of the operands widened to f32")
        a32, b32 = a.float(), b.float()
        product = lambda: torch.matmul(a32, b32)  # noqa: E731
    return lambda: (product() + bias).relu_().add_(res).to(out)


def ladder_rungs(device) -> list:
    """The ladder's calls at their shapes; inputs normal from a seed on the
    card."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import gemm as g
    from flashattention_kernel_project_tpu_torch.ops import softmax as sm
    from flashattention_kernel_project_tpu_torch.utils import platform

    gen = torch.Generator(device=device).manual_seed(42)
    bf, f32 = torch.bfloat16, torch.float32
    peak = {bf: platform.H100_BF16_FLOPS, f32: platform.H100_FP32_FLOPS}
    rungs = []

    def rand(*shape, dtype=f32, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=device) * scale).to(dtype)

    def out_bytes(shape, dt):
        return int(np.prod(shape)) * torch.empty(0, dtype=dt).element_size()

    def gemm(label, a, b, out=f32, bias=None, res=None, timed=None, library=None,
             sm90=False, f32x=False, unfused=None):
        batched = a.dim() == 3
        kernel = ("gemm_fused_epilogue" if bias is not None
                  else "gemm_batched" if batched else "gemm")
        if bias is not None:
            call = lambda: g.matmul_fused_epilogue(a, b, bias, res, out_dtype=out)  # noqa: E731
            plain = lambda: g._fused_epilogue_plain(a, b, bias, res, out)  # noqa: E731
            split = lambda: fused_split_plain(a, b, bias, res, out)  # noqa: E731
        else:
            mm = g.batched_matmul if batched else g.matmul
            call = lambda: mm(a, b, out_dtype=out)  # noqa: E731
            plain = lambda: g._matmul_plain(a, b, out)  # noqa: E731
            split = lambda: g._matmul_f32_split_plain(a, b, out)  # noqa: E731
        shape = (*a.shape[:-1], b.shape[-1])
        extra = () if bias is None else (bias, res)
        # the f32 wgmma kernel: six bf16 products on the tensor cores
        passes, rate = (6, peak[bf]) if f32x else (1, peak[a.dtype])
        rungs.append(Rung(kernel, label, call, plain, "f32" if out == f32 else "bf16",
                          passes * 2 * a.numel() * b.shape[-1],
                          nbytes(a, b, *extra) + out_bytes(shape, out), rate,
                          library, timed, unfused=unfused, sm90=sm90, f32x=f32x,
                          entry="gemm_f32" if f32x and bias is None else None,
                          split=split if f32x else None))

    # run_all.py:44-75; the aligned bf16 products take the wgmma kernel
    a16, b16 = rand(4096, 4096, dtype=bf), rand(4096, 4096, dtype=bf)
    gemm("matmul bf16 4096^3 -> bf16", a16, b16, out=bf, timed="entry",
         library=lambda: torch.matmul(a16, b16), sm90=True)
    gemm("matmul bf16 4096^3 -> f32", a16, b16, timed="extra", sm90=True)
    # run_all.py's f32 rung on the f32 wgmma kernel (JAX's six bf16 passes)
    a32, b32 = rand(2048, 2048), rand(2048, 2048)
    gemm("matmul f32 2048^3", a32, b32, timed="entry",
         library=lambda: torch.matmul(a32, b32), f32x=True)
    ab, bb = rand(8, 1024, 1024, dtype=bf), rand(8, 1024, 1024, dtype=bf)
    gemm("batched bf16 8x1024^3 -> bf16", ab, bb, out=bf, timed="entry",
         library=lambda: torch.bmm(ab, bb), sm90=True)
    # kernel 15 on the bf16 wgmma kernel, beside the unfused calls of the
    # same function (`unfused_epilogue`)
    bias, res = rand(4096), rand(4096, 4096)
    gemm("fused epilogue bf16 4096^3 -> bf16", a16, b16, out=bf, bias=bias,
         res=res, timed="entry", sm90=True,
         unfused=unfused_epilogue(a16, b16, bias, res, bf))
    # ragged: K = 130 (and 72 columns of bf16) take the element-wise loads,
    # K = 132 (f32) and K = 136 (bf16) the wgmma kernels' zero-filled TMA
    # boxes
    for dt, ks in ((f32, (130, 132)), (bf, (130, 136))):
        name = "f32" if dt == f32 else "bf16"
        for k in ks:
            gemm(f"matmul {name} 200x{k}x72", rand(200, k, dtype=dt), rand(k, 72, dtype=dt),
                 sm90=(dt, k) == (bf, 136), f32x=(dt, k) == (f32, 132))
    gemm("batched bf16 3x200x130x72", rand(3, 200, 130, dtype=bf), rand(3, 130, 72, dtype=bf))
    # the bf16 epilogue at K = 130 on the mma.sync core, the f32 one at K =
    # 132 on the f32 wgmma kernel
    for dt, k in ((bf, 130), (f32, 132)):
        gemm(f"fused epilogue {'f32' if dt == f32 else 'bf16'} 200x{k}x72",
             rand(200, k, dtype=dt), rand(k, 72, dtype=dt), bias=rand(72),
             res=rand(200, 72), f32x=dt == f32)

    # BASELINE config 3 (run_all.py:105-116) in bf16 and f32 out, and the
    # ragged N = 160 of tests/test_gemm.py:65 (the padded-column mask), on
    # the wgmma kernel; K 130 and N 75 (off its alignment) and K = 0 (the
    # softmax of the bias alone) on the mma.sync rows kernel
    b3, n3, sc = CONFIG3["b"], CONFIG3["n"], CONFIG3["scale"]
    cases = ((f"config 3: {b3}x{n3}^3", rand(b3, n3, n3, dtype=bf),
              rand(b3, n3, n3, dtype=bf), rand(n3)),
             ("3x96x128x160", rand(3, 96, 128, dtype=bf), rand(3, 128, 160, dtype=bf),
              rand(160)))
    unaligned = (("1x200x130x75", rand(1, 200, 130, dtype=bf), rand(1, 130, 75, dtype=bf),
                  rand(75)),
                 ("2x64x0x72", rand(2, 64, 0, dtype=bf), rand(2, 0, 72, dtype=bf),
                  rand(72, scale=4.0)))
    for i, (what, a, b, bi) in enumerate(cases + unaligned):
        for out in (bf, f32):
            name = "f32" if out == f32 else "bf16"
            entry = (i, out) == (0, bf)
            rungs.append(Rung(
                "gemm_softmax", f"softmax epilogue {what} -> {name}",
                lambda a=a, b=b, bi=bi, out=out: g.batched_matmul_softmax_epilogue(
                    a, b, bi, scale=sc, out_dtype=out),
                lambda a=a, b=b, bi=bi, out=out: g._softmax_epilogue_plain(
                    a, b, bi, sc, out),
                f"rows {name}", 2 * a.numel() * b.shape[-1],
                nbytes(a, b, bi) + out_bytes((*a.shape[:-1], b.shape[-1]), out),
                peak[bf], timed="entry" if entry else None,
                # bmm, then softmax in f32: the scores through device memory
                unfused=(lambda a=a, b=b, bi=bi: torch.softmax(
                    torch.bmm(a, b).float() * sc + bi, dim=-1).bfloat16())
                if entry else None, graph=False, softmax_sm90=int(i < len(cases))))
    resident_rungs(rungs, cases, rand, out_bytes, peak[bf])

    # run_all.py:143-157, a bf16 input, a ragged row, leading dims, and rows
    # of a vocabulary's width, too long for registers (read twice)
    for what, x, gate, timed in (
            ("softmax f32 8192x4096", rand(8192, 4096), "softmax", "entry"),
            ("softmax f32 4096x512", rand(4096, 512), "softmax", "extra"),
            ("softmax bf16 8192x4096", rand(8192, 4096, dtype=bf), "bf16", "extra"),
            ("softmax f32 7x33", rand(7, 33, scale=4.0), "softmax", None),
            ("softmax f32 4x8x256", rand(4, 8, 256, scale=4.0), "softmax", None),
            ("softmax f32 256x32000", rand(256, 32000, scale=4.0), "softmax", None),
            ("softmax bf16 64x40001", rand(64, 40001, dtype=bf, scale=4.0), "bf16",
             None)):
        rungs.append(Rung("softmax", what, lambda x=x: sm.softmax(x),
                          lambda x=x: sm._softmax_plain(x), gate, 5 * x.numel(),
                          2 * nbytes(x), peak[f32],
                          lambda x=x: torch.softmax(x, dim=-1), timed))
    gemm8_rungs(rungs, gen, rand, out_bytes, a16)
    streaming_rungs(rungs, gen, device)
    return rungs


WITNESS = {}  # label -> the resident form's witness count of that rung's call


def resident_rungs(rungs, cases, rand, out_bytes, peak):
    """Kernel 17 (batched_matmul_softmax_epilogue(resident=True)) at config
    3's inputs (the entry: beside kernel 16 on them and the unfused pair)
    and at two ragged shapes; each call keeps its witness count in
    WITNESS."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import gemm as g

    bf = torch.bfloat16
    sc = CONFIG3["scale"]
    fn = g.batched_matmul_softmax_epilogue
    # config 3; M and N ragged against the 128 x 128 tiles; K and N not
    # multiples of 8 (the mma.sync kernel's element-wise instance)
    shapes = (cases[0], ("2x1088x256x200", rand(2, 1088, 256, dtype=bf),
                         rand(2, 256, 200, dtype=bf), rand(200)),
              ("1x200x130x75", rand(1, 200, 130, dtype=bf), rand(1, 130, 75, dtype=bf),
               rand(75)))
    for i, (what, a, b, bi) in enumerate(shapes):
        label = f"resident softmax epilogue {what} -> bf16"

        def call(a=a, b=b, bi=bi, label=label):
            out = fn(a, b, bi, scale=sc, out_dtype=bf, resident=True)
            WITNESS[label] = fn.witness
            return out

        rungs.append(Rung(
            "gemm_softmax_resident", label, call,
            lambda a=a, b=b, bi=bi: g._softmax_epilogue_resident_plain(a, b, bi, sc, bf)[0],
            "resident", 2 * a.numel() * b.shape[-1],
            nbytes(a, b, bi) + out_bytes((*a.shape[:-1], b.shape[-1]), bf), peak,
            timed="entry" if i == 0 else None,
            unfused=(lambda a=a, b=b, bi=bi: torch.softmax(
                torch.bmm(a, b).float() * sc + bi, dim=-1).bfloat16()) if i == 0 else None,
            beside=dict(rows_kernel=lambda a=a, b=b, bi=bi: fn(a, b, bi, scale=sc,
                                                               out_dtype=bf))
            if i == 0 else None, graph=False,
            # K 130, N 75: off the wgmma kernel's alignment, the mma.sync one
            softmax_sm90=0 if i == 2 else 2))


# (M, K, N) of the 8-bit GEMMs' aligned calls that do not divide their
# tiles: one row, one 16-column group, K of one slice or less, M, N and K
# off every tile. Kernel 19 (64-deep slices; w8_plan on 132 SMs, rows of x
# x columns of C): 64 x 64 for 200 x 336 x 272, 65 x 128 x 144 and 40 x
# 136 x 1040, 16 x 64 for 1 x 64 x 16, 128 x 128 for 100 x 72 x 16912
# (133 tiles), 256 x 128 for 1100 x 520 x 4112 (165 tiles); kernel 20
# (128-deep slices): 128 x 128 tiles for the first three, 128 x 256 for
# 1100 x 336 x 4112
W8_EDGES = [(200, 336, 272), (65, 128, 144), (1, 64, 16), (40, 136, 1040),
            (100, 72, 16912), (1100, 520, 4112)]
I8_EDGES = [(200, 336, 272), (65, 128, 144), (1, 64, 16), (1100, 336, 4112)]


def gemm8_rungs(rungs, gen, rand, out_bytes, a16):
    """Kernels 19 and 20 at run_all.py:76-101's shapes (bf16 4096^2
    activations, 4096^2 weights quantized per column by the port's own
    quantizers, bit-equal to JAX's; int8 activations per row), kernel 19 at
    the decode shape of the JAX engine's int8 projections (M 8, K 2048, N
    11008, models/engine.py:388-390), both at W8_EDGES / I8_EDGES (bf16
    and f32 out; kernel 19 with an f32 x at the first), all on their wgmma
    kernels; and the ragged shapes of tests/test_quant.py and a ragged K,
    off their alignment, on the mma.sync kernels."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import quant as qt
    from flashattention_kernel_project_tpu_torch.utils import platform

    bf, f32 = torch.bfloat16, torch.float32

    def w8(label, x, n, fmt, out=bf, timed=None, sm90=True):
        w = rand(x.shape[1], n)
        wq, ws = qt.quantize_int8(w, axis=0) if fmt == "int8" else qt.quantize_fp8_weights(w)
        fn = qt.matmul_int8_weights if fmt == "int8" else qt.matmul_fp8_weights
        rungs.append(Rung(
            "gemm_w8", label, lambda: fn(x, wq, ws, out_dtype=out),
            lambda: qt._matmul_w8_plain(x, wq, ws, out),
            "f32" if out == f32 else "bf16", 2 * x.numel() * n,
            nbytes(x.bfloat16(), wq, ws) + out_bytes((x.shape[0], n), out),
            platform.H100_BF16_FLOPS, timed=timed,
            # the JAX engine's own form (engine.py:394-401): three calls
            unfused=(lambda: (torch.matmul(x, wq.to(bf)) * ws).to(out))
            if timed else None, gemm8_sm90=sm90))
        return wq, ws

    # run_all.py:76-86
    w8_4096 = w8("gemm_int8_weights_4096 (bf16 4096^3 -> bf16)", a16, 4096, "int8",
                 timed="entry")
    w8("gemm_fp8_weights_4096 (bf16 4096^3 -> bf16)", a16, 4096, "fp8", timed="extra")
    # ragged (tests/test_quant.py: 100 x 200 x 130, N off the 16-byte rows),
    # an f32 x rounded in the wrapper, f32 out: the mma.sync kernel
    x_r = rand(100, 200)
    w8("matmul_int8_weights f32 100x200x130 -> f32", x_r, 130, "int8", out=f32, sm90=False)
    w8("matmul_fp8_weights f32 100x200x130 -> f32", x_r, 130, "fp8", out=f32, sm90=False)
    # the decode shape (64 x 64 tiles), timed beside its byte bound
    x_dec = rand(8, 2048, dtype=bf)
    for fmt in ("int8", "fp8"):
        name = "matmul_int8_weights" if fmt == "int8" else "matmul_fp8_weights"
        w8(f"{name} bf16 8x2048x11008 (decode) -> bf16", x_dec, 11008, fmt,
           timed="extra")
    for i, (m, k, n) in enumerate(W8_EDGES):
        x_e = rand(m, k) if i == 0 else rand(m, k, dtype=bf)
        for fmt in ("int8", "fp8"):
            name = "matmul_int8_weights" if fmt == "int8" else "matmul_fp8_weights"
            for out in (bf, f32):
                w8(f"{name} {'f32' if i == 0 else 'bf16'} {m}x{k}x{n} (edge) -> "
                   f"{'f32' if out == f32 else 'bf16'}", x_e, n, fmt, out=out)

    def i8(label, m, k, n, out=f32, timed=None, b=None, sm90=True):
        a_q, a_s = qt.quantize_int8(rand(m, k), axis=1)
        b_q, b_s = b if b is not None else qt.quantize_int8(rand(k, n), axis=0)
        beside = None
        if timed:
            b_col = b_q.t().contiguous().t()  # column-major, as cuBLASLt wants it
            beside = dict(int_mm_col_major_b=int_mm(a_q, a_s, b_q, b_s, out, True),
                          int_mm_alone_col_major_b=lambda: torch._int_mm(a_q, b_col),
                          transposing_pass=lambda: qt._transpose_i8_cuda(b_q))
        rungs.append(Rung(
            "gemm_i8", label, lambda: qt.matmul_int8(a_q, a_s, b_q, b_s, out_dtype=out),
            lambda: qt._matmul_i8_plain(a_q, a_s, b_q, b_s, out), "exact",
            2 * m * k * n, nbytes(a_q, a_s, b_q, b_s) + out_bytes((m, n), out),
            platform.H100_INT8_OPS, timed=timed,
            unfused=int_mm(a_q, a_s, b_q, b_s, out) if timed else None,
            beside=beside, gemm8_sm90=sm90, transposed=b_q if sm90 else None))

    # run_all.py:88-101, the int8 weights of the rung above as B, as there
    i8("gemm_int8_int8_4096 (int8 4096^3 -> f32)", 4096, 4096, 4096, timed="entry",
       b=w8_4096)
    for m, k, n in I8_EDGES:
        for out in (f32, bf):
            i8(f"matmul_int8 {m}x{k}x{n} (edge) -> {'f32' if out == f32 else 'bf16'}",
               m, k, n, out=out)
    i8("matmul_int8 200x320x150 -> f32", 200, 320, 150, sm90=False)
    i8("matmul_int8 200x320x150 -> bf16", 200, 320, 150, out=bf, sm90=False)
    i8("matmul_int8 200x130x72 -> f32 (K not a multiple of 16)", 200, 130, 72,
       sm90=False)


def int_mm(a_q, a_s, b_q, b_s, out, col_major=False):
    """torch._int_mm, then the scales: the unfused baseline of kernel 20
    (several calls), never on the port's path. col_major: B laid out
    column-major before the timed call (cuBLASLt's int8 products want it so;
    the port's kernel takes B row-major, as JAX's does)."""
    import torch

    if col_major:
        b_q = b_q.t().contiguous().t()
    return lambda: (torch._int_mm(a_q, b_q).float() * a_s * b_s).to(out)


def streaming_rungs(rungs, gen, device):
    """Kernel 21 (streaming_decode) at run_all.py:521-530's rung (B 256,
    8/1 heads, S 4096, d 128, every length 4096: 512 MiB of K/V), beside
    SDPA (one call: every length is S) and the port's split decode (kernel
    6); and with ragged lengths, 0 among them, at G = 4, d = 128 (S not a
    multiple of the 64-key tile) and G = 8, d = 64."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import flash_decode as fd
    from flashattention_kernel_project_tpu_torch.ops import streaming as st
    from flashattention_kernel_project_tpu_torch.utils import platform

    bf = torch.bfloat16

    def case(label, b, hq, hkv, s, d, lens, timed=None):
        q = torch.randn(b, hq, d, generator=gen, device=device).to(bf)
        k = torch.randn(b, hkv, s, d, generator=gen, device=device).to(bf)
        v = torch.randn(b, hkv, s, d, generator=gen, device=device).to(bf)
        lengths = torch.tensor(lens, dtype=torch.int32, device=device)
        live = int(sum(min(n, s) for n in lens))
        kw = dict(block_s=512, seq_chunk=8) if timed else {}  # run_all.py's
        rungs.append(Rung(
            "streaming_decode", label,
            lambda: st.streaming_decode(q, k, v, lengths, **kw),
            lambda: st._streaming_plain(q, k, v, lengths, d ** -0.5), "decode",
            # q, lengths, the output (q's size) and the live K/V rows
            4 * live * hq * d, 2 * nbytes(q) + nbytes(lengths) + 2 * live * hkv * d * 2,
            platform.H100_BF16_FLOPS,
            library=sdpa_fn(q[:, :, None], k, v) if timed else None, timed=timed,
            beside=dict(flash_decode=lambda: fd.flash_decode(q, k, v, lengths))
            if timed else None, graph=False,
            empty=tuple(i for i, n in enumerate(lens) if n == 0)))

    case("streaming_dma_decode_b256_s4096 (8/1 heads, d128)", 256, 8, 1, 4096, 128,
         [4096] * 256, timed="entry")
    case("streaming b6 16/4 s1000 d128, lengths 0-1000", 6, 16, 4, 1000, 128,
         [0, 1, 63, 64, 700, 1000])
    case("streaming b4 8/1 s300 d64, lengths 0-300", 4, 8, 1, 300, 64, [300, 5, 0, 129])


def _hold_ladder(rung, got, want, entry):
    """Hold a ladder output against its plain version by the rung's gate;
    folds the max-abs error into `entry`. Returns a line for the log."""
    import torch

    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{rung.label}: {tuple(got.shape)} {got.dtype} "
                             f"against {tuple(want.shape)} {want.dtype}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{rung.label}: non-finite output")
    err = _rel_l2(got, want)
    max_abs = float((got.float() - want.float()).abs().max())
    entry["max_abs_err"] = max(entry["max_abs_err"], max_abs)
    line = f"rel-L2 {err:.3e}, max-abs {max_abs:.3e}"
    gate = rung.gate
    if gate == "exact" and not torch.equal(got, want):
        raise AssertionError(f"{rung.label}: not bit-equal to plain ({line})")
    if gate in ("resident", "decode") and not err <= BF16_TOL:
        raise AssertionError(f"{rung.label}: rel-L2 {err:.3e} > {BF16_TOL}")
    if gate == "resident":
        dev = float((got.float().sum(-1) - 1.0).abs().max())
        if not dev <= RESIDENT_ROW_RTOL:
            raise AssertionError(f"{rung.label}: a row sums to 1 +- {dev:.3e} > "
                                 f"{RESIDENT_ROW_RTOL}")
        line += f", rows sum to 1 within {dev:.3e}"
    for i in rung.empty:
        if float(got[i].float().abs().max()) != 0.0:
            raise AssertionError(f"{rung.label}: sequence {i} of length 0 is not 0")
    if rung.empty:
        line += f", sequences {list(rung.empty)} of length 0 exactly 0"
    if gate == "f32" and not (err <= GEMM_F32_TOL and max_abs <= GEMM_MAX_ABS):
        raise AssertionError(f"{rung.label}: {line} (gates {GEMM_F32_TOL}, "
                             f"{GEMM_MAX_ABS})")
    if rung.split is not None:
        err_split = _rel_l2(got, rung.split())
        line += f", against the split's plain version rel-L2 {err_split:.3e}"
        if not err_split <= SPLIT_TOL:
            raise AssertionError(f"{rung.label}: {line} (gate {SPLIT_TOL})")
    if gate == "softmax" and not max_abs <= SOFTMAX_MAX_ABS:
        raise AssertionError(f"{rung.label}: max-abs {max_abs:.3e} > {SOFTMAX_MAX_ABS}")
    if gate in ("bf16", "rows f32", "rows bf16") and not err <= BF16_TOL:
        raise AssertionError(f"{rung.label}: rel-L2 {err:.3e} > {BF16_TOL}")
    if gate.startswith("rows"):
        rtol = ROW_SUM_RTOL[gate.split()[1]]
        dev = float((got.float().sum(-1) - 1.0).abs().max())
        if not dev <= rtol:
            raise AssertionError(f"{rung.label}: a row sums to 1 +- {dev:.3e} > {rtol:.3e}")
        line += f", rows sum to 1 within {dev:.3e}"
    return line


def phase_baseline_configs(device, label):
    """BASELINE.json configs 1 and 2: matmul (f32, on the f32 wgmma kernel)
    and matmul_bf16 (f32 out, on the bf16 one) at 1024^3, then the row
    softmax of the product, both held on the
    host against the fp64 oracle (the port's runtime/oracle.cpp where g++
    builds it, else numpy) at BASELINE's max-abs 1e-2; config 2's oracle
    takes the bf16-rounded inputs, as tests/test_gemm.py:33-36 does."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import gemm as g
    from flashattention_kernel_project_tpu_torch.ops import softmax as sm
    from flashattention_kernel_project_tpu_torch.runtime import native
    from flashattention_kernel_project_tpu_torch.utils.testing import max_abs_diff

    gen = torch.Generator(device=device).manual_seed(1)
    a = torch.randn(1024, 1024, generator=gen, device=device)
    b = torch.randn(1024, 1024, generator=gen, device=device)
    oracle = "native (runtime/oracle.cpp)" if native.available() else "numpy"
    for cfg, mm, operands, counter in (
            (1, g.matmul, (a, b), f32x_launches),
            (2, g.matmul_bf16, (a.bfloat16(), b.bfloat16()), sm90_launches)):
        before = counter()
        c = mm(a, b)
        if counter() != before + 1:
            raise AssertionError(f"config {cfg}: the product took another kernel "
                                 f"than its wgmma GEMM")
        p = sm.softmax(c)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c_ref = native.gemm(*(x.float().cpu().numpy() for x in operands))
        p_ref = native.softmax(c_ref)
        host_s = time.perf_counter() - t0
        c_err = max_abs_diff(c.cpu().numpy(), c_ref)
        p_err = max_abs_diff(p.cpu().numpy(), p_ref)
        log(f"BASELINE config {cfg} ({mm.__name__} 1024^3, then softmax): "
            f"against the fp64 oracle, {oracle}, {host_s:.2f} s on the host: "
            f"product max-abs {c_err:.3e}, softmax max-abs {p_err:.3e} [{label}]")
        if not (c_err <= BASELINE_MAX_ABS and p_err <= BASELINE_MAX_ABS):
            raise AssertionError(f"config {cfg} misses BASELINE's max-abs "
                                 f"{BASELINE_MAX_ABS}")


LADDER_KERNELS = dict(  # entry name -> (source, the TPU kernel's def line)
    gemm=("gemm_sm90.cuh", "gemm.py:75"), gemm_batched=("gemm_sm90.cuh", "gemm.py:172"),
    gemm_f32=("gemm_f32_sm90.cuh", "gemm.py:75"),
    gemm_fused_epilogue=("gemm_sm90.cuh", "gemm.py:250"),
    gemm_softmax=("gemm_softmax_sm90.cuh", "gemm.py:334"),
    softmax=("softmax.cu", "softmax.py:44"),
    gemm_softmax_resident=("gemm_softmax_sm90.cuh", "gemm.py:458"),
    gemm_w8=("gemm_w8_sm90.cu", "quant.py:72"), gemm_i8=("gemm_i8_sm90.cu", "quant.py:224"),
    gemm_i8_transpose=("gemm_i8_sm90.cu", "quant.py:224"),
    streaming_decode=("flash_decode_sm90.cuh", "streaming.py:45"))
# the counters whose sum is an entry's launches, where not its own name
LADDER_COUNTERS = dict(gemm_softmax_resident=("gemm_softmax/resident",),
                       gemm_w8=("gemm_w8", "gemm_w8_fp8"),
                       gemm_i8_transpose=("gemm_i8/transpose",),
                       gemm_f32=("gemm/f32x", "gemm_batched/f32x"))


def phase_resident_fallback(device, label):
    """The resident form on inputs scaled by 40 (tests/test_gemm.py:110-127,
    bf16 operands as the card takes them, f32 out): the witness must count
    breaching rows, and the output must be kernel 16's on the same inputs,
    bit for bit (the gated rows launch overwrote it). At 1x1024x256x128 all
    three launches take the wgmma kernel; at 1x200x130x75 (K and N off its
    alignment) none does: the mma.sync resident kernel and rows kernel."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import gemm as g

    gen = torch.Generator(device=device).manual_seed(42)
    fn = g.batched_matmul_softmax_epilogue
    for m, k, n, sm90 in ((1024, 256, 128, 3), (200, 130, 75, 0)):
        a = (40 * torch.randn(1, m, k, generator=gen, device=device)).bfloat16()
        w = (40 * torch.randn(1, k, n, generator=gen, device=device)).bfloat16()
        bias = torch.randn(n, generator=gen, device=device)
        before = fn.sm90_launches
        got = fn(a, w, bias, scale=1.0, out_dtype=torch.float32, resident=True)
        witness = fn.witness
        rows = fn(a, w, bias, scale=1.0, out_dtype=torch.float32)
        took = fn.sm90_launches - before
        torch.cuda.synchronize()
        what = f"resident fallback (1x{m}x{k}x{n}, inputs x 40)"
        log(f"{what}: witness {int(witness)} rows, output bit-equal to kernel 16's: "
            f"{torch.equal(got, rows)}; wgmma launches {took} of 3 [{label}]")
        if not int(witness) > 0 or not torch.equal(got, rows):
            raise AssertionError(f"{what}: the resident form did not fall back to "
                                 f"kernel 16")
        if took != sm90:
            raise AssertionError(f"{what}: the calls made {took} wgmma launches, "
                                 f"{sm90} expected")


def transpose_entry(device, entry, bs, label):
    """Kernel 20's transposing pass (csrc/gemm_i8_sm90.cu) on `bs`, every B
    the ladder's wgmma calls took, held bit-equal to b.t().contiguous(),
    then timed on the first (4096^2) in turns with it (the plain version, also the one
    PyTorch call of the same function), beside its byte bound (K*N read,
    K*N written). Fills `entry`."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import quant as qt

    for b in bs:
        if not torch.equal(qt._transpose_i8_cuda(b), b.t().contiguous()):
            raise AssertionError(f"the transposing pass of {tuple(b.shape)} is not "
                                 f"b.t() bit for bit")
    b = bs[0]
    ms, plain_ms = time_pair(lambda: qt._transpose_i8_cuda(b),
                             lambda: b.t().contiguous(), device)
    bnd = bound(0.0, 2 * b.numel())
    entry.update(ms=ms, plain_ms=plain_ms, library_ms=plain_ms, max_abs_err=0.0,
                 shape=f"int8 {b.shape[0]}x{b.shape[1]} -> its transpose", **bnd)
    log(f"kernel 20's transposing pass: bit-equal to b.t() at "
        f"{[tuple(x.shape) for x in bs]}; {tuple(b.shape)}: {ms:.4f} ms "
        f"({bnd['bound_ms'] / ms:.1%} of its bound {bnd['bound_ms']:.4f} ms, bytes) | "
        f"b.t().contiguous() {plain_ms:.4f} ms [{label}]")


def phase_ladder(device, label):
    """The GEMM and softmax ladder through the ops API, BASELINE configs 1
    and 2 among it, with every launch counter at 0 before it (its launches
    are the main path's); then each output against its plain version, and
    the rungs marked `timed` timed beside their plain versions, bounds and
    library calls (or multi-call baselines), the resident form's fallback
    checked on its own. Returns the kernels' entries."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import gemm as g

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("library: torch.backends.cuda.matmul.allow_tf32 = False and "
        "torch.backends.cudnn.allow_tf32 = False (f32 products in float32)")
    rungs = ladder_rungs(device)
    torch.cuda.synchronize()
    reset_counters()
    outs = []
    softmax = g.batched_matmul_softmax_epilogue
    softmax_sm90 = dict(gemm_softmax=0, gemm_softmax_resident=0)
    for r in rungs:  # each GEMM call on the kernel its shape and type pick
        before = sm90_launches(), f32x_launches(), softmax.sm90_launches, gemm8_launches()
        outs.append(r.call())
        after8 = gemm8_launches()
        for want, got, kind in ((r.sm90, sm90_launches() - before[0], "bf16"),
                                (r.f32x, f32x_launches() - before[1], "f32"),
                                (r.gemm8_sm90, after8[0] - before[3][0], "8-bit"),
                                (r.gemm8_sm90 if r.kernel == "gemm_i8" else None,
                                 after8[1] - before[3][1], "transposing-pass")):
            if want is not None and got != int(want):
                raise AssertionError(f"{r.label}: {got} {kind} wgmma GEMM launches, "
                                     f"{int(want)} expected")
        if r.softmax_sm90 is not None:
            got = softmax.sm90_launches - before[2]
            if got != r.softmax_sm90:
                raise AssertionError(f"{r.label}: {got} softmax-epilogue wgmma "
                                     f"launches, {r.softmax_sm90} expected")
            # the resident form's own launch (its gated rows launch counts
            # as the fallback's)
            softmax_sm90[r.kernel] += got if r.kernel == "gemm_softmax" else got // 2
    phase_baseline_configs(device, label)
    torch.cuda.synchronize()
    launches = read_counters()
    entries = {}
    for name, (source, replaces) in LADDER_KERNELS.items():
        # configs 1 and 2 add a GEMM and a softmax each; config 1's GEMM is
        # on the f32 wgmma kernel
        calls = (sum(r.entry == "gemm_f32" for r in rungs) + 1 if name == "gemm_f32" else
                 sum(r.kernel == "gemm_i8" and bool(r.gemm8_sm90) for r in rungs)
                 if name == "gemm_i8_transpose" else
                 sum(r.kernel == name for r in rungs) + 2 * (name in ("gemm", "softmax")))
        got = sum(launches[c] for c in LADDER_COUNTERS.get(name, (name,)))
        if got != calls:
            raise AssertionError(f"{name}: {got} launches on the ladder's path "
                                 f"of {calls} calls")
        entries[name] = dict(name=name, route="cuda", source=f"{PKG}/csrc/{source}",
                             replaces=f"{TPU}/{replaces}", launches=got,
                             max_abs_err=0.0)
    # kernels 13 and 14: the entries' launches are the bf16 wgmma kernel's
    # (gemm_sm90.cuh), gemm_f32's the f32 one's (gemm_f32_sm90.cuh), the
    # rest went to the mma.sync core (ragged K, the epilogue)
    for name in ("gemm", "gemm_batched"):
        sm90 = launches[f"{name}/sm90"]
        if not sm90 > 0:
            raise AssertionError(f"{name}: no wgmma launch on the ladder's path")
        entries[name].update(launches=sm90, mma_sync_launches=entries[name]["launches"]
                             - sm90 - launches[f"{name}/f32x"])
    # kernel 15: the entry's launches are the wgmma kernels' (the bf16 one's,
    # gemm_sm90.cuh, and the f32 one's, gemm_f32_sm90.cuh), the rest the
    # mma.sync core's (K = 130)
    fused = entries["gemm_fused_epilogue"]
    wgmma = launches["gemm_fused_epilogue/sm90"] + launches["gemm_fused_epilogue/f32x"]
    if not (launches["gemm_fused_epilogue/sm90"] > 0 and launches["gemm_fused_epilogue/f32x"] > 0):
        raise AssertionError("gemm_fused_epilogue: a wgmma kernel took no launch on the "
                             "ladder's path")
    fused.update(launches=wgmma, f32x_launches=launches["gemm_fused_epilogue/f32x"],
                 mma_sync_launches=fused["launches"] - wgmma)
    # kernels 16 and 17: the entries' launches are the wgmma kernel's
    # (gemm_softmax_sm90.cuh), the rest the mma.sync kernels' (gemm_softmax.cu)
    for name, sm90 in softmax_sm90.items():
        if not sm90 > 0:
            raise AssertionError(f"{name}: no wgmma launch on the ladder's path")
        entries[name].update(launches=sm90,
                             mma_sync_launches=entries[name]["launches"] - sm90)
    # kernels 19 and 20: the entries' launches are the wgmma kernels'
    # (gemm_w8_sm90.cu, gemm_i8_sm90.cu), the rest the mma.sync kernels'
    for name, counters in (("gemm_w8", ("gemm_w8/sm90", "gemm_w8_fp8/sm90")),
                           ("gemm_i8", ("gemm_i8/sm90",))):
        sm90 = sum(launches[c] for c in counters)
        if not sm90 > 0:
            raise AssertionError(f"{name}: no wgmma launch on the ladder's path")
        entries[name].update(launches=sm90,
                             mma_sync_launches=entries[name]["launches"] - sm90)
    # the streaming rungs count in streaming_decode's counter alone
    if launches["flash_decode"]:
        raise AssertionError(f"{launches['flash_decode']} flash_decode launches on "
                             f"the ladder's path")
    # every resident launch is followed by the gated rows launch
    if launches["gemm_softmax/fallback"] != launches["gemm_softmax/resident"]:
        raise AssertionError(f"{launches['gemm_softmax/fallback']} gated rows "
                             f"launches for {launches['gemm_softmax/resident']} resident")
    mma_sync = ("gemm", "gemm_batched", "gemm_fused_epilogue", "gemm_softmax",
                "gemm_softmax_resident", "gemm_w8", "gemm_i8")
    log(f"ladder: kernel launches { {k: e['launches'] for k, e in entries.items()} } "
        f"(gemm, gemm_batched, gemm_fused_epilogue, gemm_softmax, "
        f"gemm_softmax_resident: the wgmma kernels'; on the mma.sync kernels "
        f"{ {k: entries[k]['mma_sync_launches'] for k in mma_sync} }), "
        f"gated rows launches {launches['gemm_softmax/fallback']}, of all three "
        f"softmax-epilogue kinds on its wgmma kernel {launches['gemm_softmax/sm90']} "
        f"[{label}]")
    witness = {k: int(v) for k, v in WITNESS.items()}
    log(f"resident witness counts: {witness} [{label}]")
    if any(witness.values()):
        raise AssertionError(f"the resident form's witness fired: {witness}")
    for rung, got in zip(rungs, outs):
        want = rung.plain()
        torch.cuda.synchronize()
        line = _hold_ladder(rung, got, want, entries[rung.entry or rung.kernel])
        log(f"{rung.label}: {line} [{label}]")
        del want
    del outs
    phase_resident_fallback(device, label)
    transpose_entry(device, entries["gemm_i8_transpose"],
                    [r.transposed for r in rungs if r.transposed is not None], label)

    for rung in rungs:
        if rung.timed is None:
            continue
        # calls of milliseconds (config 3, the resident form, the streaming
        # rung and their plain versions) eagerly, few calls
        kw = {} if rung.graph else dict(iters=3, graph=False)
        ms, plain_ms = time_pair(rung.call, rung.plain, device, **kw)
        kw = kw or dict(graph=True)  # time_pair's default
        lib_ms = None if rung.library is None else time_ms(rung.library, device, **kw)
        bnd = bound(rung.flops, rung.nbytes, rung.peak)
        rate = (f"{rung.flops / ms / 1e9:.1f} T(FL)OP/s" if bnd["bound_by"] == "operations"
                else f"{rung.nbytes / ms / 1e6:.1f} GB/s")
        log(f"{rung.label}: kernel {ms:.4f} ms ({rate}, {bnd['bound_ms'] / ms:.1%} "
            f"of its bound {bnd['bound_ms']:.4f} ms, {bnd['bound_by']}) | plain "
            f"{plain_ms:.4f} ms | library "
            f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'} [{label}]")
        times = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, **bnd)
        if rung.unfused is not None:
            times["unfused_ms"] = time_ms(rung.unfused, device, **kw)
            log(f"{rung.label}: the unfused baseline (several library calls) "
                f"{times['unfused_ms']:.4f} ms [{label}]")
        for what, fn in (rung.beside or {}).items():
            times[f"{what}_ms"] = time_ms(fn, device, **kw)
            log(f"{rung.label}: beside it, {what} on the same inputs "
                f"{times[f'{what}_ms']:.4f} ms [{label}]")
        entry = entries[rung.entry or rung.kernel]
        if rung.timed == "entry":
            entry.update(times, shape=rung.label)
        else:
            entry.setdefault("extra", {})[rung.label] = times
    return list(entries.values())

# kernels 8 and 12 (q_int8) and kernel 1's range guard: no engine path
# passes mxu, q_int8 or guard, so their path is run_all.py's 8-bit decode
# rungs with the option on, serving shapes of the 8-bit decodes, and
# `_fwd(guard=True)` at bench.py's shape and the d64 rung
# mxu=True against the cast kernel: JAX's bound (tests/test_flash_decode.py:70,
# 128 keys). The function's own distance grows with the split, one
# requantization group of the weights (4.1e-2 at run_all.py's rung with
# JAX's 2 splits, in both packages), so the kernel is held to the larger of
# this and 1.1 times its plain version's distance on the same inputs
MXU_VS_CAST_TOL = 2e-2
QI8_VS_Q_TOL = 2e-2     # q_int8=True against q_int8=False, the same bound
# kernel 8's partials against its plain version: m and y bit for bit (exact
# integer products, the same f32 steps and expf), l (a sum in the block's
# order) within MXU_L_RTOL relative; the whole call, merged on the card,
# against merge_partials of the plain partials: bit for bit at one split
# (the block divides its own rows, merge_partials' arithmetic), else within
# MXU_MERGE_TOL rel-L2 (the merge's exp and sum order are the card's)
MXU_L_RTOL = 1e-6
MXU_MERGE_TOL = 1e-3
# kernel 8 at its tile and split edges: (b, hq, hkv, s, d, n_splits, lengths,
# (window, sinks) or None): G 1, 2, 4 and 8 at d 64 and 128; splits of 32
# keys, of 96 (the second starts inside a 64-key tile) and one of 4096
# (JAX's split, the most shared memory at G 8); lengths 0, 1 and S
MXU_EDGES = [
    (4, 4, 4, 200, 64, 7, [0, 1, 33, 200], None),
    (4, 8, 4, 200, 128, 7, [0, 1, 64, 200], None),
    (4, 8, 4, 200, 64, 3, [0, 1, 150, 200], (60, 3)),
    (4, 8, 2, 200, 64, 3, [0, 1, 97, 200], (100, 4)),
    (4, 16, 4, 384, 128, 3, [0, 1, 129, 384], (100, 4)),
    (4, 16, 2, 200, 128, 3, [0, 1, 95, 200], None),
    (4, 32, 4, 200, 64, 7, [0, 1, 31, 200], None),
    (2, 8, 8, 4096, 128, 1, [4096, 1], None),
    (2, 16, 2, 4096, 128, 1, [0, 4096], None),
]
# q_int8=True against its plain version: 2.4x the largest distance read on
# the H100 (4.1e-4 at run_all.py's rung), under the ordinary kernel's own
# distance from it (6.8e-3 there, 1.7e-3 at the serving shape), so a kernel
# that took the bf16 score product would fail. Kernel 8 is held to its
# plain version bit for bit: both sum exact integer products and round the
# same f32 steps
QI8_VS_PLAIN_TOL = 1e-3
DEC_I8 = [  # (b, hq, hkv, s, d, lengths "full" or "ragged", (window, sinks) or None)
    (8, 16, 4, 8192, 128, "full", None),    # run_all.py:443-458's decode rung
    (8, 16, 4, 2048, 128, "ragged", None),  # phase_decode_8bit's serving shape
    (8, 16, 4, 2048, 128, "ragged", (256, 4)),
    # B·Hkv 264: the core rule's one split of 8192 keys would not fit a
    # block's shared memory at G 4; the default takes two (ROADMAP C.5)
    (66, 16, 4, 8192, 128, "full", None),
]
PAGED_I8 = [  # (b, hq, hkv, d, page, max_pages, lengths)
    (8, 16, 4, 128, 128, 64, [8192] * 8),  # run_all.py:461-511's paged rung
    (8, 16, 4, 128, 128, 16, [1, 127, 128, 129, 700, 1500, 2048, 0]),
]
GUARD = [(1, 16, 4, 4096, 128), (1, 16, 4, 4096, 64)]  # bench.py's; the d64 rung


def hold_mxu(what, parts, plain_parts, o, lengths, n_splits):
    """Kernel 8 against its plain version: the partials (m and y bit for
    bit, l within MXU_L_RTOL relative), the whole call against
    merge_partials of the plain partials (bit for bit at one split, else
    MXU_MERGE_TOL rel-L2) and its empty rows exactly 0. Returns (the whole
    call's rel-L2, its max-abs)."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import flash_decode as fd

    (m, l, y), (pm, pl, py) = parts, plain_parts
    l_err = float(((l - pl).abs() / pl.abs().clamp_min(1e-30)).max())
    if not (torch.equal(m, pm) and torch.equal(y, py) and l_err <= MXU_L_RTOL):
        raise AssertionError(
            f"{what}: partials m equal {torch.equal(m, pm)}, y equal "
            f"{torch.equal(y, py)} (max-abs {float((y - py).abs().max()):.3e}), "
            f"l rel {l_err:.3e} > {MXU_L_RTOL}")
    b, hq, d = o.shape
    po = fd.merge_partials(pm, pl, py).reshape(b, hq, d).bfloat16()
    err = _rel_l2(o, po)
    max_abs = float((o.float() - po.float()).abs().max())
    if not (torch.equal(o, po) if n_splits == 1 else err <= MXU_MERGE_TOL):
        raise AssertionError(f"{what}: the whole call {err:.3e} rel-L2 from the "
                             f"merged plain partials at {n_splits} splits")
    for row, n in enumerate(lengths.tolist()):
        if n == 0 and float(o[row].float().abs().max()) != 0.0:
            raise AssertionError(f"{what}: row {row} is empty but not 0")
    return err, max_abs


def mxu_edges(device, label, shapes=MXU_EDGES):
    """Kernel 8 at `shapes` (MXU_EDGES), each held by `hold_mxu`."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import flash_decode as fd

    gen = torch.Generator(device=device).manual_seed(103)
    errs = []
    for b, hq, hkv, s, d, n_splits, lens, band in shapes:
        q = torch.randn(b, hq, d, generator=gen, device=device).bfloat16()
        cache = (*quantized(gen, device, (b, hkv, s, d), "int8"),
                 *quantized(gen, device, (b, hkv, s, d), "int8"))
        lengths = torch.tensor(lens, dtype=torch.int32, device=device)
        window, sinks = band or (0, 0)
        block_s = fd.mxu_block_s(s, n_splits)
        args = (q, *cache, lengths, n_splits, block_s, d ** -0.5, window, sinks)
        what = (f"flash_decode_mxu b{b} {hq}/{hkv} s{s} d{d} {n_splits}x{block_s} "
                f"lengths {lens} window {window} sinks {sinks}")
        err, _ = hold_mxu(what, fd._decode_partials_mxu_cuda(*args),
                          fd._decode_partials_mxu_plain(*args),
                          fd._decode_mxu_cuda(*args), lengths, n_splits)
        errs.append(f"G{hq // hkv} d{d} {n_splits}x{block_s}"
                    f"{' window' if window else ''} {err:.1e}")
    log(f"flash_decode_mxu at its edges, partials bit-equal in m and y, l within "
        f"{MXU_L_RTOL}, whole call vs merged plain (rel-L2): " + ", ".join(errs)
        + f" [{label}]")


def phase_int8_products(device, label, dec_shapes=DEC_I8, paged_shapes=PAGED_I8):
    """Kernel 8 (flash_decode_int8(mxu=True)) and kernel 12's int8 score
    product (paged_flash_decode_quant(q_int8=True)) over int8 caches: every
    call first, with the launch counters at 0 before them (each must have
    launched its own kernel once, and the cast kernels never); then each
    output against its plain version (kernel 8 by `hold_mxu`: its partials
    bit for bit in m and y, its whole call against the merged plain
    partials; kernel 12's q_int8 instance rel-L2 QI8_VS_PLAIN_TOL), against
    the kernel without the option on the same cache (kernel 7 or 12, within
    JAX's 2e-2), empty rows exactly 0, one device operation a call and a
    CUDA graph's replay bit-equal to it; kernel 8 at its edges
    (`mxu_edges`); q_int8=True on e4m3 pages and with gather=False must
    launch the ordinary kernel and equal q_int8=False bit for bit. Each
    kernel timed beside its plain version, the kernel without the option
    and the bf16 kernel on the dequantized cache (kernel 8: its whole call,
    its partials alone, kernel 7's whole call). Returns the two JSON entries
    (library_ms null: no PyTorch call attends an int8 cache), timed at the
    first (run_all.py's) shape."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import flash_decode as fd
    from flashattention_kernel_project_tpu_torch.ops import paged_decode as pd
    from flashattention_kernel_project_tpu_torch.utils import platform

    gen = torch.Generator(device=device).manual_seed(101)
    dec = []
    for b, hq, hkv, s, d, lens, band in dec_shapes:
        q = torch.randn(b, hq, d, generator=gen, device=device).bfloat16()
        if lens == "full":
            lengths = torch.full((b,), s, dtype=torch.int32, device=device)
        else:
            lengths = torch.randint(1, s, (b,), generator=gen, device=device,
                                    dtype=torch.int32)
            lengths[0], lengths[-1] = 0, s
        k, ks = quantized(gen, device, (b, hkv, s, d), "int8")
        v, vs = quantized(gen, device, (b, hkv, s, d), "int8")
        window, sinks = band or (None, 0)
        dec.append(dict(q=q, cache=(k, ks, v, vs), lengths=lengths,
                        window=window, sinks=sinks, shape=(b, hq, hkv, s, d)))
    paged = []
    for b, hq, hkv, d, page, max_pages, lens in paged_shapes:
        q = torch.randn(b, hq, d, generator=gen, device=device).bfloat16()
        pools, table = _paged_8bit_case(gen, device, "int8", b, hkv, d, page,
                                        max_pages, lens)
        paged.append(dict(q=q, pools=pools, table=table, lens=lens,
                          lengths=torch.tensor(lens, dtype=torch.int32,
                                               device=device),
                          shape=(b, hq, hkv, d, page, max_pages)))
    torch.cuda.synchronize()
    reset_counters()
    outs_d = [fd.flash_decode_int8(c["q"], *c["cache"], c["lengths"], mxu=True,
                                   window=c["window"], sinks=c["sinks"])
              for c in dec]
    outs_p = [pd.paged_flash_decode_quant(c["q"], *c["pools"], c["table"],
                                          c["lengths"], q_int8=True)
              for c in paged]
    torch.cuda.synchronize()
    launches = read_counters()
    want = {"flash_decode_q/mxu": len(dec), "flash_decode_q": 0,
            "paged_decode_q/q_int8": len(paged), "paged_decode_q": 0}
    got = {name: launches[name] for name in want}
    log(f"int8 x int8 decodes: launches {got} for {len(dec)} mxu and "
        f"{len(paged)} q_int8 calls [{label}]")
    if got != want:
        raise AssertionError(f"int8 x int8 decodes: launches {got}, want {want}")

    mxu = dict(name="flash_decode_mxu", route="cuda",
               source=f"{PKG}/csrc/flash_decode_mxu.cu",
               replaces=f"{TPU}/flash_decode.py:171", max_abs_err=0.0,
               library_ms=None, launches=got["flash_decode_q/mxu"])
    for i, (c, o) in enumerate(zip(dec, outs_d)):
        b, hq, hkv, s, d = c["shape"]
        window, sinks, lengths = c["window"], c["sinks"], c["lengths"]
        n_splits = fd.mxu_n_splits(b, hkv, s, hq // hkv, d)
        block_s = fd.mxu_block_s(s, n_splits)
        args = (c["q"], *c["cache"], lengths, n_splits, block_s, d ** -0.5,
                window or 0, sinks)
        plain_parts = fd._decode_partials_mxu_plain(*args)
        po = fd.merge_partials(*plain_parts).reshape(b, hq, d).bfloat16()
        kernel_8bit_check("flash_decode_mxu", o, po, mxu, "int8")
        err, max_abs = hold_mxu("flash_decode_mxu", fd._decode_partials_mxu_cuda(*args),
                                plain_parts, o, lengths, n_splits)
        o7 = fd.flash_decode_int8(c["q"], *c["cache"], lengths, window=window,
                                  sinks=sinks)
        cast, plain_cast = _rel_l2(o, o7), _rel_l2(po, o7)
        if not cast <= max(MXU_VS_CAST_TOL, 1.1 * plain_cast):
            raise AssertionError(
                f"flash_decode_mxu {cast:.3e} from the cast kernel > "
                f"max({MXU_VS_CAST_TOL}, 1.1 x plain's {plain_cast:.3e})")
        lens = lengths.tolist()

        def whole(args=args):
            return fd._decode_mxu_cuda(*args)

        def plain_whole(args=args, shape=(b, hq, d)):
            parts = fd._decode_partials_mxu_plain(*args)
            return fd.merge_partials(*parts).reshape(shape).bfloat16()

        ops, graph_ops = device_ops(whole), graph_device_ops(whole)
        if len(ops) != 1 or len(graph_ops) != 1:
            raise AssertionError(f"flash_decode_mxu: one call ran {ops} (a "
                                 f"captured call: {graph_ops}); one expected")
        if not graph_bit_equal(whole):
            raise AssertionError("flash_decode_mxu: a CUDA graph's replay differs")
        ms, plain_ms = time_pair(whole, plain_whole, device, iters=50)
        kernel_ms = time_ms(lambda: fd._decode_partials_mxu_cuda(*args), device,
                            iters=50, graph=True)
        # kernel 7 (the cast kernel) at its own splits, against its plain
        # version, one launch a call
        n7 = fd.q_n_splits(b, hkv, s, d)
        args7 = (*args[:6], n7, fd.default_block_s(s, n7), *args[8:])
        err7 = _rel_l2(o7, fd._decode_q_plain(*args7))
        if not err7 <= O_TOL:
            raise AssertionError(f"flash_decode_q at {s} keys: rel-L2 "
                                 f"{err7:.3e} > {O_TOL}")
        cast_ms = time_ms(lambda: fd._decode_q_cuda(*args7), device, iters=50,
                          graph=True)
        kb, vb = (dequantized_bf16(*c["cache"][:2]),
                  dequantized_bf16(*c["cache"][2:]))
        bf16_ms = time_ms(lambda: fd.flash_decode(
            c["q"], kb, vb, lengths, window=window, sinks=sinks), device,
            iters=50, graph=True)
        del kb, vb
        live = _live_keys(lens, window, sinks)
        bnd = bound(4 * live * hq * d, nbytes(c["q"], o) + bytes_8bit(live, hkv, d),
                    platform.H100_INT8_OPS)
        shape = (f"b{b} hq{hq} hkv{hkv} s{s} d{d} n_splits{n_splits} "
                 f"block_s{block_s} window{window} sinks{sinks}")
        log(f"flash_decode_mxu {shape} lengths={lens}: partials bit-equal in m "
            f"and y, whole call rel-L2 {err:.3e} vs the merged plain partials, "
            f"{cast:.3e} vs the cast kernel (plain {plain_cast:.3e}), max-abs "
            f"{max_abs:.3e} | one device operation a call ({ops}; captured: "
            f"{graph_ops}), a CUDA graph's replay bit-equal | whole call "
            f"{ms:.4f} ms ({bytes_8bit(live, hkv, d) / ms / 1e6:.1f} GB/s of live "
            f"K/V and scales, {bnd['bound_ms'] / ms:.1%} of its bound "
            f"{bnd['bound_ms']:.4f} ms, {bnd['bound_by']}), kernel (partials) "
            f"{kernel_ms:.4f} ms vs plain partials and merge {plain_ms:.4f} ms | "
            f"the cast kernel (7), whole call, {cast_ms:.4f} ms (rel-L2 "
            f"{err7:.3e} vs its plain version) | the bf16 decode (6), whole "
            f"call, on the dequantized cache {bf16_ms:.4f} ms [{label}]")
        times = dict(ms=ms, kernel_ms=kernel_ms, plain_ms=plain_ms,
                     cast_ms=cast_ms, bf16_ms=bf16_ms, **bnd)
        if i == 0:
            mxu.update(times, shape=shape)
        else:
            mxu.setdefault("extra", {})[shape] = times

    mxu_edges(device, label)

    qi8 = dict(name="paged_decode_qi8", route="cuda",
               source=f"{PKG}/csrc/paged_decode_qi8.cu",
               replaces=f"{TPU}/paged_decode.py:824", max_abs_err=0.0,
               library_ms=None, launches=got["paged_decode_q/q_int8"])
    for i, (c, o) in enumerate(zip(paged, outs_p)):
        b, hq, hkv, d, page, max_pages = c["shape"]
        n_splits, block_s = pd.decode_plan(b, hkv, page, max_pages, d)
        args = (c["q"], *c["pools"], c["table"], c["lengths"], block_s, d ** -0.5)
        po = fd.merge_partials(*pd._paged_partials_qi8_plain(*args))
        err, max_abs = kernel_8bit_check("paged_decode_qi8", o,
                                         po.reshape(b, hq, d).bfloat16(), qi8,
                                         "int8")
        if not err <= QI8_VS_PLAIN_TOL:
            raise AssertionError(f"paged_decode_qi8 rel-L2 {err:.3e} from plain "
                                 f"> {QI8_VS_PLAIN_TOL}")
        o12 = pd.paged_flash_decode_quant(c["q"], *c["pools"], c["table"],
                                          c["lengths"])
        off = _rel_l2(o, o12)
        if not off <= QI8_VS_Q_TOL:
            raise AssertionError(f"paged_decode_qi8 {off:.3e} from q_int8=False "
                                 f"> {QI8_VS_Q_TOL}")
        for row, n in enumerate(c["lens"]):
            if n == 0 and float(o[row].float().abs().max()) != 0.0:
                raise AssertionError(f"paged_decode_qi8 row {row} is empty but not 0")
        whole = pdec_whole(c["q"], c["pools"], c["table"], c["lengths"],
                           q_int8=True)
        ops, graph_ops = device_ops(whole), graph_device_ops(whole)
        if len(ops) != 1 or len(graph_ops) != 1:
            raise AssertionError(f"paged_decode_qi8: one call ran {ops} (a "
                                 f"captured call: {graph_ops}); one expected")
        if not graph_bit_equal(whole):
            raise AssertionError("paged_decode_qi8: a CUDA graph's replay differs")
        ms, plain_ms = time_pair(whole,
                                 lambda: pd._paged_partials_qi8_plain(*args),
                                 device, iters=50)
        kernel_ms = time_ms(lambda: pd._paged_partials_qi8_cuda(*args), device,
                            iters=50, graph=True)
        q_ms = time_ms(pdec_whole(c["q"], c["pools"], c["table"], c["lengths"]),
                       device, iters=50, graph=True)
        kb, vb = dequantized_bf16(*c["pools"][:2]), dequantized_bf16(*c["pools"][2:])
        bf16_ms = time_ms(pdec_whole(c["q"], (kb, vb), c["table"], c["lengths"]),
                          device, iters=50, graph=True)
        del kb, vb
        live = sum(c["lens"])
        bnd = bound(4 * live * hq * d, nbytes(c["q"], o, c["table"], c["lengths"])
                    + bytes_8bit(live, hkv, d))
        shape = (f"b{b} hq{hq} hkv{hkv} d{d} page{page} max_pages{max_pages} "
                 f"({n_splits} splits of {block_s})")
        log(f"paged_decode_qi8 {shape} lengths={c['lens']}: rel-L2 {err:.3e} "
            f"vs plain, {off:.3e} vs q_int8=False, max-abs {max_abs:.3e} | one "
            f"device operation a call ({ops}; captured: {graph_ops}), a CUDA "
            f"graph's replay bit-equal | whole call {ms:.4f} ms "
            f"({bytes_8bit(live, hkv, d) / ms / 1e6:.1f} GB/s of live K/V and "
            f"scales, {bnd['bound_ms'] / ms:.1%} of its bound "
            f"{bnd['bound_ms']:.4f} ms, {bnd['bound_by']}), kernel (partials) "
            f"{kernel_ms:.4f} ms vs plain partials {plain_ms:.4f} ms | "
            f"q_int8=False (kernel 12) {q_ms:.4f} ms | the bf16 kernel on the "
            f"dequantized pool {bf16_ms:.4f} ms [{label}]")
        times = dict(ms=ms, kernel_ms=kernel_ms, plain_ms=plain_ms, q_ms=q_ms,
                     bf16_ms=bf16_ms, **bnd)
        if i == 0:
            qi8.update(times, shape=shape)
        else:
            qi8.setdefault("extra", {})[shape] = times

    # JAX's rule: q_int8 applies only with gather=True over an int8 pool
    c = paged[-1]
    b, hq, hkv, d, page, max_pages = c["shape"]
    fp8, table8 = _paged_8bit_case(gen, device, "fp8", b, hkv, d, page,
                                   max_pages, c["lens"])
    cases = [(fp8, table8, {}), (c["pools"], c["table"], dict(gather=False))]
    before = read_counters()
    pairs = [[pd.paged_flash_decode_quant(c["q"], *pools, table, c["lengths"],
                                          q_int8=flag, **kw) for flag in (True, False)]
             for pools, table, kw in cases]
    torch.cuda.synchronize()
    after = read_counters()
    ran = {name: after[name] - before[name] for name in ("paged_decode_q",
                                                         "paged_decode_q/q_int8")}
    same = [torch.equal(x, y) for x, y in pairs]
    log(f"paged_decode_quant(q_int8=True) on e4m3 pages and with gather=False: "
        f"launches {ran}, equal to q_int8=False bit for bit {same} [{label}]")
    if ran != {"paged_decode_q": 4, "paged_decode_q/q_int8": 0} or not all(same):
        raise AssertionError("q_int8=True did not fall back to the ordinary "
                             "8-bit kernel on e4m3 pages or with gather=False")
    return mxu, qi8


def phase_guard(device, label, shapes=GUARD):
    """Kernel 1's fixed-max range guard, `_fwd(guard=True)`, at bench.py's
    shape (causal) and the d64 rung (pack=True: a row counts once for a KV
    pair's two heads), and over an int8 cache at bench.py's shape
    (`_fwd_q_cuda(guard=True)`): every call first, with the launch counters
    at 0 before them; then on those bounded inputs the count must be 0 and
    O and LSE bit-equal to the unguarded fixed-max kernel's (and O, LSE
    within O_TOL, LSE_TOL of plain); on the JAX test's crafted row (one q
    row of 90 against |k|, tests/test_flash_attention.py:227-234) exactly
    1; on q x 60 the plain version's count. Timed beside the unguarded
    kernel, in turns. Returns its JSON entry (library_ms null: no PyTorch
    call computes the count), timed at the first shape."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(103)
    entry = _disc_entry("flash_fwd (guard)", "flash_fwd_sm90.cuh", "flash_attention.py:92")
    cases = [(shape, *_qkv(gen, device, *shape[:3], shape[3], shape[3], shape[4]))
             for shape in shapes]
    b, hq, hkv, n, d = shapes[0]
    kq, ks = quantized(gen, device, (b, hkv, n, d), "int8")
    vq, vs = quantized(gen, device, (b, hkv, n, d), "int8")
    q8 = cases[0][1]

    def guarded(q, k, v, d, **kw):
        return fa._fwd(q, k, v, True, None, 0, disc=fa.FIXED, pack=d == 64,
                       guard=True, **kw)

    torch.cuda.synchronize()
    reset_counters()
    def guarded8(q, kq, ks, vq, vs, d):
        return fa._fwd_q_cuda(q, kq, ks, vq, vs, True, d ** -0.5, 0,
                              disc=fa.FIXED, guard=True)

    outs = [guarded(q, k, v, shape[4]) for shape, q, k, v in cases]
    out8 = guarded8(q8, kq, ks, vq, vs, d)
    torch.cuda.synchronize()
    launches = read_counters()
    got = {name: launches[name] for name in ("flash_fwd/guard", "flash_fwd_q/guard")}
    log(f"range guard: launches {got} for {len(cases)} bf16 and one int8 "
        f"calls [{label}]")
    if got != {"flash_fwd/guard": len(cases), "flash_fwd_q/guard": 1}:
        raise AssertionError(f"range guard: launches {got}")
    entry["launches"] = sum(got.values())

    for i, ((shape, q, k, v), (o, lse, bad)) in enumerate(zip(cases, outs)):
        b, hq, hkv, n, d = shape
        args = (q, k, v, True, d ** -0.5, 0, 0, 0, fa.FIXED)
        uo, ulse = fa._fwd(*args, pack=d == 64)
        po, plse, pbad = fa._fwd_plain(*args, None, True, d == 64)
        err = _hold("flash_fwd (guard)", entry, o, po, lse, plse)
        del po, plse
        checks = [f"bounded: count {int(bad)} (plain {int(pbad)}), O and LSE "
                  f"bit-equal to the unguarded kernel "
                  f"{torch.equal(o, uo) and torch.equal(lse, ulse)}, O rel-L2 "
                  f"{err:.3e} vs plain"]
        if int(bad) != 0 or int(pbad) != 0 or not (torch.equal(o, uo)
                                                   and torch.equal(lse, ulse)):
            raise AssertionError("range guard on bounded inputs: " + checks[0])
        qc, kc = q.clone(), k.abs()
        qc[0, 0, 5, :] = 90.0  # one row far outside the fixed-max range
        crafted = int(guarded(qc, kc, v, d)[2])
        qx = (q.float() * 60.0).bfloat16()
        x60 = int(guarded(qx, k, v, d)[2])
        px60 = int(fa._fwd_plain(qx, *args[1:], None, True, d == 64)[2])
        checks.append(f"crafted row: count {crafted}; q x 60: count {x60}, "
                      f"plain {px60} of {b * hq * n} rows")
        if crafted != 1 or x60 != px60:
            raise AssertionError("range guard: " + checks[-1])
        g1 = time_ms(lambda: guarded(q, k, v, d), device, graph=True)
        u1 = time_ms(lambda: fa._fwd(*args, pack=d == 64), device, graph=True)
        u2 = time_ms(lambda: fa._fwd(*args, pack=d == 64), device, graph=True)
        g2 = time_ms(lambda: guarded(q, k, v, d), device, graph=True)
        ms, unguarded_ms = min(g1, g2), min(u1, u2)
        plain_ms = time_ms(lambda: fa._fwd_plain(*args, None, True, d == 64),
                           device, graph=True)
        pairs = b * hq * visible_pairs(n, n, 0, True)
        bnd = bound(4 * d * pairs, nbytes(q, k, v, o, lse, bad))
        shape_s = f"b{b} hq{hq} hkv{hkv} n{n} s{n} d{d} causal"
        log(f"flash_fwd (guard) {shape_s}: " + "; ".join(checks) + f" | kernel "
            f"{ms:.4f} ms ({4 * d * pairs / ms / 1e9:.1f} TFLOP/s) vs the "
            f"unguarded fixed-max kernel {unguarded_ms:.4f} ms "
            f"({ms / unguarded_ms - 1:+.2%}), plain {plain_ms:.4f} ms | bound "
            f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}) [{label}]")
        times = dict(ms=ms, plain_ms=plain_ms, unguarded_ms=unguarded_ms, **bnd)
        if i == 0:
            entry.update(times, shape=shape_s)
        else:
            entry.setdefault("extra", {})[shape_s] = times

    # the 8-bit dense forward's guard (JAX's _fwd takes it with k_scale)
    b, hq, hkv, n, d = shapes[0]
    o, lse, bad = out8
    args8 = (q8, kq, ks, vq, vs, True, d ** -0.5, 0, 0, 0, fa.FIXED)
    uo, ulse = fa._fwd_q_cuda(*args8)
    kqc, ksc = quantized(gen, device, (b, hkv, n, d), "int8")
    qc = q8.clone()
    qc[0, 0, 5, :] = 90.0
    crafted = int(guarded8(qc, kqc.abs(), ksc, vq, vs, d)[2])
    log(f"flash_fwd_q (guard) int8 b{b} hq{hq} hkv{hkv} n{n} d{d} causal: "
        f"bounded count {int(bad)}, O and LSE bit-equal to the unguarded "
        f"8-bit kernel {torch.equal(o, uo) and torch.equal(lse, ulse)}; "
        f"crafted row count {crafted} [{label}]")
    if int(bad) != 0 or crafted != 1 or not (torch.equal(o, uo)
                                             and torch.equal(lse, ulse)):
        raise AssertionError("the 8-bit forward's range guard failed")
    return entry


# the stage probes (kernels 22-23) and the paged gather's probe options:
# their path is benchmarks/profile_attention.py's stage breakdown, the probe
# rungs of run_all.py and ab_paged_int8.py's slots and copy_only runs
PROFILE = (1, 16, 4, 4096, 128)  # profile_attention.py:42's B, H, HKV, N, D
PROBE_BLOCKS = dict(block_q=512, block_k=512)  # its default blocks
SUM_ORDER_TOL = 1e-5  # qk, pv, packed: rel-L2, sums taken in another order
EXACT_RTOL = 1e-6     # copy, chain: the plain version's sums in its order
MUFU_PER_SM_CLK = 16  # exp2 results a clock an SM (compute capability 9.0)
AB_PAGED = dict(b=8, hq=16, hkv=4, d=128, page=128, s=8192)  # ab_paged_int8.py:45-57


def max_sm_clock_hz() -> float:
    """The card's highest SM clock, as nvidia-smi reports it."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True, timeout=60)
    return float(out.stdout.split()[0]) * 1e6


def sass_counts(obj: str, kernel: str, opcodes) -> dict:
    """How often each SASS opcode occurs in the instance `kernel` (a mangled
    name's fragment) of an object file, from cuobjdump beside nvcc; raises
    where the toolkit has no cuobjdump, since the count is a gate."""
    for section in sass_of(obj).split("Function : ")[1:]:
        if kernel in section.split("\n", 1)[0]:
            return {op: section.count(op) for op in opcodes}
    raise AssertionError(f"no instance {kernel} in {obj}")


def _probe_entry(name, replaces, launches, source="probes.cu", **times):
    return dict(name=name, route="cuda", source=f"{PKG}/csrc/{source}",
                replaces=f"{TPU}/probes.py:{replaces}", launches=launches,
                library_ms=None, **times)


# The stage probes copy, qk, pv, the softmax chain, qk_kt and qk_packed on
# the Hopper forward's block (csrc/probes_sm90.cu): (d, stage, block rows)
PROBE_SM90_OBJECT = "probes_sm90.cu"
PROBE_SM90_KERNEL = "probe_sm90_kernel"
PROBE_STAGES = {0: "copy", 1: "qk", 2: "pv", 3: "chain", 4: "qk_kt", 5: "qk_packed"}
PROBE_NO_PRODUCTS = (0, 3)  # the copy and the chain issue no wgmma
# the chain's exp2 of every score in the SASS: a thread's share of a
# 128-key tile's scores (2 rows x 32 keys), in probe_sm90_kernel<128, 3, 128>
CHAIN_EXP2_MIN = 64
# qk_kt and qk_packed at the tails of the Hopper block (N 192 and S 320 end
# inside a 128-row block and a 128-key tile; blocks of 64): (hq, hkv)
PROBE_TAIL_HEADS = ((16, 4), (8, 4))
PROBE_TAIL = dict(n=192, s=320, block_q=64, block_k=64)


def phase_probes_build(build_log: str, label):
    """The probes' 24 instances on the forward's block (d 64 and 128; copy,
    qk, pv, chain, qk_kt, qk_packed; 64- and 128-row blocks) through
    `wgmma_gate`, in probes_sm90.cu's object: no spill, no serialized
    wgmma, UTMALDG (the forward's TMA ring) in each, HGMMA in each but the
    copy's and the chain's, no HMMA.16816 in any; with their registers from
    ptxas."""
    instance = template_args(PROBE_SM90_KERNEL, 3)
    want = {(d, st, rows) for d in (64, 128) for st in PROBE_STAGES for rows in (64, 128)}
    counts = wgmma_gate(build_log, PROBE_SM90_KERNEL, instance,
                        {PROBE_SM90_OBJECT: lambda inst: True}, want,
                        need=("UTMALDG",))
    for (d, st, rows), c in counts.items():
        if bool(c["HGMMA"]) != (st not in PROBE_NO_PRODUCTS):
            raise AssertionError(f"probe {PROBE_STAGES[st]} (d {d}, {rows} rows): "
                                 f"{c['HGMMA']} HGMMA")
    regs = ptxas_registers(build_log, instance)
    log(f"stage probes on the forward's block: {len(counts)} instances (d, stage 0 "
        "copy / 1 qk / 2 pv / 3 chain / 4 qk_kt / 5 qk_packed, rows) built with no "
        "spill and no "
        "serialized wgmma; SASS (HGMMA, "
        "UTMALDG, HMMA.16816), registers at launch: "
        + ", ".join(f"{inst}: {c['HGMMA']}/{c['UTMALDG']}/{c['HMMA.16816']}, "
                    f"{regs.get(inst)}" for inst, c in sorted(counts.items()))
        + f" [{label}]")


def phase_probes(device, label):
    """The stage probes through the ops API, its own path with every launch
    counter at 0 before it: benchmarks/profile_attention.py's breakdown at
    its shape (1 x 16/4 heads x 4096 x 128 bf16, non-causal, block_q =
    block_k = 512, numpy seed 0): copy, qk, pv and the softmax chain, qk_kt
    beside qk, and kernel 1 at the same shape, stable and stable=False; then
    run_all.py's probe rungs: qk and pv at d64, qk_packed at d64 and the
    stream copy at 8192 x 4096 f32 (and bf16). copy, qk, pv, the chain,
    qk_kt and qk_packed run on the Hopper forward's block
    (csrc/probes_sm90.cu; `phase_probes_build` gates their SASS), the
    stream copy on csrc/probes.cu. Each launch counted, each output held
    against its plain version (copy and chain within 1e-6, the products'
    rel-L2 within 1e-5, the stream copy bit for bit), each probe timed
    beside it (CUDA graphs, in turns) and its bound; after the counted path, qk_kt at d 64
    and qk_packed at d 32 at the same shape, and both at d 64 and 128 (32
    and 64) at `PROBE_TAIL` with `PROBE_TAIL_HEADS`, held to plain; each
    one's kernel alone (through the entry, on K^T or the packed operands
    built before) and whole call timed in turns beside qk at the same
    flops; the chain's exp2 count checked in the SASS. Prints the sum of
    the stages against the fused kernel. Returns the JSON entries."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import flash_attention as fa
    from flashattention_kernel_project_tpu_torch.ops import probes as pr
    from flashattention_kernel_project_tpu_torch.ops import _build
    from flashattention_kernel_project_tpu_torch.utils import platform

    B, H, HKV, N, D = PROFILE
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .to(device).bfloat16()
               for shape in ((B, H, N, D), (B, HKV, N, D), (B, HKV, N, D)))
    gen = torch.Generator(device=device).manual_seed(42)
    q64, k64, v64 = (torch.randn(*shape, generator=gen, device=device).bfloat16()
                     for shape in ((B, H, N, 64), (B, HKV, N, 64), (B, HKV, N, 64)))
    x = torch.randn(8192, 4096, generator=gen, device=device)
    stages = dict(copy=pr.copy_probe, qk=pr.qk_probe, pv=pr.pv_probe,
                  chain=pr.softmax_chain_probe)
    torch.cuda.synchronize()
    reset_counters()
    out = {name: fn(q, k, v, **PROBE_BLOCKS) for name, fn in stages.items()}
    out["qk_kt"] = pr.qk_kt_probe(q, k, v, **PROBE_BLOCKS)
    fa.flash_attention(q, k, v, causal=False)
    fa.flash_attention(q, k, v, causal=False, stable=False)
    out["qk64"] = pr.qk_probe(q64, k64, v64)
    out["pv64"] = pr.pv_probe(q64, k64, v64)
    out["packed64"] = pr.qk_packed_probe(q64, k64)
    out["stream"] = pr.stream_copy_probe(x)
    torch.cuda.synchronize()
    launches = read_counters()
    want = dict(probe_copy=1, probe_qk=2, probe_pv=2, probe_chain=1,
                probe_qk_kt=1, probe_qk_packed=1, probe_stream_copy=1,
                flash_fwd=1, **{"flash_fwd/fixed": 1})
    got = {name: launches[name] for name in want}
    log(f"probes: launches {got} on the profiling path [{label}]")
    if got != want:
        raise AssertionError(f"probes: launches {got}, want {want}")

    # each output against its plain version
    block_k = PROBE_BLOCKS["block_k"]
    plain = dict(copy=lambda: pr._copy_plain(q, k, v, block_k),
                 qk=lambda: pr._qk_plain(q, k), pv=lambda: pr._pv_plain(q, v),
                 chain=lambda: pr._chain_plain(q, N, block_k),
                 qk_kt=lambda: pr._qk_plain(q, k),
                 qk64=lambda: pr._qk_plain(q64, k64),
                 pv64=lambda: pr._pv_plain(q64, v64),
                 packed64=lambda: pr._packed_plain(q64, k64),
                 stream=lambda: x + 1)
    errs = {}
    for name, fn in plain.items():
        want_o = fn()
        got_o = out[name]
        if got_o.shape != want_o.shape or not torch.isfinite(got_o).all():
            raise AssertionError(f"probe {name}: shape {tuple(got_o.shape)}, "
                                 f"want {tuple(want_o.shape)}, or not finite")
        max_abs = float((got_o.float() - want_o.float()).abs().max())
        if name == "stream":
            ok, err = torch.equal(got_o, want_o), max_abs
        elif name in ("copy", "chain"):
            err = float(((got_o - want_o).abs() / want_o.abs().clamp_min(1e-30)).max())
            ok = err <= EXACT_RTOL
        else:
            err = _rel_l2(got_o, want_o)
            ok = err <= SUM_ORDER_TOL
        errs[name] = (err, max_abs)
        log(f"probe {name}: {'rel err' if name in ('copy', 'chain') else 'rel-L2'} "
            f"{err:.3e} vs plain, max-abs {max_abs:.3e}")
        if not ok:
            raise AssertionError(f"probe {name} disagrees with its plain version: {err:.3e}")
    xb = x.bfloat16()
    if not torch.equal(pr.stream_copy_probe(xb), xb + 1):
        raise AssertionError("stream_copy_probe on bf16 is not x + 1 bit for bit")
    # the element tail (n not a multiple of the 16-byte vector) and a block's
    # chunk edge, in f32 and bf16, bit for bit
    tails = []
    for dtype in (torch.float32, torch.bfloat16):
        for n in (1, 7, 8 * 4096 + 3):
            xt = x.reshape(-1)[:n].to(dtype).contiguous()
            if not torch.equal(pr.stream_copy_probe(xt), xt + 1):
                raise AssertionError(f"stream_copy_probe at n {n} {dtype} is not "
                                     "x + 1 bit for bit")
            tails.append(f"{n} {str(dtype)[6:]}")
    log(f"probe stream copy: bit-equal to x + 1 at n = {tails} [{label}]")

    # qk_kt and qk_packed at their other widths and at the Hopper block's
    # tails, held to plain (after the counted path)
    tail_errs = {}
    q32, k32 = (t[..., :32].contiguous() for t in (q64, k64))
    checks = {"qk_kt d64": (lambda: pr.qk_kt_probe(q64, k64, v64, **PROBE_BLOCKS),
                            lambda: pr._qk_plain(q64, k64)),
              "qk_packed d32": (lambda: pr.qk_packed_probe(q32, k32),
                                lambda: pr._packed_plain(q32, k32))}
    for hq, hkv in PROBE_TAIL_HEADS:
        for d in (64, 128):
            qt, kt_, vt = (torch.randn(*shape, generator=gen, device=device).bfloat16()
                           for shape in ((1, hq, PROBE_TAIL["n"], d),
                                         (1, hkv, PROBE_TAIL["s"], d),
                                         (1, hkv, PROBE_TAIL["s"], d)))
            blocks = dict(block_q=PROBE_TAIL["block_q"], block_k=PROBE_TAIL["block_k"])
            checks[f"qk_kt {hq}/{hkv} d{d} tail"] = (
                lambda qt=qt, kt_=kt_, vt=vt, blocks=blocks: pr.qk_kt_probe(qt, kt_, vt, **blocks),
                lambda qt=qt, kt_=kt_: pr._qk_plain(qt, kt_))
            qh, kh = (t[..., :d // 2].contiguous() for t in (qt, kt_))
            checks[f"qk_packed {hq}/{hkv} d{d // 2} tail"] = (
                lambda qh=qh, kh=kh, blocks=blocks: pr.qk_packed_probe(qh, kh, **blocks),
                lambda qh=qh, kh=kh: pr._packed_plain(qh, kh))
    for name, (kernel, plain_fn) in checks.items():
        got_o, want_o = kernel(), plain_fn()
        err = _rel_l2(got_o, want_o)
        tail_errs[name] = err
        if (got_o.shape != want_o.shape or not torch.isfinite(got_o).all()
                or not err <= SUM_ORDER_TOL):
            raise AssertionError(f"probe {name}: shape {tuple(got_o.shape)}, rel-L2 "
                                 f"{err:.3e} vs plain (want {tuple(want_o.shape)}, "
                                 f"{SUM_ORDER_TOL})")
    log(f"probes qk_kt and qk_packed held to plain (rel-L2): "
        + ", ".join(f"{name} {err:.2e}" for name, err in tail_errs.items())
        + f" [{label}]")

    # the chain's exp2 of every score stays in the binary (a hoisted exp2
    # would leave a handful)
    obj = os.path.join(_build.BUILD_DIR, PROBE_SM90_OBJECT + ".o")
    sass = sass_counts(obj, f"{PROBE_SM90_KERNEL}ILi128ELi3ELi128EE", ("MUFU.EX2",))
    log(f"probe chain SASS at d128, 128-row blocks: {sass} (gate {CHAIN_EXP2_MIN})")
    if sass["MUFU.EX2"] < CHAIN_EXP2_MIN:
        raise AssertionError(f"the chain's exp2 left its key loop: {sass}")

    # times, each beside its plain version, in turns, from CUDA graphs
    calls = dict(
        copy=lambda: pr.copy_probe(q, k, v, **PROBE_BLOCKS),
        qk=lambda: pr.qk_probe(q, k, v, **PROBE_BLOCKS),
        pv=lambda: pr.pv_probe(q, k, v, **PROBE_BLOCKS),
        chain=lambda: pr.softmax_chain_probe(q, k, v, **PROBE_BLOCKS),
        qk_kt=lambda: pr.qk_kt_probe(q, k, v, **PROBE_BLOCKS),
        qk64=lambda: pr.qk_probe(q64, k64, v64),
        pv64=lambda: pr.pv_probe(q64, k64, v64),
        packed64=lambda: pr.qk_packed_probe(q64, k64),
        stream=lambda: pr.stream_copy_probe(x))
    ms = {name: time_pair(calls[name], plain[name], device) for name in calls}
    fused = dict(stable=lambda: fa.flash_attention(q, k, v, causal=False),
                 fixed=lambda: fa.flash_attention(q, k, v, causal=False, stable=False))
    fused_ms = {name: [] for name in fused}
    for order in (list(fused), list(fused)[::-1]):
        for name in order:
            fused_ms[name].append(time_ms(fused[name], device, graph=True))
    fused_ms = {name: min(t) for name, t in fused_ms.items()}
    # qk_kt and qk_packed: the kernel alone (through the entry, on K^T or the
    # packed operands built before) and the whole call (the torch transpose
    # or packing included), in turns beside qk at the same flops (qk_packed
    # at d / 2: its packed products are qk's at d)
    def alone(probe, stage, qq, kk, ops):
        hq_, _, n_, _, d_ = pr.probe_sizes(stage, qq, kk)
        o_ = torch.empty(qq.shape[0], hq_, n_, d_, dtype=torch.float32, device=device)
        return lambda: pr._launch(probe, stage, qq, kk, ops, block_k, o_)

    kt128, kt64 = (t.transpose(-1, -2).contiguous() for t in (k, k64))
    pk64, pk32 = pr._pack(q64, k64, block_k), pr._pack(q32, k32, block_k)
    qk_turns = time_turns({
        "qk d128": calls["qk"],
        "qk_kt d128 kernel": alone(pr.qk_kt_probe, pr._QKT, q, k, (q, kt128, None)),
        "qk_kt d128 whole": calls["qk_kt"],
        "qk_packed d64 kernel": alone(pr.qk_packed_probe, pr._PACKED, q64, k64,
                                      (*pk64, None)),
        "qk_packed d64 whole": calls["packed64"],
        "qk d64": calls["qk64"],
        "qk_kt d64 kernel": alone(pr.qk_kt_probe, pr._QKT, q64, k64, (q64, kt64, None)),
        "qk_kt d64 whole": checks["qk_kt d64"][0],
        "qk_packed d32 kernel": alone(pr.qk_packed_probe, pr._PACKED, q32, k32,
                                      (*pk32, None)),
        "qk_packed d32 whole": checks["qk_packed d32"][0]}, device)
    # the stream copy over bf16 beside x + 1, in turns (f32: time_pair's)
    stream_bf16 = time_turns({"kernel": lambda: pr.stream_copy_probe(xb),
                              "x + 1": lambda: xb + 1}, device)
    # the chain's output is l / (l + 1e-6) whatever work it does, so its
    # time must grow with the keys: half of them must take well under the
    # whole's time
    k_half, v_half = (t[:, :, :N // 2].contiguous() for t in (k, v))
    half_ms = time_ms(lambda: pr.softmax_chain_probe(q, k_half, v_half,
                                                     **PROBE_BLOCKS),
                      device, graph=True)
    log(f"probe chain: {N // 2} keys {half_ms:.4f} ms vs {N} keys "
        f"{ms['chain'][0]:.4f} ms, x{ms['chain'][0] / half_ms:.2f} (gate 1.5)")
    if not ms["chain"][0] >= 1.5 * half_ms:
        raise AssertionError(f"the chain's time does not grow with its keys: "
                             f"{half_ms:.4f} ms at {N // 2}, {ms['chain'][0]:.4f} "
                             f"ms at {N}")

    # bounds, over the bytes each function reads: copy K and V; qk q and K;
    # pv q's first column and V; the chain q's first column
    flops = 2 * B * H * N * N * D
    flops64 = 2 * B * H * N * N * 64
    q_col = B * H * N * q.element_size()
    # every score, and each block_k tile's rescale of a row (JAX's chain)
    exp2 = B * H * N * (N + N // PROBE_BLOCKS["block_k"])
    clock = max_sm_clock_hz()
    t_exp = exp2 / (MUFU_PER_SM_CLK * platform.H100_SMS * clock) * 1e3
    chain_bytes = bound(0, q_col + nbytes(out["chain"]))
    chain_bnd = dict(bound_ms=max(t_exp, chain_bytes["bound_ms"]),
                     bound_by="operations" if t_exp >= chain_bytes["bound_ms"] else "bytes")
    bnd = dict(copy=bound(0, nbytes(k, v, out["copy"])),
               qk=bound(flops, nbytes(q, k, out["qk"])),
               pv=bound(flops, q_col + nbytes(v, out["pv"])),
               chain=chain_bnd,
               qk_kt=bound(flops, nbytes(q, k, out["qk_kt"])),
               qk64=bound(flops64, nbytes(q64, k64, out["qk64"])),
               pv64=bound(flops64, q_col + nbytes(v64, out["pv64"])),
               packed64=bound(flops64, nbytes(q64, k64, out["packed64"])),
               stream=bound(0, 2 * nbytes(x)))
    shape = f"{B}x{H}/{HKV}x{N}x{D} bf16, block_q 512, block_k 512"
    shape64 = f"{B}x{H}/{HKV}x{N}x64 bf16"
    # K and V once a query block of the forward's (copy, qk, pv: its rows)
    rows = dense_rows(N, H, B, torch.cuda.get_device_properties(0).multi_processor_count)
    tiles_bytes = (N // rows) * B * H * N * D * 2 * 2
    for name in calls:
        k_ms, p_ms = ms[name]
        extra = ""
        if name == "copy":
            extra = (f" | the tiles' traffic {tiles_bytes / k_ms / 1e6:.1f} GB/s "
                     f"(K and V once a {rows}-row query block, mostly from L2); K "
                     f"and V once from HBM {nbytes(k, v) / 3.35e12 * 1e3:.4f} ms")
        if name == "chain":
            extra = (f" | {exp2} exp2 at {MUFU_PER_SM_CLK}/clock/SM x "
                     f"{platform.H100_SMS} SMs x {clock / 1e6:.0f} MHz: {t_exp:.4f} ms")
        if name == "stream":
            bb = bound(0, 2 * nbytes(xb))["bound_ms"]
            extra = (f" | x + 1 in torch {p_ms:.4f} ms (in turns); bf16 kernel "
                     f"{stream_bf16['kernel']:.4f} ms vs x + 1 "
                     f"{stream_bf16['x + 1']:.4f} ms, bound {bb:.4f} ms "
                     f"({bb / stream_bf16['kernel']:.1%} of it)")
        b_ = bnd[name]
        where = dict(stream="8192x4096 f32").get(
            name, shape64 if name.endswith("64") else shape)
        log(f"probe {name} ({where}): "
            f"kernel {k_ms:.4f} ms vs plain {p_ms:.4f} ms | bound "
            f"{b_['bound_ms']:.4f} ms ({b_['bound_by']}), "
            f"{b_['bound_ms'] / k_ms:.1%} of it{extra} [{label}]")
    serial = sum(ms[name][0] for name in stages)
    log(f"stage breakdown ({shape}, profile_attention.py:50-89): copy "
        f"{ms['copy'][0]:.4f} ms, qk {ms['qk'][0]:.4f}, pv {ms['pv'][0]:.4f}, "
        f"softmax chain {ms['chain'][0]:.4f}; qk_kt {ms['qk_kt'][0]:.4f}; fused "
        f"full (non-causal) {fused_ms['stable']:.4f} ms "
        f"({4 * B * H * N * N * D / fused_ms['stable'] / 1e9:.1f} TFLOP/s), "
        f"stable=False {fused_ms['fixed']:.4f} ms "
        f"({4 * B * H * N * N * D / fused_ms['fixed'] / 1e9:.1f} TFLOP/s) | "
        f"sum of stages {serial:.4f} ms vs fused {fused_ms['stable']:.4f} ms -> "
        f"overlap factor {serial / fused_ms['stable']:.2f}x [{label}]")

    def times(name):
        return dict(ms=ms[name][0], plain_ms=ms[name][1], max_abs_err=errs[name][1],
                    **bnd[name])

    # qk_kt and qk_packed beside qk, each over its bound (qk_packed's over the
    # unpacked products, the function's, and over the packed ones it issues)
    kt_bnd = {128: bnd["qk_kt"]["bound_ms"],
              64: bound(flops64, nbytes(q64, k64, out["qk64"]))["bound_ms"]}
    pk_bnd = {64: (bnd["packed64"]["bound_ms"], bound(flops, 0)["bound_ms"]),
              32: (bound(flops64 // 2, nbytes(q32, k32) + 4 * B * (H // 2) * N * 64)["bound_ms"],
                   bound(flops64, 0)["bound_ms"])}
    qk_side = {}
    for d in (128, 64):
        kern, whole, base = (qk_turns[f"qk_kt d{d} kernel"], qk_turns[f"qk_kt d{d} whole"],
                             qk_turns[f"qk d{d}"])
        qk_side[f"qk_kt d{d}"] = dict(kernel_ms=kern, whole_ms=whole, qk_ms=base)
        log(f"probe qk_kt (1x16/4x4096x{d}, block_k 512): kernel alone {kern:.4f} ms "
            f"({kt_bnd[d] / kern:.1%} of its bound {kt_bnd[d]:.4f}), whole call "
            f"{whole:.4f} ms; qk at the same shape {base:.4f} ms (kernel / qk "
            f"{kern / base:.3f}) [{label}]")
    for d, qk_d in ((64, 128), (32, 64)):
        kern, whole, base = (qk_turns[f"qk_packed d{d} kernel"],
                             qk_turns[f"qk_packed d{d} whole"], qk_turns[f"qk d{qk_d}"])
        unpacked, packed = pk_bnd[d]
        qk_side[f"qk_packed d{d}"] = dict(kernel_ms=kern, whole_ms=whole, qk_ms=base,
                                          packed_bound_ms=packed)
        log(f"probe qk_packed (1x16/4x4096x{d}, 2d = {2 * d}, block_q 256, block_k "
            f"512): kernel alone {kern:.4f} ms ({packed / kern:.1%} of the packed "
            f"products' bound {packed:.4f}, {unpacked / kern:.1%} of the unpacked "
            f"{unpacked:.4f}), whole call {whole:.4f} ms; qk at d {qk_d}, the same "
            f"products, {base:.4f} ms (kernel / qk {kern / base:.3f}) [{label}]")

    entries = [
        _probe_entry("probe_copy", 83, got["probe_copy"], source=PROBE_SM90_OBJECT,
                     shape=shape, **times("copy")),
        _probe_entry("probe_qk", 106, got["probe_qk"], source=PROBE_SM90_OBJECT,
                     shape=shape, **times("qk"), extra={shape64: times("qk64")}),
        _probe_entry("probe_pv", 262, got["probe_pv"], source=PROBE_SM90_OBJECT,
                     shape=shape, **times("pv"), extra={shape64: times("pv64")}),
        _probe_entry("probe_softmax_chain", 287, got["probe_chain"],
                     source=PROBE_SM90_OBJECT, shape=shape, **times("chain")),
        _probe_entry("probe_qk_kt", 129, got["probe_qk_kt"], source=PROBE_SM90_OBJECT,
                     shape=shape, **times("qk_kt"), **qk_side["qk_kt d128"],
                     extra={shape64: qk_side["qk_kt d64"]}),
        _probe_entry("probe_qk_packed", 184, got["probe_qk_packed"],
                     source=PROBE_SM90_OBJECT,
                     shape=shape64 + ", block_q 256, block_k 512", **times("packed64"),
                     **qk_side["qk_packed d64"],
                     extra={"1x16/4x4096x32 bf16": qk_side["qk_packed d32"]}),
        _probe_entry("probe_stream_copy", 360, got["probe_stream_copy"],
                     shape="8192x4096 f32", **times("stream")),
    ]
    entries[-1].update(library_ms=ms["stream"][1], bf16_ms=stream_bf16["kernel"],
                       bf16_library_ms=stream_bf16["x + 1"])
    entries[0].update(fused_ms=fused_ms["stable"], fused_fixed_ms=fused_ms["fixed"],
                      stage_sum_ms=serial)
    return entries


def ragged_paged_probes(device, label):
    """slots 3 and 4 and copy_only on ragged lengths with dead splits,
    tests/test_paged_decode.py:385-399's case (B 2, 8/2 heads, d 64, pages
    of 32, 8 table entries a row in shuffled order, lengths 200 and 64, so 8
    splits of one page and row 1's last 6 dead in JAX; here one split of 256
    keys a row, the gather plan; numpy seed 42), over a bf16 and an int8
    pool: each depth bit-equal to slots=2 and slots=2 within O_TOL of its
    plain version; copy_only bit-equal to its plain version."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import flash_decode as fd
    from flashattention_kernel_project_tpu_torch.ops import paged_decode as pd
    from flashattention_kernel_project_tpu_torch.ops import quant

    rng = np.random.default_rng(42)
    b, hq, hkv, d, page, n_pages, maxp = 2, 8, 2, 64, 32, 24, 8
    q, kf, vf = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                 .to(device) for shape in ((b, hq, d), (n_pages, hkv, page, d),
                                          (n_pages, hkv, page, d)))
    table = torch.from_numpy((rng.permutation(np.arange(1, 1 + b * maxp))
                              .reshape(b, maxp) % n_pages).astype(np.int32)).to(device)
    lengths = torch.tensor([200, 64], dtype=torch.int32, device=device)
    q, kb, vb = q.bfloat16(), kf.bfloat16(), vf.bfloat16()
    kq, ks = quant.quantize_int8(kf, axis=-1)
    vq, vs = quant.quantize_int8(vf, axis=-1)
    pool8 = (kq, ks.transpose(-1, -2).contiguous(), vq,
             vs.transpose(-1, -2).contiguous())
    n_splits, block_s = pd.decode_plan(b, hkv, page, maxp, d)
    scale = d ** -0.5
    plain = dict(
        bf16=pd._paged_partials_plain(q, kb, vb, table, lengths, block_s, scale),
        int8=pd._paged_partials_q_plain(q, *pool8, table, lengths, block_s, scale))
    runs = dict(bf16=lambda n: pd.paged_flash_decode(q, kb, vb, table, lengths,
                                                     slots=n),
                int8=lambda n: pd.paged_flash_decode_quant(q, *pool8, table,
                                                           lengths, slots=n))
    same, errs = {}, {}
    for pool, run in runs.items():
        outs = {n: run(n) for n in (2, 3, 4)}
        same.update({f"{pool}/slots{n}": torch.equal(outs[n], outs[2])
                     for n in (3, 4)})
        errs[pool] = _rel_l2(outs[2], fd.merge_partials(*plain[pool])
                             .reshape(b, hq, d))
    copy = pd.paged_flash_decode(q, kb, vb, table, lengths, copy_only=True)
    copy_ok = torch.equal(copy, pd._paged_copy_only_plain(
        q, kb, vb, table, lengths, block_s).to(q.dtype))
    log(f"paged probes, ragged (lengths [200, 64], {n_splits} split(s) of "
        f"{block_s} keys): bit-equal to slots=2 "
        f"{same}; slots=2 rel-L2 vs plain {errs}; copy_only equal to its plain "
        f"version {copy_ok} [{label}]")
    if not all(same.values()) or not copy_ok or not max(errs.values()) <= O_TOL:
        raise AssertionError("the paged gather's probe options failed on "
                             "ragged lengths")


def phase_paged_probes(device, label, shape=AB_PAGED):
    """The paged gather's probe options at ab_paged_int8.py's shape (B 8,
    16/4 heads, d 128, pages of 128, 8192 keys a row, every length 8192,
    seed 42; the int8 pool as it builds it: clip(x * 30) with scales 1/30),
    its own path with the counters at 0 before it: slots 2, 3 and 4 over the
    int8 and the bf16 pool, and copy_only over the bf16 pool. Each depth
    must equal slots=2 bit for bit (and q_int8=True at slots 4 its own
    slots=2), slots=2 its plain version within O_TOL, copy_only its plain
    version bit for bit; each timed (CUDA graphs) with the live K/V rate,
    copy_only as the gather's byte floor beside kernel 10. Returns the JSON
    entries of the slots instances (bf16, 8-bit) and of copy_only."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import flash_decode as fd
    from flashattention_kernel_project_tpu_torch.ops import paged_decode as pd

    b, hq, hkv, d, page, s = (shape[x] for x in ("b", "hq", "hkv", "d", "page", "s"))
    maxp = s // page
    n_pages = b * maxp + 1
    gen = torch.Generator(device=device).manual_seed(42)
    q = torch.randn(b, hq, d, generator=gen, device=device).bfloat16()
    kf = torch.randn(n_pages, hkv, page, d, generator=gen, device=device)
    vf = torch.randn(n_pages, hkv, page, d, generator=gen, device=device)
    kq, vq = ((x * 30).clamp(-127, 127).to(torch.int8) for x in (kf, vf))
    ks = torch.full((n_pages, hkv, 1, page), 1 / 30.0, device=device)
    vs = ks.clone()
    kb, vb = kf.bfloat16(), vf.bfloat16()
    del kf, vf
    table = torch.arange(1, 1 + b * maxp, dtype=torch.int32,
                         device=device).reshape(b, maxp)
    lengths = torch.full((b,), s, dtype=torch.int32, device=device)
    pool8 = (kq, ks, vq, vs)
    torch.cuda.synchronize()
    reset_counters()
    outs8 = {n: pd.paged_flash_decode_quant(q, *pool8, table, lengths, slots=n)
             for n in (2, 3, 4)}
    outs16 = {n: pd.paged_flash_decode(q, kb, vb, table, lengths, slots=n)
              for n in (2, 3, 4)}
    copy = pd.paged_flash_decode(q, kb, vb, table, lengths, copy_only=True)
    torch.cuda.synchronize()
    launches = read_counters()
    want = {"paged_decode": 3, "paged_decode/slots": 2,
            "paged_decode/copy_only": 1, "paged_decode_q": 3,
            "paged_decode_q/slots": 2}
    got = {name: launches[name] for name in want}
    log(f"paged probes: launches {got} on ab_paged_int8.py's path [{label}]")
    if got != want:
        raise AssertionError(f"paged probes: launches {got}, want {want}")

    n_splits, block_s = pd.decode_plan(b, hkv, page, maxp, d)
    scale = d ** -0.5
    args8 = (q, *pool8, table, lengths, block_s, scale)
    args16 = (q, kb, vb, table, lengths, block_s, scale)
    po8 = fd.merge_partials(*pd._paged_partials_q_plain(*args8)).reshape(b, hq, d)
    po16 = fd.merge_partials(*pd._paged_partials_plain(*args16)).reshape(b, hq, d)
    qi8 = {n: pd.paged_flash_decode_quant(q, *pool8, table, lengths, slots=n,
                                          q_int8=True) for n in (2, 4)}
    same = {f"{pool}/slots{n}": torch.equal(outs[n], outs[2])
            for pool, outs in (("int8", outs8), ("bf16", outs16)) for n in (3, 4)}
    same["int8 q_int8/slots4"] = torch.equal(qi8[4], qi8[2])
    errs = dict(int8=_rel_l2(outs8[2], po8), bf16=_rel_l2(outs16[2], po16))
    copy_plain = pd._paged_copy_only_plain(q, kb, vb, table, lengths,
                                           block_s).to(q.dtype)
    log(f"paged probes: bit-equal to slots=2 {same}; slots=2 rel-L2 vs plain "
        f"{errs}; copy_only equal to its plain version "
        f"{torch.equal(copy, copy_plain)} [{label}]")
    if not all(same.values()) or not torch.equal(copy, copy_plain) or not (
            max(errs.values()) <= O_TOL):
        raise AssertionError("the paged gather's probe options failed")
    ragged_paged_probes(device, label)

    live = b * s
    bytes16 = 2 * live * hkv * d * 2
    bytes8 = bytes_8bit(live, hkv, d)
    io = nbytes(q, outs16[2], table, lengths)
    ms8 = {n: time_ms(pdec_whole(q, pool8, table, lengths, slots=n),
                      device, iters=50, graph=True) for n in (2, 3, 4)}
    ms16 = {n: time_ms(pdec_whole(q, (kb, vb), table, lengths, slots=n),
                       device, iters=50, graph=True) for n in (2, 3, 4)}
    # the probe's kernel alone (its split partials), and the decode's
    copy_ms = time_ms(lambda: pd._paged_partials_cuda(*args16, copy_only=True),
                      device, iters=50, graph=True)
    kernel16_ms = time_ms(lambda: pd._paged_partials_cuda(*args16), device,
                          iters=50, graph=True)
    plain8_ms = time_ms(lambda: pd._paged_partials_q_plain(*args8), device,
                        iters=5, graph=True)
    plain16_ms = time_ms(lambda: pd._paged_partials_plain(*args16), device,
                         iters=5, graph=True)
    copy_plain_ms = time_ms(lambda: pd._paged_copy_only_plain(*args16[:6]),
                            device, iters=5, graph=True)
    bnd16 = bound(4 * live * hq * d, io + bytes16)
    bnd8 = bound(4 * live * hq * d, io + bytes8)
    bndc = bound(0, io + bytes16)
    geo = (f"b{b} hq{hq} hkv{hkv} d{d} page{page} {maxp} pages a row, every "
           f"length {s} ({n_splits} splits of {block_s} keys)")
    for pool, t, nb, bd in (("int8", ms8, bytes8, bnd8), ("bf16", ms16, bytes16, bnd16)):
        log(f"paged gather {pool} {geo}: " + ", ".join(
            f"slots={n} {t[n]:.4f} ms ({nb / t[n] / 1e6:.1f} GB/s of live K/V)"
            for n in (2, 3, 4))
            + f" | bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}) [{label}]")
    log(f"paged gather copy_only (bf16) {geo}: the kernel {copy_ms:.4f} ms "
        f"({bytes16 / copy_ms / 1e6:.1f} GB/s of live K/V), the byte floor "
        f"beside kernel 10's partials {kernel16_ms:.4f} ms "
        f"({copy_ms / kernel16_ms:.1%}) and whole call {ms16[2]:.4f} ms; plain "
        f"{copy_plain_ms:.4f} ms | bound {bndc['bound_ms']:.4f} ms [{label}]")
    src = PDEC_SOURCE
    slots16 = dict(name="paged_decode_slots", route="cuda", source=src,
                   replaces=f"{TPU}/paged_decode.py:124", shape=geo + " slots 4",
                   launches=got["paged_decode/slots"], max_abs_err=0.0,
                   ms=ms16[4], plain_ms=plain16_ms, library_ms=None,
                   slots_ms={str(n): ms16[n] for n in (2, 3, 4)}, **bnd16)
    slots8 = dict(name="paged_decode_q_slots", route="cuda", source=src,
                  replaces=f"{TPU}/paged_decode.py:832", shape=geo + " int8 slots 4",
                  launches=got["paged_decode_q/slots"], max_abs_err=0.0,
                  ms=ms8[4], plain_ms=plain8_ms, library_ms=None,
                  slots_ms={str(n): ms8[n] for n in (2, 3, 4)}, **bnd8)
    copy_entry = dict(name="paged_decode_copy_only", route="cuda", source=src,
                      replaces=f"{TPU}/paged_decode.py:203", shape=geo,
                      launches=got["paged_decode/copy_only"], max_abs_err=0.0,
                      ms=copy_ms, plain_ms=copy_plain_ms, library_ms=None,
                      decode_ms=ms16[2], decode_kernel_ms=kernel16_ms, **bndc)
    return slots16, slots8, copy_entry


# ---------------------------------------------------------------------------
# MoE on one device: bench_train.py --moe-experts 8's model trained, its
# dispatches held on real activations, served through the engine, and its
# cached decode held to a full forward.
# ---------------------------------------------------------------------------

# benchmarks/serving_queue.py:158's train_moe8_4l (bench_train.py
# --moe-experts 8): the training configuration with 8 experts of d_ff 5504
# each, top-2, capacity factor 1.25 and aux weight 0.01 (the JAX config's
# defaults), batch 4 x 4096
MOE_TRAIN = dict(TRAIN, moe_experts=8, moe_top_k=2, moe_capacity_factor=1.25,
                 moe_aux_weight=0.01)
MOE_DISPATCH_TOL = 2e-6  # dense against sort, rtol and atol (tests/test_moe.py:205)
# the card's moe_ffn against the same call on the CPU (rel-L2 over the tokens
# whose chosen experts and kept slots agree), and the tokens whose choice
# may differ: a near-tie of the router, whose f32 sums the two devices take
# in another order
MOE_CPU_TOL = 1e-5
MOE_MAX_FLIPS = 1
MOE_TOKENS = 2048  # of the trained model's layer-0 MLP input
# this repo's attention kernels, by name
ATTENTION_KERNEL = r"(flash|paged|ragged)_\w+_kernel"


def moe_kind(op, kernel: str, cfg) -> str:
    """The kind of a kernel of an MoE training step, by its own name (this
    repo's attention kernels) or by the innermost operator that launched it:
    its name, its input shapes and the backward node around it."""
    if re.search(ATTENTION_KERNEL, kernel):
        return "attention kernels"
    e, f, v = cfg.moe_experts, cfg.d_ff, cfg.vocab_size
    shapes = [list(s) for s in (op.input_shapes or []) if s and
              all(isinstance(d, int) for d in s)]
    node = op.cpu_parent
    while node is not None and "Backward" not in node.name:
        node = node.cpu_parent
    node = node.name if node is not None else ""
    if any(v in s for s in shapes):
        return "lm_head, embedding and loss (f32)"
    expert3 = [s for s in shapes if len(s) == 3 and s[0] == e]
    if op.name in ("aten::bmm", "aten::baddbmm") and expert3:
        return "expert products (f32 bmm)"
    if op.name in ("aten::gelu", "aten::gelu_backward"):
        return "expert gelu"
    if op.name == "aten::bmm":  # the dense dispatch's products (einsum)
        return "dispatch and combine"
    if op.name in ("aten::copy_", "aten::_to_copy") and any(f in s for s in expert3):
        return "expert weights widened to f32"
    if any((len(s) == 2 and s[-1] == e) or s == [e] for s in shapes):
        return "router"
    if (op.name in ("aten::index", "aten::index_put_", "aten::_index_put_impl_",
                    "aten::sort", "aten::searchsorted", "aten::scatter_",
                    "aten::scatter_add_", "aten::index_add_", "aten::gather")
            or "IndexBackward" in node
            or (op.name == "aten::cat" and [1, cfg.d_model] in shapes)):
        return "dispatch and combine"
    if op.name in ("aten::mm", "aten::addmm"):
        return "projections (bf16 GEMM)"
    return "glue"


def moe_device_ms(fn, cfg, what, label):
    """Run fn() under torch.profiler and log its device time by kind
    (`moe_kind`), each kernel classed through the operator that launched
    it, with each kind's three largest operators; this repo's attention
    kernels by their names, launched inside an operator (a backward node)
    or not (ctypes in the forward), the rest of the latter "unattributed".
    Returns {kind: ms}."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    kinds, ops, linked, flash, total, n_ops = {}, {}, 0.0, 0.0, 0.0, 0
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            us = ev.time_range.elapsed_us()
            total += us
            n_ops += 1
            if re.search(ATTENTION_KERNEL, ev.name):
                flash += us
        elif ev.device_type == DeviceType.CPU:
            for k in ev.kernels:
                kind = moe_kind(ev, k.name, cfg)
                kinds[kind] = kinds.get(kind, 0.0) + k.duration
                by_op = ops.setdefault(kind, {})
                by_op[ev.name] = by_op.get(ev.name, 0.0) + k.duration
                linked += k.duration
    rest = total - (linked - kinds.pop("attention kernels", 0.0)) - flash
    kinds["attention kernels"] = flash
    if rest > 0:
        kinds["unattributed"] = rest
    kinds = {k: us / 1e3 for k, us in kinds.items()}
    dev = sum(kinds.values())
    log(f"MoE {what} profile: {dev:.2f} ms of device time in {wall:.2f} ms of "
        f"wall (profiled), {n_ops} device operations | " + ", ".join(
            f"{k} {v:.2f} ms ({100 * v / dev:.1f}%)"
            for k, v in sorted(kinds.items(), key=lambda kv: -kv[1]))
        + f" [{label}]")
    for kind, by_op in sorted(ops.items()):
        top = sorted(by_op.items(), key=lambda kv: -kv[1])[:3]
        log(f"MoE {what} profile: {kind}: " + ", ".join(
            f"{name} {us / 1e3:.2f} ms" for name, us in top))
    return kinds


def profile_moe_step(cfg, params, tokens, lr, label):
    """One more MoE training step, profiled by `moe_device_ms`."""
    from flashattention_kernel_project_tpu_torch.models import transformer as tfm

    return moe_device_ms(lambda: tfm.sgd_train_step(cfg, params, tokens, lr),
                         cfg, "train step", label)


def moe_dispatch_check(device, cfg, params, corpus, label):
    """moe_ffn on MOE_TOKENS tokens of the trained model's layer-0 MLP input
    (rms_norm of the residual after layer 0's attention, in f32): the dense
    and the sort dispatch within MOE_DISPATCH_TOL on the card; the card's
    call against the same call on the CPU, every token whose chosen experts
    differ printed with its probabilities (more than MOE_MAX_FLIPS fail),
    and rel-L2 within MOE_CPU_TOL over the tokens whose choices and kept
    slots agree (a flip upstream can shift an expert's queue by one)."""
    import torch

    from flashattention_kernel_project_tpu_torch.models import moe
    from flashattention_kernel_project_tpu_torch.models import transformer as tfm

    seq = MOE_TOKENS
    toks = torch.from_numpy(corpus[1000:1000 + seq].astype(np.int32)).to(device)
    layer = tfm.layer_params(params, 0)
    with torch.no_grad():
        x = params["embed"][toks[None]]
        sin, cos = tfm.rope_tables(cfg, torch.arange(seq, device=device)[None])
        x = tfm._attention_block(cfg, layer, x, sin, cos)
        h = tfm.rms_norm(x, layer["rms_mlp"]).reshape(seq, cfg.d_model).float()
        mcfg = moe.MoEConfig(d_model=cfg.d_model, d_ff=cfg.d_ff,
                             num_experts=cfg.moe_experts, top_k=cfg.moe_top_k,
                             capacity_factor=cfg.moe_capacity_factor)
        mp = {"w_gate": layer["moe_router"], "w1": layer["moe_w1"].float(),
              "w2": layer["moe_w2"].float()}
        dense = moe.moe_ffn(mp, h, mcfg, dispatch="dense")
        srt = moe.moe_ffn(mp, h, mcfg, dispatch="sort")
        gap = float((dense - srt).abs().max())
        if not torch.allclose(dense, srt, rtol=MOE_DISPATCH_TOL,
                              atol=MOE_DISPATCH_TOL):
            raise AssertionError(f"MoE dense and sort dispatch differ on the "
                                 f"card: max-abs {gap:.3e}")
        cpu = torch.device("cpu")
        hc, mpc = h.to(cpu), {k: w.to(cpu) for k, w in mp.items()}
        on_cpu = moe.moe_ffn(mpc, hc, mcfg)
        on_card = moe.moe_ffn(mp, h, mcfg).to(cpu)
        probs = [torch.softmax(a @ w["w_gate"], dim=-1).to(cpu)
                 for a, w in ((h, mp), (hc, mpc))]
        cap = mcfg.capacity(seq)
        routes = [moe._top_k_dispatch_sort(p, mcfg.top_k, cap)[1] for p in probs]
        choices = [torch.stack([m.argmax(-1) for m in
                                moe._top_k_choices(p, mcfg.top_k)[1]], -1)
                   for p in probs]
    flips = (choices[0] != choices[1]).any(-1)
    same = ~flips & (routes[0] == routes[1]).all(-1)
    for t in flips.nonzero()[:, 0].tolist():
        top = probs[0][t].topk(mcfg.top_k + 1)
        log(f"MoE router near-tie: token {t} experts {choices[0][t].tolist()} on "
            f"the card, {choices[1][t].tolist()} on the CPU; card's top "
            f"{mcfg.top_k + 1} probabilities {top.values.tolist()} (experts "
            f"{top.indices.tolist()}), the gap at the flip "
            f"{float((top.values[:-1] - top.values[1:]).min()):.3e}")
    err = _rel_l2(on_card[same], on_cpu[same])
    drops = int((routes[0] == cfg.moe_experts * cap).sum())
    log(f"MoE dispatch on {seq} tokens of layer 0's MLP input (trained model; "
        f"capacity {cap} an expert, {drops} of {seq * mcfg.top_k} choices "
        f"dropped): dense vs sort max-abs {gap:.3e} (<= {MOE_DISPATCH_TOL}); "
        f"card vs CPU: {int(flips.sum())} tokens chose other experts, "
        f"{seq - int(same.sum())} excluded, rel-L2 over the other "
        f"{int(same.sum())} {err:.3e} (<= {MOE_CPU_TOL}) [{label}]")
    if int(flips.sum()) > MOE_MAX_FLIPS:
        raise AssertionError(f"MoE routing: {int(flips.sum())} tokens chose "
                             f"other experts on the card than on the CPU")
    if not err <= MOE_CPU_TOL:
        raise AssertionError(f"MoE output on the card {err:.3e} rel-L2 from "
                             f"the CPU's > {MOE_CPU_TOL}")


def moe_serve(device, cfg, params, label, batch=8, n_prompt=128, n_new=64,
              chunk=256, verify=5, page=128, n_paged=16):
    """The trained MoE model served through the engine from its split
    parameters, with every launch counter at 0 before: prefill of `batch`
    prompts, 4 decode_steps to warm up and `n_new` greedy decode_steps
    (kernels 1 and 6, timed: tok/s), one decode_step profiled by
    `moe_device_ms`, an extend chunk of `chunk` (kernel 3, wgmma route)
    and a ragged extend of `verify` (slab route), then each row's cache
    paged_insert'ed into pages of `page` and `n_paged` decode_steps_paged
    and a `verify`-token extend_paged (kernels 10 and 11). Every kernel of
    the path must have launched, every token lie in the vocabulary and
    every logit be finite. Returns the launches and the decode's tok/s."""
    import torch

    from flashattention_kernel_project_tpu_torch.models import engine

    gen = torch.Generator(device=device).manual_seed(37)

    def draw(*shape):
        return torch.randint(0, cfg.vocab_size, shape, generator=gen,
                             device=device, dtype=torch.int32)

    prompts = draw(batch, n_prompt)
    max_len = n_prompt + 4 + n_new + 1 + chunk + verify
    torch.cuda.synchronize()
    reset_counters()
    cache = engine.init_cache(cfg, batch, max_len, device)
    logits, cache = engine.prefill(cfg, params, prompts, cache)
    outs = [logits]
    warm, cache = engine.decode_steps(cfg, params, logits.argmax(-1).to(torch.int32),
                                      cache, n_steps=4)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks, cache = engine.decode_steps(cfg, params, warm[:, -1], cache,
                                      n_steps=n_new)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    moe_device_ms(lambda: engine.decode_step(cfg, params, toks[:, -1], cache),
                  cfg, f"decode step (B {batch})", label)
    logits, cache = engine.extend(cfg, params, draw(batch, chunk), cache)
    outs.append(logits)
    n = torch.arange(batch, device=device, dtype=torch.int32) % verify + 1
    logits, cache = engine.extend(cfg, params, draw(batch, verify), cache, n=n)
    outs.append(logits)
    lens = cache.lengths.tolist()
    max_pages = -(-(max(lens) + n_paged + verify) // page)
    pcache = engine.init_paged_cache(cfg, batch, batch * max_pages + 1, device,
                                     page_size=page, max_pages_per_seq=max_pages)
    for slot, length in enumerate(lens):
        engine.paged_insert(pcache, slot,
                            list(range(1 + slot * max_pages, 1 + (slot + 1) * max_pages)),
                            [k[slot, :, :length] for k in cache.k],
                            [v[slot, :, :length] for v in cache.v], length)
    ptoks, pcache = engine.decode_steps_paged(
        cfg, params, logits.argmax(-1).to(torch.int32), pcache, n_steps=n_paged)
    logits, pcache = engine.extend_paged(cfg, params, draw(batch, verify), pcache)
    outs.append(logits)
    torch.cuda.synchronize()
    counts = read_counters()
    need = ("flash_fwd", "flash_decode", "flash_fwd_ragged/wgmma",
            "flash_fwd_ragged/slab", "paged_decode", "paged_extend")
    launches = {k: counts[k] for k in need}
    tok_s = batch * n_new / decode_s
    log(f"MoE serve: prefill {batch} x {n_prompt}, 4 + {n_new} decode_steps "
        f"({tok_s:.1f} tok/s, {decode_s * 1e3 / n_new:.2f} ms a step, host "
        f"clock after the 4), extend {chunk}, ragged extend {verify} (n "
        f"{n.tolist()}), paged_insert into pages of {page}, {n_paged} "
        f"decode_steps_paged, extend_paged {verify}: launches {launches} [{label}]")
    if not all(launches.values()):
        raise AssertionError(f"MoE serve: a kernel of the path never launched: "
                             f"{launches}")
    for t in (toks, ptoks):
        if not bool(((t >= 0) & (t < cfg.vocab_size)).all()):
            raise AssertionError("MoE serve: a token outside the vocabulary")
    if not all(bool(torch.isfinite(x).all()) for x in outs):
        raise AssertionError("MoE serve: non-finite logits")
    return launches, tok_s


def phase_moe(device, corpus, label):
    """bench_train.py --moe-experts 8's model (MOE_TRAIN, bf16, weights from
    seed 0) on the card: (a) 5 timed sgd_train_steps through phase_train
    (losses finite, the first within 1.0 of ln(vocab), the held-out loss
    falling, the forward and the two-kernel backward launched) and one
    profiled step by kind; (b) its dispatches on real activations
    (`moe_dispatch_check`); (c) the trained model served (`moe_serve`);
    (d) cached decode against a full forward (phase_consistency, with its
    routing audit) on the seed-0 weights with capacity factor E / top_k,
    where no token can be dropped in either (routing couples a batch's
    tokens, so a cached step and a full forward would otherwise drop
    differently). Not on the trained weights: the native TokenLoader's two
    prefetch threads hand over the shuffled batches in the order they
    finish, so the trained weights differ from run to run (the step itself
    is bit-reproducible). f32 products with TF32 off: a
    rounded router product flips near-tie argmaxes. Returns the launches of
    (a), (c) and (d) by kernel."""
    import dataclasses

    import torch

    from flashattention_kernel_project_tpu_torch.models import transformer as tfm

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tfm.TransformerConfig(**MOE_TRAIN, dtype=torch.bfloat16)
    params = tfm.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device)
    t0 = time.perf_counter()
    params, train, ms = phase_train(device, cfg, params, corpus, TRAIN_BATCH,
                                    TRAIN_SEQ, TRAIN_LR, steps=5, label=label,
                                    profile=profile_moe_step)
    t1 = time.perf_counter()
    moe_dispatch_check(device, cfg, params, corpus, label)
    t2 = time.perf_counter()
    serve, tok_s = moe_serve(device, cfg, params, label)
    t3 = time.perf_counter()
    ccfg = dataclasses.replace(
        cfg, moe_capacity_factor=cfg.moe_experts / cfg.moe_top_k)
    init = tfm.init_params(
        ccfg, torch.Generator(device=device).manual_seed(0), device)
    reset_counters()
    phase_consistency(device, ccfg, init, n_prompt=128, n_steps=16,
                      label=label, what=f" (MoE, seed-0 weights, capacity "
                      f"factor {ccfg.moe_capacity_factor})")
    torch.cuda.synchronize()
    counts = read_counters()
    cons = {k: counts[k] for k in ("flash_fwd", "flash_decode")}
    t4 = time.perf_counter()
    log(f"MoE phase: train {t1 - t0:.1f} s, dispatch {t2 - t1:.1f} s, serve "
        f"{t3 - t2:.1f} s, consistency {t4 - t3:.1f} s | launches: train "
        f"{train}, serve {serve}, consistency {cons} [{label}]")
    return dict(train=train, serve=serve, consistency=cons, ms=ms, tok_s=tok_s)


# ---------------------------------------------------------------------------
# Serving over a device mesh (parallel/): two ranks, one process each, both
# on the one card, joined by gloo (NCCL refuses two ranks on one GPU; gloo
# stages CUDA tensors through the host). Every number here is two ranks
# sharing one card over gloo, not a tensor-parallel speed.
# ---------------------------------------------------------------------------

MESH_WORLD = 2
MESH_REQUESTS = 8
# (d): run_all.py's decode rung (B 8, 16/4 heads, S 8192, d 128); rows
# that fill the cache, end in either shard, stop at its edge, or are empty
MESH_SEQ = (8, 16, 4, 8192, 128)
MESH_SEQ_LENS = [8192, 4096, 4097, 100, 0, 6000, 1, 8191]
SEQ_TOL = 1e-2  # rel-L2 of bf16 attention outputs (O_TOL)
# path -> (the mesh it runs on, Scheduler options, prompts with the shared
# prefix, the kernels that must launch on every rank). "draft": the spec
# draft of bench_spec.py (whole on every rank)
MESH_PATHS = {
    "tp (linear, prefill_chunk=256)": (
        "mesh", dict(prefill_chunk=256), False,
        ("flash_fwd_ragged", "flash_decode")),
    "tp (paged, prefix cache)": (
        "mesh", dict(paged=True, page_size=128, prefix_cache=True,
                     prefill_chunk=256), True,
        ("flash_fwd_ragged", "paged_decode")),
    "tp (paged, prefix cache, int8)": (
        "mesh", dict(paged=True, page_size=128, prefix_cache=True,
                     prefill_chunk=256, quantized_cache=True), True,
        ("flash_fwd_ragged", "paged_decode_q")),
    "tp spec (linear)": (
        "mesh", dict(draft=True), False,
        ("flash_fwd_ragged", "flash_fwd_ragged/slab", "flash_decode")),
    "tp spec (paged)": (
        "mesh", dict(draft=True, paged=True, page_size=128), False,
        ("paged_extend", "flash_decode")),
    "sp (linear)": ("seq_mesh", {}, False, ("flash_fwd", "flash_decode")),
    "sp (linear, int8)": (
        "seq_mesh", dict(quantized_cache=True), False,
        ("flash_fwd", "flash_decode_q")),
}


def _mesh_models(device):
    """The serving model (seed 0) and bench_spec.py's draft (seed 1), bf16,
    as every rank and the parent build them."""
    import torch

    from flashattention_kernel_project_tpu_torch.models import transformer as tfm

    cfg = tfm.TransformerConfig(**SERVING, dtype=torch.bfloat16)
    params = tfm.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device)
    dcfg = tfm.TransformerConfig(**DRAFT, dtype=torch.bfloat16)
    dparams = tfm.init_params(
        dcfg, torch.Generator(device=device).manual_seed(1), device)
    return cfg, params, dcfg, dparams


def _mesh_sched_kw(kw, dcfg, dparams):
    kw = dict(kw)
    if kw.pop("draft", False):
        kw.update(draft_cfg=dcfg, draft_params=dparams, spec_k=SPEC_K)
    return kw


def mesh_rank(rank, world, device_type, prompts, system_prompts, max_new):
    """One rank of phase_mesh, on the card beside the other: every path of
    MESH_PATHS through Scheduler(mesh=) or Scheduler(seq_mesh=) over a
    2-rank axis, each with every launch counter at 0 just before it
    (tokens, launches, wall seconds); then (d) seq_sharded_decode against
    flash_decode on the whole cache, and the engines' logits against the
    single-device engine's on the same rank. Returns them by name."""
    import torch

    from flashattention_kernel_project_tpu_torch import parallel
    from flashattention_kernel_project_tpu_torch.models import engine
    from flashattention_kernel_project_tpu_torch.models.serving import Scheduler
    from flashattention_kernel_project_tpu_torch.ops.flash_decode import flash_decode

    device = torch.device(device_type, 0 if device_type == "cuda" else None)
    if device.type == "cuda":
        torch.cuda.set_device(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    cfg, params, dcfg, dparams = _mesh_models(device)
    meshes = dict(
        mesh=parallel.make_mesh({"model": world}, device_type=device.type),
        seq_mesh=parallel.make_mesh({"sp": world}, device_type=device.type))
    out = {}
    for name, (kind, kw, shared, _) in MESH_PATHS.items():
        sched_kw = dict(max_batch=8, max_len=2048, **{kind: meshes[kind]},
                        **_mesh_sched_kw(kw, dcfg, dparams))
        warm = Scheduler(cfg, params, **sched_kw)
        warm.submit(prompts[0][:8], max_new_tokens=4)
        warm.run()
        del warm
        sched = Scheduler(cfg, params, **sched_kw)
        sync()
        reset_counters()
        t0 = time.perf_counter()
        ps = system_prompts if shared else prompts
        uids = [sched.submit(p, max_new_tokens=max_new) for p in ps]
        res = sched.run()
        sync()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in read_counters().items() if v}
        extra = {}
        if sched.paged:
            extra["pages back"] = sched._pool.free_pages == sched._n_pages - 1
        if sched.prefix_cache:
            extra["prefix hits"] = sched.prefix_hits
        out[name] = dict(tokens=[res[u] for u in uids], launches=launches,
                         wall=wall, extra=extra,
                         kv_heads=sched.cache.k_pages[0].shape[1]
                         if sched.paged else sched.cache.k[0].shape[1],
                         cache_rows=None if sched.paged
                         else sched.cache.k[0].shape[2])
        del sched

    # (d) the sequence-sharded decode at run_all.py's decode rung
    b, hq, hkv, s, d = MESH_SEQ
    gen = torch.Generator(device=device).manual_seed(11)
    q = torch.randn((b, hq, d), generator=gen, device=device).bfloat16()
    k = torch.randn((b, hkv, s, d), generator=gen, device=device).bfloat16()
    v = torch.randn((b, hkv, s, d), generator=gen, device=device).bfloat16()
    lengths = torch.tensor(MESH_SEQ_LENS, dtype=torch.int32, device=device)
    mesh = meshes["seq_mesh"]
    fn = parallel.seq_sharded_decode(mesh)
    k_loc, v_loc = (parallel.mesh.shard(x, mesh, fn.kv_spec) for x in (k, v))
    whole = flash_decode(q, k, v, lengths)
    sync()
    reset_counters()
    got = fn(q, k_loc, v_loc, lengths)
    sync()
    launches = {k_: n for k_, n in read_counters().items() if n}
    out["seq_sharded_decode"] = dict(
        rel_l2=_rel_l2(got, whole), finite=bool(torch.isfinite(got).all()),
        launches=launches, out=got.float().cpu().numpy())

    # the engines' logits against the single-device engine on this rank:
    # TP prefill and one decode step, SP one decode step from the same
    # prefilled cache
    tokens = torch.randint(0, cfg.vocab_size, (8, 128), generator=gen,
                           device=device, dtype=torch.int32)
    full = engine.init_cache(cfg, 8, 256, device)
    ref_pre, full = engine.prefill(cfg, params, tokens, full)
    nxt = ref_pre.argmax(-1).to(torch.int32)
    tp_mesh = meshes["mesh"]
    pre_fn, _, dec_fn, rules = parallel.make_tp_engine(cfg, tp_mesh)
    sparams = parallel.shard_params(params, tp_mesh, rules)
    tcache = parallel.init_tp_cache(cfg, tp_mesh, 8, 256)
    tp_pre, tcache = pre_fn(sparams, tokens, tcache)
    tp_dec, _ = dec_fn(sparams, nxt, tcache)
    spec = parallel.tp_engine.sp_cache_specs(cfg.n_layers)
    scache = parallel.init_sp_cache(cfg, mesh, 8, 256)
    for dst, src, sp in zip(scache.k + scache.v, full.k + full.v,
                            spec.k + spec.v):
        dst.copy_(parallel.mesh.shard(src, mesh, sp))
    scache.lengths.copy_(full.lengths)
    sp_dec, _ = parallel.make_sp_decode_step(cfg, mesh)(params, nxt, scache)
    ref_dec, _ = engine.decode_step(cfg, engine.fuse_decode_params(cfg, params),
                                    nxt, full)
    out["logits"] = dict(tp_prefill=_rel_l2(tp_pre, ref_pre),
                         tp_decode=_rel_l2(tp_dec, ref_dec),
                         sp_decode=_rel_l2(sp_dec, ref_dec))
    return out


def phase_mesh(device, label):
    """Serving over a device mesh with two ranks on the one card (spawned,
    one process each, gloo; the kernels are built by this process first,
    so the ranks only load the library): the serving configuration at full
    width through (a) Scheduler(mesh=) over the linear cache (prefill in
    chunks of 256), the page pool with the 384-token shared prefix, and the
    page pool with an int8 cache; (b) the TP speculative Scheduler with
    bench_spec.py's draft over the linear cache and the page pool; (c)
    Scheduler(seq_mesh=) over the linear bf16 and int8 caches; 8 serving
    requests x 64 new tokens each; (d) seq_sharded_decode at B 8, 16/4
    heads, S 8192, d 128 against flash_decode on the whole cache (rel-L2
    within SEQ_TOL, the same on both ranks). Each path's tokens must be
    equal on the two ranks, and against the single-device Scheduler's in
    this process every first divergence must pass the near-tie audit; the
    TP and SP engines' logits must be within LOGITS_TOL of the
    single-device engine's; each path's kernels (rows 3, 6, 7, 10, 11, 12
    at the per-rank shapes; row 1 in SP's prefill and the draft's) must
    launch on every rank. Returns the launches by path and rank."""
    import torch

    from flashattention_kernel_project_tpu_torch.models.serving import Scheduler
    from flashattention_kernel_project_tpu_torch.utils.testing import run_ranks

    t0 = time.perf_counter()
    cfg, params, dcfg, dparams = _mesh_models(device)
    prompts = serving_prompts(cfg, MESH_REQUESTS)
    system = np.random.default_rng(1).integers(0, cfg.vocab_size, 384)
    system_prompts = [np.concatenate([system, p]).astype(np.int32)
                      for p in prompts]
    max_new = 64
    # the single-device Scheduler on the same paths, in this process
    refs = {}
    for name, (kind, kw, shared, _) in MESH_PATHS.items():
        sched = Scheduler(cfg, params, max_batch=8, max_len=2048,
                          **_mesh_sched_kw(kw, dcfg, dparams))
        ps = system_prompts if shared else prompts
        uids = [sched.submit(p, max_new_tokens=max_new) for p in ps]
        res = sched.run()
        refs[name] = [res[u] for u in uids]
        del sched
    if device.type == "cuda":
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ranks = run_ranks(mesh_rank, MESH_WORLD, device.type, prompts,
                          system_prompts, max_new, tmpdir=tmp, timeout=900.0)
    t2 = time.perf_counter()
    ties = {False: NearTie(cfg, params, list(prompts[0]) + refs[
        "tp (linear, prefill_chunk=256)"][0][:1])}
    ties[True] = NearTie(cfg, params, list(prompts[0]) + refs[
        "sp (linear, int8)"][0][:1], quantized=True)
    launches = {}
    for name, (kind, kw, shared, kernels) in MESH_PATHS.items():
        runs = [r[name] for r in ranks]
        ps = system_prompts if shared else prompts
        if runs[1]["tokens"] != runs[0]["tokens"]:
            raise AssertionError(f"mesh {name}: the two ranks' tokens differ")
        for rank, run in enumerate(runs):
            missing = [k for k in kernels if not run["launches"].get(k)]
            if device.type == "cuda" and missing:
                raise AssertionError(f"mesh {name}: rank {rank} never launched "
                                     f"{missing}: {run['launches']}")
            if run["extra"].get("pages back") is False:
                raise AssertionError(f"mesh {name}: rank {rank}'s pool not "
                                     "fully recycled")
            if len(run["tokens"]) != len(ps) or any(
                    len(t) != max_new for t in run["tokens"]):
                raise AssertionError(f"mesh {name}: rank {rank} returned "
                                     "short streams")
        if kw.get("prefix_cache") and not runs[0]["extra"]["prefix hits"]:
            raise AssertionError(f"mesh {name}: no insert reused the prefix")
        tie = ties[bool(kw.get("quantized_cache"))]
        windows, gaps = tie.audit(runs[0]["tokens"], refs[name], ps,
                                  f"mesh {name}")
        same = np.mean([a == b for x, y in zip(runs[0]["tokens"], refs[name])
                        for a, b in zip(x, y)])
        toks = sum(len(t) for t in runs[0]["tokens"])
        launches[name] = [run["launches"] for run in runs]
        log(f"mesh {name}: {len(ps)} requests x {max_new} tokens on "
            f"{MESH_WORLD} ranks ({kind}, KV heads a rank "
            f"{runs[0]['kv_heads']}, cache rows a rank {runs[0]['cache_rows']}"
            f"); tokens equal on both ranks; equal to the single-device "
            f"Scheduler {same:.4f}, agreement windows {windows}, gaps at "
            f"divergences {[f'{g:.2e}' for g in gaps]} (bound "
            f"{tie.bound:.2e}) | {runs[0]['extra']} | {toks} tokens in "
            f"{runs[0]['wall']:.2f} s = {toks / runs[0]['wall']:.1f} tok/s, "
            f"two ranks sharing one card over gloo, not a TP speed | "
            f"launches per rank {launches[name]} [{label}]")
    seq = [r["seq_sharded_decode"] for r in ranks]
    if not all(s["finite"] for s in seq) or not np.array_equal(
            seq[0]["out"], seq[1]["out"]):
        raise AssertionError("seq_sharded_decode: non-finite, or the ranks "
                             "differ")
    if max(s["rel_l2"] for s in seq) > SEQ_TOL:
        raise AssertionError(f"seq_sharded_decode: rel-L2 "
                             f"{[s['rel_l2'] for s in seq]} > {SEQ_TOL}")
    if device.type == "cuda" and not all(s["launches"].get("flash_decode")
                                         for s in seq):
        raise AssertionError(f"seq_sharded_decode never launched kernel 6: "
                             f"{[s['launches'] for s in seq]}")
    logits = [r["logits"] for r in ranks]
    bad = {k: v for lg in logits for k, v in lg.items() if v > LOGITS_TOL}
    if bad:
        raise AssertionError(f"mesh engines' logits off the single-device "
                             f"engine's: {bad} > {LOGITS_TOL}")
    errs = [f"{x['rel_l2']:.2e}" for x in seq]
    log(f"mesh seq_sharded_decode: B {MESH_SEQ[0]}, {MESH_SEQ[1]}/{MESH_SEQ[2]}"
        f" heads, S {MESH_SEQ[3]} over {MESH_WORLD} shards of "
        f"{MESH_SEQ[3] // MESH_WORLD}, d {MESH_SEQ[4]}, lengths {MESH_SEQ_LENS}:"
        f" rel-L2 against flash_decode on the whole cache "
        f"{errs} (<= {SEQ_TOL}), equal on both "
        f"ranks | launches per rank {[s['launches'] for s in seq]} | engine "
        f"logits rel-L2 against the single-device engine, per rank {logits} "
        f"(<= {LOGITS_TOL}) [{label}]")
    log(f"mesh phase: references {t1 - t0:.1f} s, ranks {t2 - t1:.1f} s "
        f"(spawn, params, 7 paths, (d), logits) [{label}]")
    return launches


# (a), (c): 1 x 16/4 x 8192 x 128 bf16 over 2 shards of 4096; the windowed
# ring's band (truncated to depth 2: the off-diagonal shard at q_offset 4096)
MESH_TRAIN_RING = (1, 16, 4, 8192, 128)
MESH_TRAIN_WINDOW = 1024
# (b): BASELINE.json config 5 (32/8 heads, 32K, int8 KV, causal) over 2
# shards of 16384
MESH_TRAIN_Q8 = (1, 32, 8, 32768, 128)
# (d): bench_train.py's model and batch, 3 steps a path; AdamW's lr and
# weight decay (explicit: torch's and optax's defaults differ), its clip
MESH_TRAIN_STEPS = 3
MESH_TRAIN_MICRO = 4
MESH_ADAMW = dict(lr=1e-3, weight_decay=1e-2)
MESH_CLIP = 1.0
RING_TOL = 1e-2   # rel-L2 of bf16 outputs and gradients (O_TOL)
STEP_TOL = 1e-2   # the first loss (relative) and each leaf after one SGD step (rel-L2)


def _ring_launches(rank, per_call=1):
    """The forwards (or backwards) the causal ring's schedule launches on
    `rank` a call: the diagonal and the rank's r shards below it."""
    return (rank + 1) * per_call


def _digest(tensors) -> str:
    """One hash of the tensors' bytes: bit-equality across ranks."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(-1).view(torch.uint8).cpu()
                 .numpy().tobytes())
    return h.hexdigest()


def mesh_train_rank(rank, world, device_type):
    """One rank of phase_mesh_train, on the card beside the other. Each
    path runs with every launch counter at 0 just before it and is held
    here against the single-device path on the same inputs: (a) the bf16
    ring, trainable ring and windowed ring, (b) the 8-bit ring, (c) Ulysses,
    (d) 3 steps each of the CP, TP, AdamW and pipeline training steps.
    Returns, by path, the errors, launches, wall ms and digests of what is
    replicated."""
    import functools

    import torch

    from flashattention_kernel_project_tpu_torch import models, parallel
    from flashattention_kernel_project_tpu_torch.models import transformer as tfm
    from flashattention_kernel_project_tpu_torch.ops import flash_attention as fa
    from flashattention_kernel_project_tpu_torch.ops.quant import quantize_kv
    from flashattention_kernel_project_tpu_torch.parallel.mesh import shard
    from flashattention_kernel_project_tpu_torch.utils.sharding import P

    device = torch.device(device_type, 0 if device_type == "cuda" else None)
    if device.type == "cuda":
        torch.cuda.set_device(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    def counted(fn):
        """fn() with the counters at 0 just before: (result, launches, ms)."""
        sync()
        reset_counters()
        t0 = time.perf_counter()
        res = fn()
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        return res, {k: n for k, n in read_counters().items() if n}, ms

    def loss_of(o):
        o = o.float()
        return (o * o.cos()).sum()

    sp = parallel.make_mesh({"sp": world}, device_type=device.type)
    out = {}
    gen = torch.Generator(device=device).manual_seed(21)
    b, hq, hkv, n, d = MESH_TRAIN_RING
    q = torch.randn((b, hq, n, d), generator=gen, device=device).bfloat16()
    k = torch.randn((b, hkv, n, d), generator=gen, device=device).bfloat16()
    v = torch.randn((b, hkv, n, d), generator=gen, device=device).bfloat16()

    # (a) the bf16 ring, forward only, causal and windowed
    for name, window in (("ring", None), ("ring (window)", MESH_TRAIN_WINDOW)):
        fn = parallel.ring_attention(sp, causal=True, data_axis=None,
                                     window=window)
        whole = shard(fa.flash_attention(q, k, v, causal=True, window=window),
                      sp, fn.spec)
        shards = [shard(x, sp, fn.spec) for x in (q, k, v)]
        got, launches, ms = counted(lambda: fn(*shards))
        out[name] = dict(err=[_rel_l2(got, whole)], launches=launches, ms=ms)

    # (a) the trainable ring and (c) Ulysses: the output and the gradients
    # of sum(o cos o) against autograd through the single-device kernel
    qf, kf, vf = (x.clone().requires_grad_() for x in (q, k, v))
    of = fa.flash_attention(qf, kf, vf, causal=True)
    loss_of(of).backward()
    for name, make in (("ring (trainable)", parallel.ring_attention_trainable),
                       ("ulysses", parallel.ulysses_attention)):
        fn = make(sp, causal=True, data_axis=None)
        shards = [shard(x, sp, fn.spec).requires_grad_() for x in (q, k, v)]

        def run():
            o = fn(*shards)
            loss_of(o).backward()
            return o

        got, launches, ms = counted(run)
        err = [_rel_l2(got.detach(), shard(of.detach(), sp, fn.spec))]
        err += [_rel_l2(s.grad, shard(w.grad, sp, fn.spec))
                for s, w in zip(shards, (qf, kf, vf))]
        out[name] = dict(err=err, launches=launches, ms=ms)
    del qf, kf, vf, of, q, k, v

    # (b) the 8-bit ring at config 5's shape
    b, hq, hkv, n, d = MESH_TRAIN_Q8
    q = torch.randn((b, hq, n, d), generator=gen, device=device).bfloat16()
    kq, ks, vq, vs = quantize_kv(
        torch.randn((b, hkv, n, d), generator=gen, device=device).bfloat16(),
        torch.randn((b, hkv, n, d), generator=gen, device=device).bfloat16())
    fn = parallel.ring_attention_kv_quant(sp, causal=True, data_axis=None)
    whole = shard(fa.flash_attention_kv_quant(q, kq, ks, vq, vs, causal=True),
                  sp, fn.spec)
    shards = [shard(x, sp, fn.spec) for x in (q, kq, ks, vq, vs)]
    got, launches, ms = counted(lambda: fn(*shards))
    out["ring (8-bit)"] = dict(err=[_rel_l2(got, whole)], launches=launches, ms=ms)
    del q, kq, ks, vq, vs, whole, shards, got

    # (d) the training steps at bench_train.py's widths and batch, each
    # against one single-device SGD step on this rank
    cfg = tfm.TransformerConfig(**TRAIN, dtype=torch.bfloat16)
    params = tfm.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ)).astype(np.int32)).to(device)
    ref_params, ref_loss = models.sgd_train_step(cfg, params, tokens, lr=TRAIN_LR)
    ref_loss = float(ref_loss)
    tp = parallel.make_mesh({"data": 1, "model": world}, device_type=device.type)
    pipe = parallel.make_mesh({"pipe": world}, device_type=device.type)

    def cp():
        step, _ = parallel.make_cp_train_step(cfg, sp, lr=TRAIN_LR)
        return step, params, None, lambda p: p

    def tp_step():
        step, rules = parallel.make_train_step(cfg, tp, lr=TRAIN_LR)
        return step, parallel.shard_params(params, tp, rules), None, \
            lambda p: parallel.shard_params(p, tp, rules)

    def adamw():
        init, step, rules, _ = parallel.make_optax_train_step(
            cfg, tp, functools.partial(torch.optim.AdamW, **MESH_ADAMW), params,
            clip_norm=MESH_CLIP)
        p = parallel.shard_params(params, tp, rules)
        return step, p, init(p), None

    def pp():
        step, specs = parallel.make_pp_train_step(
            cfg, pipe, n_micro=MESH_TRAIN_MICRO, lr=TRAIN_LR)
        return step, parallel.shard_params(params, pipe, specs), None, \
            lambda p: parallel.shard_params(p, pipe, specs)

    # path -> (the function that builds its step, the tokens' spec on the
    # data axis, the leaves replicated over the path's axis)
    tp_whole = ("embed", "rms_final", "layers.rms_attn", "layers.rms_mlp")
    paths = {"cp step": (cp, None, None),
             "tp step": (tp_step, P("data", None), tp_whole),
             "adamw step": (adamw, P("data", None), tp_whole),
             "pp step": (pp, None, ("embed", "rms_final"))}
    for name, (build, tok_spec, replicated) in paths.items():
        step, p, state, ref_of = build()
        toks = tokens if tok_spec is None else shard(tokens, tp, tok_spec)
        losses, step_ms, first = [], [], None

        def run():
            nonlocal p, state, first
            for i in range(MESH_TRAIN_STEPS):
                sync()
                t0 = time.perf_counter()
                if state is None:
                    p, loss = step(p, toks)
                else:
                    p, state, loss = step(p, state, toks)
                sync()
                step_ms.append((time.perf_counter() - t0) * 1e3)
                losses.append(float(loss))
                if i == 0 and ref_of is not None:
                    # each leaf's distance from sgd_train_step's, and its
                    # update's (p1 - p0) from the reference update
                    ref = tfm._leaves(ref_of(ref_params))
                    p0 = tfm._leaves(ref_of(params))
                    first = {k_: (_rel_l2(x, ref[k_]),
                                  _rel_l2(x.float() - p0[k_].float(),
                                          ref[k_].float() - p0[k_].float()))
                             for k_, x in tfm._leaves(p).items()}

        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        _, launches, _ = counted(run)
        peak = (torch.cuda.max_memory_allocated() / 2**30
                if device.type == "cuda" else None)
        leaves = tfm._leaves(p)
        keep = list(leaves) if replicated is None else [
            k_ for k_ in leaves if k_ in replicated]
        out[name] = dict(losses=losses, ref_loss=ref_loss, step_ms=step_ms,
                         params=first, launches=launches, peak_gib=peak,
                         digest=_digest([leaves[k_] for k_ in keep]
                                        + [torch.tensor(losses)]))
        del step, p, state
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def _mesh_train_expected(name, rank):
    """The launches the schedule predicts on `rank` for the path `name`:
    {counter: count}. The causal ring launches r + 1 forwards (and, when
    trainable, backwards) a call on rank r; the windowed ring at depth 2
    runs the diagonal and, on rank 1, the off-diagonal shard at q_offset
    4096 with the band; Ulysses one forward and one backward; the steps a
    forward and a backward a layer (4 layers), the CP step's ring r + 1 of
    each, the pipeline's stage 2 layers x 4 microbatches with its forwards
    recomputed (remat); 3 steps."""
    layers, steps = TRAIN["n_layers"], MESH_TRAIN_STEPS
    ring = _ring_launches(rank)

    def fwd_bwd(fwd, bwd):
        return {"flash_fwd": fwd, "flash_bwd": bwd, "flash_bwd/split": bwd}

    stage_layers = layers // MESH_WORLD
    pp = steps * stage_layers * MESH_TRAIN_MICRO
    return {
        "ring": {"flash_fwd": ring},
        "ring (window)": {"flash_fwd": ring, "flash_fwd/window": ring},
        "ring (trainable)": fwd_bwd(ring, ring),
        "ring (8-bit)": {"flash_fwd_q": ring},
        "ulysses": fwd_bwd(1, 1),
        "cp step": fwd_bwd(steps * layers * ring, steps * layers * ring),
        "tp step": fwd_bwd(steps * layers, steps * layers),
        "adamw step": fwd_bwd(steps * layers, steps * layers),
        "pp step": fwd_bwd(2 * pp, pp),
    }[name]


def phase_mesh_train(device, label):
    """Context-parallel and multi-device training with two ranks on the one
    card (spawned, one process each, gloo, as phase_mesh; this process
    built the kernels first): (a) ring_attention causal and with window
    MESH_TRAIN_WINDOW, ring_attention_trainable at 1 x 16/4 x 8192 x 128
    bf16 in two shards of 4096, (b) ring_attention_kv_quant at BASELINE
    config 5's shape in two shards of 16384, (c) ulysses_attention at (a)'s
    shape, each against the single-device kernel on the whole sequence
    (rel-L2 RING_TOL: outputs, and dq, dk, dv of sum(o cos o)); (d)
    make_cp_train_step (sp 2), make_train_step (data 1 x model 2),
    make_optax_train_step (AdamW, clip_norm MESH_CLIP) and
    make_pp_train_step (2 stages of 2 layers, 4 microbatches) at
    bench_train.py's model and batch (4 x 4096, seed 0), 3 steps each: the
    first loss within STEP_TOL of models.loss_fn's on the same params and
    tokens, the SGD steps' params after step 1 within STEP_TOL (rel-L2 a
    leaf) of sgd_train_step's, losses falling, the replicated params and
    the losses bit-equal on both ranks. Every path's launches of the
    forward, backward and 8-bit forward on each rank must equal what its
    schedule predicts. Times are two ranks sharing one card over gloo,
    not a multi-device speed. Returns the launches by path and rank."""
    from flashattention_kernel_project_tpu_torch.utils.testing import run_ranks

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ranks = run_ranks(mesh_train_rank, MESH_WORLD, device.type, tmpdir=tmp,
                          timeout=600.0)
    wall = time.perf_counter() - t0
    failures = []
    for name in ranks[0]:
        runs = [r[name] for r in ranks]
        for rank, run in enumerate(runs):
            want = _mesh_train_expected(name, rank)
            got = {k: run["launches"].get(k, 0) for k in want}
            if device.type == "cuda" and got != want:
                failures.append(f"{name}: rank {rank} launched {got}, the "
                                f"schedule predicts {want} (all: {run['launches']})")
        if "err" in runs[0]:
            errs = [run["err"] for run in runs]
            if max(max(e) for e in errs) > RING_TOL:
                failures.append(f"{name}: rel-L2 {errs} > {RING_TOL}")
            what = "output" if len(errs[0]) == 1 else "output, dq, dk, dv"
            ms = [round(run["ms"], 2) for run in runs]
            log(f"mesh train {name}: {what} rel-L2 against the single-device "
                f"kernel on the whole sequence, per rank "
                f"{[[f'{x:.2e}' for x in e] for e in errs]} (<= {RING_TOL}) | "
                f"launches per rank {[run['launches'] for run in runs]} | "
                f"{ms} ms a call per rank, two ranks sharing one card over "
                f"gloo [{label}]")
            continue
        losses = [run["losses"] for run in runs]
        first = abs(losses[0][0] - runs[0]["ref_loss"]) / abs(runs[0]["ref_loss"])
        if first > STEP_TOL:
            failures.append(f"{name}: first loss {losses[0][0]} against "
                            f"loss_fn's {runs[0]['ref_loss']} ({first:.2e})")
        if not losses[0][-1] < losses[0][0]:
            failures.append(f"{name}: losses {losses[0]} do not fall")
        if runs[1]["digest"] != runs[0]["digest"]:
            failures.append(f"{name}: the replicated params or losses differ "
                            "between the ranks")
        held = "n/a (AdamW)"
        if runs[0]["params"] is not None:
            dist_ = {f"{rank}:{k}": e for rank, run in enumerate(runs)
                     for k, e in run["params"].items()}
            bad = {k: e[0] for k, e in dist_.items() if e[0] > STEP_TOL}
            if bad:
                failures.append(f"{name}: params after step 1 off sgd_train_step"
                                f"'s: {bad} > {STEP_TOL}")
            worst = max(dist_.items(), key=lambda kv: kv[1][0])
            upd = max(dist_.items(), key=lambda kv: kv[1][1])
            held = (f"{worst[1][0]:.2e} ({worst[0]}); the update p1 - p0 "
                    f"against the reference update, largest {upd[1][1]:.2e} "
                    f"({upd[0]}), not gated")
        step_ms = [run["step_ms"] for run in runs]
        log(f"mesh train {name}: losses {losses[0]} (equal on both ranks, "
            f"replicated params bit-equal), first against loss_fn "
            f"{first:.2e} (<= {STEP_TOL}); params after step 1 against "
            f"sgd_train_step, largest rel-L2 {held} | ms per step per rank "
            f"{[[f'{x:.1f}' for x in m] for m in step_ms]}, two ranks sharing "
            f"one card over gloo, not a multi-device speed; peak GiB per rank "
            f"{[run['peak_gib'] and round(run['peak_gib'], 2) for run in runs]}"
            f" | launches per rank {[run['launches'] for run in runs]} [{label}]")
    log(f"mesh train phase: {wall:.1f} s (spawn, (a)-(d)) [{label}]")
    if failures:
        raise AssertionError("phase_mesh_train:\n" + "\n".join(failures))
    return {name: [r[name]["launches"] for r in ranks] for name in ranks[0]}


# ---------------------------------------------------------------------------
# Expert parallelism and sharded checkpoints over a device mesh: phase_moe's
# model on two ranks of the one card over gloo, as phase_mesh. Every time
# here is two ranks sharing one card over gloo, not a multi-device speed.
# ---------------------------------------------------------------------------

EP_TOL = 1e-5  # make_ep_moe against moe_ffn on one device (tests/test_moe.py:96)


class StepPin(RoutePin):
    """RoutePin's rule for one decode step of two paths: the reference
    takes, at each layer, the experts the other path's step chose (`calls`,
    moe_choices' record of it), and each pin must be a near-tie."""

    def __init__(self, cfg, calls):
        self.k, self.n_prompt, self.flips, self.eps = cfg.moe_top_k, 0, [], 0.0
        self.want = [(lp[None], ch[None]) for lp, ch in calls]


def _route_margin(logp, k: int) -> float:
    """The k-th minus the (k+1)-th router log-probability of a token."""
    top = logp.topk(k + 1).values
    return float(top[k - 1] - top[k])


def trace_picks(sched, calls, cfg) -> dict:
    """Wrap a Scheduler's _pick: for each token it picks, by request uid in
    order, (the top1 - top2 margin of the logits it picked from, the
    smallest top-k router margin over the layers of the decode step that
    made them, for the token's own slot; None for a first token, which a
    prefill makes). `calls` is moe_choices' record, which the decode step's
    layers extend before the pick. Returns the dict it fills."""
    orig, by_uid, n = sched._pick, {}, cfg.n_layers

    def pick(logits, temps=None):
        top = logits.float().topk(2, dim=-1).values
        gaps = (top[:, 0] - top[:, 1]).tolist()
        if temps is not None:  # a first token: the request being inserted
            req = next(r for r in sched.slots if r is not None and not r.generated)
            by_uid.setdefault(req.uid, []).append((gaps[0], None))
        else:
            step = calls[-n:]
            for i, req in enumerate(sched.slots):
                if req is not None:
                    route = min(_route_margin(lp[i], cfg.moe_top_k) for lp, _ in step)
                    by_uid.setdefault(req.uid, []).append((gaps[i], route))
        return orig(logits, temps)

    sched._pick = pick
    return by_uid


def moe_tie_bounds(cfg, params, prefix, quantized=False):
    """NearTie's bounds for an MoE model: eps, the largest logit difference
    between a fresh prefill of `prefix` and a prefill of all but its last
    token plus one decode step (over an int8 cache when `quantized`), and
    eps_route, the largest router log-probability difference of the last
    token between the two where they choose the same experts, both at
    capacity factor E / top_k, where neither path drops a token (a prefill
    drops by capacity, a decode step of 8 slots never does). Returns
    (eps, max(8 eps, 1e-3), eps_route, max(8 eps_route, 1e-3))."""
    import torch

    from flashattention_kernel_project_tpu_torch.models import engine

    cfg = dataclasses.replace(
        cfg, moe_capacity_factor=cfg.moe_experts / cfg.moe_top_k)
    device = params["embed"].device
    tokens = torch.as_tensor(np.asarray(prefix, np.int32)[None], device=device)
    with moe_choices() as fresh:
        cache = engine.init_cache(cfg, 1, len(prefix) + 1, device)
        full, _ = engine.prefill(cfg, params, tokens, cache)
    cache = engine.init_cache(cfg, 1, len(prefix) + 1, device,
                              quantized=quantized)
    engine.prefill(cfg, params, tokens[:, :-1], cache)
    with moe_choices() as step_calls:
        step, _ = engine.decode_step(cfg, params, tokens[0, -1:], cache)
    eps = float((full - step).abs().max())
    eps_route = 0.0
    for (lp_a, ch_a), (lp_b, ch_b) in zip(fresh, step_calls):
        if torch.equal(ch_a[-1].sort().values, ch_b[0].sort().values):
            eps_route = max(eps_route, float((lp_a[-1] - lp_b[0]).abs().max()))
    return eps, max(8.0 * eps, 1e-3), eps_route, max(8.0 * eps_route, 1e-3)


def moe_audit(streams, refs, margins, bound, route_bound, what):
    """The near-tie audit for an MoE model's token streams against a
    reference's: at each first divergence the reference's own top1 - top2
    logit margin must be within `bound` (moe_tie_bounds), or a router
    margin of the request's
    decode steps so far within `route_bound` (RoutePin's rule: top-k routing
    is discontinuous, and a near-tied choice that flips moves a token's
    output past any rounding). Returns (windows, [(logit margin, smallest
    router margin)] at the divergences); raises past both bounds."""
    windows, sites, bad = [], [], []
    for got, want, marg in zip(streams, refs, margins):
        diff = [j for j, (a, b) in enumerate(zip(got, want)) if a != b]
        windows.append(diff[0] if diff else len(want))
        if not diff:
            continue
        t = diff[0]
        routes = [r for _, r in marg[:t + 1] if r is not None]
        site = (marg[t][0], min(routes) if routes else None)
        sites.append(site)
        if not (site[0] <= bound or (site[1] is not None and site[1] <= route_bound)):
            bad.append((t, site))
    if bad:
        raise AssertionError(
            f"{what}: divergence at a site that is not a near-tie: (position, "
            f"(logit margin, router margin)) {bad}, bounds {bound:.2e} and "
            f"{route_bound:.2e}")
    return windows, sites


def _rank_block(x, spec, axes: dict, rank: int):
    """The block of the whole tensor x that `rank` holds under `spec` on a
    row-major mesh of `axes` (parallel.mesh.shard's cut, without a mesh)."""
    coords = dict(zip(axes, np.unravel_index(rank, tuple(axes.values()))))
    for dim, axis in enumerate(spec or ()):
        if axis in axes:
            size = x.shape[dim] // axes[axis]
            x = x.narrow(dim, int(coords[axis]) * size, size)
    return x


MESH_MOE_TP = {"data": 1, "model": MESH_WORLD}


def mesh_moe_rank(rank, world, device_type, prompts, max_new, ckpt):
    """One rank of phase_mesh_moe, on the card beside the other, each path
    with every launch counter at 0 just before it: (a) make_ep_moe over
    {"expert": world} on TRAIN_BATCH x TRAIN_SEQ hidden states, forward and
    the backward of mean(y^2), against moe_ffn on one device; (b)
    make_train_step and make_optax_train_step (AdamW) on the MoE decoder
    over data 1 x model `world` with remat, MESH_TRAIN_STEPS steps each,
    against loss_fn and sgd_train_step, the AdamW run checkpointed after
    step 2 into `ckpt` (DTensors through torch.distributed.checkpoint),
    restored into the mesh and its step 3 taken again; (c)
    Scheduler(seq_mesh=) over the model with bf16 and int8 caches, and
    (rank 0) the same Scheduler on a one-rank mesh, the single-device
    reference; the SP engine's decode logits against the single-device
    engine's on the same slots, routed alike where near-tied (StepPin).
    Returns, by path, the errors, launches, times and digests."""
    import functools

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from flashattention_kernel_project_tpu_torch import models, parallel
    from flashattention_kernel_project_tpu_torch.models import checkpoint as ck
    from flashattention_kernel_project_tpu_torch.models import engine, moe
    from flashattention_kernel_project_tpu_torch.models import transformer as tfm
    from flashattention_kernel_project_tpu_torch.models.serving import Scheduler
    from flashattention_kernel_project_tpu_torch.parallel.mesh import shard
    from flashattention_kernel_project_tpu_torch.utils.sharding import P

    device = torch.device(device_type, 0 if device_type == "cuda" else None)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False  # routing reads near-ties

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    def counted(fn):
        """fn() with the counters at 0 just before: (result, launches, ms)."""
        sync()
        reset_counters()
        t0 = time.perf_counter()
        res = fn()
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        return res, {k: n for k, n in read_counters().items() if n}, ms

    def peak_gib():
        return (torch.cuda.max_memory_allocated() / 2**30
                if device.type == "cuda" else None)

    def reset_peak():
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    cfg = tfm.TransformerConfig(**MOE_TRAIN, dtype=torch.bfloat16)
    params = tfm.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device)
    out = {}

    # (a) make_ep_moe on layer 0's experts, against moe_ffn on one device
    mcfg = moe.MoEConfig(d_model=cfg.d_model, d_ff=cfg.d_ff,
                         num_experts=cfg.moe_experts, top_k=cfg.moe_top_k,
                         capacity_factor=cfg.moe_capacity_factor)
    layer = tfm.layer_params(params, 0)
    whole = {"w_gate": layer["moe_router"], "w1": layer["moe_w1"].float(),
             "w2": layer["moe_w2"].float()}
    gen = torch.Generator(device=device).manual_seed(23)
    x = torch.randn((TRAIN_BATCH, TRAIN_SEQ, cfg.d_model), generator=gen,
                    device=device)
    ref = {k: w.clone().requires_grad_() for k, w in whole.items()}
    xr = x.clone().requires_grad_()
    y = moe.moe_ffn(ref, xr, mcfg)
    (y * y).mean().backward()
    emesh = parallel.make_mesh({"expert": world}, device_type=device.type)
    especs = models.moe_param_shardings(mcfg)
    mine = {k: w.clone().requires_grad_()
            for k, w in parallel.shard_params(whole, emesh, especs).items()}
    xe = x.clone().requires_grad_()
    fn = models.make_ep_moe(emesh, mcfg)
    reset_peak()

    def ep():
        ye = fn(mine, xe)
        (ye * ye).mean().backward()
        return ye.detach()

    ye, launches, ms = counted(ep)
    err = {"output": _rel_l2(ye, y.detach())}
    err.update({k: _rel_l2(w.grad, shard(ref[k].grad, emesh, especs[k]))
                for k, w in mine.items()})
    err["x"] = _rel_l2(xe.grad, xr.grad)
    out["ep"] = dict(err=err, ms=ms, peak_gib=peak_gib(), launches=launches,
                     digest=_digest([ye]),
                     replicated=_digest([mine["w_gate"].grad, xe.grad]),
                     e_local=mine["w1"].shape[0])
    del ref, xr, y, mine, xe, ye, x, whole, fn

    # (b) the TP steps' MoE branch at bench_train.py's batch
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ)).astype(np.int32)).to(device)
    ref_params, ref_loss = models.sgd_train_step(cfg, params, tokens, lr=TRAIN_LR)
    ref_loss = float(ref_loss)
    tp = parallel.make_mesh(MESH_MOE_TP, device_type=device.type)
    toks = shard(tokens, tp, P("data", None))
    replicated = ("embed", "rms_final", "layers.rms_attn", "layers.rms_mlp",
                  "layers.moe_router")

    step, rules = parallel.make_train_step(cfg, tp, lr=TRAIN_LR, remat=True)
    p = parallel.shard_params(params, tp, rules)
    losses, step_ms, first = [], [], None
    reset_peak()

    def sgd():
        nonlocal p, first
        for i in range(MESH_TRAIN_STEPS):
            sync()
            t0 = time.perf_counter()
            p, loss = step(p, toks)
            sync()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss))
            if i == 0:
                want = tfm._leaves(parallel.shard_params(ref_params, tp, rules))
                first = {k: _rel_l2(x_, want[k])
                         for k, x_ in tfm._leaves(p).items()}

    _, launches, _ = counted(sgd)
    leaves = tfm._leaves(p)
    out["tp step"] = dict(
        losses=losses, ref_loss=ref_loss, step_ms=step_ms, params=first,
        launches=launches, peak_gib=peak_gib(),
        digest=_digest([leaves[k] for k in replicated] + [torch.tensor(losses)]))
    del p, leaves, ref_params, step

    init, ostep, rules, sspecs = parallel.make_optax_train_step(
        cfg, tp, functools.partial(torch.optim.AdamW, **MESH_ADAMW), params,
        clip_norm=MESH_CLIP, remat=True)
    p = parallel.shard_params(params, tp, rules)
    s = init(p)
    losses, step_ms, io = [], [], {}
    reset_peak()

    def adamw():
        nonlocal p, s
        for i in range(MESH_TRAIN_STEPS):
            if i == MESH_TRAIN_STEPS - 1:
                # a sharded checkpoint of the state before the last step
                sync()
                t0 = time.perf_counter()
                ck.save_checkpoint(
                    ckpt, ck.to_dtensors(p, tp, rules), step=i,
                    opt_state=ck.to_dtensors(s, tp, ck.optimizer_specs(s, sspecs)),
                    config=cfg)
                io["save_s"] = time.perf_counter() - t0
                # the step updates the optimizer's state in place: digest
                # the saved shards now
                io["saved"] = dict(
                    params={k: _digest([x_]) for k, x_ in tfm._leaves(p).items()},
                    state={i_: {n: _digest([v]) for n, v in e.items()}
                           for i_, e in s["state"].items()})
                saved_p, saved_s = p, s
            sync()
            t0 = time.perf_counter()
            p, s, loss = ostep(p, s, toks)
            sync()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss))
        sync()
        t0 = time.perf_counter()
        got = ck.restore_checkpoint(
            ckpt, params_template=ck.to_dtensors(saved_p, tp, rules),
            opt_state_template=ck.to_dtensors(
                saved_s, tp, ck.optimizer_specs(saved_s, sspecs)))
        sync()
        io["restore_s"] = time.perf_counter() - t0
        p3, _, loss3 = ostep(ck.from_dtensors(got["params"]),
                             ck.from_dtensors(got["opt_state"]), toks)
        leaves = tfm._leaves(p)
        io["resumed"] = (float(loss3) == losses[-1] and _digest(
            list(tfm._leaves(p3).values())) == _digest(list(leaves.values())))
        io["step"] = got["step"]

    _, launches, _ = counted(adamw)
    leaves = tfm._leaves(p)
    out["adamw step"] = dict(
        losses=losses, ref_loss=ref_loss, step_ms=step_ms, params=None,
        launches=launches, peak_gib=peak_gib(), sspecs=sspecs, **io,
        digest=_digest([leaves[k] for k in replicated] + [torch.tensor(losses)]))
    del p, s, leaves, ostep, init
    reset_peak()

    # (c) Scheduler(seq_mesh=) over the MoE model; rank 0 also serves the
    # same requests on a one-rank mesh (every rank makes every group)
    sp = parallel.make_mesh({"sp": world}, device_type=device.type)
    solo = [dist.new_group([r], backend=dist.get_backend()) for r in range(world)]
    one = DeviceMesh.from_group(solo[rank], device.type, mesh_dim_names=("sp",))
    for quantized in (False, True):
        kw = dict(max_batch=8, max_len=2048, quantized_cache=quantized)
        warm = Scheduler(cfg, params, seq_mesh=sp, **kw)
        warm.submit(prompts[0][:8], max_new_tokens=4)
        warm.run()
        del warm
        sched = Scheduler(cfg, params, seq_mesh=sp, **kw)

        def serve(sched=sched):
            uids = [sched.submit(p_, max_new_tokens=max_new) for p_ in prompts]
            res = sched.run()
            return [res[u] for u in uids]

        tokens_sp, launches, ms = counted(serve)
        name = f"sp ({'int8' if quantized else 'bf16'})"
        out[name] = dict(tokens=tokens_sp, launches=launches, wall=ms / 1e3,
                         cache_rows=sched.cache.k[0].shape[2], ref=None)
        del sched
        if rank == 0:
            sched = Scheduler(cfg, params, seq_mesh=one, **kw)
            with moe_choices() as calls:
                margins = trace_picks(sched, calls, cfg)
                uids = [sched.submit(p_, max_new_tokens=max_new) for p_ in prompts]
                res = sched.run()
            out[name]["ref"] = [res[u] for u in uids]
            out[name]["margins"] = [margins[u] for u in uids]
            del sched, calls

        # the SP engine's decode logits against the single-device engine's
        # (split parameters) on the same prefilled slots, the reference
        # routed as the SP step where they differ (each a near-tie)
        gen = torch.Generator(device=device).manual_seed(11)
        prompt = torch.randint(0, cfg.vocab_size, (8, 128), generator=gen,
                               device=device, dtype=torch.int32)
        full = engine.init_cache(cfg, 8, 256, device, quantized=quantized)
        ref_pre, full = engine.prefill(cfg, params, prompt, full)
        nxt = ref_pre.argmax(-1).to(torch.int32)
        spec = parallel.tp_engine.sp_cache_specs(cfg.n_layers, quantized=quantized)
        scache = parallel.init_sp_cache(cfg, sp, 8, 256, quantized=quantized)
        pairs = [(scache.k + scache.v, full.k + full.v, spec.k + spec.v)]
        if quantized:
            pairs.append((scache.k_scale + scache.v_scale,
                          full.k_scale + full.v_scale, spec.k_scale + spec.v_scale))
        for dsts, srcs, specs in pairs:
            for dst, src, sp_ in zip(dsts, srcs, specs):
                dst.copy_(shard(src, sp, sp_))
        scache.lengths.copy_(full.lengths)
        with moe_choices() as calls:
            sp_dec, _ = parallel.make_sp_decode_step(cfg, sp)(params, nxt, scache)
        pin = StepPin(cfg, calls)
        with moe_choices(pin):
            ref_dec, _ = engine.decode_step(cfg, params, nxt, full)
        pin.audit(f"mesh MoE SP decode step ({name})")
        out[name]["logits"] = dict(
            rel_l2=_rel_l2(sp_dec, ref_dec), flips=pin.flips,
            max_abs=float((sp_dec - ref_dec).abs().max()))
        del full, scache, calls
    return out


def _mesh_moe_expected(name):
    """The forwards and backwards the TP steps launch on each rank: one of
    each a layer a step, the forward again in the backward (remat); the
    AdamW path takes its last step twice (from the checkpoint)."""
    steps = MESH_TRAIN_STEPS + (name == "adamw step")
    n = steps * MOE_TRAIN["n_layers"]
    return {"flash_fwd": 2 * n, "flash_bwd": n, "flash_bwd/split": n}


def phase_mesh_moe(device, label):
    """Expert parallelism and sharded checkpoints with two ranks on the one
    card (spawned, one process each, gloo, as phase_mesh): bench_train.py
    --moe-experts 8's model (MOE_TRAIN, bf16, seed 0, TF32 off) through
    (a) make_ep_moe over {"expert": 2} on 4 x 4096 hidden states, forward
    and backward, against moe_ffn on one device (output and every gradient
    within EP_TOL rel-L2, the outputs bit-equal on both ranks); (b)
    make_train_step and make_optax_train_step (AdamW, clip MESH_CLIP) over
    data 1 x model 2 with remat at bench_train.py's batch, 3 steps each:
    the first loss within STEP_TOL of loss_fn's, the SGD params after step
    1 within STEP_TOL of sgd_train_step's, losses falling, the replicated
    params and the losses bit-equal on both ranks, the launches of the
    forward and both backward kernels as the schedule predicts; the AdamW
    run saved as a sharded checkpoint before step 3, restored into the mesh
    and its step 3 taken again bit for bit, and the checkpoint restored
    onto one device in this process equal, bit for bit, to the ranks'
    shards put together; (c) Scheduler(seq_mesh=) over the model, 8
    serving requests x 64 tokens, max_len 2048 (1024-row shards), bf16 and
    int8 caches: the tokens equal on both ranks, every first divergence
    from the same Scheduler on one rank passing the MoE near-tie audit
    (`moe_audit`: the reference's own logit margin there within 8 eps, or
    a router margin of the request's steps within 8 eps_route, both from
    `moe_tie_bounds`), the SP decode logits within LOGITS_TOL of the
    single-device engine's, rows 1 and 6 / 7 launched on every rank. Times are two ranks sharing one card
    over gloo, not a multi-device speed. Returns the launches by path and
    rank."""
    import torch

    from flashattention_kernel_project_tpu_torch.models import checkpoint as ck
    from flashattention_kernel_project_tpu_torch.models import transformer as tfm
    from flashattention_kernel_project_tpu_torch.utils.testing import run_ranks

    t0 = time.perf_counter()
    cfg = tfm.TransformerConfig(**MOE_TRAIN, dtype=torch.bfloat16)
    prompts = serving_prompts(cfg, MESH_REQUESTS)
    max_new = 64
    failures = []
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "ckpt")
        ranks = run_ranks(mesh_moe_rank, MESH_WORLD, device.type, prompts,
                          max_new, ckpt, tmpdir=tmp, timeout=900.0)
        t1 = time.perf_counter()
        # the sharded checkpoint restored onto one device
        params = tfm.init_params(
            cfg, torch.Generator(device=device).manual_seed(0), device)
        leaves = tfm._leaves(params)
        template = tfm._unflatten({k: torch.zeros_like(v) for k, v in leaves.items()})
        # AdamW's state of parameter i (its leaf in order), param_groups
        # left out: a template may ask for part of a sharded item
        opt_template = {"state": {
            i: {"step": torch.zeros(()), "exp_avg": torch.zeros_like(v),
                "exp_avg_sq": torch.zeros_like(v)}
            for i, v in enumerate(leaves.values())}}
        del params, leaves
        t2 = time.perf_counter()
        got = ck.restore_checkpoint(ckpt, params_template=template,
                                    opt_state_template=opt_template)
        if device.type == "cuda":
            torch.cuda.synchronize()
        one_s = time.perf_counter() - t2
        del template, opt_template
    whole = tfm._leaves(got["params"])
    state = got["opt_state"]["state"]
    specs = tfm._leaves(tfm.param_shardings(cfg))
    sspecs = ranks[0]["adamw step"]["sspecs"]
    for rank, r in enumerate(ranks):
        saved = r["adamw step"]["saved"]
        bad = [k for k, d in saved["params"].items()
               if _digest([_rank_block(whole[k], specs[k], MESH_MOE_TP, rank)]) != d]
        bad += [f"state {i}.{n}" for i, e in saved["state"].items()
                for n, d in e.items()
                if _digest([_rank_block(state[i][n], sspecs[i]
                                        if state[i][n].dim() else None,
                                        MESH_MOE_TP, rank)]) != d]
        if bad:
            failures.append(f"checkpoint on one device: rank {rank}'s shards "
                            f"differ in {bad}")
    del got, whole, state
    log(f"mesh MoE checkpoint: saved before AdamW step {ranks[0]['adamw step']['step'] + 1} "
        f"as DTensors through torch.distributed.checkpoint in "
        f"{[round(r['adamw step']['save_s'], 2) for r in ranks]} s a rank, "
        f"restored into the mesh in "
        f"{[round(r['adamw step']['restore_s'], 2) for r in ranks]} s, the "
        f"step taken again bit-equal {[r['adamw step']['resumed'] for r in ranks]}"
        f"; restored onto one device here in {one_s:.2f} s, equal bit for "
        f"bit to both ranks' shards put together: {not failures} (warm "
        f"file cache; two ranks sharing one card over gloo) [{label}]")
    if not all(r["adamw step"]["resumed"] for r in ranks):
        failures.append("checkpoint: the resumed step differs from the "
                        "uninterrupted one")

    # (a)
    eps = [r["ep"] for r in ranks]
    for rank, e in enumerate(eps):
        big = {k: v for k, v in e["err"].items() if not v <= EP_TOL}
        if big:
            failures.append(f"make_ep_moe: rank {rank} rel-L2 {big} > {EP_TOL}")
    if eps[1]["digest"] != eps[0]["digest"]:
        failures.append("make_ep_moe: the ranks' outputs differ")
    log(f"mesh MoE make_ep_moe: {TRAIN_BATCH} x {TRAIN_SEQ} tokens of d_model "
        f"{cfg.d_model}, {cfg.moe_experts} experts over 2 ranks ({eps[0]['e_local']} "
        f"a rank), sort dispatch (auto); against moe_ffn on one device, "
        f"rel-L2 per rank (output and the gradients of mean(y^2)) "
        f"{[{k: f'{v:.2e}' for k, v in e['err'].items()} for e in eps]} (<= "
        f"{EP_TOL}); outputs bit-equal on both ranks, w_gate's and x's "
        f"gradients bit-equal {eps[0]['replicated'] == eps[1]['replicated']} "
        f"| forward + backward {[round(e['ms'], 2) for e in eps]} ms per rank"
        f", peak GiB {[e['peak_gib'] and round(e['peak_gib'], 2) for e in eps]}"
        f", two ranks sharing one card over gloo [{label}]")

    # (b)
    launches = {}
    for name in ("tp step", "adamw step"):
        runs = [r[name] for r in ranks]
        want = _mesh_moe_expected(name)
        for rank, run in enumerate(runs):
            have = {k: run["launches"].get(k, 0) for k in want}
            if device.type == "cuda" and have != want:
                failures.append(f"{name}: rank {rank} launched {have}, the "
                                f"schedule predicts {want} (all: {run['launches']})")
        losses = runs[0]["losses"]
        first = abs(losses[0] - runs[0]["ref_loss"]) / abs(runs[0]["ref_loss"])
        if first > STEP_TOL:
            failures.append(f"{name}: first loss {losses[0]} against loss_fn's "
                            f"{runs[0]['ref_loss']} ({first:.2e})")
        if not losses[-1] < losses[0]:
            failures.append(f"{name}: losses {losses} do not fall")
        if runs[1]["digest"] != runs[0]["digest"]:
            failures.append(f"{name}: the replicated params or losses differ "
                            "between the ranks")
        held = "n/a (AdamW)"
        if runs[0]["params"] is not None:
            errs = {f"{rank}:{k}": e for rank, run in enumerate(runs)
                    for k, e in run["params"].items()}
            bad = {k: e for k, e in errs.items() if e > STEP_TOL}
            if bad:
                failures.append(f"{name}: params after step 1 off "
                                f"sgd_train_step's: {bad} > {STEP_TOL}")
            worst = max(errs.items(), key=lambda kv: kv[1])
            held = f"{worst[1]:.2e} ({worst[0]})"
        launches[name] = [run["launches"] for run in runs]
        log(f"mesh MoE {name} (data 1 x model 2, {cfg.moe_experts // 2} experts "
            f"a rank, dense dispatch, remat): losses {losses} (equal on both "
            f"ranks, replicated params bit-equal), first against loss_fn "
            f"{first:.2e} (<= {STEP_TOL}); params after step 1 against "
            f"sgd_train_step, largest rel-L2 {held} | ms per step per rank "
            f"{[[f'{x:.1f}' for x in run['step_ms']] for run in runs]}, two "
            f"ranks sharing one card over gloo, not a multi-device speed; "
            f"peak GiB per rank "
            f"{[run['peak_gib'] and round(run['peak_gib'], 2) for run in runs]}"
            f" | launches per rank {launches[name]} [{label}]")

    # (c)
    params = tfm.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device)
    for name, kernel in (("sp (bf16)", "flash_decode"), ("sp (int8)", "flash_decode_q")):
        runs = [r[name] for r in ranks]
        if runs[1]["tokens"] != runs[0]["tokens"]:
            failures.append(f"mesh MoE {name}: the two ranks' tokens differ")
        for rank, run in enumerate(runs):
            missing = [k for k in ("flash_fwd", kernel) if not run["launches"].get(k)]
            if device.type == "cuda" and missing:
                failures.append(f"mesh MoE {name}: rank {rank} never launched "
                                f"{missing}: {run['launches']}")
            if len(run["tokens"]) != len(prompts) or any(
                    len(t_) != max_new for t_ in run["tokens"]):
                failures.append(f"mesh MoE {name}: rank {rank} returned short "
                                "streams")
        lg = runs[0]["logits"]
        if max(run["logits"]["rel_l2"] for run in runs) > LOGITS_TOL:
            failures.append(f"mesh MoE {name}: SP decode logits off the "
                            f"single-device engine's: "
                            f"{[run['logits']['rel_l2'] for run in runs]} > {LOGITS_TOL}")
        ref = runs[0]["ref"]
        eps, bound, eps_route, route_bound = moe_tie_bounds(
            cfg, params, list(prompts[0]) + ref[0][:1], quantized="int8" in name)
        windows, sites = moe_audit(runs[0]["tokens"], ref, runs[0]["margins"],
                                   bound, route_bound, f"mesh MoE {name}")
        same = np.mean([a == b for x, y in zip(runs[0]["tokens"], ref)
                        for a, b in zip(x, y)])
        toks = sum(len(t_) for t_ in runs[0]["tokens"])
        errs = [f"{run['logits']['rel_l2']:.2e}" for run in runs]
        log(f"mesh MoE {name}: {len(prompts)} requests x {max_new} tokens on "
            f"{MESH_WORLD} ranks (seq_mesh, cache rows a rank "
            f"{runs[0]['cache_rows']}); tokens equal on both ranks; equal to "
            f"the same Scheduler on one rank {same:.4f}, agreement windows "
            f"{windows}, (logit margin, smallest router margin) at the "
            f"divergences {[(f'{m:.2e}', r_ and f'{r_:.2e}') for m, r_ in sites]}"
            f" (bounds {bound:.2e}, {route_bound:.2e}: 8 x eps {eps:.2e}, "
            f"{eps_route:.2e}) | SP decode "
            f"step on 8 x 128 prefilled rows against the single-device engine: "
            f"logits rel-L2 per rank {errs} (<= {LOGITS_TOL}), max-abs "
            f"{lg['max_abs']:.2e}, the reference pinned to the SP step's experts at "
            f"(row, step, layer, margin, router log-prob difference) "
            f"{lg['flips']} | {toks} tokens in {runs[0]['wall']:.2f} s = "
            f"{toks / runs[0]['wall']:.1f} tok/s, two ranks sharing one card "
            f"over gloo, not an SP speed | launches per rank "
            f"{[run['launches'] for run in runs]} [{label}]")
        launches[name] = [run["launches"] for run in runs]
    log(f"mesh MoE phase: ranks {t1 - t0:.1f} s (spawn, params, (a), (b), (c)), "
        f"the one-device restore and checks {time.perf_counter() - t1:.1f} s "
        f"[{label}]")
    if failures:
        raise AssertionError("phase_mesh_moe:\n" + "\n".join(failures))
    return launches


BENCH_TOL = 0.15      # chained and device time against time_ms(graph=True)
EAGER_FLOOR = 0.9     # benchmark's eager mean against the same graph time
ROOFLINE_CAP = 1.05   # a share of the roofline past 1 is a timer's fault
BENCH_MIN_DELTA_S = 0.2  # benchmark_chained's delta: ~1-2 s a call


def bench_cases(device):
    """The two calls that phase_benchmarking times: bench.py's headline
    (kernel 1's hybrid instance; flops as bench.py:79 counts them) and
    flash_decode at phase_decode's serving shape and lengths (kernel 6).
    Each: (name, fn of its first argument, that argument, the work given
    to the timers, the kernel's symbol, its launch counter)."""
    import torch

    from flashattention_kernel_project_tpu_torch.ops import flash_attention as fa
    from flashattention_kernel_project_tpu_torch.ops import flash_decode as fd

    B, H, HKV, N, D = 1, 16, 4, 4096, 128
    rng = np.random.default_rng(42)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .to(device).bfloat16()
               for shape in ((B, H, N, D), (B, HKV, N, D), (B, HKV, N, D)))
    k_max = fa.k_max_norm(k)
    head = lambda x: fa.flash_attention(x, k, v, causal=True, stable="auto",  # noqa: E731
                                        k_max=k_max)
    head_work = dict(flops=int(4 * B * H * N * N * D * 0.5),  # bench.py:79
                     bytes_accessed=nbytes(q, k, v, q))
    b, hq, hkv, s, d = 8, 16, 4, 2048, 128
    gen = torch.Generator(device=device).manual_seed(11)  # phase_decode's
    qd = torch.randn(b, hq, d, generator=gen, device=device).bfloat16()
    kc = torch.randn(b, hkv, s, d, generator=gen, device=device).bfloat16()
    vc = torch.randn(b, hkv, s, d, generator=gen, device=device).bfloat16()
    lengths = torch.randint(1, s, (b,), generator=gen, device=device,
                            dtype=torch.int32)
    lengths[0] = 0
    lengths[-1] = s
    live = int(lengths.sum())
    dec = lambda x: fd.flash_decode(x, kc, vc, lengths)  # noqa: E731
    dec_work = dict(flops=4 * live * hq * d,
                    bytes_accessed=nbytes(qd, qd) + 2 * live * hkv * d * 2)
    return [
        ("headline", head, q, head_work, SM90_KERNEL, "flash_fwd/hybrid",
         f"flash_attention(causal, stable=auto, k_max) {B}x{H}/{HKV}x{N}x{D} bf16"),
        ("decode", dec, qd, dec_work, DEC_KERNEL, "flash_decode",
         f"flash_decode b{b} hq{hq} hkv{hkv} s{s} d{d}, {live} live keys"),
    ]


def trace_kernel_us(trace_dir: str, symbol: str) -> tuple:
    """_trace_device_us of the newest trace under trace_dir: its device
    span, and the device us of the ops named after `symbol`; raises if
    none is."""
    from flashattention_kernel_project_tpu_torch.utils.benchmarking import (
        _trace_device_us,
    )

    total, per_op = _trace_device_us(trace_dir)
    mine = {n: us for n, us in per_op.items() if symbol in n}
    if not mine or total <= 0:
        raise AssertionError(f"the trace under {trace_dir} (span {total} us) "
                             f"holds no {symbol}: {sorted(per_op)}")
    return total, sum(mine.values()), len(per_op)


def phase_benchmarking(device, label):
    """utils.benchmarking on the card, its own path with the counters at 0
    before it: the two calls of `bench_cases`, each timed in two turns
    (in order, then in reverse) by benchmark_chained (min_delta_s 0.2),
    benchmark_device (its trace kept and read), benchmark (eager) and
    time_ms(graph=True) over 50 calls a graph (as time_turns: at 10 a
    graph, the host's ~20 us of submitting each replay read as 2 us a
    decode call on an NVIDIA H100 80GB HBM3 at 700 W). Gates: chained and device time within BENCH_TOL
    of the graph time, benchmark's eager mean at least EAGER_FLOOR of it,
    every roofline fraction at most ROOFLINE_CAP, the kernel's own symbol
    in benchmark_device's trace and in capture_trace's, each kernel
    launched; a trace of a CPU call (no device event) and CPU tensors are
    refused. Returns the readings by call."""
    import torch

    from flashattention_kernel_project_tpu_torch.utils import benchmarking as bm

    reset_counters()
    out, counters = {}, []
    with tempfile.TemporaryDirectory(prefix="fkp_bench_") as tmp:
        for name, fn, x, work, symbol, counter, what in bench_cases(device):
            counters.append(counter)
            timers = dict(
                chained=lambda: bm.benchmark_chained(
                    fn, x, name=f"{name} chained", min_delta_s=BENCH_MIN_DELTA_S,
                    **work),
                device=lambda: bm.benchmark_device(
                    fn, x, name=f"{name} device",
                    trace_dir=os.path.join(tmp, f"{name}_device"), **work),
                eager=lambda: bm.benchmark(fn, x, name=f"{name} eager", **work),
                graph=lambda: time_ms(lambda: fn(x), device, iters=50,
                                      graph=True))
            readings = {t: [] for t in timers}
            for order in (list(timers), list(timers)[::-1]):
                for t in order:
                    readings[t].append(timers[t]())
            results = [r for t in ("chained", "device", "eager") for r in readings[t]]
            for r in results:
                log(f"benchmarking: {r.report()} [{label}]")
            ms = {t: min(r if t == "graph" else r.mean_ms for r in rs)
                  for t, rs in readings.items()}
            dev_span, dev_kernel, dev_ops = trace_kernel_us(
                os.path.join(tmp, f"{name}_device"), symbol)
            cap_span, cap_kernel, _ = trace_kernel_us(bm.capture_trace(
                fn, x, trace_dir=os.path.join(tmp, f"{name}_capture")), symbol)
            fracs = [r.roofline_fraction() for r in results]
            ratio = {t: ms[t] / ms["graph"] for t in ("chained", "device", "eager")}
            host = 1 - ms["graph"] / ms["eager"]
            log(f"benchmarking {name} ({what}): chained {ms['chained']:.4f} ms "
                f"(x{ratio['chained']:.3f} graph), device {ms['device']:.4f} "
                f"(x{ratio['device']:.3f}; {readings['device'][0].iters} and "
                f"{readings['device'][1].iters} iterations), eager "
                f"{ms['eager']:.4f} (x{ratio['eager']:.3f}; the host's share "
                f"{host:.1%}), time_ms(graph=True) {ms['graph']:.4f} | roofline "
                f"{min(fracs):.1%}-{max(fracs):.1%} | device trace: span "
                f"{dev_span:.1f} us, {symbol} {dev_kernel:.1f} us of {dev_ops} "
                f"op names; capture_trace: span {cap_span:.1f} us, {symbol} "
                f"{cap_kernel:.1f} us [{label}]")
            misses = [f"{t} x{ratio[t]:.3f}" for t in ("chained", "device")
                      if abs(ratio[t] - 1) > BENCH_TOL]
            if ratio["eager"] < EAGER_FLOOR:
                misses.append(f"eager x{ratio['eager']:.3f} < {EAGER_FLOOR}")
            if max(fracs) > ROOFLINE_CAP:
                misses.append(f"roofline {max(fracs):.3f} > {ROOFLINE_CAP}")
            if misses:
                raise AssertionError(f"benchmarking {name}: {misses} against "
                                     f"time_ms(graph=True) {ms['graph']:.4f} ms")
            out[name] = dict(ms, host_share=host, roofline=max(fracs))
        # a window with no device event is refused, and so are CPU tensors
        cpu = os.path.join(tmp, "cpu")
        bm.capture_trace(torch.mm, *[torch.ones(64, 64)] * 2, trace_dir=cpu)
        for call in (lambda: bm._trace_device_us(cpu),
                     lambda: bm.benchmark_device(torch.mm, torch.ones(8, 8),
                                                 torch.ones(8, 8))):
            try:
                call()
            except ValueError as err:
                log(f"benchmarking: refused as it must: {err}")
            else:
                raise AssertionError("benchmarking read a window or tensors "
                                     "with no device time")
    counts = read_counters()
    launches = {c: counts[c] for c in counters}
    if not all(launches.values()):
        raise AssertionError(f"benchmarking launched no kernel of {launches}")
    log(f"benchmarking launches: {launches} [{label}]")
    return out


def phase_apart(name: str, timeout: int = 600) -> None:
    """chip_smoke's phase `name` in a fresh process (tools/run_phase.py,
    which loads the library this process built), its lines in this
    output; raises if it fails. Device traces taken 640-700 s into this
    script's process held part of their dispatch, where a fresh process's
    held all of it (NVIDIA H100 80GB HBM3, 700 W)."""
    import subprocess

    sys.stdout.flush()
    subprocess.run([sys.executable, os.path.join(ROOT, "tools", "run_phase.py"),
                    name], check=True, timeout=timeout)


class PhaseClock:
    """The run's seconds by phase: `with clock(name):` logs "phase <name>:
    <s> s" as the phase ends; `summary()` gives every phase's seconds and
    the total since the clock started, on one line."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.seconds = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        yield
        s = time.perf_counter() - t0
        self.seconds[name] = self.seconds.get(name, 0.0) + s
        log(f"phase {name}: {s:.1f} s")

    def summary(self) -> str:
        parts = ", ".join(f"{n} {s:.1f}" for n, s in self.seconds.items())
        return (f"phase seconds: {parts}; total "
                f"{time.perf_counter() - self.t0:.1f} s")


# the keys of each kernel in the kernels line (the rest of an entry's
# detail is logged by its phase and in kernel_detail's lines)
KERNEL_KEYS = ("name", "route", "source", "replaces", "launches", "max_abs_err",
               "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")


def _short(v):
    return float(f"{v:.4g}") if isinstance(v, float) else v


def compact(entry: dict) -> dict:
    """A kernel's entry in the kernels line: KERNEL_KEYS (every one must be
    there), numbers to 4 significant digits, and the share of the bound."""
    out = {k: _short(entry[k]) for k in KERNEL_KEYS}
    out["bound_share"] = _short(entry["bound_ms"] / entry["ms"])
    return out


def kernel_detail(entries) -> None:
    """Log each kernel entry whole (shapes, the other timings), before the
    kernels line keeps only KERNEL_KEYS of it."""
    for e in entries:
        log("kernel detail: " + json.dumps(
            {k: _short(v) for k, v in e.items() if k != "launches"},
            separators=(",", ":"), default=str))


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
    clock = PhaseClock()
    sys.path.insert(0, ROOT)
    from flashattention_kernel_project_tpu_torch.models import transformer as tfm
    from flashattention_kernel_project_tpu_torch.ops import _build
    from flashattention_kernel_project_tpu_torch.utils import platform

    # 1. device: alive, a Hopper card
    from flashattention_kernel_project_tpu_torch.utils import health

    alive = health.device_healthcheck()
    log(f"device healthcheck: {alive}")
    if not alive["ok"]:
        print(f"the device failed its healthcheck: {alive}", file=sys.stderr)
        return 3
    name = platform.require_hopper()
    label = platform.card_label()
    log(f"device: {name}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(label)
    device = torch.device("cuda", 0)

    # 2. kernels against their plain versions
    with clock("build"):
        _build.library()
    log(f"kernels built from "
        f"{[os.path.relpath(s, ROOT) for s in _build.kernel_sources()]}")
    with open(os.path.join(_build.BUILD_DIR, "libfkp_kernels.so.log")) as f:
        build_log = f.read()
    kernel = ""  # the entry ptxas reports on
    arg = r"L[ib]\d+E|f|a|13__nv_fp8_e4m3|13__nv_bfloat16"  # template arguments
    types = {"f": "f32", "a": "int8", "13__nv_fp8_e4m3": "e4m3",
             "13__nv_bfloat16": "bf16"}
    for line in build_log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+?)'", line)
        if entry:  # e.g. flash_fwd_q_kernel<128,1,int8,0,1>, gemm_kernel<bf16,1,1>
            name, rest = mangled_name(entry.group(1))
            targs = re.match(rf"I((?:{arg})+)E", rest)
            args = [types.get(a, a[2:-1])
                    for a in re.findall(arg, targs.group(1) if targs else "")]
            kernel = name + (f"<{','.join(args)}>" if args else "")
        if "registers" in line or "spill" in line:
            log(f"ptxas: {kernel}: " + line.split(":", 1)[-1].strip())
    with clock("build_checks"):
        dump_sass(sorted(glob.glob(os.path.join(_build.BUILD_DIR, "*.o"))))
        phase_fwd_sm90_build(build_log, label)
        phase_gemm_sm90_build(build_log, label)
        phase_gemm_f32_build(build_log, label)
        phase_gemm_softmax_build(build_log, label)
        phase_gemm_8bit_build(build_log, label)
        phase_bwd_sm90_build(build_log, label)
        phase_dec_sm90_build(build_log, label)
        phase_dec_q_build(build_log, label)
        phase_ext_sm90_build(build_log, label)
        phase_dec_paged_build(build_log, label)
        phase_ragged_build(build_log, label)
        phase_fwd_q_build(build_log, label)
        phase_probes_build(build_log, label)
    with clock("forward"):
        fwd = phase_forward(device, [
            (1, 16, 4, 4096, 4096, 128, True, 0),  # bench.py's shape
            (1, 16, 4, 512, 512, 128, True, 0),    # the slice's longest prefill
            (1, 16, 4, 1024, 1024, 64, True, 0),   # d=64
            (2, 4, 2, 200, 333, 128, False, 0),    # ragged, non-causal
            (2, 4, 2, 200, 333, 128, True, 133),   # ragged, causal, q_offset
        ], label)
    with clock("fwd_tiles"):
        phase_fwd_tiles(device, label)
    with clock("fwd_sm90_times"):
        phase_fwd_sm90_times(device, label)
    with clock("decode"):
        dec = phase_decode(device, 8, 16, 4, 2048, 128, label)
    with clock("ragged"):
        ragged = phase_ragged(device, [
            # the third chunk of a 768-token prompt at chunk 256 (the slice's)
            (1, 16, 4, 256, 2304, [768], [512], 128, True),
            # per-row raggedness and an empty row
            (4, 16, 4, 64, 1024, [64, 300, 1000, 0], [0, 236, 936, 0], 128, True),
            (2, 4, 2, 200, 512, [333, 512], [133, 312], 64, True),
            (4, 16, 4, 64, 1024, [64, 300, 1000, 0], [0, 236, 936, 0], 128, False),
        ], label)
    with clock("paged_decode"):
        paged = phase_paged_decode(device, [
            # the slice's pool: 16 pages of 128 a slot, 129 pages
            (8, 16, 4, 128, 128, 16, [1, 127, 128, 129, 700, 1500, 2048, 0]),
            (4, 8, 2, 64, 16, 19, [5, 16, 300, 0]),
        ], label)
    with clock("paged_extend"):
        extend = phase_paged_extend(device, [
            EXT_SERVING,  # the slice's verify (T = spec_k + 1)
            (4, 8, 2, 64, 16, 19, 3, [0, 14, 300, 5]),
            # G = 8, T = 9: a folded group of 72 rows, two query tiles
            (2, 16, 2, 128, 64, 16, 9, [33, 900]),
        ], label)
    # the 8-bit kernels (int8 and e4m3) at the same shapes, each beside the
    # bf16 kernel on its dequantized cache
    with clock("decode_8bit"):
        dec_q = phase_decode_8bit(device, 8, 16, 4, 2048, 128, label)
    with clock("paged_decode_8bit"):
        paged_q = phase_paged_decode_8bit(device, 8, 16, 4, 128, 128, 16,
                                          [1, 127, 128, 129, 700, 1500, 2048, 0], label)
    with clock("ragged_8bit"):
        ragged_q = phase_ragged_8bit(device, 1, 16, 4, 256, 2304, [768], [512], 128,
                                     label)
    with clock("paged_extend_8bit"):
        extend_q = phase_paged_extend_8bit(device, [
            EXT_SERVING,
            (8, 16, 4, 128, 16, 128, 5, [0, 1, 12, 15, 16, 700, 1500, 2043]),
        ], label)
    # the band kernels against their plain versions over the same band, and
    # the band skip at run_all.py's long-context shape
    with clock("window_forward"):
        win_fwd = phase_window_forward(device, [
            (1, 16, 4, 4096, 4096, 128, 0, 1024, 64),  # the training shape's band
            (1, 16, 4, 512, 512, 128, 0, 256, 4),      # the slice's longest prefill
            (1, 16, 4, 1024, 1024, 128, 0, 256, 100),  # sinks wider than a key tile
            (1, 16, 4, 512, 2048, 128, 1536, 256, 4),  # q_offset past the window
        ], label, entry_shape=1)
    with clock("band_skip"):
        phase_band_skip(device, label)
    with clock("window_fixed"):
        win_fix = phase_window_fixed(device, label)
    with clock("window_ragged"):
        win_ragged, win_ragged_q = phase_window_ragged(
            device, 1, 16, 4, 256, 2304, [768], [512], 128, SERVING_WINDOW,
            SERVING_SINKS, label)
    with clock("window_decode"):
        win_dec, win_dec_q = phase_window_decode(
            device, 8, 16, 4, 2048, 128, [100, 255, 256, 257, 700, 1500, 2000, 2048],
            SERVING_WINDOW, SERVING_SINKS, label)
    # the fixed-max and hybrid disciplines against their plain versions:
    # kernel 1 fixed-max at bench.py's shape (causal and full) and a ragged
    # one (the 32K windowed one is above), kernel 2's counterpart at
    # run_all.py's d64 rung, kernel 1 hybrid at d=128 and d=64 on bounded,
    # breaching and mixed inputs, kernel 3 fixed-max at the
    # serving chunk, the dense 8-bit forward in each discipline and at
    # BASELINE config 5, then bench.py's headline call
    with clock("fixed"):
        fix_fwd = phase_fixed(device, [
            (1, 16, 4, 4096, 4096, 128, True, 0),   # bench.py's shape
            (1, 16, 4, 4096, 4096, 128, False, 0),  # run_all.py's full rung
            (2, 4, 2, 200, 333, 128, True, 133),    # ragged, causal, q_offset
        ], label)
    with clock("packed"):
        packed = phase_packed(device, 1, 16, 4, 4096, 64, label)
    with clock("hybrid"):
        hyb_fwd = phase_hybrid(device, 1, 16, 4, 4096, 128, label)
    with clock("hybrid_d64"):
        hyb_fwd64 = phase_hybrid(device, 1, 16, 4, 4096, 64, label)  # the d64 rung
    with clock("ragged_fixed"):
        fix_ragged, fix_ragged_q = phase_ragged_fixed(
            device, 1, 16, 4, 256, 2304, [768], [512], 128, label)
    with clock("kv_quant"):
        fwd_q = phase_kv_quant(device, 1, 16, 4, 4096, 128, label)
    with clock("config5"):
        fwd_q["launches"] = phase_config5(device, fwd_q, label)
    with clock("headline"):
        hyb_fwd["launches"] = phase_headline(device, hyb_fwd, label)
    # the GEMM and softmax ladder (run_all.py's GEMM and softmax rungs,
    # BASELINE configs 1-3), its own path with the counters at 0 before it
    with clock("ladder"):
        ladder = phase_ladder(device, label)
    # the wgmma GEMMs (kernels 13 and 14, bf16 and f32) at their tiles'
    # edges, then timed in turns with torch.matmul / torch.bmm (the f32 one
    # beside the FFMA core too, and against the fp64 oracle)
    with clock("gemm_tiles"):
        phase_gemm_tiles(device, label)
    # kernels 16 and 17 on their wgmma kernel at its bands' and tiles' edges
    with clock("softmax_tiles"):
        phase_softmax_tiles(device, label)
    with clock("gemm_sm90_times"):
        gemm_times = phase_gemm_sm90_times(device, label)
    with clock("gemm_f32_times"):
        f32_times = phase_gemm_f32_times(device, label)
    for entry in ladder:
        if entry["name"] in ("gemm", "gemm_batched"):
            entry["turns"] = {k: v for k, v in gemm_times.items()
                              if (k.startswith("8 x")) == (entry["name"] == "gemm_batched")}
        elif entry["name"] == "gemm_f32":
            entry["turns"] = f32_times
    # kernels 8 and 12 (q_int8) over int8 caches and kernel 1's range guard,
    # each its own path with the counters at 0 before it
    with clock("int8_products"):
        mxu, qi8 = phase_int8_products(device, label)
    with clock("guard"):
        guard = phase_guard(device, label)
    # the stage probes (profile_attention.py's breakdown, run_all.py's probe
    # rungs) and the paged gather's slots and copy_only (ab_paged_int8.py),
    # each its own path with the counters at 0 before it
    with clock("probes"):
        probes = phase_probes(device, label)
    with clock("paged_probes"):
        paged_probes = phase_paged_probes(device, label)

    # 3. the serving slices at the serving configuration: the default
    # Scheduler, the paged one (a page pool, a shared 384-token system
    # prompt through the prefix cache, prefill in chunks of 256) and
    # multi_step=4, each with every launch counter at 0 before it
    cfg = tfm.TransformerConfig(**SERVING, dtype=torch.bfloat16)
    params = tfm.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device)
    prompts = serving_prompts(cfg, 32)
    with clock("slice"):
        sched, single, launches = phase_slice(
            device, cfg, params, prompts, max_batch=8, max_len=2048, max_new=64,
            label=label)
    fwd["launches"] = launches["flash_fwd"]
    dec["launches"] = launches["flash_decode"]
    system = np.random.default_rng(1).integers(0, cfg.vocab_size, 384)
    with clock("paged_slice"):
        paged_launches = phase_paged_slice(
            device, cfg, params,
            [np.concatenate([system, p]).astype(np.int32) for p in prompts],
            max_batch=8, max_len=2048, max_new=64, linear=sched.metrics(),
            label=label)
    ragged["launches"] = paged_launches["flash_fwd_ragged"]
    paged["launches"] = paged_launches["paged_decode"]
    with clock("multi_step"):
        phase_multi_step(device, cfg, params, prompts, max_batch=8, max_len=2048,
                         max_new=64, single=single, label=label)

    # 4. speculative decoding at bench_spec.py's configuration: the serving
    # model as the target, the 2-layer draft; then the serving slice through
    # the speculative Scheduler, linear, paged, and paged with draft = target
    draft_cfg = tfm.TransformerConfig(**DRAFT, dtype=torch.bfloat16)
    draft_params = tfm.init_params(
        draft_cfg, torch.Generator(device=device).manual_seed(1), device)
    with clock("spec_generate"):
        tie = phase_spec_generate(device, cfg, params, draft_cfg, draft_params,
                                  batch=4, prompt_len=128, max_new=128, label=label)
    with clock("spec_slice"):
        spec_launches = phase_spec_slice(
            device, cfg, params, draft_cfg, draft_params, prompts, max_batch=8,
            max_len=2048, max_new=64, single=single, linear=sched.metrics(),
            tie=tie, label=label)
    extend["launches"] = spec_launches["paged_extend"]
    with clock("profile_spec_round"):
        for quantized in (False, True):
            profile_spec_round(device, cfg, params, draft_cfg, draft_params,
                               label, quantized=quantized)
        # the linear cache's round: its verify is the ragged forward's slab
        # route
        profile_spec_round(device, cfg, params, draft_cfg, draft_params, label,
                           paged=False)

    # 5. the int8 cache of bench_serving.py --int8: the serving requests
    # linear, paged, multi_step=4 and speculative over both caches
    with clock("8bit_slices"):
        q8 = phase_8bit_slices(device, cfg, params, draft_cfg, draft_params,
                               prompts, system, max_batch=8, max_len=2048,
                               max_new=64, label=label)
    dec_q["launches"] = q8["int8 slice (linear)"]["flash_decode_q"]
    paged_q["launches"] = q8["int8 slice (paged)"]["paged_decode_q"]
    extend_q["launches"] = q8["int8 spec slice (paged)"]["paged_extend_q"]
    ragged_q["launches"] = q8["int8 spec slice (linear)"]["flash_fwd_ragged_q"]

    # 6. cached decode against a full forward: the linear cache, then the
    # paged cache with a prefix shared through cache_from_pages; bf16 within
    # its floor, the 8-bit caches (int8, e4m3 linear; int8 paged) within the
    # JAX suite's 5e-2 on top of that floor; int8 weights
    with clock("consistency"):
        floor = phase_consistency(device, cfg, params, n_prompt=128, n_steps=16,
                                  label=label)
    with clock("paged_consistency"):
        paged_floor = phase_paged_consistency(
            device, cfg, params, n_prompt=640, n_shared=512, chunk=256, n_steps=16,
            label=label)
    with clock("consistency_8bit"):
        for fmt in FMTS:
            phase_consistency(device, cfg, params, n_prompt=128, n_steps=16,
                              label=label, quant_fmt=fmt,
                              tol=QUANT_LOGITS_TOL + floor)
    with clock("paged_consistency_int8"):
        phase_paged_consistency(device, cfg, params, n_prompt=640, n_shared=512,
                                chunk=256, n_steps=16, label=label, quantized=True,
                                tol=QUANT_LOGITS_TOL + paged_floor)
    with clock("int8_weights"):
        phase_int8_weights(device, cfg, params, label)
    with clock("profile_decode_steps"):
        profile_decode_steps(device, cfg, params, label)

    # 7. the windowed serving model (window 256, 4 sinks) on the same
    # weights: the serving requests five ways, each launch counter at 0
    # before it, then cached decode against a windowed full forward with a
    # prompt longer than the window
    band = dict(attn_window=SERVING_WINDOW, attn_sinks=SERVING_SINKS)
    wcfg = tfm.TransformerConfig(**SERVING, **band, dtype=torch.bfloat16)
    wdraft = tfm.TransformerConfig(**DRAFT, **band, dtype=torch.bfloat16)
    with clock("window_slices"):
        win = phase_window_slices(device, wcfg, params, wdraft, draft_params, prompts,
                                  system, max_batch=8, max_len=2048, max_new=64,
                                  label=label)
    win_fwd["launches"] = win["window slice"]["flash_fwd/window"]
    win_dec["launches"] = win["window slice"]["flash_decode/window"]
    win_ragged["launches"] = win["window slice (paged)"]["flash_fwd_ragged/window"]
    win_ragged_q["launches"] = win["window slice (int8)"]["flash_fwd_ragged_q/window"]
    win_dec_q["launches"] = win["window slice (int8)"]["flash_decode_q/window"]
    del draft_params
    with clock("window_consistency"):
        wfloor = phase_consistency(device, wcfg, params, n_prompt=640, n_steps=16,
                                   label=label)
        phase_consistency(device, wcfg, params, n_prompt=640, n_steps=16,
                          label=label, quant_fmt="int8", tol=QUANT_LOGITS_TOL + wfloor)
    # e4m3's own error at this prompt length passes the JAX suite's 5e-2
    # (set on a small float32 model): measure it through plain float32
    # attention on the same tokens, and gate the kernels' path at the
    # larger of the two plus the bf16 floor (the port's plain path has
    # JAX's e4m3 gap: tests/test_torch_quant_serving.py)
    with clock("window_consistency_fp8"):
        with plain_attention():
            fp8_ref = phase_consistency(device, wcfg, params, n_prompt=640,
                                        n_steps=16, label=label, quant_fmt="fp8",
                                        tol=float("inf"), what=" (plain attention)")
        phase_consistency(device, wcfg, params, n_prompt=640, n_steps=16,
                          label=label, quant_fmt="fp8",
                          tol=max(QUANT_LOGITS_TOL, fp8_ref) + wfloor)

    # 7b. the serving model with attn_stable=False (the fixed-max forwards)
    # on the same weights, three ways, each launch counter at 0 before it,
    # then cached decode against its full forward
    fcfg = tfm.TransformerConfig(**SERVING, attn_stable=False,
                                 dtype=torch.bfloat16)
    with clock("fixed_slices"):
        fixed = phase_fixed_slices(device, fcfg, params, prompts, max_batch=8,
                                   max_len=2048, max_new=64, tie=tie, label=label)
    fix_fwd["launches"] = fixed["fixed slice"]["flash_fwd/fixed"]
    fix_ragged["launches"] = fixed["fixed slice (prefill_chunk=256)"][
        "flash_fwd_ragged/fixed"]
    fix_ragged_q["launches"] = fixed["fixed slice (int8, prefill_chunk=256)"][
        "flash_fwd_ragged_q/fixed"]
    with clock("fixed_consistency"):
        phase_consistency(device, fcfg, params, n_prompt=128, n_steps=16,
                          label=label, what=" (attn_stable=False)")
    del params, sched

    # 8. the backward kernels against their plain version, without and with
    # the training config's window
    with clock("backward"):
        bwd = phase_backward(device, [
            (1, 16, 4, 4096, 4096, 128, True, 0),  # bench.py's shape
            (4, 16, 4, 4096, 4096, 128, True, 0),  # the training step's shape
            (1, 16, 4, 1024, 1024, 64, True, 0),   # d=64
            (2, 4, 2, 200, 333, 128, False, 0),    # ragged, non-causal
            (2, 4, 2, 200, 333, 128, True, 133),   # ragged, causal, q_offset
        ], label, entry_shape=1)
    with clock("window_backward"):
        win_bwd = phase_window_backward(device, 4, 16, 4, 4096, 128, TRAIN_WINDOW,
                                        TRAIN_SINKS, label)
    # the backward at its tiles' edges in both schedules, then timed in
    # turns with SDPA's backward
    with clock("bwd_tiles"):
        phase_bwd_tiles(device, label)
    with clock("bwd_sm90_times"):
        bwd_times = phase_bwd_sm90_times(device, label)
    bwd[0]["turns"] = bwd_times
    kernels = [fwd, dec, *bwd, ragged, paged, extend, dec_q, paged_q, ragged_q,
               extend_q, win_fwd, win_dec, win_dec_q, win_ragged, win_ragged_q,
               *win_bwd, fix_fwd, win_fix, hyb_fwd, hyb_fwd64, packed,
               fix_ragged, fix_ragged_q, fwd_q, *ladder, mxu, qi8, guard,
               *probes, *paged_probes]
    kernel_detail(kernels)

    # 9. training at the bench_train.py configuration
    cfg = tfm.TransformerConfig(**TRAIN, dtype=torch.bfloat16)
    params = tfm.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device)
    corpus = motif_corpus(cfg)
    with clock("train"):
        params, train_launches, train_ms = phase_train(
            device, cfg, params, corpus, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR, steps=5,
            label=label)
    # row 4 (kernel A) runs in every backward, row 5 (kernel B) in the
    # two-kernel schedule's
    bwd[0]["launches"] = train_launches["flash_bwd"]
    bwd[1]["launches"] = train_launches["flash_bwd/split"]

    # 10. train -> checkpoint -> restore -> serve
    with clock("checkpoint"):
        phase_checkpoint(device, cfg, params, corpus, label)
    del params

    # 11. training with the window (1024) and 64 sinks, from the same seed
    wcfg = tfm.TransformerConfig(**TRAIN, attn_window=TRAIN_WINDOW,
                                 attn_sinks=TRAIN_SINKS, dtype=torch.bfloat16)
    params = tfm.init_params(
        wcfg, torch.Generator(device=device).manual_seed(0), device)
    with clock("window_train"):
        _, wtrain_launches, wtrain_ms = phase_train(
            device, wcfg, params, corpus, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR, steps=5,
            label=label)
    win_bwd[0]["launches"] = wtrain_launches["flash_bwd/window"]
    win_bwd[1]["launches"] = wtrain_launches["flash_bwd/split"]
    log(f"train with window {wcfg.attn_window} and {wcfg.attn_sinks} sinks: "
        f"{wtrain_ms:.2f} ms/step vs {train_ms:.2f} without (same run) [{label}]")

    del params

    # 12. the JAX package's default model (d_head 64) with attn_stable=False:
    # 8 requests served and 5 SGD steps, through the packed forward
    with clock("default_model"):
        serve64, train64 = phase_default_model(device, label)
    packed["launches"] = serve64["flash_fwd/packed"] + train64["flash_fwd/packed"]
    log(f"packed forward launches: {serve64['flash_fwd/packed']} serving the "
        f"d64 model, {train64['flash_fwd/packed']} in its 5 training steps")

    # 13. bench_train.py --moe-experts 8's model: trained, its dispatches on
    # real activations, served through the engine, cached decode held to a
    # full forward (kernels 1, 3, 4, 5, 6, 10 and 11 on its path)
    with clock("moe"):
        phase_moe(device, corpus, label)

    # 14. serving over a device mesh: two ranks spawned on the one card over
    # gloo, the serving model through Scheduler(mesh=) and (seq_mesh=) and
    # seq_sharded_decode, each against the single-device path (kernels 1,
    # 3, 6, 7, 10, 11 and 12 at the per-rank shapes)
    with clock("mesh"):
        phase_mesh(device, label)

    # 15. training over a device mesh: two ranks spawned on the one card
    # over gloo, ring attention (bf16, windowed, trainable, 8-bit) and
    # Ulysses against the single-device kernels, then bench_train.py's model
    # through the CP, TP, AdamW and pipeline steps (kernels 1, 1 (window),
    # 1 (8-bit), 4 and 5 at the per-rank shapes)
    with clock("mesh_train"):
        phase_mesh_train(device, label)

    # 16. expert parallelism and sharded checkpoints over a device mesh:
    # the MoE model of 13 through make_ep_moe, the TP steps' MoE branch
    # (a sharded checkpoint through torch.distributed.checkpoint mid-run),
    # and Scheduler(seq_mesh=) (kernels 1, 4, 5, 6 and 7 at the per-rank
    # shapes)
    with clock("mesh_moe"):
        phase_mesh_moe(device, label)

    # 17. utils.benchmarking's four timers on bench.py's headline call and
    # the serving decode (kernels 1 and 6), each against time_ms, in a
    # process of their own
    with clock("benchmarking"):
        phase_apart("benchmarking")

    log(clock.summary())
    log(label)
    print(json.dumps({"kernels": [compact(e) for e in kernels]},
                     separators=(",", ":")), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
