#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one Hopper GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ (at first use) and holds each
against its plain PyTorch version in bf16 at the shapes its path gives it.
Then it drives the port's two main paths at full width, with random
weights from a seed:
  - serving: 32 requests through models.serving.Scheduler at the serving
    configuration of benchmarks/bench_serving.py (8 layers, d_model 2048,
    16 q heads x 128, 4 KV heads, d_ff 5504, vocab 32000, bf16, batch 8,
    max_len 2048), and cached decoding against a full forward;
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


def time_ms(fn, device, iters: int = 10, reps: int = 5) -> float:
    """Median per-call milliseconds over `reps` runs of `iters` calls, from
    CUDA events on a GPU (after a warm-up call)."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / iters)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            times.append((time.perf_counter() - t0) * 1e3 / iters)
    return statistics.median(times)


def time_pair(kernel_fn, plain_fn, device, iters=10):
    """Kernel and plain times measured in turns (plain, kernel, kernel,
    plain) so that both see the same clocks."""
    p1 = time_ms(plain_fn, device, iters)
    k1 = time_ms(kernel_fn, device, iters)
    k2 = time_ms(kernel_fn, device, iters)
    p2 = time_ms(plain_fn, device, iters)
    return min(k1, k2), min(p1, p2)


def _rel_l2(a, b) -> float:
    from flashattention_kernel_project_tpu_torch.utils.testing import rel_l2

    return rel_l2(a.float().cpu().numpy(), b.float().cpu().numpy())


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
            entry.update(ms=ms, plain_ms=plain_ms,
                         shape=f"b{b} hq{hq} hkv{hkv} n{n} s{s} d{d} causal")
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
    log(f"flash_decode b{b} hq{hq} hkv{hkv} s{s} d{d} n_splits={n_splits} "
        f"lengths={lengths.tolist()}: rel-L2 {err:.3e}, max-abs {max_abs:.3e} "
        f"| kernel {ms:.4f} ms ({gbytes / ms * 1e3:.1f} GB/s of live K/V) vs "
        f"plain partials {plain_ms:.4f} ms | with the merge: {op_ms:.4f} ms "
        f"vs plain {op_plain_ms:.4f} ms [{label}]")
    return dict(name="flash_decode", route="cuda",
                source=f"{PKG}/csrc/flash_decode.cu",
                replaces="flashattention_kernel_project_tpu/ops/flash_decode.py:38",
                max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                shape=f"b{b} hq{hq} hkv{hkv} s{s} d{d} n_splits{n_splits}")


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
            dkdv.update(ms=kv_ms, plain_ms=plain_ms, shape=shape)
            dq_e.update(ms=dq_ms, plain_ms=plain_ms, shape=shape)
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


def phase_slice(device, cfg, params, prompts, max_batch, max_len, max_new,
                label):
    """Serve `prompts` through the Scheduler; every request must return
    max_new tokens and (on a GPU) both kernels must have launched."""
    import torch

    from flashattention_kernel_project_tpu_torch.models.serving import Scheduler
    from flashattention_kernel_project_tpu_torch.ops import flash_attention as fa
    from flashattention_kernel_project_tpu_torch.ops import flash_decode as fd

    # warm-up on a throwaway scheduler: allocator, cuBLAS handles
    warm = Scheduler(cfg, params, max_batch=max_batch, max_len=max_len)
    warm.submit(prompts[0][:8], max_new_tokens=4)
    warm.run()
    del warm
    if device.type == "cuda":
        torch.cuda.synchronize()

    sched = Scheduler(cfg, params, max_batch=max_batch, max_len=max_len)
    fa._fwd.launches = 0
    fd.flash_decode.launches = 0
    uids = [sched.submit(p, max_new_tokens=max_new) for p in prompts]
    out = sched.run()
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = dict(flash_fwd=fa._fwd.launches,
                    flash_decode=fd.flash_decode.launches)
    for u in uids:
        if len(out[u]) != max_new:
            raise AssertionError(f"request {u} returned {len(out[u])} tokens")
        if not all(0 <= t < cfg.vocab_size for t in out[u]):
            raise AssertionError(f"request {u} returned out-of-vocab tokens")
    if device.type == "cuda" and not all(launches.values()):
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    m = sched.metrics()
    log(f"slice: {len(prompts)} requests x {max_new} new tokens, batch "
        f"{max_batch}, max_len {max_len}, prompt lengths "
        f"{sorted(len(p) for p in prompts)}")
    log(f"slice: {m.tokens} tokens in {m.wall_s:.3f} s = {m.tok_per_s:.1f} tok/s"
        f" | TTFT mean {m.ttft_s_mean * 1e3:.1f} ms p95 "
        f"{m.ttft_s_p95 * 1e3:.1f} ms | latency mean "
        f"{m.latency_s_mean * 1e3:.1f} ms p95 {m.latency_s_p95 * 1e3:.1f} ms"
        f" | kernel launches {launches} [{label}]")
    return launches


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
        for line in f:
            if "registers" in line or "spill" in line:
                log("ptxas: " + line.strip())
    fwd = phase_forward(device, [
        (1, 16, 4, 4096, 4096, 128, True, 0),  # bench.py's shape
        (1, 16, 4, 512, 512, 128, True, 0),    # the slice's longest prefill
        (1, 16, 4, 1024, 1024, 64, True, 0),   # d=64
        (2, 4, 2, 200, 333, 128, False, 0),    # ragged, non-causal
        (2, 4, 2, 200, 333, 128, True, 133),   # ragged, causal, q_offset
    ], label)
    dec = phase_decode(device, 8, 16, 4, 2048, 128, label)

    # 3. the slice at the serving configuration
    cfg = tfm.TransformerConfig(**SERVING, dtype=torch.bfloat16)
    params = tfm.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device)
    launches = phase_slice(device, cfg, params, serving_prompts(cfg, 32),
                           max_batch=8, max_len=2048, max_new=64, label=label)
    fwd["launches"] = launches["flash_fwd"]
    dec["launches"] = launches["flash_decode"]

    # 4. cached decode against a full forward
    phase_consistency(device, cfg, params, n_prompt=128, n_steps=16,
                      label=label)
    del params

    # 5. the backward kernels against their plain version
    bwd = phase_backward(device, [
        (1, 16, 4, 4096, 4096, 128, True, 0),  # bench.py's shape
        (4, 16, 4, 4096, 4096, 128, True, 0),  # the training step's shape
        (1, 16, 4, 1024, 1024, 64, True, 0),   # d=64
        (2, 4, 2, 200, 333, 128, False, 0),    # ragged, non-causal
        (2, 4, 2, 200, 333, 128, True, 133),   # ragged, causal, q_offset
    ], label, entry_shape=1)

    # 6. training at the bench_train.py configuration
    cfg = tfm.TransformerConfig(**TRAIN, dtype=torch.bfloat16)
    params = tfm.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device)
    corpus = motif_corpus(cfg)
    params, train_launches = phase_train(
        device, cfg, params, corpus, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR, steps=5,
        label=label)
    for entry in bwd:
        entry["launches"] = train_launches["flash_bwd"]

    # 7. train -> checkpoint -> restore -> serve
    phase_checkpoint(device, cfg, params, corpus, label)

    print(json.dumps({"kernels": [fwd, dec, *bwd]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
