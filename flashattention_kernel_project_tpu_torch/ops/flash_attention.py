"""Fused GQA attention: forward (O and logsumexp), backward, and the ragged
forward against a live cache.

Counterpart of flashattention_kernel_project_tpu/ops/flash_attention.py
(`flash_attention`, `flash_attention_with_lse`, `_fwd`, `_fwd_packed`
(here `_fwd(pack=True)`), `_bwd_pallas` and the custom_vjp around them, `k_max_norm`,
`flash_attention_kv_quant` and `_with_lse`, `flash_attention_ragged`,
`flash_attention_ragged_kv_quant`), with or without a sliding window
(`window` keys, causal only) and attention sinks (the first `sinks` keys,
visible to every query), in the JAX package's three softmax disciplines:
stable=True (the online running max), stable=False (fixed-max: m pinned at
0, sound while every log2-domain score stays below 78) and stable="auto"
(per block of rows, fixed-max where a Cauchy-Schwarz bound on the scores
proves it sound, online elsewhere; the ragged forwards take it as True, as
in JAX). On a CUDA tensor `_fwd` launches the hand-written Hopper kernel of
csrc/flash_fwd_sm90.cuh (wgmma, TMA and a K/V ring) through
csrc/flash_fwd.cu (with pack=True kernel 2's counterpart, its fixed-max
d=64 instance), `_fwd_q_cuda` the same kernel's 8-bit form through
csrc/flash_fwd_q.cu (an int8 or e4m3 cache widened to bf16 in shared memory),
`_fwd_ragged` (a bf16 cache) and `flash_attention_ragged_kv_quant` (8-bit)
one of two Hopper kernels by the route `ops.paged_decode.ragged_plan`
picks from static shapes (chunks of T < 9, the linear speculative verify
among them: the paged extend's block over the linear cache,
csrc/ragged_slab.cu; longer chunks: the dense forward's kernel in its
ragged flavour, csrc/flash_fwd_ragged.cu), and `_bwd` the
Hopper backward of csrc/flash_bwd_sm90.cuh (kernel A: dK, dV and in the
fused-dq schedule dQ's partials) and csrc/flash_bwd_dq_sm90.cuh (kernel B:
dQ alone, the two-kernel schedule); on a CPU tensor
they run `_fwd_plain`, `_fwd_ragged_plain` (over the dequantized cache for
8 bits) and `_bwd_plain`, the same functions in plain PyTorch, which the
CPU tests hold against the JAX kernels and chip_smoke.py holds the CUDA
kernels against. `_fwd(guard=True)` (fixed-max only) also returns the
range guard's count of rows whose l or acc left the fixed-max range,
counted in the kernel's epilogue (`_guard_count` on the CPU).

Layouts follow the JAX package: q [B, Hq, N, D], k/v [B, Hkv, S, D],
O [B, Hq, N, D] in q's dtype, LSE [B, Hq, N] float32 in natural log.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from flashattention_kernel_project_tpu_torch.ops import _build
from flashattention_kernel_project_tpu_torch.ops.quant import check_8bit_cache
from flashattention_kernel_project_tpu_torch.ops.softmax import _LOG2E, NEG_INF

_LN2 = 0.6931471805599453
_KERNEL_DIMS = (64, 128)

# The softmax disciplines, as the kernels number them (kDisc in
# csrc/flash_fwd_core.cuh): stable=True, stable=False, stable="auto"
ONLINE, FIXED, HYBRID = 0, 1, 2
# fixed-max is sound while every log2-domain score stays below this
# (_SAFE_BOUND of the JAX kernel): exp2 then leaves f32 far from overflow
_SAFE_BOUND = 78.0
# the rows that share one hybrid decision: one warp's rows in the kernel
_HYBRID_ROWS = 16


def _discipline(stable) -> int:
    """ONLINE, FIXED or HYBRID from the JAX package's `stable` (True,
    False or "auto")."""
    if isinstance(stable, str):
        if stable != "auto":
            raise ValueError(f"stable must be True, False or 'auto', got {stable!r}")
        return HYBRID
    return ONLINE if stable else FIXED


def _counter(disc) -> str:
    """The wrapper attribute that counts a discipline's launches."""
    return ("launches", "fixed_launches", "hybrid_launches")[disc]


def _band(causal, window, sinks):
    """The JAX package's argument checks for a sliding window (asserts
    there, ValueError here): window needs causal and window >= 1; sinks
    need a window. Returns (window, sinks) as the kernels take them, window
    0 meaning none."""
    if window is not None and (not causal or window < 1):
        raise ValueError(f"window={window} needs causal=True and window >= 1")
    if sinks < 0 or (sinks and window is None):
        raise ValueError(f"sinks={sinks} needs a window and sinks >= 0")
    return (window or 0), sinks


def _band_mask(rows, cols, window, sinks):
    """rows [..., N, 1] query positions, cols [S] key positions -> bool
    [..., N, S]: key j visible to the query at position p iff j <= p and,
    with a window (> 0), j > p - window or j < sinks."""
    mask = cols <= rows
    if window:
        mask = mask & ((cols > rows - window) | (cols < sinks))
    return mask


def k_max_norm(k: torch.Tensor, k_scale: torch.Tensor | None = None) -> torch.Tensor:
    """max_t ||k_t|| over a K cache [..., S, D], as a 0-d float32 tensor on
    k's device: the cacheable half of stable="auto"'s score bound (pass it
    to flash_attention(k_max=...)). For an 8-bit cache pass the per-token
    scales [..., S, 1], so that the bound covers the dequantized keys; the
    squares are taken in float32 (an int8 square would wrap). Any value at
    least the true maximum is sound. Plain torch, as the JAX package
    computes it in XLA; the host never reads it."""
    kn2 = k.float().square().sum(dim=-1)
    if k_scale is not None:
        kn2 = kn2 * k_scale.float()[..., 0].square()
    return kn2.max().sqrt()


def _fixed_rows(q, sm_scale, disc, k_max):
    """Where the plain versions pin m at 0: [B, Hq, N, 1] bool, True for
    the rows that run fixed-max (all of them for FIXED; for HYBRID the
    rows of each block of _HYBRID_ROWS whose bound max ||q_r|| *
    |sm_scale| * log2(e) * k_max is below _SAFE_BOUND, a NaN bound running
    online), or None for ONLINE."""
    if disc == ONLINE:
        return None
    b, hq, n, _ = q.shape
    if disc == FIXED:
        return torch.ones((b, hq, n, 1), dtype=torch.bool, device=q.device)
    qn2 = q.float().square().sum(dim=-1)  # [B, Hq, N]
    pad = (-n) % _HYBRID_ROWS
    qn2 = torch.nn.functional.pad(qn2, (0, pad))
    qb = qn2.view(b, hq, -1, _HYBRID_ROWS).amax(dim=-1)
    bound = qb.sqrt() * (abs(sm_scale) * _LOG2E) * k_max.to(q.device)
    fixed = (bound < _SAFE_BOUND).repeat_interleave(_HYBRID_ROWS, dim=-1)
    return fixed[..., :n, None]


def _softmax_plain(scores, mask, pinned):
    """(p, m, l) of log2-domain scores [..., N, S]: masked entries (mask
    False) NEG_INF; m the row max, or 0 where `pinned` (fixed-max rows)."""
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    if pinned is not None:
        m = m.masked_fill(pinned, 0.0)
    p = torch.exp2(scores - m)
    if mask is not None:
        # a row with no visible key has m == NEG_INF and exp2(0) == 1
        p = p * mask
    return p, m, p.sum(dim=-1, keepdim=True)


def _guard_count(l, acc, causal, q_offset, hkv, pack=False):
    """The fixed-max range guard (JAX `_fwd(guard=True)`,
    flash_attention.py:672-701): the number of rows, as a 0-d int32
    tensor, whose l [B, Hq, N, 1] is not finite or lies outside
    [2^-100, 2^120], or whose unnormalized acc [B, Hq, N, D] holds a
    non-finite element. With m pinned at 0, l witnesses the range of every
    p = exp2(s). When causal, a row at a negative position sees no key and
    carries l == 0 by right: it does not count. pack=True counts a row once
    for the two heads of a KV pair (of the `hkv` KV heads), as JAX's paired
    d=64 kernel does (:957-974)."""
    bad = (~torch.isfinite(l) | (l > 2.0 ** 120) | (l < 2.0 ** -100)
           | ~torch.isfinite(acc).all(dim=-1, keepdim=True))
    b, hq, n, _ = bad.shape
    if pack:
        bad = bad.reshape(b, hkv // 2, 2, hq // hkv, n, 1).any(dim=2)
    if causal:
        bad = bad & (torch.arange(n, device=l.device)[:, None] + q_offset >= 0)
    return bad.sum(dtype=torch.int32)


def _check_guard(guard, disc):
    """JAX's assert that the guard instruments the fixed-max kernel, as a
    ValueError."""
    if guard and disc != FIXED:
        raise ValueError("guard instruments the fixed-max kernel (stable=False)")


def _fwd_plain(q, k, v, causal, sm_scale, q_offset, window=0, sinks=0,
               disc=ONLINE, k_max=None, guard=False, pack=False):
    """The forward in plain PyTorch, in float32: the same log2-domain
    scores, masks (causal, and the band of `window` keys plus the first
    `sinks` when window > 0), discipline (FIXED: m pinned at 0; HYBRID: so
    in each block of _HYBRID_ROWS rows whose bound with `k_max`, a 0-d
    tensor, proves it sound) and empty-row rule as the kernel, with one
    softmax over all keys. guard=True adds `_guard_count` (over KV-head
    pairs with pack=True) to the result."""
    b, hq, n, d = q.shape
    group = hq // k.shape[1]
    s = k.shape[2]
    qf = q.float() * (sm_scale * _LOG2E)
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    scores = qf @ kf.transpose(-1, -2)  # [B, Hq, N, S], log2 domain
    mask = None
    if causal:
        rows = torch.arange(n, device=q.device)[:, None] + q_offset
        mask = _band_mask(rows, torch.arange(s, device=q.device), window, sinks)
    p, m, l = _softmax_plain(scores, mask, _fixed_rows(q, sm_scale, disc, k_max))
    safe_l = torch.where(l == 0.0, torch.ones_like(l), l)
    acc = p @ vf
    lse = torch.where(l == 0.0, torch.full_like(l, NEG_INF),
                      m * _LN2 + torch.log(safe_l))
    out = (acc / safe_l).to(q.dtype), lse[..., 0]
    if not guard:
        return out
    return (*out, _guard_count(l, acc, causal, q_offset, k.shape[1], pack))


@functools.cache
def _kernel(name, n_ptrs, n_flags=4):
    """A C entry point taking `n_ptrs` pointers, then (b, hq, hkv, n, s, d),
    a float scale, `n_flags` ints (causal, q_offset, window, sinks, and the
    forwards' discipline) and the stream."""
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    return _build.kernel(
        name,
        [vp] * n_ptrs + [i32] * 6 + [ctypes.c_float] + [i32] * n_flags + [vp],
    )


def _check_cuda_inputs(q, k, v, **more):
    for name, x in (("q", q), ("k", k), ("v", v), *more.items()):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.dtype != torch.bfloat16:
            raise TypeError(f"the CUDA kernels take bf16; {name} is {x.dtype}")
        if x.dim() != 4 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 4-D tensor")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    b, hq, n, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not match")
    if d not in _KERNEL_DIMS:
        raise ValueError(f"the CUDA kernels take d in {_KERNEL_DIMS}, got {d}")
    if n == 0 or k.shape[2] == 0:
        raise ValueError("empty query or key sequence")


def _check_k_max(q, disc, k_max):
    """HYBRID reads k_max on the device: one float32 value on q's device."""
    if disc == HYBRID and (k_max is None or k_max.device != q.device
                           or k_max.dtype != torch.float32
                           or k_max.numel() != 1):
        raise ValueError("stable='auto' needs k_max as one float32 value on "
                         "q's device")


def _fwd_args(q, k, v, sm_scale, disc, k_max, k_scale=None):
    """The checks and defaults the dense forwards share: (sm_scale, and for
    HYBRID k_max as the kernels read it, a 0-d float32 tensor on k's
    device: computed from k (and k_scale) when None, a number copied
    there; None for the other disciplines)."""
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"q heads {q.shape[1]} not a multiple of kv heads "
                         f"{k.shape[1]}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if disc != HYBRID:
        return sm_scale, None
    if k_max is None:
        return sm_scale, k_max_norm(k, k_scale)
    return sm_scale, torch.as_tensor(k_max, dtype=torch.float32,
                                     device=k.device).reshape(())


def _fwd_cuda(q, k, v, causal, sm_scale, q_offset, window, sinks, disc,
              k_max, counter, guard=False, pack=False):
    """Launch csrc/flash_fwd.cu on checked inputs and count the launch in
    `_fwd.<counter>` (and `_fwd.window_launches` with a window,
    `_fwd.guard_launches` with the guard). guard=True adds the range
    guard's count, a 0-d int32 device tensor, to the result; with
    pack=True the kernel counts a row once for a KV pair's two heads, by a
    zeroed bit a (b, pair, group member, row) that the first of them sets."""
    _check_cuda_inputs(q, k, v)
    _check_k_max(q, disc, k_max)
    b, hq, n, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    lse = torch.empty((b, hq, n), dtype=torch.float32, device=q.device)
    bad = torch.zeros((), dtype=torch.int32, device=q.device) if guard else None
    pairs = (torch.zeros(-(-b * hq * n // 64), dtype=torch.int32,
                         device=q.device) if guard and pack else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _kernel("fkp_flash_fwd", 8, 5)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        None if k_max is None else k_max.data_ptr(),
        None if bad is None else bad.data_ptr(),
        None if pairs is None else pairs.data_ptr(),
        b, hq, hkv, n, s, d, float(sm_scale * _LOG2E), int(bool(causal)),
        int(q_offset), int(window), int(sinks), int(disc), stream,
    )
    setattr(_fwd, counter, getattr(_fwd, counter) + 1)
    _fwd.window_launches += bool(window)
    _fwd.guard_launches += guard
    _build.check(rc, "flash_fwd")
    return (o, lse, bad) if guard else (o, lse)


def _fwd(q, k, v, causal, sm_scale, q_offset, window=0, sinks=0, disc=ONLINE,
         k_max=None, pack=False, *, guard=False):
    """(O, LSE). CPU tensors run `_fwd_plain`; CUDA tensors launch
    csrc/flash_fwd.cu (bf16, contiguous, d in {64, 128}) or raise. window
    > 0: the band of `window` keys plus the first `sinks` (causal only),
    whose key tiles outside it the kernel never visits. disc: ONLINE,
    FIXED or HYBRID; HYBRID reads `k_max` (max_t ||k_t||; computed from k
    when None) on the device. Each launch counts in `_fwd.launches`
    (ONLINE), `.fixed_launches` or `.hybrid_launches`.

    pack=True (disc FIXED, d = 64, an even KV-head count): kernel 2's
    counterpart, the fixed-max d=64 forward, counted in
    `_fwd.packed_launches` instead. The TPU pairs two KV heads
    block-diagonally so that a d=64 product fills its 128-deep matrix unit;
    Hopper's wgmma is 16 deep and needs no pairing, so this is the same
    fixed-max d=64 instance.

    guard=True (disc FIXED only; ValueError otherwise, where JAX asserts):
    (O, LSE, bad), bad the fixed-max range guard's count of rows whose l
    left [2^-100, 2^120] or whose acc is not finite (`_guard_count`), a 0-d
    int32 tensor the kernel adds to on the device, with no host sync. The
    kernel is the fixed-max one with a count pointer, O and LSE as without
    it; its launches count in `.guard_launches` too. With pack=True a row
    counts once for the two heads of a KV pair, as in JAX's paired kernel.
    The 8-bit dense forward takes the guard in `_fwd_q_plain` and
    `_fwd_q_cuda`."""
    if pack and (disc != FIXED or q.shape[-1] != 64 or k.shape[1] % 2):
        raise ValueError("the packed forward is the fixed-max d=64 one, over "
                         "an even KV-head count")
    _check_guard(guard, disc)
    sm_scale, k_max = _fwd_args(q, k, v, sm_scale, disc, k_max)
    if q.device.type == "cpu":
        return _fwd_plain(q, k, v, causal, sm_scale, q_offset, window, sinks,
                          disc, k_max, guard, pack)
    if q.device.type != "cuda":
        raise ValueError(f"no forward for device {q.device}")
    return _fwd_cuda(q, k, v, causal, sm_scale, q_offset, window, sinks, disc,
                     k_max, "packed_launches" if pack else _counter(disc),
                     guard, pack)


# kernel launches by discipline, for showing that a path ran the kernel,
# those of them with a window, those of the packed forward, and those with
# the range guard
_fwd.launches = 0
_fwd.fixed_launches = 0
_fwd.hybrid_launches = 0
_fwd.window_launches = 0
_fwd.packed_launches = 0
_fwd.guard_launches = 0


def _check_pack(stable, q, k, v):
    """The JAX package's asserts for pack_heads=True, as ValueErrors:
    stable=False, d = 64 and an even KV-head count. (Its third, a bf16
    cache, holds by construction: the 8-bit forwards take no pack_heads,
    as JAX's do not.)"""
    if stable is not False:
        raise ValueError("pack_heads=True needs stable=False")
    if q.shape[-1] != 64 or v.shape[-1] != 64 or k.shape[1] % 2:
        raise ValueError(f"pack_heads=True needs d = 64 and an even KV-head "
                         f"count; got d {q.shape[-1]}, {k.shape[1]} KV heads")


def _pack_default(stable, q, k, v) -> bool:
    """JAX's default for pack_heads: on for stable=False at d = 64 with an
    even KV-head count."""
    return (stable is False and q.shape[-1] == 64 and v.shape[-1] == 64
            and k.shape[1] % 2 == 0)


def _bwd_plain(q, k, v, o, lse, do, causal, sm_scale, q_offset, window=0,
               sinks=0):
    """The backward in plain PyTorch, in float32: recompute p from the
    saved logsumexp under the forward's masks, GQA folded by repeating K/V over the group and the
    group summed back onto the KV heads for dK and dV. A row that sees no
    key has p == 0 and so zero dq (its LSE is the finite NEG_INF, for
    which exp(s - lse) alone would overflow). Returns (dq, dk, dv) in the
    inputs' dtypes."""
    b, hq, n, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    group = hq // hkv
    qf, dof = q.float(), do.float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    delta = (o.float() * dof).sum(dim=-1, keepdim=True)  # [B, Hq, N, 1]
    scores = (qf @ kf.transpose(-1, -2)) * sm_scale
    p = torch.exp(scores - lse[..., None])
    if causal:
        rows = torch.arange(n, device=q.device)[:, None] + q_offset
        mask = _band_mask(rows, torch.arange(s, device=q.device), window, sinks)
        p = torch.where(mask, p, torch.zeros((), device=q.device))
    dv = p.transpose(-1, -2) @ dof
    ds = p * (dof @ vf.transpose(-1, -2) - delta)
    dq = (ds @ kf) * sm_scale
    dk = (ds.transpose(-1, -2) @ qf) * sm_scale
    dk = dk.view(b, hkv, group, s, d).sum(dim=2)
    dv = dv.view(b, hkv, group, s, d).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# the query rows of the backward's ring stage (kernel A): the kernels read
# lse and delta from arrays padded to a multiple of it
_BWD_ROWS = 64


def _bwd_rows(lse, o, do):
    """(lse2, delta) as the backward kernels read them: lse * log2(e) and
    delta = rowsum(o * do) (plain torch, as the JAX package computes it in
    XLA), [B, Hq, N_pad] float32 with N_pad = N rounded up to _BWD_ROWS,
    zero in the pad."""
    pad = (-lse.shape[-1]) % _BWD_ROWS
    # the product of two bf16 is exact in float32: one float32 copy of o,
    # multiplied in place
    delta = o.to(torch.float32, copy=True).mul_(do).sum(dim=-1)
    return (torch.nn.functional.pad(lse * _LOG2E, (0, pad)),
            torch.nn.functional.pad(delta, (0, pad)))


def _launch_bwd(name, outs, q, k, v, do, lse2, delta, causal, sm_scale,
                q_offset, window=0, sinks=0):
    """Launch one backward entry writing `outs` (a None passes a null
    pointer); inputs as `_bwd` checked them, (lse2, delta) from
    `_bwd_rows`."""
    b, hq, n, d = q.shape
    rc = _kernel(f"fkp_{name}", 6 + len(outs))(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse2.data_ptr(), delta.data_ptr(),
        *(None if x is None else x.data_ptr() for x in outs),
        b, hq, k.shape[1], n, k.shape[2], d, float(sm_scale),
        int(bool(causal)), int(q_offset), int(window), int(sinks),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(rc, name)


def _dkdv_cuda(q, k, v, *args, dq_accum=None):
    """(dk, dv) from kernel A (csrc/flash_bwd_sm90.cuh); with `dq_accum` (a
    zeroed float32 tensor of q's shape) its fused-dq instance, which also
    adds the unscaled dq partials to it."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_bwd("flash_bwd_dkdv", (dk, dv, dq_accum), q, k, v, *args)
    return dk, dv


def _dq_cuda(q, k, v, *args):
    """dq from kernel B (csrc/flash_bwd_dq_sm90.cuh), the two-kernel
    schedule's second half."""
    dq = torch.empty_like(q)
    _launch_bwd("flash_bwd_dq", (dq,), q, k, v, *args)
    return dq


def _fused_cuda(q, k, v, do, lse2, delta, causal, sm_scale, *band):
    """(dq, dk, dv) from kernel A's fused-dq instance: dq = sm_scale * the
    sum of its partials, rounded to q's dtype in plain torch, as the JAX
    package sums them in XLA."""
    dq_accum = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk, dv = _dkdv_cuda(q, k, v, do, lse2, delta, causal, sm_scale, *band,
                        dq_accum=dq_accum)
    return dq_accum.mul_(sm_scale).to(q.dtype), dk, dv


# The schedule `_bwd` takes when fuse_dq is None: the two-kernel one, measured
# faster on the H100 at the training shape (4 x 16/4 heads x 4096 x 128:
# 1.92 ms against 2.30; PERF.md, row 4) and within 2% at d = 64. The JAX
# package defaults to the fused one (`_bwd_pallas`, fuse_dq=None -> True); on
# Hopper its dq product, the lockstep of the two warpgroups that share dS and
# the reduce-adds cost more than kernel B's three products.
_FUSE_DQ_DEFAULT = False


def _bwd(q, k, v, o, lse, do, causal, sm_scale, q_offset, window=0, sinks=0,
         fuse_dq=None):
    """(dq, dk, dv) from the forward's (o, lse) and the output gradient,
    under the forward's masks (window > 0: the band and the sinks).
    CPU tensors run `_bwd_plain` (one function for both schedules); CUDA
    tensors launch the Hopper kernels or raise. fuse_dq (JAX `_bwd_pallas`'s
    option): True, kernel A with its dq partials summed by reduce-adds
    (`_fused_cuda`); False, kernel A for dk and dv, then kernel B for dq;
    None, `_FUSE_DQ_DEFAULT`. delta = rowsum(o * do) is plain torch, as the
    JAX package computes it in XLA outside its kernels. Each call counts one
    in `_bwd.launches` (and in `_bwd.window_launches` with a window), and
    one in `_bwd.fused_launches` or `_bwd.split_launches` by schedule."""
    if fuse_dq is not None and not isinstance(fuse_dq, bool):
        raise ValueError(f"fuse_dq must be True, False or None, got {fuse_dq!r}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, o, lse, do, causal, sm_scale, q_offset,
                          window, sinks)
    if q.device.type != "cuda":
        raise ValueError(f"no backward for device {q.device}")
    # the model hands do back through a transpose and a reshape
    do = do.contiguous()
    _check_cuda_inputs(q, k, v, do=do)
    if do.shape != q.shape:
        raise ValueError(f"do {tuple(do.shape)} does not match q {tuple(q.shape)}")
    if lse.shape != q.shape[:3] or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 {tuple(q.shape[:3])}, got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    if fuse_dq is None:
        fuse_dq = _FUSE_DQ_DEFAULT
    args = (q, k, v, do, *_bwd_rows(lse, o, do), causal, sm_scale, q_offset,
            window, sinks)
    if fuse_dq:
        dq, dk, dv = _fused_cuda(*args)
        _bwd.fused_launches += 1
    else:
        dk, dv = _dkdv_cuda(*args)
        dq = _dq_cuda(*args)
        _bwd.split_launches += 1
    _bwd.launches += 1
    _bwd.window_launches += bool(window)
    return dq, dk, dv


_bwd.launches = 0  # backward calls that launched their kernels
_bwd.window_launches = 0  # those of them with a window
_bwd.fused_launches = 0  # those of them in the fused-dq schedule (kernel A)
_bwd.split_launches = 0  # those of them in the two-kernel one (A, then B)


class _FlashAttention(torch.autograd.Function):
    """flash_attention with its backward: the counterpart of the JAX
    package's custom_vjps (`_flash_attention`, and `_flash_attention_km`
    with a cached k_max). The forward saves (q, k, v, o, lse); the backward
    recomputes p from lse, whatever the forward's discipline (the saved LSE
    bounds every exponent), and gives k_max no gradient, as a bound needs
    none."""

    @staticmethod
    def forward(ctx, q, k, v, k_max, causal, sm_scale, q_offset, window, sinks,
                disc, pack):
        o, lse = _fwd(q, k, v, causal, sm_scale, q_offset, window, sinks,
                      disc, k_max, pack)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, sm_scale, q_offset, window, sinks)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _bwd(q, k, v, o, lse, do, *ctx.args)
        return dq, dk, dv, None, None, None, None, None, None, None, None


def _options(q, k, v, causal, stable, window, sinks, pack_heads, k_max):
    """flash_attention's options resolved as JAX resolves them: (window,
    sinks, discipline, pack, k_max), k_max kept for stable="auto" only."""
    window, sinks = _band(causal, window, sinks)
    disc = _discipline(stable)
    if pack_heads is None:
        pack = _pack_default(stable, q, k, v)
    elif pack_heads:
        _check_pack(stable, q, k, v)
        pack = True
    else:
        pack = False
    return window, sinks, disc, pack, (k_max if disc == HYBRID else None)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: float | None = None,
    q_offset: int = 0,
    stable: bool | str = True,
    window: int | None = None,
    sinks: int = 0,
    stack_group: bool | None = None,
    pack_heads: bool | None = None,
    k_max=None,
) -> torch.Tensor:
    """Grouped-query attention forward.

    q [B, Hq, N, D]; k, v [B, Hkv, S, D] with Hq % Hkv == 0, q head h
    reading KV head h // (Hq // Hkv). causal: query i sees key j iff
    j <= i + q_offset (a static offset of the query block within the key
    sequence). window (causal only): the query at position p sees only keys
    j > p - window, plus the first `sinks` keys. sm_scale defaults to
    1/sqrt(D). A row that sees no key gives zeros. Returns [B, Hq, N, D] in
    q's dtype; differentiable in q, k and v (the backward is `_bwd`, the
    same for every discipline).

    stable: True, the online running max (any input); False, fixed-max
    (m pinned at 0: no tile max and no rescale), sound while every
    |score * sm_scale| * log2(e) stays below 78, and loud outside it (the
    output turns non-finite); "auto", per block of 16 query rows, fixed-max
    where max_r ||q_r|| * |sm_scale| * log2(e) * k_max < 78 proves the
    contract and online elsewhere, so never wrong. k_max: max_t ||k_t||
    (`k_max_norm`, a 0-d tensor or a number; any over-estimate is sound),
    for stable="auto" only; computed from k on the device when None, and
    never read on the host. pack_heads: kernel 2 of the JAX package (the
    fixed-max d=64 forward with KV heads paired), by default on for
    stable=False at d = 64 with an even KV-head count; ValueError where the
    JAX package asserts. stack_group: accepted and without effect. The JAX
    package stacks a GQA group's q heads into one TPU block as a schedule
    choice; the Hopper kernel runs one block per (64-row tile, q head), the
    group's heads reading their shared K/V tiles through L2, and computes
    the same function either way.
    """
    del stack_group  # a schedule choice of the TPU kernel: the same function
    window, sinks, disc, pack, k_max = _options(q, k, v, causal, stable, window,
                                                sinks, pack_heads, k_max)
    return _FlashAttention.apply(q, k, v, k_max, causal, sm_scale, q_offset,
                                 window, sinks, disc, pack)


def flash_attention_with_lse(
    q, k, v, *, causal=False, sm_scale=None, q_offset=0, stable=True,
    window=None, sinks=0, pack_heads=None,
):
    """flash_attention that also returns the logsumexp [B, Hq, N] float32
    (natural log; NEG_INF for a row that sees no key). Not differentiable,
    as in the JAX package."""
    window, sinks, disc, pack, k_max = _options(q, k, v, causal, stable, window,
                                                sinks, pack_heads, None)
    with torch.no_grad():  # the plain version would otherwise record a graph
        return _fwd(q, k, v, causal, sm_scale, q_offset, window, sinks, disc,
                    k_max, pack)


def _fwd_q_plain(q, k_q, k_scale, v_q, v_scale, causal, sm_scale, q_offset,
                 window=0, sinks=0, disc=ONLINE, k_max=None, guard=False):
    """The 8-bit forward in plain PyTorch: the cache dequantized to float32
    (values times their per-token scales), then `_fwd_plain`. guard=True
    (FIXED; as JAX's `_fwd` takes it with k_scale): (O, LSE, bad)."""
    _check_guard(guard, disc)
    return _fwd_plain(q, k_q.float() * k_scale, v_q.float() * v_scale, causal,
                      sm_scale, q_offset, window, sinks, disc, k_max, guard)


def _fwd_q_cuda(q, k_q, k_scale, v_q, v_scale, causal, sm_scale, q_offset,
                window=0, sinks=0, disc=ONLINE, k_max=None, guard=False):
    """(O, LSE) from csrc/flash_fwd_q.cu (flash_fwd_sm90.cuh's block body
    over 64-key byte tiles widened to bf16, in 64- or 128-row blocks): q bf16,
    k_q/v_q [B, Hkv, S, D] int8 or float8_e4m3fn with [B, Hkv, S, 1]
    float32 scales, contiguous and 16-byte aligned; k_max (a 0-d device
    tensor) for HYBRID. guard=True (FIXED): (O, LSE, bad), as
    `_fwd`'s, counted in `flash_attention_kv_quant.guard_launches` too."""
    _check_guard(guard, disc)
    check_8bit_cache(q, k_q, k_scale, v_q, v_scale, (*k_q.shape[:3], 1),
                     "8-bit forward")
    b, hq, n, d = q.shape
    if k_q.dim() != 4 or k_q.shape[0] != b or k_q.shape[3] != d:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k_q.shape)} "
                         "do not match")
    if d not in _KERNEL_DIMS:
        raise ValueError(f"the CUDA kernels take d in {_KERNEL_DIMS}, got {d}")
    if n == 0 or k_q.shape[2] == 0:
        raise ValueError("empty query or key sequence")
    _check_k_max(q, disc, k_max)
    o = torch.empty_like(q)
    lse = torch.empty((b, hq, n), dtype=torch.float32, device=q.device)
    bad = torch.zeros((), dtype=torch.int32, device=q.device) if guard else None
    rc = _kernel("fkp_flash_fwd_q", 9, 6)(
        q.data_ptr(), k_q.data_ptr(), k_scale.data_ptr(), v_q.data_ptr(),
        v_scale.data_ptr(), o.data_ptr(), lse.data_ptr(),
        None if k_max is None else k_max.data_ptr(),
        None if bad is None else bad.data_ptr(),
        b, hq, k_q.shape[1], n, k_q.shape[2], d, float(sm_scale * _LOG2E),
        int(bool(causal)), int(q_offset), int(window), int(sinks), int(disc),
        int(k_q.dtype == torch.float8_e4m3fn),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    counters = flash_attention_kv_quant
    setattr(counters, _counter(disc), getattr(counters, _counter(disc)) + 1)
    counters.window_launches += bool(window)
    counters.guard_launches += guard
    _build.check(rc, "flash_fwd_q")
    return (o, lse, bad) if guard else (o, lse)


def flash_attention_kv_quant_with_lse(
    q, k_q, k_scale, v_q, v_scale, *, causal=False, sm_scale=None, q_offset=0,
    stable=True, window=None, sinks=0,
):
    """flash_attention_kv_quant that also returns the logsumexp [B, Hq, N]
    float32, the merge carry of attention over 8-bit KV shards."""
    window, sinks = _band(causal, window, sinks)
    disc = _discipline(stable)
    sm_scale, k_max = _fwd_args(q, k_q, v_q, sm_scale, disc, None, k_scale)
    args = (q, k_q, k_scale, v_q, v_scale, causal, sm_scale, q_offset, window,
            sinks, disc, k_max)
    with torch.no_grad():
        if q.device.type == "cpu":
            return _fwd_q_plain(*args)
        if q.device.type == "cuda":
            return _fwd_q_cuda(*args)
    raise ValueError(f"no forward for device {q.device}")


def flash_attention_kv_quant(
    q: torch.Tensor,
    k_q: torch.Tensor,
    k_scale: torch.Tensor,
    v_q: torch.Tensor,
    v_scale: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: float | None = None,
    q_offset: int = 0,
    stable: bool | str = True,
    window: int | None = None,
    sinks: int = 0,
) -> torch.Tensor:
    """flash_attention against an 8-bit KV cache, forward only (the
    long-context prefill over a quantized cache): k_q, v_q [B, Hkv, S, D]
    int8 or float8_e4m3fn, k_scale, v_scale [B, Hkv, S, 1] float32
    per-token scales (`quantize_kv`). The other arguments are
    flash_attention's; stable="auto" bounds the scores with the norms of
    the dequantized keys. CPU tensors run `_fwd_q_plain`; CUDA tensors
    launch csrc/flash_fwd_q.cu (q bf16, d in {64, 128}) or raise, counting
    in `.launches` (online), `.fixed_launches`, `.hybrid_launches` and
    `.window_launches`."""
    return flash_attention_kv_quant_with_lse(
        q, k_q, k_scale, v_q, v_scale, causal=causal, sm_scale=sm_scale,
        q_offset=q_offset, stable=stable, window=window, sinks=sinks)[0]


# kernel launches by discipline, for showing that a path ran the kernel,
# those of them with a window, and those with the range guard
flash_attention_kv_quant.launches = 0
flash_attention_kv_quant.fixed_launches = 0
flash_attention_kv_quant.hybrid_launches = 0
flash_attention_kv_quant.window_launches = 0
flash_attention_kv_quant.guard_launches = 0


def _ragged_mask(n, s, kv_lens, q_offsets, causal, window=0, sinks=0):
    """[B, 1, N, S] bool: query i of row b sees key j iff j < kv_lens[b] and,
    when causal, j <= i + q_offsets[b] (and, with a window, j is in the
    band of the last `window` positions or among the first `sinks`)."""
    col = torch.arange(s, device=kv_lens.device)
    mask = col[None, None, :] < kv_lens.long()[:, None, None]  # [B, 1, S]
    if causal:
        rows = (torch.arange(n, device=kv_lens.device)[None, :, None]
                + q_offsets.long()[:, None, None])
        mask = mask & _band_mask(rows, col, window, sinks)  # [B, N, S]
    return mask.expand(-1, n, -1)[:, None]


def _fwd_ragged_plain(q, k, v, kv_lens, q_offsets, causal, sm_scale,
                      window=0, sinks=0, disc=ONLINE):
    """The ragged forward in plain PyTorch, in float32: the dense
    `_fwd_plain` with a per-row mask (FIXED: m pinned at 0). kv_lens above
    S count as S."""
    b, hq, n, d = q.shape
    group = hq // k.shape[1]
    s = k.shape[2]
    qf = q.float() * (sm_scale * _LOG2E)
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    scores = qf @ kf.transpose(-1, -2)  # [B, Hq, N, S], log2 domain
    mask = _ragged_mask(n, s, kv_lens, q_offsets, causal, window, sinks)
    p, _, l = _softmax_plain(scores, mask, _fixed_rows(q, sm_scale, disc, None))
    o = (p @ vf) / torch.where(l == 0.0, torch.ones_like(l), l)
    return o.to(q.dtype)


@functools.cache
def _ragged_kernel():
    """fkp_flash_fwd_ragged (the wgmma route): q, k, k_scale, v, v_scale,
    o, kv_lens, q_offsets, then (b, hq, hkv, n, s_max, d), a float scale,
    (causal, window, sinks, disc, kv_type, block_rows) and the stream."""
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    return _build.kernel("fkp_flash_fwd_ragged",
                         [vp] * 8 + [i32] * 6 + [ctypes.c_float] + [i32] * 6
                         + [vp])


@functools.cache
def _slab_kernel():
    """fkp_ragged_slab (the slab route): q, k, k_scale, v, v_scale, kv_lens,
    q_offsets, o, m, l, y (the splits' workspace), then (b, hq, hkv, t,
    s_max, d, n_splits, block_s, block_rows), a float scale, (causal,
    window, sinks, fixed, kv_type) and the stream."""
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    return _build.kernel("fkp_ragged_slab",
                         [vp] * 11 + [i32] * 9 + [ctypes.c_float] + [i32] * 5
                         + [vp])


def _check_ragged_bounds(q, kv_lens, q_offsets):
    b = q.shape[0]
    for name, x in (("kv_lens", kv_lens), ("q_offsets", q_offsets)):
        if x.device != q.device or x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32 on q's device")
        if tuple(x.shape) != (b,) or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous [{b}] tensor")


def _ragged_cuda(q, cache, kv_lens, q_offsets, causal, sm_scale, window,
                 sinks, disc, counters):
    """One launch of the ragged forward on checked inputs: cache (k, v)
    bf16 or (k_q, k_scale, v_q, v_scale) 8-bit, on the route
    `ragged_plan` picks (the slab route's splits merged on the card).
    Counts it in `counters.<discipline>`, `.window_launches` with a window,
    and `.slab_launches` or `.wgmma_launches` by route."""
    from flashattention_kernel_project_tpu_torch.ops import paged_decode as pd

    quant = len(cache) == 4
    k, k_scale, v, v_scale = cache if quant else (cache[0], None, cache[1], None)
    b, hq, t, d = q.shape
    hkv, s_max = k.shape[1], k.shape[2]
    plan = pd.ragged_plan(b, hq, hkv, t, s_max, d, quant)
    # the kernel first: no library, no launch and nothing allocated
    kernel = _slab_kernel() if plan.route == pd.RAGGED_SLAB else _ragged_kernel()
    kv_type = (2 if k.dtype == torch.float8_e4m3fn else 1) if quant else 0
    o = torch.empty_like(q)
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    scale = float(sm_scale * _LOG2E)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if plan.route == pd.RAGGED_SLAB:
        work = [None] * 3
        if plan.n_splits > 1:  # m, l, y of every split, one allocation
            cells = b * hkv * plan.row_tiles * plan.n_splits * plan.block_rows
            ws = torch.empty(cells * (d + 2), dtype=torch.float32,
                             device=q.device)
            work = [ws[:cells], ws[cells:2 * cells], ws[2 * cells:]]
        rc = kernel(
            q.data_ptr(), k.data_ptr(), ptr(k_scale), v.data_ptr(),
            ptr(v_scale), kv_lens.data_ptr(), q_offsets.data_ptr(),
            o.data_ptr(), *map(ptr, work), b, hq, hkv, t, s_max, d,
            plan.n_splits, plan.block_s, plan.block_rows, scale,
            int(bool(causal)), int(window), int(sinks), int(disc == FIXED),
            kv_type, stream)
        counters.slab_launches += 1
    else:
        rc = kernel(
            q.data_ptr(), k.data_ptr(), ptr(k_scale), v.data_ptr(),
            ptr(v_scale), o.data_ptr(), kv_lens.data_ptr(),
            q_offsets.data_ptr(), b, hq, hkv, t, s_max, d, scale,
            int(bool(causal)), int(window), int(sinks), int(disc), kv_type,
            plan.block_rows, stream)
        counters.wgmma_launches += 1
    setattr(counters, _counter(disc), getattr(counters, _counter(disc)) + 1)
    counters.window_launches += bool(window)
    _build.check(rc, f"ragged forward ({plan.route} route)")
    return o


def _fwd_ragged(q, k, v, kv_lens, q_offsets, causal, sm_scale, window=0,
                sinks=0, disc=ONLINE):
    """O of the ragged forward. CPU tensors run `_fwd_ragged_plain`; CUDA
    tensors (bf16, contiguous, d in {64, 128}, int32 bounds on the device)
    launch `_ragged_cuda`'s kernel or raise. The bounds are never read on
    the host. disc: ONLINE or FIXED, counted in
    `flash_attention_ragged.launches` or `.fixed_launches`."""
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"q heads {q.shape[1]} not a multiple of kv heads "
                         f"{k.shape[1]}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return _fwd_ragged_plain(q, k, v, kv_lens, q_offsets, causal, sm_scale,
                                 window, sinks, disc)
    if q.device.type != "cuda":
        raise ValueError(f"no ragged forward for device {q.device}")
    _check_cuda_inputs(q, k, v)
    _check_ragged_bounds(q, kv_lens, q_offsets)
    return _ragged_cuda(q, (k, v), kv_lens, q_offsets, causal, sm_scale,
                        window, sinks, disc, flash_attention_ragged)


def _ragged_discipline(stable) -> int:
    """ONLINE or FIXED: the ragged kernels have no hybrid, so "auto" is
    the online path, as in the JAX package."""
    disc = _discipline(stable)
    return ONLINE if disc == HYBRID else disc


def flash_attention_ragged(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_lens: torch.Tensor,
    q_offsets: torch.Tensor,
    *,
    causal: bool = True,
    sm_scale: float | None = None,
    stable: bool | str = True,
    window: int | None = None,
    sinks: int = 0,
) -> torch.Tensor:
    """Attention with per-row KV lengths and causal query offsets: the
    chunked-prefill forward against a live cache.

    q [B, Hq, N, D]; k, v [B, Hkv, S_max, D] (e.g. the cache buffers);
    kv_lens [B] int32, the valid keys of each row; q_offsets [B] int32, the
    position of query 0. Query i of row b attends key j iff j < kv_lens[b]
    and, when causal, j <= i + q_offsets[b]; window and sinks narrow that
    as flash_attention's do; a row that sees no key gives zeros. Forward
    only (the serving path). Returns [B, Hq, N, D] in q's dtype. stable:
    True (online) or False (fixed-max, flash_attention's contract);
    "auto" is the online path, as in the JAX package, whose ragged kernel
    has no hybrid.
    """
    disc = _ragged_discipline(stable)
    window, sinks = _band(causal, window, sinks)
    return _fwd_ragged(q, k, v, kv_lens, q_offsets, causal, sm_scale, window,
                       sinks, disc)


# kernel launches by discipline, for showing that a path ran the kernel,
# those of them with a window, and by route (ops.paged_decode.ragged_plan)
flash_attention_ragged.launches = 0
flash_attention_ragged.fixed_launches = 0
flash_attention_ragged.window_launches = 0
flash_attention_ragged.slab_launches = 0
flash_attention_ragged.wgmma_launches = 0


def _fwd_ragged_q_plain(q, k_q, k_scale, v_q, v_scale, kv_lens, q_offsets,
                        causal, sm_scale, window=0, sinks=0, disc=ONLINE):
    """The 8-bit ragged forward in plain PyTorch: the cache dequantized to
    float32 (values times their per-token scales), then `_fwd_ragged_plain`."""
    return _fwd_ragged_plain(q, k_q.float() * k_scale, v_q.float() * v_scale,
                             kv_lens, q_offsets, causal, sm_scale, window,
                             sinks, disc)


def _fwd_ragged_q_cuda(q, k_q, k_scale, v_q, v_scale, kv_lens, q_offsets,
                       causal, sm_scale, window=0, sinks=0, disc=ONLINE):
    check_8bit_cache(q, k_q, k_scale, v_q, v_scale, (*k_q.shape[:3], 1),
                     "8-bit ragged forward")
    _check_ragged_bounds(q, kv_lens, q_offsets)
    b, hq, n, d = q.shape
    if k_q.dim() != 4 or k_q.shape[0] != b or k_q.shape[3] != d:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k_q.shape)} "
                         "do not match")
    if d not in _KERNEL_DIMS:
        raise ValueError(f"the CUDA kernels take d in {_KERNEL_DIMS}, got {d}")
    if n == 0 or k_q.shape[2] == 0:
        raise ValueError("empty query or key sequence")
    for name, x in (("q", q), ("k_q", k_q), ("v_q", v_q)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    return _ragged_cuda(q, (k_q, k_scale, v_q, v_scale), kv_lens, q_offsets,
                        causal, sm_scale, window, sinks, disc,
                        flash_attention_ragged_kv_quant)


def flash_attention_ragged_kv_quant(
    q: torch.Tensor,
    k_q: torch.Tensor,
    k_scale: torch.Tensor,
    v_q: torch.Tensor,
    v_scale: torch.Tensor,
    kv_lens: torch.Tensor,
    q_offsets: torch.Tensor,
    *,
    causal: bool = True,
    sm_scale: float | None = None,
    stable: bool | str = True,
    window: int | None = None,
    sinks: int = 0,
) -> torch.Tensor:
    """flash_attention_ragged against an 8-bit KV cache: k_q, v_q
    [B, Hkv, S_max, D] int8 or float8_e4m3fn, k_scale, v_scale
    [B, Hkv, S_max, 1] float32 per-token scales (the engine's 8-bit cache
    layout). The other arguments and the result are flash_attention_ragged's.
    CPU tensors run `_fwd_ragged_q_plain`; CUDA tensors launch the 8-bit
    kernel of `_ragged_cuda`'s route (q bf16, d in {64, 128}, int32 bounds
    on the device) or raise."""
    disc = _ragged_discipline(stable)
    window, sinks = _band(causal, window, sinks)
    if q.shape[1] % k_q.shape[1]:
        raise ValueError(f"q heads {q.shape[1]} not a multiple of kv heads "
                         f"{k_q.shape[1]}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    args = (q, k_q, k_scale, v_q, v_scale, kv_lens, q_offsets, causal,
            sm_scale, window, sinks, disc)
    if q.device.type == "cpu":
        return _fwd_ragged_q_plain(*args)
    if q.device.type == "cuda":
        return _fwd_ragged_q_cuda(*args)
    raise ValueError(f"no ragged forward for device {q.device}")


# kernel launches by discipline, for showing that a path ran the kernel,
# those of them with a window, and by route (ops.paged_decode.ragged_plan)
flash_attention_ragged_kv_quant.launches = 0
flash_attention_ragged_kv_quant.fixed_launches = 0
flash_attention_ragged_kv_quant.window_launches = 0
flash_attention_ragged_kv_quant.slab_launches = 0
flash_attention_ragged_kv_quant.wgmma_launches = 0
