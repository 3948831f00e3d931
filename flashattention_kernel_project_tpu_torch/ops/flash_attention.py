"""Fused GQA attention: forward (O and logsumexp) and backward.

Counterpart of flashattention_kernel_project_tpu/ops/flash_attention.py
(`flash_attention`, `flash_attention_with_lse`, `_fwd`, `_bwd_pallas` and
the custom_vjp around them), in the stable=True discipline. On a CUDA
tensor `_fwd` launches the hand-written Hopper kernel in csrc/flash_fwd.cu
and `_bwd` the two in csrc/flash_bwd_dkdv.cu and csrc/flash_bwd_dq.cu; on a
CPU tensor they run `_fwd_plain` and `_bwd_plain`, the same functions in
plain PyTorch, which the CPU tests hold against the JAX kernels and
chip_smoke.py holds the CUDA kernels against.

Layouts follow the JAX package: q [B, Hq, N, D], k/v [B, Hkv, S, D],
O [B, Hq, N, D] in q's dtype, LSE [B, Hq, N] float32 in natural log.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from flashattention_kernel_project_tpu_torch.ops import _build
from flashattention_kernel_project_tpu_torch.ops.softmax import _LOG2E, NEG_INF

_LN2 = 0.6931471805599453
_KERNEL_DIMS = (64, 128)


def _unsupported(stable, window, sinks, k_max, stack_group, pack_heads):
    """Options of the JAX forward that the port does not take yet (each is
    a ROADMAP item)."""
    if stable is not True:
        raise NotImplementedError(
            "flash_attention: only stable=True is ported; the fixed-max and "
            "'auto' disciplines are ROADMAP item A.1"
        )
    if window is not None or sinks:
        raise NotImplementedError(
            "flash_attention: window/sinks are ROADMAP item A.1"
        )
    if k_max is not None:
        raise NotImplementedError("flash_attention: k_max is ROADMAP item A.1")
    if stack_group or pack_heads:
        raise NotImplementedError(
            "flash_attention: stack_group/pack_heads are TPU layouts with no "
            "Hopper counterpart yet (ROADMAP item A.1)"
        )


def _fwd_plain(q, k, v, causal, sm_scale, q_offset):
    """The forward in plain PyTorch, in float32: the same log2-domain
    scores, masks and empty-row rule as the kernel, with one softmax over
    all keys."""
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
        mask = torch.arange(s, device=q.device)[None, :] <= rows
        scores = scores.masked_fill(~mask, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp2(scores - m)
    if mask is not None:
        # a row with no visible key has m == NEG_INF and exp2(0) == 1
        p = p * mask
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l == 0.0, torch.ones_like(l), l)
    o = (p @ vf) / safe_l
    lse = torch.where(l == 0.0, torch.full_like(l, NEG_INF),
                      m * _LN2 + torch.log(safe_l))
    return o.to(q.dtype), lse[..., 0]


@functools.cache
def _kernel(name="fkp_flash_fwd", n_ptrs=5):
    """A C entry point taking `n_ptrs` pointers, then (b, hq, hkv, n, s, d),
    a float scale, (causal, q_offset) and the stream."""
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    return _build.kernel(
        name,
        [vp] * n_ptrs + [i32] * 6 + [ctypes.c_float, i32, i32, vp],
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


def _fwd(q, k, v, causal, sm_scale, q_offset):
    """(O, LSE). CPU tensors run `_fwd_plain`; CUDA tensors launch
    csrc/flash_fwd.cu (bf16, contiguous, d in {64, 128}) or raise."""
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"q heads {q.shape[1]} not a multiple of kv heads "
                         f"{k.shape[1]}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return _fwd_plain(q, k, v, causal, sm_scale, q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"no forward for device {q.device}")
    _check_cuda_inputs(q, k, v)
    b, hq, n, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    lse = torch.empty((b, hq, n), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        b, hq, hkv, n, s, d, float(sm_scale * _LOG2E), int(bool(causal)),
        int(q_offset), stream,
    )
    _fwd.launches += 1
    _build.check(rc, "flash_fwd")
    return o, lse


_fwd.launches = 0  # kernel launches, for showing that a path ran the kernel


def _bwd_plain(q, k, v, o, lse, do, causal, sm_scale, q_offset):
    """The backward in plain PyTorch, in float32: recompute p from the
    saved logsumexp, GQA folded by repeating K/V over the group and the
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
        mask = torch.arange(s, device=q.device)[None, :] <= rows
        p = torch.where(mask, p, torch.zeros((), device=q.device))
    dv = p.transpose(-1, -2) @ dof
    ds = p * (dof @ vf.transpose(-1, -2) - delta)
    dq = (ds @ kf) * sm_scale
    dk = (ds.transpose(-1, -2) @ qf) * sm_scale
    dk = dk.view(b, hkv, group, s, d).sum(dim=2)
    dv = dv.view(b, hkv, group, s, d).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _launch_bwd(name, outs, q, k, v, do, lse, delta, causal, sm_scale,
                q_offset):
    """Launch one backward kernel writing `outs`; inputs as `_bwd` checked
    them."""
    b, hq, n, d = q.shape
    rc = _kernel(f"fkp_{name}", 6 + len(outs))(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), *(x.data_ptr() for x in outs),
        b, hq, k.shape[1], n, k.shape[2], d, float(sm_scale),
        int(bool(causal)), int(q_offset),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(rc, name)


def _dkdv_cuda(q, k, v, *args):
    """(dk, dv) from csrc/flash_bwd_dkdv.cu."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_bwd("flash_bwd_dkdv", (dk, dv), q, k, v, *args)
    return dk, dv


def _dq_cuda(q, k, v, *args):
    """dq from csrc/flash_bwd_dq.cu."""
    dq = torch.empty_like(q)
    _launch_bwd("flash_bwd_dq", (dq,), q, k, v, *args)
    return dq


def _bwd(q, k, v, o, lse, do, causal, sm_scale, q_offset):
    """(dq, dk, dv) from the forward's (o, lse) and the output gradient.
    CPU tensors run `_bwd_plain`; CUDA tensors launch
    csrc/flash_bwd_dkdv.cu, then csrc/flash_bwd_dq.cu, or raise. delta =
    rowsum(o * do) is plain torch, as the JAX package computes it in XLA
    outside its kernels. Each call launches each kernel once, and counts
    one in `_bwd.launches`."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, o, lse, do, causal, sm_scale, q_offset)
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
    lse = lse.contiguous()
    delta = (o.float() * do.float()).sum(dim=-1)
    args = (q, k, v, do, lse, delta, causal, sm_scale, q_offset)
    dk, dv = _dkdv_cuda(*args)
    dq = _dq_cuda(*args)
    _bwd.launches += 1
    return dq, dk, dv


_bwd.launches = 0  # backward calls that launched both kernels


class _FlashAttention(torch.autograd.Function):
    """flash_attention with its backward: the counterpart of the JAX
    package's custom_vjp (`_flash_attention`). The forward saves (q, k, v,
    o, lse); the backward recomputes p from lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, q_offset):
        o, lse = _fwd(q, k, v, causal, sm_scale, q_offset)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, sm_scale, q_offset)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _bwd(q, k, v, o, lse, do, *ctx.args)
        return dq, dk, dv, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: float | None = None,
    q_offset: int = 0,
    stable: bool = True,
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
    sequence). sm_scale defaults to 1/sqrt(D). A row that sees no key gives
    zeros. Returns [B, Hq, N, D] in q's dtype; differentiable in q, k and v
    (the backward is `_bwd`).
    """
    _unsupported(stable, window, sinks, k_max, stack_group, pack_heads)
    return _FlashAttention.apply(q, k, v, causal, sm_scale, q_offset)


def flash_attention_with_lse(
    q, k, v, *, causal=False, sm_scale=None, q_offset=0, stable=True,
    window=None, sinks=0, pack_heads=None,
):
    """flash_attention that also returns the logsumexp [B, Hq, N] float32
    (natural log; NEG_INF for a row that sees no key). Not differentiable,
    as in the JAX package."""
    _unsupported(stable, window, sinks, None, None, pack_heads)
    with torch.no_grad():  # the plain version would otherwise record a graph
        return _fwd(q, k, v, causal, sm_scale, q_offset)
