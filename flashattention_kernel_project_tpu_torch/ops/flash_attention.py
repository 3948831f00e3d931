"""Fused GQA attention forward: O and logsumexp.

Counterpart of flashattention_kernel_project_tpu/ops/flash_attention.py
(`flash_attention`, `flash_attention_with_lse`, `_fwd`), forward only and
in the stable=True discipline. On a CUDA tensor `_fwd` launches the
hand-written Hopper kernel in csrc/flash_fwd.cu; on a CPU tensor it runs
`_fwd_plain`, the same function in plain PyTorch, which the CPU tests hold
against the JAX kernel and chip_smoke.py holds the CUDA kernel against.

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
def _kernel():
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    return _build.kernel(
        "fkp_flash_fwd",
        [vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, ctypes.c_float,
         i32, i32, vp],
    )


def _check_cuda_inputs(q, k, v):
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.dtype != torch.bfloat16:
            raise TypeError(f"the CUDA forward takes bf16; {name} is {x.dtype}")
        if x.dim() != 4 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 4-D tensor")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    b, hq, n, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not match")
    if d not in _KERNEL_DIMS:
        raise ValueError(f"the CUDA forward takes d in {_KERNEL_DIMS}, got {d}")
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
    zeros. Returns [B, Hq, N, D] in q's dtype. Forward only: the backward
    kernel is not ported yet.
    """
    _unsupported(stable, window, sinks, k_max, stack_group, pack_heads)
    return _fwd(q, k, v, causal, sm_scale, q_offset)[0]


def flash_attention_with_lse(
    q, k, v, *, causal=False, sm_scale=None, q_offset=0, stable=True,
    window=None, sinks=0, pack_heads=None,
):
    """flash_attention that also returns the logsumexp [B, Hq, N] float32
    (natural log; NEG_INF for a row that sees no key)."""
    _unsupported(stable, window, sinks, None, None, pack_heads)
    return _fwd(q, k, v, causal, sm_scale, q_offset)
