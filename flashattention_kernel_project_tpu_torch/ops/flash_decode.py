"""Split-KV single-token GQA decode against a linear bf16 KV cache.

Counterpart of flashattention_kernel_project_tpu/ops/flash_decode.py
(`flash_decode`, `merge_partials`). The cache's key axis is cut into
`n_splits` independent splits; each emits unnormalized partials (m, l, y)
over its keys below `lengths`, and `merge_partials` combines them. On a
CUDA tensor the partials come from the hand-written Hopper kernel in
csrc/flash_decode.cu; on a CPU tensor from `_decode_partials_plain`, the same
function in plain PyTorch. The merge is plain PyTorch on both, as it is a
jnp reduction outside the Pallas kernel in the JAX package.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from flashattention_kernel_project_tpu_torch.ops import _build
from flashattention_kernel_project_tpu_torch.ops.softmax import NEG_INF
from flashattention_kernel_project_tpu_torch.utils.platform import H100_SMS

_KERNEL_DIMS = (64, 128)
_KERNEL_GROUPS = (1, 2, 4, 8)
_MIN_SPLIT = 128  # keys


def default_n_splits(batch: int, kv_heads: int, s_max: int) -> int:
    """Splits that give about two blocks per SM on an H100: B*Hkv alone is
    32 blocks at the serving shape (B=8, Hkv=4), a quarter of the 132 SMs.
    Splits are kept at 128 keys or more, so short caches get fewer. Only the
    order of the sums depends on this. (The TPU default, one split per 4096
    keys, suits a core that runs its grid serially.)"""
    want = -(-2 * H100_SMS // max(batch * kv_heads, 1))
    return max(1, min(want, -(-s_max // _MIN_SPLIT)))


def merge_partials(m, l, y):
    """Combine per-split partials: m, l [..., n_splits, G, 1] and
    y [..., n_splits, G, D] -> [..., G, D]. A row with no live key in any
    split (l == 0 everywhere) gives zeros."""
    m_g = m.amax(dim=-3, keepdim=True)
    alpha = torch.exp(m - m_g)
    l_g = (l * alpha).sum(dim=-3)
    y_g = (y * alpha).sum(dim=-3)
    safe_l = torch.where(l_g == 0.0, torch.ones_like(l_g), l_g)
    return y_g / safe_l


def _decode_partials_plain(q, k, v, lengths, n_splits, block_s, sm_scale):
    """The kernel's partials in plain PyTorch, in float32."""
    b, hq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    g = hq // hkv
    pad = n_splits * block_s - s
    kp = torch.nn.functional.pad(k.float(), (0, 0, 0, pad))
    vp = torch.nn.functional.pad(v.float(), (0, 0, 0, pad))
    kp = kp.view(b, hkv, n_splits, block_s, d)
    vp = vp.view(b, hkv, n_splits, block_s, d)
    qg = q.float().reshape(b, hkv, 1, g, d)
    scores = (qg @ kp.transpose(-1, -2)) * sm_scale  # [B, Hkv, splits, G, bs]
    col = torch.arange(n_splits * block_s, device=q.device)
    live = col[None, :] < lengths.clamp(0, s).to(col.dtype)[:, None]
    mask = live.view(b, 1, n_splits, 1, block_s)
    scores = scores.masked_fill(~mask, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    # a dead split has m == NEG_INF, where exp(s - m) would be 1
    e = torch.exp(scores - m) * mask
    l = e.sum(dim=-1, keepdim=True)
    y = e @ vp
    return m, l, y


@functools.cache
def _kernel():
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    return _build.kernel(
        "fkp_flash_decode",
        [vp, vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, i32,
         ctypes.c_float, vp],
    )


def _check_cuda_inputs(q, k, v, lengths):
    for name, x in (("q", q), ("k_cache", k), ("v_cache", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.dtype != torch.bfloat16:
            raise TypeError(f"the CUDA decode takes bf16; {name} is {x.dtype}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if lengths.device != q.device or lengths.dtype != torch.int32:
        raise TypeError("lengths must be int32 on q's device")
    if not lengths.is_contiguous():
        raise ValueError("lengths must be contiguous")
    b, hq, d = q.shape
    if k.dim() != 4 or k.shape[0] != b or k.shape[3] != d or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not match")
    if tuple(lengths.shape) != (b,):
        raise ValueError(f"lengths must be [{b}], got {tuple(lengths.shape)}")
    if d not in _KERNEL_DIMS:
        raise ValueError(f"the CUDA decode takes d in {_KERNEL_DIMS}, got {d}")
    if hq // k.shape[1] not in _KERNEL_GROUPS:
        raise ValueError(f"the CUDA decode takes Hq/Hkv in {_KERNEL_GROUPS}")
    if k.shape[2] == 0:
        raise ValueError("empty cache")


def _decode_partials_cuda(q, k, v, lengths, n_splits, block_s, sm_scale):
    _check_cuda_inputs(q, k, v, lengths)
    b, hq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    g = hq // hkv
    m = torch.empty((b, hkv, n_splits, g, 1), dtype=torch.float32,
                    device=q.device)
    l = torch.empty_like(m)
    y = torch.empty((b, hkv, n_splits, g, d), dtype=torch.float32,
                    device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        m.data_ptr(), l.data_ptr(), y.data_ptr(),
        b, hq, hkv, s, d, n_splits, block_s, float(sm_scale), stream,
    )
    flash_decode.launches += 1
    _build.check(rc, "flash_decode")
    return m, l, y


def flash_decode(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: torch.Tensor,
    *,
    n_splits: int | None = None,
    sm_scale: float | None = None,
    return_partials: bool = False,
    window: int | None = None,
    sinks: int = 0,
) -> torch.Tensor:
    """Single-token GQA decode against a (padded) KV cache.

    q [B, Hq, D], one new token per sequence; k_cache, v_cache
    [B, Hkv, S, D]; lengths [B] int32, the valid keys per sequence (keys
    [0, lengths) are attended; lengths above S count as S). Query head h
    reads KV head h // (Hq // Hkv). n_splits defaults to
    `default_n_splits`. Returns [B, Hq, D] in q's dtype; a sequence of
    length 0 gives zeros. CPU tensors run the plain version; CUDA tensors
    launch csrc/flash_decode.cu (bf16, contiguous, d in {64, 128},
    Hq/Hkv in {1, 2, 4, 8}) or raise.
    """
    if window is not None or sinks:
        raise NotImplementedError(
            "flash_decode: window/sinks are ROADMAP item A.4"
        )
    if return_partials:
        raise NotImplementedError(
            "flash_decode: return_partials (seq-sharded decode) is ROADMAP "
            "item A.9"
        )
    b, hq, d = q.shape
    hkv, s = k_cache.shape[1], k_cache.shape[2]
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    if n_splits is None:
        n_splits = default_n_splits(b, hkv, s)
    if n_splits < 1:
        raise ValueError(f"n_splits must be >= 1, got {n_splits}")
    block_s = -(-s // n_splits)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        parts = _decode_partials_plain(
            q, k_cache, v_cache, lengths, n_splits, block_s, sm_scale)
    elif q.device.type == "cuda":
        parts = _decode_partials_cuda(
            q, k_cache, v_cache, lengths, n_splits, block_s, sm_scale)
    else:
        raise ValueError(f"no decode for device {q.device}")
    out = merge_partials(*parts)  # [B, Hkv, G, D]
    return out.reshape(b, hq, d).to(q.dtype)


flash_decode.launches = 0  # kernel launches, for showing that a path ran the kernel
