"""Split-KV single-token GQA decode against a linear KV cache, bf16 or
8-bit.

Counterpart of flashattention_kernel_project_tpu/ops/flash_decode.py
(`flash_decode`, `flash_decode_int8`, `flash_decode_fp8`,
`merge_partials`; `fold_partials` is the fold of return_partials=True).
The cache's key axis is cut into `n_splits` independent splits; each
emits unnormalized partials (m, l, y) over its keys below `lengths` (with
a sliding window, only the band's keys and the sinks), and
`merge_partials` combines them. On a CPU tensor the partials come from
`_decode_partials_plain`, `_decode_partials_q_plain` and
`_decode_partials_mxu_plain` and the merge is plain PyTorch, as it is a jnp
reduction outside the Pallas kernel in the JAX package. On a CUDA tensor a
bf16 cache takes the Hopper kernel of csrc/flash_decode_sm90.cuh (64-key
tiles through a TMA ring, both products on the tensor cores), which also
merges the splits: one launch a call, no plain merge. An 8-bit cache (int8
or e4m3 with per-token scales) takes the same header's 8-bit kernel (the
byte tiles widened to bf16 in registers), one launch a call as well;
mxu=True (an int8 cache with both products int8 x int8) takes
csrc/flash_decode_mxu.cu (K's and then V's byte tiles through one TMA ring,
the split's statistics and int8 weights in shared memory), which also
merges its splits: one launch a call.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from flashattention_kernel_project_tpu_torch.ops import _build
from flashattention_kernel_project_tpu_torch.ops.flash_attention import _band_mask
from flashattention_kernel_project_tpu_torch.ops.quant import check_8bit_cache
from flashattention_kernel_project_tpu_torch.ops.softmax import NEG_INF
from flashattention_kernel_project_tpu_torch.utils.platform import (
    H100_SMEM_PER_BLOCK,
    H100_SMEM_PER_SM,
    H100_SMEM_RESERVED_PER_BLOCK,
    H100_SMS,
)

_KERNEL_DIMS = (64, 128)
_KERNEL_GROUPS = (1, 2, 4, 8)
_MIN_SPLIT = 128  # keys
# csrc/flash_decode_sm90.cuh: keys a tile, the ring's stages, its shared
# memory besides the ring (alignment slack, barriers, row statistics) and
# the (batch row, KV head) pairs its split merge counts
_TILE = 64
_STAGES = 3
_SMEM_EXTRA = 1024 + 512
_MAX_COUNTERS = 1 << 18


def _core_n_splits(batch: int, kv_heads: int, s_max: int) -> int:
    """The int8 x int8 decode's splits (kernel 8, mxu=True): about two
    blocks per SM on an H100, B*Hkv alone being 32 blocks at the
    serving shape (B=8, Hkv=4), a quarter of the 132 SMs. Splits are kept at
    128 keys or more, so short caches get fewer. Only the order of the sums
    depends on this (with mxu=True the requantization groups too). (The TPU
    default, one split per 4096 keys, suits a core that runs its grid
    serially.)"""
    want = -(-2 * H100_SMS // max(batch * kv_heads, 1))
    return max(1, min(want, -(-s_max // _MIN_SPLIT)))


def _blocks_per_sm(d: int) -> int:
    """Blocks of the Hopper decode an H100 SM holds at the shared memory of
    its ring (3 stages of a 64-key K and V tile): 2 at d = 128, 4 at d = 64,
    the kernel's __launch_bounds__."""
    ring = _STAGES * 2 * _TILE * d * 2
    return H100_SMEM_PER_SM // (ring + _SMEM_EXTRA + H100_SMEM_RESERVED_PER_BLOCK)


# csrc/flash_decode_sm90.cuh's 8-bit kernel: the blocks an SM holds by
# its registers (LayoutQ::kMinBlocks, its __launch_bounds__: 4 at d = 64,
# 3 at d = 128) and its shared memory besides the ring (alignment slack,
# barriers, row statistics)
_Q_MIN_BLOCKS_D64, _Q_MIN_BLOCKS = 4, 3
_SMEM_EXTRA_Q = 1024 + 512


def _q_stage_bytes(d: int) -> int:
    """A stage of the 8-bit kernel's ring: a 64-key K and V tile of d bytes
    a key and their 64 + 64 f32 scales, rounded up to 1 KB."""
    return -(-(2 * _TILE * d + 2 * _TILE * 4) // 1024) * 1024


def _blocks_per_sm_q(d: int) -> int:
    """Blocks of the 8-bit Hopper decode an H100 SM holds: as many as its
    shared memory takes (4 at d = 128, 7 at d = 64), at most the
    kernel's __launch_bounds__ minimum (3 and 4), which the registers
    set."""
    ring = _STAGES * _q_stage_bytes(d)
    smem = H100_SMEM_PER_SM // (ring + _SMEM_EXTRA_Q + H100_SMEM_RESERVED_PER_BLOCK)
    return min(smem, _Q_MIN_BLOCKS_D64 if d <= 64 else _Q_MIN_BLOCKS)


def _whole_tile_splits(pairs: int, s_max: int, blocks_per_sm: int) -> int:
    """As many splits as keep 132 SMs' blocks full (blocks_per_sm each, over
    the `pairs` blocks a split adds) and no more, each whole 64-key tiles
    and at least two of them; one where the pairs fill the card."""
    tiles = -(-s_max // _TILE)
    want = H100_SMS * blocks_per_sm // max(pairs, 1)
    n = max(1, min(want, tiles // 2))
    return -(-tiles // -(-tiles // n))  # whole tiles, none of them empty


def default_n_splits(batch: int, kv_heads: int, s_max: int, d: int = 128) -> int:
    """Splits of the bf16 decode: as many as keep the card's blocks full
    (132 SMs times the blocks an SM holds at the kernel's ring, over the
    B*Hkv blocks a split adds) and no more, each whole 64-key tiles and at
    least two of them; one where B*Hkv already fills the card (B 256 x
    Hkv 1). At the serving shape (B 8, Hkv 4, S 2048) 8 splits of 256 keys:
    256 blocks. Only the order of the sums depends on this. (The TPU
    default, one split per 4096 keys, suits a core that runs its grid
    serially.)"""
    return _whole_tile_splits(batch * kv_heads, s_max, _blocks_per_sm(d))


def q_n_splits(batch: int, kv_heads: int, s_max: int, d: int = 128) -> int:
    """Splits of the 8-bit decode (kernel 7), by `default_n_splits`'s rule
    at the blocks an SM holds of the 8-bit kernel (`_blocks_per_sm_q`): at
    the serving shape (B 8, Hkv 4, S 2048, d 128) 11 splits of 192 keys,
    352 blocks; `default_block_s` sizes them."""
    return _whole_tile_splits(batch * kv_heads, s_max, _blocks_per_sm_q(d))


def default_block_s(s_max: int, n_splits: int) -> int:
    """Keys a split of the bf16 or 8-bit decode covers at the default split
    count: whole 64-key tiles, ceil(tiles / n_splits) of them."""
    tiles = -(-s_max // _TILE)
    return -(-tiles // n_splits) * _TILE


def fold_partials(m, l, y):
    """Fold the split axis of per-split partials m, l [B, Hkv, n_splits, G,
    1] and y [B, Hkv, n_splits, G, D] into one unnormalized streaming state
    (m [B, Hkv, G, 1], l [B, Hkv, G, 1], y [B, Hkv, G, D], m in natural-log
    units), as the JAX package's return_partials does: the state a
    sequence-sharded decode gathers across ranks and merges with
    `merge_partials`. A row with no live key keeps l = 0, y = 0 and m =
    NEG_INF, so it weighs nothing in that merge."""
    m_g = m.amax(dim=-3)
    alpha = torch.exp(m - m_g[..., None, :, :])
    return m_g, (l * alpha).sum(dim=-3), (y * alpha).sum(dim=-3)


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


def _decode_band(window, sinks):
    """(window, sinks) as the kernels take them, window 0 meaning none. As
    in the JAX decode, sinks count only under a window; window must be >=
    1 (a ValueError where JAX asserts)."""
    if window is not None and window < 1:
        raise ValueError(f"window={window} must be >= 1")
    if sinks < 0:
        raise ValueError(f"sinks={sinks} must be >= 0")
    return (window, sinks) if window is not None else (0, 0)


def _split_rows(x, n_splits, block_s):
    """[B, Hkv, S, X] -> [B, Hkv, n_splits, block_s, X], zero-padded past S."""
    b, hkv, s, width = x.shape
    xp = torch.nn.functional.pad(x, (0, 0, 0, n_splits * block_s - s))
    return xp.view(b, hkv, n_splits, block_s, width)


def _split_mask(lengths, s, n_splits, block_s, window, sinks, device):
    """[B, 1, n_splits, 1, block_s] bool: the keys below the length (lengths
    above S count as S), and with a window (> 0) only the last `window` of
    them and the first `sinks` (the forward's band for the query at
    position length - 1)."""
    col = torch.arange(n_splits * block_s, device=device)
    pos = lengths.clamp(0, s).to(col.dtype)[:, None] - 1
    return _band_mask(pos, col, window, sinks).view(-1, 1, n_splits, 1, block_s)


def _decode_partials_plain(q, k, v, lengths, n_splits, block_s, sm_scale,
                           window=0, sinks=0):
    """The kernel's partials in plain PyTorch, in float32: keys below the
    length, and with a window (> 0) only the last `window` of them and the
    first `sinks` (the forward's band for the query at position length -
    1)."""
    b, hq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    g = hq // hkv
    kp = _split_rows(k.float(), n_splits, block_s)
    vp = _split_rows(v.float(), n_splits, block_s)
    qg = q.float().reshape(b, hkv, 1, g, d)
    scores = (qg @ kp.transpose(-1, -2)) * sm_scale  # [B, Hkv, splits, G, bs]
    mask = _split_mask(lengths, s, n_splits, block_s, window, sinks, q.device)
    return _split_partials(scores, mask, vp)


def _split_partials(scores, mask, vp):
    """(m, l, y) of each split from its scores [B, Hkv, splits, G, bs]
    (natural log) where `mask` holds, against its V rows [B, Hkv, splits,
    bs, D]."""
    scores = scores.masked_fill(~mask, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    # a dead split has m == NEG_INF, where exp(s - m) would be 1
    e = torch.exp(scores - m) * mask
    return m, e.sum(dim=-1, keepdim=True), e @ vp


_DECODE_ARGS = [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                      ctypes.c_void_p]


@functools.cache
def _kernel():
    """fkp_flash_decode: q, k, v, lengths, m, l, y, then (b, hq, hkv, s, d,
    n_splits, block_s), sm_scale, (window, sinks) and the stream: the
    splits' partials."""
    return _build.kernel("fkp_flash_decode", [ctypes.c_void_p] * 7 + _DECODE_ARGS)


@functools.cache
def _kernel_out():
    """fkp_flash_decode_out: q, k, v, lengths, out, m, l, y (the splits'
    workspace, None with one split), then as fkp_flash_decode: the merged
    rows."""
    return _build.kernel("fkp_flash_decode_out", [ctypes.c_void_p] * 8 + _DECODE_ARGS)


def _check_cuda_inputs(q, k, v, lengths):
    for name, x in (("q", q), ("k_cache", k), ("v_cache", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.dtype != torch.bfloat16:
            raise TypeError(f"the CUDA decode takes bf16; {name} is {x.dtype}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    _check_decode_shapes(q, k, v, lengths)


def _check_decode_shapes(q, k, v, lengths):
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


def _decode_partials_cuda(q, k, v, lengths, n_splits, block_s, sm_scale,
                          window=0, sinks=0):
    """The Hopper kernel's partials of each split (fkp_flash_decode), the
    same (m, l, y) as `_decode_partials_plain`."""
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
        b, hq, hkv, s, d, n_splits, block_s, float(sm_scale), int(window),
        int(sinks), stream,
    )
    flash_decode.launches += 1
    flash_decode.window_launches += bool(window)
    _build.check(rc, "flash_decode")
    return m, l, y


def _split_workspace(q, hkv, n_splits):
    """(the f32 m, l and y of every split that a one-launch decode merges on
    the card, in one allocation the caller keeps until its launch, y first
    so that it keeps the allocation's alignment; their pointers m, l, y),
    or (None, three Nones) with one split. The merge's counters take at
    most _MAX_COUNTERS (batch row, KV head) pairs: a ValueError beyond."""
    b, hq, d = q.shape
    if n_splits == 1:
        return None, [None] * 3
    if b * hkv > _MAX_COUNTERS:
        raise ValueError(f"the CUDA decode merges more than one split for at "
                         f"most {_MAX_COUNTERS} (batch row, KV head) pairs, "
                         f"got {b * hkv}")
    rows = b * hq * n_splits
    ws = torch.empty(rows * (d + 2), dtype=torch.float32, device=q.device)
    m = ws.data_ptr() + 4 * rows * d
    return ws, [m, m + 4 * rows, ws.data_ptr()]


def _decode_plain(q, k, v, lengths, n_splits, block_s, sm_scale, window=0,
                  sinks=0):
    """flash_decode in plain PyTorch: the plain partials through
    `merge_partials`, [B, Hq, D] in q's dtype."""
    b, hq, d = q.shape
    parts = _decode_partials_plain(q, k, v, lengths, n_splits, block_s,
                                   sm_scale, window, sinks)
    return merge_partials(*parts).reshape(b, hq, d).to(q.dtype)


def _decode_cuda(q, k, v, lengths, n_splits, block_s, sm_scale, window=0,
                 sinks=0, counter=None):
    """flash_decode on the card in one launch (fkp_flash_decode_out): the
    kernel merges its splits itself, through an f32 workspace of their
    partials when there are more than one. The launch counts in
    `flash_decode.launches` (and `.window_launches` with a window), or in
    `counter.launches` where a counter is given (streaming_decode's)."""
    _check_cuda_inputs(q, k, v, lengths)
    b, hq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    _ws, work = _split_workspace(q, hkv, n_splits)
    rc = _kernel_out()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), *work, b, hq, hkv, s, d, n_splits, block_s,
        float(sm_scale), int(window), int(sinks),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if counter is None:
        flash_decode.launches += 1
        flash_decode.window_launches += bool(window)
    else:
        counter.launches += 1
    _build.check(rc, "flash_decode")
    return out


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
    reads KV head h // (Hq // Hkv). n_splits: split i covers keys
    [i * block_s, (i + 1) * block_s) with block_s = ceil(S / n_splits);
    None takes `default_n_splits`, whose splits are whole 64-key tiles
    (`default_block_s`). window: the query (at position lengths - 1) sees
    only keys [lengths - window, lengths), plus the first `sinks` keys
    (sinks count only with a window, as in the JAX decode); a split with no
    such key loads nothing. Returns [B, Hq, D] in q's dtype; a sequence of
    length 0 gives zeros. CPU tensors run the plain version; CUDA tensors
    launch csrc/flash_decode_sm90.cuh's kernel once, the split merge
    included (bf16, contiguous, d in {64, 128}, Hq/Hkv in {1, 2, 4, 8}),
    or raise. Two calls must not run at once on two streams of one device:
    they would share the kernel's split-merge counters.

    return_partials=True skips the merge's normalization and returns the
    folded unnormalized state (m [B, Hkv, G, 1], l [B, Hkv, G, 1], y [B,
    Hkv, G, D], float32, `fold_partials`): what parallel.seq_sharded_decode
    gathers across ranks. On a CUDA tensor the kernel's split partials
    (fkp_flash_decode, one launch) are folded in plain PyTorch.
    """
    window, sinks = _decode_band(window, sinks)
    b, hq, d = q.shape
    hkv, s = k_cache.shape[1], k_cache.shape[2]
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    if n_splits is None:
        n_splits = default_n_splits(b, hkv, s, d)
        block_s = default_block_s(s, n_splits)
    elif n_splits < 1:
        raise ValueError(f"n_splits must be >= 1, got {n_splits}")
    else:
        block_s = -(-s // n_splits)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    args = (q, k_cache, v_cache, lengths, n_splits, block_s, sm_scale, window,
            sinks)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no decode for device {q.device}")
    if return_partials:
        partials = (_decode_partials_plain if q.device.type == "cpu"
                    else _decode_partials_cuda)
        return fold_partials(*partials(*args))
    if q.device.type == "cpu":
        return _decode_plain(*args)
    return _decode_cuda(*args)


# kernel launches, for showing that a path ran the kernel, and those of
# them with a window
flash_decode.launches = 0
flash_decode.window_launches = 0


def _decode_partials_q_plain(q, k_q, k_scale, v_q, v_scale, lengths, n_splits,
                             block_s, sm_scale, window=0, sinks=0):
    """The 8-bit kernel's partials in plain PyTorch: the cache dequantized
    to float32 (values times their per-token scales), then the bf16 plain
    path's arithmetic."""
    return _decode_partials_plain(q, k_q.float() * k_scale,
                                  v_q.float() * v_scale, lengths, n_splits,
                                  block_s, sm_scale, window, sinks)


def _decode_q_plain(q, k_q, k_scale, v_q, v_scale, lengths, n_splits,
                    block_s, sm_scale, window=0, sinks=0):
    """flash_decode_int8 (mxu=False) in plain PyTorch: the plain partials
    through `merge_partials`, [B, Hq, D] in q's dtype."""
    b, hq, d = q.shape
    parts = _decode_partials_q_plain(q, k_q, k_scale, v_q, v_scale, lengths,
                                     n_splits, block_s, sm_scale, window, sinks)
    return merge_partials(*parts).reshape(b, hq, d).to(q.dtype)


_DECODE_Q_ARGS = ([ctypes.c_int] * 7 + [ctypes.c_float] + [ctypes.c_int] * 3
                  + [ctypes.c_void_p])


@functools.cache
def _kernel_q():
    """fkp_flash_decode_q: q, k, k_scale, v, v_scale, lengths, m, l, y, then
    (b, hq, hkv, s, d, n_splits, block_s), a float scale, (window, sinks),
    fp8 and the stream: the splits' partials."""
    return _build.kernel("fkp_flash_decode_q", [ctypes.c_void_p] * 9 + _DECODE_Q_ARGS)


@functools.cache
def _kernel_q_out():
    """fkp_flash_decode_q_out: q, k, k_scale, v, v_scale, lengths, out, m,
    l, y (the splits' workspace, None with one split), then as
    fkp_flash_decode_q: the merged rows."""
    return _build.kernel("fkp_flash_decode_q_out",
                         [ctypes.c_void_p] * 10 + _DECODE_Q_ARGS)


def _check_q_inputs(q, k_q, k_scale, v_q, v_scale, lengths):
    check_8bit_cache(q, k_q, k_scale, v_q, v_scale, (*k_q.shape[:3], 1),
                     "8-bit decode")
    _check_decode_shapes(q, k_q, v_q, lengths)


def _decode_partials_q_cuda(q, k_q, k_scale, v_q, v_scale, lengths, n_splits,
                            block_s, sm_scale, window=0, sinks=0):
    """The 8-bit Hopper kernel's partials of each split (fkp_flash_decode_q),
    the same (m, l, y) as `_decode_partials_q_plain`."""
    _check_q_inputs(q, k_q, k_scale, v_q, v_scale, lengths)
    b, hq, d = q.shape
    hkv, s = k_q.shape[1], k_q.shape[2]
    g = hq // hkv
    m = torch.empty((b, hkv, n_splits, g, 1), dtype=torch.float32,
                    device=q.device)
    l = torch.empty_like(m)
    y = torch.empty((b, hkv, n_splits, g, d), dtype=torch.float32,
                    device=q.device)
    rc = _kernel_q()(
        q.data_ptr(), k_q.data_ptr(), k_scale.data_ptr(), v_q.data_ptr(),
        v_scale.data_ptr(), lengths.data_ptr(), m.data_ptr(), l.data_ptr(),
        y.data_ptr(), b, hq, hkv, s, d, n_splits, block_s, float(sm_scale),
        int(window), int(sinks), int(k_q.dtype == torch.float8_e4m3fn),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    flash_decode_int8.launches += 1
    flash_decode_int8.window_launches += bool(window)
    _build.check(rc, "flash_decode_q")
    return m, l, y


def _decode_q_cuda(q, k_q, k_scale, v_q, v_scale, lengths, n_splits, block_s,
                   sm_scale, window=0, sinks=0):
    """flash_decode_int8 (mxu=False) on the card in one launch
    (fkp_flash_decode_q_out): the kernel merges its splits itself, through
    an f32 workspace of their partials when there are more than one.
    Counted in `flash_decode_int8.launches` (and `.window_launches` with a
    window)."""
    _check_q_inputs(q, k_q, k_scale, v_q, v_scale, lengths)
    b, hq, d = q.shape
    hkv, s = k_q.shape[1], k_q.shape[2]
    out = torch.empty_like(q)
    _ws, work = _split_workspace(q, hkv, n_splits)
    rc = _kernel_q_out()(
        q.data_ptr(), k_q.data_ptr(), k_scale.data_ptr(), v_q.data_ptr(),
        v_scale.data_ptr(), lengths.data_ptr(), out.data_ptr(), *work, b, hq,
        hkv, s, d, n_splits, block_s, float(sm_scale), int(window), int(sinks),
        int(k_q.dtype == torch.float8_e4m3fn),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    flash_decode_int8.launches += 1
    flash_decode_int8.window_launches += bool(window)
    _build.check(rc, "flash_decode_q")
    return out


def _quantize_q_rows(q, sm_scale):
    """q [B, Hq, D] quantized per row as the JAX wrapper does for mxu=True
    (flash_decode.py:485-490): qsc = (max|q| == 0 ? 1 : max|q|) * (1 / 127),
    q_i8 = round(q / qsc), half to even. Returns (q_i8 as float32 values,
    the row's score scale qsc * sm_scale [B, Hq, 1])."""
    qf = q.float()
    qmax = qf.abs().amax(dim=-1, keepdim=True)
    qsc = torch.where(qmax == 0.0, 1.0, qmax) * (1.0 / 127.0)
    return torch.round(qf / qsc), qsc * sm_scale


def _decode_partials_mxu_plain(q, k_q, k_scale, v_q, v_scale, lengths,
                               n_splits, block_s, sm_scale, window=0, sinks=0):
    """Kernel 8's partials in plain PyTorch (int8 cache): q quantized per
    row (`_quantize_q_rows`), the scores f32(q_i8 . k_i8) * (qs * ks), the
    split's softmax statistics, its weights e * vs requantized per row over
    the split (rs = max / 127, ei = floor(ew / rs + 0.5)) and y = f32(ei .
    v_i8) * rs. Both integer products are exact (float64 sums of integers
    below 2^53), as the kernel's int32 sums are."""
    b, hq, d = q.shape
    hkv, s = k_q.shape[1], k_q.shape[2]
    g = hq // hkv
    q_i8, qs = _quantize_q_rows(q, sm_scale)
    kp = _split_rows(k_q.double(), n_splits, block_s)
    vp = _split_rows(v_q.double(), n_splits, block_s)
    ks = _split_rows(k_scale, n_splits, block_s).transpose(-1, -2)  # [.., 1, bs]
    vs = _split_rows(v_scale, n_splits, block_s).transpose(-1, -2)
    s32 = (q_i8.double().reshape(b, hkv, 1, g, d) @ kp.transpose(-1, -2)).float()
    scores = s32 * (qs.reshape(b, hkv, 1, g, 1) * ks)  # [B, Hkv, splits, G, bs]
    mask = _split_mask(lengths, s, n_splits, block_s, window, sinks, q.device)
    scores = scores.masked_fill(~mask, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m) * mask
    l = e.sum(dim=-1, keepdim=True)
    ew = torch.where(mask, e * vs, 0.0)
    r = ew.amax(dim=-1, keepdim=True)
    rs = torch.where(r == 0.0, 1.0, r) * (1.0 / 127.0)
    ei = torch.floor(ew / rs + 0.5)
    y = (ei.double() @ vp).float() * rs
    return m, l, y


_DECODE_MXU_ARGS = ([ctypes.c_int] * 7 + [ctypes.c_float] + [ctypes.c_int] * 2
                    + [ctypes.c_void_p])


@functools.cache
def _kernel_mxu():
    """fkp_flash_decode_mxu: q, k, k_scale, v, v_scale, lengths, m, l, y,
    then (b, hq, hkv, s, d, n_splits, block_s), a float scale, (window,
    sinks) and the stream: the splits' partials."""
    return _build.kernel("fkp_flash_decode_mxu",
                         [ctypes.c_void_p] * 9 + _DECODE_MXU_ARGS)


@functools.cache
def _kernel_mxu_out():
    """fkp_flash_decode_mxu_out: q, k, k_scale, v, v_scale, lengths, out,
    m, l, y (the splits' workspace, None with one split), then as
    fkp_flash_decode_mxu: the merged rows."""
    return _build.kernel("fkp_flash_decode_mxu_out",
                         [ctypes.c_void_p] * 10 + _DECODE_MXU_ARGS)


# csrc/flash_decode_mxu.cu: the bytes of its ring of 64-key byte tiles (4
# stages at d = 128, 8 at d = 64), and a bound on its static shared memory
# besides the int8 q rows' G * d bytes (barriers, row statistics)
_MXU_RING = 32768
_MXU_STATIC = 1024


def _mxu_smem_bytes(g, d, block_s):
    """Shared memory of a kernel-8 block (csrc/flash_decode_mxu.cu): 1 KB
    of alignment slack, the ring and each stage's 64 K scales, the split's
    f32 scores (G a key), V scales and int8 weights (G a key), the int8 q
    rows and the static rest."""
    stages = _MXU_RING // (_TILE * d)
    return (1024 + _MXU_RING + stages * _TILE * 4 + (5 * g + 4) * block_s
            + g * d + _MXU_STATIC)


def _check_mxu_inputs(q, k_q, k_scale, v_q, v_scale, lengths, block_s):
    """The int8 x int8 kernel's checks: an int8 cache as the 8-bit decodes
    take it, and a split whose scores and weights fit a block's shared
    memory (ValueError otherwise)."""
    check_8bit_cache(q, k_q, k_scale, v_q, v_scale, (*k_q.shape[:3], 1),
                     "int8 x int8 decode")
    if k_q.dtype != torch.int8:
        raise TypeError(f"the int8 x int8 decode needs an int8 cache, got {k_q.dtype}")
    _check_decode_shapes(q, k_q, v_q, lengths)
    g, d = q.shape[1] // k_q.shape[1], q.shape[2]
    if _mxu_smem_bytes(g, d, block_s) > H100_SMEM_PER_BLOCK:
        raise ValueError(
            f"the int8 x int8 decode keeps a split's scores and weights in "
            f"shared memory: {block_s} keys at G = {g} need "
            f"{_mxu_smem_bytes(g, d, block_s)} bytes, over the "
            f"{H100_SMEM_PER_BLOCK} a block may hold; use more splits")


def _decode_partials_mxu_cuda(q, k_q, k_scale, v_q, v_scale, lengths, n_splits,
                              block_s, sm_scale, window=0, sinks=0):
    """Kernel 8's partials of each split (fkp_flash_decode_mxu), the same
    (m, l, y) as `_decode_partials_mxu_plain`. Counted in
    `flash_decode_int8.mxu_launches`."""
    _check_mxu_inputs(q, k_q, k_scale, v_q, v_scale, lengths, block_s)
    b, hq, d = q.shape
    hkv, s = k_q.shape[1], k_q.shape[2]
    g = hq // hkv
    m = torch.empty((b, hkv, n_splits, g, 1), dtype=torch.float32,
                    device=q.device)
    l = torch.empty_like(m)
    y = torch.empty((b, hkv, n_splits, g, d), dtype=torch.float32,
                    device=q.device)
    rc = _kernel_mxu()(
        q.data_ptr(), k_q.data_ptr(), k_scale.data_ptr(), v_q.data_ptr(),
        v_scale.data_ptr(), lengths.data_ptr(), m.data_ptr(), l.data_ptr(),
        y.data_ptr(), b, hq, hkv, s, d, n_splits, block_s, float(sm_scale),
        int(window), int(sinks), torch.cuda.current_stream(q.device).cuda_stream,
    )
    flash_decode_int8.mxu_launches += 1
    _build.check(rc, "flash_decode_mxu")
    return m, l, y


def _decode_mxu_cuda(q, k_q, k_scale, v_q, v_scale, lengths, n_splits, block_s,
                     sm_scale, window=0, sinks=0):
    """flash_decode_int8(mxu=True) on the card in one launch
    (fkp_flash_decode_mxu_out): the kernel merges its splits itself,
    through an f32 workspace of their partials when there are more than
    one. Counted in `flash_decode_int8.mxu_launches`."""
    _check_mxu_inputs(q, k_q, k_scale, v_q, v_scale, lengths, block_s)
    b, hq, d = q.shape
    hkv, s = k_q.shape[1], k_q.shape[2]
    out = torch.empty_like(q)
    _ws, work = _split_workspace(q, hkv, n_splits)
    rc = _kernel_mxu_out()(
        q.data_ptr(), k_q.data_ptr(), k_scale.data_ptr(), v_q.data_ptr(),
        v_scale.data_ptr(), lengths.data_ptr(), out.data_ptr(), *work, b, hq,
        hkv, s, d, n_splits, block_s, float(sm_scale), int(window), int(sinks),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    flash_decode_int8.mxu_launches += 1
    _build.check(rc, "flash_decode_mxu")
    return out


def mxu_n_splits(batch: int, kv_heads: int, s_max: int, g: int, d: int) -> int:
    """The int8 x int8 decode's default splits: `_core_n_splits`, or the
    fewest more whose split (`mxu_block_s`) keeps its scores and weights in
    a block's shared memory (`_mxu_smem_bytes`). Where the core rule's
    split fits, this is the core rule; past it (one split of 8192 keys at
    G 4 once B * Hkv reaches 264) the split is cut to what fits."""
    n = _core_n_splits(batch, kv_heads, s_max)
    while _mxu_smem_bytes(g, d, mxu_block_s(s_max, n)) > H100_SMEM_PER_BLOCK:
        n += 1
    return n


def mxu_block_s(s: int, n_splits: int) -> int:
    """Keys a split of the int8 x int8 decode covers: ceil(S / n_splits)
    rounded up to a multiple of 32, JAX's rule (flash_decode.py:497-502).
    Each split is one requantization group of the exp weights, so the same
    n_splits gives the same function in both packages."""
    block_s = -(-s // n_splits)
    return block_s + (-block_s) % 32


def flash_decode_int8(
    q: torch.Tensor,
    k_q: torch.Tensor,
    k_scale: torch.Tensor,
    v_q: torch.Tensor,
    v_scale: torch.Tensor,
    lengths: torch.Tensor,
    *,
    n_splits: int | None = None,
    sm_scale: float | None = None,
    return_partials: bool = False,
    window: int | None = None,
    sinks: int = 0,
    mxu: bool | None = None,
) -> torch.Tensor:
    """flash_decode against an 8-bit KV cache with per-token scales.

    k_q, v_q [B, Hkv, S, D] int8 or float8_e4m3fn; k_scale, v_scale
    [B, Hkv, S, 1] float32, the cache's own layout. The other arguments and
    the result are flash_decode's. CPU tensors run
    `_decode_partials_q_plain` through `merge_partials`; CUDA tensors
    launch csrc/flash_decode_sm90.cuh's 8-bit kernel once, the split merge
    included (q bf16, contiguous, 16-byte aligned, d in {64, 128}, Hq/Hkv
    in {1, 2, 4, 8}), or raise. n_splits None takes `q_n_splits`, splits of
    whole 64-key tiles (`default_block_s`); a caller's n_splits covers
    ceil(S / n_splits) keys a split, as in JAX. window and sinks as
    flash_decode's. `flash_decode_fp8` is the same function. Two calls must
    not run at once on two streams of one device: they would share the
    kernel's split-merge counters.

    mxu=True (an int8 cache only; ValueError for e4m3, where JAX asserts):
    both products int8 x int8, q and the exp weights requantized per row
    (kernel 8 of the JAX package, `_decode_partials_mxu_plain` through
    `merge_partials`; on a CUDA tensor one launch of
    csrc/flash_decode_mxu.cu, the split merge included on counters of its
    own, counted in `.mxu_launches`; two such calls must not run at once on
    two streams of one device either). Each split is one requantization
    group of the weights and is sized by JAX's rule (`mxu_block_s`);
    n_splits defaults to `mxu_n_splits` (the core rule, `_core_n_splits`,
    cut to splits that fit the kernel's shared memory), where JAX's default
    is one split per 4096 keys. A caller's split must fit the kernel's
    shared memory (ValueError otherwise).

    return_partials=True returns flash_decode's folded state (m, l, y),
    from the kernel's split partials on a CUDA tensor (fkp_flash_decode_q,
    or fkp_flash_decode_mxu with mxu=True; one launch) folded in plain
    PyTorch.
    """
    if mxu and k_q.dtype != torch.int8:
        raise ValueError(f"mxu=True needs an int8 cache, got {k_q.dtype}")
    window, sinks = _decode_band(window, sinks)
    b, hq, d = q.shape
    hkv, s = k_q.shape[1], k_q.shape[2]
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    if n_splits is not None and n_splits < 1:
        raise ValueError(f"n_splits must be >= 1, got {n_splits}")
    if mxu:
        n_splits = n_splits or mxu_n_splits(b, hkv, s, hq // hkv, d)
        block_s = mxu_block_s(s, n_splits)
    elif n_splits is None:
        n_splits = q_n_splits(b, hkv, s, d)
        block_s = default_block_s(s, n_splits)
    else:
        block_s = -(-s // n_splits)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    args = (q, k_q, k_scale, v_q, v_scale, lengths, n_splits, block_s,
            sm_scale, window, sinks)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no decode for device {q.device}")
    if return_partials:
        partials = {("cpu", False): _decode_partials_q_plain,
                    ("cpu", True): _decode_partials_mxu_plain,
                    ("cuda", False): _decode_partials_q_cuda,
                    ("cuda", True): _decode_partials_mxu_cuda}
        return fold_partials(*partials[q.device.type, bool(mxu)](*args))
    if q.device.type == "cuda":
        return (_decode_mxu_cuda if mxu else _decode_q_cuda)(*args)
    if not mxu:
        return _decode_q_plain(*args)
    parts = _decode_partials_mxu_plain(*args)
    return merge_partials(*parts).reshape(b, hq, d).to(q.dtype)


# kernel launches, for showing that a path ran the kernel, those of them
# with a window, and those of the int8 x int8 kernel (mxu=True)
flash_decode_int8.launches = 0
flash_decode_int8.window_launches = 0
flash_decode_int8.mxu_launches = 0

# an e4m3 cache takes the same function and kernel
flash_decode_fp8 = flash_decode_int8
