"""Paged-KV attention: split-KV GQA decode and the multi-token causal
extend over a block-table KV cache, bf16 or 8-bit.

Counterpart of flashattention_kernel_project_tpu/ops/paged_decode.py
(`paged_flash_decode`, `paged_flash_decode_quant`, `paged_flash_extend`,
`paged_append`, `paged_append_chunk`, `paged_append_quant`,
`paged_append_chunk_quant`, `PagePool`). KV lives in fixed-size pages of a
shared pool, [n_pages, Hkv, page, D] per layer; each sequence holds a block
table of page ids. The decode cuts a sequence's keys into splits of whole
64-key tiles (`decode_plan`); each split gives unnormalized partials (m, l,
y) over its keys below the sequence's length, and the splits merge. On a
CUDA tensor that is one launch of the Hopper kernel of
csrc/paged_extend_sm90.cuh at T = 1 (built by csrc/paged_decode*.cu),
which merges the splits itself; on a CPU tensor `_paged_partials_plain`,
the same partials in plain PyTorch, through ops.flash_decode.merge_partials.
The extend (the speculative verify step) scores T appended tokens per
sequence against its pages: on a CUDA tensor the same header's kernel
(built by paged_extend.cu and paged_extend_q.cu), split over the pages
(`extend_n_splits`) with the split merge on the card, one launch a call;
on a CPU tensor `_paged_extend_plain` (`_paged_extend_partials_plain`
gives the kernel's split partials). An 8-bit pool (int8 or
float8_e4m3fn) keeps each token's K and V scales in scale pools
[n_pages, Hkv, 1, page] float32, lane-major as in the JAX package; its
kernels are the 8-bit instances of the same sources, and its plain
versions (`_paged_partials_q_plain`, `_paged_extend_q_plain`) dequantize
the gathered rows.

The gather schedule's two probe options follow JAX's: `slots` (the
depth of the TPU gather's DMA ring) is the depth of the kernel's TMA ring
(2, 3 or 4 stages), with the output bit-equal at every depth; `copy_only`
runs the same loads with no attention math (`_paged_copy_only_plain` on a
CPU tensor), at slots=2 only. The plain versions accept any slots >= 2
and ignore it.

The pool and the tables are updated in place (`paged_append`,
`paged_append_chunk` and their 8-bit forms, which quantize each token once
as they write it), where the JAX package returns new arrays.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from flashattention_kernel_project_tpu_torch.ops import _build
from flashattention_kernel_project_tpu_torch.ops.flash_attention import (
    _LN2,
    _check_ragged_bounds,
    _fwd_ragged_plain,
)
from flashattention_kernel_project_tpu_torch.ops.flash_decode import (
    _KERNEL_DIMS,
    _KERNEL_GROUPS,
    _TILE,
    _blocks_per_sm,
    _decode_partials_plain,
    default_block_s,
    _split_mask,
    _split_partials,
    _split_rows,
    merge_partials,
)
from flashattention_kernel_project_tpu_torch.ops.quant import (
    check_8bit_cache,
    quantizer_for,
)
from flashattention_kernel_project_tpu_torch.ops.softmax import _LOG2E
from flashattention_kernel_project_tpu_torch.utils.platform import H100_SMS

_MAX_PAGE = 128  # the kernels take pages of 16, 32, ..., 128 rows
# csrc/paged_extend_sm90.cuh: the splits a call takes and the (batch row,
# KV head, row tile) triples its split merge counts
_EXTEND_MAX_SPLITS = 64
_EXTEND_MAX_COUNTERS = 1 << 18
_KERNEL_SLOTS = (2, 3, 4)  # the ring depths the decode is built for
_DECODE_ROWS = 16  # csrc/paged_extend_sm90.cuh's kDecodeRows: one slab of G rows


def _check_slots(slots: int, device: torch.device,
                 copy_only: bool = False) -> None:
    if slots < 2:
        raise ValueError(f"slots={slots}: the gather needs at least 2")
    if copy_only and slots != 2:
        raise ValueError(f"copy_only runs at slots=2 only, got slots={slots}")
    if device.type == "cuda" and slots not in _KERNEL_SLOTS:
        raise ValueError(f"the CUDA paged decode takes slots in {_KERNEL_SLOTS}, "
                         f"got {slots}")


def decode_plan(batch: int, kv_heads: int, page: int, max_pages: int,
                d: int = 128, gather: bool = True) -> tuple[int, int]:
    """How the paged decode cuts each row's keys: (n_splits, block_s), the
    splits of block_s keys (whole 64-key tiles) that cover the table's
    capacity (max_pages * page; the lengths stay on the device), none of
    them empty. gather=True (the engine's path): the extend's rule at one
    row tile (`extend_n_splits`): as many splits as bring B * Hkv blocks
    to the card's and no more, at least two tiles a split, at most 64; one
    where B * Hkv fills the card (8 splits of 256 keys at the serving
    shape, B 8, Hkv 4, 16 pages of 128). gather=False (JAX's one page a
    program): splits of the fewest whole pages that make whole tiles,
    lcm(page, 64) keys, as many pages more each as keep them at 64 or
    fewer; one split where B * Hkv passes the split merge's 2^18
    counters. Only the order of the sums depends on this (and copy_only's
    output, a sum over the splits)."""
    capacity = max_pages * page
    if gather:
        n = extend_n_splits(batch, kv_heads, 1, capacity, d)
        return n, default_block_s(capacity, n)
    unit = math.lcm(page, _TILE)
    units = -(-capacity // unit)
    per = (units if batch * kv_heads > _EXTEND_MAX_COUNTERS
           else -(-units // _EXTEND_MAX_SPLITS))
    block_s = per * unit
    return -(-capacity // block_s), block_s


def _linear_rows(pages, block_table):
    """Each row's pages in table order: [n_pages, Hkv, page, D] ->
    [B, Hkv, max_pages * page, D]."""
    b = block_table.shape[0]
    _, hkv, _, d = pages.shape
    return (pages[block_table.long()].permute(0, 2, 1, 3, 4)
            .reshape(b, hkv, -1, d))


def _linear_scales(scale_pages, block_table):
    """Each row's lane-major scales in table order: [n_pages, Hkv, 1, page]
    -> [B, Hkv, max_pages * page, 1], the linear cache's layout."""
    b = block_table.shape[0]
    hkv = scale_pages.shape[1]
    return (scale_pages[block_table.long()].permute(0, 2, 1, 4, 3)
            .reshape(b, hkv, -1, 1))


def _dequantized_rows(pages, scale_pages, block_table):
    """An 8-bit pool's rows in table order, dequantized to float32."""
    return (_linear_rows(pages, block_table).float()
            * _linear_scales(scale_pages, block_table))


def _n_splits(block_table, page, block_s):
    """The splits of block_s keys that cover a table's capacity."""
    return -(-block_table.shape[1] * page // block_s)


def _paged_partials_plain(q, k_pages, v_pages, block_table, lengths,
                          block_s, sm_scale):
    """The kernel's partials in plain PyTorch, in float32: each row's pages
    gathered into a linear [B, Hkv, max_pages*page, D] cache, then the
    linear decode's partials over splits of block_s keys (`decode_plan`)."""
    return _decode_partials_plain(
        q, _linear_rows(k_pages, block_table),
        _linear_rows(v_pages, block_table), lengths,
        _n_splits(block_table, k_pages.shape[2], block_s), block_s, sm_scale)


def _paged_copy_only_plain(q, k_pages, v_pages, block_table, lengths,
                           block_s):
    """The gather with no attention math (JAX's copy_only, paged_decode.py
    :203-210, :338-345), over the port's splits of block_s keys, in plain
    PyTorch: for q head h * G + g, the sum over the live splits (those that
    start below the row's length) of k + v at the split's first key row
    start + g, in float32, split by split in order. Returns [B, Hq, D]
    float32."""
    b, hq, d = q.shape
    _, hkv, page, _ = k_pages.shape
    max_pages = block_table.shape[1]
    g = hq // hkv
    span = block_s
    rows = (_linear_rows(k_pages, block_table).float()
            + _linear_rows(v_pages, block_table).float())  # [B, Hkv, S, D]
    lens = lengths.to(q.device).clamp(0, max_pages * page)
    out = torch.zeros(b, hkv, g, d, dtype=torch.float32, device=q.device)
    for start in range(0, max_pages * page, span):
        live = (start < lens).reshape(b, 1, 1, 1)
        out = out + torch.where(live, rows[:, :, start:start + g], 0.0)
    return out.reshape(b, hq, d)


# b, hq, hkv, page, d, max_pages, n_pages, n_splits, block_s
_DECODE_INTS = [ctypes.c_int] * 9


@functools.cache
def _kernel():
    """fkp_paged_decode: q, k_pages, v_pages, block_table, lengths, o (None:
    partials only), m, l, y (the splits' partials or workspace), then
    (b, hq, hkv, page, d, max_pages, n_pages, n_splits, block_s), the
    log2-domain scale, slots, copy_only and the stream."""
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    return _build.kernel("fkp_paged_decode",
                         [vp] * 9 + _DECODE_INTS + [ctypes.c_float, i32, i32, vp])


@functools.cache
def _kernel_q():
    """fkp_paged_decode_q: q, k_pages, k_scale_pages, v_pages,
    v_scale_pages, block_table, lengths, o, m, l, y, then as
    fkp_paged_decode, with fp8, q_int8 and slots before the stream."""
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    return _build.kernel("fkp_paged_decode_q",
                         [vp] * 11 + _DECODE_INTS
                         + [ctypes.c_float, i32, i32, i32, vp])


def _check_pool_inputs(q, k_pages, v_pages, block_table, what):
    """Device, dtype, layout and shape checks shared by the paged kernels;
    q is [B, Hq, D] or [B, Hq, T, D]."""
    for name, x in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.dtype != torch.bfloat16:
            raise TypeError(f"the CUDA {what} takes bf16; {name} is {x.dtype}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    _check_pool_shapes(q, k_pages, v_pages, block_table, what)


def _check_pool_shapes(q, k_pages, v_pages, block_table, what):
    if block_table.device != q.device or block_table.dtype != torch.int32:
        raise TypeError("block_table must be int32 on q's device")
    if not block_table.is_contiguous():
        raise ValueError("block_table must be contiguous")
    b, d = q.shape[0], q.shape[-1]
    if (k_pages.dim() != 4 or k_pages.shape[3] != d
            or v_pages.shape != k_pages.shape):
        raise ValueError(f"shapes q {tuple(q.shape)} k_pages "
                         f"{tuple(k_pages.shape)} v_pages "
                         f"{tuple(v_pages.shape)} do not match")
    if block_table.dim() != 2 or block_table.shape[0] != b:
        raise ValueError(f"block_table must be [{b}, max_pages]")
    if d not in _KERNEL_DIMS:
        raise ValueError(f"the CUDA {what} takes d in {_KERNEL_DIMS}, got {d}")


def _check_cuda_inputs(q, k_pages, v_pages, block_table, lengths):
    """The bf16 paged decode's checks on the card."""
    _check_pool_inputs(q, k_pages, v_pages, block_table, "paged decode")
    _check_decode_bounds(q, k_pages, lengths)


def _check_decode_bounds(q, k_pages, lengths):
    if lengths.device != q.device or lengths.dtype != torch.int32:
        raise TypeError("lengths must be int32 on q's device")
    b = q.shape[0]
    if tuple(lengths.shape) != (b,) or not lengths.is_contiguous():
        raise ValueError(f"lengths must be a contiguous [{b}] tensor, got "
                         f"{tuple(lengths.shape)}")
    _check_kernel_page(k_pages.shape[2], "paged decode")
    if q.shape[1] // k_pages.shape[1] not in _KERNEL_GROUPS:
        raise ValueError(f"the CUDA paged decode takes Hq/Hkv in {_KERNEL_GROUPS}")


def _check_scale_pools(q, k_pages, k_scale_pages, v_pages, v_scale_pages,
                       block_table, what):
    n_pages, hkv, page, _ = k_pages.shape
    check_8bit_cache(q, k_pages, k_scale_pages, v_pages, v_scale_pages,
                     (n_pages, hkv, 1, page), what)
    _check_pool_shapes(q, k_pages, v_pages, block_table, what)


def _check_block_s(block_s: int, capacity: int) -> int:
    """The splits of a call's block_s on the card: whole 64-key tiles, at
    most 64 splits over the capacity."""
    if block_s <= 0 or block_s % _TILE:
        raise ValueError(f"the CUDA paged decode takes splits of whole "
                         f"{_TILE}-key tiles, got {block_s} keys")
    n_splits = -(-capacity // block_s)
    if n_splits > _EXTEND_MAX_SPLITS:
        raise ValueError(f"the CUDA paged decode takes 1 to "
                         f"{_EXTEND_MAX_SPLITS} splits, got {n_splits}")
    return n_splits


def _decode_cuda(q, pools, block_table, lengths, block_s, sm_scale, whole,
                 slots=2, copy_only=False, q_int8=False):
    """One launch of the Hopper paged decode (csrc/paged_decode*.cu) over
    `pools` ((k_pages, v_pages) bf16, or (k_pages, k_scale_pages, v_pages,
    v_scale_pages) 8-bit), in splits of block_s keys, the ring `slots`
    deep. whole: the output [B, Hq, D] bf16, the splits merged on the card;
    else the kernel's split partials (m, l [B, Hkv, n_splits, G, 1], y
    [B, Hkv, n_splits, G, D], `_paged_partials_plain`'s layout; copy_only:
    the copy probe's, y alone meaningful). q_int8: the int8 score product
    over an int8 pool. Raises ValueError or TypeError before any launch
    on a call the kernel does not take."""
    quant = len(pools) == 4
    k_pages = pools[0]
    if quant:
        what = "int8-score paged decode" if q_int8 else "8-bit paged decode"
        _check_scale_pools(q, *pools, block_table, what)
        _check_decode_bounds(q, k_pages, lengths)
    else:
        _check_cuda_inputs(q, *pools, block_table, lengths)
    _check_slots(slots, torch.device("cuda"), copy_only)  # the card's depths
    if copy_only and (whole or quant):
        raise ValueError("copy_only gives the bf16 gather's split partials")
    if q_int8 and k_pages.dtype != torch.int8:
        raise TypeError(f"the int8 score product needs an int8 pool, got "
                        f"{k_pages.dtype}")
    b, hq, d = q.shape
    n_pages, hkv, page, _ = k_pages.shape
    max_pages = block_table.shape[1]
    n_splits = _check_block_s(block_s, max_pages * page)
    if whole and n_splits > 1 and b * hkv > _EXTEND_MAX_COUNTERS:
        raise ValueError(f"the CUDA paged decode merges more than one split "
                         f"for at most {_EXTEND_MAX_COUNTERS} (batch row, KV "
                         f"head) pairs, got {b * hkv}")
    o = torch.empty_like(q) if whole else None
    work = [None] * 3
    if not whole or n_splits > 1:  # m, l, y of every split, one allocation
        cells = b * hkv * n_splits * _DECODE_ROWS
        ws = torch.empty(cells * (d + 2), dtype=torch.float32, device=q.device)
        work = [ws[:cells], ws[cells:2 * cells], ws[2 * cells:]]
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    args = [x.data_ptr() for x in (q, *pools, block_table, lengths)]
    args += [ptr(o), *map(ptr, work), b, hq, hkv, page, d, max_pages, n_pages,
             n_splits, block_s, float(sm_scale * _LOG2E)]
    if quant:
        args += [int(k_pages.dtype == torch.float8_e4m3fn), int(q_int8), slots]
    else:
        args += [slots, int(copy_only)]
    args.append(torch.cuda.current_stream(q.device).cuda_stream)
    rc = (_kernel_q if quant else _kernel)()(*args)
    counter = paged_flash_decode_quant if quant else paged_flash_decode
    if q_int8:
        counter.q_int8_launches += 1
    elif copy_only:
        counter.copy_only_launches += 1
    else:
        counter.launches += 1
    counter.slots_launches += slots != 2
    _build.check(rc, "paged_decode_q" if quant else "paged_decode")
    if whole:
        return o
    return tuple(_kernel_partials(x, (b, hkv, 1, n_splits, _DECODE_ROWS),
                                  hq // hkv, width)
                 for x, width in zip(work, (1, 1, d)))


def _paged_partials_cuda(q, k_pages, v_pages, block_table, lengths, block_s,
                         sm_scale, slots=2, copy_only=False):
    """The kernel's split partials (m, l, y) over a bf16 pool, for the tests
    and for timing the kernel alone; with copy_only the copy probe's (y:
    each split's k + v rows, m and l 0)."""
    return _decode_cuda(q, (k_pages, v_pages), block_table, lengths, block_s,
                        sm_scale, False, slots, copy_only)


def paged_flash_decode(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_table: torch.Tensor,
    lengths: torch.Tensor,
    *,
    sm_scale: float | None = None,
    gather: bool = True,
    slots: int = 2,
    copy_only: bool = False,
) -> torch.Tensor:
    """Single-token GQA decode against a paged KV cache.

    q [B, Hq, D], one new token per sequence; k_pages, v_pages
    [n_pages, Hkv, page, D], the pool; block_table [B, max_pages] int32,
    each sequence's page ids in order (entries past its pages must still be
    valid ids, e.g. 0; they are never read); lengths [B] int32, the valid
    tokens of each sequence (a length past the table's max_pages pages
    counts as that many). gather=True (the engine's path) cuts the keys
    into splits sized for occupancy, False into splits of the fewest whole
    pages that make whole 64-key tiles, the port's form of the JAX
    package's one-page-per-program kernel (`decode_plan`); the function is
    the same. Returns [B, Hq, D] in q's dtype; a sequence of length 0 gives
    zeros. CPU tensors run the plain version; CUDA tensors launch
    csrc/paged_extend_sm90.cuh's decode once, the split merge included
    (bf16, d in {64, 128}, Hq/Hkv in {1, 2, 4, 8}, pages of 16 to 128 rows
    in steps of 16), or raise. Two calls must not run at once on two
    streams of one device: they would share the kernel's split-merge
    counters.

    The gather's probe options, as in JAX (gather=False ignores both):
    slots (>= 2; on the card 2, 3 or 4) is the depth of the kernel's TMA
    ring and leaves the output bit-equal; copy_only=True loads the same
    keys with no attention math and returns, for q head h * G + g, the
    sum over live splits of k + v at the split's first key row + g
    (`_paged_copy_only_plain`), counted in `.copy_only_launches`; it
    takes slots=2 only. Launches with slots != 2 also count in
    `.slots_launches`.
    """
    b, hq, d = q.shape
    hkv, page = k_pages.shape[1], k_pages.shape[2]
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    _check_slots(slots, q.device, copy_only)
    if not gather:  # JAX's one-page kernel takes neither option
        slots, copy_only = 2, False
    _, block_s = decode_plan(b, hkv, page, block_table.shape[1], d, gather)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    args = (q, k_pages, v_pages, block_table, lengths, block_s, sm_scale)
    if q.device.type == "cpu":
        if copy_only:
            return _paged_copy_only_plain(*args[:6]).to(q.dtype)
        return merge_partials(*_paged_partials_plain(*args)).reshape(
            b, hq, d).to(q.dtype)
    if q.device.type != "cuda":
        raise ValueError(f"no paged decode for device {q.device}")
    if copy_only:
        # [B, Hkv, splits, G, D]: the splits' rows, summed in order
        y = _paged_partials_cuda(*args, copy_only=True)[2]
        out = torch.zeros_like(y[:, :, 0])
        for i in range(y.shape[2]):
            out = out + y[:, :, i]
        return out.reshape(b, hq, d).to(q.dtype)
    return _decode_cuda(q, (k_pages, v_pages), block_table, lengths, block_s,
                        sm_scale, True, slots)


# kernel launches, for showing that a path ran the kernel; the copy probe's;
# and those (of either) with slots != 2
paged_flash_decode.launches = 0
paged_flash_decode.copy_only_launches = 0
paged_flash_decode.slots_launches = 0


def _paged_partials_q_plain(q, k_pages, k_scale_pages, v_pages, v_scale_pages,
                            block_table, lengths, block_s, sm_scale):
    """The 8-bit kernel's partials in plain PyTorch: each row's pages
    gathered and dequantized to float32, then the linear decode's partials
    over splits of block_s keys."""
    return _decode_partials_plain(
        q, _dequantized_rows(k_pages, k_scale_pages, block_table),
        _dequantized_rows(v_pages, v_scale_pages, block_table), lengths,
        _n_splits(block_table, k_pages.shape[2], block_s), block_s, sm_scale)


def _paged_partials_q_cuda(q, k_pages, k_scale_pages, v_pages, v_scale_pages,
                           block_table, lengths, block_s, sm_scale, slots=2):
    """The 8-bit kernel's split partials (m, l, y)."""
    return _decode_cuda(q, (k_pages, k_scale_pages, v_pages, v_scale_pages),
                        block_table, lengths, block_s, sm_scale, False, slots)


def _q_int8_rows(q, sm_scale):
    """q [B, Hq, D] folded into the log2 domain and quantized per row, as
    the JAX wrapper does for q_int8=True (paged_decode.py:1011-1024): qf =
    q * sm_scale * log2(e), qs = max|qf| == 0 ? 1 : max|qf| / 127, q_i8 =
    clip(round(qf / qs), -127, 127), half to even. Returns (q_i8 as float32
    values, qs * ln 2 [B, Hq, 1], the scale that takes an int32 score to
    natural-log units). qmax / 127 divides by a tensor: on a CUDA tensor
    PyTorch takes a scalar divisor as a product with its rounded
    reciprocal, a step off the quotient for some rows, and a row with an
    element at exactly half its largest (qf / qs = 63.5, common in bf16)
    then rounds that element the other way."""
    qf = q.float() * (sm_scale * _LOG2E)
    qmax = qf.abs().amax(dim=-1, keepdim=True)
    qs = torch.where(qmax == 0.0, 1.0, qmax / torch.full_like(qmax, 127.0))
    return torch.round(qf / qs).clamp(-127, 127), qs * _LN2


def _paged_partials_qi8_plain(q, k_pages, k_scale_pages, v_pages,
                              v_scale_pages, block_table, lengths, block_s,
                              sm_scale):
    """Kernel 12's q_int8 partials in plain PyTorch (an int8 pool): q
    quantized per row (`_q_int8_rows`), the scores (f32(q_i8 . k_i8) *
    ks) * (qs * ln 2), the int8 product exact (float64 sums of integers),
    then the 8-bit decode's softmax against the dequantized V rows, over
    splits of block_s keys."""
    b, hq, d = q.shape
    hkv, page = k_pages.shape[1], k_pages.shape[2]
    max_pages = block_table.shape[1]
    n_splits = _n_splits(block_table, page, block_s)
    q_i8, qsl = _q_int8_rows(q, sm_scale)
    kp = _split_rows(_linear_rows(k_pages, block_table).double(), n_splits,
                     block_s)
    ks = _split_rows(_linear_scales(k_scale_pages, block_table), n_splits,
                     block_s).transpose(-1, -2)  # [B, Hkv, splits, 1, bs]
    vp = _split_rows(_dequantized_rows(v_pages, v_scale_pages, block_table),
                     n_splits, block_s)
    g = hq // hkv
    s32 = (q_i8.double().reshape(b, hkv, 1, g, d) @ kp.transpose(-1, -2)).float()
    scores = (s32 * ks) * qsl.reshape(b, hkv, 1, g, 1)
    mask = _split_mask(lengths, max_pages * page, n_splits, block_s, 0, 0,
                       q.device)
    return _split_partials(scores, mask, vp)


def _paged_partials_qi8_cuda(q, k_pages, k_scale_pages, v_pages,
                             v_scale_pages, block_table, lengths, block_s,
                             sm_scale, slots=2):
    """The int8-score instance's split partials (m, l, y)."""
    return _decode_cuda(q, (k_pages, k_scale_pages, v_pages, v_scale_pages),
                        block_table, lengths, block_s, sm_scale, False, slots,
                        q_int8=True)


def paged_flash_decode_quant(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    k_scale_pages: torch.Tensor,
    v_pages: torch.Tensor,
    v_scale_pages: torch.Tensor,
    block_table: torch.Tensor,
    lengths: torch.Tensor,
    *,
    sm_scale: float | None = None,
    gather: bool = True,
    slots: int = 2,
    q_int8: bool | None = None,
) -> torch.Tensor:
    """paged_flash_decode against an 8-bit page pool.

    k_pages, v_pages [n_pages, Hkv, page, D] int8 or float8_e4m3fn;
    k_scale_pages, v_scale_pages [n_pages, Hkv, 1, page] float32, each
    token's scales lane-major (written by paged_append_quant). The other
    arguments, both schedules and the result are paged_flash_decode's. CPU
    tensors run `_paged_partials_q_plain`; CUDA tensors launch the 8-bit
    decode of csrc/paged_extend_sm90.cuh once, the split merge included (q
    bf16, d in {64, 128}, Hq/Hkv in {1, 2, 4, 8}, pages of 16 to 128 rows
    in steps of 16), or raise. Two calls must not run at once on two
    streams of one device: they would share the kernel's split-merge
    counters (those of paged_flash_decode).

    q_int8=True: the scores as int8 x int8 products, q folded into the log2
    domain and quantized per row (`_paged_partials_qi8_plain`; on a CUDA
    tensor the int8-score instance, counted in `.q_int8_launches`). As in
    JAX it applies only with gather=True over an int8 pool: on e4m3 pages
    or with gather=False the ordinary 8-bit kernel runs (`.launches`).

    slots: as paged_flash_decode's, for either kernel (gather=True only, as
    in JAX); launches with slots != 2 also count in `.slots_launches`.
    """
    q_int8 = bool(q_int8) and gather and k_pages.dtype == torch.int8
    _check_slots(slots, q.device)
    if not gather:
        slots = 2
    b, hq, d = q.shape
    hkv, page = k_pages.shape[1], k_pages.shape[2]
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    _, block_s = decode_plan(b, hkv, page, block_table.shape[1], d, gather)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    pools = (k_pages, k_scale_pages, v_pages, v_scale_pages)
    if q.device.type == "cpu":
        plain = _paged_partials_qi8_plain if q_int8 else _paged_partials_q_plain
        parts = plain(q, *pools, block_table, lengths, block_s, sm_scale)
        return merge_partials(*parts).reshape(b, hq, d).to(q.dtype)
    if q.device.type != "cuda":
        raise ValueError(f"no paged decode for device {q.device}")
    return _decode_cuda(q, pools, block_table, lengths, block_s, sm_scale,
                        True, slots, q_int8=q_int8)


# kernel launches, for showing that a path ran the kernel, those of the
# int8-score instance (q_int8=True), and those (of either) with slots != 2
paged_flash_decode_quant.launches = 0
paged_flash_decode_quant.q_int8_launches = 0
paged_flash_decode_quant.slots_launches = 0


def _paged_extend_plain(q, k_pages, v_pages, block_table, new_lengths,
                        old_lengths, sm_scale):
    """The extend in plain PyTorch, in float32: each row's pages gathered
    into a linear [B, Hkv, max_pages*page, D] cache, then the ragged causal
    forward with kv_lens = new_lengths and q_offsets = old_lengths (lengths
    past the table's capacity count as that many)."""
    return _fwd_ragged_plain(
        q, _linear_rows(k_pages, block_table),
        _linear_rows(v_pages, block_table), new_lengths, old_lengths, True,
        sm_scale)


def extend_block_rows(rows: int) -> int:
    """Folded rows (G * T) a block of the Hopper extend holds
    (csrc/paged_extend_sm90.cuh's kRows): the fewest 16-row slabs that hold
    `rows`, up to four, so 16, 32 or 64; more rows take more row tiles (G 8
    and T 9: two of 64). The serving verify's 20 rows take 32."""
    return (16, 32, 64, 64)[min(-(-rows // 16), 4) - 1]


def extend_n_splits(batch: int, kv_heads: int, row_tiles: int, capacity: int,
                    d: int = 128) -> int:
    """Splits of the Hopper extend: as many as bring B * Hkv * row_tiles
    blocks to the card's (132 SMs times the blocks an SM holds at the
    kernel's ring, as `default_n_splits` for the linear decode) and no
    more, each whole 64-key tiles and at least two of them, at most
    _EXTEND_MAX_SPLITS; one where the triples already fill the card. Sized
    by the table's capacity (max_pages * page), not by the lengths, which
    stay on the device. At the serving verify (B 8, Hkv 4, one row tile,
    16 pages of 128) 8 splits of 256 keys. Only the order of the sums
    depends on this."""
    tiles = -(-capacity // _TILE)
    want = H100_SMS * _blocks_per_sm(d) // max(batch * kv_heads * row_tiles, 1)
    n = max(1, min(want, tiles // 2, _EXTEND_MAX_SPLITS))
    return -(-tiles // -(-tiles // n))  # whole tiles, none of them empty


# The ragged forward's two routes on the card (flash_attention_ragged and
# _kv_quant): "slab", the paged extend's block over the linear cache
# (csrc/ragged_slab.cu), and "wgmma", the dense forward's kernel in its
# ragged flavour (csrc/flash_fwd_ragged.cu). Chunks of fewer than
# RAGGED_WGMMA_MIN_T tokens take the slab route. Which route wins turns on
# the rows' lengths, which stay on the device, more than on B: on an H100
# at 16/4 heads (PERF.md, tools/ab_ragged.py --threshold) the slab route
# lost from T 8 at 512 cached keys a row, at B 1 to 8 alike (27% at B 8,
# T 8; 63% at T 14), and won up to T 16 at long rows (1500 keys at B 1,
# the verify's lengths to 2048 at B 8; the wgmma route 34% behind at T 10,
# 15% at T 16; at B 1 the slab route won to T 32 there). The cut at 9
# keeps the larger of the two losses smallest
# (27% and 34%, against 63% and 15% with the cut at 16): past G * T = 32
# folded rows the slab route's blocks take 64 rows.
RAGGED_SLAB = "slab"
RAGGED_WGMMA = "wgmma"
RAGGED_WGMMA_MIN_T = 9


class RaggedPlan(NamedTuple):
    """How the ragged forward cuts a call on the card: its route, the query
    rows a block holds (the slab route's folded G * T rows, 16, 32 or 64;
    the wgmma route's query rows, 64 or 128), the row tiles, and the splits
    of the keys (the slab route's; the wgmma route takes one) of block_s
    keys each."""

    route: str
    block_rows: int
    row_tiles: int
    n_splits: int
    block_s: int


def ragged_plan(b: int, hq: int, hkv: int, t: int, s_max: int, d: int = 128,
                quant: bool = False) -> RaggedPlan:
    """The route and cut of a ragged forward call [b, hq, t, d] against a
    cache of s_max rows and hkv KV heads (8-bit with quant), from static
    shapes only (the lengths stay on the device). T < RAGGED_WGMMA_MIN_T
    (the linear speculative verify, T = spec_k + 1, and chunks of a few
    tokens): the slab route, as the paged extend cuts a call (`extend_block_rows`,
    `extend_n_splits` over the capacity s_max, `default_block_s`). Else the
    wgmma route: blocks of 64 query rows where their grid fits one wave of
    the card's SMs (and always over an 8-bit cache), else 128; one split."""
    tiles = -(-s_max // _TILE)
    if t < RAGGED_WGMMA_MIN_T:
        rows = hq // hkv * t
        block_rows = extend_block_rows(rows)
        row_tiles = -(-rows // block_rows)
        n_splits = extend_n_splits(b, hkv, row_tiles, s_max, d)
        return RaggedPlan(RAGGED_SLAB, block_rows, row_tiles, n_splits,
                          default_block_s(s_max, n_splits))
    fits = -(-t // 64) * hq * b <= H100_SMS
    block_rows = 64 if quant or fits else 128
    return RaggedPlan(RAGGED_WGMMA, block_rows, -(-t // block_rows), 1,
                      tiles * _TILE)


def _check_kernel_page(page: int, what: str) -> None:
    """The paged kernels' page rule on the card: 16 to 128 rows in steps
    of 16 (the extend's TMA boxes are gcd(page, 64) rows)."""
    if page % 16 or not 16 <= page <= _MAX_PAGE:
        raise ValueError(f"the CUDA {what} takes pages of 16 to "
                         f"{_MAX_PAGE} rows in steps of 16, got {page}")


def _extend_partials(q, k_rows, v_rows, new_lengths, old_lengths, n_splits,
                     block_s, sm_scale):
    """The Hopper extend's split partials in plain PyTorch, in float32:
    q [B, Hq, T, D] folded into [B, Hkv, G*T, D] (row gi * T + tr), each
    row's keys k_rows, v_rows [B, Hkv, S, D] cut into n_splits splits of
    block_s keys; folded row r of batch row b sees key j iff j < new_len
    (clamped to S) and j <= old_len + r % T. Returns (m, l [B, Hkv,
    n_splits, G*T, 1], y [B, Hkv, n_splits, G*T, D]) for `merge_partials`
    (m NEG_INF and l = 0 for a row with no live key in a split)."""
    b, hq, t, d = q.shape
    hkv, s = k_rows.shape[1], k_rows.shape[2]
    rows = hq // hkv * t
    if n_splits * block_s < s:
        raise ValueError(f"{n_splits} splits of {block_s} keys miss keys of {s}")
    kp = _split_rows(k_rows.float(), n_splits, block_s)
    vp = _split_rows(v_rows.float(), n_splits, block_s)
    qg = q.float().reshape(b, hkv, 1, rows, d)
    scores = (qg @ kp.transpose(-1, -2)) * sm_scale  # [B, Hkv, splits, R, bs]
    col = torch.arange(n_splits * block_s, device=q.device)
    new = new_lengths.to(q.device).clamp(0, s).long()[:, None, None]
    pos = (old_lengths.to(q.device).long()[:, None, None]
           + (torch.arange(rows, device=q.device) % t)[None, :, None])
    mask = (col < new) & (col <= pos)  # [B, R, splits * bs]
    mask = mask.view(b, rows, n_splits, block_s).transpose(1, 2)[:, None]
    return _split_partials(scores, mask, vp)


def _merge_extend(parts, q):
    """The extend's split partials merged (`merge_partials`) into [B, Hq,
    T, D] in q's dtype."""
    return merge_partials(*parts).reshape(q.shape).to(q.dtype)


def _paged_extend_partials_plain(q, k_pages, v_pages, block_table,
                                 new_lengths, old_lengths, n_splits, block_s,
                                 sm_scale):
    """The bf16 kernel's split partials in plain PyTorch: each row's pages
    gathered into a linear cache, then `_extend_partials`."""
    return _extend_partials(q, _linear_rows(k_pages, block_table),
                            _linear_rows(v_pages, block_table), new_lengths,
                            old_lengths, n_splits, block_s, sm_scale)


def _paged_extend_q_partials_plain(q, k_pages, k_scale_pages, v_pages,
                                   v_scale_pages, block_table, new_lengths,
                                   old_lengths, n_splits, block_s, sm_scale):
    """The 8-bit kernel's split partials in plain PyTorch: each row's pages
    gathered and dequantized to float32, then `_extend_partials`."""
    return _extend_partials(
        q, _dequantized_rows(k_pages, k_scale_pages, block_table),
        _dequantized_rows(v_pages, v_scale_pages, block_table), new_lengths,
        old_lengths, n_splits, block_s, sm_scale)


def extend_plan(q_shape, kv_heads: int, page: int, max_pages: int,
                n_splits: int | None = None):
    """How the Hopper extend cuts a call: (block_rows, row_tiles, n_splits,
    block_s). n_splits None takes `extend_n_splits`; block_s is whole
    64-key tiles (`default_block_s` over the table's capacity)."""
    b, hq, t, d = q_shape
    rows = hq // kv_heads * t
    block_rows = extend_block_rows(rows)
    row_tiles = -(-rows // block_rows)
    capacity = max_pages * page
    if n_splits is None:
        n_splits = extend_n_splits(b, kv_heads, row_tiles, capacity, d)
    elif not 1 <= n_splits <= _EXTEND_MAX_SPLITS:
        raise ValueError(f"the CUDA paged extend takes 1 to "
                         f"{_EXTEND_MAX_SPLITS} splits, got {n_splits}")
    return block_rows, row_tiles, n_splits, default_block_s(capacity, n_splits)


# b, hq, hkv, t, page, d, max_pages, n_pages, n_splits, block_s, block_rows
_EXTEND_INTS = [ctypes.c_int] * 11


@functools.cache
def _extend_kernel():
    """fkp_paged_extend: q, k_pages, v_pages, block_table, new_lengths,
    old_lengths, o (None: partials only), m, l, y (the splits' partials or
    workspace), then (b, hq, hkv, t, page, d, max_pages, n_pages, n_splits,
    block_s, block_rows), the log2-domain scale and the stream."""
    vp = ctypes.c_void_p
    return _build.kernel("fkp_paged_extend",
                         [vp] * 10 + _EXTEND_INTS + [ctypes.c_float, vp])


@functools.cache
def _extend_kernel_q():
    """fkp_paged_extend_q: q, k_pages, k_scale_pages, v_pages,
    v_scale_pages, block_table, new_lengths, old_lengths, o, m, l, y, then
    as fkp_paged_extend, fp8 before the stream."""
    vp = ctypes.c_void_p
    return _build.kernel("fkp_paged_extend_q",
                         [vp] * 12 + _EXTEND_INTS + [ctypes.c_float, ctypes.c_int, vp])


def _extend_cuda(q, pools, block_table, new_lengths, old_lengths, sm_scale,
                 n_splits, whole):
    """One launch of the Hopper extend over `pools` ((k_pages, v_pages) bf16,
    or (k_pages, k_scale_pages, v_pages, v_scale_pages) 8-bit). whole: the
    output [B, Hq, T, D] bf16, the splits merged on the card; else the
    kernel's split partials (m, l, y) in `_extend_partials`' layout, at
    `extend_plan`'s block_s (n_splits None: `extend_n_splits`)."""
    quant = len(pools) == 4
    k_pages = pools[0]
    if quant:
        _check_scale_pools(q, *pools, block_table, "8-bit paged extend")
    else:
        _check_pool_inputs(q, *pools, block_table, "paged extend")
    _check_ragged_bounds(q, new_lengths, old_lengths)
    n_pages, hkv, page, _ = k_pages.shape
    _check_kernel_page(page, "paged extend")
    b, hq, t, d = q.shape
    max_pages = block_table.shape[1]
    block_rows, row_tiles, n_splits, block_s = extend_plan(
        q.shape, hkv, page, max_pages, n_splits)
    if whole and n_splits > 1 and b * hkv * row_tiles > _EXTEND_MAX_COUNTERS:
        raise ValueError(f"the CUDA paged extend merges more than one split "
                         f"for at most {_EXTEND_MAX_COUNTERS} (batch row, KV "
                         f"head, row tile) triples, got {b * hkv * row_tiles}")
    o = torch.empty_like(q) if whole else None
    work = [None] * 3
    if not whole or n_splits > 1:  # m, l, y of every split, one allocation
        cells = b * hkv * row_tiles * n_splits * block_rows
        ws = torch.empty(cells * (d + 2), dtype=torch.float32, device=q.device)
        work = [ws[:cells], ws[cells:2 * cells], ws[2 * cells:]]
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    args = [x.data_ptr() for x in (q, *pools, block_table, new_lengths,
                                   old_lengths)]
    args += [ptr(o), *map(ptr, work), b, hq, hkv, t, page, d, max_pages,
             n_pages, n_splits, block_s, block_rows, float(sm_scale * _LOG2E)]
    if quant:
        args.append(int(k_pages.dtype == torch.float8_e4m3fn))
    args.append(torch.cuda.current_stream(q.device).cuda_stream)
    rc = (_extend_kernel_q if quant else _extend_kernel)()(*args)
    counter = paged_flash_extend_quant if quant else paged_flash_extend
    counter.launches += 1
    _build.check(rc, "paged_extend_q" if quant else "paged_extend")
    if whole:
        return o
    rows = hq // hkv * t
    return tuple(_kernel_partials(x, (b, hkv, row_tiles, n_splits, block_rows),
                                  rows, width)
                 for x, width in zip(work, (1, 1, d)))


def _kernel_partials(x, grid, rows, width):
    """A partial the kernel writes, [B, Hkv, row_tiles, n_splits,
    block_rows(, D)] flat (grid: those five sizes), as `_extend_partials`
    gives it: [B, Hkv, n_splits, rows, width], the padding rows dropped."""
    b, hkv, row_tiles, n_splits, block_rows = grid
    x = x.view(b, hkv, row_tiles, n_splits, block_rows, width)
    return x.transpose(2, 3).reshape(b, hkv, n_splits, -1, width)[:, :, :, :rows]


def _paged_extend_cuda(q, k_pages, v_pages, block_table, new_lengths,
                       old_lengths, sm_scale):
    """paged_flash_extend on the card in one launch (the splits merged in
    the kernel)."""
    return _extend_cuda(q, (k_pages, v_pages), block_table, new_lengths,
                        old_lengths, sm_scale, None, whole=True)


def paged_flash_extend(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_table: torch.Tensor,
    new_lengths: torch.Tensor,
    old_lengths: torch.Tensor,
    *,
    sm_scale: float | None = None,
    k_scale_pages: torch.Tensor | None = None,
    v_scale_pages: torch.Tensor | None = None,
) -> torch.Tensor:
    """Causal multi-token GQA extend against a paged KV cache: the paged
    verify step of speculative decoding.

    q [B, Hq, T, D], T chunk tokens per sequence, whose K/V must already be
    appended to the pages (new_lengths == old_lengths + T); k_pages, v_pages
    [n_pages, Hkv, page, D], the pool; block_table [B, max_pages] int32;
    new_lengths, old_lengths [B] int32, the lengths after and before the
    chunk. Chunk token t of row b attends keys [0, old_lengths[b] + t], the
    semantics of the linear engine's ragged `extend`. Returns
    [B, Hq, T, D] in q's dtype. CPU tensors run `_paged_extend_plain` (any
    page size); CUDA tensors launch csrc/paged_extend_sm90.cuh's kernel
    once, the split merge included (bf16, d in {64, 128}, pages of 16 to
    128 rows in steps of 16, any Hq/Hkv and T: a folded group of G * T rows
    above 64 takes more than one row tile), or raise. Two calls must not run
    at once on two streams of one device: they would share the kernel's
    split-merge counters. With k_scale_pages and v_scale_pages the pool is
    8-bit: `paged_flash_extend_quant`.
    """
    if k_scale_pages is not None or v_scale_pages is not None:
        if k_scale_pages is None or v_scale_pages is None:
            raise ValueError("an 8-bit pool needs k_scale_pages and v_scale_pages")
        return paged_flash_extend_quant(
            q, k_pages, k_scale_pages, v_pages, v_scale_pages, block_table,
            new_lengths, old_lengths, sm_scale=sm_scale)
    b, hq, t, d = q.shape
    if hq % k_pages.shape[1]:
        raise ValueError(f"q heads {hq} not a multiple of kv heads "
                         f"{k_pages.shape[1]}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    args = (q, k_pages, v_pages, block_table, new_lengths, old_lengths,
            sm_scale)
    if q.device.type == "cpu":
        return _paged_extend_plain(*args)
    if q.device.type == "cuda":
        return _paged_extend_cuda(*args)
    raise ValueError(f"no paged extend for device {q.device}")


paged_flash_extend.launches = 0  # kernel launches, for showing that a path ran the kernel


def _paged_extend_q_plain(q, k_pages, k_scale_pages, v_pages, v_scale_pages,
                          block_table, new_lengths, old_lengths, sm_scale):
    """The 8-bit extend in plain PyTorch: each row's pages gathered and
    dequantized to float32, then the ragged causal forward as in
    `_paged_extend_plain`."""
    return _fwd_ragged_plain(
        q, _dequantized_rows(k_pages, k_scale_pages, block_table),
        _dequantized_rows(v_pages, v_scale_pages, block_table), new_lengths,
        old_lengths, True, sm_scale)


def _paged_extend_q_cuda(q, k_pages, k_scale_pages, v_pages, v_scale_pages,
                         block_table, new_lengths, old_lengths, sm_scale):
    """paged_flash_extend_quant on the card in one launch."""
    return _extend_cuda(q, (k_pages, k_scale_pages, v_pages, v_scale_pages),
                        block_table, new_lengths, old_lengths, sm_scale,
                        None, whole=True)


def paged_flash_extend_quant(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    k_scale_pages: torch.Tensor,
    v_pages: torch.Tensor,
    v_scale_pages: torch.Tensor,
    block_table: torch.Tensor,
    new_lengths: torch.Tensor,
    old_lengths: torch.Tensor,
    *,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """paged_flash_extend against an 8-bit page pool (int8 or
    float8_e4m3fn pages, float32 scale pages [n_pages, Hkv, 1, page]), the
    JAX package's paged_flash_extend with k_scale_pages and v_scale_pages.
    CPU tensors run `_paged_extend_q_plain`; CUDA tensors launch the 8-bit
    instances of csrc/paged_extend_sm90.cuh once (q bf16, d in {64, 128},
    pages of 16 to 128 rows in steps of 16, any Hq/Hkv and T) or raise."""
    b, hq, t, d = q.shape
    if hq % k_pages.shape[1]:
        raise ValueError(f"q heads {hq} not a multiple of kv heads "
                         f"{k_pages.shape[1]}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    args = (q, k_pages, k_scale_pages, v_pages, v_scale_pages, block_table,
            new_lengths, old_lengths, sm_scale)
    if q.device.type == "cpu":
        return _paged_extend_q_plain(*args)
    if q.device.type == "cuda":
        return _paged_extend_q_cuda(*args)
    raise ValueError(f"no paged extend for device {q.device}")


paged_flash_extend_quant.launches = 0  # kernel launches, for showing that a path ran the kernel


def _token_slots(page, block_table, lengths, t):
    """(page ids, rows) [B * T] of positions lengths[b] + 0 .. T - 1: row
    pos % page of page block_table[b, pos // page], or of the junk page 0
    past the table's capacity."""
    max_pages = block_table.shape[1]
    pos = lengths.long()[:, None] + torch.arange(t, device=lengths.device)[None, :]
    slot = pos // page
    ids = block_table.long().gather(1, slot.clamp(0, max_pages - 1))
    ids = torch.where(slot >= max_pages, torch.zeros_like(ids), ids)
    return ids.reshape(-1), (pos % page).reshape(-1)


def paged_append(k_pages, v_pages, k_new, v_new, block_table, lengths):
    """Append one token per sequence into its current page, in place:
    k_new, v_new [B, Hkv, D] go to row lengths[b] % page of page
    block_table[b, lengths[b] // page] (the page must already be allocated
    by the PagePool). A sequence past its table's capacity writes to the
    reserved junk page 0 instead of its own last page, as in the JAX
    package. Returns (k_pages, v_pages)."""
    ids, off = _token_slots(k_pages.shape[2], block_table, lengths, 1)
    # advanced indices on dims 0 and 2 put B first: value [B, Hkv, D]
    k_pages[ids, :, off] = k_new.to(k_pages.dtype)
    v_pages[ids, :, off] = v_new.to(v_pages.dtype)
    return k_pages, v_pages


def paged_append_chunk(k_pages, v_pages, k_new, v_new, block_table, lengths):
    """Append T tokens per sequence, in place, in one indexed write per
    pool: k_new, v_new [B, T, Hkv, D]; token t of row b goes to position
    lengths[b] + t, row (lengths[b] + t) % page of page
    block_table[b, (lengths[b] + t) // page], so a chunk may cross page
    edges. A position past the table's capacity writes to the junk page 0,
    as in paged_append (several may collide there; its content is
    garbage by design). Returns (k_pages, v_pages)."""
    b, t, hkv, d = k_new.shape
    ids, off = _token_slots(k_pages.shape[2], block_table, lengths, t)
    # advanced indices on dims 0 and 2 put the B*T tokens first
    k_pages[ids, :, off] = k_new.reshape(b * t, hkv, d).to(k_pages.dtype)
    v_pages[ids, :, off] = v_new.reshape(b * t, hkv, d).to(v_pages.dtype)
    return k_pages, v_pages


def paged_append_chunk_quant(k_pages, k_scale_pages, v_pages, v_scale_pages,
                             k_new, v_new, block_table, lengths):
    """paged_append_chunk into an 8-bit pool, in place: each of the B * T
    tokens' K and V rows (k_new, v_new [B, T, Hkv, D], full precision) is
    quantized once, per token and head (int8 or e4m3, the pool's type),
    its values written to the pages and its scales to the lane-major scale
    pages, in one indexed write per pool. Same junk-page rule. Returns
    (k_pages, k_scale_pages, v_pages, v_scale_pages)."""
    b, t, hkv, d = k_new.shape
    ids, off = _token_slots(k_pages.shape[2], block_table, lengths, t)
    # K and V in one quantizer call: [2, B*T, Hkv, D]
    vals, scales = quantizer_for(k_pages.dtype)(
        torch.stack((k_new, v_new)).reshape(2, b * t, hkv, d), axis=-1)
    k_pages[ids, :, off] = vals[0]
    v_pages[ids, :, off] = vals[1]
    # advanced indices on dims 0 and 3 put the tokens first: [B*T, Hkv]
    k_scale_pages[ids, :, 0, off] = scales[0, ..., 0]
    v_scale_pages[ids, :, 0, off] = scales[1, ..., 0]
    return k_pages, k_scale_pages, v_pages, v_scale_pages


def paged_append_quant(k_pages, k_scale_pages, v_pages, v_scale_pages, k_new,
                       v_new, block_table, lengths):
    """paged_append into an 8-bit pool, in place: k_new, v_new [B, Hkv, D]
    full precision, quantized per token and head as they are written (see
    paged_append_chunk_quant). Returns (k_pages, k_scale_pages, v_pages,
    v_scale_pages)."""
    return paged_append_chunk_quant(
        k_pages, k_scale_pages, v_pages, v_scale_pages, k_new[:, None],
        v_new[:, None], block_table, lengths)


class PagePool:
    """Host-side page allocator for the paged KV cache (a free list).

    The device tensors are owned elsewhere; the pool only hands out page
    ids. Page 0 is reserved as the junk page that padding table entries
    point at (no live token is ever read from it)."""

    def __init__(self, n_pages: int):
        assert n_pages >= 2
        self.n_pages = n_pages
        self._free = list(range(n_pages - 1, 0, -1))  # page 0 reserved

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> list[int]:
        if n > len(self._free):
            raise MemoryError(
                f"page pool exhausted: want {n}, have {len(self._free)}"
            )
        return [self._free.pop() for _ in range(n)]

    def free(self, pages: list[int]) -> None:
        for p in pages:
            if p != 0:
                self._free.append(p)

    def table_for(self, pages: list[int], max_pages: int) -> np.ndarray:
        t = np.zeros(max_pages, np.int32)
        t[: len(pages)] = pages
        return t
