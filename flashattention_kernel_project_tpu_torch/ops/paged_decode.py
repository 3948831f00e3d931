"""Paged-KV decode: split-KV GQA decode over a block-table KV cache.

Counterpart of flashattention_kernel_project_tpu/ops/paged_decode.py
(`paged_flash_decode`, `paged_append`, `PagePool`) for a bf16 pool. KV
lives in fixed-size pages of a shared pool, [n_pages, Hkv, page, D] per
layer; each sequence holds a block table of page ids. The decode cuts a
sequence's table into splits of whole pages; each split emits unnormalized
partials (m, l, y) over its keys below the sequence's length, and
ops.flash_decode.merge_partials combines them. On a CUDA tensor the
partials come from the hand-written Hopper kernel in csrc/paged_decode.cu;
on a CPU tensor from `_paged_partials_plain`, the same function in plain
PyTorch.

The pool and the tables are updated in place (`paged_append`), where the
JAX package returns new arrays.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from flashattention_kernel_project_tpu_torch.ops import _build
from flashattention_kernel_project_tpu_torch.ops.flash_decode import (
    _KERNEL_DIMS,
    _KERNEL_GROUPS,
    _decode_partials_plain,
    merge_partials,
)
from flashattention_kernel_project_tpu_torch.utils.platform import H100_SMS

_MAX_PAGE = 128  # the kernel takes pages of 16, 32, ..., 128 rows


def gather_pages_per_split(batch: int, kv_heads: int, max_pages: int) -> int:
    """Pages per split of the gather schedule: splits that give about two
    blocks per SM on an H100, as the linear decode's `default_n_splits`
    (2 pages of 128 at the serving shape: 32 (row, head) pairs x 8 splits).
    The TPU sized its spans in bytes, 2048 bf16 tokens, because its grid
    runs serially. Only the order of the sums depends on this."""
    want = -(-2 * H100_SMS // max(batch * kv_heads, 1))
    return -(-max_pages // max(1, min(want, max_pages)))


def _paged_partials_plain(q, k_pages, v_pages, block_table, lengths,
                          pages_per_split, sm_scale):
    """The kernel's partials in plain PyTorch, in float32: each row's pages
    gathered into a linear [B, Hkv, max_pages*page, D] cache, then the
    linear decode's partials over splits of pages_per_split pages."""
    b, max_pages = block_table.shape
    _, hkv, page, d = k_pages.shape
    ids = block_table.long()

    def linear(pages):  # [B, max_pages, Hkv, page, D] -> [B, Hkv, S, D]
        return pages[ids].permute(0, 2, 1, 3, 4).reshape(b, hkv, -1, d)

    n_splits = -(-max_pages // pages_per_split)
    return _decode_partials_plain(
        q, linear(k_pages), linear(v_pages), lengths, n_splits,
        pages_per_split * page, sm_scale)


@functools.cache
def _kernel():
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    return _build.kernel(
        "fkp_paged_decode", [vp] * 8 + [i32] * 8 + [ctypes.c_float, vp])


def _check_cuda_inputs(q, k_pages, v_pages, block_table, lengths):
    for name, x in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.dtype != torch.bfloat16:
            raise TypeError(f"the CUDA paged decode takes bf16; {name} is {x.dtype}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    for name, x in (("block_table", block_table), ("lengths", lengths)):
        if x.device != q.device or x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32 on q's device")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b, hq, d = q.shape
    if (k_pages.dim() != 4 or k_pages.shape[3] != d
            or v_pages.shape != k_pages.shape):
        raise ValueError(f"shapes q {tuple(q.shape)} k_pages "
                         f"{tuple(k_pages.shape)} v_pages "
                         f"{tuple(v_pages.shape)} do not match")
    if block_table.dim() != 2 or block_table.shape[0] != b:
        raise ValueError(f"block_table must be [{b}, max_pages]")
    if tuple(lengths.shape) != (b,):
        raise ValueError(f"lengths must be [{b}], got {tuple(lengths.shape)}")
    page = k_pages.shape[2]
    if page % 16 or not 16 <= page <= _MAX_PAGE:
        raise ValueError(f"the CUDA paged decode takes pages of 16 to "
                         f"{_MAX_PAGE} rows in steps of 16, got {page}")
    if d not in _KERNEL_DIMS:
        raise ValueError(f"the CUDA paged decode takes d in {_KERNEL_DIMS}, got {d}")
    if hq // k_pages.shape[1] not in _KERNEL_GROUPS:
        raise ValueError(f"the CUDA paged decode takes Hq/Hkv in {_KERNEL_GROUPS}")


def _paged_partials_cuda(q, k_pages, v_pages, block_table, lengths,
                         pages_per_split, sm_scale):
    _check_cuda_inputs(q, k_pages, v_pages, block_table, lengths)
    b, hq, d = q.shape
    _, hkv, page, _ = k_pages.shape
    max_pages = block_table.shape[1]
    n_splits = -(-max_pages // pages_per_split)
    g = hq // hkv
    m = torch.empty((b, hkv, n_splits, g, 1), dtype=torch.float32,
                    device=q.device)
    l = torch.empty_like(m)
    y = torch.empty((b, hkv, n_splits, g, d), dtype=torch.float32,
                    device=q.device)
    rc = _kernel()(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_table.data_ptr(), lengths.data_ptr(),
        m.data_ptr(), l.data_ptr(), y.data_ptr(),
        b, hq, hkv, page, d, max_pages, n_splits, pages_per_split,
        float(sm_scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    paged_flash_decode.launches += 1
    _build.check(rc, "paged_decode")
    return m, l, y


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
    counts as that many). gather=True (the engine's path) cuts the table
    into splits sized for occupancy (`gather_pages_per_split`); False runs
    one page per split, the schedule of the JAX package's one-page-per-
    program kernel. Returns [B, Hq, D] in q's dtype; a sequence of length 0
    gives zeros. CPU tensors run the plain version; CUDA tensors launch
    csrc/paged_decode.cu (bf16, d in {64, 128}, Hq/Hkv in {1, 2, 4, 8},
    pages of 16 to 128 rows in steps of 16) or raise.
    """
    if slots != 2 or copy_only:
        raise NotImplementedError(
            "paged_flash_decode: slots and copy_only tune and probe the TPU's "
            "DMA pipeline; Hopper stage probes are ROADMAP item A.12"
        )
    b, hq, d = q.shape
    hkv = k_pages.shape[1]
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    max_pages = block_table.shape[1]
    pages_per_split = (gather_pages_per_split(b, hkv, max_pages)
                       if gather else 1)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    args = (q, k_pages, v_pages, block_table, lengths, pages_per_split,
            sm_scale)
    if q.device.type == "cpu":
        parts = _paged_partials_plain(*args)
    elif q.device.type == "cuda":
        parts = _paged_partials_cuda(*args)
    else:
        raise ValueError(f"no paged decode for device {q.device}")
    return merge_partials(*parts).reshape(b, hq, d).to(q.dtype)


paged_flash_decode.launches = 0  # kernel launches, for showing that a path ran the kernel


def paged_append(k_pages, v_pages, k_new, v_new, block_table, lengths):
    """Append one token per sequence into its current page, in place:
    k_new, v_new [B, Hkv, D] go to row lengths[b] % page of page
    block_table[b, lengths[b] // page] (the page must already be allocated
    by the PagePool). A sequence past its table's capacity writes to the
    reserved junk page 0 instead of its own last page, as in the JAX
    package. Returns (k_pages, v_pages)."""
    page = k_pages.shape[2]
    max_pages = block_table.shape[1]
    pos = lengths.long()
    slot = pos // page
    ids = block_table.long().gather(1, slot.clamp(0, max_pages - 1)[:, None])[:, 0]
    ids = torch.where(slot >= max_pages, torch.zeros_like(ids), ids)
    off = pos % page
    # advanced indices on dims 0 and 2 put B first: value [B, Hkv, D]
    k_pages[ids, :, off] = k_new.to(k_pages.dtype)
    v_pages[ids, :, off] = v_new.to(v_pages.dtype)
    return k_pages, v_pages


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
