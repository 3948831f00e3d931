"""Streaming single-token GQA decode.

Counterpart of flashattention_kernel_project_tpu/ops/streaming.py
(`streaming_decode`): the contract of `flash_decode` without splits (q
[B, Hq, D], caches [B, Hkv, S, D], lengths [B] read on the device, a length
of 0 giving 0), computed by one program per (sequence, KV head) that
streams its keys through an explicit two-slot pipeline with an online
(m, l, acc). That is `flash_decode`'s Hopper kernel
(csrc/flash_decode_sm90.cuh: 64-key K/V tiles by TMA through a 3-stage
ring, both products on the tensor cores) at one split: on a CUDA tensor
`streaming_decode` launches it with `streaming_plan`'s one split of S
rounded up to whole 64-key tiles, so no workspace and no merge, and counts
the launch in `streaming_decode.launches` (not in flash_decode's). On a CPU
tensor it runs `_streaming_plain`, the same function in plain PyTorch
(flash_decode's plain path with one split).

`seq_chunk` and `block_s` are accepted and checked and do not change the
function: the TPU folded `seq_chunk` sequences into one program to amortise
a per-program cost Hopper blocks do not have (folding 8 of run_all.py's 256
sequences would leave 32 blocks for 132 SMs), and `block_s` sized its VMEM
tiles; the kernel streams 64-key tiles, one block per (sequence, KV head).
"""

from __future__ import annotations

import math

import torch

from flashattention_kernel_project_tpu_torch.ops import flash_decode as fd


def _streaming_plain(q, k_cache, v_cache, lengths, sm_scale):
    """The kernel's function in plain PyTorch, in float32: flash_decode's
    plain partials over one split, merged; q's dtype out."""
    b, hq, d = q.shape
    parts = fd._decode_partials_plain(q, k_cache, v_cache, lengths, 1,
                                      k_cache.shape[2], sm_scale)
    return fd.merge_partials(*parts).reshape(b, hq, d).to(q.dtype)


def streaming_plan(s: int) -> tuple[int, int]:
    """(n_splits, block_s) of the CUDA route for a cache of S keys: one
    split of S rounded up to whole 64-key tiles, JAX's one program per
    (sequence, KV head)."""
    return 1, -(-s // fd._TILE) * fd._TILE


def streaming_decode(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: torch.Tensor,
    *,
    block_s: int = 512,
    sm_scale: float | None = None,
    seq_chunk: int = 1,
) -> torch.Tensor:
    """Single-token GQA decode against a (padded) KV cache, streamed.

    q [B, Hq, D]; k_cache, v_cache [B, Hkv, S, D]; lengths [B] int32, keys
    [0, lengths) attended (lengths above S count as S; 0 gives zeros).
    Query head h reads KV head h // (Hq // Hkv). sm_scale defaults to
    D^-0.5. block_s >= 1 and seq_chunk >= 1 dividing B (a ValueError
    otherwise, where JAX asserts) do not change the function (module
    docstring). Returns [B, Hq, D] in q's dtype. CPU tensors run the plain
    version; CUDA tensors launch csrc/flash_decode_sm90.cuh's kernel once at
    one split (bf16, contiguous, d in {64, 128}, Hq/Hkv in {1, 2, 4, 8}) or
    raise.
    """
    b, hq, d = q.shape
    hkv = k_cache.shape[1]
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    if seq_chunk < 1 or b % seq_chunk:
        raise ValueError(f"seq_chunk={seq_chunk} must divide the batch {b}")
    if block_s < 1:
        raise ValueError(f"block_s={block_s} must be >= 1")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return _streaming_plain(q, k_cache, v_cache, lengths, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"no decode for device {q.device}")
    n_splits, split = streaming_plan(k_cache.shape[2])
    return fd._decode_cuda(q, k_cache, v_cache, lengths, n_splits, split,
                           sm_scale, counter=streaming_decode)


# kernel launches, for showing that a path ran the kernel
streaming_decode.launches = 0
