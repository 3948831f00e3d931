"""Ulysses (DeepSpeed-style) sequence parallelism by all-to-all.

Counterpart of flashattention_kernel_project_tpu/parallel/ulysses.py: the
second sequence-parallel strategy beside ring attention. An all-to-all turns
the sequence-sharded activations [B, H, N/P, D] into head-sharded ones [B,
H/P, N, D]; each rank runs the fused kernel (`flash_attention`, row 1 and
its backward, rows 4 and 5) on whole sequences for its heads, and a second
all-to-all turns the output back. Two collectives in all, against P - 1
rotations of the ring, at the price of heads % P == 0. The all-to-all is
`mesh.all_to_all` (dist.all_to_all_single on the axis' group) inside an
autograd Function whose backward is the reverse all-to-all.
"""

from __future__ import annotations

import torch

from flashattention_kernel_project_tpu_torch.ops.flash_attention import flash_attention
from flashattention_kernel_project_tpu_torch.parallel.mesh import (
    all_to_all,
    axis_group,
)
from flashattention_kernel_project_tpu_torch.parallel.ring_attention import _spec


def _seq_to_heads(x, group):
    """[B, H, N/P, D] on each rank -> [B, H/P, N, D]: rank j's block of the
    heads from every rank, the sequence blocks in rank order (JAX's
    all_to_all with split_axis=1, concat_axis=2, tiled=True)."""
    p = torch.distributed.get_world_size(group)
    b, h, n, d = x.shape
    blocks = x.reshape(b, p, h // p, n, d).transpose(0, 1)  # [P, B, H/P, N/P, D]
    got = all_to_all(blocks, group)  # got[j]: rank j's sequence block
    return got.permute(1, 2, 0, 3, 4).reshape(b, h // p, p * n, d)


def _heads_to_seq(x, group):
    """_seq_to_heads' inverse: [B, H/P, N, D] -> [B, H, N/P, D]."""
    p = torch.distributed.get_world_size(group)
    b, h, n, d = x.shape
    blocks = x.reshape(b, h, p, n // p, d).permute(2, 0, 1, 3, 4)
    got = all_to_all(blocks, group)  # got[j]: rank j's heads
    return got.transpose(0, 1).reshape(b, p * h, n // p, d)


class _SeqToHeads(torch.autograd.Function):
    """_seq_to_heads, whose gradient is _heads_to_seq."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _seq_to_heads(x, group)

    @staticmethod
    def backward(ctx, g):
        return _heads_to_seq(g, ctx.group), None


class _HeadsToSeq(torch.autograd.Function):
    """_heads_to_seq, whose gradient is _seq_to_heads."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _heads_to_seq(x, group)

    @staticmethod
    def backward(ctx, g):
        return _seq_to_heads(g, ctx.group), None


def ulysses_attention(mesh, *, causal: bool = True, sm_scale: float | None = None,
                      seq_axis: str = "sp", data_axis: str | None = "data"):
    """fn(q [B, Hq, N/P, D], k, v [B, Hkv, S/P, D]) on the rank's sequence
    shards -> its shard of the output, differentiable in q, k and v. The
    query and KV head counts must be multiples of the `seq_axis` size P
    (ValueError otherwise: GQA works where Hkv % P == 0; else shard the query
    heads and replicate K, V before calling). `fn.spec` is the layout of
    q, k, v and the output."""
    group = axis_group(mesh, seq_axis)

    def fn(q, k, v):
        p = torch.distributed.get_world_size(group)
        if q.shape[1] % p or k.shape[1] % p:
            raise ValueError(f"ulysses_attention cuts {q.shape[1]} query and "
                             f"{k.shape[1]} KV heads over {p} ranks: each must "
                             "be a multiple of the axis size")
        qh, kh, vh = (_SeqToHeads.apply(x, group) for x in (q, k, v))
        o = flash_attention(qh, kh, vh, causal=causal, sm_scale=sm_scale)
        return _HeadsToSeq.apply(o, group)

    fn.spec = _spec(mesh, seq_axis, data_axis)
    return fn
