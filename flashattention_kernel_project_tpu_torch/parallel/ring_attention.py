"""Ring (context-parallel) attention over a sequence-sharded KV axis.

Counterpart of flashattention_kernel_project_tpu/parallel/ring_attention.py.
Any partition of the key axis can be attended independently and the
partials combined in normalized (o, lse) form:

  lse = logaddexp(lse_a, lse_b)
  o   = o_a * exp(lse_a - lse) + o_b * exp(lse_b - lse)

Each rank of the `seq_axis` group holds one shard of q, k and v; the KV
shards rotate around the ring (`mesh.ring_shift`: sent to the next rank,
received from the previous, in one batch_isend_irecv) and every rank merges
the partials of its own queries. The rotation of step t is issued before
step t's attend, as in JAX; here it completes first (no overlap).

Causal schedule: at step t rank i attends KV shard (i - t) mod P. Step 0 is
the diagonal (local causal attention); a step t >= 1 contributes only where
i >= t (a plain `if` on the rank: the wrapped shards are future tokens), but
every rank takes part in every rotation. A sliding window truncates the
ring at min(P, (window - 2) // S_loc + 2) steps, the in-window off-diagonal
shards running causal at q_offset = t * S_loc, so that the kernel's band is
the global-position window.

The kernels are the single-device ones: `flash_attention_with_lse` (row 1,
with a window row 1 (window)), `flash_attention_kv_quant_with_lse` (row 1,
8-bit) and, in the trainable ring's backward, `ops.flash_attention._bwd`
(rows 4 and 5) with the global o and lse. The TPU tiling knobs (block_q,
block_k) and `interpret` are dropped: passing them raises TypeError.
"""

from __future__ import annotations

import torch

from flashattention_kernel_project_tpu_torch.ops import flash_attention as fa
from flashattention_kernel_project_tpu_torch.parallel.mesh import (
    axis_group,
    ring_shift,
)
from flashattention_kernel_project_tpu_torch.utils.sharding import P


def merge_normalized(o_a, lse_a, o_b, lse_b):
    """Merge two normalized attention partials (o [..., N, D], lse [..., N]);
    safe for an empty partial (o = 0, lse = NEG_INF), which weighs 0."""
    lse = torch.logaddexp(lse_a, lse_b)
    wa = torch.exp(lse_a - lse)[..., None]
    wb = torch.exp(lse_b - lse)[..., None]
    return o_a * wa + o_b * wb, lse


def _spec(mesh, seq_axis, data_axis):
    """The layout of q, k, v and the output: the sequence over seq_axis,
    the batch over data_axis when the mesh has it."""
    b_axis = data_axis if data_axis and data_axis in mesh.mesh_dim_names else None
    return P(b_axis, None, seq_axis, None)


def _ring_forward(group, attend, q, kv, causal, window=None):
    """The ring's forward on the rank's shards: `attend(q, kv, local_causal,
    q_offset, window)` runs the local kernel on a tuple of KV shards (bf16
    K, V; or 8-bit values and per-token scales, which rotate as one
    message) and returns (o float32, lse). Returns the merged (o float32,
    lse) of the rank's queries."""
    n_ring = torch.distributed.get_world_size(group)
    idx = torch.distributed.get_rank(group)
    # step 0: the diagonal shard, local causal (or plain) attention
    o, lse = attend(q, kv, local_causal=causal, q_offset=0, window=window)
    s_loc = kv[0].shape[2]
    depth = n_ring
    if window is not None:
        depth = min(n_ring, max(window - 2, 0) // s_loc + 2)
    for t in range(1, depth):
        kv = tuple(ring_shift(kv, group))
        if causal and idx < t:
            # shard idx - t wrapped round: future tokens, an empty partial
            # (o 0, lse NEG_INF), whose merge is the identity
            continue
        o_t, lse_t = attend(q, kv, local_causal=False,
                            q_offset=t * s_loc if causal else 0,
                            window=window if causal else None)
        o, lse = merge_normalized(o, lse, o_t, lse_t)
    return o, lse


def _make_ring(mesh, attend, *, causal, seq_axis, data_axis, window=None):
    """fn(q, *kv) on the rank's shards -> its slice of the output in q's
    dtype, through `_ring_forward`, with `fn.spec` the layout of both."""
    if window is not None and not causal:
        raise ValueError("a sliding window implies causality")
    group = axis_group(mesh, seq_axis)

    def fn(q, *kv):
        return _ring_forward(group, attend, q, kv, causal, window)[0].to(q.dtype)

    fn.spec = _spec(mesh, seq_axis, data_axis)
    return fn


def _bf16_attend(sm_scale):
    """The ring's local attend over bf16 K, V shards (kernel 1)."""

    def attend(q, kv, *, local_causal, q_offset=0, window=None):
        k, v = kv
        o, lse = fa.flash_attention_with_lse(
            q, k, v, causal=local_causal or window is not None,
            q_offset=q_offset, window=window, sm_scale=sm_scale)
        return o.float(), lse

    return attend


def ring_attention(mesh, *, causal: bool = True, sm_scale: float | None = None,
                   seq_axis: str = "sp", data_axis: str | None = "data",
                   window: int | None = None):
    """Context-parallel attention: q [B, H, N/P, D], k, v [B, Hkv, S/P, D],
    the rank's shards of sequences cut over `seq_axis` (and of the batch
    over `data_axis` where the mesh has it) -> the rank's slice of the
    output. Causal assumes q and kv share the partition. window (causal
    only): sliding-window attention over global positions; out-of-window
    shards are neither rotated nor attended."""
    return _make_ring(mesh, _bf16_attend(sm_scale), causal=causal, seq_axis=seq_axis,
                      data_axis=data_axis, window=window)


def ring_attention_kv_quant(mesh, *, causal: bool = True,
                            sm_scale: float | None = None, seq_axis: str = "sp",
                            data_axis: str | None = "data",
                            window: int | None = None):
    """ring_attention over an 8-bit sequence-sharded KV cache (BASELINE
    config 5's shape): each rank holds and rotates its quantized shard,
    values and per-token scales together, and attends through the 8-bit
    forward, so no shard is ever widened in full. fn(q, k_q [B, Hkv, S/P,
    D] int8 or e4m3, k_scale [B, Hkv, S/P, 1] float32, v_q, v_scale) -> the
    rank's slice of the output."""

    def attend(q, kv, *, local_causal, q_offset=0, window=None):
        kq, ks, vq, vs = kv
        o, lse = fa.flash_attention_kv_quant_with_lse(
            q, kq, ks, vq, vs, causal=local_causal or window is not None,
            q_offset=q_offset, window=window, sm_scale=sm_scale)
        return o.float(), lse

    return _make_ring(mesh, attend, causal=causal, seq_axis=seq_axis,
                      data_axis=data_axis, window=window)


# ---------------------------------------------------------------------------
# The differentiable ring (context-parallel training). The backward follows
# the forward's schedule: the FlashAttention-2 recompute needs only the
# global (o, lse) of each query row, both on the query's rank after the
# forward's merge, so each KV shard's gradient is computed wherever the
# shard is. The (dk, dv) float32 accumulators ride the ring with their
# shard and one more hop brings them home; dq accumulates in place.
# ---------------------------------------------------------------------------

class _RingAttention(torch.autograd.Function):
    """The trainable ring on the rank's (q, k, v) shards of one group."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal, sm_scale):
        o, lse = _ring_forward(group, _bf16_attend(sm_scale), q, (k, v), causal)
        o = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (group, causal, sm_scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        group, causal, sm_scale = ctx.args
        n_ring = torch.distributed.get_world_size(group)
        idx = torch.distributed.get_rank(group)
        # t = 0: the diagonal shard, local causal
        dq, dk, dv = fa._bwd(q, k, v, o, lse, do, causal, sm_scale, 0)
        dq = dq.float()
        kv = (k, v)
        dkv = (dk.float(), dv.float())
        for t in range(1, n_ring):
            # the shard and its accumulators rotate together, before this
            # step's kernels add the shard's contribution
            *kv, dk_acc, dv_acc = ring_shift((*kv, *dkv), group)
            if causal and idx < t:
                dkv = (dk_acc, dv_acc)
                continue
            dq_t, dk_t, dv_t = fa._bwd(q, *kv, o, lse, do, False, sm_scale, 0)
            dq += dq_t.float()
            dkv = (dk_acc + dk_t.float(), dv_acc + dv_t.float())
        # the shard on board is idx + 1 (mod P): one more hop brings each
        # accumulator home
        if n_ring > 1:
            dkv = ring_shift(dkv, group)
        return (dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype),
                None, None, None)


def ring_attention_trainable_inner(mesh, *, causal: bool = True,
                                   sm_scale: float | None = None,
                                   seq_axis: str = "sp"):
    """The differentiable ring on the rank's (q, k, v) shards, for a caller
    that already holds them (the context-parallel train step calls it once
    a layer). JAX's first argument, the ring's size, is here the mesh's
    `seq_axis` size."""
    group = axis_group(mesh, seq_axis)

    def fn(q, k, v):
        return _RingAttention.apply(q, k, v, group, causal, sm_scale)

    return fn


def ring_attention_trainable(mesh, *, causal: bool = True,
                             sm_scale: float | None = None,
                             seq_axis: str = "sp",
                             data_axis: str | None = "data"):
    """Differentiable context-parallel attention: fn(q, k, v) on the rank's
    shards, as ring_attention, that autograd differentiates in q, k and v.
    Each ring step's backward is the fused backward (`ops.flash_attention.
    _bwd`, kernels 4 and 5) against the saved global logsumexp; the causal
    schedule skips the wrapped shards in both directions."""
    fn = ring_attention_trainable_inner(mesh, causal=causal, sm_scale=sm_scale,
                                        seq_axis=seq_axis)
    fn.spec = _spec(mesh, seq_axis, data_axis)
    return fn
