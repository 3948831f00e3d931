"""Device meshes over torch.distributed, and the attention kernels on one.

Counterpart of flashattention_kernel_project_tpu/parallel/mesh.py. JAX runs
one controller, and shard_map runs a function on every device of a Mesh;
torch.distributed runs one process a rank, each running the same Python.
So here:
- `make_mesh` returns a torch.distributed.device_mesh.DeviceMesh over the
  process group the caller has initialised, with JAX's axis names ("data",
  "model", "sp") as its mesh_dim_names; a JAX axis name resolves to that
  dimension's process group (`axis_group`);
- `shard_params` (JAX: device_put with a NamedSharding) returns this rank's
  slice of each leaf;
- a function JAX wraps in shard_map takes and returns the rank's own
  shards: `head_sharded_attention` and the head-sharded decodes run the
  kernel on the rank's batch rows and KV heads and return its slice of the
  output, with no collective; `seq_sharded_decode` returns the whole output,
  bit-equal on every rank (JAX's out_specs P()), from the partials its
  ranks all-gather (JAX's all_gather) and merge;
- a region whose ranks each compute a part of a replicated sum (the
  expert-parallel MoE) enters through `copy_to_group` and leaves through
  `reduce_from_group`, which give every rank exact gradients.
The kernels are the single-device ones (ops/), launched at the rank's
shapes.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from flashattention_kernel_project_tpu_torch.ops.flash_attention import flash_attention
from flashattention_kernel_project_tpu_torch.ops.flash_decode import (
    flash_decode,
    flash_decode_int8,
    merge_partials,
)
from flashattention_kernel_project_tpu_torch.utils.sharding import P


def make_mesh(axis_sizes: dict[str, int] | None = None, *,
              device_type: str = "cuda"):
    """A DeviceMesh over the initialised default process group, its ranks
    laid out row-major in the shape `axis_sizes` ({"data": 2, "model": 4};
    one -1 entry takes the remaining ranks; default: every rank on one
    "model" axis). Each axis gets process groups of the default group's
    backend, one for each line of ranks along it, created by every rank in
    the same order. device_type: "cuda" (the rank's current device) or
    "cpu", as the tests run it."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    n = dist.get_world_size()
    axis_sizes = dict(axis_sizes or {"model": n})
    names = tuple(axis_sizes)
    sizes = list(axis_sizes.values())
    if sizes.count(-1) > 1:
        raise ValueError(f"at most one -1 in {axis_sizes}")
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = n // known
    if int(np.prod(sizes)) != n:
        raise ValueError(f"mesh {dict(zip(names, sizes))} does not cover the "
                         f"{n} ranks")
    ranks = np.arange(n).reshape(sizes)
    me = dist.get_rank()
    backend = dist.get_backend()
    groups = []
    for dim in range(len(sizes)):
        lines = np.moveaxis(ranks, dim, -1).reshape(-1, sizes[dim])
        mine = None
        for line in lines:
            g = dist.new_group([int(r) for r in line], backend=backend)
            if me in line:
                mine = g
        groups.append(mine)
    return DeviceMesh.from_group(groups, device_type,
                                 mesh=torch.from_numpy(ranks),
                                 mesh_dim_names=names)


def axis_group(mesh, axis: str):
    """The process group of this rank's line along the mesh axis `axis`."""
    return mesh.get_group(axis)


def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh, axis: str) -> int:
    """This rank's position along `axis` (its rank in `axis_group`)."""
    return dist.get_rank(axis_group(mesh, axis))


def mesh_device(mesh) -> torch.device:
    """The device this rank's shards live on: the current CUDA device, or
    the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def shard(x: torch.Tensor, mesh, spec) -> torch.Tensor:
    """This rank's block of the whole array x under `spec` (P): each
    dimension named by a mesh axis cut into that axis' size equal blocks,
    the rank's block by its position along the axis (ValueError if the
    size does not divide). Axes the mesh lacks leave their dimension
    whole, as JAX's wrappers drop an absent data axis."""
    out = x
    for dim, axis in enumerate(spec):
        if axis is None or axis not in mesh.mesh_dim_names:
            continue
        n = axis_size(mesh, axis)
        if x.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                             f"divide over {n} ranks of axis {axis!r}")
        size = x.shape[dim] // n
        out = out.narrow(dim, axis_index(mesh, axis) * size, size)
    return out.contiguous()


def shard_params(params, mesh, rules):
    """This rank's slice of every leaf of `params`, by the matching tree of
    specs `rules` (models.param_shardings): the counterpart of JAX's
    device_put with a NamedSharding. A leaf whose spec is None or P() stays
    whole. A dict whose keys differ from its rules' raises ValueError, as
    JAX's tree map does."""
    if isinstance(params, dict):
        if not isinstance(rules, dict) or set(params) != set(rules):
            raise ValueError(f"dict key mismatch: specs for "
                             f"{sorted(rules) if isinstance(rules, dict) else rules},"
                             f" params {sorted(params)}")
        return {k: shard_params(v, mesh, rules[k]) for k, v in params.items()}
    return params if not rules else shard(params, mesh, rules)


class _CopyToGroup(torch.autograd.Function):
    """Megatron's f: the identity forward on a value every rank of `group`
    holds alike; an all-reduce (sum) of the cotangent backward, where each
    rank used the value for its own part of a region."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromGroup(torch.autograd.Function):
    """Megatron's g: an all-reduce (sum) of the ranks' partial outputs
    forward; the identity backward, the cotangent of the replicated sum
    being the same on every rank."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """x, entering a region whose ranks of `group` each compute a part of
    a sum from it: the backward sums the ranks' cotangents, so x's
    gradient is whole and the same on every rank."""
    return x if dist.get_world_size(group) == 1 else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """The region's partial x summed over `group` (JAX's psum in a
    shard_map whose output is replicated), differentiable with exact
    gradients on every rank: unlike train._psum, whose backward sums
    again (JAX's transpose, which the training steps fold out), the
    backward here passes the cotangent through, and copy_to_group at the
    region's inputs sums what each rank's part sends back."""
    return x if dist.get_world_size(group) == 1 else _ReduceFromGroup.apply(x, group)


def _staged(x: torch.Tensor, group):
    """x as a point-to-point or all-to-all op on `group` takes it, and the
    function that brings what the op gives back to x's device. gloo's
    send, recv and all-to-all read host memory, so under gloo a CUDA
    tensor goes through a host copy (as gloo's own all-reduce and
    all-gather stage CUDA tensors); under NCCL device tensors pass
    straight through. Only the transfer is staged: the kernels still run
    on the card."""
    if x.is_cuda and dist.get_backend(group) == "gloo":
        return x.cpu(), lambda y: y.to(x.device)
    return x, lambda y: y


def _pack(tensors) -> torch.Tensor:
    """The tensors' bytes end to end, one uint8 tensor: one message."""
    return torch.cat([t.contiguous().view(torch.uint8).reshape(-1)
                      for t in tensors])


def _unpack(buf: torch.Tensor, like) -> list[torch.Tensor]:
    """_pack's inverse: tensors shaped and typed as `like`, each a copy of
    its own (so aligned as a fresh allocation, as the kernels need)."""
    out, at = [], 0
    for t in like:
        n = t.numel() * t.element_size()
        out.append(buf[at:at + n].clone().view(t.dtype).view(t.shape))
        at += n
    return out


def exchange(send, dst: int | None, recv_like, src: int | None, group):
    """One batch_isend_irecv on `group`: the tensors `send` (a list, or
    None) to the group rank `dst`, and tensors shaped and typed as
    `recv_like` (a list, or None) from the group rank `src`, each list one
    message. Returns the received tensors on recv_like's device, or None.
    Every rank of a send or receive must make the matching call, in the
    same order."""
    ops, buf, back = [], None, None
    if send:
        out, _ = _staged(_pack(send), group)
        ops.append(dist.P2POp(dist.isend, out, dist.get_global_rank(group, dst),
                              group))
    if recv_like:
        want = torch.empty(sum(t.numel() * t.element_size() for t in recv_like),
                           dtype=torch.uint8, device=recv_like[0].device)
        buf, back = _staged(want, group)
        ops.append(dist.P2POp(dist.irecv, buf, dist.get_global_rank(group, src),
                              group))
    for work in dist.batch_isend_irecv(ops) if ops else []:
        work.wait()
    return None if buf is None else _unpack(back(buf), recv_like)


def ring_shift(tensors, group) -> list[torch.Tensor]:
    """JAX's ppermute with perm [(i, i + 1 mod n)] on `group`: each rank's
    `tensors` go to the next rank, and the previous rank's come back, in
    one call (sends and receives posted together, so no rank waits on a
    send before its receive). Every rank's tensors have the same shapes."""
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    return exchange(tensors, (me + 1) % n, tensors, (me - 1) % n, group)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """dist.all_to_all_single on `group`: x's leading dimension cut into
    one equal block a rank, block j sent to rank j; the blocks received,
    in rank order, in the same shape."""
    out, back = _staged(x.contiguous(), group)
    got = torch.empty_like(out)
    dist.all_to_all_single(got, out, group=group)
    return back(got)


def _batch_spec(mesh, data_axis):
    return data_axis if data_axis in mesh.mesh_dim_names else None


def head_sharded_attention(mesh, *, causal: bool = True,
                           sm_scale: float | None = None,
                           data_axis: str | None = "data",
                           model_axis: str = "model", **kernel_kwargs):
    """The fused attention with the KV heads cut over `model_axis` and the
    batch over `data_axis` (when the mesh has it): no collective, attention
    being independent across heads. Returns fn(q, k, v) on the rank's
    shards (q [B/data, Hq/model, N, D], k, v [B/data, Hkv/model, S, D]) ->
    its slice of the output [B/data, Hq/model, N, D]. Each returned fn
    carries `kv_spec`, the spec of the cache (or K, V) it takes."""

    def fn(q, k, v):
        return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale,
                               **kernel_kwargs)

    fn.kv_spec = P(_batch_spec(mesh, data_axis), model_axis, None, None)
    return fn


def head_sharded_decode(mesh, *, n_splits: int = 8,
                        sm_scale: float | None = None,
                        data_axis: str | None = "data",
                        model_axis: str = "model", **kernel_kwargs):
    """The split-KV decode with the cache cut over its KV heads
    (P(batch, model_axis, None, None)): each rank reads only its heads'
    cache. Returns fn(q [B/data, Hq/model, D], k_cache, v_cache, lengths
    [B/data]) -> its slice of the output [B/data, Hq/model, D]."""

    def fn(q, k_cache, v_cache, lengths):
        return flash_decode(q, k_cache, v_cache, lengths, n_splits=n_splits,
                            sm_scale=sm_scale, **kernel_kwargs)

    fn.kv_spec = P(_batch_spec(mesh, data_axis), model_axis, None, None)
    return fn


def head_sharded_decode_quant(mesh, *, n_splits: int = 8,
                              sm_scale: float | None = None,
                              data_axis: str | None = "data",
                              model_axis: str = "model", **kernel_kwargs):
    """head_sharded_decode over an 8-bit cache (values and per-token scales
    cut over the KV heads alike): fn(q, k_q, k_scale, v_q, v_scale,
    lengths) -> the rank's slice of the output [B/data, Hq/model, D]."""

    def fn(q, k_q, k_s, v_q, v_s, lengths):
        return flash_decode_int8(q, k_q, k_s, v_q, v_s, lengths,
                                 n_splits=n_splits, sm_scale=sm_scale,
                                 **kernel_kwargs)

    fn.kv_spec = P(_batch_spec(mesh, data_axis), model_axis, None, None)
    return fn


def gather_merge(m, l, y, group):
    """The folded partials (m, l [B, Hkv, G, 1], y [B, Hkv, G, D]) of every
    rank of `group`, all-gathered in one collective and merged: [B, Hkv, G,
    D] float32, the same on every rank. A rank whose rows hold no live key
    (l = 0) weighs nothing."""
    mine = torch.cat([m, l, y], dim=-1).contiguous()
    parts = [torch.empty_like(mine) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, mine, group=group)
    st = torch.stack(parts, dim=-3)  # [B, Hkv, ranks, G, D + 2]
    return merge_partials(st[..., :1], st[..., 1:2], st[..., 2:])


def seq_sharded_decode(mesh, *, n_splits: int | None = None,
                       sm_scale: float | None = None,
                       data_axis: str | None = "data", seq_axis: str = "sp",
                       **kernel_kwargs):
    """The split-KV decode with the cache cut along its length over
    `seq_axis` (P(batch, None, seq_axis, None)), for contexts longer than
    one device holds. Each rank decodes its key range with its length
    clipped to the range and returns the unnormalized partials
    (flash_decode(return_partials=True)); one all-gather of the partials
    and `merge_partials` give the output on every rank. Returns fn(q [B/data,
    Hq, D], k_shard [B/data, Hkv, S/sp, D], v_shard, lengths [B/data], the
    global lengths) -> [B/data, Hq, D] in q's dtype, the same on every
    rank."""
    group = axis_group(mesh, seq_axis)

    def fn(q, k_shard, v_shard, lengths):
        s_loc = k_shard.shape[2]
        lo = dist.get_rank(group) * s_loc
        local_len = (lengths - lo).clamp(0, s_loc).to(torch.int32)
        m, l, y = flash_decode(q, k_shard, v_shard, local_len,
                               n_splits=n_splits, sm_scale=sm_scale,
                               return_partials=True, **kernel_kwargs)
        out = gather_merge(m, l, y, group)
        return out.reshape(q.shape).to(q.dtype)

    fn.kv_spec = P(_batch_spec(mesh, data_axis), None, seq_axis, None)
    return fn
