"""Mixture-of-Experts FFN on one device.

Counterpart of flashattention_kernel_project_tpu/models/moe.py, single
device: top-k routing with a static per-expert capacity, through the
GShard dense dispatch (two one-hot [T, E, C] products) or the sort-based
ragged dispatch (O(T * k) indices and two gathers), which route and drop
the same tokens. Each expert holds at most
`capacity = ceil(top_k * T / E * capacity_factor)` tokens; overflow
tokens are dropped from that expert (their combine weight is 0).

Everything here is plain torch in float32: the JAX package computes the
router, the dispatch and the expert products in XLA, with no Pallas
kernel. The router product and the expert products take float32 weights
(bf16 expert weights are widened first), and TF32 must stay off on the
card: routing takes argmaxes over near-ties, which a rounded product flips.

Expert parallelism (`moe_param_shardings`, `make_ep_moe`) runs on
torch.distributed, one process a rank (parallel/mesh.py): the experts cut
over a mesh axis, the router and the dispatch computed alike on every rank,
each rank running its own experts, one all-reduce summing their parts.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from flashattention_kernel_project_tpu_torch.utils.sharding import P


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int = 256
    d_ff: int = 512          # per-expert hidden width
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25

    def capacity(self, num_tokens: int) -> int:
        cap = math.ceil(self.top_k * num_tokens / self.num_experts
                        * self.capacity_factor)
        # at least one slot, and a multiple of 8 from 8 tokens on
        return max(8, -(-cap // 8) * 8) if num_tokens >= 8 else max(1, cap)


def init_moe_params(cfg: MoEConfig, generator: torch.Generator, device) -> dict:
    """Scaled-normal init in float32: the router w_gate [D, E] and w1
    [E, D, F] at D**-0.5, w2 [E, F, D] at F**-0.5, drawn from `generator`
    (which must live on `device`). torch's draws differ from jax.random's:
    tests that compare with the JAX package convert its parameters."""
    def normal(shape, scale):
        return torch.randn(shape, generator=generator, device=device,
                           dtype=torch.float32) * scale

    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "w_gate": normal((d, e), d ** -0.5),
        "w1": normal((e, d, f), d ** -0.5),
        "w2": normal((e, f, d), f ** -0.5),
    }


def moe_param_shardings(cfg: MoEConfig, expert_axis: str = "expert") -> dict:
    """The expert-parallel layout (utils.sharding.P specs): the router
    whole on every rank, w1 and w2 cut over `expert_axis` on their expert
    dimension."""
    del cfg
    return {
        "w_gate": P(),
        "w1": P(expert_axis, None, None),
        "w2": P(expert_axis, None, None),
    }


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """jax.nn.one_hot: an index outside [0, n) gives a row of zeros."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _top_k_choices(probs: torch.Tensor, top_k: int):
    """Iterative-argmax top-k, the first maximum on a tie (the dense path's
    exact selection order). probs [T, E] -> (gates [T, k] renormalized,
    masks: k one-hots [T, E], aux_loss: Switch Transformer eq. 4 on the
    first choice)."""
    e = probs.shape[1]
    chosen_gates, masks = [], []
    p = probs
    for _ in range(top_k):
        oh = _one_hot(p.argmax(dim=-1), e, probs.dtype)
        chosen_gates.append((probs * oh).sum(dim=-1))
        masks.append(oh)
        p = p * (1.0 - oh)
    gates = torch.stack(chosen_gates, dim=-1)
    gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    aux_loss = e * (masks[0].mean(dim=0) * probs.mean(dim=0)).sum()
    return gates, masks, aux_loss


def _top_k_dispatch(probs: torch.Tensor, top_k: int, capacity: int):
    """Static-shape top-k routing with per-expert capacity, dense form.
    probs [T, E] -> (dispatch, combine [T, E, C] one-hot(-weighted), aux).
    Each choice fills an expert's buffer after every earlier choice, in
    token order."""
    gates, masks, aux_loss = _top_k_choices(probs, top_k)
    return (*_dense_slots(gates, masks, capacity), aux_loss)


def _dense_slots(gates: torch.Tensor, masks, capacity: int):
    """The dense dispatch and combine [T, E, C] of the choices (gates
    [T, k], masks: k one-hots [T, E]) at `capacity` slots an expert."""
    t, e = masks[0].shape
    counts = torch.zeros((e,), dtype=torch.int64, device=gates.device)
    dispatch = gates.new_zeros((t, e, capacity))
    combine = gates.new_zeros((t, e, capacity))
    for k, oh in enumerate(masks):
        ohi = oh.long()
        # each token's position within its chosen expert's buffer
        pos = ohi.cumsum(dim=0) - ohi + counts[None, :]            # [T, E]
        counts = counts + ohi.sum(dim=0)
        keep = (pos < capacity).to(gates.dtype) * oh                # [T, E]
        pos_oh = _one_hot((pos * ohi).sum(dim=-1), capacity, gates.dtype)
        d = keep[:, :, None] * pos_oh[:, None, :]                   # [T, E, C]
        dispatch = dispatch + d
        combine = combine + gates[:, k][:, None, None] * d
    return dispatch, combine


def _top_k_dispatch_sort(probs: torch.Tensor, top_k: int, capacity: int):
    """Sort-based ragged dispatch: the routing and drops of
    `_top_k_dispatch` with O(T * k) index tensors in place of the dense
    [T, E, C] pair. Returns (slot_token [E * C + 1]: the token filling each
    expert slot, T for an empty one; slot_tk [T, k]: each choice's slot,
    E * C (the dummy) when dropped; gates [T, k]; aux_loss).

    The choices are flattened k-major ([k, T]) and sorted stably by expert,
    so all first choices fill an expert's buffer before any second choice,
    in token order: the dense path's drop order."""
    t, e = probs.shape
    device = probs.device
    gates, masks, aux_loss = _top_k_choices(probs, top_k)
    flat_e = torch.stack([m.argmax(dim=-1) for m in masks]).reshape(-1)
    sorted_e, order = torch.sort(flat_e, stable=True)
    start = torch.searchsorted(sorted_e, torch.arange(e, device=device))
    pos = torch.arange(top_k * t, device=device) - start[sorted_e]
    dummy = e * capacity
    slot_sorted = torch.where(pos < capacity, sorted_e * capacity + pos,
                              torch.full_like(pos, dummy))
    sorted_t = torch.arange(t, device=device).repeat(top_k)[order]
    slot_token = torch.full((dummy + 1,), t, dtype=torch.int64, device=device)
    slot_token[slot_sorted] = sorted_t
    slot_token[dummy] = t  # the dropped choices all wrote the dummy slot
    inv = torch.empty_like(order)
    inv[order] = torch.arange(top_k * t, device=device)
    slot_tk = slot_sorted[inv].reshape(top_k, t).t()
    return slot_token, slot_tk, gates, aux_loss


# the dense dispatch's one-hot pair costs 2 * T*E*C float32 bytes; past this
# budget the sort-based dispatch takes over ("auto")
_DENSE_DISPATCH_BYTES = 64 << 20


def _expert_ffn(w1: torch.Tensor, w2: torch.Tensor, expert_in: torch.Tensor):
    """[E, C, D] -> [E, C, D] through each expert's gelu MLP (jax.nn.gelu:
    the tanh approximation), float32 products."""
    h = F.gelu(torch.bmm(expert_in, w1), approximate="tanh")
    return torch.bmm(h, w2)


def _use_sort_dispatch(dispatch: str, t: int, e: int, c: int) -> bool:
    if dispatch == "auto":
        return 2 * t * e * c * 4 > _DENSE_DISPATCH_BYTES
    if dispatch not in ("dense", "sort"):
        raise ValueError(f"dispatch must be 'auto', 'dense' or 'sort', got {dispatch!r}")
    return dispatch == "sort"


def _moe_tokens(x2, w_gate, w1, w2, top_k, capacity_factor, dispatch="auto"):
    """The routed expert MLP of tokens x2 [T, D] float32 with float32
    weights (router w_gate [D, E], experts w1 [E, D, F], w2 [E, F, D]) ->
    (out [T, D] float32, aux_loss). `moe_ffn` and the decoder's MoE block
    (models/transformer.py) both run this."""
    t, d = x2.shape
    e = w1.shape[0]
    cap = MoEConfig(num_experts=e, top_k=top_k,
                    capacity_factor=capacity_factor).capacity(t)
    probs = torch.softmax(x2 @ w_gate, dim=-1)
    if _use_sort_dispatch(dispatch, t, e, cap):
        slot_token, slot_tk, gates, aux = _top_k_dispatch_sort(probs, top_k, cap)
        zero = x2.new_zeros((1, d))
        expert_in = torch.cat([x2, zero])[slot_token[:-1]].view(e, cap, d)
        eo = torch.cat([_expert_ffn(w1, w2, expert_in).reshape(-1, d), zero])
        out = sum(gates[:, j, None] * eo[slot_tk[:, j]] for j in range(top_k))
    else:
        dsp, combine, aux = _top_k_dispatch(probs, top_k, cap)
        expert_in = torch.einsum("tec,td->ecd", dsp, x2)
        out = torch.einsum("tec,ecd->td", combine, _expert_ffn(w1, w2, expert_in))
    return out, aux


def moe_ffn(params: dict, x: torch.Tensor, cfg: MoEConfig, *,
            return_aux: bool = False, dispatch: str = "auto"):
    """Single-device MoE FFN. x [..., T, D] (leading dims folded into T) ->
    the same shape in x's dtype (and the load-balancing aux loss with
    return_aux=True).

    dispatch: "dense" (the GShard one-hot products), "sort" (the ragged
    sort-based gathers: the same routing and drops, O(T * k) index
    memory) or "auto" (sort when the dense one-hots would pass 64 MB)."""
    x2 = x.reshape(-1, cfg.d_model).float()
    w_gate, w1, w2 = (params[k].float() for k in ("w_gate", "w1", "w2"))
    out, aux = _moe_tokens(x2, w_gate, w1, w2, cfg.top_k, cfg.capacity_factor,
                           dispatch)
    out = out.reshape(x.shape).to(x.dtype)
    return (out, aux) if return_aux else out


def _pmean(x: torch.Tensor, group) -> torch.Tensor:
    """x averaged over `group`, with each rank's own cotangent passed back
    (JAX's pmean, whose transpose averages the cotangents, alike on every
    rank)."""
    total = x.detach().clone()
    dist.all_reduce(total, group=group)
    return x + (total / dist.get_world_size(group) - x).detach()


def make_ep_moe(mesh, cfg: MoEConfig, *, expert_axis: str = "expert",
                data_axis: str | None = None, return_aux: bool = False,
                dispatch: str = "auto"):
    """The expert-parallel MoE FFN over `mesh` (parallel.make_mesh).

    Returns fn(params, x), run by every rank: params are the rank's shards
    by moe_param_shardings (parallel.shard_params: w_gate whole, w1 and w2
    the rank's e_local = num_experts / |expert_axis| experts), x the whole
    input [..., T, D], or, with `data_axis`, the rank's block of its leading
    dimension. The router and the dispatch run alike on every rank, each
    rank runs only its experts (the dense form: its slice of the one-hot
    pair; the sort form: its slots, with the choices routed elsewhere read
    from a zero row), and one all-reduce over the expert axis sums the
    parts. The output (x's shape and dtype; with return_aux, also the
    load-balancing loss) is the same on every rank of the expert axis and
    equals moe_ffn's, with the same routing and drops. With `data_axis`
    each data shard routes its own tokens at its own capacity, and the aux
    loss is averaged over the data axis.

    Gradients are exact on every rank with no collective asked of the
    caller: a loss taken on the output gives each rank its slice of the w1
    and w2 gradients, and the whole w_gate and x gradients. The region's
    inputs (the tokens and the gates) enter through parallel.mesh's
    copy_to_group, its output leaves through reduce_from_group (Megatron's
    pair). With `data_axis` they are the rank's data shard's, as a data
    parallel step averages them.

    ValueError where the experts do not divide over the expert axis."""
    from flashattention_kernel_project_tpu_torch.parallel.mesh import (
        axis_group,
        axis_index,
        axis_size,
        copy_to_group,
        reduce_from_group,
    )

    n_shards = axis_size(mesh, expert_axis)
    if cfg.num_experts % n_shards:
        raise ValueError(f"{cfg.num_experts} experts do not divide over the "
                         f"{n_shards} ranks of axis {expert_axis!r}")
    _use_sort_dispatch(dispatch, 0, 1, 1)  # an unknown form raises here
    e_local = cfg.num_experts // n_shards
    group = axis_group(mesh, expert_axis)
    shard = axis_index(mesh, expert_axis)
    data = axis_group(mesh, data_axis) if data_axis else None
    d = cfg.d_model

    def fn(params, x):
        w1, w2 = params["w1"].float(), params["w2"].float()
        if w1.shape[0] != e_local:
            raise ValueError(f"w1 holds {w1.shape[0]} experts, this rank's "
                             f"shard is {e_local}: pass parallel.shard_params' "
                             "shards")
        x2 = x.reshape(-1, d).float()
        t = x2.shape[0]
        cap = cfg.capacity(t)
        probs = torch.softmax(x2 @ params["w_gate"].float(), dim=-1)
        xe = copy_to_group(x2, group)
        if _use_sort_dispatch(dispatch, t, cfg.num_experts, cap):
            slot_token, slot_tk, gates, aux = _top_k_dispatch_sort(
                probs, cfg.top_k, cap)
            lo, n_loc = shard * e_local * cap, e_local * cap
            zero = x2.new_zeros((1, d))
            expert_in = torch.cat([xe, zero])[slot_token[lo:lo + n_loc]]
            eo = torch.cat([_expert_ffn(w1, w2, expert_in.view(e_local, cap, d))
                            .reshape(-1, d), zero])
            # another rank's slot (or a dropped choice) reads the zero row
            idx = slot_tk - lo
            idx = torch.where((idx >= 0) & (idx < n_loc), idx,
                              torch.full_like(idx, n_loc))
            gates = copy_to_group(gates, group)
            part = sum(gates[:, j, None] * eo[idx[:, j]]
                       for j in range(cfg.top_k))
        else:
            gates, masks, aux = _top_k_choices(probs, cfg.top_k)
            dsp, comb = _dense_slots(copy_to_group(gates, group), masks, cap)
            mine = slice(shard * e_local, (shard + 1) * e_local)
            expert_in = torch.einsum("tec,td->ecd", dsp[:, mine], xe)
            part = torch.einsum("tec,ecd->td", comb[:, mine],
                                _expert_ffn(w1, w2, expert_in))
        out = reduce_from_group(part, group).reshape(x.shape).to(x.dtype)
        if not return_aux:
            return out
        if data is not None:
            aux = _pmean(aux, data)
        return out, aux

    return fn
