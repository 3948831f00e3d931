"""Training steps over a device mesh: DP x TP (Megatron), context-parallel
(the sequence over a ring), and DP x TP driven by a torch.optim optimizer.

Counterpart of flashattention_kernel_project_tpu/parallel/train.py. Each
rank runs the step on its own shards (parallel/mesh.py): under TP the
parameters are cut by models.param_shardings (wq, wk, wv, w_gate, w_up by
columns, wo and w_down by rows over "model") and each rank runs the fused
kernels on its own heads; under DP the batch is cut over "data"; under CP
the parameters are whole and each rank holds a contiguous slice of the
sequence, attending globally through the trainable ring once a layer.

The gradient scaling follows JAX's. `_psum`, the one differentiable
collective here, is an all-reduce whose backward is an all-reduce (sum), as
JAX's psum transposes to a psum (it is torch.distributed.nn.functional's
all_reduce, with the size-1 axis a no-op). So every cotangent that crosses
a forward `_psum` arrives summed over the axis: a rank's raw gradient is
|axis| times its own contribution. As in JAX, a leaf cut over the axis
(whose contribution is its whole gradient) divides the factor out, and a
replicated leaf takes the mean over the axis, which sums the ranks'
contributions while it folds the factor away (`_fold`). The result is the
single-device gradient, and the replicated leaves come out bit-equal on
every rank because the all-reduce gives every rank the same bits.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.utils.checkpoint

from flashattention_kernel_project_tpu_torch.models import moe
from flashattention_kernel_project_tpu_torch.models import transformer as tfm
from flashattention_kernel_project_tpu_torch.ops.flash_attention import flash_attention
from flashattention_kernel_project_tpu_torch.parallel.mesh import axis_group
from flashattention_kernel_project_tpu_torch.utils.sharding import P


class _PSum(torch.autograd.Function):
    """JAX's psum on `group`: an all-reduce (sum), whose backward is an
    all-reduce (sum) of the cotangent."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _psum(x, group):
    return x if dist.get_world_size(group) == 1 else _PSum.apply(x, group)


def _all_reduce_mean(tensors, group):
    """JAX's pmean of each tensor over `group` (the sum, then / |group|, in
    the tensor's dtype), one all-reduce for each dtype: the tensors of a
    dtype flattened into one buffer, the dtypes in their order of first
    appearance (the same on every rank: a set's order is not)."""
    n = dist.get_world_size(group)
    if n == 1:
        return list(tensors)
    out = list(tensors)
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        idx = [i for i, t in enumerate(tensors) if t.dtype == dtype]
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=group)
        flat /= n
        for i, part in zip(idx, flat.split([tensors[i].numel() for i in idx])):
            out[i] = part.view(tensors[i].shape)
    return out


def _is_sharded(spec, axis) -> bool:
    return axis in [ax for ax in (spec or ()) if ax is not None]


def _fold(grads, specs, axis, group):
    """The psum-transpose factor folded out of the raw gradients (see the
    module docstring): leaves cut over `axis` divided by |axis|, the others
    averaged over it."""
    n = dist.get_world_size(group)
    rep = [i for i, s in enumerate(specs) if not _is_sharded(s, axis)]
    out = list(grads)
    for i, g in zip(rep, _all_reduce_mean([grads[i] for i in rep], group)):
        out[i] = g
    return [g if i in rep else g / n for i, g in enumerate(out)]


def _sgd(flat: dict, grads, lr: float) -> dict:
    """p - lr * g in float32, cast back to p's dtype, as a parameter tree."""
    with torch.no_grad():
        return tfm._unflatten({k: (x.float() - lr * g.float()).to(x.dtype)
                               for (k, x), g in zip(flat.items(), grads)})


def _value_and_grad(loss_fn, params: dict):
    """(loss, the leaves as {name: tensor}, their gradients in that order) of
    loss_fn(params), differentiated in every leaf; a leaf the loss does not
    reach gets zeros."""
    flat = {k: x.detach().requires_grad_(True)
            for k, x in tfm._leaves(params).items()}
    with torch.enable_grad():
        loss = loss_fn(tfm._unflatten(flat))
        grads = torch.autograd.grad(loss, list(flat.values()), allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(flat.values(), grads)]
    return loss.detach(), flat, grads


def _nll(logits, targets):
    """Per-position next-token NLL [B, N] in float32 of logits [B, N, V]
    against targets [B, N]."""
    return torch.nn.functional.cross_entropy(
        logits.flatten(0, 1), targets.flatten().long(),
        reduction="none").view(targets.shape)


# ---------------------------------------------------------------------------
# DP x TP
# ---------------------------------------------------------------------------

def _tp_moe_block(cfg, layer, x, group):
    """The MoE MLP residual block under TP (JAX's train.py:60-88): moe_w1
    and moe_w2 arrive cut over the model axis on their expert dimension;
    the router and the dense dispatch run alike on every rank (always the
    dense form, whatever the size), each rank runs its own experts on its
    slice of the one-hot pair, and one `_psum` sums the parts. Returns
    (out, the layer's load-balancing loss)."""
    h2 = tfm.rms_norm(x, layer["rms_mlp"])
    h2f = h2.reshape(-1, cfg.d_model).float()
    probs = torch.softmax(h2f @ layer["moe_router"], dim=-1)
    cap = moe.MoEConfig(num_experts=cfg.moe_experts, top_k=cfg.moe_top_k,
                        capacity_factor=cfg.moe_capacity_factor).capacity(
                            h2f.shape[0])
    dispatch, combine, aux = moe._top_k_dispatch(probs, cfg.moe_top_k, cap)
    e_local = layer["moe_w1"].shape[0]
    mine = slice(dist.get_rank(group) * e_local,
                 (dist.get_rank(group) + 1) * e_local)
    expert_in = torch.einsum("tec,td->ecd", dispatch[:, mine], h2f)
    expert_out = moe._expert_ffn(layer["moe_w1"].float(),
                                 layer["moe_w2"].float(), expert_in)
    part = torch.einsum("tec,ecd->td", combine[:, mine], expert_out)
    out = _psum(part, group).reshape(h2.shape)
    return x + out.to(x.dtype), aux


def _tp_forward(cfg, params, tokens, *, group, remat=False):
    """The forward on the rank's shards -> (logits, the MoE load-balancing
    loss averaged over the layers, None for a dense config): head counts
    from the local weight shapes (wq arrives column-cut), two `_psum`s a
    layer after the row-parallel projections (wo, and w_down or the
    experts' parts). remat=True checkpoints each layer
    (torch.utils.checkpoint, non-reentrant): its activations are
    recomputed in the backward. Attention runs causal with the default
    discipline, as JAX's TP step does."""
    b, n = tokens.shape
    x = params["embed"][tokens]
    positions = torch.arange(n, device=tokens.device)[None, :]
    sin, cos = tfm.rope_tables(cfg, positions)

    def layer_fn(x, layer):
        hq = layer["wq"].shape[-1] // cfg.d_head
        hkv = layer["wk"].shape[-1] // cfg.d_head
        h = tfm.rms_norm(x, layer["rms_attn"])
        q = tfm.apply_rope((h @ layer["wq"]).view(b, n, hq, cfg.d_head), sin, cos)
        k = tfm.apply_rope((h @ layer["wk"]).view(b, n, hkv, cfg.d_head), sin, cos)
        v = (h @ layer["wv"]).view(b, n, hkv, cfg.d_head)
        o = flash_attention(q.transpose(1, 2).contiguous(),
                            k.transpose(1, 2).contiguous(),
                            v.transpose(1, 2).contiguous(), causal=True)
        o = o.transpose(1, 2).reshape(b, n, hq * cfg.d_head)
        x = x + _psum(o @ layer["wo"], group)
        if "moe_w1" in layer:
            return _tp_moe_block(cfg, layer, x, group)
        h2 = tfm.rms_norm(x, layer["rms_mlp"])
        gated = torch.nn.functional.silu(h2 @ layer["w_gate"]) * (h2 @ layer["w_up"])
        return x + _psum(gated @ layer["w_down"], group), None

    n_layers = params["layers"]["wq"].shape[0]
    auxes = []
    for i in range(n_layers):
        layer = tfm.layer_params(params, i)
        if remat:
            x, aux = torch.utils.checkpoint.checkpoint(layer_fn, x, layer,
                                                       use_reentrant=False)
        else:
            x, aux = layer_fn(x, layer)
        if aux is not None:
            auxes.append(aux)
    x = tfm.rms_norm(x, params["rms_final"])
    aux = torch.stack(auxes).sum() / n_layers if auxes else None
    return tfm.logits_f32(x, params["embed"]), aux


def _tp_loss(cfg, params, tokens, *, group, remat=False):
    """The next-token NLL's mean, plus moe_aux_weight times the load-
    balancing loss for an MoE config (JAX's _tp_loss)."""
    logits, aux = _tp_forward(cfg, params, tokens, group=group, remat=remat)
    loss = _nll(logits[:, :-1], tokens[:, 1:]).mean()
    return loss if aux is None else loss + cfg.moe_aux_weight * aux


def _tp_grads(cfg, mesh, params, tokens, *, data_axis, model_axis, remat):
    """(loss, leaves, gradients, the leaves' specs) of the DP x TP loss on
    the rank's shards: the gradients and the loss averaged over the data
    axis, then the model axis' factor folded out (`_fold`). The specs are
    matched to the leaves by name, whatever the order of params' keys."""
    data = axis_group(mesh, data_axis) if data_axis in mesh.mesh_dim_names else None
    model = axis_group(mesh, model_axis)
    loss, flat, grads = _value_and_grad(
        lambda p: _tp_loss(cfg, p, tokens, group=model, remat=remat), params)
    if data is not None:
        *grads, loss = _all_reduce_mean([*grads, loss], data)
    rules = tfm._leaves(tfm.param_shardings(cfg, data_axis=data_axis,
                                            model_axis=model_axis))
    specs = [rules[k] for k in flat]
    return loss, flat, _fold(grads, specs, model_axis, model), specs


def make_train_step(cfg: tfm.TransformerConfig, mesh, *, lr: float = 1e-3,
                    data_axis: str = "data", model_axis: str = "model",
                    remat: bool = False):
    """The DP x TP SGD step. Returns (step_fn(params, tokens) -> (new_params,
    loss), param_specs): params are the rank's shards by param_specs
    (parallel.shard_params), tokens the rank's rows of the batch (cut over
    `data_axis` when the mesh has it); the loss is the global mean, the same
    on every rank. remat=True checkpoints each layer. An MoE config's
    experts are cut over the model axis (expert parallelism, JAX's
    train.py:60-88): its router is whole and its gradient averaged over the
    axis like the norms'."""
    rules = tfm.param_shardings(cfg, data_axis=data_axis, model_axis=model_axis)

    def step(params, tokens):
        loss, flat, grads, _ = _tp_grads(cfg, mesh, params, tokens,
                                         data_axis=data_axis,
                                         model_axis=model_axis, remat=remat)
        return _sgd(flat, grads, lr), loss

    return step, rules


# ---------------------------------------------------------------------------
# Context-parallel: the long-context train step. Parameters and tokens
# whole on every rank; each rank embeds its contiguous slice of the
# sequence and attends globally through the trainable ring. The loss is the
# global (sum, count) of the NLL: the ranks' slices hold different numbers
# of labelled positions (the last global position has none).
# ---------------------------------------------------------------------------

def _cp_loss(cfg, params, tokens, *, ring, group):
    b, n = tokens.shape
    n_ring = dist.get_world_size(group)
    idx = dist.get_rank(group)
    n_loc = n // n_ring
    lo = idx * n_loc
    tok = tokens[:, lo:lo + n_loc]
    x = params["embed"][tok]
    positions = lo + torch.arange(n_loc, device=tokens.device)[None, :]
    sin, cos = tfm.rope_tables(cfg, positions)
    auxes = []
    for i in range(params["layers"]["wq"].shape[0]):
        layer = tfm.layer_params(params, i)
        h = tfm.rms_norm(x, layer["rms_attn"])
        q = tfm.apply_rope((h @ layer["wq"]).view(b, n_loc, cfg.n_heads, cfg.d_head),
                           sin, cos)
        k = tfm.apply_rope((h @ layer["wk"]).view(b, n_loc, cfg.n_kv_heads,
                                                  cfg.d_head), sin, cos)
        v = (h @ layer["wv"]).view(b, n_loc, cfg.n_kv_heads, cfg.d_head)
        o = ring(q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
                 v.transpose(1, 2).contiguous())
        x = x + o.transpose(1, 2).reshape(b, n_loc, cfg.q_dim) @ layer["wo"]
        if "moe_w1" in layer:
            x, aux = tfm._moe_mlp_block(layer, x, cfg)
            auxes.append(aux)
        else:
            x = tfm._mlp_block(layer, x, cfg)
    x = tfm.rms_norm(x, params["rms_final"])
    logits = tfm.logits_f32(x, params["embed"])
    # the labels are the next global tokens; the last global position has
    # none, so it is masked out of the sum and the count is b * (n - 1)
    labels = torch.nn.functional.pad(tokens, (0, 1))[:, lo + 1:lo + 1 + n_loc]
    valid = (lo + torch.arange(n_loc, device=tokens.device) + 1 < n).float()
    loss = _psum((_nll(logits, labels) * valid).sum(), group) / (b * (n - 1))
    if auxes:
        # each slice routes its own tokens: the global balance loss is the
        # slices' mean (they hold equal token counts)
        aux = _psum(torch.stack(auxes).mean(), group) / n_ring
        loss = loss + cfg.moe_aux_weight * aux
    return loss


def _layer_keys(cfg) -> tuple[str, ...]:
    ffn = (("moe_router", "moe_w1", "moe_w2") if cfg.moe_experts
           else ("w_gate", "w_up", "w_down"))
    return ("wq", "wk", "wv", "wo", "rms_attn", "rms_mlp") + ffn


def make_cp_train_step(cfg: tfm.TransformerConfig, mesh, *, lr: float = 1e-3,
                       seq_axis: str = "sp"):
    """The context-parallel SGD step (the sequence over `seq_axis`, the
    parameters whole, the trainable ring once a layer). Returns
    (step_fn(params, tokens [b, n_global]) -> (new_params, loss),
    param_specs), the specs all P() (dense or MoE); the tokens are the whole
    batch on every rank, n_global a multiple of the ring's size. The new
    parameters and the loss are the same on every rank."""
    from flashattention_kernel_project_tpu_torch.parallel.ring_attention import (
        ring_attention_trainable_inner,
    )

    group = axis_group(mesh, seq_axis)
    ring = ring_attention_trainable_inner(mesh, causal=True, seq_axis=seq_axis)
    rules = dict(embed=P(), rms_final=P(),
                 layers={k: P() for k in _layer_keys(cfg)})

    def step(params, tokens):
        if tokens.shape[1] % dist.get_world_size(group):
            raise ValueError(f"sequence {tokens.shape[1]} does not divide over "
                             f"the {dist.get_world_size(group)}-rank ring")
        loss, flat, grads = _value_and_grad(
            lambda p: _cp_loss(cfg, p, tokens, ring=ring, group=group), params)
        # every parameter is replicated: the mean over the ring sums the
        # ranks' contributions and folds the loss psum's factor away
        return _sgd(flat, _all_reduce_mean(grads, group), lr), loss

    return step, rules


# ---------------------------------------------------------------------------
# DP x TP driven by a torch.optim optimizer (AdamW, SGD with momentum, ...)
# over the same Megatron layout: each rank updates its weight shards with
# its own state.
# ---------------------------------------------------------------------------

def make_optax_train_step(cfg: tfm.TransformerConfig, mesh, optimizer, params,
                          *, clip_norm: float | None = None,
                          data_axis: str = "data", model_axis: str = "model",
                          remat: bool = False):
    """The DP x TP step driven by a torch.optim optimizer (the name is
    JAX's, whose step takes an optax one). `optimizer` is a class or a
    factory taking the rank's list of parameter tensors, e.g.
    functools.partial(torch.optim.AdamW, lr=1e-2, weight_decay=1e-4). It
    must be elementwise over the parameters (Adam, AdamW, SGD with momentum
    are): each rank updates its shard with its own state. Global-norm
    clipping inside such an optimizer would take a shard's norm and
    desynchronise the replicated leaves, so pass clip_norm here: the true
    global norm is the all-reduce over the model axis of the cut leaves'
    square sums plus the replicated leaves' once. `params` (the global or
    local tree) is JAX's argument for shaping the state; torch creates the
    state at the first step.

    Returns (init_fn(sharded_params) -> opt_state, step_fn(params,
    opt_state, tokens) -> (params, opt_state, loss), param_specs,
    opt_state_specs). opt_state is the optimizer's state_dict, updated in
    place by the step; its per-parameter entries are keyed by the
    parameter's index in the order of the leaves, and opt_state_specs[i] is
    the layout of parameter i's entries of its shape (scalar entries, the
    step counts, are whole on every rank), i in the order of `params`'
    leaves, which the step's params must share."""
    rules = tfm.param_shardings(cfg, data_axis=data_axis, model_axis=model_axis)
    flat_rules = tfm._leaves(rules)
    model = axis_group(mesh, model_axis)

    def _clip(grads, specs):
        sq = [g.float().square().sum() for g in grads]
        cut = sum(s for s, spec in zip(sq, specs) if _is_sharded(spec, model_axis))
        whole = sum(s for s, spec in zip(sq, specs)
                    if not _is_sharded(spec, model_axis))
        cut = cut.clone()
        dist.all_reduce(cut, group=model)
        scale = torch.clamp(clip_norm / torch.clamp((cut + whole).sqrt(), min=1e-12),
                            max=1.0)
        return [(g.float() * scale).to(g.dtype) for g in grads]

    def _optimizer(flat):
        return optimizer(list(flat.values()))

    def init_fn(sharded_params):
        flat = {k: x.detach().clone() for k, x in tfm._leaves(sharded_params).items()}
        return _optimizer(flat).state_dict()

    def step(params, opt_state, tokens):
        loss, _, grads, specs = _tp_grads(cfg, mesh, params, tokens,
                                          data_axis=data_axis,
                                          model_axis=model_axis, remat=remat)
        if clip_norm is not None:
            grads = _clip(grads, specs)
        flat = {k: x.detach().clone() for k, x in tfm._leaves(params).items()}
        opt = _optimizer(flat)
        opt.load_state_dict(opt_state)
        for x, g in zip(flat.values(), grads):
            x.grad = g
        opt.step()
        for x in flat.values():
            x.grad = None
        return tfm._unflatten(flat), opt.state_dict(), loss

    specs = dict(enumerate(flat_rules[k] for k in tfm._leaves(params)))
    return init_fn, step, rules, specs
