"""Pipeline parallelism: GPipe microbatching over a "pipe" mesh axis.

Counterpart of flashattention_kernel_project_tpu/parallel/pipeline.py. The
layer stack is cut over the `pipe` axis (each stage a contiguous slab of
layers, pp_param_specs) and the schedule has n_micro + n_stages - 1 ticks:
at tick t stage p runs its slab on microbatch t - p (stage 0 embeds it, the
last stage takes the head and the NLL), then sends the activations to stage
p + 1 (`mesh.exchange`, one batch_isend_irecv a tick). JAX runs every stage
on every tick and masks the bubble ticks out of the loss and the MoE aux;
here a stage skips its bubble ticks, so they enter neither.

torch has no differentiable send and receive, so the step runs the
backward by hand (`_pp_backward`): the forward ticks keep each microbatch's
slab input and output, then the backward ticks run in reverse, each stage
back-propagating a microbatch from the cotangent its successor sent (the
last stage from the loss) and sending the cotangent of the slab's input to
its predecessor. No collective is on the differentiated path (the loss's
all-reduce is of its value), so the gradients carry no factor: the stages'
own layers take theirs as they are, and the replicated leaves (the
embedding, read by stage 0 and by the last stage's head, and the final
norm) take the all-reduce sum over the axis. remat=True checkpoints each
layer of the slab (torch.utils.checkpoint, non-reentrant), as JAX
checkpoints the slab's scan body.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist
import torch.utils.checkpoint

from flashattention_kernel_project_tpu_torch.models import transformer as tfm
from flashattention_kernel_project_tpu_torch.parallel.mesh import (
    axis_group,
    exchange,
)
from flashattention_kernel_project_tpu_torch.parallel.train import _sgd
from flashattention_kernel_project_tpu_torch.utils.sharding import P

# the dense layer leaves, cut over the pipe axis (JAX's list)
_DENSE = ("rms_attn", "rms_mlp", "wq", "wk", "wv", "wo", "w_gate", "w_up",
          "w_down")


def _stage_forward(cfg, layers, x, sin, cos, *, remat):
    """This stage's slab on activations x [mb, n, d] -> (x, the slab's mean
    MoE aux loss, None for dense layers)."""

    def body(x, layer):
        x = tfm._attention_block(cfg, layer, x, sin, cos)
        if "moe_w1" in layer:
            return tfm._moe_mlp_block(layer, x, cfg)
        return tfm._mlp_block(layer, x, cfg), None

    auxes = []
    for i in range(layers["wq"].shape[0]):
        layer = {k: w[i] for k, w in layers.items()}
        if remat:
            x, aux = torch.utils.checkpoint.checkpoint(body, x, layer,
                                                       use_reentrant=False)
        else:
            x, aux = body(x, layer)
        if aux is not None:
            auxes.append(aux)
    return x, (torch.stack(auxes).mean() if auxes else None)


class _Tick(NamedTuple):
    """What a stage keeps of one microbatch for the backward: the slab's
    input (a leaf, or the embedding's output on stage 0), its output, its
    aux loss, and on the last stage the microbatch's NLL sum."""

    x: torch.Tensor
    y: torch.Tensor
    aux: torch.Tensor | None
    nll: torch.Tensor | None


def _pp_forward(cfg, params, tokens, group, n_micro, remat):
    """The forward ticks on this stage: (the _Ticks of its microbatches,
    the loss's global value, its count of labelled positions)."""
    n_stages = dist.get_world_size(group)
    stage = dist.get_rank(group)
    last = n_stages - 1
    b, n = tokens.shape
    if b % n_micro:
        raise ValueError(f"batch {b} does not divide into {n_micro} microbatches")
    mb = b // n_micro
    micro = tokens.view(n_micro, mb, n)
    sin, cos = tfm.rope_tables(cfg, torch.arange(n, device=tokens.device)[None, :])
    like = [torch.empty((mb, n, cfg.d_model), dtype=params["embed"].dtype,
                        device=tokens.device)]
    ticks, x_recv = [], None
    for t in range(n_micro + n_stages - 1):
        m = t - stage
        live = 0 <= m < n_micro
        if live:
            x = (params["embed"][micro[m]] if stage == 0
                 else x_recv.requires_grad_())
            y, aux = _stage_forward(cfg, params["layers"], x, sin, cos,
                                    remat=remat)
            nll = None
            if stage == last:
                h = tfm.rms_norm(y, params["rms_final"])
                logits = tfm.logits_f32(h, params["embed"])
                nll = torch.nn.functional.cross_entropy(
                    logits[:, :-1].flatten(0, 1), micro[m][:, 1:].flatten().long(),
                    reduction="sum")
            ticks.append(_Tick(x, y, aux, nll))
        # stage p sends microbatch t - p on; stage p + 1 runs it next tick
        got = exchange([ticks[-1].y.detach()] if live and stage < last else None,
                       stage + 1,
                       like if stage > 0 and 0 <= t + 1 - stage < n_micro else None,
                       stage - 1, group)
        x_recv = got[0] if got else None
    # the NLL lives on the last stage, each stage's aux on its own: one
    # all-reduce of (nll sum, aux sum) gives every stage the loss
    parts = torch.zeros(2, dtype=torch.float32, device=tokens.device)
    with torch.no_grad():
        for tk in ticks:
            if tk.nll is not None:
                parts[0] += tk.nll
            if tk.aux is not None:
                parts[1] += tk.aux
    dist.all_reduce(parts, group=group)
    count = b * (n - 1)
    # each stage's aux is its slab's mean over n_micro ticks: the sum over
    # the stages is n_stages times the mean over the layers
    loss = parts[0] / count + cfg.moe_aux_weight * parts[1] / (n_micro * n_stages)
    return ticks, loss, count


def _pp_backward(cfg, ticks, group, n_micro, count):
    """The backward ticks in reverse: each stage back-propagates its
    microbatches from the cotangent of the loss (last stage) or the one its
    successor sent, and sends its slab input's cotangent to its
    predecessor. Gradients accumulate in the parameter leaves."""
    n_stages = dist.get_world_size(group)
    stage = dist.get_rank(group)
    last = n_stages - 1
    aux_weight = cfg.moe_aux_weight / (n_micro * n_stages)
    like = [torch.empty_like(ticks[0].y)]
    g_recv = None
    for t in reversed(range(n_micro + n_stages - 1)):
        m = t - stage
        live = 0 <= m < n_micro
        if live:
            tk = ticks[m]
            if stage == last:
                outs, cots = [tk.nll], [torch.tensor(1.0 / count, device=tk.y.device)]
            else:
                outs, cots = [tk.y], [g_recv]
            if tk.aux is not None:
                outs.append(tk.aux)
                cots.append(torch.tensor(aux_weight, device=tk.y.device))
            torch.autograd.backward(outs, cots)
        # stage p sends microbatch t - p's input cotangent back; stage p - 1
        # back-propagates it next (reverse) tick
        got = exchange([ticks[m].x.grad] if live and stage > 0 else None,
                       stage - 1,
                       like if stage < last and 0 <= t - 1 - stage < n_micro
                       else None, stage + 1, group)
        g_recv = got[0] if got else None


def pp_loss_fn(cfg, params, tokens, *, mesh, n_micro: int,
               pipe_axis: str = "pipe", remat: bool = True):
    """Next-token NLL of `tokens` [B, N] (whole on every stage) through the
    pipeline over `pipe_axis`: params["layers"] this stage's slab
    (pp_param_specs), the rest whole. Returns the loss, the same on every
    stage (plus moe_aux_weight times the mean MoE aux for an MoE config).
    JAX's takes its axis from the enclosing shard_map; here `mesh` names
    it."""
    group = axis_group(mesh, pipe_axis)
    with torch.no_grad():
        return _pp_forward(cfg, params, tokens, group, n_micro, remat)[1]


def pp_param_specs(pipe_axis: str = "pipe"):
    """The stacked layer dimension cut over the pipe axis, the embedding
    and final norm whole (stage 0 reads the embedding, the last stage the
    head). The dense keys only, as JAX's: shard_params raises ValueError on
    an MoE tree, as JAX's does."""
    return {"embed": P(), "rms_final": P(),
            "layers": {k: P(pipe_axis) for k in _DENSE}}


def make_pp_train_step(cfg: tfm.TransformerConfig, mesh, *, n_micro: int = 4,
                       lr: float = 1e-3, pipe_axis: str = "pipe",
                       remat: bool = True):
    """The pipeline-parallel SGD step. Returns (step_fn(params, tokens) ->
    (new_params, loss), param_specs): params this stage's shards by
    param_specs, tokens the whole batch on every stage; the loss and the
    new embedding and final norm are the same on every stage.
    cfg.n_layers must divide over the axis (ValueError); params whose layer
    keys are not param_specs' (an MoE tree) raise ValueError, as JAX's
    shard_map does."""
    group = axis_group(mesh, pipe_axis)
    n_stages = dist.get_world_size(group)
    if cfg.n_layers % n_stages:
        raise ValueError(f"{cfg.n_layers} layers do not divide over "
                         f"{n_stages} stages")
    specs = pp_param_specs(pipe_axis)

    def step(params, tokens):
        if set(params["layers"]) != set(specs["layers"]):
            raise ValueError(f"layer keys {sorted(params['layers'])} are not the "
                             f"specs' {sorted(specs['layers'])}")
        flat = {k: x.detach().requires_grad_(True)
                for k, x in tfm._leaves(params).items()}
        with torch.enable_grad():
            ticks, loss, count = _pp_forward(cfg, tfm._unflatten(flat), tokens,
                                             group, n_micro, remat)
            _pp_backward(cfg, ticks, group, n_micro, count)
        del ticks
        grads = {k: torch.zeros_like(x) if x.grad is None else x.grad
                 for k, x in flat.items()}
        # the replicated leaves: the stages' contributions summed
        for k, g in grads.items():
            if not k.startswith("layers."):
                dist.all_reduce(g, group=group)
        return _sgd(flat, list(grads.values()), lr), loss.detach()

    return step, specs
