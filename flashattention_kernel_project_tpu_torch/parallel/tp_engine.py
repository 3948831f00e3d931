"""The serving engine over a device mesh: tensor parallel (TP) and
sequence parallel (SP).

Counterpart of flashattention_kernel_project_tpu/parallel/tp_engine.py.
TP: the Megatron layout (models.param_shardings: wq/wk/wv and w_gate/w_up
cut by columns, wo and w_down by rows), the cache cut over its KV heads, the
embedding and the lm_head whole. Each rank runs the single-device engine
(models/engine.py) on the local config (`local_config`: heads and d_ff
divided by the axis size) with `axis=` the model axis' process group, which
adds the two all-reduces a layer. SP: the cache cut along its length over
the seq axis, the parameters whole; every rank computes the same
activations, writes a new row only where the global write position falls
in its key range, decodes its range to partials, and the partials are
all-gathered and merged.

Where JAX's shard_map takes the whole arrays and returns them sharded, each
function here is called on every rank with the rank's own shards: the
parameters from parallel.shard_params, the caches from `init_tp_cache`,
`init_tp_paged_cache` or `init_sp_cache`, which allocate only the rank's
heads or key range. The logits (and the tokens of the multi-step windows)
come out the same on every rank, JAX's out_specs P(); the caches are the
rank's and are updated in place, as the port's engine does. A JAX lax.scan
over steps is a Python loop over steps. Whether a cache is 8-bit is read
from the cache itself (`cache.quantized`), so the functions take no
`quantized_cache`, which JAX's need for their shard_map specs. The `*_specs` functions give the
caches' layouts in JAX's shapes and names.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from flashattention_kernel_project_tpu_torch.models import engine
from flashattention_kernel_project_tpu_torch.models import transformer as tfm
from flashattention_kernel_project_tpu_torch.ops.flash_decode import (
    flash_decode,
    flash_decode_int8,
)
from flashattention_kernel_project_tpu_torch.ops.quant import quantizer_for
from flashattention_kernel_project_tpu_torch.parallel.mesh import (
    axis_group,
    axis_size,
    gather_merge,
    mesh_device,
)
from flashattention_kernel_project_tpu_torch.utils.sharding import P


def local_config(cfg: tfm.TransformerConfig, tp: int) -> tfm.TransformerConfig:
    """The per-rank config: heads and MLP width divided over the TP axis
    (ValueError if they do not divide). An MoE config's d_ff is divided
    too, as JAX's is."""
    if cfg.n_heads % tp or cfg.n_kv_heads % tp:
        raise ValueError(f"heads ({cfg.n_heads}/{cfg.n_kv_heads}) not "
                         f"divisible by tp={tp}")
    if cfg.d_ff % tp:
        raise ValueError(f"d_ff {cfg.d_ff} not divisible by tp={tp}")
    return dataclasses.replace(cfg, n_heads=cfg.n_heads // tp,
                               n_kv_heads=cfg.n_kv_heads // tp,
                               d_ff=cfg.d_ff // tp)


def cache_specs(quantized: bool, n_layers: int, model_axis: str = "model"):
    """The specs of a head-sharded engine.KVCache."""
    kv = [P(None, model_axis, None, None)] * n_layers
    scale = kv if quantized else None
    return engine.KVCache(k=kv, v=kv, lengths=P(), k_scale=scale,
                          v_scale=scale)


def init_tp_cache(cfg: tfm.TransformerConfig, mesh, batch: int, max_len: int,
                  *, quantized: bool = False, quant_fmt: str = "int8",
                  model_axis: str = "model") -> engine.KVCache:
    """This rank's part of a head-sharded linear cache: its KV heads, on
    its device."""
    lcfg = local_config(cfg, axis_size(mesh, model_axis))
    return engine.init_cache(lcfg, batch, max_len, mesh_device(mesh),
                             quantized=quantized, quant_fmt=quant_fmt)


def paged_cache_specs(quantized: bool, n_layers: int,
                      model_axis: str = "model"):
    """The specs of a head-sharded engine.PagedKVCache: the pools cut over
    their KV heads, the block tables and lengths whole."""
    pool = [P(None, model_axis, None, None)] * n_layers
    scale = pool if quantized else None
    return engine.PagedKVCache(k_pages=pool, v_pages=pool, block_tables=P(),
                               lengths=P(), k_scale_pages=scale,
                               v_scale_pages=scale)


def init_tp_paged_cache(cfg: tfm.TransformerConfig, mesh, batch: int,
                        n_pages: int, *, page_size: int = 128,
                        max_pages_per_seq: int = 16, quantized: bool = False,
                        model_axis: str = "model") -> engine.PagedKVCache:
    """This rank's part of head-sharded page pools: its KV heads of every
    page, the whole block tables."""
    lcfg = local_config(cfg, axis_size(mesh, model_axis))
    return engine.init_paged_cache(lcfg, batch, n_pages, mesh_device(mesh),
                                   page_size=page_size,
                                   max_pages_per_seq=max_pages_per_seq,
                                   quantized=quantized)


def _tp(cfg, mesh, model_axis):
    """(local config, the axis' group, the parameters' specs)."""
    lcfg = local_config(cfg, axis_size(mesh, model_axis))
    return (lcfg, axis_group(mesh, model_axis),
            tfm.param_shardings(cfg, model_axis=model_axis))


def make_tp_verify_extend(cfg: tfm.TransformerConfig, mesh, *,
                          model_axis: str = "model"):
    """TP ragged extend returning every position's logits [B, T, V]: the
    speculative verify over the mesh. fn(params, tokens [B, T], cache) ->
    (logits, cache)."""
    lcfg, group, _ = _tp(cfg, mesh, model_axis)

    def fn(params, tokens, cache):
        return engine.extend(lcfg, params, tokens, cache, all_logits=True,
                             axis=group)

    return fn


def make_tp_paged_decode(cfg: tfm.TransformerConfig, mesh, *,
                         model_axis: str = "model"):
    """decode_step_paged over head-sharded page pools: fn(params, tokens
    [B], cache) -> (logits [B, V], cache); params per param_shardings (the
    split layout), the cache per init_tp_paged_cache. The page scatter
    (engine.paged_insert) runs on each rank's pools outside this."""
    lcfg, group, _ = _tp(cfg, mesh, model_axis)

    def fn(params, tokens, cache):
        return engine.decode_step_paged(lcfg, params, tokens, cache, axis=group)

    return fn


def make_tp_paged_verify_extend(cfg: tfm.TransformerConfig, mesh, *,
                                model_axis: str = "model"):
    """TP multi-token extend over the page pool returning every position's
    logits [B, T, V]: the speculative verify with the target on the mesh
    and a page pool (bf16, extend_paged's contract on the mesh)."""
    lcfg, group, _ = _tp(cfg, mesh, model_axis)

    def fn(params, tokens, cache):
        return engine.extend_paged(lcfg, params, tokens, cache, axis=group)

    return fn


def make_tp_decode_steps(cfg: tfm.TransformerConfig, mesh, *, n_steps: int,
                         model_axis: str = "model", n_splits: int | None = None,
                         paged: bool = False):
    """n_steps greedy decode steps over the mesh (the linear or, with
    paged=True, the paged cache): fn(params, tokens [B], cache) -> (tokens
    [B, n_steps] int32, the cache advanced n_steps)."""
    lcfg, group, _ = _tp(cfg, mesh, model_axis)

    def fn(params, tokens, cache):
        if paged:
            return engine.decode_steps_paged(lcfg, params, tokens, cache,
                                             n_steps=n_steps, axis=group)
        return engine.decode_steps(lcfg, params, tokens, cache, n_steps=n_steps,
                                   n_splits=n_splits, axis=group)

    return fn


def make_tp_engine(cfg: tfm.TransformerConfig, mesh, *,
                   model_axis: str = "model", n_splits: int | None = None):
    """The TP engine: (prefill_fn, extend_fn, decode_fn, rules). The
    parameters are the rank's shards by `rules` (parallel.shard_params), the
    cache init_tp_cache's.

    prefill_fn(params, tokens [B, T], cache) -> (logits [B, V], cache)
    extend_fn(params, tokens [B, T], cache, n [B]) -> (logits [B, V], cache)
    decode_fn(params, tokens [B], cache) -> (logits [B, V], cache)

    The logits are the same on every rank: the lm_head is whole and reads
    the all-reduced final hidden state."""
    lcfg, group, rules = _tp(cfg, mesh, model_axis)

    def prefill_fn(params, tokens, cache):
        return engine.prefill(lcfg, params, tokens, cache, axis=group)

    def extend_fn(params, tokens, cache, n):
        return engine.extend(lcfg, params, tokens, cache, n=n, axis=group)

    def decode_fn(params, tokens, cache):
        return engine.decode_step(lcfg, params, tokens, cache,
                                  n_splits=n_splits, axis=group)

    return prefill_fn, extend_fn, decode_fn, rules


# ---------------------------------------------------------------------------
# The sequence-sharded decode (context parallel at serving time): the cache
# cut along its length, for contexts longer than one device holds. The
# parameters are whole and every rank computes the same activations; what is
# split is the KV stream, which bounds decode.
# ---------------------------------------------------------------------------


def sp_cache_specs(n_layers: int, seq_axis: str = "sp",
                   quantized: bool = False):
    """The specs of a length-sharded engine.KVCache."""
    kv = [P(None, None, seq_axis, None)] * n_layers
    scale = kv if quantized else None
    return engine.KVCache(k=kv, v=kv, lengths=P(), k_scale=scale,
                          v_scale=scale)


def init_sp_cache(cfg: tfm.TransformerConfig, mesh, batch: int, max_len: int,
                  *, quantized: bool = False, quant_fmt: str = "int8",
                  seq_axis: str = "sp") -> engine.KVCache:
    """This rank's key range of a length-sharded linear cache (max_len over
    the axis' size rows; ValueError if it does not divide); 8-bit values
    and scales when quantized. Its lengths are the global ones."""
    sp = axis_size(mesh, seq_axis)
    if max_len % sp:
        raise ValueError(f"max_len {max_len} not divisible by {sp} ranks")
    return engine.init_cache(cfg, batch, max_len // sp, mesh_device(mesh),
                             quantized=quantized, quant_fmt=quant_fmt)


def _write_shard(layers, news, pos, ok):
    """Write each new [B, Hkv, 1, X] row at the local row pos[b] of its
    cache layer [B, Hkv, S_loc, X], in place, for the slots where ok[b]
    (the rank holds the global write position); the other slots keep their
    row (JAX's jnp.where, with no host sync)."""
    slots = torch.arange(pos.shape[0], device=pos.device)
    keep = ok[:, None, None]
    for layer, new in zip(layers, news):
        old = layer[slots, :, pos]  # [B, Hkv, X]
        layer[slots, :, pos] = torch.where(keep, new[:, :, 0].to(layer.dtype),
                                           old)


def _sp_step(cfg, params, tokens, cache, group, n_splits):
    """One SP decode step on this rank's key range: (logits [B, V], the
    same on every rank; the cache advanced one row, in place)."""
    if cfg.attn_window is not None:
        raise NotImplementedError(
            "the seq-sharded decode has no sliding window: a rank's clipped "
            "length is not the band's end (JAX's ignores the window)")
    b = tokens.shape[0]
    s_loc = cache.k[0].shape[2]
    lo = dist.get_rank(group) * s_loc
    x = params["embed"][tokens][:, None]
    sin, cos = tfm.rope_tables(cfg, cache.lengths[:, None])
    local_pos = cache.lengths.long() - lo
    ok = (local_pos >= 0) & (local_pos < s_loc)
    pos = local_pos.clamp(0, s_loc - 1)
    new_lengths = cache.lengths + 1
    local_len = (new_lengths - lo).clamp(0, s_loc).to(torch.int32)
    for i in range(cfg.n_layers):
        layer = tfm.layer_params(params, i)
        h = tfm.rms_norm(x, layer["rms_attn"])
        q, k, v = engine._qkv(cfg, layer, h, b, 1)
        q = tfm.apply_rope(q, sin, cos)
        k = tfm.apply_rope(k, sin, cos)
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)
        qd = q.reshape(b, cfg.n_heads, cfg.d_head).to(cfg.dtype)
        if cache.quantized:
            vals, scales = quantizer_for(cache.k[i].dtype)(
                torch.stack((kt, vt)), axis=-1)
            _write_shard((cache.k[i], cache.v[i], cache.k_scale[i],
                          cache.v_scale[i]),
                         (vals[0], vals[1], scales[0], scales[1]), pos, ok)
            m, l, y = flash_decode_int8(
                qd, cache.k[i], cache.k_scale[i], cache.v[i], cache.v_scale[i],
                local_len, n_splits=n_splits, return_partials=True)
        else:
            _write_shard((cache.k[i], cache.v[i]), (kt, vt), pos, ok)
            m, l, y = flash_decode(qd, cache.k[i], cache.v[i], local_len,
                                   n_splits=n_splits, return_partials=True)
        o = gather_merge(m, l, y, group).reshape(b, 1, cfg.q_dim).to(x.dtype)
        x = x + engine._proj(o, layer, "wo")
        x = engine._mlp(layer, x, cfg)
    x = tfm.rms_norm(x, params["rms_final"])
    cache.lengths.copy_(new_lengths)
    return engine._lm_head(params, x[:, 0]), cache


def make_sp_decode_step(cfg: tfm.TransformerConfig, mesh, *,
                        seq_axis: str = "sp", n_splits: int | None = None):
    """fn(params, tokens [B], cache) -> (logits [B, V], cache): one decode
    step over the length-sharded cache (init_sp_cache), the parameters
    whole (the split layout). With an 8-bit cache the new row is quantized
    on the rank that holds it and each rank decodes its range through the
    8-bit kernel. An MoE model's layers route their batch alike on every
    rank (engine._mlp with no axis: the parameters are whole), empty slots
    included, as JAX's SP step does."""
    group = axis_group(mesh, seq_axis)

    def fn(params, tokens, cache):
        return _sp_step(cfg, params, tokens, cache, group, n_splits)

    return fn


def make_sp_decode_steps(cfg: tfm.TransformerConfig, mesh, *, n_steps: int,
                         seq_axis: str = "sp", n_splits: int | None = None):
    """n_steps greedy SP decode steps: fn(params, tokens [B], cache) ->
    (tokens [B, n_steps] int32, the cache advanced n_steps)."""
    step = make_sp_decode_step(cfg, mesh, seq_axis=seq_axis, n_splits=n_splits)

    def fn(params, tokens, cache):
        return engine._step_loop(lambda cur, c: step(params, cur, c), tokens,
                                 cache, n_steps, 0.0, None, None, None)

    return fn
