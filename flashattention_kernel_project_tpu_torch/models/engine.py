"""Inference engine: linear and paged KV caches, prefill, chunked extend,
decode, generation, speculative decoding.

Counterpart of flashattention_kernel_project_tpu/models/engine.py for
full-precision caches: prefill runs attention through ops.flash_attention,
`extend` (chunked prefill against a live cache) through
ops.flash_attention.flash_attention_ragged, `extend_paged` through
ops.paged_decode.paged_flash_extend, decode through ops.flash_decode over
the linear cache and ops.paged_decode over the page pool.
`speculative_generate` drafts with a small model's decode steps and
verifies with one multi-token target `extend` a round.

Unlike the JAX engine, whose functions return a new cache, the port updates
the cache IN PLACE: `prefill`, `extend`, `extend_paged`, `decode_step`,
`decode_step_paged` and `paged_insert` write the new K/V rows into the
cache's per-layer buffers and advance its lengths, then return the same
cache object. Writes that would run past a linear buffer are clamped to its
end, as jax.lax.dynamic_update_slice clamps its start; paged writes past a
table's capacity go to the junk page 0.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from flashattention_kernel_project_tpu_torch.models import transformer as tfm
from flashattention_kernel_project_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_ragged,
)
from flashattention_kernel_project_tpu_torch.ops.flash_decode import flash_decode
from flashattention_kernel_project_tpu_torch.ops.paged_decode import (
    paged_append,
    paged_append_chunk,
    paged_flash_decode,
    paged_flash_extend,
)


@dataclasses.dataclass
class KVCache:
    """KV cache as per-layer buffers.

    k, v: lists of L tensors [B, Hkv, S_max, D] in the model dtype
    lengths: [B] int32 on the same device, the valid tokens per slot
    """

    k: list
    v: list
    lengths: torch.Tensor


def init_cache(
    cfg: tfm.TransformerConfig,
    batch: int,
    max_len: int,
    device,
    *,
    quantized: bool = False,
) -> KVCache:
    """Allocate a zeroed linear KV cache on `device`."""
    if quantized:
        raise NotImplementedError("8-bit KV caches are ROADMAP item A.7")
    shape = (batch, cfg.n_kv_heads, max_len, cfg.d_head)
    L = cfg.n_layers
    return KVCache(
        k=[torch.zeros(shape, dtype=cfg.dtype, device=device) for _ in range(L)],
        v=[torch.zeros(shape, dtype=cfg.dtype, device=device) for _ in range(L)],
        lengths=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def _write_tokens(cache_layer, new, lengths):
    """Write new [B, Hkv, T, D] into cache_layer [B, Hkv, S, D] at rows
    lengths[b] .. lengths[b] + T - 1 of each slot, in place. A start past
    S - T clamps to S - T (as dynamic_update_slice does), so a retired slot
    riding the batch with a growing length never writes past the buffer."""
    b, _, s, _ = cache_layer.shape
    t = new.shape[2]
    start = lengths.long().clamp(0, s - t)
    pos = start[:, None] + torch.arange(t, device=new.device)[None, :]
    slots = torch.arange(b, device=new.device)[:, None]
    # advanced indices on dims 0 and 2 put [B, T] first: value [B, T, Hkv, D]
    cache_layer[slots, :, pos] = new.transpose(1, 2).to(cache_layer.dtype)


def prefill(cfg, params, tokens, cache: KVCache):
    """Run the prompt tokens [B, T] through the model, writing K/V at each
    slot's current length and advancing the lengths by T (in place).
    Returns (last-position logits [B, vocab] float32, cache).

    Assumes the prefilled slots are empty (lengths == 0): attention here
    only sees the prompt itself."""
    tfm._dense_only(cfg)
    b, t = tokens.shape
    x = params["embed"][tokens]
    positions = cache.lengths[:, None].long() + torch.arange(
        t, device=tokens.device)[None, :]
    sin, cos = tfm.rope_tables(cfg, positions)
    for i in range(cfg.n_layers):
        layer = tfm.layer_params(params, i)
        h = tfm.rms_norm(x, layer["rms_attn"])
        q, k, v = _qkv(cfg, layer, h, b, t)
        q = tfm.apply_rope(q, sin, cos)
        k = tfm.apply_rope(k, sin, cos)
        kt = k.transpose(1, 2).contiguous()
        vt = v.transpose(1, 2).contiguous()
        o = flash_attention(
            q.transpose(1, 2).contiguous(), kt, vt,
            causal=True,
            stable=cfg.attn_stable,
            window=cfg.attn_window,
            sinks=cfg.attn_sinks,
        )
        x = x + o.transpose(1, 2).reshape(b, t, cfg.q_dim) @ layer["wo"]
        x = _mlp(layer, x)
        _write_tokens(cache.k[i], kt, cache.lengths)
        _write_tokens(cache.v[i], vt, cache.lengths)
    x = tfm.rms_norm(x, params["rms_final"])
    cache.lengths += t
    return tfm.logits_f32(x[:, -1], params["embed"]), cache


def fuse_decode_params(cfg: tfm.TransformerConfig, params: dict) -> dict:
    """One-time transform for the decode loop: QKV concatenated into one
    [D, q+2kv] matrix and gate/up into one [D, 2F] per layer, so a decode
    step streams 5 weight matrices per layer instead of 7 (decode at small
    batch is bound by weight bytes). The split layout stays for prefill."""
    L = params["layers"]
    return {
        "embed": params["embed"],
        "rms_final": params["rms_final"],
        "layers": {
            "rms_attn": L["rms_attn"],
            "rms_mlp": L["rms_mlp"],
            "wo": L["wo"],
            "w_down": L["w_down"],
            "wqkv": torch.cat([L["wq"], L["wk"], L["wv"]], dim=-1),
            "w_gate_up": torch.cat([L["w_gate"], L["w_up"]], dim=-1),
        },
    }


def _proj(x, layer, name):
    """x [B, T, K] @ layer weight `name` [K, N] (full precision; the 8-bit
    weight path is ROADMAP item A.7)."""
    return x @ layer[name]


def _lm_head(params, x):
    """Logits x [B, D] -> [B, vocab], float32 products, sums and output."""
    return tfm.logits_f32(x, params["embed"])


def _qkv(cfg, layer, h, b, t):
    """Project h -> (q, k, v) [B, T, heads, d_head] with the fused or the
    split weights."""
    if "wqkv" in layer:
        qd, kvd = cfg.q_dim, cfg.kv_dim
        qkv = _proj(h, layer, "wqkv")
        q = qkv[..., :qd].reshape(b, t, cfg.n_heads, cfg.d_head)
        k = qkv[..., qd:qd + kvd].reshape(b, t, cfg.n_kv_heads, cfg.d_head)
        v = qkv[..., qd + kvd:].reshape(b, t, cfg.n_kv_heads, cfg.d_head)
        return q, k, v
    q = (h @ layer["wq"]).view(b, t, cfg.n_heads, cfg.d_head)
    k = (h @ layer["wk"]).view(b, t, cfg.n_kv_heads, cfg.d_head)
    v = (h @ layer["wv"]).view(b, t, cfg.n_kv_heads, cfg.d_head)
    return q, k, v


def _mlp(layer, x):
    if "w_gate_up" in layer:
        h = tfm.rms_norm(x, layer["rms_mlp"])
        gu = _proj(h, layer, "w_gate_up")
        f = gu.shape[-1] // 2
        gated = torch.nn.functional.silu(gu[..., :f]) * gu[..., f:]
        return x + _proj(gated, layer, "w_down")
    return tfm._mlp_block(layer, x)


def decode_step(cfg, params, tokens, cache: KVCache, *, n_splits=None):
    """One decode step: tokens [B] -> (logits [B, vocab] float32, cache).
    Appends each slot's K/V row at its length and advances the lengths by
    one, in place. `params` may be fused (fuse_decode_params) or split."""
    tfm._dense_only(cfg)
    b = tokens.shape[0]
    x = params["embed"][tokens][:, None]  # [B, 1, D]
    sin, cos = tfm.rope_tables(cfg, cache.lengths[:, None])
    new_lengths = cache.lengths + 1
    for i in range(cfg.n_layers):
        layer = tfm.layer_params(params, i)
        h = tfm.rms_norm(x, layer["rms_attn"])
        q, k, v = _qkv(cfg, layer, h, b, 1)
        q = tfm.apply_rope(q, sin, cos)
        k = tfm.apply_rope(k, sin, cos)
        _write_tokens(cache.k[i], k.transpose(1, 2), cache.lengths)
        _write_tokens(cache.v[i], v.transpose(1, 2), cache.lengths)
        o = flash_decode(
            q.reshape(b, cfg.n_heads, cfg.d_head).to(cfg.dtype),
            cache.k[i], cache.v[i], new_lengths,
            n_splits=n_splits, window=cfg.attn_window, sinks=cfg.attn_sinks,
        )
        x = x + _proj(o.reshape(b, 1, cfg.q_dim), layer, "wo")
        x = _mlp(layer, x)
    x = tfm.rms_norm(x, params["rms_final"])
    cache.lengths.copy_(new_lengths)
    return _lm_head(params, x[:, 0]), cache


def _step_loop(step, tokens, cache, n_steps, temperature, generator, top_k,
               top_p):
    """n_steps calls of step(tokens, cache) -> (logits, cache), each
    feeding back its sampled token: ([B, n_steps] int32, cache). A Python
    loop in place of the JAX package's lax.scan."""
    cur = tokens.to(torch.int32)
    out = []
    for _ in range(n_steps):
        logits, cache = step(cur, cache)
        cur = _sample(logits, temperature, generator, top_k, top_p)
        out.append(cur)
    return torch.stack(out, dim=1), cache


def decode_steps(
    cfg, params, tokens, cache: KVCache, *, n_steps: int, n_splits=None,
    temperature: float = 0.0, generator: torch.Generator | None = None,
    top_k: int | None = None, top_p: float | None = None,
):
    """n_steps decode steps, each feeding back its sampled token: tokens
    [B] -> ([B, n_steps] int32, cache advanced n_steps)."""
    return _step_loop(
        lambda cur, c: decode_step(cfg, params, cur, c, n_splits=n_splits),
        tokens, cache, n_steps, temperature, generator, top_k, top_p)


def extend(
    cfg, params, tokens, cache: KVCache, *, n: torch.Tensor | None = None,
    all_logits: bool = False,
):
    """Chunked prefill: append T tokens per slot to a live cache, in place,
    attending to each slot's whole prefix through flash_attention_ragged.
    tokens [B, T] -> (last-position logits [B, vocab] float32, or every
    position's [B, T, vocab] with all_logits=True, and the cache).

    n [B] int32 (optional) makes the chunk ragged: slot b appends only its
    first n[b] tokens (1 <= n[b] <= T; pad the rest). Lengths advance by n,
    the per-slot KV bound keeps the padded tail invisible (later appends
    overwrite it), and the logits are taken at each slot's last real
    position n[b] - 1. The padded tail is still written, so the cache needs
    T rows of room past each slot's length."""
    tfm._dense_only(cfg)
    b, t = tokens.shape
    x = params["embed"][tokens]
    old_lengths = cache.lengths.clone()
    positions = old_lengths[:, None].long() + torch.arange(
        t, device=tokens.device)[None, :]
    sin, cos = tfm.rope_tables(cfg, positions)
    new_lengths = old_lengths + (t if n is None else n.to(torch.int32))
    for i in range(cfg.n_layers):
        layer = tfm.layer_params(params, i)
        h = tfm.rms_norm(x, layer["rms_attn"])
        q, k, v = _qkv(cfg, layer, h, b, t)
        q = tfm.apply_rope(q, sin, cos)
        k = tfm.apply_rope(k, sin, cos)
        _write_tokens(cache.k[i], k.transpose(1, 2), old_lengths)
        _write_tokens(cache.v[i], v.transpose(1, 2), old_lengths)
        o = flash_attention_ragged(
            q.transpose(1, 2).contiguous().to(cfg.dtype),
            cache.k[i], cache.v[i], new_lengths, old_lengths,
            causal=True, stable=cfg.attn_stable, window=cfg.attn_window,
            sinks=cfg.attn_sinks,
        )
        x = x + _proj(o.transpose(1, 2).reshape(b, t, cfg.q_dim), layer, "wo")
        x = _mlp(layer, x)
    x = tfm.rms_norm(x, params["rms_final"])
    if all_logits:
        xe = x
    elif n is None:
        xe = x[:, -1]
    else:
        last = n.long().clamp(min=1) - 1
        xe = x[torch.arange(b, device=x.device), last]
    cache.lengths.copy_(new_lengths)
    return tfm.logits_f32(xe, params["embed"]), cache


def generate(
    cfg, params, prompt, *, max_new_tokens: int = 32, max_len: int | None = None,
    n_splits=None, temperature: float = 0.0,
    top_k: int | None = None, top_p: float | None = None,
    generator: torch.Generator | None = None,
):
    """Greedy (or sampled, with temperature and a generator) generation.
    prompt [B, T] -> [B, T + max_new_tokens] int32."""
    b, t = prompt.shape
    max_len = max_len or (t + max_new_tokens)
    cache = init_cache(cfg, b, max_len, prompt.device)
    logits, cache = prefill(cfg, params, prompt, cache)
    dec_params = fuse_decode_params(cfg, params)
    cur = _sample(logits, temperature, generator, top_k, top_p)
    parts = [prompt.to(torch.int32), cur[:, None]]
    if max_new_tokens > 1:
        toks, cache = decode_steps(
            cfg, dec_params, cur, cache, n_steps=max_new_tokens - 1,
            n_splits=n_splits, temperature=temperature, generator=generator,
            top_k=top_k, top_p=top_p,
        )
        parts.append(toks)
    return torch.cat(parts, dim=1)


def _sample(logits, temperature, generator, top_k=None, top_p=None):
    """Greedy / temperature / top-k / nucleus sampling. logits [B, V] ->
    [B] int32. Greedy when temperature <= 0 or no generator is given."""
    if temperature <= 0.0 or generator is None:
        return logits.argmax(dim=-1).to(torch.int32)
    logits = logits.float() / temperature
    v = logits.shape[-1]
    use_k = top_k is not None and 0 < top_k < v
    use_p = top_p is not None and 0.0 < top_p < 1.0
    if use_k or use_p:
        sorted_desc = logits.sort(dim=-1, descending=True).values
        if use_k:
            kth = sorted_desc[:, top_k - 1:top_k]
            logits = logits.masked_fill(logits < kth, float("-inf"))
        if use_p:
            if use_k:
                keep_k = torch.arange(v, device=logits.device)[None, :] < top_k
                sorted_desc = sorted_desc.masked_fill(~keep_k, float("-inf"))
            probs = torch.softmax(sorted_desc, dim=-1)
            cum = probs.cumsum(dim=-1)
            # the smallest prefix with cumulative probability >= top_p; it
            # always holds the argmax
            keep = cum - probs < top_p
            cutoff = torch.where(keep, sorted_desc,
                                 torch.full_like(sorted_desc, float("inf")))
            cutoff = cutoff.amin(dim=-1, keepdim=True)
            logits = logits.masked_fill(logits < cutoff, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


# ---------------------------------------------------------------------------
# The paged cache: pages of a shared pool and per-slot block tables replace
# the per-slot linear buffers. Prefill still runs into a linear batch-1
# cache; paged_insert moves its rows into pages.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PagedKVCache:
    """KV cache as per-layer page pools.

    k_pages, v_pages: lists of L tensors [n_pages, Hkv, page, D] in the
        model dtype (page 0 is the junk page)
    block_tables: [B, max_pages] int32, each slot's page ids in order
        (shared by the layers: a page id names the same page in every pool)
    lengths: [B] int32, the valid tokens per slot
    """

    k_pages: list
    v_pages: list
    block_tables: torch.Tensor
    lengths: torch.Tensor

    @property
    def page_size(self) -> int:
        return self.k_pages[0].shape[2]


def init_paged_cache(
    cfg: tfm.TransformerConfig,
    batch: int,
    n_pages: int,
    device,
    *,
    page_size: int = 128,
    max_pages_per_seq: int = 16,
    quantized: bool = False,
) -> PagedKVCache:
    """Allocate a zeroed page pool with all-zero block tables on `device`."""
    if quantized:
        raise NotImplementedError("8-bit page pools are ROADMAP item A.7")
    shape = (n_pages, cfg.n_kv_heads, page_size, cfg.d_head)
    L = cfg.n_layers
    return PagedKVCache(
        k_pages=[torch.zeros(shape, dtype=cfg.dtype, device=device) for _ in range(L)],
        v_pages=[torch.zeros(shape, dtype=cfg.dtype, device=device) for _ in range(L)],
        block_tables=torch.zeros((batch, max_pages_per_seq), dtype=torch.int32,
                                 device=device),
        lengths=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def paged_insert(
    cache: PagedKVCache, slot: int, table_row, k_seq, v_seq, length: int, *,
    start_page: int = 0,
) -> PagedKVCache:
    """Move a sequence's prefix KV into its pages and install its block
    table at `slot`, in place. table_row [max_pages] int32 (host or device)
    holds the sequence's page ids; k_seq, v_seq are per-layer
    [Hkv, >= length, D]. Pages start_page .. ceil(length / page) - 1 are
    written whole (rows past `length` zeroed, as the JAX package's page
    scatter does); the first start_page pages are shared prefix-cache
    pages that already hold this content and are left alone. Returns the
    cache."""
    page = cache.page_size
    n_full = -(-int(length) // page)
    device = cache.block_tables.device
    if not torch.is_tensor(table_row):
        table_row = torch.from_numpy(np.asarray(table_row, np.int32))
    row = table_row.to(device=device, dtype=torch.int32)
    cache.block_tables[slot] = row
    cache.lengths[slot] = int(length)
    if n_full <= start_page:
        return cache
    ids = row[start_page:n_full].long()
    lo, hi = start_page * page, int(length)
    for pages, seqs in ((cache.k_pages, k_seq), (cache.v_pages, v_seq)):
        for pool, seq in zip(pages, seqs):
            hkv, _, d = seq.shape
            blocks = torch.zeros((hkv, (n_full - start_page) * page, d),
                                 dtype=pool.dtype, device=device)
            blocks[:, : hi - lo] = seq[:, lo:hi]
            pool[ids] = blocks.view(hkv, -1, page, d).transpose(0, 1)
    return cache


def cache_from_pages(
    cfg: tfm.TransformerConfig, cache: PagedKVCache, page_ids, s: int,
    max_len: int,
) -> KVCache:
    """A batch-1 linear cache of max_len rows whose first s rows are the
    content of the given (full) pages, with length s: the prefix-cache
    gather that lets a request skip the prefill of a shared prompt prefix
    and extend only its suffix."""
    device = cache.lengths.device
    ids = torch.as_tensor(list(page_ids), dtype=torch.long).to(device)
    out = init_cache(cfg, 1, max_len, device)
    for pools, rows in ((cache.k_pages, out.k), (cache.v_pages, out.v)):
        for pool, lin in zip(pools, rows):
            hkv, d = pool.shape[1], pool.shape[3]
            lin[0, :, :s] = pool[ids].transpose(0, 1).reshape(hkv, -1, d)[:, :s]
    out.lengths.fill_(s)
    return out


def decode_step_paged(cfg, params, tokens, cache: PagedKVCache):
    """One decode step against the paged cache: tokens [B] -> (logits
    [B, vocab] float32, cache). Appends each slot's K/V row into its current
    page and advances the lengths by one, in place; a slot of length 0 gets
    zero attention output. `params` may be fused or split."""
    tfm._dense_only(cfg)
    b = tokens.shape[0]
    x = params["embed"][tokens][:, None]  # [B, 1, D]
    sin, cos = tfm.rope_tables(cfg, cache.lengths[:, None])
    new_lengths = cache.lengths + 1
    for i in range(cfg.n_layers):
        layer = tfm.layer_params(params, i)
        h = tfm.rms_norm(x, layer["rms_attn"])
        q, k, v = _qkv(cfg, layer, h, b, 1)
        q = tfm.apply_rope(q, sin, cos)
        k = tfm.apply_rope(k, sin, cos)
        paged_append(cache.k_pages[i], cache.v_pages[i], k[:, 0], v[:, 0],
                     cache.block_tables, cache.lengths)
        o = paged_flash_decode(
            q.reshape(b, cfg.n_heads, cfg.d_head).to(cfg.dtype),
            cache.k_pages[i], cache.v_pages[i], cache.block_tables,
            new_lengths,
        )
        x = x + _proj(o.reshape(b, 1, cfg.q_dim), layer, "wo")
        x = _mlp(layer, x)
    x = tfm.rms_norm(x, params["rms_final"])
    cache.lengths.copy_(new_lengths)
    return _lm_head(params, x[:, 0]), cache


def decode_steps_paged(
    cfg, params, tokens, cache: PagedKVCache, *, n_steps: int,
    temperature: float = 0.0, generator: torch.Generator | None = None,
    top_k: int | None = None, top_p: float | None = None,
):
    """decode_steps against the paged cache: tokens [B] -> ([B, n_steps]
    int32, cache advanced n_steps)."""
    return _step_loop(
        lambda cur, c: decode_step_paged(cfg, params, cur, c),
        tokens, cache, n_steps, temperature, generator, top_k, top_p)


def extend_paged(cfg, params, tokens, cache: PagedKVCache):
    """Multi-token extend against the paged cache, in place: tokens [B, T]
    -> (every position's logits [B, T, vocab] float32, cache advanced by
    T). The paged counterpart of `extend(..., all_logits=True)`, and the
    speculative verify step over a page pool: per layer, the chunk's K/V go
    into the pages in one write per pool (paged_append_chunk), then
    paged_flash_extend scores every chunk position. Each slot must own the
    pages for T more tokens (the Scheduler's reserve rows see to it). The
    lengths advance on the device, with no host sync. `params` may be fused
    or split."""
    tfm._dense_only(cfg)
    pool = cache.k_pages[0]
    if not pool.is_floating_point() or pool.element_size() < 2:
        raise NotImplementedError("extend_paged: 8-bit page pools are ROADMAP item A.7")
    b, t = tokens.shape
    x = params["embed"][tokens]
    old_lengths = cache.lengths.clone()
    positions = old_lengths[:, None].long() + torch.arange(
        t, device=tokens.device)[None, :]
    sin, cos = tfm.rope_tables(cfg, positions)
    new_lengths = old_lengths + t
    for i in range(cfg.n_layers):
        layer = tfm.layer_params(params, i)
        h = tfm.rms_norm(x, layer["rms_attn"])
        q, k, v = _qkv(cfg, layer, h, b, t)
        q = tfm.apply_rope(q, sin, cos)
        k = tfm.apply_rope(k, sin, cos)
        paged_append_chunk(cache.k_pages[i], cache.v_pages[i], k, v,
                           cache.block_tables, old_lengths)
        o = paged_flash_extend(
            q.transpose(1, 2).contiguous().to(cfg.dtype),
            cache.k_pages[i], cache.v_pages[i], cache.block_tables,
            new_lengths, old_lengths,
        )  # [B, Hq, T, D]
        x = x + _proj(o.transpose(1, 2).reshape(b, t, cfg.q_dim), layer, "wo")
        x = _mlp(layer, x)
    x = tfm.rms_norm(x, params["rms_final"])
    cache.lengths.copy_(new_lengths)
    return tfm.logits_f32(x, params["embed"]), cache


# ---------------------------------------------------------------------------
# Speculative decoding: a draft model proposes, the target verifies with one
# chunked extend a round. temperature 0 is greedy and gives exactly the
# target's greedy tokens; temperature > 0 accepts a draft d_j with
# probability min(1, p/q) and resamples the residual on a rejection, which
# keeps the target's sampling distribution.
# ---------------------------------------------------------------------------


def speculative_accept(p, q, d, rng) -> list[int]:
    """Rejection-sampling acceptance for one slot (numpy).

    p: [k+1, V] target probabilities (p[j] is the target's distribution
    after the first j+1 chunk tokens), q: [k, V] draft probabilities, d: [k]
    draft tokens drawn from q, rng: np.random.Generator. Returns the
    committed tokens (1 to k+1): the accepted draft prefix and one token
    drawn from the residual norm(max(p - q, 0)) at the first rejection, or a
    bonus token from p[k] when every draft is accepted. The committed
    sequence is distributed as target-only sampling (Leviathan et al. 2023,
    Chen et al. 2023). The same p, q, d and rng state give the JAX
    package's tokens."""
    k = len(d)
    out: list[int] = []
    for j in range(k):
        tok = int(d[j])
        p_j = p[j]
        q_tok = max(float(q[j, tok]), 1e-20)
        if rng.random() < float(p_j[tok]) / q_tok:
            out.append(tok)
            continue
        res = np.maximum(p_j - q[j], 0.0)
        s = float(res.sum())
        dist = res / s if s > 0.0 else p_j / float(p_j.sum())
        out.append(int(rng.choice(len(dist), p=dist / dist.sum())))
        return out
    pk = p[k] / float(p[k].sum())
    out.append(int(rng.choice(len(pk), p=pk)))
    return out


def greedy_accept(preds: np.ndarray, d: np.ndarray) -> list[list[int]]:
    """Verification by argmax, the temperature -> 0 limit of the rejection
    rule. preds [B, k+1]: the target's token after each chunk prefix
    [c, d_1..d_j]; d [B, k]: the drafts. Each slot commits its drafts up to
    the first one the target disagrees with, then the target's own token
    there, or the bonus token preds[:, k] when every draft matched: 1 to
    k+1 tokens."""
    match = preds[:, :-1] == d
    a = np.where(match.all(axis=1), d.shape[1], np.argmin(match, axis=1))
    return [[int(x) for x in d[i, :a[i]]] + [int(preds[i, a[i]])]
            for i in range(len(d))]


def host_rng_from(generator: torch.Generator) -> np.random.Generator:
    """A numpy generator for the host side of the rejection rule, seeded by
    one draw from `generator`, so a run is deterministic given the
    generator's seed (the JAX package folds a constant into its key)."""
    seed = torch.randint(0, 2**31 - 1, (1,), generator=generator,
                         device=generator.device)
    return np.random.default_rng(int(seed))


def speculative_generate(
    cfg, params, prompt, *, draft_cfg, draft_params, spec_k: int = 4,
    max_new_tokens: int = 32, max_len: int | None = None,
    temperature: float = 0.0, generator: torch.Generator | None = None,
):
    """Speculative decoding: prompt [B, T] -> [B, T + max_new_tokens] int32.

    Each round the draft decodes `spec_k` tokens from its own linear cache,
    then the target verifies [c, d_1..d_k] (c: the previous round's target
    token) in one `extend(all_logits=True)`. Each slot commits its longest
    accepted prefix and the target's own next token at the first mismatch,
    or a bonus token when every draft matched: 1 to spec_k + 1 target-grade
    tokens a round. Rollback is the lengths vector alone: K/V past a slot's
    accepted prefix is dead and later rounds overwrite it; the draft's
    lengths are reset to the target's. Requires equal vocabularies.

    temperature > 0 with a `generator` samples both models and verifies by
    rejection sampling (`speculative_accept`, on a host rng seeded from the
    generator), so the committed tokens are distributed as target-only
    sampling at that temperature."""
    if draft_cfg.vocab_size != cfg.vocab_size:
        raise ValueError("the draft and the target need the same vocabulary")
    sampling = temperature > 0.0 and generator is not None
    if sampling:
        host_rng = host_rng_from(generator)
    b, t = prompt.shape
    device = prompt.device
    max_len = max_len or (t + max_new_tokens + spec_k + 2)
    tcache = init_cache(cfg, b, max_len, device)
    dcache = init_cache(draft_cfg, b, max_len, device)
    tl, tcache = prefill(cfg, params, prompt, tcache)
    _, dcache = prefill(draft_cfg, draft_params, prompt, dcache)
    ddec = fuse_decode_params(draft_cfg, draft_params)

    out = np.zeros((b, max_new_tokens + spec_k + 2), np.int32)
    counts = np.zeros(b, np.int64)
    c = _sample(tl, temperature, generator)  # [B]
    out[:, 0] = c.cpu().numpy()
    counts += 1

    while counts.min() < max_new_tokens:
        # the draft: feed c, then propose spec_k tokens, feeding each one
        # (the last too: when the target accepts them all, the draft's next
        # round starts past d_k)
        dl, dcache = decode_step(draft_cfg, ddec, c, dcache)
        drafts, q_dists = [], []
        for _ in range(spec_k):
            if sampling:
                q_dists.append(torch.softmax(dl / temperature, dim=-1))
            d_j = _sample(dl, temperature, generator)
            drafts.append(d_j)
            dl, dcache = decode_step(draft_cfg, ddec, d_j, dcache)
        d = torch.stack(drafts, dim=1)  # [B, k]

        # the target: one chunked extend over [c, d_1..d_k]
        chunk = torch.cat([c[:, None], d], dim=1)  # [B, k+1]
        all_l, tcache = extend(cfg, params, chunk, tcache, all_logits=True)
        d_np = d.cpu().numpy()
        if sampling:
            # p[:, j]: the target's distribution after chunk[:, :j+1]
            p = torch.softmax(all_l / temperature, dim=-1).double().cpu().numpy()
            q = torch.stack(q_dists, dim=1).double().cpu().numpy()
            takes = [speculative_accept(p[i], q[i], d_np[i], host_rng)
                     for i in range(b)]
        else:
            preds = all_l.argmax(dim=-1).to(torch.int32).cpu().numpy()
            takes = greedy_accept(preds, d_np)
        a = np.array([len(tk) - 1 for tk in takes], np.int64)  # accepted drafts

        # commit d[:a] and the target's token; roll both caches back to the
        # accepted prefix (+1 for c, which the extend wrote)
        new_len = tcache.lengths.cpu().numpy() - (spec_k + 1) + 1 + a
        c_next = np.empty(b, np.int32)
        for i in range(b):
            n0 = int(counts[i])
            # a slot whose output is full rides along for the laggards
            take = takes[i][:max(out.shape[1] - n0, 0)]
            out[i, n0:n0 + len(take)] = take
            counts[i] += len(take)
            c_next[i] = take[-1] if take else out[i, n0 - 1]
        # cap a finished slot's length, or its extend would run past max_len
        new_len = np.minimum(new_len, t + max_new_tokens + 1).astype(np.int32)
        lengths = torch.from_numpy(new_len).to(device)
        tcache.lengths.copy_(lengths)
        dcache.lengths.copy_(lengths)  # the draft holds [.., c, d_1..d_k]
        c = torch.from_numpy(c_next).to(device)

    return torch.cat([prompt.to(torch.int32),
                      torch.from_numpy(out[:, :max_new_tokens]).to(device)],
                     dim=1)
