"""GQA decoder-only transformer: RMSNorm, RoPE, grouped-query attention
through ops.flash_attention, SwiGLU MLP, tied embeddings.

Counterpart of flashattention_kernel_project_tpu/models/transformer.py,
dense path: the forward, the next-token loss and a plain SGD step.
Parameters are a dict of tensors in the JAX package's layout, so a JAX
parameter tree converts by copying (models/convert.py):

    embed [vocab, d_model], rms_final [d_model] float32,
    layers: wq [L, d_model, q_dim], wk/wv [L, d_model, kv_dim],
            wo [L, q_dim, d_model], w_gate/w_up [L, d_model, d_ff],
            w_down [L, d_ff, d_model], rms_attn/rms_mlp [L, d_model] float32

Weights are stored [in, out] and applied as x @ w.
"""

from __future__ import annotations

import dataclasses

import torch

from flashattention_kernel_project_tpu_torch.ops.flash_attention import (
    flash_attention,
)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The JAX config's fields, less the TPU tiling knobs (block_q,
    block_k); the kernels pick their own tiles. moe_experts > 0 is not
    ported yet."""

    vocab_size: int = 32000
    d_model: int = 1024
    n_layers: int = 8
    n_heads: int = 16
    n_kv_heads: int = 4
    d_head: int = 64
    d_ff: int = 2816
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.bfloat16
    attn_stable: bool = True
    attn_window: int | None = None
    attn_sinks: int = 0
    moe_experts: int = 0

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.d_head

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.d_head


def _dense_only(cfg: TransformerConfig):
    if cfg.moe_experts:
        raise NotImplementedError("MoE layers are ROADMAP item A.10")


def init_params(
    cfg: TransformerConfig, generator: torch.Generator, device
) -> dict:
    """Scaled-normal init (std = fan_in**-0.5, embed 0.02), weights in
    cfg.dtype, drawn from `generator` (which must live on `device`).
    torch's draws differ from jax.random's: tests that compare with the JAX
    package convert its parameters instead."""
    _dense_only(cfg)
    L = cfg.n_layers

    def dense(shape, scale=None):
        scale = scale or shape[-2] ** -0.5
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return (w * scale).to(cfg.dtype)

    def ones(shape):
        return torch.ones(shape, dtype=torch.float32, device=device)

    d, f = cfg.d_model, cfg.d_ff
    layers = dict(
        wq=dense((L, d, cfg.q_dim)),
        wk=dense((L, d, cfg.kv_dim)),
        wv=dense((L, d, cfg.kv_dim)),
        wo=dense((L, cfg.q_dim, d)),
        rms_attn=ones((L, d)),
        rms_mlp=ones((L, d)),
        w_gate=dense((L, d, f)),
        w_up=dense((L, d, f)),
        w_down=dense((L, f, d)),
    )
    return dict(
        embed=dense((cfg.vocab_size, d), scale=0.02),
        rms_final=ones((d,)),
        layers=layers,
    )


def layer_params(params: dict, i: int) -> dict:
    """Layer i's weights (views, no copy)."""
    return {name: w[i] for name, w in params["layers"].items()}


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * w).to(x.dtype)


def rope_tables(cfg: TransformerConfig, positions: torch.Tensor):
    """positions [..., N] -> (sin, cos) [..., N, d_head/2] float32."""
    half = cfg.d_head // 2
    exps = -torch.arange(half, dtype=torch.float32, device=positions.device) / half
    freqs = torch.pow(torch.tensor(cfg.rope_theta, dtype=torch.float32,
                                   device=positions.device), exps)
    angles = positions[..., None].float() * freqs
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor):
    """x [..., N, H, d_head]; sin/cos broadcastable to [..., N, d_head/2]."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    sin = sin[..., None, :]
    cos = cos[..., None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _attention_block(cfg, layer, x, sin, cos):
    b, n, _ = x.shape
    h = rms_norm(x, layer["rms_attn"])
    q = (h @ layer["wq"]).view(b, n, cfg.n_heads, cfg.d_head)
    k = (h @ layer["wk"]).view(b, n, cfg.n_kv_heads, cfg.d_head)
    v = (h @ layer["wv"]).view(b, n, cfg.n_kv_heads, cfg.d_head)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    o = flash_attention(
        q.transpose(1, 2).contiguous(),
        k.transpose(1, 2).contiguous(),
        v.transpose(1, 2).contiguous(),
        causal=True,
        stable=cfg.attn_stable,
        window=cfg.attn_window,
        sinks=cfg.attn_sinks,
    )
    o = o.transpose(1, 2).reshape(b, n, cfg.q_dim)
    return x + o @ layer["wo"]


def _mlp_block(layer, x):
    h = rms_norm(x, layer["rms_mlp"])
    gated = torch.nn.functional.silu(h @ layer["w_gate"]) * (h @ layer["w_up"])
    return x + gated @ layer["w_down"]


def logits_f32(x: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """x @ embed.T with float32 products, sums and output, as the JAX
    package's preferred_element_type=float32: bf16-rounded logits flip
    near-tie argmaxes between the decode and forward paths."""
    return x.float() @ embed.float().t()


def forward(cfg: TransformerConfig, params: dict, tokens: torch.Tensor):
    """tokens [B, N] int -> logits [B, N, vocab] float32 (causal LM)."""
    _dense_only(cfg)
    n = tokens.shape[1]
    x = params["embed"][tokens]
    positions = torch.arange(n, device=tokens.device)[None, :]
    sin, cos = rope_tables(cfg, positions)
    for i in range(cfg.n_layers):
        layer = layer_params(params, i)
        x = _attention_block(cfg, layer, x, sin, cos)
        x = _mlp_block(layer, x)
    x = rms_norm(x, params["rms_final"])
    return logits_f32(x, params["embed"])


def loss_fn(cfg: TransformerConfig, params: dict, tokens: torch.Tensor):
    """Next-token cross-entropy, the mean over every position's
    log_softmax(logits) at the following token, in float32 (the lm_head's
    logits are float32)."""
    logits = forward(cfg, params, tokens)
    # the last position has no target: ignore_index keeps it out of the mean
    # without copying the [B, N-1, vocab] slice of the logits
    targets = torch.nn.functional.pad(tokens[:, 1:].long(), (0, 1), value=-100)
    return torch.nn.functional.cross_entropy(
        logits.flatten(0, 1), targets.flatten(), ignore_index=-100)


def _leaves(tree: dict, prefix: str = "") -> dict:
    """{"layers.wq": tensor, ...}: the parameter dict flattened."""
    out = {}
    for name, x in tree.items():
        if isinstance(x, dict):
            out.update(_leaves(x, f"{prefix}{name}."))
        else:
            out[prefix + name] = x
    return out


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, x in flat.items():
        *path, name = key.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[name] = x
    return tree


def sgd_train_step(cfg: TransformerConfig, params: dict, tokens: torch.Tensor,
                   lr: float = 1e-3):
    """One full training step (forward, backward, update) -> (new_params,
    loss). The update is p - lr * g in float32, cast back to p's dtype, as
    in the JAX package. Gradients reach the stacked per-layer leaves through
    layer_params' views; `params` itself is left unchanged."""
    flat = {k: x.detach().requires_grad_(True)
            for k, x in _leaves(params).items()}
    with torch.enable_grad():
        loss = loss_fn(cfg, _unflatten(flat), tokens)
        grads = torch.autograd.grad(loss, list(flat.values()))
    with torch.no_grad():
        new = {k: (x.float() - lr * g.float()).to(x.dtype)
               for (k, x), g in zip(flat.items(), grads)}
    return _unflatten(new), loss.detach()
