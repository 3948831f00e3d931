"""Numpy oracles with float64 accumulation.

Counterpart of flashattention_kernel_project_tpu/utils/oracles.py: the
reference pairs every kernel with a naive CPU implementation, accumulated in
float64 so that the oracle's error stays apart from the kernel's. The GEMM
ladder's products and fused epilogue, the row softmax, attention and its
grouped-query form, the streaming softmax merge, and the gradients of
grouped-query attention (the oracle tests/test_flash_attention.py builds
inline for the backward, with q_offset).
"""

from __future__ import annotations

import numpy as np


def gemm(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """C = A @ B with fp64 accumulation. Accepts leading batch dims."""
    return (a.astype(np.float64) @ b.astype(np.float64)).astype(np.float32)


def gemm_fused_epilogue(
    a: np.ndarray, b: np.ndarray, bias: np.ndarray, residual: np.ndarray
) -> np.ndarray:
    """C = ReLU(A@B + bias[col]) + residual."""
    c = a.astype(np.float64) @ b.astype(np.float64)
    c = np.maximum(c + bias.astype(np.float64), 0.0) + residual.astype(np.float64)
    return c.astype(np.float32)


def softmax(x: np.ndarray, axis: int = -1) -> np.ndarray:
    x64 = x.astype(np.float64)
    m = np.max(x64, axis=axis, keepdims=True)
    e = np.exp(x64 - m)
    return (e / np.sum(e, axis=axis, keepdims=True)).astype(np.float32)


def attention(
    q: np.ndarray,
    k: np.ndarray,
    v: np.ndarray,
    *,
    scale: float | None = None,
    causal: bool = False,
    q_offset: int = 0,
    window: int | None = None,
    sinks: int = 0,
) -> np.ndarray:
    """Naive attention, [..., N, D] x [..., S, D] -> [..., N, Dv] float32.

    With `causal`, query i sees key j iff j <= i + q_offset; `window` (with
    causal) keeps only its `window` most recent keys, itself included, and
    `sinks` the first `sinks` keys besides. Fully masked rows give zeros.
    """
    q64 = q.astype(np.float64)
    k64 = k.astype(np.float64)
    v64 = v.astype(np.float64)
    if scale is None:
        scale = 1.0 / np.sqrt(q.shape[-1])
    # batched @ goes to BLAS; einsum's loop is several times slower
    scores = (q64 @ k64.swapaxes(-1, -2)) * scale
    if causal:
        n, s = scores.shape[-2], scores.shape[-1]
        row = np.arange(n)[:, None] + q_offset
        mask = np.arange(s)[None, :] > row
        if window is not None:
            out_of_band = np.arange(s)[None, :] <= row - window
            if sinks:
                out_of_band &= np.arange(s)[None, :] >= sinks
            mask |= out_of_band
        scores = np.where(mask, -np.inf, scores)
    m = np.max(scores, axis=-1, keepdims=True)
    m = np.where(np.isfinite(m), m, 0.0)  # fully masked rows
    e = np.exp(scores - m)
    p = e / np.maximum(np.sum(e, axis=-1, keepdims=True), 1e-30)
    return (p @ v64).astype(np.float32)


def gqa_attention(
    q: np.ndarray,
    k: np.ndarray,
    v: np.ndarray,
    *,
    scale: float | None = None,
    causal: bool = False,
    q_offset: int = 0,
    window: int | None = None,
    sinks: int = 0,
) -> np.ndarray:
    """q [B, Hq, N, D], k/v [B, Hkv, S, D] -> [B, Hq, N, Dv] float32.
    Query head h reads KV head h // (Hq // Hkv); the masks are
    `attention`'s."""
    hq, hkv = q.shape[1], k.shape[1]
    assert hq % hkv == 0
    group = hq // hkv
    return attention(
        q, np.repeat(k, group, axis=1), np.repeat(v, group, axis=1),
        scale=scale, causal=causal, q_offset=q_offset, window=window,
        sinks=sinks,
    )


def online_softmax_merge(state_a, state_b):
    """Associative merge of unnormalized streaming softmax partials
    (m, l, y): m = max(ma, mb), a = exp(ma - m), b = exp(mb - m),
    l = la*a + lb*b, y = ya*a + yb*b; O = y / l at the very end. The
    combiner of split-KV decode and ring attention."""
    ma, la, ya = state_a
    mb, lb, yb = state_b
    m = np.maximum(ma, mb)
    a = np.exp(ma - m)
    b = np.exp(mb - m)
    return m, la * a + lb * b, ya * a[..., None] + yb * b[..., None]


def gqa_attention_grads(
    q: np.ndarray,
    k: np.ndarray,
    v: np.ndarray,
    do: np.ndarray,
    *,
    scale: float | None = None,
    causal: bool = False,
    q_offset: int = 0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(dq, dk, dv) in float64 of gqa_attention's output against the output
    gradient `do`; dk and dv summed over each KV head's group. A row that
    sees no key gives zero dq."""
    hq, hkv = q.shape[1], k.shape[1]
    group = hq // hkv
    q64, do64 = q.astype(np.float64), do.astype(np.float64)
    k64 = np.repeat(k, group, axis=1).astype(np.float64)
    v64 = np.repeat(v, group, axis=1).astype(np.float64)
    if scale is None:
        scale = 1.0 / np.sqrt(q.shape[-1])
    scores = (q64 @ k64.swapaxes(-1, -2)) * scale
    n, s = scores.shape[-2], scores.shape[-1]
    mask = np.ones((n, s), bool)
    if causal:
        mask = np.arange(s)[None, :] <= np.arange(n)[:, None] + q_offset
    scores = np.where(mask, scores, -np.inf)
    m = np.max(scores, axis=-1, keepdims=True)
    p = np.where(mask, np.exp(scores - np.where(np.isfinite(m), m, 0.0)), 0.0)
    p /= np.maximum(np.sum(p, axis=-1, keepdims=True), 1e-300)
    dv = p.swapaxes(-1, -2) @ do64
    dp = do64 @ v64.swapaxes(-1, -2)
    ds = p * (dp - np.sum(p * dp, axis=-1, keepdims=True)) * scale
    dq = ds @ k64
    dk = ds.swapaxes(-1, -2) @ q64
    b, _, _, d = k.shape
    return (dq, dk.reshape(b, hkv, group, s, d).sum(axis=2),
            dv.reshape(b, hkv, group, s, v.shape[-1]).sum(axis=2))
