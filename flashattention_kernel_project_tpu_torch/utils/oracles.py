"""Numpy attention oracle with float64 accumulation.

Counterpart of flashattention_kernel_project_tpu/utils/oracles.py, cut to
the grouped-query attention oracles the port's checks use: the forward, and
its gradients (the oracle tests/test_flash_attention.py builds inline for
the backward, with q_offset).
"""

from __future__ import annotations

import numpy as np


def gqa_attention(
    q: np.ndarray,
    k: np.ndarray,
    v: np.ndarray,
    *,
    scale: float | None = None,
    causal: bool = False,
    q_offset: int = 0,
) -> np.ndarray:
    """q [B, Hq, N, D], k/v [B, Hkv, S, D] -> [B, Hq, N, Dv] float32.
    Query head h reads KV head h // (Hq // Hkv); with `causal`, query i
    sees key j iff j <= i + q_offset. Fully masked rows give zeros."""
    hq, hkv = q.shape[1], k.shape[1]
    assert hq % hkv == 0
    group = hq // hkv
    q64 = q.astype(np.float64)
    k64 = np.repeat(k, group, axis=1).astype(np.float64)
    v64 = np.repeat(v, group, axis=1).astype(np.float64)
    if scale is None:
        scale = 1.0 / np.sqrt(q.shape[-1])
    scores = (q64 @ k64.swapaxes(-1, -2)) * scale
    if causal:
        n, s = scores.shape[-2], scores.shape[-1]
        mask = np.arange(s)[None, :] > np.arange(n)[:, None] + q_offset
        scores = np.where(mask, -np.inf, scores)
    m = np.max(scores, axis=-1, keepdims=True)
    m = np.where(np.isfinite(m), m, 0.0)
    e = np.exp(scores - m)
    p = e / np.maximum(np.sum(e, axis=-1, keepdims=True), 1e-30)
    return (p @ v64).astype(np.float32)


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
