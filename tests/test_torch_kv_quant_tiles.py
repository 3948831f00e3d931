"""The port's dense 8-bit forward (`flash_attention_kv_quant` and
`_with_lse`, csrc/flash_fwd_q.cu: flash_fwd_sm90.cuh's block body in 64-
and 128-row blocks over 64-key tiles) at the edges of its row blocks and
tiles, against the JAX package's (its Pallas kernel in interpret mode) on
the same 8-bit values and scales, in float32 on the CPU, where the port's
wrapper runs its plain version: N and S under, on and past 64 and 128, a
q_offset, non-causal, a window wider than a tile with sinks, in the three
disciplines; and the fixed-max range guard's count against JAX's
`_fwd(..., guard=True)` with k_scale, exactly, on bounded and on crafted
rows (tests/test_torch_guard.py's form)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattention_kernel_project_tpu_torch.models.convert import params_from_jax
from flashattention_kernel_project_tpu_torch.ops import flash_attention as tfa
from flashattention_kernel_project_tpu_torch.utils.testing import assert_rel_l2

jq = importlib.import_module("flashattention_kernel_project_tpu.ops.quant")
jfa = importlib.import_module("flashattention_kernel_project_tpu.ops.flash_attention")

torch.set_num_threads(1)

CPU = torch.device("cpu")
TOL = 1e-4  # float32 on both sides, the same 8-bit values and scales
BLK = 64    # the JAX kernel's blocks (interpret mode: fewer grid steps)
J_QUANT = {"int8": jq.quantize_int8, "fp8": jq.quantize_fp8_tokenwise}
# (n, s, causal, q_offset, window, sinks): N and S under, on and past the
# 64- and 128-row blocks and the 64-key tiles
EDGES = [
    (63, 63, True, 0, None, 0),
    (65, 130, True, 65, None, 0),
    (129, 129, True, 0, None, 0),
    (127, 200, False, 0, None, 0),
    (129, 200, True, 71, 70, 66),  # a window and sinks wider than a tile
]


def _inputs(seed, fmt, n, s, d=64, b=1, hq=2, hkv=1):
    """q (float32 numpy) and an 8-bit cache quantized by the JAX package:
    (k_q, k_scale, v_q, v_scale) as numpy arrays."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, n, d)).astype(np.float32)
    cache = []
    for _ in range(2):
        x = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
        cache.extend(np.asarray(a) for a in J_QUANT[fmt](jnp.asarray(x), axis=-1))
    return q, cache


def _port_cache(cache):
    return [params_from_jax(x, CPU) for x in cache]


@pytest.mark.parametrize("stable", [True, False, "auto"])
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("case", EDGES)
def test_kv_quant_at_block_edges_matches_jax(case, fmt, stable):
    """O and LSE of `flash_attention_kv_quant_with_lse` against JAX's, and
    `flash_attention_kv_quant`'s O equal to them."""
    n, s, causal, q_offset, window, sinks = case
    q, cache = _inputs(n + s, fmt, n, s)
    kw = dict(causal=causal, stable=stable, q_offset=q_offset, window=window,
              sinks=sinks)
    jo, jl = jfa.flash_attention_kv_quant_with_lse(
        jnp.asarray(q), *map(jnp.asarray, cache), block_q=BLK, block_k=BLK,
        interpret=True, **kw)
    tcache = _port_cache(cache)
    to, tl = tfa.flash_attention_kv_quant_with_lse(torch.from_numpy(q), *tcache,
                                                   **kw)
    assert_rel_l2(to.numpy(), np.asarray(jo), tol=TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    o = tfa.flash_attention_kv_quant(torch.from_numpy(q), *tcache, **kw)
    assert torch.equal(o, to)


def _guard_counts(q, cache, causal, window, sinks):
    """(JAX's count, the port's) of the fixed-max guard over the 8-bit
    cache."""
    kq, ks, vq, vs = cache
    _, _, bad = jfa._fwd(jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq),
                         causal, None, 0, BLK, BLK, None, stable=False,
                         guard=True, k_scale=jnp.asarray(ks),
                         v_scale=jnp.asarray(vs), window=window, sinks=sinks)
    tkq, tks, tvq, tvs = _port_cache(cache)
    _, _, tbad = tfa._fwd_q_plain(torch.from_numpy(q), tkq, tks, tvq, tvs,
                                  causal, q.shape[-1] ** -0.5, 0, window or 0,
                                  sinks, disc=tfa.FIXED, guard=True)
    assert tbad.dim() == 0 and tbad.dtype == torch.int32
    return int(np.asarray(bad)), int(tbad)


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("n,window,sinks", [(129, None, 0), (130, 70, 4)])
def test_guard_counts_at_block_edges_as_jax(n, window, sinks, fmt):
    """Bounded rows count 0 in both; rows past the range (a crafted row of
    90s against |k|, and rows on either side of the 64- and 128-row block
    edges) count the same, exactly."""
    q, cache = _inputs(7, fmt, n, n)
    assert _guard_counts(q, cache, True, window, sinks) == (0, 0)
    rng = np.random.default_rng(8)
    k = np.abs(rng.standard_normal((1, 1, n, 64))).astype(np.float32)
    cache[:2] = (np.asarray(a) for a in J_QUANT[fmt](jnp.asarray(k), axis=-1))
    for row in (20, 63, 64, 127, 128):
        q[0, row % 2, row, :] = 90.0
    jax_count, port_count = _guard_counts(q, cache, True, window, sinks)
    assert jax_count == port_count > 0
