"""The port's dense forward (kernels 1 and 2) against the JAX package's at
the edges of the tiles: n and s off the tile size, a q_offset with n < s,
rows before the first key, sinks wider than a tile under a window, d 64
and 128 (d 64 through JAX's packed kernel where it packs), in the three
disciplines. In float32 on the CPU: the port's wrappers run their plain
versions, the JAX kernels run in interpret mode with 16-row blocks. The
CUDA kernel holds the same shapes against the plain version on the card
(chip_smoke.py::phase_fwd_tiles, at the 128-row tiles' edges)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattention_kernel_project_tpu_torch.ops import flash_attention as tfa
from flashattention_kernel_project_tpu_torch.utils.oracles import gqa_attention
from flashattention_kernel_project_tpu_torch.utils.testing import assert_rel_l2

jfa = importlib.import_module("flashattention_kernel_project_tpu.ops.flash_attention")

torch.set_num_threads(1)

TOL = 1e-4        # float32 on both sides (tests/test_torch_stable.py)
SAME_TOL = 1e-6   # "auto" against stable=True where every block runs online
BLK = 16          # the JAX kernels' blocks

# b, hq, hkv, n, s, d, causal, q_offset, window, sinks
SHAPES = {
    "ragged_full": (1, 2, 2, 40, 72, 64, False, 0, None, 0),
    "ragged_full_d128": (1, 2, 1, 40, 72, 128, False, 0, None, 0),
    "offset_n_lt_s": (1, 4, 2, 24, 72, 64, True, 48, None, 0),
    "offset_n_lt_s_d128": (1, 2, 1, 24, 72, 128, True, 48, None, 0),
    "before_first_key": (1, 2, 2, 40, 40, 128, True, -8, None, 0),
    "wide_sinks": (1, 2, 2, 80, 80, 64, True, 0, 24, 20),
    "wide_sinks_d128": (1, 2, 1, 80, 80, 128, True, 0, 24, 20),
}
# stable as the wrappers take it; "breach": "auto" on q x 60, where every
# block's bound breaches and the hybrid runs online throughout
DISCIPLINES = {"stable": True, "fixed": False, "auto": "auto", "breach": "auto"}


def _inputs(seed, b, hq, hkv, n, s, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32) for shape in
                 ((b, hq, n, d), (b, hkv, s, d), (b, hkv, s, d)))


@pytest.mark.parametrize("disc", sorted(DISCIPLINES))
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_forward_at_tile_edges_matches_jax(shape, disc):
    """O and LSE from flash_attention_with_lse against JAX's (its packed
    d=64 kernel for stable=False where the KV-head count is even, as both
    packages default) at TOL; the rows that see a key against the float64
    oracle without a window; on the breach inputs "auto" equals stable=True
    within SAME_TOL."""
    b, hq, hkv, n, s, d, causal, q_offset, window, sinks = SHAPES[shape]
    q, k, v = _inputs(sum(map(ord, shape)), b, hq, hkv, n, s, d)
    if disc == "breach":
        q = q * 60.0
    kw = dict(causal=causal, q_offset=q_offset, window=window, sinks=sinks,
              stable=DISCIPLINES[disc])
    jo, jl = jfa.flash_attention_with_lse(
        *map(jnp.asarray, (q, k, v)), block_q=BLK, block_k=BLK, interpret=True,
        **kw)
    jo, jl = np.asarray(jo), np.asarray(jl)
    to, tl = (x.numpy() for x in tfa.flash_attention_with_lse(
        *map(torch.from_numpy, (q, k, v)), **kw))
    assert np.isfinite(to).all() and np.isfinite(tl).all()
    assert_rel_l2(to, jo, tol=TOL)
    live = jl > -1e29
    np.testing.assert_allclose(tl[live], jl[live], rtol=TOL, atol=TOL)
    assert (tl[~live] < -1e29).all()
    if q_offset < 0:  # rows before the first key: O = 0, LSE = NEG_INF
        assert not to[:, :, :-q_offset].any()
    if window is None:
        assert_rel_l2(to, gqa_attention(q, k, v, causal=causal, q_offset=q_offset),
                      tol=TOL)
    if disc == "breach":
        pinned = tfa._fixed_rows(torch.from_numpy(q), d ** -0.5, tfa.HYBRID,
                                 tfa.k_max_norm(torch.from_numpy(k)))
        assert not pinned.any()  # every block breaches
        so, sl = (x.numpy() for x in tfa.flash_attention_with_lse(
            *map(torch.from_numpy, (q, k, v)), **dict(kw, stable=True)))
        assert_rel_l2(to, so, tol=SAME_TOL)
        np.testing.assert_allclose(tl, sl, rtol=SAME_TOL, atol=SAME_TOL)
