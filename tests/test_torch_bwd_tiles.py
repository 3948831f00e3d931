"""The port's attention backward (kernels 4 and 5) against the JAX package's
at the edges of the Hopper kernels' tiles (kernel A: 128-key blocks and
64-row query tiles; kernel B: 128-row blocks and 64-key tiles): n and s off
64 and 128, a q_offset with n < s, rows before the first key, a window of
24 with 20 sinks (wider than the JAX blocks' 16 rows), d 64 and 128, GQA
groups of 1 and 4, in both dq schedules (fuse_dq True and False). In
float32 on the CPU: the port's `_bwd` runs its plain version (one function
for both schedules), the JAX `_bwd_pallas` runs in interpret mode with
16-row blocks and the same fuse_dq, both on the JAX forward's (o, lse).
The CUDA kernels hold the same kinds of shapes against the plain version
on the card (chip_smoke.py::phase_bwd_tiles)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattention_kernel_project_tpu_torch.ops import flash_attention as tfa
from flashattention_kernel_project_tpu_torch.utils.testing import assert_rel_l2

jfa = importlib.import_module("flashattention_kernel_project_tpu.ops.flash_attention")

torch.set_num_threads(1)

TOL = 1e-3  # float32 on both sides, through the log2(e) fold and exp2
BLK = 16    # the JAX kernels' blocks

# b, hq, hkv, n, s, d, causal, q_offset, window, sinks
SHAPES = {
    "ragged_full": (1, 4, 1, 72, 136, 64, False, 0, None, 0),
    "ragged_full_d128": (1, 2, 2, 72, 136, 128, False, 0, None, 0),
    "offset_n_lt_s": (1, 4, 1, 40, 136, 64, True, 96, None, 0),
    "offset_n_lt_s_d128": (1, 2, 2, 40, 136, 128, True, 96, None, 0),
    "before_first_key": (1, 4, 1, 72, 72, 64, True, -20, None, 0),
    "before_first_key_d128": (1, 2, 2, 72, 72, 128, True, -20, None, 0),
    "wide_sinks": (1, 4, 1, 136, 136, 64, True, 0, 24, 20),
    "wide_sinks_d128": (1, 2, 2, 136, 136, 128, True, 0, 24, 20),
}


def _inputs(seed, b, hq, hkv, n, s, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32) for shape in
                 ((b, hq, n, d), (b, hkv, s, d), (b, hkv, s, d), (b, hq, n, d)))


@pytest.mark.parametrize("fuse_dq", [True, False])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_bwd_at_tile_edges_matches_jax(shape, fuse_dq):
    """dq, dk, dv from the port's `_bwd(fuse_dq=...)` against
    `_bwd_pallas(fuse_dq=...)` at TOL. Rows before the first key: the JAX
    backward turns them into NaN (exp(s - lse) with lse = NEG_INF), so JAX
    runs on the rows that see a key alone (they carry every contribution to
    dk and dv), and the port must give the others dq = 0 exactly."""
    b, hq, hkv, n, s, d, causal, q_offset, window, sinks = SHAPES[shape]
    q, k, v, do = _inputs(sum(map(ord, shape)), b, hq, hkv, n, s, d)
    qj, kj, vj, doj = map(jnp.asarray, (q, k, v, do))
    scale = d ** -0.5
    o, lse = jfa._fwd(qj, kj, vj, causal, scale, q_offset, BLK, BLK, True,
                      window=window, sinks=sinks)
    skip = max(-q_offset, 0)  # the rows that see no key
    res = (qj[:, :, skip:], kj, vj, o[:, :, skip:], lse[:, :, skip:])
    exp = jfa._bwd_pallas(res, doj[:, :, skip:], causal, scale, q_offset + skip,
                          BLK, BLK, True, window=window, sinks=sinks,
                          fuse_dq=fuse_dq)
    got = tfa._bwd(*(torch.from_numpy(np.asarray(x)) for x in (q, k, v, o, lse, do)),
                   causal, scale, q_offset, window or 0, sinks, fuse_dq=fuse_dq)
    for name, g, e in zip(("dq", "dk", "dv"), got, exp):
        g = g.numpy()
        assert g.dtype == np.float32 and np.isfinite(g).all(), name
        if name == "dq":
            assert not g[:, :, :skip].any()
            g = g[:, :, skip:]
        assert g.shape == e.shape, name
        assert_rel_l2(g, np.asarray(e), tol=TOL, msg=name)


def test_window_sinks_autograd_at_tile_edges_matches_jax_grad():
    """torch.autograd.grad through the port's flash_attention with a window
    of 24 and 20 sinks at 136 tokens, d 128 and a GQA group of 4, against
    jax.grad through the JAX one, on the loss sum(o * cos(o))."""
    q, k, v, _ = _inputs(7, 1, 4, 1, 136, 136, 128)
    kw = dict(causal=True, window=24, sinks=20)

    def jloss(q, k, v):
        o = jfa.flash_attention(q, k, v, block_q=BLK, block_k=BLK, interpret=True,
                                **kw)
        return jnp.sum(o * jnp.cos(o))

    exp = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    o = tfa.flash_attention(*ts, **kw)
    got = torch.autograd.grad((o * torch.cos(o)).sum(), ts)
    for g, e in zip(got, exp):
        assert_rel_l2(g.numpy(), np.asarray(e), tol=TOL)


def test_bwd_rejects_a_fuse_dq_that_is_not_a_bool():
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(8, 1, 2, 1, 8, 8, 64))
    o, lse = tfa._fwd(q, k, v, True, None, 0)
    with pytest.raises(ValueError):
        tfa._bwd(q, k, v, o, lse, do, True, None, 0, fuse_dq="yes")


def test_bwd_rows_pad_lse_and_delta_to_the_ring_rows():
    """`_bwd_rows`: lse * log2(e) and rowsum(o * do), zero-padded to a
    multiple of the kernels' 64-row stage."""
    o, do = (torch.from_numpy(x) for x in _inputs(9, 2, 3, 1, 70, 70, 64)[::3])
    lse = torch.randn(2, 3, 70)
    lse2, delta = tfa._bwd_rows(lse, o, do)
    assert lse2.shape == delta.shape == (2, 3, 128)
    torch.testing.assert_close(lse2[..., :70], lse * tfa._LOG2E)
    torch.testing.assert_close(delta[..., :70], (o * do).sum(-1))
    assert not lse2[..., 70:].any() and not delta[..., 70:].any()
