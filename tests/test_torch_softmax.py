"""The port's row softmax and online-softmax state machine against the JAX
package's, on the CPU (the JAX kernel in interpret mode, the port's
wrapper on its plain version): the shapes of tests/test_softmax.py, a bf16
input, the online reference, and tile_state, merge and finalize, whose
merge is associative and commutative."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattention_kernel_project_tpu import ops as jops
from flashattention_kernel_project_tpu_torch import ops
from flashattention_kernel_project_tpu_torch.utils import oracles
from flashattention_kernel_project_tpu_torch.utils.testing import (
    assert_max_abs,
    assert_rel_l2,
)

torch.set_num_threads(1)

TOL = 1e-5  # f32 on both sides (tests/test_softmax.py:23)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


@pytest.mark.parametrize("shape", [(64, 128), (4096, 512), (7, 33), (4, 8, 256)])
def test_softmax_matches_jax(rng, shape):
    x = rng.standard_normal(shape, dtype=np.float32) * 4.0
    got = ops.softmax.softmax(_t(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    assert_max_abs(got.numpy(), np.asarray(jops.softmax(jnp.asarray(x))), tol=TOL)
    assert_max_abs(got.numpy(), oracles.softmax(x), tol=TOL)


def test_softmax_bf16_matches_jax(rng):
    """A bf16 input: f32 arithmetic, out in bf16, on both sides."""
    x = rng.standard_normal((96, 300), dtype=np.float32) * 4.0
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    got = ops.softmax.softmax(_t(x).bfloat16())
    assert got.dtype == torch.bfloat16
    want = np.asarray(jops.softmax(xj).astype(jnp.float32))
    assert_rel_l2(got.float().numpy(), want, tol=1e-2)
    assert_rel_l2(got.float().numpy(),
                  oracles.softmax(np.asarray(xj.astype(jnp.float32))), tol=1e-2)


def test_online_softmax_reference_matches_jax(rng):
    x = rng.standard_normal((16, 1000), dtype=np.float32) * 5.0
    got = ops.online_softmax_reference(_t(x), block_cols=256)
    want = jops.online_softmax_reference(jnp.asarray(x), block_cols=256)
    assert_max_abs(got.numpy(), np.asarray(want), tol=TOL)
    assert_max_abs(got.numpy(), oracles.softmax(x), tol=TOL)


def _scores_values(rng, rows=8, cols=64, dv=32):
    return (rng.standard_normal((rows, cols), dtype=np.float32) * 3.0,
            rng.standard_normal((cols, dv), dtype=np.float32))


def _states(rng, n=3):
    """n tile states of the port and of JAX from the same numpy inputs."""
    out = []
    for _ in range(n):
        s, v = _scores_values(rng)
        out.append((ops.tile_state(_t(s), _t(v)),
                    jops.tile_state(jnp.asarray(s), jnp.asarray(v))))
    return out


def test_tile_state_and_merge_match_jax(rng):
    (ta, ja), (tb, jb), (tc, jc) = _states(rng)
    for t, j in ((ta, ja), (tb, jb)):
        for x, y in zip(t, j):
            assert_max_abs(x.numpy(), np.asarray(y), tol=TOL)
    tm = ops.merge(ops.merge(ta, tb), tc)
    jm = jops.merge(jops.merge(ja, jb), jc)
    for x, y in zip(tm, jm):
        assert_rel_l2(x.numpy(), np.asarray(y), tol=TOL)
    assert_rel_l2(ops.finalize(tm).numpy(), np.asarray(jops.finalize(jm)), tol=TOL)
    assert_rel_l2(ops.finalize(tm, eps=1.0).numpy(),
                  np.asarray(jops.finalize(jm, eps=1.0)), tol=TOL)


def test_merge_associative_and_commutative(rng):
    (sa, _), (sb, _), (sc, _) = _states(rng)
    left = ops.merge(ops.merge(sa, sb), sc)
    right = ops.merge(sa, ops.merge(sb, sc))
    for x, y in zip(left, right):
        assert_max_abs(x.numpy(), y.numpy(), tol=1e-4)
    for x, y in zip(ops.merge(sa, sb), ops.merge(sb, sa)):
        assert_max_abs(x.numpy(), y.numpy(), tol=1e-4)


def test_merge_over_a_split_key_axis_equals_dense_softmax(rng):
    """init_state, then tiles of an arbitrary split of the key axis merged
    and finalized: one-shot softmax @ V, as JAX's the same way."""
    rows, cols, dv = 8, 96, 16
    scores = rng.standard_normal((rows, cols), dtype=np.float32) * 3.0
    values = rng.standard_normal((cols, dv), dtype=np.float32)
    splits = [0, 17, 40, 96]
    state, jstate = ops.init_state((rows,), dv), jops.init_state((rows,), dv)
    for lo, hi in zip(splits[:-1], splits[1:]):
        state = ops.merge(state, ops.tile_state(_t(scores[:, lo:hi]), _t(values[lo:hi])))
        jstate = jops.merge(jstate, jops.tile_state(jnp.asarray(scores[:, lo:hi]),
                                                    jnp.asarray(values[lo:hi])))
    got = ops.finalize(state).numpy()
    assert_max_abs(got, oracles.softmax(scores) @ values, tol=1e-4)
    assert_max_abs(got, np.asarray(jops.finalize(jstate)), tol=TOL)


def test_init_state_matches_jax():
    t, j = ops.init_state((2, 3), 4), jops.init_state((2, 3), 4)
    for x, y in zip(t, j):
        assert x.dtype == torch.float32 and tuple(x.shape) == y.shape
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_merge_matches_numpy_oracle(rng):
    (sa, _), (sb, _) = _states(rng, 2)
    got = ops.merge(sa, sb)
    want = oracles.online_softmax_merge(tuple(x.numpy() for x in sa),
                                        tuple(x.numpy() for x in sb))
    for g, e in zip(got, want):
        assert_max_abs(g.numpy(), e, tol=TOL)
