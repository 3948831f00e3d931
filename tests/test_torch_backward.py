"""The port's attention backward against the JAX package's, on the same
numpy inputs, in float32 on the CPU: `_bwd_plain` against `_bwd_pallas` in
interpret mode (both dq schedules) and against the float64 oracle, and
autograd through the port's `flash_attention` against jax.grad through the
JAX one."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattention_kernel_project_tpu_torch.ops import flash_attention as tfa
from flashattention_kernel_project_tpu_torch.utils.oracles import gqa_attention_grads
from flashattention_kernel_project_tpu_torch.utils.testing import assert_rel_l2

jfa = importlib.import_module("flashattention_kernel_project_tpu.ops.flash_attention")

torch.set_num_threads(1)

TOL = 1e-3        # float32 on both sides, through the log2(e) fold and exp2
ORACLE_TOL = 5e-4  # the JAX backward's own bound (tests/test_flash_attention.py:445)


def _inputs(seed, b, hq, hkv, n, s, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, n, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    do = rng.standard_normal((b, hq, n, d)).astype(np.float32)
    return q, k, v, do


def _plain(q, k, v, do, o, lse, causal, q_offset):
    t = [torch.from_numpy(np.array(x)) for x in (q, k, v, o, lse, do)]
    return tfa._bwd_plain(*t, causal, q.shape[-1] ** -0.5, q_offset)


CASES = [
    # b, hq, hkv, n, s, d, causal, q_offset
    (1, 4, 2, 48, 48, 16, True, 0),     # GQA 4/2, causal
    (2, 4, 2, 40, 72, 16, False, 0),    # non-causal, n != s, ragged tails
    (1, 4, 2, 24, 56, 64, True, 32),    # d=64, q block placed late in S
    (1, 2, 1, 37, 53, 16, True, 16),    # ragged, q_offset > 0, group 2
]


@pytest.mark.parametrize("fuse_dq", [True, False])
@pytest.mark.parametrize("b,hq,hkv,n,s,d,causal,q_offset", CASES)
def test_bwd_plain_matches_jax_pallas(b, hq, hkv, n, s, d, causal, q_offset,
                                      fuse_dq):
    q, k, v, do = _inputs(0, b, hq, hkv, n, s, d)
    qj, kj, vj, doj = map(jnp.asarray, (q, k, v, do))
    o, lse = jfa._fwd(qj, kj, vj, causal, None, q_offset, 16, 16, True)
    exp = jfa._bwd_pallas((qj, kj, vj, o, lse), doj, causal, d ** -0.5,
                          q_offset, 16, 16, True, fuse_dq=fuse_dq)
    got = _plain(q, k, v, do, o, lse, causal, q_offset)
    for name, g, e in zip(("dq", "dk", "dv"), got, exp):
        assert g.dtype == torch.float32 and g.shape == e.shape, name
        assert_rel_l2(g.numpy(), np.asarray(e), tol=TOL, msg=name)


@pytest.mark.parametrize("b,hq,hkv,n,s,d,causal,q_offset", CASES)
def test_bwd_plain_matches_float64_oracle(b, hq, hkv, n, s, d, causal, q_offset):
    q, k, v, do = _inputs(1, b, hq, hkv, n, s, d)
    o, lse = tfa._fwd_plain(*(torch.from_numpy(x) for x in (q, k, v)), causal,
                            d ** -0.5, q_offset)
    got = _plain(q, k, v, do, o, lse, causal, q_offset)
    exp = gqa_attention_grads(q, k, v, do, causal=causal, q_offset=q_offset)
    for name, g, e in zip(("dq", "dk", "dv"), got, exp):
        assert_rel_l2(g.numpy().astype(np.float64), e, tol=ORACLE_TOL, msg=name)


def test_bwd_plain_rows_that_see_no_key():
    """A negative q_offset leaves the first rows with no visible key: the
    forward gives them LSE = NEG_INF, and the backward must give them
    dq = 0 with everything finite. (The JAX backward turns these rows into
    NaN through exp(s - lse), so the oracle is the reference here.)"""
    q, k, v, do = _inputs(2, 1, 4, 2, 32, 48, 16)
    o, lse = tfa._fwd_plain(*(torch.from_numpy(x) for x in (q, k, v)), True,
                            0.25, -8)
    assert (lse[..., :8] == tfa.NEG_INF).all()
    dq, dk, dv = _plain(q, k, v, do, o, lse, True, -8)
    for x in (dq, dk, dv):
        assert torch.isfinite(x).all()
    np.testing.assert_array_equal(dq[..., :8, :].numpy(), 0.0)
    exp = gqa_attention_grads(q, k, v, do, causal=True, q_offset=-8)
    for g, e in zip((dq, dk, dv), exp):
        assert_rel_l2(g.numpy().astype(np.float64), e, tol=ORACLE_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_autograd_matches_jax_grad(causal):
    """torch.autograd.grad through the port's flash_attention against
    jax.grad through the JAX one, on tests/test_flash_attention.py's
    loss sum(o * cos(o))."""
    q, k, v, _ = _inputs(3, 1, 4, 2, 64, 96, 32)

    def jloss(q, k, v):
        o = jfa.flash_attention(q, k, v, causal=causal, block_q=32, block_k=32,
                                interpret=True)
        return jnp.sum(o * jnp.cos(o))

    exp = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    o = tfa.flash_attention(*ts, causal=causal)
    got = torch.autograd.grad((o * torch.cos(o)).sum(), ts)
    for g, e in zip(got, exp):
        assert g.dtype == torch.float32
        assert_rel_l2(g.numpy(), np.asarray(e), tol=TOL)


def test_bwd_takes_a_non_contiguous_do():
    """The model hands the output gradient back through a transpose."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(4, 1, 2, 1, 16, 16, 16))
    o, lse = tfa._fwd(q, k, v, True, None, 0)
    do_t = do.transpose(1, 2).contiguous().transpose(1, 2)
    assert not do_t.is_contiguous()
    for a, b in zip(tfa._bwd(q, k, v, o, lse, do_t, True, None, 0),
                    tfa._bwd(q, k, v, o, lse, do, True, None, 0)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("kwargs", [dict(window=8), dict(window=8, sinks=2)])
def test_window_and_sinks_raise_with_gradients(kwargs):
    q, k, v = (torch.zeros(1, 2, 8, 16, requires_grad=True) for _ in range(3))
    with pytest.raises(NotImplementedError):
        tfa.flash_attention(q, k, v, causal=True, **kwargs)


def test_cpu_backward_never_launches_kernels():
    """CPU tensors go to the plain versions in both directions and leave
    the counters at 0; flash_attention_with_lse records no graph."""
    before = (tfa._fwd.launches, tfa._bwd.launches)
    ts = [torch.from_numpy(x).requires_grad_(True)
          for x in _inputs(5, 1, 2, 1, 8, 8, 16)[:3]]
    tfa.flash_attention(*ts, causal=True).sum().backward()
    assert all(t.grad is not None for t in ts)
    o, lse = tfa.flash_attention_with_lse(*ts)
    assert not o.requires_grad and not lse.requires_grad
    assert (tfa._fwd.launches, tfa._bwd.launches) == before == (0, 0)


def test_cuda_backward_inputs_are_checked_before_any_build():
    bf = torch.zeros(1, 2, 8, 64, dtype=torch.bfloat16)
    with pytest.raises(TypeError):  # an f32 output gradient
        tfa._check_cuda_inputs(bf, bf, bf, do=torch.zeros(1, 2, 8, 64))
    with pytest.raises(ValueError):  # a non-contiguous one
        tfa._check_cuda_inputs(bf, bf, bf, do=bf.transpose(1, 2))
