"""The port's fixed-max range guard, `_fwd(..., guard=True)` (and
`_fwd_q_plain(..., guard=True)` over an int8 cache), against the JAX
package's (`_fwd(..., stable=False, guard=True)`, interpret mode) on the
CPU: the count of rows whose l left [2^-100, 2^120] or whose acc is not
finite, exactly, on bounded inputs, on the JAX test's crafted row, on
underflowing rows, on rows that see no key, on q x 60 (d=64 paired over KV
heads as in JAX, and unpaired), with a window and over an int8 cache; O
and LSE as without the guard."""

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


def _inputs(seed, d, b=1, hq=2, hkv=2, n=128, s=256):
    """JAX's guard test's shape (tests/test_flash_attention.py:222-234)."""
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, hq, n, d), (b, hkv, s, d), (b, hkv, s, d)))


def _jax(q, k, v, causal=False, q_offset=0, **kw):
    """JAX's _fwd with the guard: (O, LSE, count) as numpy and an int."""
    o, lse, bad = jfa._fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal, None, q_offset, 128, 128, None, stable=False,
                           guard=True, **kw)
    return np.asarray(o), np.asarray(lse), int(np.asarray(bad))


def _port(q, k, v, causal=False, q_offset=0, pack_heads=None, **kw):
    """The port's _fwd with the guard: (O, LSE, count). pack_heads=None is
    JAX's default: paired at d=64."""
    pack = q.shape[-1] == 64 if pack_heads is None else pack_heads
    o, lse, bad = tfa._fwd(*map(torch.from_numpy, (q, k, v)), causal, None,
                           q_offset, disc=tfa.FIXED, pack=pack, guard=True,
                           **kw)
    assert bad.dim() == 0 and bad.dtype == torch.int32
    return o.numpy(), lse.numpy(), int(bad)


def _port_q(q, k_q, k_scale, v_q, v_scale, causal=False):
    """The port's 8-bit dense forward with the guard: (O, LSE, count)."""
    k_q, k_scale, v_q, v_scale = (params_from_jax(np.asarray(x), CPU)
                                  for x in (k_q, k_scale, v_q, v_scale))
    o, lse, bad = tfa._fwd_q_plain(torch.from_numpy(q), k_q, k_scale, v_q,
                                   v_scale, causal, q.shape[-1] ** -0.5, 0,
                                   disc=tfa.FIXED, guard=True)
    assert bad.dim() == 0 and bad.dtype == torch.int32
    return o.numpy(), lse.numpy(), int(bad)


@pytest.mark.parametrize("d", [64, 128])
def test_guard_counts_the_crafted_row(d):
    """One q row of 90 against |k| overflows exp2: exactly 1, in both (d=64
    runs JAX's paired kernel)."""
    q, k, v = _inputs(0, d)
    q[0, 0, 5, :] = 90.0
    k = np.abs(k)
    assert _jax(q, k, v)[2] == 1
    assert _port(q, k, v)[2] == 1


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [64, 128])
def test_guard_is_silent_on_bounded_inputs(d, causal):
    """Count 0 in both; O and LSE of the guarded call are the unguarded
    call's, and JAX's within its own bounds."""
    q, k, v = _inputs(1, d)
    jo, jlse, jbad = _jax(q, k, v, causal)
    o, lse, bad = _port(q, k, v, causal)
    assert jbad == bad == 0
    uo, ulse = tfa._fwd(*map(torch.from_numpy, (q, k, v)), causal, None, 0,
                        disc=tfa.FIXED)
    assert np.array_equal(o, uo.numpy()) and np.array_equal(lse, ulse.numpy())
    assert_rel_l2(o, jo, tol=1e-2)
    np.testing.assert_allclose(lse, jlse, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("d", [64, 128])
def test_guard_counts_underflowing_rows(d):
    """Rows of -90 against |k|: every p underflows, l < 2^-100; two rows of
    one head count 2 in both."""
    q, k, v = _inputs(2, d)
    q[0, 1, 7:9, :] = -90.0
    k = np.abs(k)
    assert _jax(q, k, v, causal=True)[2] == 2
    assert _port(q, k, v, causal=True)[2] == 2


@pytest.mark.parametrize("d", [64, 128])
def test_guard_skips_rows_that_see_no_key(d):
    """Causal with q_offset -40: rows 0-39 see no key and carry l == 0 by
    right, so they do not count; an overflowing row past them does."""
    q, k, v = _inputs(3, d)
    assert _jax(q, k, v, causal=True, q_offset=-40)[2] == 0
    assert _port(q, k, v, causal=True, q_offset=-40)[2] == 0
    q[0, 1, 70, :] = 90.0
    k = np.abs(k)
    assert _jax(q, k, v, causal=True, q_offset=-40)[2] == 1
    assert _port(q, k, v, causal=True, q_offset=-40)[2] == 1


@pytest.mark.parametrize("hq,hkv", [(2, 2), (8, 4)])
@pytest.mark.parametrize("d,pack", [(64, True), (64, False), (128, False)])
def test_guard_counts_every_breaching_row_as_jax(d, pack, hq, hkv):
    """q x 60 breaches most rows, and each count equals JAX's: unpaired,
    each row of each head; paired (d=64, pack_heads=True, JAX's default
    there), a row once for the two heads of a KV pair."""
    q, k, v = _inputs(4, d, hq=hq, hkv=hkv)
    q *= 60.0
    bad = _port(q, k, v, causal=True, pack_heads=pack)[2]
    assert bad == _jax(q, k, v, causal=True, pack_heads=pack)[2] > 0


def test_guard_with_a_window_and_sinks():
    """The band and its sinks: the crafted row counts 1, bounded rows 0."""
    q, k, v = _inputs(5, 128)
    kw = dict(causal=True, window=64, sinks=4)
    assert _jax(q, k, v, **kw)[2] == _port(q, k, v, **kw)[2] == 0
    q[0, 0, 100, :] = 90.0
    k = np.abs(k)
    assert _jax(q, k, v, **kw)[2] == _port(q, k, v, **kw)[2] == 1


def test_guard_over_an_int8_cache():
    """JAX's _fwd takes the guard with k_scale: the 8-bit dense forward's
    count on bounded inputs (0) and on the crafted row (1), in both."""
    q, k, v = _inputs(6, 128)
    kq, ks = jq.quantize_int8(jnp.asarray(np.abs(k)), axis=-1)
    vq, vs = jq.quantize_int8(jnp.asarray(v), axis=-1)
    kw = dict(k_scale=ks, v_scale=vs)
    assert _jax(q, kq, vq, True, **kw)[2] == _port_q(q, kq, ks, vq, vs, True)[2] == 0
    q[0, 1, 20, :] = 90.0
    assert _jax(q, kq, vq, True, **kw)[2] == _port_q(q, kq, ks, vq, vs, True)[2] == 1


@pytest.mark.parametrize("stable", [True, "auto"])
def test_guard_needs_the_fixed_max_discipline(stable):
    """guard=True with stable=True or "auto" raises, where JAX asserts."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(7, 64, n=16, s=16))
    with pytest.raises(ValueError, match="fixed-max"):
        tfa._fwd(q, k, v, True, None, 0, disc=tfa._discipline(stable),
                 guard=True)
    kq, ks = (torch.zeros(k.shape, dtype=torch.int8),
              torch.ones(*k.shape[:3], 1))
    with pytest.raises(ValueError, match="fixed-max"):
        tfa._fwd_q_plain(q, kq, ks, kq, ks, True, 0.125, 0,
                         disc=tfa._discipline(stable), guard=True)
    with pytest.raises(AssertionError):
        jfa._fwd(*(jnp.asarray(x.numpy()) for x in (q, k, v)), True, None, 0,
                 128, 128, None, stable=stable, guard=True)
