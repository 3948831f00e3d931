"""The port's attention ops against the JAX package's, on the same numpy
inputs, in float32 on the CPU (the JAX kernels in interpret mode, the port's
wrappers on their plain versions). The two agree to rounding: the JAX side
rounds through the log2(e) fold and exp2, so they are not bit-equal."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattention_kernel_project_tpu_torch.ops import flash_attention as tfa
from flashattention_kernel_project_tpu_torch.ops import flash_decode as tfd
from flashattention_kernel_project_tpu_torch.utils.oracles import gqa_attention
from flashattention_kernel_project_tpu_torch.utils.testing import assert_rel_l2

# the JAX package's ops/__init__ re-exports functions under the modules' names
jfa = importlib.import_module("flashattention_kernel_project_tpu.ops.flash_attention")
jfd = importlib.import_module("flashattention_kernel_project_tpu.ops.flash_decode")

torch.set_num_threads(1)

TOL = 1e-4  # float32 on both sides


def _inputs(seed, b, hq, hkv, n, s, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, n, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize(
    "hq,hkv,n,s,d,causal,q_offset",
    [
        (4, 2, 32, 32, 16, True, 0),     # GQA, causal
        (4, 2, 40, 40, 16, False, 0),    # ragged N, non-causal
        (2, 2, 24, 56, 64, True, 32),    # d=64, q block placed late in S
        (4, 1, 37, 37, 64, True, 0),     # ragged N, group 4
        (2, 1, 16, 48, 16, True, -8),    # negative offset: rows with no key
    ],
)
def test_flash_attention_with_lse_matches_jax(hq, hkv, n, s, d, causal, q_offset):
    q, k, v = _inputs(0, 2, hq, hkv, n, s, d)
    jo, jl = jfa.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        q_offset=q_offset, block_q=16, block_k=16, interpret=True,
    )
    to, tl = tfa.flash_attention_with_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, q_offset=q_offset,
    )
    assert to.shape == (2, hq, n, d) and tl.shape == (2, hq, n)
    assert to.dtype == torch.float32 and tl.dtype == torch.float32
    assert_rel_l2(to.numpy(), np.asarray(jo), tol=TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    exp = gqa_attention(q, k, v, causal=causal, q_offset=q_offset)
    assert_rel_l2(to.numpy(), exp, tol=TOL)


def test_flash_attention_matches_jax_default_path():
    q, k, v = _inputs(1, 1, 4, 2, 48, 48, 16)
    jo = jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        block_q=16, block_k=16, interpret=True,
    )
    to = tfa.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True,
    )
    assert_rel_l2(to.numpy(), np.asarray(jo), tol=TOL)


@pytest.mark.parametrize(
    "kwargs",
    [dict(stable=False), dict(stable="auto"), dict(window=8),
     dict(window=8, sinks=2), dict(k_max=1.0), dict(stack_group=True),
     dict(pack_heads=True)],
)
def test_flash_attention_unported_options_raise(kwargs):
    q, k, v = (torch.zeros(1, 2, 8, 16) for _ in range(3))
    with pytest.raises(NotImplementedError):
        tfa.flash_attention(q, k, v, causal=True, **kwargs)


def _decode_inputs(seed, b, hq, hkv, s, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("n_splits", [1, 2])
@pytest.mark.parametrize("d", [16, 64])
def test_flash_decode_matches_jax(n_splits, d):
    s = 64
    q, k, v = _decode_inputs(2, 4, 4, 2, s, d)
    lengths = np.array([0, 1, 37, s], np.int32)  # empty, one key, ragged, full
    jo = jfd.flash_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
        n_splits=n_splits, interpret=True,
    )
    to = tfd.flash_decode(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lengths), n_splits=n_splits,
    )
    assert to.shape == (4, 4, d)
    assert_rel_l2(to.numpy(), np.asarray(jo), tol=TOL)
    np.testing.assert_array_equal(to.numpy()[0], 0.0)  # length 0 -> zeros


def test_flash_decode_lengths_above_cache_clamp():
    q, k, v = _decode_inputs(3, 2, 4, 2, 32, 16)
    args = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    over = tfd.flash_decode(*args, torch.tensor([40, 99], dtype=torch.int32))
    full = tfd.flash_decode(*args, torch.tensor([32, 32], dtype=torch.int32))
    torch.testing.assert_close(over, full, rtol=0, atol=0)


def test_flash_decode_default_splits_fill_the_card():
    # B*Hkv = 32 at the serving shape: 9 splits give 288 blocks for 132 SMs
    assert tfd.default_n_splits(8, 4, 2048) == 9
    assert tfd.default_n_splits(1, 1, 100) == 1  # short caches: no tiny splits
    q, k, v = _decode_inputs(4, 2, 4, 2, 300, 16)
    lengths = torch.tensor([300, 123], dtype=torch.int32)
    args = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), lengths)
    # the default changes only the order of the sums
    torch.testing.assert_close(
        tfd.flash_decode(*args), tfd.flash_decode(*args, n_splits=1),
        rtol=1e-5, atol=1e-6,
    )


@pytest.mark.parametrize(
    "kwargs", [dict(window=8), dict(sinks=2), dict(return_partials=True)],
)
def test_flash_decode_unported_options_raise(kwargs):
    q = torch.zeros(1, 2, 16)
    kv = torch.zeros(1, 1, 8, 16)
    with pytest.raises(NotImplementedError):
        tfd.flash_decode(q, kv, kv, torch.ones(1, dtype=torch.int32), **kwargs)


def test_merge_partials_matches_jax():
    rng = np.random.default_rng(5)
    m = rng.standard_normal((2, 3, 4, 2, 1)).astype(np.float32)
    m[0, 0, :, 0] = -1e30  # a row with no live key in any split
    l = np.abs(rng.standard_normal((2, 3, 4, 2, 1))).astype(np.float32)
    l[0, 0, :, 0] = 0.0
    y = rng.standard_normal((2, 3, 4, 2, 8)).astype(np.float32)
    y[0, 0, :, 0] = 0.0
    exp = np.asarray(jfd.merge_partials(jnp.asarray(m), jnp.asarray(l), jnp.asarray(y)))
    got = tfd.merge_partials(torch.from_numpy(m), torch.from_numpy(l), torch.from_numpy(y))
    assert_rel_l2(got.numpy(), exp, tol=1e-6)
    np.testing.assert_array_equal(got.numpy()[0, 0, 0], 0.0)


def test_cpu_tensors_never_launch_kernels():
    """The wrappers' launch counters count kernel launches only: CPU
    tensors go to the plain versions and leave them at 0."""
    before = (tfa._fwd.launches, tfd.flash_decode.launches)
    q, k, v = (torch.from_numpy(x) for x in _inputs(6, 1, 2, 1, 8, 8, 16))
    tfa.flash_attention(q, k, v, causal=True)
    tfa.flash_attention_with_lse(q, k, v)
    tfd.flash_decode(q[:, :, 0], k, v, torch.tensor([5], dtype=torch.int32))
    assert (tfa._fwd.launches, tfd.flash_decode.launches) == before == (0, 0)


def test_cuda_inputs_are_checked_before_any_build():
    """A tensor the kernel does not take raises before the library is
    built or loaded (the wrapper validates first)."""
    with pytest.raises(TypeError):
        tfa._check_cuda_inputs(*(torch.zeros(1, 2, 8, 64) for _ in range(3)))
    bf = torch.zeros(1, 2, 8, 48, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        tfa._check_cuda_inputs(bf, bf, bf)
    q = torch.zeros(1, 4, 64, dtype=torch.bfloat16)
    kv = torch.zeros(1, 1, 8, 64, dtype=torch.bfloat16)
    with pytest.raises(TypeError):  # int64 lengths
        tfd._check_cuda_inputs(q, kv, kv, torch.ones(1, dtype=torch.int64))
    q3 = torch.zeros(1, 3, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # group of 3
        tfd._check_cuda_inputs(q3, kv, kv, torch.ones(1, dtype=torch.int32))
