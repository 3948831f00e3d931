"""The port's streaming decode against the JAX package's (its Pallas kernel
in interpret mode, the port's wrapper on its plain version), on the CPU:
the four cases of tests/test_streaming.py, each against JAX's
streaming_decode, in float32 and in bf16."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattention_kernel_project_tpu_torch import ops
from flashattention_kernel_project_tpu_torch.utils import oracles
from flashattention_kernel_project_tpu_torch.utils.testing import assert_rel_l2

jops = importlib.import_module("flashattention_kernel_project_tpu.ops")

torch.set_num_threads(1)

F32_TOL = 1e-5   # f32 on both sides: the same function, summed in another order
BF16_TOL = 1e-2  # bf16 inputs and output, the JAX suite's bound


def _inputs(rng, b, hq, hkv, s, d, lengths):
    q = rng.standard_normal((b, hq, d), dtype=np.float32)
    k = rng.standard_normal((b, hkv, s, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, s, d), dtype=np.float32)
    return q, k, v, np.asarray(lengths, np.int32)


def _both(q, k, v, lengths, dtype="f32", **kw):
    """(JAX's output, the port's) on the same inputs, as float32 numpy."""
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16,
                                                                    torch.bfloat16)
    want = jops.streaming_decode(*(jnp.asarray(x, jdt) for x in (q, k, v)),
                                 jnp.asarray(lengths), **kw)
    got = ops.streaming_decode(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
                               torch.from_numpy(lengths), **kw)
    assert got.dtype == tdt and tuple(got.shape) == q.shape
    return np.asarray(want, np.float32), got.float().numpy()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
def test_streaming_decode_matches_jax(rng, hq, hkv, dtype):
    """tests/test_streaming.py:14-32's case: ragged lengths down to 1,
    against JAX and, per sequence, the float64 oracle."""
    q, k, v, lengths = _inputs(rng, 3, hq, hkv, 160, 64, [160, 97, 1])
    want, got = _both(q, k, v, lengths, dtype, block_s=32)
    assert_rel_l2(got, want, tol=F32_TOL if dtype == "f32" else BF16_TOL)
    for i, n in enumerate(lengths):
        exp = oracles.gqa_attention(q[i:i + 1, :, None], k[i:i + 1, :, :n],
                                    v[i:i + 1, :, :n])[:, :, 0]
        assert_rel_l2(got[i:i + 1], exp, tol=BF16_TOL)


def test_streaming_decode_matches_flash_decode(rng):
    """tests/test_streaming.py:35-50: the streaming decode and the split
    decode compute one function (here the port's flash_decode, 2 splits)."""
    q, k, v, lengths = _inputs(rng, 2, 8, 2, 128, 32, [128, 55])
    want, got = _both(q, k, v, lengths, block_s=32)
    assert_rel_l2(got, want, tol=F32_TOL)
    split = ops.flash_decode.flash_decode(
        *(torch.from_numpy(x) for x in (q, k, v, lengths)), n_splits=2)
    assert_rel_l2(got, split.numpy(), tol=F32_TOL)


def test_streaming_decode_zero_length(rng):
    """tests/test_streaming.py:53-62: a sequence of length 0 gives exactly
    0, the other matches JAX."""
    q, k, v, lengths = _inputs(rng, 2, 4, 4, 64, 32, [64, 0])
    want, got = _both(q, k, v, lengths, block_s=32)
    assert np.isfinite(got).all() and np.abs(got[1]).max() == 0.0
    assert_rel_l2(got, want, tol=F32_TOL)


@pytest.mark.parametrize("seq_chunk", [1, 4, 8])
def test_streaming_decode_seq_chunk(rng, seq_chunk):
    """tests/test_streaming.py:65-89: seq_chunk (and block_s) do not change
    the function, ragged lengths inside a chunk included; against JAX's
    chunked call."""
    b, s = 16, 256
    lengths = rng.integers(1, s + 1, size=b).astype(np.int32)
    lengths[0], lengths[1] = s, 1
    q, k, v, lengths = _inputs(rng, b, 4, 2, s, 128, lengths)
    want, got = _both(q, k, v, lengths, block_s=64, seq_chunk=seq_chunk)
    assert_rel_l2(got, want, tol=F32_TOL)
    one = ops.streaming_decode(*(torch.from_numpy(x) for x in (q, k, v, lengths)))
    np.testing.assert_array_equal(got, one.numpy())


def test_streaming_decode_checks_raise():
    q, k = torch.zeros(6, 4, 32), torch.zeros(6, 2, 16, 32)
    lengths = torch.full((6,), 16, dtype=torch.int32)
    with pytest.raises(ValueError, match="seq_chunk"):
        ops.streaming_decode(q, k, k, lengths, seq_chunk=4)
    with pytest.raises(ValueError, match="block_s"):
        ops.streaming_decode(q, k, k, lengths, block_s=0)
    with pytest.raises(ValueError, match="multiple"):
        ops.streaming_decode(q[:, :3], k, k, lengths)


@pytest.mark.parametrize("s,block_s", [(300, 320), (1000, 1024), (4096, 4096)])
def test_streaming_cuda_plan(rng, s, block_s):
    """The CUDA route's plan (streaming_plan): flash_decode's Hopper kernel
    at one split of S rounded up to whole 64-key tiles, which computes the
    streaming decode's function (the plain decode at that plan equals
    `_streaming_plain`, lengths 0 and S among them)."""
    from flashattention_kernel_project_tpu_torch.ops import flash_decode as fd
    from flashattention_kernel_project_tpu_torch.ops import streaming as st

    assert st.streaming_plan(s) == (1, block_s)
    q, k, v, lengths = (torch.from_numpy(x) for x in
                        _inputs(rng, 3, 4, 2, s, 64, [s, 0, s // 3 + 1]))
    want = st._streaming_plain(q, k, v, lengths, 0.125)
    got = fd._decode_plain(q, k, v, lengths, *st.streaming_plan(s), 0.125)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)
