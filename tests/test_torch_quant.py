"""The port's 8-bit KV-cache ops against the JAX package's, in float32 on
the CPU (the JAX kernels in interpret mode, the port's wrappers on their
plain versions): the quantizers bit for bit, the 8-bit decode over a linear
cache and over a page pool (both schedules), the 8-bit ragged forward and
paged extend, and the 8-bit page appends bit for bit, each for int8 and
e4m3 caches."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattention_kernel_project_tpu_torch.models.convert import params_from_jax
from flashattention_kernel_project_tpu_torch.ops import flash_attention as tfa
from flashattention_kernel_project_tpu_torch.ops import flash_decode as tfd
from flashattention_kernel_project_tpu_torch.ops import paged_decode as tpd
from flashattention_kernel_project_tpu_torch.ops import quant as tq
from flashattention_kernel_project_tpu_torch.utils.testing import assert_rel_l2

jq = importlib.import_module("flashattention_kernel_project_tpu.ops.quant")
jfd = importlib.import_module("flashattention_kernel_project_tpu.ops.flash_decode")
jfa = importlib.import_module("flashattention_kernel_project_tpu.ops.flash_attention")
jpd = importlib.import_module("flashattention_kernel_project_tpu.ops.paged_decode")

torch.set_num_threads(1)

TOL = 1e-4  # float32 on both sides, the same 8-bit values and scales
CPU = torch.device("cpu")
FMTS = ["int8", "fp8"]
J_QUANT = {"int8": jq.quantize_int8, "fp8": jq.quantize_fp8_tokenwise}
T_QUANT = {"int8": tq.quantize_int8, "fp8": tq.quantize_fp8_tokenwise}


def _torch(x):
    """A JAX or numpy array as a CPU tensor, 8-bit and bf16 types kept."""
    return params_from_jax(np.asarray(x), CPU)


def _same_bits(t, a):
    """Tensor t equals the JAX or numpy array a bit for bit."""
    a = _torch(a)
    if t.dtype != a.dtype or t.shape != a.shape:
        return False
    if t.element_size() == 1:
        return torch.equal(t.view(torch.uint8), a.view(torch.uint8))
    if t.dtype == torch.bfloat16:
        return torch.equal(t.view(torch.int16), a.view(torch.int16))
    return torch.equal(t, a)


def _random(rng, shape):
    """Normal values with per-row magnitudes spread over several decades
    (and one all-zero row), so the scales and the rounding get exercised."""
    spread = np.exp(2.0 * rng.standard_normal(shape[:-1] + (1,)))
    x = rng.standard_normal(shape) * spread
    x[(0,) * (len(shape) - 1)] = 0.0
    return x.astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt", FMTS)
def test_quantizers_match_jax_bit_for_bit(fmt, dtype):
    """Values and scales bit-equal to the JAX package's, per token (axis
    -1) and per column (axis 0), from float32 and bf16 inputs."""
    x = _random(np.random.default_rng(0), (3, 2, 40, 16))
    jx = jnp.asarray(x, dtype)
    tx = _torch(jx)
    for axis in (-1, 0):
        jv, js = J_QUANT[fmt](jx, axis=axis)
        tv, ts = T_QUANT[fmt](tx, axis=axis)
        assert tv.dtype == tq.cache_dtype(fmt) and ts.dtype == torch.float32
        assert _same_bits(tv, jv) and np.array_equal(ts.numpy(), np.asarray(js))
    jdeq = (jq.dequantize_int8 if fmt == "int8" else jq.dequantize_fp8)(jv, js)
    tdeq = (tq.dequantize_int8 if fmt == "int8" else tq.dequantize_fp8)(tv, ts)
    np.testing.assert_array_equal(tdeq.numpy(), np.asarray(jdeq))
    k_q, k_s, v_q, v_s = tq.quantize_kv(tx, tx * 2, fmt=fmt)
    jk_q, jk_s, jv_q, jv_s = jq.quantize_kv(jx, jx * 2, fmt=fmt)
    assert _same_bits(k_q, jk_q) and _same_bits(v_q, jv_q)
    assert np.array_equal(v_s.numpy(), np.asarray(jv_s))


def test_per_tensor_fp8_and_weight_quantizers_match_jax():
    x = _random(np.random.default_rng(1), (24, 40))
    jv, js = jq.quantize_fp8(jnp.asarray(x))
    tv, ts = tq.quantize_fp8(torch.from_numpy(x))
    assert ts.dim() == 0 and float(ts) == float(js) and _same_bits(tv, jv)
    jv, js = jq.quantize_fp8_weights(jnp.asarray(x))
    tv, ts = tq.quantize_fp8_weights(torch.from_numpy(x))
    assert ts.shape == (1, 40) and _same_bits(tv, jv)
    assert np.array_equal(ts.numpy(), np.asarray(js))
    with pytest.raises(ValueError, match="quant_fmt"):
        tq.cache_dtype("int4")


def _quantized(rng, shape, fmt):
    """(JAX 8-bit values, JAX scales, port values, port scales) of a random
    cache quantized per token by the JAX package."""
    jv, js = J_QUANT[fmt](jnp.asarray(_random(rng, shape)), axis=-1)
    return jv, js, _torch(jv), _torch(js)


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("n_splits", [1, 3])
def test_flash_decode_8bit_matches_jax(n_splits, fmt):
    """flash_decode_int8 (and its fp8 alias) over a cache with ragged
    lengths, an empty slot and a full one."""
    rng = np.random.default_rng(2)
    b, hq, hkv, s, d = 4, 4, 2, 40, 16
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    jk, jks, tk, tks = _quantized(rng, (b, hkv, s, d), fmt)
    jv, jvs, tv, tvs = _quantized(rng, (b, hkv, s, d), fmt)
    lengths = np.array([0, 1, 23, s], np.int32)
    jfn = jfd.flash_decode_int8 if fmt == "int8" else jfd.flash_decode_fp8
    tfn = tfd.flash_decode_int8 if fmt == "int8" else tfd.flash_decode_fp8
    jo = jfn(jnp.asarray(q), jk, jks, jv, jvs, jnp.asarray(lengths),
             n_splits=n_splits, interpret=True)
    to = tfn(torch.from_numpy(q), tk, tks, tv, tvs, torch.from_numpy(lengths),
             n_splits=n_splits)
    assert to.shape == q.shape and to.dtype == torch.float32
    assert_rel_l2(to.numpy(), np.asarray(jo), tol=TOL)
    np.testing.assert_array_equal(to.numpy()[0], 0.0)  # length 0 -> zeros
    assert tfd.flash_decode_int8.launches == 0  # CPU tensors: plain version


def _paged_8bit(rng, fmt, page, b=4, hkv=2, d=16, max_pages=6):
    """An 8-bit pool with its lane-major scale pools, quantized by the JAX
    package, and shuffled tables (entries past a row's pages at page 0)."""
    n_pages = b * max_pages + 1
    pools = []
    for _ in range(2):
        vals, scales = J_QUANT[fmt](
            jnp.asarray(_random(rng, (n_pages, hkv, page, d))), axis=-1)
        scales = jnp.swapaxes(scales, -1, -2)  # [n_pages, Hkv, 1, page]
        pools.append((vals, scales))
    lengths = np.array([0, 1, 2 * page + 3, max_pages * page][:b], np.int32)
    perm = rng.permutation(np.arange(1, n_pages)).astype(np.int32)
    table = np.zeros((b, max_pages), np.int32)
    for i, n in enumerate(lengths):
        used = -(-int(n) // page)
        table[i, :used] = perm[i * max_pages:i * max_pages + used]
    return pools, table, lengths


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("page", [8, 16])
@pytest.mark.parametrize("gather", [True, False])
def test_paged_flash_decode_quant_matches_jax(gather, page, fmt):
    rng = np.random.default_rng(3)
    pools, table, lengths = _paged_8bit(rng, fmt, page)
    (jk, jks), (jv, jvs) = pools
    q = rng.standard_normal((4, 4, 16)).astype(np.float32)
    jo = jpd.paged_flash_decode_quant(
        jnp.asarray(q), jk, jks, jv, jvs, jnp.asarray(table),
        jnp.asarray(lengths), gather=gather, interpret=True)
    to = tpd.paged_flash_decode_quant(
        torch.from_numpy(q), *(_torch(x) for pair in pools for x in pair),
        torch.from_numpy(table), torch.from_numpy(lengths), gather=gather)
    assert to.shape == q.shape and to.dtype == torch.float32
    assert_rel_l2(to.numpy(), np.asarray(jo), tol=TOL)
    np.testing.assert_array_equal(to.numpy()[0], 0.0)
    assert tpd.paged_flash_decode_quant.launches == 0


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_ragged_kv_quant_matches_jax(causal, fmt):
    """The chunked-prefill forward over an 8-bit cache: per-row bounds, an
    empty row, the padded tail past kv_lens invisible."""
    rng = np.random.default_rng(4)
    b, hq, hkv, n, s, d = 3, 4, 2, 13, 48, 16
    q = rng.standard_normal((b, hq, n, d)).astype(np.float32)
    jk, jks, tk, tks = _quantized(rng, (b, hkv, s, d), fmt)
    jv, jvs, tv, tvs = _quantized(rng, (b, hkv, s, d), fmt)
    kv_lens = np.array([13, 40, 0], np.int32)
    q_offsets = np.array([0, 27, 0], np.int32)
    jo = jfa.flash_attention_ragged_kv_quant(
        jnp.asarray(q), jk, jks, jv, jvs, jnp.asarray(kv_lens),
        jnp.asarray(q_offsets), causal=causal, block_q=16, block_k=16,
        interpret=True)
    to = tfa.flash_attention_ragged_kv_quant(
        torch.from_numpy(q), tk, tks, tv, tvs, torch.from_numpy(kv_lens),
        torch.from_numpy(q_offsets), causal=causal)
    assert to.shape == q.shape and to.dtype == torch.float32
    assert_rel_l2(to.numpy(), np.asarray(jo), tol=TOL)
    np.testing.assert_array_equal(to.numpy()[2], 0.0)  # kv_len 0 -> zeros
    assert tfa.flash_attention_ragged_kv_quant.launches == 0


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("page", [8, 16])
def test_paged_flash_extend_8bit_matches_jax(page, fmt):
    """The paged verify over an 8-bit pool: chunks crossing page edges, a
    row with no prefix, through paged_flash_extend(k_scale_pages=...)."""
    rng = np.random.default_rng(5)
    b, hq, t, d = 3, 4, 3, 16
    pools, table, _ = _paged_8bit(rng, fmt, page, b=b)
    old = np.array([0, page - 1, 2 * page + 1], np.int32)
    new = old + t
    q = rng.standard_normal((b, hq, t, d)).astype(np.float32)
    (jk, jks), (jv, jvs) = pools
    jo = jpd.paged_flash_extend(
        jnp.asarray(q), jk, jv, jnp.asarray(table), jnp.asarray(new),
        jnp.asarray(old), k_scale_pages=jks, v_scale_pages=jvs, interpret=True)
    tk, tks, tv, tvs = (_torch(x) for pair in pools for x in pair)
    args = (torch.from_numpy(q), tk, tv, torch.from_numpy(table),
            torch.from_numpy(new), torch.from_numpy(old))
    to = tpd.paged_flash_extend(*args, k_scale_pages=tks, v_scale_pages=tvs)
    assert to.shape == q.shape and to.dtype == torch.float32
    assert_rel_l2(to.numpy(), np.asarray(jo), tol=TOL)
    assert tpd.paged_flash_extend_quant.launches == 0
    with pytest.raises(ValueError, match="k_scale_pages and v_scale_pages"):
        tpd.paged_flash_extend(*args, k_scale_pages=tks)


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("chunk", [False, True])
def test_paged_append_quant_matches_jax_bit_for_bit(chunk, fmt):
    """One token (paged_append_quant) or a 3-token chunk
    (paged_append_chunk_quant) per row into an 8-bit pool, in place:
    values and scales bit-equal to the JAX package's, a chunk crossing a
    page edge, an empty row, a row at its table's capacity (the junk page
    0 is left out of the comparison: colliding writes land there)."""
    page, max_pages, t = 8, 3, 3 if chunk else 1
    rng = np.random.default_rng(6)
    pools = []
    for _ in range(2):
        vals, scales = J_QUANT[fmt](jnp.asarray(_random(rng, (10, 2, page, 16))),
                                    axis=-1)
        pools += [vals, jnp.swapaxes(scales, -1, -2)]
    new = [_random(rng, (4, t, 2, 16)) for _ in range(2)]
    table = np.array([[4, 7, 2], [9, 1, 5], [0, 0, 0], [3, 8, 6]], np.int32)
    lengths = np.array([6, max_pages * page - 1, 0, page], np.int32)
    tpools = [_torch(x) for x in pools]
    if chunk:
        jout = jpd.paged_append_chunk_quant(
            *pools, *(jnp.asarray(x) for x in new), jnp.asarray(table),
            jnp.asarray(lengths))
        out = tpd.paged_append_chunk_quant(
            *tpools, *(torch.from_numpy(x) for x in new),
            torch.from_numpy(table), torch.from_numpy(lengths))
    else:
        jout = jpd.paged_append_quant(
            *pools, *(jnp.asarray(x[:, 0]) for x in new), jnp.asarray(table),
            jnp.asarray(lengths))
        out = tpd.paged_append_quant(
            *tpools, *(torch.from_numpy(x[:, 0]) for x in new),
            torch.from_numpy(table), torch.from_numpy(lengths))
    for got, want, mine in zip(out, jout, tpools):
        assert got is mine  # in place
        assert _same_bits(got[1:], np.asarray(want)[1:])


def test_8bit_options_and_checks_raise():
    """return_partials folds the splits (y / l is the decode); window
    and sinks, mxu and q_int8 run (tests/test_torch_window.py and
    tests/test_torch_int8_decodes.py hold them to JAX); the CUDA wrappers'
    checks refuse what the kernels do not take (the 8-bit GEMMs' checks
    are in tests/test_torch_gemm8.py)."""
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.standard_normal((2, 4, 16)).astype(np.float32))
    _, _, k, ks = _quantized(rng, (2, 2, 8, 16), "int8")
    lengths = torch.tensor([3, 8], dtype=torch.int32)
    args = (q, k, ks, k, ks, lengths)
    m, l, y = tfd.flash_decode_int8(*args, return_partials=True)
    full = tfd.flash_decode_int8(*args)
    torch.testing.assert_close((y / l).reshape(full.shape), full)
    got = tfd.flash_decode_int8(*args, mxu=True)
    assert got.shape == full.shape and torch.isfinite(got).all()
    for kwargs in (dict(window=4), dict(window=4, sinks=1)):
        got = tfd.flash_decode_int8(*args, **kwargs)
        assert got.shape == full.shape and torch.isfinite(got).all()
        assert not torch.equal(got, full)  # the band bites at length 8
    table = torch.tensor([[0], [1]], dtype=torch.int32)
    pool = k.view(2, 2, 8, 16)[:, :, :8].contiguous()
    spool = ks.view(2, 2, 1, 8).contiguous()
    got = tpd.paged_flash_decode_quant(q, pool, spool, pool, spool, table,
                                       lengths, q_int8=True)
    assert got.shape == q.shape and torch.isfinite(got).all()
    got = tfa.flash_attention_ragged_kv_quant(q[:, :, None], k, ks, k, ks,
                                              lengths, lengths - 1, window=4)
    torch.testing.assert_close(got[:, :, 0], tfd.flash_decode_int8(
        *args, window=4, n_splits=1))  # a one-row chunk is a decode
    with pytest.raises(TypeError, match="bf16 q"):  # the kernels take bf16 q
        tfd._decode_partials_q_cuda(*args, 1, 8, 0.25)
    with pytest.raises(TypeError, match="int8 or float8"):
        tq.check_8bit_cache(q.bfloat16(), ks, ks, ks, ks, ks.shape, "decode")
    with pytest.raises(ValueError, match="float32"):
        tq.check_8bit_cache(q.bfloat16(), k, ks.bfloat16(), k, ks, ks.shape,
                            "decode")
    with pytest.raises(ValueError, match="differ"):
        tq.check_8bit_cache(q.bfloat16(), k, ks, k[:, :, :4].contiguous(), ks,
                            ks.shape, "ragged forward")
