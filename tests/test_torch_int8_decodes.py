"""The port's int8 x int8 decodes against the JAX package's, in float32 on
the CPU (the JAX kernels in interpret mode, the port's wrappers on their
plain versions): flash_decode_int8(mxu=True) (kernel 8) and
paged_flash_decode_quant(q_int8=True) (kernel 12's int8 score product),
over the same int8 values and scales, quantized by the JAX package."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattention_kernel_project_tpu_torch.models.convert import params_from_jax
from flashattention_kernel_project_tpu_torch.ops import flash_decode as tfd
from flashattention_kernel_project_tpu_torch.ops import paged_decode as tpd
from flashattention_kernel_project_tpu_torch.utils.oracles import gqa_attention
from flashattention_kernel_project_tpu_torch.utils.testing import assert_rel_l2

jq = importlib.import_module("flashattention_kernel_project_tpu.ops.quant")
jfd = importlib.import_module("flashattention_kernel_project_tpu.ops.flash_decode")
jpd = importlib.import_module("flashattention_kernel_project_tpu.ops.paged_decode")

torch.set_num_threads(1)

# Both packages take the same integer products and the same scale products
# in float32; exp and the order of the sums differ, and a weight that lands
# on a rounding edge may requantize one step apart
TOL = 1e-3
# mxu=True against the dequantized cache through float32 attention: JAX's
# own bound (tests/test_flash_decode.py:70)
MXU_TOL = 2e-2
CPU = torch.device("cpu")


def _torch(x):
    """A JAX or numpy array as a CPU tensor, int8 kept."""
    return params_from_jax(np.asarray(x), CPU)


def _int8_cache(rng, b, hkv, s, d):
    """(JAX int8 K, K scales, V, V scales) of a random cache, per token."""
    kq, ks = jq.quantize_int8(jnp.asarray(rng.standard_normal((b, hkv, s, d)),
                                          jnp.float32), axis=-1)
    vq, vs = jq.quantize_int8(jnp.asarray(rng.standard_normal((b, hkv, s, d)),
                                          jnp.float32), axis=-1)
    return kq, ks, vq, vs


def _both_mxu(q, cache, lengths, **kw):
    """flash_decode_int8(mxu=True) of both packages on the same inputs."""
    jo = jfd.flash_decode_int8(jnp.asarray(q), *cache, jnp.asarray(lengths),
                               interpret=True, mxu=True, **kw)
    to = tfd.flash_decode_int8(torch.from_numpy(q), *map(_torch, cache),
                               torch.from_numpy(lengths), mxu=True, **kw)
    return np.asarray(jo), to.numpy()


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("g", [1, 2, 4, 8])
def test_mxu_decode_matches_jax(g, d):
    """Kernel 8's function at the same n_splits (so the same requantization
    groups), lengths 0, short, mid-split and full."""
    rng = np.random.default_rng(g * 10 + d)
    b, hkv, s = 4, 2, 100
    q = rng.standard_normal((b, g * hkv, d)).astype(np.float32)
    lengths = np.array([0, 3, 57, s], np.int32)
    jo, to = _both_mxu(q, _int8_cache(rng, b, hkv, s, d), lengths, n_splits=3)
    assert_rel_l2(to, jo, tol=TOL)
    assert np.all(to[0] == 0.0)  # the empty slot


@pytest.mark.parametrize("kw", [dict(window=100), dict(window=60, sinks=4)],
                         ids=["window", "window+sinks"])
def test_mxu_decode_window_matches_jax(kw):
    """The window and sinks case of tests/test_flash_decode.py:142-163 (3
    splits of 384 keys, lengths 384 and 200): JAX's result, and within
    JAX's 2e-2 of the dequantized cache's band through float32 attention."""
    rng = np.random.default_rng(5)
    b, hq, hkv, s, d = 2, 8, 2, 384, 32
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    cache = _int8_cache(rng, b, hkv, s, d)
    lengths = np.array([384, 200], np.int32)
    jo, to = _both_mxu(q, cache, lengths, n_splits=3, **kw)
    assert_rel_l2(to, jo, tol=TOL)
    kd, vd = (np.asarray(x, np.float32) * np.asarray(sc) for x, sc in
              (cache[:2], cache[2:]))
    window, sinks = kw["window"], kw.get("sinks", 0)
    for i, n in enumerate(lengths):
        keys = sorted(set(range(max(0, n - window), n)) | set(range(min(sinks, n))))
        exp = gqa_attention(q[i:i + 1, :, None], kd[i:i + 1, :, keys],
                            vd[i:i + 1, :, keys], causal=False)[:, :, 0]
        assert_rel_l2(to[i:i + 1], exp, tol=MXU_TOL)


def test_mxu_decode_near_the_dequantized_cache():
    """tests/test_flash_decode.py:51-70's shape (4 splits, lengths 128 and
    57): within JAX's 2e-2 of float32 attention over the dequantized cache,
    and the cast path (mxu=False) on the same cache within it too."""
    rng = np.random.default_rng(6)
    b, hq, hkv, s, d = 2, 8, 2, 128, 64
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    cache = _int8_cache(rng, b, hkv, s, d)
    lengths = np.array([128, 57], np.int32)
    _, to = _both_mxu(q, cache, lengths, n_splits=4)
    cast = tfd.flash_decode_int8(torch.from_numpy(q), *map(_torch, cache),
                                 torch.from_numpy(lengths), n_splits=4).numpy()
    kd, vd = (np.asarray(x, np.float32) * np.asarray(sc) for x, sc in
              (cache[:2], cache[2:]))
    for i, n in enumerate(lengths):
        exp = gqa_attention(q[i:i + 1, :, None], kd[i:i + 1, :, :n],
                            vd[i:i + 1, :, :n], causal=False)[:, :, 0]
        assert_rel_l2(to[i:i + 1], exp, tol=MXU_TOL)
        assert_rel_l2(cast[i:i + 1], exp, tol=1e-2)


def test_mxu_split_rule_and_default_splits():
    """block_s follows JAX's rule (ceil(S / n_splits) up to a multiple of
    32; a split wholly past S holds no key); n_splits=None takes the int8 x
    int8 decode's default (`mxu_n_splits`), the same function as passing
    it."""
    assert tfd.mxu_block_s(100, 3) == 64  # ceil(100/3) = 34 -> 64
    assert tfd.mxu_block_s(4096, 1) == 4096
    assert tfd.mxu_block_s(8192, 9) == 928
    rng = np.random.default_rng(7)
    b, hq, hkv, s, d = 2, 4, 2, 40, 16
    q = torch.from_numpy(rng.standard_normal((b, hq, d)).astype(np.float32))
    cache = tuple(map(_torch, _int8_cache(rng, b, hkv, s, d)))
    lengths = torch.tensor([40, 9], dtype=torch.int32)
    got = tfd.flash_decode_int8(q, *cache, lengths, mxu=True)
    want = tfd.flash_decode_int8(q, *cache, lengths, mxu=True,
                                 n_splits=tfd.mxu_n_splits(b, hkv, s, hq // hkv, d))
    assert torch.equal(got, want)
    # 3 splits of 32 over 40 keys: the third is past S and weighs nothing
    jo, to = _both_mxu(q.numpy(), tuple(np.asarray(x) for x in cache),
                       lengths.numpy(), n_splits=3)
    assert_rel_l2(to, jo, tol=TOL)


@pytest.mark.parametrize("band", [None, (100, 4)], ids=["full", "window+sinks"])
@pytest.mark.parametrize("s,n_splits,block_s", [(200, 3, 96), (8192, 9, 928)])
def test_mxu_decode_matches_jax_at_unaligned_splits(s, n_splits, block_s, band):
    """The port's split arithmetic (on the CPU, its plain version) against
    JAX's at splits that start off a multiple of 64 keys: S 200 in 3 splits
    of 96, and chip_smoke.py's S 8192 in 9 splits of 928 at a small width,
    lengths 0, inside the second split, on its edge and full, without and
    with a window and sinks. The kernel's TMA tiles, which start at a
    split's or a range's first key, meet such splits on the card, where
    chip_smoke.py's `mxu_edges` (MXU_EDGES) holds them."""
    assert tfd.mxu_block_s(s, n_splits) == block_s and block_s % 64
    rng = np.random.default_rng(s + n_splits)
    b, hq, hkv, d = 4, 4, 2, 16
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    lengths = np.array([0, block_s + 37, block_s, s], np.int32)
    kw = {} if band is None else dict(window=band[0], sinks=band[1])
    jo, to = _both_mxu(q, _int8_cache(rng, b, hkv, s, d), lengths,
                       n_splits=n_splits, **kw)
    assert_rel_l2(to, jo, tol=TOL)
    assert np.all(to[0] == 0.0)


def test_mxu_needs_an_int8_cache():
    """mxu=True on an e4m3 cache raises, where JAX asserts."""
    rng = np.random.default_rng(8)
    x = jnp.asarray(rng.standard_normal((1, 1, 8, 16)), jnp.float32)
    vals, scales = map(_torch, jq.quantize_fp8_tokenwise(x, axis=-1))
    q = torch.zeros(1, 2, 16)
    lengths = torch.tensor([8], dtype=torch.int32)
    with pytest.raises(ValueError, match="int8"):
        tfd.flash_decode_int8(q, vals, scales, vals, scales, lengths, mxu=True)


def test_mxu_kernel_refuses_a_split_past_shared_memory():
    """The CUDA wrapper refuses a split whose scores and weights would not
    fit a block's shared memory beside the kernel's ring (JAX's 4096-key
    split fits at G = 8, at both widths), and raises before any launch."""
    for d in (64, 128):
        assert tfd._mxu_smem_bytes(8, d, 4096) <= tfd.H100_SMEM_PER_BLOCK
        assert tfd._mxu_smem_bytes(8, d, 4128) <= tfd.H100_SMEM_PER_BLOCK
        assert tfd._mxu_smem_bytes(8, d, 8192) > tfd.H100_SMEM_PER_BLOCK
    # the ring and the 5 G + 4 bytes a key of the split's arrays
    assert (tfd._mxu_smem_bytes(4, 128, 928) - tfd._mxu_smem_bytes(4, 128, 896)
            == 24 * 32)
    rng = np.random.default_rng(10)
    cache = tuple(map(_torch, _int8_cache(rng, 1, 1, 8192, 128)))
    q = torch.zeros(1, 8, 128, dtype=torch.bfloat16)
    lengths = torch.tensor([8192], dtype=torch.int32)
    for fn in (tfd._decode_mxu_cuda, tfd._decode_partials_mxu_cuda):
        with pytest.raises(ValueError, match="shared memory"):
            fn(q, *cache, lengths, 1, 8192, 0.1)


# cache lengths for the default split rule: short, tile and split edges, the
# serving and run_all.py lengths, and the longest the kernels take here
_MXU_RULE_S = (1, 31, 64, 100, 127, 128, 129, 928, 2048, 4095, 4096, 4097,
               8192, 8193, 16384, 32768, 65536)


@pytest.mark.parametrize("d", [64, 128])
def test_mxu_default_split_fits_shared_memory(d):
    """The default n_splits (`mxu_n_splits`) keeps a split's scores and
    weights in a block's shared memory for every B * Hkv from 1 to 1024, S
    up to 65536 and G in {1, 2, 4, 8}: the core rule's single split at
    B * Hkv >= 264 (8192 keys at G 4 need 232,960 bytes) no longer
    reaches the card's refusal."""
    for g in (1, 2, 4, 8):
        for pairs in range(1, 1025):
            for s in _MXU_RULE_S:
                n = tfd.mxu_n_splits(pairs, 1, s, g, d)
                assert n >= tfd._core_n_splits(pairs, 1, s)
                smem = tfd._mxu_smem_bytes(g, d, tfd.mxu_block_s(s, n))
                assert smem <= tfd.H100_SMEM_PER_BLOCK, (pairs, s, g, n)
                if n > tfd._core_n_splits(pairs, 1, s):  # the fewest that fit
                    fewer = tfd._mxu_smem_bytes(g, d, tfd.mxu_block_s(s, n - 1))
                    assert fewer > tfd.H100_SMEM_PER_BLOCK
    # the shapes the core rule sent past shared memory
    assert tfd._core_n_splits(66, 4, 8192) == 1
    assert tfd.mxu_n_splits(66, 4, 8192, 4, 128) == 2
    assert tfd.mxu_n_splits(32, 8, 16384, 4, 128) == 3


@pytest.mark.parametrize("d", [64, 128])
def test_mxu_default_split_unchanged_where_it_fit(d):
    """Where the core rule's split fits (every serving shape, B8 S8192's 9
    splits of 928), the default is the core rule itself, so the function,
    whose requantization groups are its splits, is unchanged there."""
    for g in (1, 2, 4, 8):
        for b, hkv in ((1, 1), (1, 4), (8, 4), (8, 8), (32, 4), (64, 4),
                       (65, 4), (256, 1)):
            for s in _MXU_RULE_S:
                core = tfd._core_n_splits(b, hkv, s)
                if tfd._mxu_smem_bytes(g, d, tfd.mxu_block_s(s, core)) \
                        <= tfd.H100_SMEM_PER_BLOCK:
                    assert tfd.mxu_n_splits(b, hkv, s, g, d) == core
    assert tfd.mxu_n_splits(8, 4, 8192, 4, 128) == 9


def _int8_pool(rng, b, hkv, d, page, max_pages, fmt="int8"):
    """A pool of b * max_pages + 1 pages (lane-major scale pages), each
    row's pages a permutation; JAX arrays."""
    n_pages = b * max_pages + 1
    quant = jq.quantize_int8 if fmt == "int8" else jq.quantize_fp8_tokenwise
    pools = []
    for _ in range(2):
        vals, scales = quant(jnp.asarray(rng.standard_normal(
            (n_pages, hkv, page, d)), jnp.float32), axis=-1)
        pools += [vals, jnp.swapaxes(scales, -1, -2)]
    table = (1 + rng.permutation(b * max_pages)).reshape(b, max_pages)
    return pools, table.astype(np.int32)


@pytest.mark.parametrize("g,d", [(1, 64), (2, 128), (4, 64), (8, 128)])
def test_q_int8_paged_decode_matches_jax(g, d):
    """paged_flash_decode_quant(q_int8=True): lengths 0, inside a page, on
    page edges and full."""
    rng = np.random.default_rng(20 + g)
    b, hkv, page, max_pages = 4, 2, 16, 5
    q = rng.standard_normal((b, g * hkv, d)).astype(np.float32)
    pools, table = _int8_pool(rng, b, hkv, d, page, max_pages)
    lengths = np.array([0, 7, 32, 80], np.int32)
    jo = jpd.paged_flash_decode_quant(jnp.asarray(q), *pools, jnp.asarray(table),
                                      jnp.asarray(lengths), q_int8=True,
                                      interpret=True)
    to = tpd.paged_flash_decode_quant(torch.from_numpy(q), *map(_torch, pools),
                                      torch.from_numpy(table),
                                      torch.from_numpy(lengths), q_int8=True)
    assert_rel_l2(to.numpy(), np.asarray(jo), tol=TOL)
    assert np.all(to.numpy()[0] == 0.0)


@pytest.mark.parametrize("case", ["e4m3", "gather=False"])
def test_q_int8_falls_back_as_jax_does(case):
    """JAX runs q_int8 only with gather=True over an int8 pool
    (paged_decode.py:1008): on e4m3 pages, or with gather=False, the result
    is q_int8=False's exactly, in both packages."""
    rng = np.random.default_rng(30)
    b, hq, hkv, d, page, max_pages = 3, 4, 2, 32, 16, 3
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    pools, table = _int8_pool(rng, b, hkv, d, page, max_pages,
                              "fp8" if case == "e4m3" else "int8")
    lengths = np.array([5, 33, 48], np.int32)
    kw = dict(gather=False) if case == "gather=False" else {}
    tq = torch.from_numpy(q)
    targs = (*map(_torch, pools), torch.from_numpy(table), torch.from_numpy(lengths))
    on = tpd.paged_flash_decode_quant(tq, *targs, q_int8=True, **kw)
    off = tpd.paged_flash_decode_quant(tq, *targs, q_int8=False, **kw)
    assert torch.equal(on, off)
    jargs = (jnp.asarray(q), *pools, jnp.asarray(table), jnp.asarray(lengths))
    jon = jpd.paged_flash_decode_quant(*jargs, q_int8=True, interpret=True, **kw)
    joff = jpd.paged_flash_decode_quant(*jargs, q_int8=False, interpret=True, **kw)
    np.testing.assert_array_equal(np.asarray(jon), np.asarray(joff))
    assert_rel_l2(on.numpy(), np.asarray(jon), tol=1e-4)


def test_cpu_tensors_leave_the_new_counters_at_zero():
    """The plain versions launch nothing: the int8 x int8 counters count
    kernel launches only."""
    before = (tfd.flash_decode_int8.mxu_launches,
              tpd.paged_flash_decode_quant.q_int8_launches)
    rng = np.random.default_rng(9)
    q = rng.standard_normal((2, 4, 16)).astype(np.float32)
    _both_mxu(q, _int8_cache(rng, 2, 2, 8, 16), np.array([8, 3], np.int32))
    assert (tfd.flash_decode_int8.mxu_launches,
            tpd.paged_flash_decode_quant.q_int8_launches) == before
