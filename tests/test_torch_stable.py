"""The port's softmax disciplines against the JAX package's, in float32 on
the CPU (the JAX kernels in interpret mode, the port's wrappers on their
plain versions): stable=False (fixed-max) with its O, LSE, gradients and
loud overflow; stable="auto" (the per-block hybrid) on bounded inputs, on
inputs that breach the fixed-max range and on mixed blocks, with and
without a cached k_max; the packed d=64 forward (kernel 2); the dense
8-bit forward in each discipline; and the ragged fixed-max forward over
bf16 and 8-bit caches. tests/test_flash_attention.py:37-264 on the port."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattention_kernel_project_tpu_torch.models.convert import params_from_jax
from flashattention_kernel_project_tpu_torch.ops import flash_attention as tfa
from flashattention_kernel_project_tpu_torch.utils.oracles import gqa_attention
from flashattention_kernel_project_tpu_torch.utils.testing import assert_rel_l2

jfa = importlib.import_module("flashattention_kernel_project_tpu.ops.flash_attention")
jq = importlib.import_module("flashattention_kernel_project_tpu.ops.quant")

torch.set_num_threads(1)

TOL = 1e-4        # float32 on both sides (tests/test_torch_ops.py)
GRAD_TOL = 1e-3   # gradients, through the log2(e) fold (tests/test_torch_backward.py)
SAME_TOL = 1e-6   # "auto" against stable=True where every block runs online
BLK = 16          # the JAX kernels' blocks
CPU = torch.device("cpu")


def _inputs(seed, b, hq, hkv, n, s, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32) for shape in
                 ((b, hq, n, d), (b, hkv, s, d), (b, hkv, s, d)))


def _jax_with_lse(q, k, v, **kw):
    o, lse = jfa.flash_attention_with_lse(
        *map(jnp.asarray, (q, k, v)), block_q=BLK, block_k=BLK, interpret=True,
        **kw)
    return np.asarray(o), np.asarray(lse)


def _port_with_lse(q, k, v, **kw):
    o, lse = tfa.flash_attention_with_lse(*map(torch.from_numpy, (q, k, v)), **kw)
    return o.numpy(), lse.numpy()


def _port(q, k, v, **kw):
    return tfa.flash_attention(*map(torch.from_numpy, (q, k, v)), **kw).numpy()


# b, hq, hkv, n, s, d, causal, q_offset, window, sinks. d = 16 and d = 32
# keep JAX on kernel 1 (its d=64 default packs the heads: kernel 2 below).
FIXED_CASES = {
    "full": (1, 4, 2, 48, 64, 16, False, 0, None, 0),
    "causal": (1, 4, 2, 64, 64, 32, True, 0, None, 0),
    "tail": (2, 2, 1, 40, 56, 16, True, 16, None, 0),
    "negative_offset": (1, 2, 1, 24, 40, 16, True, -8, None, 0),
    "window_sinks": (1, 4, 2, 64, 64, 16, True, 0, 12, 3),
}


@pytest.mark.parametrize("case", sorted(FIXED_CASES))
def test_fixed_max_matches_jax(case):
    """stable=False: O and LSE against the JAX fixed-max kernel and O
    against the float64 oracle; a row that sees no key gives 0 and
    NEG_INF, as the online discipline does."""
    b, hq, hkv, n, s, d, causal, q_offset, window, sinks = FIXED_CASES[case]
    q, k, v = _inputs(0, b, hq, hkv, n, s, d)
    kw = dict(causal=causal, q_offset=q_offset, window=window, sinks=sinks,
              stable=False)
    jo, jl = _jax_with_lse(q, k, v, **kw)
    to, tl = _port_with_lse(q, k, v, **kw)
    assert_rel_l2(to, jo, tol=TOL)
    live = jl > -1e29
    np.testing.assert_allclose(tl[live], jl[live], rtol=TOL, atol=TOL)
    so, sl = _port_with_lse(q, k, v, **dict(kw, stable=True))
    np.testing.assert_allclose(tl, sl, rtol=TOL, atol=TOL)
    assert_rel_l2(to, so, tol=TOL)
    if window is None:
        assert_rel_l2(to, gqa_attention(q, k, v, causal=causal, q_offset=q_offset),
                      tol=TOL)
    if q_offset < 0:
        assert not to[:, :, :-q_offset].any()
        assert (tl[:, :, :-q_offset] == sl[:, :, :-q_offset]).all()


@pytest.mark.parametrize("stable", [False, "auto"])
def test_gradients_match_jax(stable):
    """The backward re-centres on the saved LSE, so the gradients through
    the fixed-max and hybrid forwards are JAX's."""
    q, k, v = _inputs(1, 1, 4, 2, 48, 48, 32)
    kw = dict(causal=True, stable=stable)

    def jloss(q, k, v):
        o = jfa.flash_attention(q, k, v, block_q=BLK, block_k=BLK,
                                interpret=True, **kw)
        return jnp.sum(o * jnp.cos(o))

    exp = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    o = tfa.flash_attention(*ts, **kw)
    got = torch.autograd.grad((o * torch.cos(o)).sum(), ts)
    for name, g, e in zip(("dq", "dk", "dv"), got, exp):
        assert_rel_l2(g.numpy(), np.asarray(e), tol=GRAD_TOL, msg=name)


def test_fixed_max_overflow_is_loud():
    """tests/test_flash_attention.py:70-93: logits far outside the
    contract overflow exp2 and the fixed-max output fails loudly
    (non-finite, or rel-L2 >= 5e-3), while stable=True holds."""
    q, k, v = _inputs(2, 1, 2, 2, 64, 128, 32)
    q = q * 40.0
    exp = gqa_attention(q, k, v)
    assert_rel_l2(_port(q, k, v, stable=True), exp, tol=TOL)
    fast = _port(q, k, v, stable=False)
    err = np.linalg.norm(fast - exp) / np.linalg.norm(exp)
    assert (not np.isfinite(fast).all()) or err >= 5e-3, err


@pytest.mark.parametrize("causal", [False, True])
def test_auto_matches_oracle_on_bounded_inputs(causal):
    """stable="auto" on in-contract inputs runs fixed-max in every block
    and matches JAX's hybrid (O and LSE) and the oracle."""
    q, k, v = _inputs(3, 1, 4, 2, 48, 80, 32)
    kw = dict(causal=causal, stable="auto")
    pinned = tfa._fixed_rows(torch.from_numpy(q), 32 ** -0.5, tfa.HYBRID,
                             tfa.k_max_norm(torch.from_numpy(k)))
    assert pinned.all()  # every block proved in range
    jo, jl = _jax_with_lse(q, k, v, **kw)
    to, tl = _port_with_lse(q, k, v, **kw)
    assert_rel_l2(to, jo, tol=TOL)
    np.testing.assert_allclose(tl, jl, rtol=TOL, atol=TOL)
    assert_rel_l2(to, gqa_attention(q, k, v, causal=causal), tol=TOL)


@pytest.mark.parametrize("scale", [60.0, -60.0])
def test_auto_equals_stable_on_a_range_breach(scale):
    """tests/test_flash_attention.py:117-135: with q x +-60 every block's
    bound breaches, so "auto" runs the online discipline throughout and
    equals stable=True; the JAX hybrid agrees."""
    q, k, v = _inputs(4, 1, 2, 2, 64, 96, 32)
    q = q * scale
    auto = _port(q, k, v, causal=True, stable="auto")
    safe = _port(q, k, v, causal=True, stable=True)
    assert np.isfinite(auto).all()
    assert_rel_l2(auto, safe, tol=SAME_TOL)
    jauto, _ = _jax_with_lse(q, k, v, causal=True, stable="auto")
    assert_rel_l2(auto, jauto, tol=TOL)


def test_auto_mixed_blocks():
    """tests/test_flash_attention.py:138-153: one block of rows breaches,
    the others stay bounded; the hybrid runs online on exactly that block
    and matches stable=True (and JAX's hybrid, whose blocks are 16 rows
    here too)."""
    q, k, v = _inputs(5, 1, 2, 2, 64, 64, 32)
    q[:, :, :16] *= 60.0
    pinned = tfa._fixed_rows(torch.from_numpy(q), 32 ** -0.5, tfa.HYBRID,
                             tfa.k_max_norm(torch.from_numpy(k)))[..., 0]
    assert not pinned[:, :, :16].any() and pinned[:, :, 16:].all()
    auto = _port(q, k, v, causal=True, stable="auto")
    safe = _port(q, k, v, causal=True, stable=True)
    assert np.isfinite(auto).all()
    assert_rel_l2(auto, safe, tol=SAME_TOL)
    jauto, _ = _jax_with_lse(q, k, v, causal=True, stable="auto")
    assert_rel_l2(auto, jauto, tol=TOL)


def test_auto_cached_k_max():
    """tests/test_flash_attention.py:175-201: k_max_norm(k) passed in gives
    the bit-equal output; an over-estimate stays correct; gradients flow
    to q, k and v and match JAX's, and k_max gets none."""
    q, k, v = _inputs(6, 1, 4, 2, 64, 64, 32)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    kw = dict(causal=True, stable="auto")
    np.testing.assert_allclose(tfa.k_max_norm(tk).numpy(),
                               np.asarray(jfa.k_max_norm(jnp.asarray(k))),
                               rtol=1e-6)
    plain = tfa.flash_attention(tq, tk, tv, **kw)
    cached = tfa.flash_attention(tq, tk, tv, k_max=tfa.k_max_norm(tk), **kw)
    assert torch.equal(plain, cached)
    over = tfa.flash_attention(tq, tk, tv, k_max=1e6, **kw)
    assert_rel_l2(over.numpy(), gqa_attention(q, k, v, causal=True), tol=TOL)

    def jloss(q, k, v):
        o = jfa.flash_attention(q, k, v, block_q=BLK, block_k=BLK, interpret=True,
                                k_max=jfa.k_max_norm(k), **kw)
        return jnp.sum(o * jnp.cos(o))

    exp = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    ts = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    k_max = tfa.k_max_norm(tk).requires_grad_(True)
    o = tfa.flash_attention(*ts, k_max=k_max, **kw)
    got = torch.autograd.grad((o * torch.cos(o)).sum(), ts + [k_max],
                              allow_unused=True)
    assert got[3] is None
    for name, g, e in zip(("dq", "dk", "dv"), got, exp):
        assert_rel_l2(g.numpy(), np.asarray(e), tol=GRAD_TOL, msg=name)


@pytest.mark.parametrize("hkv", [2, 4])
@pytest.mark.parametrize("causal", [False, True])
def test_packed_matches_jax(hkv, causal):
    """Kernel 2: the d=64 fixed-max forward against JAX `_fwd_packed`,
    O and LSE; flash_attention(stable=False) takes it by default at d = 64
    with an even KV-head count, as JAX does."""
    q, k, v = _inputs(7, 1, 2 * hkv, hkv, 40, 72, 64)
    jo, jl = jfa._fwd_packed(*map(jnp.asarray, (q, k, v)), causal, None, 8,
                             BLK, BLK, True)
    to, tl = tfa._fwd(*map(torch.from_numpy, (q, k, v)), causal, None, 8,
                      disc=tfa.FIXED, pack=True)
    assert_rel_l2(to.numpy(), np.asarray(jo), tol=TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    assert tfa._options(tq, tk, tv, causal, False, None, 0, None, None)[3]
    for stable in (True, "auto"):
        assert not tfa._options(tq, tk, tv, causal, stable, None, 0, None, None)[3]
    got = _port(q, k, v, causal=causal, q_offset=8, stable=False)
    assert_rel_l2(got, to.numpy(), tol=0.0)


def test_pack_heads_errors():
    """pack_heads=True raises ValueError where JAX asserts: a discipline
    other than stable=False, an 8-bit cache, d != 64, an odd KV-head
    count."""
    x64 = [torch.zeros(1, 4, 8, 64), torch.zeros(1, 2, 8, 64), torch.zeros(1, 2, 8, 64)]
    for stable in (True, "auto"):
        with pytest.raises(ValueError):
            tfa.flash_attention(*x64, stable=stable, pack_heads=True)
    q8, s8 = torch.zeros(1, 2, 8, 64, dtype=torch.int8), torch.ones(1, 2, 8, 1)
    with pytest.raises(TypeError):  # the 8-bit forward takes no pack_heads
        tfa.flash_attention_kv_quant(x64[0], q8, s8, q8, s8, stable=False,
                                     pack_heads=True)
    x32 = [torch.zeros(1, 4, 8, 32), torch.zeros(1, 2, 8, 32), torch.zeros(1, 2, 8, 32)]
    odd = [torch.zeros(1, 3, 8, 64), torch.zeros(1, 3, 8, 64), torch.zeros(1, 3, 8, 64)]
    for x in (x32, odd):
        with pytest.raises(ValueError):
            tfa.flash_attention(*x, stable=False, pack_heads=True)
        with pytest.raises(ValueError):
            tfa.flash_attention_with_lse(*x, stable=False, pack_heads=True)
    with pytest.raises(ValueError):
        tfa.flash_attention(*x64, stable="fast")
    # pack_heads=False keeps kernel 1's fixed-max path: the same function
    a = tfa.flash_attention(*x64, stable=False, pack_heads=False)
    assert torch.equal(a, tfa.flash_attention(*x64, stable=False))
    # the packed forward is the fixed-max d=64 one
    for disc in (tfa.ONLINE, tfa.HYBRID):
        with pytest.raises(ValueError):
            tfa._fwd(*x64, True, None, 0, disc=disc, pack=True)
    with pytest.raises(ValueError):
        tfa._fwd(*x32, True, None, 0, disc=tfa.FIXED, pack=True)


def test_hybrid_needs_k_max():
    """The kernels' hybrid reads k_max on the device: the CUDA wrappers
    refuse a missing or malformed one before the launch, and the other
    disciplines read none."""
    q = torch.zeros(1, 2, 8, 64)
    for k_max in (None, torch.ones(2), torch.ones((), dtype=torch.float64)):
        with pytest.raises(ValueError):
            tfa._check_k_max(q, tfa.HYBRID, k_max)
    tfa._check_k_max(q, tfa.HYBRID, torch.ones(()))
    for disc in (tfa.ONLINE, tfa.FIXED):
        tfa._check_k_max(q, disc, None)


def _quantize(x, fmt):
    """The JAX package's per-token quantizer: (values, scales)."""
    fn = jq.quantize_fp8_tokenwise if fmt == "fp8" else jq.quantize_int8
    vals, scales = fn(jnp.asarray(x), axis=-1)
    return np.asarray(vals), np.asarray(scales, np.float32)


def _quant_inputs(seed, fmt, q_scale=1.0):
    q, k, v = _inputs(seed, 1, 4, 2, 48, 64, 32)
    (kq, ks), (vq, vs) = _quantize(k, fmt), _quantize(v, fmt)
    return q * q_scale, (kq, ks, vq, vs)


@pytest.mark.parametrize("stable", [True, False, "auto"])
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_kv_quant_matches_jax(fmt, stable):
    """The dense 8-bit forward (flash_attention_kv_quant and _with_lse)
    against JAX's, O and LSE, in each discipline, and against the oracle
    on the dequantized cache."""
    q, cache = _quant_inputs(8, fmt)
    kw = dict(causal=True, stable=stable, q_offset=16)
    jo, jl = jfa.flash_attention_kv_quant_with_lse(
        jnp.asarray(q), *map(jnp.asarray, cache), block_q=BLK, block_k=BLK,
        interpret=True, **kw)
    tcache = [params_from_jax(x, CPU) for x in cache]
    to, tl = tfa.flash_attention_kv_quant_with_lse(torch.from_numpy(q), *tcache, **kw)
    assert_rel_l2(to.numpy(), np.asarray(jo), tol=TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    o = tfa.flash_attention_kv_quant(torch.from_numpy(q), *tcache, **kw)
    assert torch.equal(o, to)
    kd, vd = (tcache[0].float() * tcache[1]).numpy(), (tcache[2].float() * tcache[3]).numpy()
    assert_rel_l2(to.numpy(), gqa_attention(q, kd, vd, causal=True, q_offset=16),
                  tol=TOL)


def test_kv_quant_auto_breach():
    """tests/test_flash_attention.py:237-253: q x 60 over an int8 cache;
    the bound covers the dequantized keys (squares in float32, no int8
    wrap), so every block runs online and "auto" equals stable=True."""
    q, cache = _quant_inputs(9, "int8", q_scale=60.0)
    tcache = [params_from_jax(x, CPU) for x in cache]
    tq = torch.from_numpy(q)
    auto = tfa.flash_attention_kv_quant(tq, *tcache, causal=True, stable="auto")
    safe = tfa.flash_attention_kv_quant(tq, *tcache, causal=True, stable=True)
    assert torch.isfinite(auto).all()
    assert_rel_l2(auto.numpy(), safe.numpy(), tol=SAME_TOL)
    # the wrapped int8 bound would certify these blocks; the float32 one does not
    k_max = tfa.k_max_norm(tcache[0], tcache[1])
    assert not tfa._fixed_rows(tq, 32 ** -0.5, tfa.HYBRID, k_max).any()
    jauto = jfa.flash_attention_kv_quant(jnp.asarray(q), *map(jnp.asarray, cache),
                                         causal=True, stable="auto",
                                         block_q=BLK, block_k=BLK, interpret=True)
    assert_rel_l2(auto.numpy(), np.asarray(jauto), tol=TOL)


def _ragged_inputs(seed, d=32):
    """A chunk of 20 queries against a cache of 72 rows: a fresh prompt, a
    chunk at offset 40, an empty row."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((3, 4, 20, d)).astype(np.float32)
    k = rng.standard_normal((3, 2, 72, d)).astype(np.float32)
    v = rng.standard_normal((3, 2, 72, d)).astype(np.float32)
    return q, k, v, np.array([20, 60, 0], np.int32), np.array([0, 40, 0], np.int32)


@pytest.mark.parametrize("window", [None, 12])
def test_ragged_fixed_max_matches_jax(window):
    q, k, v, kv_lens, q_offsets = _ragged_inputs(10)
    kw = dict(causal=True, window=window, sinks=3 if window else 0)
    jo = jfa.flash_attention_ragged(
        *map(jnp.asarray, (q, k, v, kv_lens, q_offsets)), block_q=BLK,
        block_k=BLK, interpret=True, stable=False, **kw)
    args = tuple(map(torch.from_numpy, (q, k, v, kv_lens, q_offsets)))
    to = tfa.flash_attention_ragged(*args, stable=False, **kw)
    assert_rel_l2(to.numpy(), np.asarray(jo), tol=TOL)
    assert not to[2].any()  # kv_len 0 -> zeros
    assert_rel_l2(to.numpy(), tfa.flash_attention_ragged(*args, **kw).numpy(),
                  tol=TOL)
    auto = tfa.flash_attention_ragged(*args, stable="auto", **kw)
    assert torch.equal(auto, tfa.flash_attention_ragged(*args, **kw))


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_ragged_8bit_fixed_max_matches_jax(fmt):
    q, k, v, kv_lens, q_offsets = _ragged_inputs(11)
    cache = (*_quantize(k, fmt), *_quantize(v, fmt))
    jo = jfa.flash_attention_ragged_kv_quant(
        *map(jnp.asarray, (q, *cache, kv_lens, q_offsets)), block_q=BLK,
        block_k=BLK, interpret=True, stable=False)
    to = tfa.flash_attention_ragged_kv_quant(
        torch.from_numpy(q), *(params_from_jax(x, CPU) for x in cache),
        *map(torch.from_numpy, (kv_lens, q_offsets)), stable=False)
    assert_rel_l2(to.numpy(), np.asarray(jo), tol=TOL)


def test_cpu_tensors_leave_the_new_counters_at_zero():
    """Every discipline's CPU call runs the plain version: no counter of
    the forwards moves."""
    def counts():
        return [getattr(fn, a) for fn in (tfa._fwd, tfa.flash_attention_ragged,
                                          tfa.flash_attention_ragged_kv_quant,
                                          tfa.flash_attention_kv_quant)
                for a in dir(fn) if a.endswith("launches")]

    before = counts()
    q, k, v = (torch.from_numpy(x) for x in _inputs(12, 1, 4, 2, 16, 16, 64))
    for stable in (True, False, "auto"):
        tfa.flash_attention(q, k, v, causal=True, stable=stable)
    assert counts() == before and not any(before)
