"""The port's model and engine against the JAX package's, on the same
(converted) parameters and tokens, in float32 on the CPU: forward logits,
prefill and decode-step logits, greedy generation token for token, the
in-place cache write, and the sampling filters."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattention_kernel_project_tpu import models as jmodels
from flashattention_kernel_project_tpu.models import engine as jengine
from flashattention_kernel_project_tpu_torch.models import engine, transformer
from flashattention_kernel_project_tpu_torch.models.convert import params_from_jax
from flashattention_kernel_project_tpu_torch.ops.flash_decode import flash_decode_int8
from flashattention_kernel_project_tpu_torch.utils.testing import assert_rel_l2

torch.set_num_threads(1)

TOL = 1e-4  # float32 on both sides
CPU = torch.device("cpu")
JCFG = jmodels.TransformerConfig(
    vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_head=16, d_ff=128, dtype=jnp.float32, block_q=32, block_k=32,
)
CFG = transformer.TransformerConfig(
    vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_head=16, d_ff=128, dtype=torch.float32,
)


@pytest.fixture(scope="module")
def both_params():
    jp = jmodels.init_params(JCFG, jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), CPU)


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, size=shape,
                                                dtype=np.int32)


def test_forward_matches_jax(both_params):
    jp, tp = both_params
    toks = _tokens(0, (2, 19))
    exp = np.asarray(jmodels.forward(JCFG, jp, jnp.asarray(toks)))
    got = transformer.forward(CFG, tp, torch.from_numpy(toks))
    assert got.dtype == torch.float32 and got.shape == (2, 19, CFG.vocab_size)
    assert_rel_l2(got.numpy(), exp, tol=TOL)


def test_prefill_and_decode_steps_match_jax(both_params):
    """prefill then decode steps on fused params: every step's logits match
    the JAX engine's, and the port's cache (updated in place) holds the
    same K/V rows and lengths."""
    jp, tp = both_params
    toks = _tokens(1, (2, 8))
    jcache = jmodels.init_cache(JCFG, 2, 16)
    jl, jcache = jmodels.prefill(JCFG, jp, jnp.asarray(toks), jcache)
    cache = engine.init_cache(CFG, 2, 16, CPU)
    tl, cache2 = engine.prefill(CFG, tp, torch.from_numpy(toks), cache)
    assert cache2 is cache
    assert_rel_l2(tl.numpy(), np.asarray(jl), tol=TOL)

    jfused = jmodels.fuse_decode_params(JCFG, jp)
    tfused = params_from_jax(jax.tree.map(np.asarray, jfused), CPU)
    cur = np.array(jnp.argmax(jl, -1), np.int32)
    for _ in range(3):
        jl, jcache = jmodels.decode_step(
            JCFG, jfused, jnp.asarray(cur), jcache, n_splits=2)
        tl, cache = engine.decode_step(
            CFG, tfused, torch.from_numpy(cur), cache, n_splits=2)
        assert_rel_l2(tl.numpy(), np.asarray(jl), tol=TOL)
        cur = np.array(jnp.argmax(jl, -1), np.int32)
    np.testing.assert_array_equal(cache.lengths.numpy(), [11, 11])
    for i in range(CFG.n_layers):
        assert_rel_l2(cache.k[i].numpy(), np.asarray(jcache.k[i]), tol=TOL)
        assert_rel_l2(cache.v[i].numpy(), np.asarray(jcache.v[i]), tol=TOL)


def test_decode_step_split_params_matches_fused(both_params):
    _, tp = both_params
    toks = torch.from_numpy(_tokens(2, (2, 6)))
    logits = []
    for params in (tp, engine.fuse_decode_params(CFG, tp)):
        cache = engine.init_cache(CFG, 2, 8, CPU)
        engine.prefill(CFG, tp, toks, cache)
        lg, _ = engine.decode_step(CFG, params, toks[:, -1], cache)
        logits.append(lg)
    torch.testing.assert_close(logits[0], logits[1], rtol=1e-5, atol=1e-5)


def test_generate_greedy_tokens_match_jax(both_params):
    jp, tp = both_params
    prompt = _tokens(3, (2, 8))
    exp = np.asarray(jmodels.generate(
        JCFG, jp, jnp.asarray(prompt), max_new_tokens=6, n_splits=2))
    got = engine.generate(CFG, tp, torch.from_numpy(prompt), max_new_tokens=6,
                          n_splits=2)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), exp)


@pytest.mark.parametrize("start", [[0, 3], [6, 7], [9, 40]])
def test_write_tokens_clamps_like_dynamic_update_slice(start):
    """The in-place write lands where jax.lax.dynamic_update_slice puts it,
    clamping a start past S - T so nothing is written past the buffer."""
    rng = np.random.default_rng(4)
    buf = rng.standard_normal((2, 2, 8, 4)).astype(np.float32)
    new = rng.standard_normal((2, 2, 2, 4)).astype(np.float32)
    lengths = np.asarray(start, np.int32)
    exp = np.asarray(jengine._write_tokens(
        jnp.asarray(buf), jnp.asarray(new), jnp.asarray(lengths)))
    got = torch.from_numpy(buf.copy())
    engine._write_tokens(got, torch.from_numpy(new), torch.from_numpy(lengths))
    np.testing.assert_array_equal(got.numpy(), exp)


def test_init_params_shapes_and_scales():
    gen = torch.Generator(device="cpu").manual_seed(0)
    p = transformer.init_params(CFG, gen, CPU)
    jshapes = jax.tree.map(
        lambda x: x.shape,
        jax.eval_shape(lambda: jmodels.init_params(JCFG, jax.random.PRNGKey(0))))
    assert jax.tree.map(lambda x: tuple(x.shape), p) == jshapes
    assert p["embed"].dtype == torch.float32
    assert abs(float(p["embed"].std()) - 0.02) < 2e-3
    assert abs(float(p["layers"]["wq"].std()) - CFG.d_model ** -0.5) < 0.02
    assert abs(float(p["layers"]["w_down"].std()) - CFG.d_ff ** -0.5) < 0.02
    torch.testing.assert_close(p["layers"]["rms_attn"], torch.ones(2, 64))


def test_convert_keeps_bf16():
    jp = {"w": jnp.arange(6, dtype=jnp.bfloat16).reshape(2, 3)}
    tp = params_from_jax(jax.tree.map(np.asarray, jp), CPU)
    assert tp["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tp["w"].float().numpy(),
                                  np.arange(6).reshape(2, 3))


def test_unported_model_options_raise():
    """return_partials, once unported (A.9), returns the folded partials of
    an empty cache: l = 0, y = 0, no NaN (tests/test_torch_parallel_mesh.py
    holds it to JAX)."""
    cache = engine.init_cache(CFG, 1, 8, CPU, quantized=True)
    m, l, y = flash_decode_int8(torch.zeros(1, CFG.n_heads, CFG.d_head),
                                cache.k[0], cache.k_scale[0], cache.v[0],
                                cache.v_scale[0], cache.lengths,
                                return_partials=True)
    g = CFG.n_heads // CFG.n_kv_heads
    assert m.shape == l.shape == (1, CFG.n_kv_heads, g, 1)
    assert y.shape == (1, CFG.n_kv_heads, g, CFG.d_head)
    assert (l == 0).all() and (y == 0).all() and torch.isfinite(m).all()


def test_sampling_top_k_top_p():
    """top-k keeps only the k best tokens; top-p keeps the smallest nucleus
    (and always holds the argmax); no generator means greedy."""
    logits = torch.log(torch.tensor([[0.5, 0.3, 0.15, 0.05]]))
    gen = torch.Generator().manual_seed(0)
    draws = {int(engine._sample(logits, 1.0, gen, top_k=2)[0]) for _ in range(64)}
    assert draws == {0, 1}
    draws_p = {int(engine._sample(logits, 1.0, gen, top_p=0.6)[0])
               for _ in range(64)}
    assert draws_p == {0, 1}
    draws_g = {int(engine._sample(logits, 1.0, gen, top_p=1e-6)[0])
               for _ in range(16)}
    assert draws_g == {0}
    assert int(engine._sample(logits, 1.0, None)[0]) == 0
    assert int(engine._sample(logits, 0.0, gen)[0]) == 0
