"""The port's MoE decoder (moe_experts = 8) against the JAX package's, on
the same (converted) parameters and tokens, in float32 on the CPU:
forward logits and the loss with its load-balancing term, three SGD
steps, greedy decoding token for token, a ragged extend (whose padded
positions take expert capacity), the paged decode and extend, a checkpoint
round trip, and the fused-layout paths that refuse MoE parameters as
JAX's do. Counterparts of tests/test_moe.py:135 and :150 at
tests/test_torch_model.py's size."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattention_kernel_project_tpu import models as jmodels
from flashattention_kernel_project_tpu.models import engine as jengine
from flashattention_kernel_project_tpu.models.serving import Scheduler as JScheduler
from flashattention_kernel_project_tpu_torch.models import engine, transformer
from flashattention_kernel_project_tpu_torch.models.checkpoint import (
    restore_checkpoint,
    save_checkpoint,
)
from flashattention_kernel_project_tpu_torch.models.convert import params_from_jax
from flashattention_kernel_project_tpu_torch.models.serving import Scheduler
from flashattention_kernel_project_tpu_torch.utils.testing import assert_rel_l2

torch.set_num_threads(1)

TOL = 1e-4  # float32 on both sides
CPU = torch.device("cpu")
SIZE = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_head=16, d_ff=128, moe_experts=8)
JCFG = jmodels.TransformerConfig(**SIZE, dtype=jnp.float32, block_q=32,
                                 block_k=32)
CFG = transformer.TransformerConfig(**SIZE, dtype=torch.float32)


# the JAX package's model functions, compiled once (eagerly each interpret
# -mode kernel call runs op by op)
jit_init = jax.jit(jmodels.init_params, static_argnums=0)
jit_forward = jax.jit(jmodels.forward, static_argnums=0)
jit_loss = jax.jit(jmodels.loss_fn, static_argnums=0)
jit_sgd = jax.jit(jmodels.sgd_train_step, static_argnums=0,
                  static_argnames="lr")


@pytest.fixture(scope="module")
def both_params():
    jp = jit_init(JCFG, jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), CPU)


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, size=shape,
                                                dtype=np.int32)


def _both(jcfg_kw):
    """The JAX and port configs with the same MoE fields replaced."""
    return (dataclasses.replace(JCFG, **jcfg_kw),
            dataclasses.replace(CFG, **jcfg_kw))


def test_init_params_moe_leaves(both_params):
    """The MoE layers hold a float32 router and cfg.dtype experts at their
    fan-in scales, and no SwiGLU weights, as JAX's init_params."""
    cfg = dataclasses.replace(CFG, dtype=torch.bfloat16, d_ff=256)
    p = transformer.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    assert set(p["layers"]) == set(both_params[0]["layers"])
    assert "w_gate" not in p["layers"] and "moe_w1" in p["layers"]
    L = p["layers"]
    assert L["moe_router"].dtype == torch.float32
    assert L["moe_router"].shape == (2, 64, 8)
    assert L["moe_w1"].dtype == L["moe_w2"].dtype == torch.bfloat16
    assert L["moe_w1"].shape == (2, 8, 64, 256)
    assert L["moe_w2"].shape == (2, 8, 256, 64)
    assert abs(float(L["moe_router"].std()) - 64 ** -0.5) < 0.01
    assert abs(float(L["moe_w1"].float().std()) - 64 ** -0.5) < 0.01
    assert abs(float(L["moe_w2"].float().std()) - 256 ** -0.5) < 0.01


def test_forward_and_loss_match_jax(both_params):
    """Logits and the loss (cross-entropy + 0.01 x the mean aux) within
    1e-4 of JAX's; moe_aux_weight 0 changes the loss in both packages, by
    the same amount."""
    jp, tp = both_params
    toks = _tokens(0, (2, 32))
    exp = np.asarray(jit_forward(JCFG, jp, jnp.asarray(toks)))
    got = transformer.forward(CFG, tp, torch.from_numpy(toks))
    assert got.shape == (2, 32, CFG.vocab_size) and torch.isfinite(got).all()
    assert_rel_l2(got.numpy(), exp, tol=TOL)
    jcfg0, cfg0 = _both(dict(moe_aux_weight=0.0))
    losses = []
    for jc, c in ((JCFG, CFG), (jcfg0, cfg0)):
        jl = float(jit_loss(jc, jp, jnp.asarray(toks)))
        tl = float(transformer.loss_fn(c, tp, torch.from_numpy(toks)))
        assert abs(tl - jl) <= TOL * abs(jl)
        losses.append((jl, tl))
    (j1, t1), (j0, t0) = losses
    assert t1 != t0 and abs((t1 - t0) - (j1 - j0)) <= 1e-5


def test_sgd_steps_match_jax(both_params):
    """Three sgd_train_steps at lr 0.1: every loss and every updated leaf,
    the float32 router included, within 1e-4 of JAX's, and the loss falls
    (tests/test_moe.py:150)."""
    jp, tp = both_params
    toks = _tokens(1, (2, 32))
    jt, tt = jnp.asarray(toks), torch.from_numpy(toks)
    losses = []
    for _ in range(3):
        jp, jl = jit_sgd(JCFG, jp, jt, lr=0.1)
        tp, tl = transformer.sgd_train_step(CFG, tp, tt, lr=0.1)
        assert abs(float(tl) - float(jl)) <= TOL * abs(float(jl))
        losses.append(float(tl))
    assert losses[-1] < losses[0]
    jflat = transformer._leaves(jax.tree.map(np.asarray, jp))
    tflat = transformer._leaves(tp)
    assert set(tflat) == set(jflat) and "layers.moe_router" in tflat
    for k, x in tflat.items():
        assert x.dtype == torch.float32
        assert_rel_l2(x.numpy(), jflat[k], tol=TOL)


def test_greedy_decode_matches_jax(both_params):
    """prefill then decode_steps on the split parameters: the same greedy
    tokens as the JAX engine, token for token, and every step's logits
    within 1e-4."""
    jp, tp = both_params
    toks = _tokens(2, (2, 8))
    jcache = jmodels.init_cache(JCFG, 2, 24)
    jl, jcache = jmodels.prefill(JCFG, jp, jnp.asarray(toks), jcache)
    cache = engine.init_cache(CFG, 2, 24, CPU)
    tl, cache = engine.prefill(CFG, tp, torch.from_numpy(toks), cache)
    assert_rel_l2(tl.numpy(), np.asarray(jl), tol=TOL)
    cur = np.array(jnp.argmax(jl, -1), np.int32)
    np.testing.assert_array_equal(tl.argmax(-1).numpy(), cur)
    jtoks, jcache = jengine.decode_steps(JCFG, jp, jnp.asarray(cur), jcache,
                                         n_steps=8)
    ttoks, cache = engine.decode_steps(CFG, tp, torch.from_numpy(cur), cache,
                                       n_steps=8)
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(cache.lengths.numpy(), [16, 16])
    jl, _ = jengine.decode_step(JCFG, jp, jtoks[:, -1], jcache)
    tl, _ = engine.decode_step(CFG, tp, ttoks[:, -1], cache)
    assert_rel_l2(tl.numpy(), np.asarray(jl), tol=TOL)


def test_ragged_extend_matches_jax(both_params):
    """A ragged extend (n = [5, 32] of a 32-token chunk) after a prefill:
    the last real position's logits and the cache rows within 1e-4 of
    JAX's. The first row's 27 padded positions are routed with the rest and
    take capacity ahead of the second row's tokens, as in JAX: at capacity
    factor 0.5 (8 slots an expert for 128 choices) that drops second-row
    choices that a routing of the real tokens alone would keep."""
    jp, tp = both_params
    jcfg, cfg = _both(dict(moe_capacity_factor=0.5))
    prompt, chunk = _tokens(3, (2, 8)), _tokens(4, (2, 32))
    n = np.array([5, 32], np.int32)
    jcache = jmodels.init_cache(jcfg, 2, 48)
    _, jcache = jmodels.prefill(jcfg, jp, jnp.asarray(prompt), jcache)
    jl, jcache = jengine.extend(jcfg, jp, jnp.asarray(chunk), jcache,
                                n=jnp.asarray(n))
    cache = engine.init_cache(cfg, 2, 48, CPU)
    engine.prefill(cfg, tp, torch.from_numpy(prompt), cache)
    tl, cache = engine.extend(cfg, tp, torch.from_numpy(chunk), cache,
                              n=torch.from_numpy(n))
    assert_rel_l2(tl.numpy(), np.asarray(jl), tol=TOL)
    np.testing.assert_array_equal(cache.lengths.numpy(), [13, 40])
    for i in range(cfg.n_layers):
        assert_rel_l2(cache.k[i][:, :, :40].numpy(),
                      np.asarray(jcache.k[i])[:, :, :40], tol=TOL)


def test_paged_decode_and_extend_match_jax(both_params):
    """paged_insert of two prefilled prompts, then three decode_step_paged
    steps and a 3-token extend_paged on the split parameters: the logits
    within 1e-4 of the JAX engine's, and decode_steps_paged runs on."""
    jp, tp = both_params
    page, max_pages, n_pages = 8, 4, 9
    toks = _tokens(5, (2, 11))
    tables = np.array([[6, 2, 8, 0], [1, 5, 3, 0]], np.int32)
    jcache = jengine.init_paged_cache(JCFG, 2, n_pages, page_size=page,
                                      max_pages_per_seq=max_pages)
    cache = engine.init_paged_cache(CFG, 2, n_pages, CPU, page_size=page,
                                    max_pages_per_seq=max_pages)
    for slot in range(2):
        jc1 = jmodels.init_cache(JCFG, 1, 16)
        _, jc1 = jmodels.prefill(JCFG, jp, jnp.asarray(toks[slot:slot + 1]), jc1)
        c1 = engine.init_cache(CFG, 1, 16, CPU)
        engine.prefill(CFG, tp, torch.from_numpy(toks[slot:slot + 1]), c1)
        jcache = jengine.paged_insert(
            jcache, slot, jnp.asarray(tables[slot]),
            tuple(x[0, :, :11] for x in jc1.k), tuple(x[0, :, :11] for x in jc1.v),
            11)
        engine.paged_insert(cache, slot, tables[slot],
                            [x[0, :, :11] for x in c1.k],
                            [x[0, :, :11] for x in c1.v], 11)
    cur = toks[:, -1].copy()
    for _ in range(3):
        jl, jcache = jengine.decode_step_paged(JCFG, jp, jnp.asarray(cur), jcache,
                                               interpret=True)
        tl, _ = engine.decode_step_paged(CFG, tp, torch.from_numpy(cur), cache)
        assert_rel_l2(tl.numpy(), np.asarray(jl), tol=TOL)
        cur = np.array(jnp.argmax(jl, -1), np.int32)
    chunk = _tokens(6, (2, 3))
    jl, jcache = jengine.extend_paged(JCFG, jp, jnp.asarray(chunk), jcache,
                                      interpret=True)
    tl, _ = engine.extend_paged(CFG, tp, torch.from_numpy(chunk), cache)
    assert tl.shape == (2, 3, CFG.vocab_size)
    assert_rel_l2(tl.numpy(), np.asarray(jl), tol=TOL)
    np.testing.assert_array_equal(cache.lengths.numpy(), [17, 17])
    toks_s, _ = engine.decode_steps_paged(CFG, tp, tl[:, -1].argmax(-1).int(),
                                          cache, n_steps=2)
    assert toks_s.shape == (2, 2) and int(cache.lengths[0]) == 19


def test_moe_checkpoint_round_trip(tmp_path):
    """A bf16 MoE tree saves and restores bit for bit, the router float32,
    and the saved config carries the MoE fields; a JAX MoE tree's leaves
    convert with their dtypes kept."""
    cfg = dataclasses.replace(CFG, dtype=torch.bfloat16, moe_top_k=1,
                              moe_capacity_factor=2.0)
    p = transformer.init_params(cfg, torch.Generator().manual_seed(1), CPU)
    path = save_checkpoint(str(tmp_path / "moe"), p, step=3, config=cfg)
    out = restore_checkpoint(path, params_template=p)
    flat, got = transformer._leaves(p), transformer._leaves(out["params"])
    assert set(got) == set(flat)
    for k, x in flat.items():
        assert got[k].dtype == x.dtype and torch.equal(got[k], x)
    assert got["layers.moe_router"].dtype == torch.float32
    saved = out["config"]
    assert (saved["moe_experts"], saved["moe_top_k"], saved["moe_capacity_factor"],
            saved["moe_aux_weight"]) == (8, 1, 2.0, 0.01)
    assert out["step"] == 3 and saved["dtype"] == "bfloat16"
    jlayers = {"moe_router": jnp.ones((2, 64, 8), jnp.float32),
               "moe_w1": jnp.ones((2, 8, 64, 128), jnp.bfloat16)}
    conv = params_from_jax(jax.tree.map(np.asarray, {"layers": jlayers}), CPU)
    assert conv["layers"]["moe_router"].dtype == torch.float32
    assert conv["layers"]["moe_w1"].dtype == torch.bfloat16


def test_fused_layout_paths_refuse_moe(both_params):
    """generate and the Scheduler build the fused decode layout, which has
    no MoE form: JAX's raise KeyError on an MoE tree, the port's a
    NotImplementedError that names the Scheduler that serves it
    (seq_mesh=), as JAX's does."""
    jp, tp = both_params
    prompt = _tokens(7, (1, 4))
    with pytest.raises(KeyError):
        jmodels.generate(JCFG, jp, jnp.asarray(prompt), max_new_tokens=2)
    with pytest.raises(KeyError):
        JScheduler(JCFG, jp, max_batch=1, max_len=32)
    with pytest.raises(KeyError):
        JScheduler(JCFG, jp, max_batch=1, max_len=32, paged=True, page_size=16)
    msg = "no MoE form.*seq_mesh"
    with pytest.raises(NotImplementedError, match=msg):
        engine.generate(CFG, tp, torch.from_numpy(prompt), max_new_tokens=2)
    with pytest.raises(NotImplementedError, match=msg):
        Scheduler(CFG, tp, max_batch=1, max_len=32)
    with pytest.raises(NotImplementedError, match=msg):
        Scheduler(CFG, tp, max_batch=1, max_len=32, paged=True, page_size=16)
    for fn in (engine.fuse_decode_params, engine.quantize_decode_params):
        with pytest.raises(NotImplementedError, match=msg):
            fn(CFG, tp)
