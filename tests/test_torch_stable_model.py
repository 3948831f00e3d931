"""The decoder with attn_stable=False (the fixed-max discipline) against the
JAX package's, in float32 on the CPU, at the JAX default config's head
shape (d_head 64, an even KV-head count: JAX's forward takes the packed
kernel 2, its extend the ragged fixed-max kernel) cut to 2 layers, d_model
128 and 2 KV heads: forward logits, the loss and every gradient, an SGD
step, prefill and extend logits, and the Scheduler token for token in its
default, prefill_chunk and 8-bit modes (the JAX kernels in interpret mode,
the port's wrappers on their plain versions)."""

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
from flashattention_kernel_project_tpu_torch.models.convert import params_from_jax
from flashattention_kernel_project_tpu_torch.models.serving import Scheduler
from flashattention_kernel_project_tpu_torch.ops import flash_attention as tfa
from flashattention_kernel_project_tpu_torch.utils.testing import assert_rel_l2

torch.set_num_threads(1)

TOL = 1e-4        # float32 on both sides (tests/test_torch_model.py)
GRAD_TOL = 1e-3   # each gradient leaf and the stepped params (tests/test_torch_train.py)
CPU = torch.device("cpu")
JCFG = jmodels.TransformerConfig(
    vocab_size=64, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
    d_head=64, d_ff=256, dtype=jnp.float32, block_q=32, block_k=32,
    attn_stable=False,
)
CFG = transformer.TransformerConfig(
    vocab_size=64, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
    d_head=64, d_ff=256, dtype=torch.float32, attn_stable=False,
)


@pytest.fixture(scope="module")
def both_params():
    jp = jmodels.init_params(JCFG, jax.random.PRNGKey(3))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), CPU)


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, size=shape,
                                                dtype=np.int32)


def test_the_config_takes_the_packed_forward():
    """At this head shape stable=False packs by default, as in JAX; the
    stable model does not."""
    x = torch.zeros(1, CFG.n_heads, 8, CFG.d_head)
    kv = torch.zeros(1, CFG.n_kv_heads, 8, CFG.d_head)
    assert tfa._options(x, kv, kv, True, CFG.attn_stable, None, 0, None, None)[3]
    assert not tfa._options(x, kv, kv, True, True, None, 0, None, None)[3]


def test_forward_matches_jax(both_params):
    jp, tp = both_params
    toks = _tokens(0, (2, 40))
    exp = np.asarray(jmodels.forward(JCFG, jp, jnp.asarray(toks)))
    got = transformer.forward(CFG, tp, torch.from_numpy(toks))
    assert_rel_l2(got.numpy(), exp, tol=TOL)
    # the fixed-max model computes the stable model's function
    stable = transformer.forward(dataclasses.replace(CFG, attn_stable=True), tp,
                                 torch.from_numpy(toks))
    assert_rel_l2(got.numpy(), stable.numpy(), tol=TOL)


def test_loss_gradients_and_a_step_match_jax(both_params):
    jp, tp = both_params
    toks = _tokens(1, (2, 40))
    jloss, jgrads = jax.value_and_grad(
        lambda p: jmodels.loss_fn(JCFG, p, jnp.asarray(toks)))(jp)
    flat = transformer._leaves
    leaves = {k: x.clone().requires_grad_(True) for k, x in flat(tp).items()}
    loss = transformer.loss_fn(CFG, transformer._unflatten(leaves),
                               torch.from_numpy(toks))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=TOL)
    jflat = flat(jax.tree.map(np.asarray, jgrads))
    for (name, _), g in zip(leaves.items(), grads):
        assert_rel_l2(g.numpy(), jflat[name], tol=GRAD_TOL, msg=name)
    new, loss = transformer.sgd_train_step(CFG, tp, torch.from_numpy(toks), 0.1)
    jnew, jl = jmodels.sgd_train_step(JCFG, jp, jnp.asarray(toks), lr=0.1)
    np.testing.assert_allclose(float(loss), float(jl), rtol=GRAD_TOL)
    jnew = flat(jax.tree.map(np.asarray, jnew))
    for name, x in flat(new).items():
        assert_rel_l2(x.numpy(), jnew[name], tol=GRAD_TOL, msg=name)


def test_prefill_and_extend_match_jax(both_params):
    """prefill (the packed forward) then a ragged extend (the ragged
    fixed-max forward): logits at every chunk position and the cache rows
    match the JAX engine's."""
    jp, tp = both_params
    toks, chunk = _tokens(2, (2, 12)), _tokens(3, (2, 7))
    n = np.array([7, 4], np.int32)
    jcache = jmodels.init_cache(JCFG, 2, 32)
    jl0, jcache = jmodels.prefill(JCFG, jp, jnp.asarray(toks), jcache)
    jl, jcache = jengine.extend(JCFG, jp, jnp.asarray(chunk), jcache,
                                n=jnp.asarray(n), all_logits=True)
    cache = engine.init_cache(CFG, 2, 32, CPU)
    tl0, _ = engine.prefill(CFG, tp, torch.from_numpy(toks), cache)
    tl, _ = engine.extend(CFG, tp, torch.from_numpy(chunk), cache,
                          n=torch.from_numpy(n), all_logits=True)
    assert_rel_l2(tl0.numpy(), np.asarray(jl0), tol=TOL)
    assert_rel_l2(tl.numpy(), np.asarray(jl), tol=TOL)
    np.testing.assert_array_equal(cache.lengths.numpy(), np.asarray(jcache.lengths))
    for i in range(CFG.n_layers):
        assert_rel_l2(cache.k[i].numpy(), np.asarray(jcache.k[i]), tol=TOL)


def _run(sched, prompts, max_new):
    uids = [sched.submit(p, max_new_tokens=max_new) for p in prompts]
    out = sched.run()
    return [out[u] for u in uids]


# kwargs, prompt lengths, max_new
SCHEDULER_CASES = {
    "default": (dict(), (14, 23, 6), 6),
    "prefill_chunk": (dict(prefill_chunk=8), (21, 13), 5),
    "int8_chunks": (dict(quantized_cache=True, prefill_chunk=8), (17, 11), 5),
}


@pytest.mark.parametrize("case", sorted(SCHEDULER_CASES))
def test_scheduler_matches_jax_scheduler(both_params, case):
    """The Scheduler serving the attn_stable=False model gives the JAX
    Scheduler's tokens in each mode."""
    jp, tp = both_params
    kwargs, lens, max_new = SCHEDULER_CASES[case]
    rng = np.random.default_rng(len(case))
    prompts = [rng.integers(0, CFG.vocab_size, size=n).astype(np.int32)
               for n in lens]
    kw = dict(max_batch=2, max_len=64, **kwargs)
    jout = _run(JScheduler(JCFG, jp, interpret=True, **kw), prompts, max_new)
    out = _run(Scheduler(CFG, tp, **kw), prompts, max_new)
    assert out == jout, (case, out, jout)
    assert all(len(o) == max_new for o in out)
