"""The port's 8-bit KV caches in the engine and the Scheduler against the
JAX package's, in float32 on the CPU (the JAX kernels in interpret mode,
the port's wrappers on their plain versions): the linear and the paged
8-bit engine, generation with int8 and e4m3 caches and int8 weights, the
converted 8-bit parameters, and the Scheduler with quantized_cache=True in
every mode the port serves, token for token."""

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
from flashattention_kernel_project_tpu_torch.utils.testing import assert_rel_l2

torch.set_num_threads(1)

TOL = 1e-4  # float32 on both sides
CPU = torch.device("cpu")
# the tiny config of tests/test_torch_serving.py, and the one-layer draft of
# tests/test_serving.py's speculative cases
JCFG = jmodels.TransformerConfig(
    vocab_size=64, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_head=16, d_ff=128, dtype=jnp.float32, block_q=32, block_k=32,
)
CFG = transformer.TransformerConfig(
    vocab_size=64, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_head=16, d_ff=128, dtype=torch.float32,
)
JDRAFT = dataclasses.replace(JCFG, n_layers=1, d_ff=64)
DRAFT = dataclasses.replace(CFG, n_layers=1, d_ff=64)


def _to_torch(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree), CPU)


@pytest.fixture(scope="module")
def both_params():
    jp = jmodels.init_params(JCFG, jax.random.PRNGKey(0))
    jd = jmodels.init_params(JDRAFT, jax.random.PRNGKey(99))
    return jp, _to_torch(jp), jd, _to_torch(jd)


def _dequantized(vals, scales):
    """A cache's (or pool's) float32 content: values times their scales
    (lane-major scale pages transposed back)."""
    vals, scales = np.asarray(vals).astype(np.float32), np.asarray(scales)
    if scales.shape[-2] == 1 and vals.shape[-2] != 1:
        scales = np.swapaxes(scales, -1, -2)
    return vals * scales


def _assert_same_cache(vals, scales, jvals, jscales):
    """The same 8-bit content as the JAX buffers, within float32 rounding
    (a token whose K/V differ by one rounding may round to a neighbouring
    8-bit value)."""
    assert vals.dtype == params_from_jax(np.asarray(jvals), CPU).dtype
    assert_rel_l2(_dequantized(vals.float().numpy(), scales.numpy()),
                  _dequantized(jvals, jscales), tol=TOL)


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_linear_8bit_engine_matches_jax(both_params, fmt):
    """prefill into an 8-bit cache, a ragged extend chunk (the 8-bit ragged
    forward) and two decode steps (the 8-bit decode): caches and logits
    match the JAX engine's."""
    jp, tp, _, _ = both_params
    rng = np.random.default_rng(0)
    toks = rng.integers(0, CFG.vocab_size, size=(2, 16)).astype(np.int32)
    jcache = jmodels.init_cache(JCFG, 2, 48, quantized=True, quant_fmt=fmt)
    cache = engine.init_cache(CFG, 2, 48, CPU, quantized=True, quant_fmt=fmt)
    assert cache.quantized and cache.k_scale[0].shape == (2, 2, 48, 1)
    jl, jcache = jmodels.prefill(JCFG, jp, jnp.asarray(toks[:, :10]), jcache)
    tl, out = engine.prefill(CFG, tp, torch.from_numpy(toks[:, :10]), cache)
    assert out is cache
    assert_rel_l2(tl.numpy(), np.asarray(jl), tol=TOL)
    n = np.array([6, 4], np.int32)  # a ragged chunk: row 1's tail is padding
    jl, jcache = jengine.extend(JCFG, jp, jnp.asarray(toks[:, 10:]), jcache,
                                n=jnp.asarray(n), interpret=True)
    tl, _ = engine.extend(CFG, tp, torch.from_numpy(toks[:, 10:]), cache,
                          n=torch.from_numpy(n))
    assert_rel_l2(tl.numpy(), np.asarray(jl), tol=TOL)
    fused = engine.fuse_decode_params(CFG, tp)
    jfused = jmodels.fuse_decode_params(JCFG, jp)
    cur = np.array(jnp.argmax(jl, -1), np.int32)
    for _ in range(2):
        jl, jcache = jmodels.decode_step(JCFG, jfused, jnp.asarray(cur), jcache,
                                         n_splits=2, interpret=True)
        tl, _ = engine.decode_step(CFG, fused, torch.from_numpy(cur), cache,
                                   n_splits=2)
        assert_rel_l2(tl.numpy(), np.asarray(jl), tol=TOL)
        cur = np.array(jnp.argmax(jl, -1), np.int32)
    np.testing.assert_array_equal(cache.lengths.numpy(), [18, 16])
    for i in range(CFG.n_layers):
        _assert_same_cache(cache.k[i], cache.k_scale[i], jcache.k[i],
                           jcache.k_scale[i])
        _assert_same_cache(cache.v[i], cache.v_scale[i], jcache.v[i],
                           jcache.v_scale[i])


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_paged_8bit_engine_matches_jax(both_params, fmt):
    """paged_insert of two prefilled prompts into an 8-bit pool (the second
    sharing the first's first page through start_page), cache_from_pages of
    that page (dequantized), two decode_step_paged steps and one
    extend_paged chunk: pools, gathered rows and logits match the JAX
    engine's."""
    jp, tp, _, _ = both_params
    page, max_pages, n_pages = 8, 4, 9
    rng = np.random.default_rng(1)
    toks = rng.integers(0, CFG.vocab_size, size=(2, 11)).astype(np.int32)
    toks[1, :page] = toks[0, :page]
    tables = np.array([[6, 2, 8, 0], [6, 5, 3, 0]], np.int32)
    kw = dict(page_size=page, max_pages_per_seq=max_pages, quantized=True,
              quant_fmt=fmt)
    jcache = jengine.init_paged_cache(JCFG, 2, n_pages, **kw)
    cache = engine.init_paged_cache(CFG, 2, n_pages, CPU, **kw)
    assert cache.quantized and cache.k_scale_pages[0].shape == (n_pages, 2, 1, page)
    for slot in range(2):
        jc1 = jmodels.init_cache(JCFG, 1, 16)
        _, jc1 = jmodels.prefill(JCFG, jp, jnp.asarray(toks[slot:slot + 1]), jc1)
        c1 = engine.init_cache(CFG, 1, 16, CPU)
        engine.prefill(CFG, tp, torch.from_numpy(toks[slot:slot + 1]), c1)
        jcache = jengine.paged_insert(
            jcache, slot, jnp.asarray(tables[slot]),
            tuple(x[0, :, :11] for x in jc1.k), tuple(x[0, :, :11] for x in jc1.v),
            11, start_page=slot)
        engine.paged_insert(cache, slot, tables[slot],
                            [x[0, :, :11] for x in c1.k],
                            [x[0, :, :11] for x in c1.v], 11, start_page=slot)

    def same_pools():
        for i in range(CFG.n_layers):  # page 0 is junk
            _assert_same_cache(cache.k_pages[i][1:], cache.k_scale_pages[i][1:],
                               jcache.k_pages[i][1:], jcache.k_scale_pages[i][1:])
            _assert_same_cache(cache.v_pages[i][1:], cache.v_scale_pages[i][1:],
                               jcache.v_pages[i][1:], jcache.v_scale_pages[i][1:])

    same_pools()
    # rows past a prompt's length in its last page: zero values and scales
    assert not cache.k_pages[0][2, :, 11 - page:].float().any()
    assert not cache.k_scale_pages[0][2, :, :, 11 - page:].any()

    jlin = jengine.cache_from_pages(JCFG, jcache, [6], page, 16)
    lin = engine.cache_from_pages(CFG, cache, [6], page, 16)
    assert not lin.quantized and int(lin.lengths[0]) == page
    for i in range(CFG.n_layers):
        assert_rel_l2(lin.k[i].numpy(), np.asarray(jlin.k[i]), tol=TOL)
        assert_rel_l2(lin.v[i].numpy(), np.asarray(jlin.v[i]), tol=TOL)

    jfused = jmodels.fuse_decode_params(JCFG, jp)
    tfused = engine.fuse_decode_params(CFG, tp)
    cur = toks[:, -1].copy()
    for _ in range(2):
        jl, jcache = jengine.decode_step_paged(JCFG, jfused, jnp.asarray(cur),
                                               jcache, interpret=True)
        tl, _ = engine.decode_step_paged(CFG, tfused, torch.from_numpy(cur), cache)
        assert_rel_l2(tl.numpy(), np.asarray(jl), tol=TOL)
        cur = np.array(jnp.argmax(jl, -1), np.int32)
    chunk = rng.integers(0, CFG.vocab_size, size=(2, 3)).astype(np.int32)
    jl, jcache = jengine.extend_paged(JCFG, jp, jnp.asarray(chunk), jcache,
                                      interpret=True)
    tl, _ = engine.extend_paged(CFG, tp, torch.from_numpy(chunk), cache)
    assert tl.shape == (2, 3, CFG.vocab_size)
    assert_rel_l2(tl.numpy(), np.asarray(jl), tol=TOL)
    np.testing.assert_array_equal(cache.lengths.numpy(), [16, 16])
    same_pools()


@pytest.mark.parametrize("kw", [
    dict(quantized_cache=True),
    dict(quantized_cache=True, quant_fmt="fp8"),
    dict(int8_weights=True),
    dict(quantized_cache=True, int8_weights=True),
], ids=["int8_cache", "fp8_cache", "int8_weights", "int8_both"])
def test_generate_8bit_matches_jax(both_params, kw):
    jp, tp, _, _ = both_params
    prompt = np.random.default_rng(2).integers(
        0, CFG.vocab_size, size=(2, 8)).astype(np.int32)
    jout = jmodels.generate(JCFG, jp, jnp.asarray(prompt), max_new_tokens=6,
                            n_splits=2, **kw)
    out = engine.generate(CFG, tp, torch.from_numpy(prompt), max_new_tokens=6,
                          n_splits=2, **kw)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_quantized_decode_params_match_jax(both_params, fmt):
    """quantize_decode_params bit for bit against the JAX package's (whose
    output params_from_jax converts, 8-bit leaves included), and a decode
    step with them against the JAX step and (int8) within 5e-2 of the
    full-precision one."""
    jp, tp, _, _ = both_params
    jq8 = jmodels.quantize_decode_params(JCFG, jmodels.fuse_decode_params(JCFG, jp),
                                         fmt=fmt)
    conv = _to_torch(jq8)
    fused = engine.fuse_decode_params(CFG, tp)
    q8 = engine.quantize_decode_params(CFG, fused, fmt=fmt)
    assert set(q8["layers"]) == set(conv["layers"])
    for a, b in [(q8[k], conv[k]) for k in ("lm_head_q", "lm_head_s")] + [
            (q8["layers"][k], conv["layers"][k]) for k in q8["layers"]]:
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.element_size() == 1:
            assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
        else:
            torch.testing.assert_close(a, b, rtol=1e-6, atol=0)
    prompt = np.random.default_rng(3).integers(0, CFG.vocab_size, (2, 8)).astype(np.int32)
    jcache = jmodels.init_cache(JCFG, 2, 16)
    jl, jcache = jmodels.prefill(JCFG, jp, jnp.asarray(prompt), jcache)
    nxt = np.array(jnp.argmax(jl, -1), np.int32)
    jlq, _ = jmodels.decode_step(JCFG, jq8, jnp.asarray(nxt), jcache, interpret=True)
    cache = engine.init_cache(CFG, 2, 16, CPU)
    engine.prefill(CFG, tp, torch.from_numpy(prompt), cache)
    lengths = cache.lengths.clone()
    lq, _ = engine.decode_step(CFG, conv, torch.from_numpy(nxt), cache)
    assert_rel_l2(lq.numpy(), np.asarray(jlq), tol=TOL)
    if fmt == "int8":  # tests/test_model.py:92-111 bounds int8 weights
        cache.lengths.copy_(lengths)
        lf, _ = engine.decode_step(CFG, fused, torch.from_numpy(nxt), cache)
        assert_rel_l2(lq.numpy(), lf.numpy(), tol=5e-2)


def _prompts(seed, lens, base=None):
    rng = np.random.default_rng(seed)
    out = [rng.integers(0, CFG.vocab_size, size=n).astype(np.int32) for n in lens]
    if base is not None:
        out = [np.concatenate([base, p]) for p in out]
    return out


# (kwargs, (prompt seed, lengths), max_new, max_batch, max_len): the int8
# cases of tests/test_serving.py and tests/test_torch_paged.py's modes
SCHEDULER_CASES = {
    "linear": (dict(), (0, (5, 9, 3, 12)), 4, 3, 128),
    "prefill_chunk": (dict(prefill_chunk=6), (2, (8, 5)), 3, 2, 128),
    "paged": (dict(paged=True, page_size=16), (5, (8, 5)), 3, 2, 64),
    "multi_step": (dict(multi_step=3), (11, (6, 11, 4)), 7, 2, 64),
    "multi_step_paged": (dict(paged=True, page_size=8, multi_step=3),
                         (13, (6, 9, 4)), 7, 2, 64),
    "spec_linear": (dict(spec_k=3), (27, (6, 11, 4)), 6, 2, 64),
    "spec_paged": (dict(paged=True, page_size=8, spec_k=3), (27, (6, 11, 4)),
                   6, 2, 64),
}


def _run(sched, prompts, max_new):
    uids = [sched.submit(p, max_new_tokens=max_new) for p in prompts]
    out = sched.run()
    return [out[u] for u in uids]


@pytest.mark.parametrize("case", sorted(SCHEDULER_CASES))
def test_quantized_scheduler_matches_jax_scheduler(both_params, case):
    """Scheduler(quantized_cache=True) in each mode gives the JAX int8
    Scheduler's tokens; the page pools come back whole."""
    jp, tp, jd, td = both_params
    kwargs, (seed, lens), max_new, max_batch, max_len = SCHEDULER_CASES[case]
    kw = dict(max_batch=max_batch, max_len=max_len, quantized_cache=True,
              **kwargs)
    jkw, tkw = dict(kw), dict(kw)
    if case.startswith("spec"):
        jkw.update(draft_cfg=JDRAFT, draft_params=jd)
        tkw.update(draft_cfg=DRAFT, draft_params=td)
    prompts = _prompts(seed, lens)
    jout = _run(JScheduler(JCFG, jp, interpret=True, **jkw), prompts, max_new)
    sched = Scheduler(CFG, tp, **tkw)
    assert sched.cache.quantized
    if sched.spec:
        assert not sched.dcache.quantized  # the draft's cache stays full precision
    out = _run(sched, prompts, max_new)
    assert out == jout, (case, out, jout)
    assert all(len(o) == max_new for o in out)
    if sched.paged:
        assert sched._pool.free_pages == sched._n_pages - 1
        assert not sched.cache.block_tables.any()


def test_quantized_scheduler_paged_equals_linear_and_spec_equals_plain(both_params):
    """tests/test_serving.py:164-186 and :891-923 in the port: the int8
    page pool gives the linear int8 Scheduler's tokens, and speculative
    decoding over the int8 pool gives the plain int8 pool's."""
    _, tp, _, td = both_params
    prompts = _prompts(5, (8, 5))
    kw = dict(max_batch=2, max_len=64, quantized_cache=True)
    paged = _run(Scheduler(CFG, tp, paged=True, page_size=16, **kw), prompts, 3)
    assert paged == _run(Scheduler(CFG, tp, **kw), prompts, 3)
    prompts = _prompts(27, (6, 11, 4))
    pkw = dict(kw, paged=True, page_size=8)
    spec = _run(Scheduler(CFG, tp, draft_cfg=DRAFT, draft_params=td, spec_k=3,
                          **pkw), prompts, 6)
    assert spec == _run(Scheduler(CFG, tp, **pkw), prompts, 6)


def test_quantized_scheduler_prefix_cache_matches_jax(both_params):
    """Prefix sharing over an int8 pool: the second request shares the
    first's two full pages (refcount 2), extends its suffix from the
    dequantized pages, and both give the JAX Scheduler's tokens; at the end
    every page is back and the index is empty."""
    jp, tp, _, _ = both_params
    base = _prompts(9, (32,))[0]
    prompts = _prompts(10, (3, 2), base=base)
    kw = dict(max_batch=2, max_len=128, paged=True, page_size=16,
              prefix_cache=True, quantized_cache=True)
    jout = _run(JScheduler(JCFG, jp, interpret=True, **kw), prompts, 3)
    sched = Scheduler(CFG, tp, **kw)
    uids = [sched.submit(p, max_new_tokens=3) for p in prompts]
    sched._fill_slots()
    shared = set(sched._slot_pages[0]) & set(sched._slot_pages[1])
    assert len(shared) == 2 and sched.prefix_hits == 1
    assert all(sched._page_refs[pid] == 2 for pid in shared)
    out = sched.run()
    assert [out[u] for u in uids] == jout
    assert sched._pool.free_pages == sched._n_pages - 1
    assert not sched._prefix_index and not sched._page_refs


# a bf16 model a little wider than CFG, for the cached-decode gap
GAP_WIDTHS = dict(vocab_size=256, d_model=128, n_layers=2, n_heads=4,
                  n_kv_heads=2, d_head=32, d_ff=256)


def _decode_gap(prefill, decode_step, forward, toks, n_prompt):
    """rel-L2 of the logits of prefill(prompt) and teacher-forced decode
    steps over the rest of `toks` against one full forward over `toks`."""
    steps = [prefill(toks[:, :n_prompt])]
    for i in range(n_prompt, toks.shape[1]):
        steps.append(decode_step(toks[:, i]))
    full = forward(toks)[:, n_prompt - 1:]
    return float(np.linalg.norm(np.stack(steps, 1) - full) / np.linalg.norm(full))


@pytest.mark.parametrize("window", [None, 12])
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_8bit_cache_decode_gap_equals_jax(fmt, window):
    """The e4m3 bound (ROADMAP C): the same bf16 params and tokens through
    each package's 8-bit cached decode (JAX in interpret mode, the port's
    plain path), each against its own full forward, with and without a
    sliding window (12 keys and 2 sinks, bitten by every decode step). The
    port's gap is JAX's (int8 ~1.3e-2, e4m3 ~3.7e-2 here), so what the card
    shows above the JAX suite's 5e-2 is the format's error on top of the
    bf16 floor, not the port's."""
    band = dict(attn_window=window, attn_sinks=2 if window else 0)
    jcfg = jmodels.TransformerConfig(**GAP_WIDTHS, **band, dtype=jnp.bfloat16,
                                     block_q=32, block_k=32)
    cfg = transformer.TransformerConfig(**GAP_WIDTHS, **band,
                                        dtype=torch.bfloat16)
    jp = jmodels.init_params(jcfg, jax.random.PRNGKey(0))
    tp = _to_torch(jp)
    toks = np.random.default_rng(0).integers(0, 256, size=(2, 32)).astype(np.int32)
    n_prompt = 24

    jc = [jmodels.init_cache(jcfg, 2, 33, quantized=True, quant_fmt=fmt)]
    jf = jmodels.fuse_decode_params(jcfg, jp)

    def jprefill(t):
        logits, jc[0] = jmodels.prefill(jcfg, jp, jnp.asarray(t), jc[0],
                                        interpret=True)
        return np.asarray(logits, np.float32)

    def jstep(t):
        logits, jc[0] = jmodels.decode_step(jcfg, jf, jnp.asarray(t), jc[0],
                                            interpret=True)
        return np.asarray(logits, np.float32)

    cache = engine.init_cache(cfg, 2, 33, CPU, quantized=True, quant_fmt=fmt)
    tf = engine.fuse_decode_params(cfg, tp)
    jgap = _decode_gap(
        jprefill, jstep,
        lambda t: np.asarray(jmodels.forward(jcfg, jp, jnp.asarray(t)), np.float32),
        toks, n_prompt)
    tgap = _decode_gap(
        lambda t: engine.prefill(cfg, tp, torch.from_numpy(t), cache)[0].numpy(),
        lambda t: engine.decode_step(cfg, tf, torch.from_numpy(t), cache)[0].numpy(),
        lambda t: transformer.forward(cfg, tp, torch.from_numpy(t)).numpy(),
        toks, n_prompt)
    # not larger than JAX's (a larger one would be the port's fault), and
    # of the same size (JAX rounds its attention to bf16, the plain path
    # does not, so the port's may be the smaller)
    assert 0.8 * jgap <= tgap <= 1.1 * jgap, (fmt, window, tgap, jgap)
    assert jgap < 5e-2  # tests/test_model.py:219's bound, at this width
