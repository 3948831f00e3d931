"""The port's speculative decoding against the JAX package's, in float32 on
the CPU (the JAX kernels in interpret mode, the port's wrappers on their
plain versions): the paged extend and the chunk append, `extend_paged`, the
rejection rule and its filtered distributions, `speculative_generate`, and
the speculative Scheduler over the linear and the paged cache, token for
token."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattention_kernel_project_tpu import models as jmodels
from flashattention_kernel_project_tpu.models import engine as jengine
from flashattention_kernel_project_tpu.models import serving as jserving
from flashattention_kernel_project_tpu.models.serving import Scheduler as JScheduler
from flashattention_kernel_project_tpu_torch.models import engine, serving, transformer
from flashattention_kernel_project_tpu_torch.models.convert import params_from_jax
from flashattention_kernel_project_tpu_torch.models.serving import Scheduler
from flashattention_kernel_project_tpu_torch.ops import paged_decode as tpd
from flashattention_kernel_project_tpu_torch.utils.oracles import gqa_attention
from flashattention_kernel_project_tpu_torch.utils.testing import assert_rel_l2

jpd = importlib.import_module("flashattention_kernel_project_tpu.ops.paged_decode")

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


@pytest.fixture(scope="module")
def both_params():
    jp = jmodels.init_params(JCFG, jax.random.PRNGKey(0))
    jd = jmodels.init_params(JDRAFT, jax.random.PRNGKey(99))
    to_torch = lambda p: params_from_jax(jax.tree.map(np.asarray, p), CPU)  # noqa: E731
    return jp, to_torch(jp), jd, to_torch(jd)


def _drafts(both_params, same):
    """(JAX draft cfg, params, port draft cfg, params): the target itself or
    the random one-layer draft."""
    jp, tp, jd, td = both_params
    return (JCFG, jp, CFG, tp) if same else (JDRAFT, jd, DRAFT, td)


# (b, hq, hkv, d, page, t, old lengths, max_pages): tests/test_paged_decode.py's
# shape (old 130 crosses a page edge, 7 is tiny), page 8 with a shuffled
# table and a row with no prefix, and a folded group of G * T = 72 rows
EXTEND_CASES = {
    "jax_shape": (2, 4, 2, 32, 128, 4, [130, 7], 4),
    "page8_shuffled": (3, 4, 2, 16, 8, 3, [0, 13, 21], 4),
    "group8_t9": (2, 16, 2, 16, 16, 9, [33, 5], 4),
}


def _extend_inputs(case, seed=0):
    b, hq, hkv, d, page, t, old, max_pages = EXTEND_CASES[case]
    rng = np.random.default_rng(seed)
    n_pages = b * max_pages + 1
    q = rng.standard_normal((b, hq, t, d)).astype(np.float32)
    k = rng.standard_normal((n_pages, hkv, page, d)).astype(np.float32)
    v = rng.standard_normal((n_pages, hkv, page, d)).astype(np.float32)
    old = np.array(old, np.int32)
    new = old + t
    perm = rng.permutation(np.arange(1, n_pages)).astype(np.int32)
    table = np.zeros((b, max_pages), np.int32)
    for i, n in enumerate(new):
        used = -(-int(n) // page)
        table[i, :used] = perm[i * max_pages:i * max_pages + used]
    return q, k, v, table, new, old


@pytest.mark.parametrize("case", sorted(EXTEND_CASES))
def test_paged_flash_extend_matches_jax_and_oracle(case):
    q, k, v, table, new, old = _extend_inputs(case)
    jo = jpd.paged_flash_extend(*(jnp.asarray(x) for x in (q, k, v, table, new, old)),
                                interpret=True)
    to = tpd.paged_flash_extend(*(torch.from_numpy(x)
                                  for x in (q, k, v, table, new, old)))
    assert to.shape == q.shape and to.dtype == torch.float32
    assert_rel_l2(to.numpy(), np.asarray(jo), tol=TOL)
    page = k.shape[2]
    for i in range(q.shape[0]):  # each row against the float64 oracle
        rows = table[i].astype(np.int64)
        lin_k = k[rows].transpose(1, 0, 2, 3).reshape(k.shape[1], -1, k.shape[3])
        lin_v = v[rows].transpose(1, 0, 2, 3).reshape(v.shape[1], -1, v.shape[3])
        n = int(new[i])
        assert n <= len(rows) * page
        exp = gqa_attention(q[i:i + 1], lin_k[None, :, :n], lin_v[None, :, :n],
                            causal=True, q_offset=int(old[i]))
        assert_rel_l2(to.numpy()[i:i + 1], exp, tol=TOL)
    assert tpd.paged_flash_extend.launches == 0  # CPU tensors: plain version


def test_paged_flash_extend_options_and_checks():
    """The 8-bit flavour needs both scale pools; the CUDA wrapper's checks
    refuse what the kernel does not take."""
    q, k, v, table, new, old = (torch.from_numpy(x)
                                for x in _extend_inputs("page8_shuffled"))
    with pytest.raises(ValueError, match="k_scale_pages and v_scale_pages"):
        tpd.paged_flash_extend(q, k, v, table, new, old, k_scale_pages=k)
    with pytest.raises(ValueError, match="multiple"):
        tpd.paged_flash_extend(q[:, :3], k, v, table, new, old)
    with pytest.raises(TypeError):  # f32: the kernel takes bf16
        tpd._paged_extend_cuda(q, k, v, table, new, old, 0.25)
    bq, bk, bv = (x.bfloat16() for x in (q, k, v))
    with pytest.raises(ValueError, match="d in"):  # d = 16
        tpd._paged_extend_cuda(bq, bk, bv, table, new, old, 0.25)
    with pytest.raises(TypeError, match="int32"):
        tpd._check_ragged_bounds(bq, new.long(), old)


def test_paged_append_chunk_matches_jax_bit_for_bit():
    """T tokens per row in one write per pool: a chunk crossing a page
    edge, one past the table's capacity (its tail goes to the junk page 0),
    an empty row whose table is all page 0, and one starting a page. Pages
    other than the junk page match the JAX package bit for bit."""
    page, max_pages, t = 8, 3, 4
    rng = np.random.default_rng(2)
    k = rng.standard_normal((10, 2, page, 16)).astype(np.float32)
    v = rng.standard_normal((10, 2, page, 16)).astype(np.float32)
    k_new = rng.standard_normal((4, t, 2, 16)).astype(np.float32)
    v_new = rng.standard_normal((4, t, 2, 16)).astype(np.float32)
    table = np.array([[4, 7, 2], [9, 1, 5], [0, 0, 0], [3, 8, 6]], np.int32)
    lengths = np.array([6, max_pages * page - 2, 0, page], np.int32)
    jk, jv = jpd.paged_append_chunk(*(jnp.asarray(x) for x in
                                      (k, v, k_new, v_new, table, lengths)))
    tk, tv = (torch.from_numpy(x.copy()) for x in (k, v))
    out = tpd.paged_append_chunk(tk, tv, *(torch.from_numpy(x) for x in
                                           (k_new, v_new, table, lengths)))
    assert out[0] is tk and out[1] is tv  # in place
    np.testing.assert_array_equal(tk.numpy()[1:], np.asarray(jk)[1:])
    np.testing.assert_array_equal(tv.numpy()[1:], np.asarray(jv)[1:])
    np.testing.assert_array_equal(tk.numpy()[7, :, 0:2], k_new[0, 2:].transpose(1, 0, 2))
    np.testing.assert_array_equal(tk.numpy()[5, :, 6:8], k_new[1, :2].transpose(1, 0, 2))
    assert not np.array_equal(tk.numpy()[0], k[0])  # the overflow's junk writes


def test_extend_paged_matches_jax_and_linear_extend(both_params):
    """extend_paged of a 4-token chunk crossing a page edge, on two prompts
    paged_insert'ed into shuffled pages: logits and lengths against JAX's
    extend_paged and the port's linear extend(all_logits=True), then a
    decode step on both caches."""
    jp, tp, _, _ = both_params
    page, max_pages, n_pages, t0, t = 8, 3, 9, 13, 4
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, CFG.vocab_size, size=(2, t0)).astype(np.int32)
    chunk = rng.integers(0, CFG.vocab_size, size=(2, t)).astype(np.int32)
    tables = np.array([[6, 2, 8], [3, 5, 1]], np.int32)

    lin = engine.init_cache(CFG, 2, 32, CPU)
    engine.prefill(CFG, tp, torch.from_numpy(prompt), lin)
    jcache = jengine.init_paged_cache(JCFG, 2, n_pages, page_size=page,
                                      max_pages_per_seq=max_pages)
    cache = engine.init_paged_cache(CFG, 2, n_pages, CPU, page_size=page,
                                    max_pages_per_seq=max_pages)
    for slot in range(2):
        k_seq = [x[slot, :, :t0] for x in lin.k]
        v_seq = [x[slot, :, :t0] for x in lin.v]
        jcache = jengine.paged_insert(
            jcache, slot, jnp.asarray(tables[slot]),
            tuple(jnp.asarray(x.numpy()) for x in k_seq),
            tuple(jnp.asarray(x.numpy()) for x in v_seq), t0)
        engine.paged_insert(cache, slot, tables[slot], k_seq, v_seq, t0)

    jl, jcache = jengine.extend_paged(JCFG, jp, jnp.asarray(chunk), jcache,
                                      interpret=True)
    tl, out = engine.extend_paged(CFG, tp, torch.from_numpy(chunk), cache)
    ll, _ = engine.extend(CFG, tp, torch.from_numpy(chunk), lin, all_logits=True)
    assert out is cache and tl.shape == (2, t, CFG.vocab_size)
    assert tl.dtype == torch.float32
    assert_rel_l2(tl.numpy(), np.asarray(jl), tol=TOL)
    assert_rel_l2(tl.numpy(), ll.numpy(), tol=TOL)
    np.testing.assert_array_equal(cache.lengths.numpy(), [t0 + t] * 2)
    np.testing.assert_array_equal(cache.lengths.numpy(), np.asarray(jcache.lengths))
    np.testing.assert_array_equal(cache.lengths.numpy(), lin.lengths.numpy())
    for i in range(CFG.n_layers):
        assert_rel_l2(cache.k_pages[i].numpy()[1:], np.asarray(jcache.k_pages[i])[1:],
                      tol=TOL)
    tok = torch.from_numpy(np.array(jnp.argmax(jl[:, -1], -1), np.int32))
    dl, _ = engine.decode_step_paged(CFG, tp, tok, cache)
    ld, _ = engine.decode_step(CFG, tp, tok, lin)
    assert_rel_l2(dl.numpy(), ld.numpy(), tol=TOL)
    # a bf16 pool: no scale pages (8-bit pools: tests/test_torch_quant_serving.py)
    assert not cache.quantized and cache.k_scale_pages is None


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_speculative_accept_matches_jax(seed):
    """The same p, q, d and numpy rng state give the JAX package's tokens,
    over 200 slots with skewed and perfect drafts."""
    rng = np.random.default_rng(seed)
    vocab, k = 8, 3
    for trial in range(200):
        p = rng.dirichlet(np.ones(vocab), size=k + 1)
        q = p[:k] if trial % 4 == 0 else rng.dirichlet(np.ones(vocab) * 0.3, size=k)
        d = np.array([rng.choice(vocab, p=q[j]) for j in range(k)])
        state = int(rng.integers(1 << 30))
        got = engine.speculative_accept(p, q, d, np.random.default_rng(state))
        want = jengine.speculative_accept(p, q, d, np.random.default_rng(state))
        assert got == want, (trial, got, want)


def test_speculative_accept_preserves_target_dist():
    """The first committed token's marginal is the target's p[0] whatever
    the draft (tests/test_model.py's check), and a perfect draft accepts
    every token."""
    rng = np.random.default_rng(3)
    vocab, k, n = 6, 2, 20000
    p = rng.dirichlet(np.ones(vocab), size=k + 1)
    q = rng.dirichlet(np.ones(vocab) * 0.3, size=k)
    hist = np.zeros(vocab)
    for _ in range(n):
        d = [rng.choice(vocab, p=q[j]) for j in range(k)]
        hist[engine.speculative_accept(p, q, np.array(d), rng)[0]] += 1
    tv = 0.5 * np.abs(hist / n - p[0]).sum()
    assert tv < 0.03, (tv, hist / n, p[0])
    p = rng.dirichlet(np.ones(8), size=4)
    for _ in range(200):
        d = np.array([rng.choice(8, p=p[j]) for j in range(3)])
        take = engine.speculative_accept(p, p[:3], d, rng)
        assert len(take) == 4 and take[:3] == list(d)


@pytest.mark.parametrize("top_k,top_p", [(None, None), (8, None), (None, 0.9),
                                         (8, 0.9)])
def test_host_filtered_probs_matches_jax(top_k, top_p):
    z = np.random.default_rng(5).standard_normal((3, 5, 64)).astype(np.float32) * 3
    got = serving._host_filtered_probs(z, 0.7, top_k, top_p)
    want = jserving._host_filtered_probs(z, 0.7, top_k, top_p)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-12)
    if top_k:
        assert ((got > 0).sum(-1) <= top_k).all()


@pytest.mark.parametrize("same_draft", [True, False])
def test_speculative_generate_matches_jax_and_generate(both_params, same_draft):
    """Greedy speculative tokens equal the JAX package's and the port's
    plain greedy generation, with a perfect and a random draft."""
    jp, tp, _, _ = both_params
    jdcfg, jdp, dcfg, dp = _drafts(both_params, same_draft)
    prompt = np.random.default_rng(17).integers(
        0, CFG.vocab_size, size=(2, 8)).astype(np.int32)
    jout = jmodels.speculative_generate(
        JCFG, jp, jnp.asarray(prompt), draft_cfg=jdcfg, draft_params=jdp,
        spec_k=3, max_new_tokens=10, interpret=True)
    out = engine.speculative_generate(
        CFG, tp, torch.from_numpy(prompt), draft_cfg=dcfg, draft_params=dp,
        spec_k=3, max_new_tokens=10)
    ref = engine.generate(CFG, tp, torch.from_numpy(prompt), max_new_tokens=10)
    assert out.shape == (2, 18) and out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(out.numpy(), ref.numpy())


def test_speculative_generate_sampling(both_params):
    """temperature > 0: deterministic given the generator's seed, in-vocab
    tokens, the prompt kept; a different seed gives a different stream."""
    _, tp, _, td = both_params
    prompt = torch.from_numpy(np.random.default_rng(21).integers(
        0, CFG.vocab_size, size=(2, 8)).astype(np.int32))

    def run(seed):
        return engine.speculative_generate(
            CFG, tp, prompt, draft_cfg=DRAFT, draft_params=td, spec_k=3,
            max_new_tokens=12, temperature=0.8,
            generator=torch.Generator().manual_seed(seed))

    a, b, c = run(5), run(5), run(6)
    assert a.shape == (2, 20)
    torch.testing.assert_close(a, b)
    torch.testing.assert_close(a[:, :8], prompt)
    assert ((a >= 0) & (a < CFG.vocab_size)).all()
    assert not torch.equal(a, c)
    with pytest.raises(ValueError, match="vocabulary"):
        engine.speculative_generate(
            CFG, tp, prompt, draft_cfg=dataclasses.replace(DRAFT, vocab_size=32),
            draft_params=td)


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab_size, size=n).astype(np.int32) for n in lens]


def _serve(sched, prompts, max_new):
    uids = [sched.submit(p, max_new_tokens=max_new) for p in prompts]
    out = sched.run()
    return [out[u] for u in uids]


@pytest.mark.parametrize("same_draft", [True, False])
@pytest.mark.parametrize("paged", [False, True])
def test_scheduler_spec_matches_jax_and_plain(both_params, paged, same_draft):
    """3 requests on 2 slots (one queues), spec_k 3: the speculative
    Scheduler gives the JAX speculative Scheduler's tokens and the port's
    plain Scheduler's, over the linear cache and the page pool (which ends
    fully recycled), as tests/test_serving.py's speculative cases."""
    jp, tp, _, _ = both_params
    jdcfg, jdp, dcfg, dp = _drafts(both_params, same_draft)
    prompts = _prompts(10, (6, 11, 4))
    kw = dict(max_batch=2, max_len=64, paged=paged, spec_k=3)
    jout = _serve(JScheduler(JCFG, jp, draft_cfg=jdcfg, draft_params=jdp,
                             interpret=True, **kw), prompts, 6)
    sched = Scheduler(CFG, tp, draft_cfg=dcfg, draft_params=dp, **kw)
    out = _serve(sched, prompts, 6)
    ref = _serve(Scheduler(CFG, tp, max_batch=2, max_len=64), prompts, 6)
    assert out == jout and out == ref, (out, jout, ref)
    assert all(len(x) == 6 for x in out)
    if paged:
        assert sched._pool.free_pages == sched._n_pages - 1
        assert not sched.cache.block_tables.any() and not sched._page_refs


def test_scheduler_spec_with_prefix_cache_and_chunks(both_params):
    """Speculative rounds between the chunks of a chunked prefill, over the
    paged, prefix-cached Scheduler: the target's prefix pages are shared,
    the draft prefills every prompt whole, and the tokens equal the same
    Scheduler's without a draft."""
    _, tp, _, td = both_params
    base = _prompts(7, (40,))[0]
    prompts = [np.concatenate([base, p]) for p in _prompts(9, (5, 9, 3))]
    kw = dict(max_batch=2, max_len=128, paged=True, page_size=16,
              prefix_cache=True, prefill_chunk=8)
    sched = Scheduler(CFG, tp, draft_cfg=DRAFT, draft_params=td, spec_k=3, **kw)
    out = _serve(sched, prompts, 7)
    assert sched.prefix_hits >= 1
    assert out == _serve(Scheduler(CFG, tp, **kw), prompts, 7)
    assert sched._pool.free_pages == sched._n_pages - 1
    assert not sched._prefix_index and not sched._page_refs


def test_scheduler_spec_eos_mid_round(both_params):
    """An EOS inside an accepted draft chunk retires the request and drops
    the rest of the round, as tests/test_serving.py:359-379."""
    jp, tp, _, _ = both_params
    p = np.array([1, 2, 3], np.int32)
    eos = _serve(Scheduler(CFG, tp, max_batch=1, max_len=64), [p], 4)[0][1]
    kw = dict(max_batch=1, max_len=64, eos_token=int(eos))
    out = _serve(Scheduler(CFG, tp, draft_cfg=CFG, draft_params=tp, spec_k=3,
                           **kw), [p], 8)[0]
    jout = _serve(JScheduler(JCFG, jp, draft_cfg=JCFG, draft_params=jp,
                             spec_k=3, interpret=True, **kw), [p], 8)[0]
    assert out == jout == _serve(Scheduler(CFG, tp, **kw), [p], 8)[0]
    assert out[-1] == eos and len(out) <= 8


def test_scheduler_spec_sampling(both_params):
    """A sampled slot (temperature 0.8, the rejection rule) beside a greedy
    one: the greedy slot keeps the plain greedy tokens, and the run is
    deterministic given the generator's seed, with and without top_k, as
    tests/test_serving.py:846-888."""
    _, tp, _, td = both_params
    prompts = _prompts(31, (6, 11))

    def run(**kw):
        s = Scheduler(CFG, tp, max_batch=2, max_len=64, draft_cfg=DRAFT,
                      draft_params=td, spec_k=3,
                      generator=torch.Generator().manual_seed(5), **kw)
        u0 = s.submit(prompts[0], max_new_tokens=6)  # greedy by default
        u1 = s.submit(prompts[1], max_new_tokens=6, temperature=0.8)
        out = s.run()
        return out[u0], out[u1]

    greedy = _serve(Scheduler(CFG, tp, max_batch=2, max_len=64), prompts[:1], 6)[0]
    for kw in ({}, dict(top_k=8)):
        (g0, s1), (g0b, s1b) = run(**kw), run(**kw)
        assert (g0, s1) == (g0b, s1b)  # deterministic given the seed
        assert g0 == greedy  # the greedy slot is unchanged by its neighbour
        assert len(s1) == 6 and all(0 <= t < CFG.vocab_size for t in s1)


def test_scheduler_spec_guards(both_params):
    """spec with multi_step raises as the JAX Scheduler does, spec over an
    8-bit pool keeps the draft's cache full precision, a draft needs its
    params and the target's vocabulary, and admission reserves spec_k + 1
    rows."""
    _, tp, _, td = both_params
    kw = dict(max_batch=2, max_len=64, draft_cfg=DRAFT, draft_params=td)
    with pytest.raises(NotImplementedError, match="no spec composition"):
        Scheduler(CFG, tp, multi_step=4, **kw)
    q8 = Scheduler(CFG, tp, quantized_cache=True, paged=True, **kw)
    assert q8.cache.quantized and not q8.dcache.quantized
    with pytest.raises(NotImplementedError, match="bf16-only"):
        Scheduler(CFG, tp, mesh=object(), paged=True, quantized_cache=True, **kw)
    with pytest.raises(ValueError, match="draft_params"):
        Scheduler(CFG, tp, max_batch=2, max_len=64, draft_cfg=DRAFT)
    with pytest.raises(ValueError, match="vocabulary"):
        Scheduler(CFG, tp, max_batch=2, max_len=64, draft_params=td,
                  draft_cfg=dataclasses.replace(DRAFT, vocab_size=32))
    sched = Scheduler(CFG, tp, spec_k=3, **kw)
    with pytest.raises(ValueError, match="60"):  # 64 less 4 reserved rows
        sched.submit(np.arange(50, dtype=np.int32), max_new_tokens=12)
    sched.submit(np.arange(50, dtype=np.int32), max_new_tokens=10)

