"""The port's paged KV cache and its Scheduler modes against the JAX
package's, in float32 on the CPU (the JAX kernels in interpret mode, the
port's wrappers on their plain versions): the paged decode (both
schedules), the paged append, the page pool, the engine's paged functions,
and the Scheduler with chunked prefill, a page pool, prefix caching and
multi-step decoding, token for token."""

import importlib

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
from flashattention_kernel_project_tpu_torch.ops import paged_decode as tpd
from flashattention_kernel_project_tpu_torch.utils.testing import assert_rel_l2

jpd = importlib.import_module("flashattention_kernel_project_tpu.ops.paged_decode")

torch.set_num_threads(1)

TOL = 1e-4  # float32 on both sides
CPU = torch.device("cpu")
# the tiny config of tests/test_torch_serving.py
JCFG = jmodels.TransformerConfig(
    vocab_size=64, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_head=16, d_ff=128, dtype=jnp.float32, block_q=32, block_k=32,
)
CFG = transformer.TransformerConfig(
    vocab_size=64, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_head=16, d_ff=128, dtype=torch.float32,
)


@pytest.fixture(scope="module")
def both_params():
    jp = jmodels.init_params(JCFG, jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), CPU)


def _paged_inputs(seed, page, d=16, b=4, hq=4, hkv=2, max_pages=6):
    """A pool of b * max_pages + 1 pages; each row's pages are drawn from a
    shuffled permutation, entries past its pages point at page 0."""
    rng = np.random.default_rng(seed)
    n_pages = b * max_pages + 1
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    k = rng.standard_normal((n_pages, hkv, page, d)).astype(np.float32)
    v = rng.standard_normal((n_pages, hkv, page, d)).astype(np.float32)
    lengths = np.array([0, 1, 2 * page + 3, max_pages * page][:b], np.int32)
    perm = rng.permutation(np.arange(1, n_pages)).astype(np.int32)
    table = np.zeros((b, max_pages), np.int32)
    for i, n in enumerate(lengths):
        used = -(-int(n) // page)
        table[i, :used] = perm[i * max_pages:i * max_pages + used]
    return q, k, v, table, lengths


@pytest.mark.parametrize("page", [8, 16])
@pytest.mark.parametrize("gather", [True, False])
def test_paged_flash_decode_matches_jax(gather, page):
    q, k, v, table, lengths = _paged_inputs(0, page)
    jo = jpd.paged_flash_decode(*(jnp.asarray(x) for x in (q, k, v, table, lengths)),
                                gather=gather, interpret=True)
    to = tpd.paged_flash_decode(*(torch.from_numpy(x)
                                  for x in (q, k, v, table, lengths)),
                                gather=gather)
    assert to.shape == q.shape and to.dtype == torch.float32
    assert_rel_l2(to.numpy(), np.asarray(jo), tol=TOL)
    np.testing.assert_array_equal(to.numpy()[0], 0.0)  # length 0 -> zeros
    assert tpd.paged_flash_decode.launches == 0  # CPU tensors: plain version


def test_paged_flash_decode_schedules_and_options():
    """Both schedules give the linear decode of the gathered rows; the
    gather's probe options (slots leaves the output as it is, copy_only
    gives its rows' sums, slots < 2 raises); the occupancy split sizing at
    the serving shape."""
    from flashattention_kernel_project_tpu_torch.ops import flash_decode as tfd

    q, k, v, table, lengths = (torch.from_numpy(x) for x in _paged_inputs(1, 8))
    ids = table.long()
    lin_k = k[ids].permute(0, 2, 1, 3, 4).reshape(4, 2, -1, 16)
    lin_v = v[ids].permute(0, 2, 1, 3, 4).reshape(4, 2, -1, 16)
    ref = tfd.flash_decode(q, lin_k, lin_v, lengths, n_splits=1)
    for gather in (True, False):
        torch.testing.assert_close(
            tpd.paged_flash_decode(q, k, v, table, lengths, gather=gather),
            ref, rtol=1e-5, atol=1e-6)
    base = tpd.paged_flash_decode(q, k, v, table, lengths)
    assert torch.equal(tpd.paged_flash_decode(q, k, v, table, lengths, slots=3),
                       base)
    with pytest.raises(ValueError, match="slots"):
        tpd.paged_flash_decode(q, k, v, table, lengths, slots=1)
    # the plain version takes any depth; the card's kernels are built for 2-4
    assert torch.equal(tpd.paged_flash_decode(q, k, v, table, lengths, slots=9),
                       base)
    with pytest.raises(ValueError, match="slots in"):
        tpd._check_slots(5, torch.device("cuda"))
    # copy_only: per live split (here one split of 64 keys, 8 pages of 8),
    # k + v at its first key row + g
    got = tpd.paged_flash_decode(q, k, v, table, lengths, copy_only=True)
    assert torch.equal(got, _copy_only_definition(k, v, table, lengths, 8, 2))
    with pytest.raises(ValueError, match="copy_only runs at slots=2"):
        tpd.paged_flash_decode(q, k, v, table, lengths, copy_only=True, slots=3)
    # gather=False takes neither option, as JAX's one-page kernel
    assert torch.equal(tpd.paged_flash_decode(q, k, v, table, lengths,
                                              gather=False, copy_only=True),
                       tpd.paged_flash_decode(q, k, v, table, lengths,
                                              gather=False))
    # B=8, Hkv=4, 16 pages of 128: 8 splits of 256 keys, 256 blocks
    assert tpd.decode_plan(8, 4, 128, 16) == (8, 256)
    bf = torch.zeros(4, 4, 16, dtype=torch.bfloat16)
    pool = torch.zeros(25, 2, 8, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # pages of 8 rows: the kernel takes 16..128
        tpd._check_cuda_inputs(bf, pool, pool, table, lengths)


def _copy_only_definition(k, v, table, lengths, pages_per_split, g):
    """copy_only's output, key row by key row: for q head h * G + g, the sum
    over the live splits of k + v at the split's first key row + g."""
    page, max_pages = k.shape[2], table.shape[1]
    b, hkv, d = table.shape[0], k.shape[1], k.shape[3]
    span = pages_per_split * page
    want = torch.zeros(b, hkv, g, d)
    for row in range(b):
        for start in range(0, max_pages * page, span):
            if start < int(lengths[row]):
                pid = int(table[row, start // page])
                want[row] += k[pid, :, :g].float() + v[pid, :, :g].float()
    return want.reshape(b, hkv * g, d)


def _slot_case(pool):
    """JAX's slot-rotation case (tests/test_paged_decode.py:385-399): 8/2
    heads, d 64, pages of 32, 8 table entries a row, ragged lengths (the
    dead splits of row 1 included), over a float32, bf16 or int8 pool."""
    rng = np.random.default_rng(42)
    b, hq, hkv, d, page, npages, maxp = 2, 8, 2, 64, 32, 24, 8
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    kp = rng.standard_normal((npages, hkv, page, d)).astype(np.float32)
    vp = rng.standard_normal((npages, hkv, page, d)).astype(np.float32)
    tbl = (rng.permutation(np.arange(1, 1 + b * maxp)).reshape(b, maxp)
           % npages).astype(np.int32)
    lens = np.array([200, 64], np.int32)
    arrays = q, kp, vp, tbl, lens
    if pool == "float32":
        return arrays
    tq, tk, tv, tt, tl = (torch.from_numpy(x) for x in arrays)
    if pool == "bf16":
        return tq.bfloat16(), tk.bfloat16(), tv.bfloat16(), tt, tl
    from flashattention_kernel_project_tpu_torch.ops import quant

    kq, ks = quant.quantize_int8(tk, axis=-1)
    vq, vs = quant.quantize_int8(tv, axis=-1)
    return (tq.bfloat16(), kq, ks.transpose(-1, -2).contiguous(), vq,
            vs.transpose(-1, -2).contiguous(), tt, tl)


@pytest.mark.parametrize("slots", [3, 4])
@pytest.mark.parametrize("pool", ["float32", "bf16", "int8"])
def test_paged_slots_give_the_two_slot_result(slots, pool):
    """Every gather depth gives the 2-slot result bit for bit, as JAX's test
    requires of its DMA ring; over a float32 pool both packages' slots runs
    agree too."""
    case = _slot_case(pool)
    if pool == "float32":
        jo = jpd.paged_flash_decode(*(jnp.asarray(x) for x in case), slots=slots,
                                    interpret=True)
        case = [torch.from_numpy(x) for x in case]
    fn = tpd.paged_flash_decode_quant if pool == "int8" else tpd.paged_flash_decode
    base = fn(*case)
    rot = fn(*case, slots=slots)
    assert torch.equal(rot, base)
    if pool == "float32":
        assert_rel_l2(rot.numpy(), np.asarray(jo), tol=TOL)
    if pool == "int8":
        qi8 = fn(*case, q_int8=True)
        assert torch.equal(fn(*case, slots=slots, q_int8=True), qi8)
    assert fn.launches == fn.slots_launches == 0


def test_paged_copy_only_matches_its_definition_and_jax():
    """copy_only over the port's splits: for q head h * G + g, the sum over
    the live splits of k + v at the split's first key row + g. At B * Hkv =
    264 (two blocks per SM of an H100) and 4 pages of 16 rows of a float32
    pool, both packages make one split a row, so the JAX probe's output is
    the same function."""
    rng = np.random.default_rng(11)
    b, hq, hkv, d, page, maxp = 66, 8, 4, 16, 16, 4
    n_pages = b * maxp + 1
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    kp = rng.standard_normal((n_pages, hkv, page, d)).astype(np.float32)
    vp = rng.standard_normal((n_pages, hkv, page, d)).astype(np.float32)
    tbl = rng.permutation(np.arange(1, n_pages)).reshape(b, maxp).astype(np.int32)
    lens = rng.integers(0, maxp * page + 1, b).astype(np.int32)
    lens[:3] = [0, 1, maxp * page]
    assert tpd.decode_plan(b, hkv, page, maxp, d)[0] == 1
    jo = jpd.paged_flash_decode(*(jnp.asarray(x) for x in (q, kp, vp, tbl, lens)),
                                copy_only=True, interpret=True)
    to = tpd.paged_flash_decode(*(torch.from_numpy(x) for x in (q, kp, vp, tbl, lens)),
                                copy_only=True)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    # the definition over several splits of several pages: 4/2 heads, 6
    # pages of 8, 2 pages and 3 splits a row
    q, k, v, table, lengths = (torch.from_numpy(x) for x in _paged_inputs(3, 8))
    got = tpd._paged_copy_only_plain(q, k, v, table, lengths, 2 * 8)
    assert torch.equal(got, _copy_only_definition(k, v, table, lengths, 2, 2))
    assert tpd.paged_flash_decode.copy_only_launches == 0


def test_paged_append_matches_jax_bit_for_bit():
    """One token per row into its current page; a row past its table's
    capacity writes into the junk page 0, as in the JAX package."""
    page, max_pages = 8, 3
    rng = np.random.default_rng(2)
    k = rng.standard_normal((10, 2, page, 16)).astype(np.float32)
    v = rng.standard_normal((10, 2, page, 16)).astype(np.float32)
    k_new = rng.standard_normal((4, 2, 16)).astype(np.float32)
    v_new = rng.standard_normal((4, 2, 16)).astype(np.float32)
    table = np.array([[4, 7, 2], [9, 1, 5], [0, 0, 0], [3, 8, 6]], np.int32)
    # row 1 overflows its 3 pages (to page 0 row 2); row 2 is empty (page 0
    # row 0); row 3 starts its second page
    lengths = np.array([5, max_pages * page + 2, 0, page], np.int32)
    jk, jv = jpd.paged_append(*(jnp.asarray(x) for x in
                                (k, v, k_new, v_new, table, lengths)))
    tk, tv = (torch.from_numpy(x.copy()) for x in (k, v))
    out = tpd.paged_append(tk, tv, *(torch.from_numpy(x) for x in
                                     (k_new, v_new, table, lengths)))
    assert out[0] is tk and out[1] is tv  # in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tk.numpy()[0, :, 2], k_new[1])  # overflow


def test_page_pool_matches_jax():
    jpool, tpool = jpd.PagePool(6), tpd.PagePool(6)
    log = []
    for pool in (jpool, tpool):
        a = pool.alloc(3)
        b = pool.alloc(1)
        pool.free([a[1], 0])  # page 0 is never returned to the free list
        c = pool.alloc(2)
        with pytest.raises(MemoryError):
            pool.alloc(2)
        log.append((a, b, c, pool.free_pages,
                    pool.table_for(c + b, 4).tolist()))
    assert log[0] == log[1]
    assert log[1][3] == 0 and 0 not in log[1][0] + log[1][1] + log[1][2]


def test_paged_engine_matches_jax(both_params):
    """paged_insert of two prefilled prompts (the second sharing the first's
    first page via start_page), cache_from_pages of that page, and three
    decode_step_paged steps: pools, gathered rows and logits match the
    JAX engine's."""
    jp, tp = both_params
    page, max_pages, n_pages = 8, 4, 9
    rng = np.random.default_rng(3)
    toks = rng.integers(0, CFG.vocab_size, size=(2, 11)).astype(np.int32)
    toks[1, :page] = toks[0, :page]  # one full shared page
    tables = np.array([[6, 2, 0, 0], [6, 5, 0, 0]], np.int32)
    tables[0, 2], tables[1, 2] = 8, 3  # room for the decode steps

    jcache = jengine.init_paged_cache(JCFG, 2, n_pages, page_size=page,
                                      max_pages_per_seq=max_pages)
    cache = engine.init_paged_cache(CFG, 2, n_pages, CPU, page_size=page,
                                    max_pages_per_seq=max_pages)
    assert cache.page_size == page
    for slot in range(2):
        jc1 = jmodels.init_cache(JCFG, 1, 16)
        _, jc1 = jmodels.prefill(JCFG, jp, jnp.asarray(toks[slot:slot + 1]), jc1)
        c1 = engine.init_cache(CFG, 1, 16, CPU)
        engine.prefill(CFG, tp, torch.from_numpy(toks[slot:slot + 1]), c1)
        jcache = jengine.paged_insert(
            jcache, slot, jnp.asarray(tables[slot]),
            tuple(x[0, :, :11] for x in jc1.k), tuple(x[0, :, :11] for x in jc1.v),
            11, start_page=slot)
        out = engine.paged_insert(
            cache, slot, tables[slot], [x[0, :, :11] for x in c1.k],
            [x[0, :, :11] for x in c1.v], 11, start_page=slot)
        assert out is cache
    for i in range(CFG.n_layers):
        assert_rel_l2(cache.k_pages[i].numpy(), np.asarray(jcache.k_pages[i]), tol=TOL)
        assert_rel_l2(cache.v_pages[i].numpy(), np.asarray(jcache.v_pages[i]), tol=TOL)
        # rows past a prompt's length in its last page are zero
        assert not cache.k_pages[i][2, :, 11 - page:].any()
    np.testing.assert_array_equal(cache.block_tables.numpy(), tables)
    np.testing.assert_array_equal(cache.lengths.numpy(), [11, 11])

    jlin = jengine.cache_from_pages(JCFG, jcache, [6], page, 16)
    lin = engine.cache_from_pages(CFG, cache, [6], page, 16)
    assert int(lin.lengths[0]) == page
    for i in range(CFG.n_layers):
        assert_rel_l2(lin.k[i].numpy(), np.asarray(jlin.k[i]), tol=TOL)
        assert_rel_l2(lin.v[i].numpy(), np.asarray(jlin.v[i]), tol=TOL)

    jfused = jmodels.fuse_decode_params(JCFG, jp)
    tfused = engine.fuse_decode_params(CFG, tp)
    cur = toks[:, -1].copy()
    for _ in range(3):
        jl, jcache = jengine.decode_step_paged(JCFG, jfused, jnp.asarray(cur),
                                               jcache, interpret=True)
        tl, _ = engine.decode_step_paged(CFG, tfused, torch.from_numpy(cur), cache)
        assert_rel_l2(tl.numpy(), np.asarray(jl), tol=TOL)
        cur = np.array(jnp.argmax(jl, -1), np.int32)
    np.testing.assert_array_equal(cache.lengths.numpy(), [14, 14])
    for i in range(CFG.n_layers):
        assert_rel_l2(cache.k_pages[i].numpy(), np.asarray(jcache.k_pages[i]), tol=TOL)
    toks_s, _ = engine.decode_steps_paged(CFG, tfused, torch.from_numpy(cur),
                                          cache, n_steps=2)
    assert toks_s.shape == (2, 2) and int(cache.lengths[0]) == 16
    # an 8-bit pool: e4m3 pages and lane-major float32 scale pages
    q8 = engine.init_paged_cache(CFG, 1, 4, CPU, quantized=True, quant_fmt="fp8")
    assert q8.quantized and q8.k_pages[0].dtype == torch.float8_e4m3fn
    assert q8.v_scale_pages[0].shape == (4, CFG.n_kv_heads, 1, 128)


def _prompts(seed, lens, base=None):
    rng = np.random.default_rng(seed)
    out = [rng.integers(0, CFG.vocab_size, size=n).astype(np.int32) for n in lens]
    if base is not None:
        out = [np.concatenate([base, p]) for p in out]
    return out


# (kwargs, prompts, max_new, max_batch, max_len): the cases of
# tests/test_serving.py
SCHEDULER_CASES = {
    "prefill_chunk": (dict(prefill_chunk=5), (1, (7, 13, 3, 11)), 4, 3, 128),
    "paged": (dict(paged=True, page_size=16), (4, (6, 11, 4, 9)), 4, 2, 64),
    "paged_chunked": (dict(paged=True, page_size=16, prefill_chunk=5),
                      (6, (13, 7)), 4, 2, 64),
    "multi_step": (dict(multi_step=3), (11, (6, 11, 4)), 7, 2, 64),
    "multi_step_paged": (dict(paged=True, page_size=8, multi_step=3),
                         (13, (6, 9, 4)), 7, 2, 64),
}


@pytest.mark.parametrize("case", sorted(SCHEDULER_CASES))
def test_scheduler_modes_match_jax_scheduler(both_params, case):
    jp, tp = both_params
    kwargs, (seed, lens), max_new, max_batch, max_len = SCHEDULER_CASES[case]
    prompts = _prompts(seed, lens)
    jsched = JScheduler(JCFG, jp, max_batch=max_batch, max_len=max_len,
                        interpret=True, **kwargs)
    juids = [jsched.submit(p, max_new_tokens=max_new) for p in prompts]
    jout = jsched.run()
    sched = Scheduler(CFG, tp, max_batch=max_batch, max_len=max_len, **kwargs)
    uids = [sched.submit(p, max_new_tokens=max_new) for p in prompts]
    out = sched.run()
    for u, ju in zip(uids, juids):
        assert out[u] == jout[ju], (case, out[u], jout[ju])
        assert len(out[u]) == max_new
    if sched.paged:  # every page back in the pool, every table at page 0
        assert sched._pool.free_pages == sched._n_pages - 1
        assert not sched.cache.block_tables.any()
        assert not sched._page_refs


def test_scheduler_paged_pool_exhaustion(both_params):
    """An oversubscribed pool raises MemoryError at the insert that does
    not fit, as the JAX Scheduler does."""
    _, tp = both_params
    sched = Scheduler(CFG, tp, max_batch=2, max_len=64, paged=True,
                      page_size=16, n_pages=3)  # the junk page + 2
    p = np.arange(20, dtype=np.int32) % CFG.vocab_size
    sched.submit(p, max_new_tokens=8)  # needs ceil(28 / 16) = 2 pages
    sched.submit(p, max_new_tokens=8)
    with pytest.raises(MemoryError):
        sched.run()


def test_failed_prefix_insert_drops_its_page_references(both_params):
    """A prefix-cached insert that runs out of pages keeps no reference:
    after the MemoryError each shared page's count equals its live holders,
    and retiring the holder returns every page to the pool."""
    _, tp = both_params
    sched = Scheduler(CFG, tp, max_batch=2, max_len=64, paged=True,
                      page_size=16, n_pages=5, prefix_cache=True)
    base = _prompts(21, (40,))[0]  # two full pages and 8 tokens
    first, second = _prompts(22, (1, 5), base=base)
    sched.submit(first, max_new_tokens=7)   # 3 pages, 1 left free
    sched.submit(second, max_new_tokens=8)  # shares 2 pages, needs 2 more
    with pytest.raises(MemoryError):
        sched.run()
    holders = {}
    for pages in sched._slot_pages:
        for pid in pages:
            holders[pid] = holders.get(pid, 0) + 1
    assert len(holders) == 3 and sched._page_refs == holders
    assert not sched._slot_pages[1] and not sched.cache.block_tables[1].any()
    sched._release_slot(0)
    assert sched._pool.free_pages == sched._n_pages - 1
    assert not sched._page_refs and not sched._prefix_index


@pytest.mark.parametrize("aligned", [False, True])
def test_scheduler_prefix_cache_matches_jax(both_params, aligned):
    """Two live requests with a common prefix share its full pages
    (refcount 2), the second runs extend over its suffix only, and both
    give the JAX Scheduler's tokens; a page-aligned prompt holds back its
    last page. At the end every page is back and the index is empty."""
    jp, tp = both_params
    if aligned:
        p = _prompts(8, (32,))[0]  # two full pages of 16
        prompts, n_shared = [p, p], 1
    else:
        base = _prompts(7, (40,))[0]
        prompts, n_shared = _prompts(9, (5, 9), base=base), 40 // 16
    kw = dict(max_batch=2, max_len=128, paged=True, page_size=16,
              prefix_cache=True)
    jsched = JScheduler(JCFG, jp, interpret=True, **kw)
    juids = [jsched.submit(p, max_new_tokens=4) for p in prompts]
    jout = jsched.run()
    sched = Scheduler(CFG, tp, **kw)
    uids = [sched.submit(p, max_new_tokens=4) for p in prompts]
    sched._fill_slots()
    shared = set(sched._slot_pages[0]) & set(sched._slot_pages[1])
    assert len(shared) == n_shared, sched._slot_pages
    assert all(sched._page_refs[pid] == 2 for pid in shared)
    assert sched.prefix_hits == 1
    out = sched.run()
    for u, ju in zip(uids, juids):
        assert out[u] == jout[ju], (out[u], jout[ju])
    assert sched._pool.free_pages == sched._n_pages - 1
    assert not sched._prefix_index and not sched._page_refs


def test_scheduler_mode_errors(both_params):
    _, tp = both_params
    with pytest.raises(ValueError, match="paged"):
        Scheduler(CFG, tp, max_batch=2, max_len=64, prefix_cache=True)
    ms = Scheduler(CFG, tp, max_batch=2, max_len=64, multi_step=4,
                   generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="multi_step"):
        ms.submit(np.arange(4, dtype=np.int32), temperature=0.5)
    with pytest.raises(ValueError, match="60"):  # 64 less 4 reserved rows
        ms.submit(np.arange(50, dtype=np.int32), max_new_tokens=12)
