"""The port's ragged forward (`flash_attention_ragged` and
`flash_attention_ragged_kv_quant`, kernel 3) and the plan that routes it on
the card (`ops.paged_decode.ragged_plan`): chunks of T < 9 (the linear
speculative verify among them) take the slab route, the paged extend's
block over the linear cache seen as a pool of one page of S_max rows a
batch row; longer chunks the dense forward's wgmma kernel. On the CPU, in
float32: the plan's routes, row tiles and splits; the equivalence the slab
route rests on (the paged extend's plain version over the linear cache as a
pool equals the ragged forward's whenever q_offsets = kv_lens - T, and so
do its split partials at the plan's splits, merged); and the ragged
forward against the JAX package's (its Pallas kernel in interpret mode) on
the same numpy inputs at the edges of both routes' tiles: T 1, 5 and 9,
kv_lens 0, 1, 63, 64, 65 and S_max, S_max not a multiple of 64, causal
False, a window with sinks, fixed-max, bf16, int8 and e4m3 caches."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattention_kernel_project_tpu_torch.models.convert import params_from_jax
from flashattention_kernel_project_tpu_torch.ops import _build
from flashattention_kernel_project_tpu_torch.ops import flash_attention as tfa
from flashattention_kernel_project_tpu_torch.ops import flash_decode as tfd
from flashattention_kernel_project_tpu_torch.ops import paged_decode as tpd
from flashattention_kernel_project_tpu_torch.utils.platform import H100_SMS
from flashattention_kernel_project_tpu_torch.utils.testing import assert_rel_l2

jfa = importlib.import_module("flashattention_kernel_project_tpu.ops.flash_attention")
jq = importlib.import_module("flashattention_kernel_project_tpu.ops.quant")

torch.set_num_threads(1)

TOL = 1e-2  # rel-L2, the JAX suite's bound (tests/test_flash_attention.py)
SAME_TOL = 1e-5  # one function two ways in float32: the sums' order alone
TILE = 64
CPU = torch.device("cpu")
J_QUANT = {"int8": jq.quantize_int8, "fp8": jq.quantize_fp8_tokenwise}

# (b, hq, hkv, t, s_max, d, quant) -> (route, block_rows, row_tiles,
# n_splits, block_s): the linear verify (B 8, 16/4, T 5, S_max 2048), the
# serving chunk (T 256, S_max 2304), the threshold's edges (T 8 slab at B 1
# and 8; 9, 15, 16, 32, 64 wgmma, B 8 T 16 among them), G 8 x T 9 (wgmma:
# past the threshold), G 16 x T 8 (128 folded rows: two row tiles of 64),
# d 64, an 8-bit chunk (64-row blocks), a grid past one wave (128-row
# blocks), S_max not a multiple of 64, one tile
PLANS = {
    "verify": ((8, 16, 4, 5, 2048, 128, False), ("slab", 32, 1, 8, 256)),
    "verify 8-bit": ((8, 16, 4, 5, 2048, 128, True), ("slab", 32, 1, 8, 256)),
    "chunk": ((1, 16, 4, 256, 2304, 128, False), ("wgmma", 64, 4, 1, 2304)),
    "chunk 8-bit": ((1, 16, 4, 256, 2304, 128, True), ("wgmma", 64, 4, 1, 2304)),
    "t8": ((8, 16, 4, 8, 2048, 128, False), ("slab", 32, 1, 8, 256)),
    "b1 t8": ((1, 16, 4, 8, 2304, 128, False), ("slab", 32, 1, 18, 128)),
    "t9": ((1, 16, 4, 9, 2304, 128, False), ("wgmma", 64, 1, 1, 2304)),
    "t15": ((1, 16, 4, 15, 2304, 128, False), ("wgmma", 64, 1, 1, 2304)),
    "b8 t16": ((8, 16, 4, 16, 2048, 128, False), ("wgmma", 64, 1, 1, 2048)),
    "t16": ((1, 16, 4, 16, 2304, 128, False), ("wgmma", 64, 1, 1, 2304)),
    "t32": ((1, 16, 4, 32, 2304, 128, False), ("wgmma", 64, 1, 1, 2304)),
    "t64": ((1, 16, 4, 64, 2304, 128, False), ("wgmma", 64, 1, 1, 2304)),
    "g8 t9": ((2, 16, 2, 9, 1024, 128, False), ("wgmma", 64, 1, 1, 1024)),
    "g16 t8": ((2, 32, 2, 8, 1024, 128, False), ("slab", 64, 2, 8, 128)),
    "d64 t8": ((4, 16, 4, 8, 1000, 64, False), ("slab", 32, 1, 8, 128)),
    "d64": ((4, 16, 4, 5, 1000, 64, False), ("slab", 32, 1, 8, 128)),
    "wave": ((8, 16, 4, 256, 2048, 128, False), ("wgmma", 128, 2, 1, 2048)),
    "wave 8-bit": ((8, 16, 4, 256, 2048, 128, True), ("wgmma", 64, 4, 1, 2048)),
    "one tile": ((2, 4, 2, 1, 40, 128, False), ("slab", 16, 1, 1, 64)),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_ragged_plan(name):
    """The route, row tiles and splits at each shape; splits are whole
    64-key tiles, cover S_max with none empty, at most the kernel's cap;
    the slab route's cut is the paged extend's (`extend_plan` over a pool
    of one page of S_max rows)."""
    (b, hq, hkv, t, s_max, d, quant), want = PLANS[name]
    plan = tpd.ragged_plan(b, hq, hkv, t, s_max, d, quant)
    assert tuple(plan) == want
    assert plan.route == (tpd.RAGGED_SLAB if t < tpd.RAGGED_WGMMA_MIN_T
                          else tpd.RAGGED_WGMMA)
    assert plan.block_s % TILE == 0
    assert (plan.n_splits - 1) * plan.block_s < s_max <= plan.n_splits * plan.block_s
    assert 1 <= plan.n_splits <= tpd._EXTEND_MAX_SPLITS
    rows = hq // hkv * t if plan.route == tpd.RAGGED_SLAB else t
    assert (plan.row_tiles - 1) * plan.block_rows < rows <= plan.row_tiles * plan.block_rows
    if plan.route == tpd.RAGGED_SLAB:
        assert tuple(plan)[1:] == tpd.extend_plan((b, hq, t, d), hkv, s_max, 1)
        # no more blocks than the card holds at once, past one split
        blocks = b * hkv * plan.row_tiles * plan.n_splits
        assert plan.n_splits == 1 or blocks <= H100_SMS * tfd._blocks_per_sm(d)


def _linear_case(seed, b, hq, hkv, t, s_max, d, kv_lens, fmt):
    """(q, k, v as numpy float32 or (vals, scales) per JAX's quantizer,
    kv_lens) for a linear cache [b, hkv, s_max, d]."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, t, d)).astype(np.float32)
    kv = [rng.standard_normal((b, hkv, s_max, d)).astype(np.float32)
          for _ in range(2)]
    if fmt is not None:
        kv = [tuple(np.asarray(x) for x in J_QUANT[fmt](jnp.asarray(a), axis=-1))
              for a in kv]
    return q, kv, np.array(kv_lens, np.int32)


def _to(x):
    return params_from_jax(np.asarray(x), CPU)


@pytest.mark.parametrize("fmt", [None, "int8", "fp8"])
@pytest.mark.parametrize("t", [1, 5, 9])
def test_slab_route_is_the_paged_extend_over_one_page_a_row(t, fmt):
    """The linear cache [B, Hkv, S_max, D] is a pool of B pages of S_max
    rows with the table arange(B)[:, None] (the 8-bit scales [B, Hkv,
    S_max, 1] the lane-major scale pages [B, Hkv, 1, S_max]): the paged
    extend's plain version over it equals the ragged forward's when
    q_offsets = kv_lens - T, and so do its split partials at the slab
    route's cut (its plan below the threshold, T 1 and 5; at T 9 the cut
    the slab route would take), merged."""
    b, hq, hkv, s_max, d = 6, 8, 2, 100, 32
    kv_lens = [0, 1, 63, 64, 65, s_max]
    kv_lens = [max(n, t) if n else 0 for n in kv_lens]
    q, (k, v), lens = _linear_case(3, b, hq, hkv, t, s_max, d, kv_lens, fmt)
    offs = np.maximum(lens - t, 0).astype(np.int32)
    offs[lens == 0] = -t  # an empty row: its tokens before the cache
    table = torch.arange(b, dtype=torch.int32)[:, None]
    new, old = _to(lens), _to(offs)
    qt = _to(q)
    plan = tpd.ragged_plan(b, hq, hkv, t, s_max, d, fmt is not None)
    cut = tpd.extend_plan((b, hq, t, d), hkv, s_max, 1)  # the slab route's
    assert (plan.route == tpd.RAGGED_SLAB) == (t < tpd.RAGGED_WGMMA_MIN_T)
    if plan.route == tpd.RAGGED_SLAB:
        assert tuple(plan)[1:] == cut
    plan = tpd.RaggedPlan(tpd.RAGGED_SLAB, *cut)
    if fmt is None:
        kt, vt = _to(k), _to(v)
        ragged = tfa.flash_attention_ragged(qt, kt, vt, new, old)
        paged = tpd._paged_extend_plain(qt, kt, vt, table, new, old, d ** -0.5)
        parts = tpd._paged_extend_partials_plain(
            qt, kt, vt, table, new, old, plan.n_splits, plan.block_s, d ** -0.5)
    else:
        (kq, ks), (vq, vs) = k, v
        kq, vq = _to(kq), _to(vq)
        ks, vs = _to(ks), _to(vs)
        ks_pages, vs_pages = ks.transpose(-1, -2), vs.transpose(-1, -2)
        ragged = tfa.flash_attention_ragged_kv_quant(qt, kq, ks, vq, vs, new, old)
        paged = tpd._paged_extend_q_plain(qt, kq, ks_pages, vq, vs_pages, table,
                                          new, old, d ** -0.5)
        parts = tpd._paged_extend_q_partials_plain(
            qt, kq, ks_pages, vq, vs_pages, table, new, old, plan.n_splits,
            plan.block_s, d ** -0.5)
    merged = tpd._merge_extend(parts, qt)
    assert_rel_l2(paged.numpy(), ragged.numpy(), tol=SAME_TOL)
    assert_rel_l2(merged.numpy(), ragged.numpy(), tol=SAME_TOL)
    np.testing.assert_array_equal(ragged.numpy()[0], 0.0)
    np.testing.assert_array_equal(merged.numpy()[0], 0.0)


# the flavours held to JAX: causal (the serving verify and chunks), not
# causal, the band (window 70, 66 sinks: a sink tile and a band that cuts
# a 64-key tile), fixed-max
FLAVOURS = {
    "causal": dict(),
    "full": dict(causal=False),
    "window": dict(window=70, sinks=66),
    "fixed": dict(stable=False),
}


@pytest.mark.parametrize("fmt", [None, "int8", "fp8"])
@pytest.mark.parametrize("flavour", sorted(FLAVOURS))
@pytest.mark.parametrize("t", [1, 5, 9])
def test_ragged_matches_jax_at_the_edges(t, flavour, fmt):
    """flash_attention_ragged (_kv_quant for 8 bits) against JAX's at
    kv_lens 0, 1, 63, 64, 65 and S_max = 100 (not a multiple of 64), q
    offsets at and off kv_len - T (one before the cache), 8/2 heads, d 32;
    a row that sees no key is exactly 0."""
    b, hq, hkv, s_max, d = 6, 8, 2, 100, 32
    kw = FLAVOURS[flavour]
    q, (k, v), lens = _linear_case(11, b, hq, hkv, t, s_max, d,
                                   [0, 1, 63, 64, 65, s_max], fmt)
    offs = np.array([0, 0, 63 - t, 30, 65 - t, s_max - t], np.int32)
    offs[1] = -t  # token t - 1 sits at -1: with causal, row 1 sees no key
    jargs = dict(block_q=16, block_k=32, interpret=True, **kw)
    if fmt is None:
        jo = jfa.flash_attention_ragged(
            *(jnp.asarray(x) for x in (q, k, v, lens, offs)), **jargs)
        to = tfa.flash_attention_ragged(*(_to(x) for x in (q, k, v, lens, offs)),
                                        **kw)
    else:
        (kq, ks), (vq, vs) = k, v
        jo = jfa.flash_attention_ragged_kv_quant(
            *(jnp.asarray(x) for x in (q, kq, ks, vq, vs, lens, offs)), **jargs)
        to = tfa.flash_attention_ragged_kv_quant(
            *(_to(x) for x in (q, kq, ks, vq, vs, lens, offs)), **kw)
    assert to.shape == q.shape and torch.isfinite(to).all()
    assert_rel_l2(to.numpy(), np.asarray(jo), tol=TOL)
    np.testing.assert_array_equal(to.numpy()[0], 0.0)  # kv_len 0
    if kw.get("causal", True):
        np.testing.assert_array_equal(to.numpy()[1], 0.0)  # before the cache


def test_ragged_lengths_past_s_max_count_as_s_max():
    """kv_lens above S_max count as S_max (ROADMAP section C, "Ragged
    bounds"), on both plain versions the routes are held to."""
    q, (k, v), lens = _linear_case(5, 2, 4, 2, 5, 70, 32, [70, 70], None)
    offs = np.array([65, 10], np.int32)
    args = [_to(x) for x in (q, k, v)]
    want = tfa.flash_attention_ragged(*args, _to(lens), _to(offs))
    got = tfa.flash_attention_ragged(*args, _to(lens + 1000), _to(offs))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_cuda_ragged_calls_are_checked_before_any_build(monkeypatch):
    """A call the card's kernels do not take raises before the library is
    built or loaded, and never runs the plain version instead; CPU calls
    launch nothing on either route."""
    def no_build():
        raise AssertionError("the library was asked for")

    monkeypatch.setattr(_build, "library", no_build)
    bf = torch.zeros(1, 4, 5, 64, dtype=torch.bfloat16)
    with pytest.raises(TypeError):  # float32 K/V
        tfa._check_cuda_inputs(bf, torch.zeros(1, 2, 8, 64), torch.zeros(1, 2, 8, 64))
    with pytest.raises(TypeError):  # int64 bounds
        tfa._check_ragged_bounds(bf, torch.ones(1, dtype=torch.int64),
                                 torch.zeros(1, dtype=torch.int32))
    k8 = torch.zeros(1, 2, 8, 48, dtype=torch.int8)
    scale = torch.ones(1, 2, 8, 1)
    bounds = (torch.ones(1, dtype=torch.int32), torch.zeros(1, dtype=torch.int32))
    with pytest.raises((TypeError, ValueError)):  # d 48
        tfa._fwd_ragged_q_cuda(torch.zeros(1, 4, 5, 48, dtype=torch.bfloat16),
                               k8, scale, k8, scale, *bounds, True, 0.125)
    counters = (tfa.flash_attention_ragged, tfa.flash_attention_ragged_kv_quant)
    before = [(c.slab_launches, c.wgmma_launches, c.launches) for c in counters]
    q, (k, v), lens = _linear_case(2, 1, 4, 2, 5, 64, 32, [64], None)
    tfa.flash_attention_ragged(*(_to(x) for x in (q, k, v, lens)),
                               _to(np.array([59], np.int32)))
    after = [(c.slab_launches, c.wgmma_launches, c.launches) for c in counters]
    assert after == before == [(0, 0, 0)] * 2


class _OnTheCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device: it sends a wrapper down
    the card's path on a machine with no card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.mark.parametrize("fmt", [None, "int8", "fp8"])
@pytest.mark.parametrize("t", [5, 64])  # the slab route, the wgmma route
def test_cuda_ragged_call_without_a_library_raises(monkeypatch, t, fmt):
    """A call on CUDA tensors with no library to load raises the build's
    error: it never runs the plain version in the kernel's place, and
    counts no launch on either route."""
    class NoLibrary(RuntimeError):
        pass

    def no_library():
        raise NoLibrary("no kernel library")

    def no_plain(*args, **kw):
        raise AssertionError("the plain version ran on the card's path")

    monkeypatch.setattr(_build, "library", no_library)
    for name in ("_fwd_ragged_plain", "_fwd_ragged_q_plain"):
        monkeypatch.setattr(tfa, name, no_plain)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0}))
    for fn in (tfa._slab_kernel, tfa._ragged_kernel):
        fn.cache_clear()
    b, hq, hkv, s_max, d = 2, 16, 4, 256, 64
    assert tpd.ragged_plan(b, hq, hkv, t, s_max, d, fmt is not None).route == (
        tpd.RAGGED_SLAB if t == 5 else tpd.RAGGED_WGMMA)
    q, kv, lens = _linear_case(3, b, hq, hkv, t, s_max, d, [200, 256], fmt)
    card = lambda x: _to(x).as_subclass(_OnTheCard)  # noqa: E731
    q = card(q).bfloat16().as_subclass(_OnTheCard)
    bounds = (card(lens), card(np.zeros(b, np.int32)))
    if fmt is None:
        call = tfa.flash_attention_ragged
        cache = [card(x).bfloat16().as_subclass(_OnTheCard) for x in kv]
    else:
        call = tfa.flash_attention_ragged_kv_quant
        (kq, ks), (vq, vs) = kv
        cache = [card(kq), card(ks), card(vq), card(vs)]
    before = (call.slab_launches, call.wgmma_launches, call.launches)
    try:
        with pytest.raises(NoLibrary):
            call(q, *cache, *bounds)
    finally:
        for fn in (tfa._slab_kernel, tfa._ragged_kernel):
            fn.cache_clear()
    assert (call.slab_launches, call.wgmma_launches, call.launches) == before


def test_split_partials_merge_to_the_ragged_forward():
    """The slab route's split plan at the verify's G and T over a 2048-row
    cache (d 32: 16 splits of 128): the plain split partials of the linear
    cache as a pool, merged, equal the ragged forward, rows whose causal
    bound lies before a split included."""
    b, hq, hkv, t, s_max, d = 4, 16, 4, 5, 2048, 32
    q, (k, v), lens = _linear_case(7, b, hq, hkv, t, s_max, d,
                                   [5, 300, 1029, 2048], None)
    offs = (lens - t).astype(np.int32)
    plan = tpd.ragged_plan(b, hq, hkv, t, s_max, d)
    assert (plan.route, plan.n_splits, plan.block_s) == (tpd.RAGGED_SLAB, 16, 128)
    qt, kt, vt, new, old = (_to(x) for x in (q, k, v, lens, offs))
    parts = tpd._extend_partials(qt, kt, vt, new, old, plan.n_splits,
                                 plan.block_s, d ** -0.5)
    m, l, _ = parts
    assert (l[0, :, 1:] == 0).all() and (m[0, :, 1:] == tfa.NEG_INF).all()
    got = tpd._merge_extend(parts, qt)
    want = tfa.flash_attention_ragged(qt, kt, vt, new, old)
    assert_rel_l2(got.numpy(), want.numpy(), tol=SAME_TOL)
    assert tfd.merge_partials is tpd.merge_partials
