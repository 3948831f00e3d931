"""The port's paged decode (`paged_flash_decode`, `paged_flash_decode_quant`)
at the edges of the Hopper kernel's split plan (`decode_plan`: whole 64-key
tiles a split, sized from the table's capacity; csrc/paged_extend_sm90.cuh
at T = 1, built by csrc/paged_decode*.cu), against the JAX package's
paged decodes (their Pallas kernels in interpret mode) on the same numpy
inputs, on the CPU: the plain split partials over the plan, merged, over
float32, int8 and e4m3 pools and with the int8 score product, in both
schedules; the plan's rules; a split with no live key; the copy probe
over the port's splits; the card's checks before any launch."""

import importlib
import math
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattention_kernel_project_tpu_torch.models.convert import params_from_jax
from flashattention_kernel_project_tpu_torch.ops import flash_decode as tfd
from flashattention_kernel_project_tpu_torch.ops import paged_decode as tpd
from flashattention_kernel_project_tpu_torch.utils.platform import H100_SMS
from flashattention_kernel_project_tpu_torch.utils.testing import assert_rel_l2

jpd = importlib.import_module("flashattention_kernel_project_tpu.ops.paged_decode")
jq = importlib.import_module("flashattention_kernel_project_tpu.ops.quant")

torch.set_num_threads(1)

# float32 on both sides; an 8-bit pool's values and scales are the JAX
# package's, and exp and the order of the sums differ (the int8 score
# product: the same integer dots, a weight on a rounding edge may differ)
TOLS = {"f32": 1e-4, "int8": 1e-3, "fp8": 1e-3, "q_int8": 1e-3}
TILE = 64
CPU = torch.device("cpu")
J_QUANT = {"int8": jq.quantize_int8, "fp8": jq.quantize_fp8_tokenwise,
           "q_int8": jq.quantize_int8}
HEADER = os.path.join(os.path.dirname(tpd.__file__), os.pardir, "csrc",
                      "paged_extend_sm90.cuh")

# name: (b, hq, hkv, d, page, max_pages, lengths). Each case has a row of
# length 0 and lengths on and about a 64-key tile's edge, a split's edge
# (the gather plan's block_s) or the capacity, and past it.
CASES = {
    # G 4, d 64, pages of 16 (4 pages a tile), capacity 192: the gather
    # plan takes one split (three tiles), gather=False three of one tile
    "g4_d64_page16": (4, 8, 2, 64, 16, 12, [0, 63, 65, 200]),
    # G 1, d 128, pages of 48 (a tile across two pages), capacity 480:
    # gather=False splits of 192 keys (4 pages), a row ending on the
    # second split's edge and one past the capacity
    "g1_d128_page48": (3, 2, 2, 128, 48, 10, [0, 192, 481]),
    # G 8, d 64, pages of 128 (two tiles a page), capacity 384
    "g8_d64_page128": (3, 8, 1, 64, 128, 3, [0, 128, 383]),
    # G 8, d 128, pages of 16, capacity 256: lengths at tile edges
    "g8_d128_page16": (2, 16, 2, 128, 16, 16, [64, 0]),
}
FMTS = ("f32", "int8", "fp8", "q_int8")


def _table(rng, b, max_pages, page, lengths):
    """Each row's pages in order from a shuffled pool (entries past a row's
    pages name the junk page 0)."""
    n_pages = b * max_pages + 1
    perm = rng.permutation(np.arange(1, n_pages)).astype(np.int32)
    table = np.zeros((b, max_pages), np.int32)
    for i, n in enumerate(lengths):
        used = min(-(-int(n) // page), max_pages)
        table[i, :used] = perm[i * max_pages:i * max_pages + used]
    return table


def _inputs(case, fmt, seed=0):
    """(q, pools, table, lengths) as numpy / JAX arrays: pools (k, v) in
    float32, or (k, k_scale, v, v_scale) quantized by the JAX package with
    lane-major scale pages."""
    b, hq, hkv, d, page, max_pages, lengths = CASES[case]
    rng = np.random.default_rng(seed)
    n_pages = b * max_pages + 1
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    kv = [rng.standard_normal((n_pages, hkv, page, d)).astype(np.float32)
          for _ in range(2)]
    if fmt == "f32":
        pools = tuple(kv)
    else:
        (k, ks), (v, vs) = (J_QUANT[fmt](jnp.asarray(x), axis=-1) for x in kv)
        pools = (k, jnp.swapaxes(ks, -1, -2), v, jnp.swapaxes(vs, -1, -2))
    lengths = np.array(lengths, np.int32)
    return q, pools, _table(rng, b, max_pages, page, lengths), lengths


def _jax(q, pools, table, lengths, fmt, gather):
    args = [jnp.asarray(x) for x in (q, *pools, table, lengths)]
    if fmt == "f32":
        return np.asarray(jpd.paged_flash_decode(*args, gather=gather,
                                                 interpret=True))
    return np.asarray(jpd.paged_flash_decode_quant(
        *args, gather=gather, q_int8=fmt == "q_int8", interpret=True))


def _plain(fmt):
    return {"f32": tpd._paged_partials_plain, "int8": tpd._paged_partials_q_plain,
            "fp8": tpd._paged_partials_q_plain,
            "q_int8": tpd._paged_partials_qi8_plain}[fmt]


def _torch_args(q, pools, table, lengths):
    to = lambda x: params_from_jax(np.asarray(x), CPU)  # noqa: E731
    return tuple(to(x) for x in (q, *pools, table, lengths))


def _plan(case, gather):
    b, hq, hkv, d, page, max_pages, _ = CASES[case]
    return tpd.decode_plan(b, hkv, page, max_pages, d, gather)


# JAX takes the int8 score product with gather=True only
SCHEDULES = [(fmt, gather) for fmt in FMTS for gather in (True, False)
             if gather or fmt != "q_int8"]


@pytest.mark.parametrize("fmt,gather", SCHEDULES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_partials_over_the_plan_match_jax(case, fmt, gather):
    """The kernel's function as split partials over the plan (whole 64-key
    tiles covering the capacity), merged, against JAX's decode in the same
    schedule; a row of length 0 exactly 0, a length past the capacity
    read as the capacity, and the public wrapper the same function."""
    q, pools, table, lengths = _inputs(case, fmt)
    jo = _jax(q, pools, table, lengths, fmt, gather)
    args = _torch_args(q, pools, table, lengths)
    n_splits, block_s = _plan(case, gather)
    d = q.shape[-1]
    parts = _plain(fmt)(*args, block_s, d ** -0.5)
    assert parts[2].shape[2] == n_splits
    got = tfd.merge_partials(*parts).reshape(q.shape)
    assert torch.isfinite(got).all()
    assert_rel_l2(got.numpy(), jo, tol=TOLS[fmt])
    for row, n in enumerate(lengths):
        if n == 0:
            assert torch.all(got[row] == 0)
    fn = tpd.paged_flash_decode if fmt == "f32" else tpd.paged_flash_decode_quant
    kw = {"q_int8": True} if fmt == "q_int8" else {}
    torch.testing.assert_close(fn(*args, gather=gather, **kw), got, rtol=0, atol=0)
    assert fn.launches == 0 and getattr(fn, "q_int8_launches", 0) == 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_both_schedules_and_every_depth_give_one_function(case):
    """gather True and False differ in the order of the sums alone; slots
    leaves the plain version's output as it is."""
    q, k, v, table, lengths = _torch_args(*_inputs(case, "f32", seed=1))
    want = tpd.paged_flash_decode(q, k, v, table, lengths)
    got = tpd.paged_flash_decode(q, k, v, table, lengths, gather=False)
    assert_rel_l2(got.numpy(), want.numpy(), tol=1e-5)
    for slots in (3, 4):
        assert torch.equal(tpd.paged_flash_decode(q, k, v, table, lengths,
                                                  slots=slots), want)


@pytest.mark.parametrize("b,hkv,page,max_pages,d", [
    (8, 4, 128, 16, 128),   # the serving shape: 8 splits of 256 keys
    (8, 4, 128, 64, 128),   # 8192 keys a row
    (8, 4, 16, 128, 128),   # pages of 16
    (4, 2, 48, 10, 64),     # pages of 48: a split across pages
    (1, 1, 112, 3, 128),    # capacity 336: under six tiles
    (64, 8, 128, 16, 128),  # B * Hkv fills the card
    (1, 1, 128, 1000, 128),  # a long table: the split cap
    (300000, 1, 16, 4, 64),  # past the merge's 2^18 counters
])
@pytest.mark.parametrize("gather", [True, False])
def test_plan_takes_whole_tiles_within_the_caps(b, hkv, page, max_pages, d,
                                                gather):
    """Whole 64-key tiles, together covering the capacity with no empty
    split, at most 64 splits, more than one only where the merge's counters
    hold B * Hkv; gather=True: at least two tiles a split unless one split
    holds the table, and no more blocks than the card holds unless one
    split; gather=False: splits of whole pages (lcm(page, 64) keys)."""
    n, block_s = tpd.decode_plan(b, hkv, page, max_pages, d, gather)
    capacity = max_pages * page
    assert block_s % TILE == 0 and 1 <= n <= tpd._EXTEND_MAX_SPLITS
    assert (n - 1) * block_s < capacity <= n * block_s
    assert n == 1 or b * hkv <= tpd._EXTEND_MAX_COUNTERS
    if gather:
        assert n == 1 or block_s >= 2 * TILE
        assert n == 1 or b * hkv * n <= H100_SMS * tfd._blocks_per_sm(d)
        assert (n, block_s) == (tpd.extend_n_splits(b, hkv, 1, capacity, d),
                                tfd.default_block_s(capacity, n))
    else:
        assert block_s % math.lcm(page, TILE) == 0


def test_plan_at_the_serving_shape_and_where_the_card_fills():
    """8 splits of 256 keys bring 32 (row, KV head) pairs to 256 blocks;
    where B * Hkv fills the card, one split; gather=False takes splits of
    the fewest whole pages that make whole tiles."""
    assert tpd.decode_plan(8, 4, 128, 16) == (8, 256)
    assert tpd.decode_plan(64, 8, 128, 16)[0] == 1
    assert tpd.decode_plan(8, 4, 128, 16, gather=False) == (16, 128)
    assert tpd.decode_plan(8, 4, 48, 16, gather=False) == (4, 192)
    assert tpd.decode_plan(8, 4, 16, 16, gather=False) == (4, 64)
    assert tpd.decode_plan(1, 1, 128, 1000, gather=False) == (63, 2048)


def test_a_split_with_no_live_key_weighs_nothing():
    """At gather=False's splits of 64 keys (pages of 16), the row of 63
    keys has no live key past its first split: m NEG_INF, l 0, y 0, weight
    0 in the merge; the row of length 0 has none at all."""
    q, k, v, table, lengths = _torch_args(*_inputs("g4_d64_page16", "f32"))
    n, block_s = _plan("g4_d64_page16", False)
    m, l, y = tpd._paged_partials_plain(q, k, v, table, lengths, block_s, 0.125)
    assert (n, block_s) == (3, 64)
    assert torch.all(l[1, :, 1:] == 0) and torch.all(y[1, :, 1:] == 0)
    assert torch.all(m[1, :, 1:] <= -1e29) and torch.all(l[1, :, 0] > 0)
    assert torch.all(l[0] == 0)
    out = tfd.merge_partials(m, l, y)
    assert torch.isfinite(out).all() and torch.all(out[0] == 0)


@pytest.mark.parametrize("gather", [True, False])
def test_copy_only_over_the_plan_is_its_definition(gather):
    """copy_only over the port's splits: for q head h * G + g, the sum over
    the splits that start below the row's length of k + v at the split's
    first key row + g, read whole; gather=False takes no probe option, as
    JAX's one-page kernel."""
    q, k, v, table, lengths = _torch_args(*_inputs("g8_d128_page16", "f32"))
    got = tpd.paged_flash_decode(q, k, v, table, lengths, copy_only=True,
                                 gather=gather)
    if not gather:
        assert torch.equal(got, tpd.paged_flash_decode(q, k, v, table, lengths,
                                                       gather=False))
        return
    _, block_s = _plan("g8_d128_page16", True)
    b, hq, d = q.shape
    hkv, page = k.shape[1], k.shape[2]
    g = hq // hkv
    want = torch.zeros(b, hkv, g, d)
    for row in range(b):
        for start in range(0, table.shape[1] * page, block_s):
            if start < int(lengths[row]):
                pid = int(table[row, start // page])
                r = start % page
                want[row] += k[pid, :, r:r + g] + v[pid, :, r:r + g]
    assert torch.equal(got, want.reshape(b, hq, d))
    assert tpd.paged_flash_decode.copy_only_launches == 0


def test_plan_matches_the_kernel_header():
    """The wrapper's tile, split cap, counter capacity, decode rows and page
    bounds are the kernel's (csrc/paged_extend_sm90.cuh)."""
    with open(HEADER) as f:
        src = f.read()

    def const(name):  # an integer, or 1 << n
        value = re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)
        base, _, shift = value.partition(" << ")
        return int(base) << int(shift or 0)

    assert const("kTile") == tfd._TILE == TILE
    assert const("kMaxSplits") == tpd._EXTEND_MAX_SPLITS
    assert const("kMaxCounters") == tpd._EXTEND_MAX_COUNTERS
    assert const("kDecodeRows") == tpd._DECODE_ROWS
    assert max(tfd._KERNEL_GROUPS) <= const("kDecodeRows")
    assert (const("kMinPage"), const("kMaxPage")) == (16, tpd._MAX_PAGE)


def _bf16_call(page=16, g=2, d=64, max_pages=4):
    rng = np.random.default_rng(5)
    b, hkv = 2, 2
    q = torch.from_numpy(rng.standard_normal((b, g * hkv, d))).bfloat16()
    pool = torch.from_numpy(rng.standard_normal((5, hkv, page, d))).bfloat16()
    table = torch.zeros(b, max_pages, dtype=torch.int32)
    table[:, :2] = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    return q, pool, table, torch.tensor([20, 0], dtype=torch.int32)


@pytest.mark.parametrize("bad,match", [
    (dict(page=8), "pages of 16 to 128"),
    (dict(page=24), "pages of 16 to 128"),
    (dict(g=3), "Hq/Hkv in"),
    (dict(g=16), "Hq/Hkv in"),
    (dict(d=32), "d in"),
    (dict(slots=5), "slots in"),
    (dict(slots=3, copy_only=True), "copy_only runs at slots=2"),
    (dict(block_s=96), "whole 64-key tiles"),
    (dict(page=128, max_pages=33), "1 to 64 splits"),
])
def test_cuda_wrappers_refuse_before_launching(bad, match):
    """On bf16 and 8-bit tensors the card's checks run before any launch:
    pages outside 16..128 in steps of 16, G outside {1, 2, 4, 8}, d outside
    {64, 128}, slots outside {2, 3, 4}, copy_only at another depth, splits
    not of whole tiles or more than 64 of them."""
    bad = dict(bad)
    slots, copy_only = bad.pop("slots", 2), bad.pop("copy_only", False)
    block_s = bad.pop("block_s", 64)
    q, pool, table, lengths = _bf16_call(**bad)
    k8 = pool.to(torch.int8)
    scale = torch.ones(pool.shape[0], pool.shape[1], 1, pool.shape[2])
    calls = [lambda: tpd._paged_partials_cuda(q, pool, pool, table, lengths,
                                              block_s, 0.1, slots, copy_only)]
    if not copy_only:
        calls += [lambda: tpd._paged_partials_q_cuda(q, k8, scale, k8, scale,
                                                     table, lengths, block_s,
                                                     0.1, slots),
                  lambda: tpd._paged_partials_qi8_cuda(q, k8, scale, k8, scale,
                                                       table, lengths, block_s,
                                                       0.1, slots)]
    for call in calls:
        with pytest.raises(ValueError, match=match):
            call()
    assert tpd.paged_flash_decode.launches == 0
    assert tpd.paged_flash_decode_quant.launches == 0
