"""The port's paged extend (`paged_flash_extend`, the paged speculative
verify) at the edges of the Hopper kernel's split plan
(csrc/paged_extend_sm90.cuh: whole 64-key tiles a split, pages followed by
TMA boxes of gcd(page, 64) rows, the folded G * T rows in 16-row slabs,
the splits' partials merged on the card), against the JAX package's
`paged_flash_extend` (its Pallas kernel in interpret mode) on the same numpy
inputs, in float32 on the CPU: the plain split partials through
`merge_partials` at 1, 2 and the default number of splits, bf16 and 8-bit
pools; and the split rule, the row rule and the card's page rule."""

import importlib
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

TOL = 1e-4  # float32 on both sides (8-bit: the same values and scales)
SAME_TOL = 1e-5  # one function at two split plans: the sums' order alone
TILE = 64
CPU = torch.device("cpu")
J_QUANT = {"int8": jq.quantize_int8, "fp8": jq.quantize_fp8_tokenwise}
HEADER = os.path.join(os.path.dirname(tpd.__file__), os.pardir, "csrc",
                      "paged_extend_sm90.cuh")

# name: (b, hq, hkv, d, page, max_pages, t, old lengths). Every case has a
# row with old_len 0 and a row whose new length is the table's capacity.
CASES = {
    # G * T = 20 (the serving verify's fold) over pages of 16 (4 boxes a
    # tile): a chunk 62..66 across the 64-key split edge at 2 splits, a row
    # of 5 keys whose second split has no live key
    "g4_t5_page16": (3, 8, 2, 16, 16, 8, 5, [0, 62, 123]),
    # pages of 48 (16-row boxes, a tile across two pages), 144 keys
    "g2_t5_page48": (2, 4, 2, 16, 48, 3, 5, [0, 139]),
    # pages of 128 (a page two tiles), a chunk across the 128-key edge
    "g4_t3_page128": (3, 4, 1, 16, 128, 2, 3, [0, 126, 253]),
    # G * T = 72: two row tiles of 64 folded rows
    "g8_t9_page16": (2, 16, 2, 16, 16, 8, 9, [0, 119]),
}


def _table(rng, b, max_pages, page, new):
    """Each row's pages in order from a shuffled pool (entries past a row's
    pages name the junk page 0)."""
    n_pages = b * max_pages + 1
    perm = rng.permutation(np.arange(1, n_pages)).astype(np.int32)
    table = np.zeros((b, max_pages), np.int32)
    for i, n in enumerate(new):
        used = -(-int(n) // page)
        table[i, :used] = perm[i * max_pages:i * max_pages + used]
    return table


def _inputs(case, fmt, seed=0):
    """(q, pools, table, new, old) as numpy / JAX arrays: pools (k, v) in
    float32, or ((k, k_scale), (v, v_scale)) quantized by the JAX package
    with lane-major scale pages."""
    b, hq, hkv, d, page, max_pages, t, old = CASES[case]
    rng = np.random.default_rng(seed)
    n_pages = b * max_pages + 1
    q = rng.standard_normal((b, hq, t, d)).astype(np.float32)
    old = np.array(old, np.int32)
    new = old + t
    assert new.max() == max_pages * page and old.min() == 0
    kv = [rng.standard_normal((n_pages, hkv, page, d)).astype(np.float32)
          for _ in range(2)]
    if fmt != "f32":
        kv = [(vals, jnp.swapaxes(scales, -1, -2)) for vals, scales in
              (J_QUANT[fmt](jnp.asarray(x), axis=-1) for x in kv)]
    return q, kv, _table(rng, b, max_pages, page, new), new, old


def _jax(q, pools, table, new, old):
    kw = {}
    if isinstance(pools[0], tuple):
        (k, ks), (v, vs) = pools
        kw = dict(k_scale_pages=ks, v_scale_pages=vs)
    else:
        k, v = pools
    return np.asarray(jpd.paged_flash_extend(
        *(jnp.asarray(x) for x in (q, k, v, table, new, old)), interpret=True,
        **kw))


def _torch_args(q, pools, table, new, old):
    """The port's plain partials' arguments before (n_splits, block_s,
    sm_scale), and the function."""
    to = lambda x: params_from_jax(np.asarray(x), CPU)  # noqa: E731
    if isinstance(pools[0], tuple):
        (k, ks), (v, vs) = pools
        return (tpd._paged_extend_q_partials_plain,
                (to(q), to(k), to(ks), to(v), to(vs), to(table), to(new), to(old)))
    k, v = pools
    return (tpd._paged_extend_partials_plain,
            (to(q), to(k), to(v), to(table), to(new), to(old)))


def _splits(case, n_splits):
    """(n_splits, block_s) of the kernel's plan for the case: n_splits None
    takes the default rule."""
    b, hq, hkv, d, page, max_pages, t, _ = CASES[case]
    _, _, n, block_s = tpd.extend_plan((b, hq, t, d), hkv, page, max_pages,
                                       n_splits)
    return n, block_s


@pytest.mark.parametrize("n_splits", [1, 2, None])
@pytest.mark.parametrize("fmt", ["f32", "int8", "fp8"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_split_partials_merged_match_jax(case, fmt, n_splits):
    """The kernel's function as split partials (whole 64-key tiles, the
    plan's block_s) merged through `merge_partials`, against JAX's extend,
    at one split, two and the default; every row finite."""
    q, pools, table, new, old = _inputs(case, fmt)
    jo = _jax(q, pools, table, new, old)
    fn, args = _torch_args(q, pools, table, new, old)
    n, block_s = _splits(case, n_splits)
    assert block_s % TILE == 0 and (n - 1) * block_s < table.shape[1] * CASES[case][4]
    parts = fn(*args, n, block_s, q.shape[-1] ** -0.5)
    got = tpd._merge_extend(parts, args[0])
    assert got.shape == q.shape and torch.isfinite(got).all()
    assert_rel_l2(got.numpy(), jo, tol=TOL)


def test_a_split_with_no_live_key_weighs_nothing():
    """At 2 splits of 64 keys, the row of 5 keys has no live key in its
    second split (m NEG_INF, l 0, y 0: weight 0 in the merge), and the chunk
    at 62..66 has rows whose causal bound ends before the second split
    (l 0 there) beside rows that see it."""
    q, pools, table, new, old = _inputs("g4_t5_page16", "f32")
    fn, args = _torch_args(q, pools, table, new, old)
    m, l, y = fn(*args, 2, 64, 0.25)
    t = 5
    assert torch.all(l[0, :, 1] == 0) and torch.all(y[0, :, 1] == 0)
    assert torch.all(m[0, :, 1] <= -1e29)
    # row 1 (old 62): chunk tokens tr = 0, 1 stop at keys 62, 63; tr >= 2 see 64..
    tr = torch.arange(l.shape[3]) % t
    assert torch.all(l[1, :, 1, :, 0][:, tr < 2] == 0)
    assert torch.all(l[1, :, 1, :, 0][:, tr >= 2] > 0)
    assert torch.isfinite(tpd._merge_extend((m, l, y), args[0])).all()


@pytest.mark.parametrize("case", sorted(CASES))
def test_output_does_not_change_with_the_split_plan(case):
    """One split, the default and caller's counts (block_s whole tiles, up
    to more splits than tiles, the tail's splits empty) give one function;
    the merged partials equal the plain extend."""
    q, pools, table, new, old = _inputs(case, "f32", seed=1)
    fn, args = _torch_args(q, pools, table, new, old)
    plain = tpd._paged_extend_plain(*args, q.shape[-1] ** -0.5)
    for n_splits in (1, 2, 3, 7, None):
        n, block_s = _splits(case, n_splits)
        got = tpd._merge_extend(fn(*args, n, block_s, q.shape[-1] ** -0.5), args[0])
        assert_rel_l2(got.numpy(), plain.numpy(), tol=SAME_TOL)


def test_kernel_partials_layout():
    """The workspace the kernel writes ([B, Hkv, row_tiles, n_splits,
    block_rows, width] flat) reads as the plain partials' [B, Hkv,
    n_splits, rows, width], row tile by row tile, padding rows dropped."""
    b, hkv, row_tiles, n_splits, block_rows, rows, width = 2, 3, 2, 4, 64, 72, 5
    flat = torch.arange(b * hkv * row_tiles * n_splits * block_rows * width,
                        dtype=torch.float32)
    got = tpd._kernel_partials(flat, (b, hkv, row_tiles, n_splits, block_rows),
                               rows, width)
    assert got.shape == (b, hkv, n_splits, rows, width)
    full = flat.view(b, hkv, row_tiles, n_splits, block_rows, width)
    for r in (0, 63, 64, 71):
        assert torch.equal(got[:, :, :, r], full[:, :, r // 64, :, r % 64])


@pytest.mark.parametrize("rows,block_rows,row_tiles", [
    (1, 16, 1), (5, 16, 1), (16, 16, 1), (17, 32, 1), (20, 32, 1),
    (32, 32, 1), (33, 64, 1), (40, 64, 1), (64, 64, 1), (72, 64, 2),
    (128, 64, 2), (129, 64, 3)])
def test_block_rows_take_the_fewest_slabs(rows, block_rows, row_tiles):
    """G * T folded rows take the fewest 16-row slabs that hold them, up to
    four a block; more rows take more row tiles of 64."""
    assert tpd.extend_block_rows(rows) == block_rows
    _, tiles, _, _ = tpd.extend_plan((1, rows, 1, 128), 1, 16, 4)
    assert tiles == row_tiles


@pytest.mark.parametrize("b,hkv,row_tiles,capacity,d", [
    (8, 4, 1, 2048, 128),   # the serving verify: 16 pages of 128
    (8, 4, 1, 16 * 128, 64),
    (1, 1, 1, 64, 128),     # one tile
    (1, 1, 1, 100, 128),    # under two tiles
    (2, 2, 2, 48 * 3, 128),  # pages of 48, two row tiles
    (1, 1, 1, 1 << 16, 128),  # a long table: the split cap
    (64, 8, 1, 4096, 128),  # the triples fill the card
    (3, 5, 1, 1000, 64),
])
def test_split_rule_whole_tiles_covering_the_capacity(b, hkv, row_tiles,
                                                      capacity, d):
    """Whole 64-key tiles, at least two a split unless one split holds the
    table, at most 64 splits, together covering the capacity with no empty
    split, and no more blocks than the card holds unless one split."""
    n = tpd.extend_n_splits(b, hkv, row_tiles, capacity, d)
    block_s = tfd.default_block_s(capacity, n)
    assert 1 <= n <= tpd._EXTEND_MAX_SPLITS and block_s % TILE == 0
    assert (n - 1) * block_s < capacity <= n * block_s
    assert n == 1 or block_s >= 2 * TILE
    assert n == 1 or b * hkv * row_tiles * n <= H100_SMS * tfd._blocks_per_sm(d)


def test_split_rule_fills_the_card_or_takes_one():
    """At the serving verify 8 splits of 256 keys bring 32 (row, KV head)
    pairs to 256 blocks; where the triples already fill the card, or the
    table is one tile, one split."""
    assert tpd.extend_n_splits(8, 4, 1, 2048) == 8
    assert tfd.default_block_s(2048, 8) == 256
    assert 8 * 4 * tpd.extend_n_splits(8, 4, 1, 2048) >= H100_SMS
    assert tpd.extend_n_splits(64, 8, 1, 4096) == 1
    assert tpd.extend_n_splits(1, 1, 1, TILE) == 1
    assert tpd.extend_n_splits(1, 1, 1, 1 << 16) == tpd._EXTEND_MAX_SPLITS


@pytest.mark.parametrize("page", [16, 32, 48, 64, 80, 96, 112, 128])
def test_card_page_rule_takes_16_to_128_in_steps_of_16(page):
    tpd._check_kernel_page(page, "paged extend")


@pytest.mark.parametrize("page", [8, 24, 136])
def test_card_page_rule_refuses_other_pages(page):
    with pytest.raises(ValueError, match="pages of 16 to 128 rows in steps of 16"):
        tpd._check_kernel_page(page, "paged extend")


def test_cuda_wrappers_refuse_before_launching():
    """On bf16 tensors the card's checks run before any launch: a page of 8
    rows (the CPU path takes it) and a split count past the kernel's are
    ValueErrors."""
    rng = np.random.default_rng(2)
    b, hq, hkv, d, t = 2, 8, 2, 64, 5
    bq = torch.from_numpy(rng.standard_normal((b, hq, t, d))).bfloat16()
    old = torch.tensor([0, 11], dtype=torch.int32)
    new = old + t
    table = torch.tensor([[1, 0], [2, 3]], dtype=torch.int32)
    for page, n_splits, match in ((8, 2, "pages of 16 to 128"),
                                  (16, 65, "1 to 64 splits")):
        k, v = (torch.from_numpy(rng.standard_normal((4, hkv, page, d))).bfloat16()
                for _ in range(2))
        with pytest.raises(ValueError, match=match):
            tpd._extend_cuda(bq, (k, v), table, new, old, 0.25, n_splits,
                             whole=False)
    with pytest.raises(ValueError, match="pages of 16 to 128"):
        tpd._paged_extend_cuda(bq, k[:, :, :8].contiguous(),
                               v[:, :, :8].contiguous(), table, new, old, 0.25)
    assert tpd.paged_flash_extend.launches == 0


def test_plan_matches_the_kernel_header():
    """The wrapper's tile, split cap, counter capacity and page bounds are
    the kernel's (csrc/paged_extend_sm90.cuh)."""
    with open(HEADER) as f:
        src = f.read()

    def const(name):  # an integer, or 1 << n
        value = re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)
        base, _, shift = value.partition(" << ")
        return int(base) << int(shift or 0)

    assert const("kTile") == tfd._TILE
    assert const("kStages") == tfd._STAGES
    assert const("kMaxSplits") == tpd._EXTEND_MAX_SPLITS
    assert const("kMaxCounters") == tpd._EXTEND_MAX_COUNTERS
    assert (const("kMinPage"), const("kMaxPage")) == (16, tpd._MAX_PAGE)
