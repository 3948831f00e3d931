"""The port's bf16 linear decode (`flash_decode`) at the edges of the Hopper
kernel's tiles and splits (csrc/flash_decode_sm90.cuh: 64-key tiles, each
split in whole tiles from its first key, a window's sinks and band as two
key ranges), against the JAX package's `flash_decode` (its Pallas kernel in
interpret mode) on the same numpy inputs, in float32 on the CPU, where the
port's wrapper runs its plain version; and the split rule that sizes the
kernel's splits for any batch."""

import importlib
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattention_kernel_project_tpu_torch.ops import flash_decode as tfd
from flashattention_kernel_project_tpu_torch.utils.platform import H100_SMS
from flashattention_kernel_project_tpu_torch.utils.testing import assert_rel_l2

jfd = importlib.import_module("flashattention_kernel_project_tpu.ops.flash_decode")

torch.set_num_threads(1)

TOL = 1e-4  # float32 on both sides, as tests/test_torch_ops.py
SAME_TOL = 1e-5  # one function at two split counts: the sums' order alone
TILE = 64
S_OFF = 200  # a cache off a multiple of the tile
EDGE_LENGTHS = [0, 1, 63, 64, 65, 127, S_OFF]
GROUPS = [(2, 2), (4, 2), (4, 1), (8, 1)]  # (hq, hkv): G = 1, 2, 4, 8
HEADER = os.path.join(os.path.dirname(tfd.__file__), os.pardir, "csrc",
                      "flash_decode_sm90.cuh")


def _inputs(seed, b, hq, hkv, s, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    return q, k, v


def _both(q, k, v, lengths, **kw):
    """(JAX's output, the port's) for the same call, as numpy."""
    lengths = np.asarray(lengths, np.int32)
    jo = jfd.flash_decode(*map(jnp.asarray, (q, k, v, lengths)), interpret=True,
                          **kw)
    to = tfd.flash_decode(*map(torch.from_numpy, (q, k, v, lengths)), **kw)
    assert tuple(to.shape) == q.shape and to.dtype == torch.float32
    return np.asarray(jo), to.numpy()


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("hq,hkv", GROUPS)
def test_lengths_at_tile_edges_match_jax(hq, hkv, d):
    """Lengths 0, 1, 63, 64, 65, 127 and S with S off the tile, at the
    port's default splits (whole tiles) and JAX's; a length of 0 gives
    zeros."""
    q, k, v = _inputs(1, len(EDGE_LENGTHS), hq, hkv, S_OFF, d)
    jo, to = _both(q, k, v, EDGE_LENGTHS)
    assert_rel_l2(to, jo, tol=TOL)
    np.testing.assert_array_equal(to[0], 0.0)


@pytest.mark.parametrize("d", [64, 128])
def test_caller_splits_off_the_tile_match_jax(d):
    """A caller's n_splits = 3 over S = 200 gives splits of 67 keys (JAX
    pads them to 72): neither starts on a tile; lengths above S clamp."""
    lengths = [0, 66, 67, 134, 135, S_OFF, 999]
    q, k, v = _inputs(2, len(lengths), 4, 1, S_OFF, d)
    jo, to = _both(q, k, v, np.minimum(lengths, S_OFF), n_splits=3)
    assert_rel_l2(to, jo, tol=TOL)
    over = tfd.flash_decode(*map(torch.from_numpy, (q, k, v)),
                            torch.tensor(lengths, dtype=torch.int32), n_splits=3)
    np.testing.assert_array_equal(over.numpy(), to)


@pytest.mark.parametrize("n_splits", [None, 2, 3])
@pytest.mark.parametrize("hq,hkv,d", [(2, 2, 64), (8, 1, 128)])
def test_window_wider_than_a_tile_match_jax(hq, hkv, d, n_splits):
    """A window of 70 keys and 66 sinks, each wider than a tile. At
    n_splits = 2 the first split [0, 150) of the length-200 row holds the
    sinks [0, 66) and the band's start [130, 150) with a gap between: the
    window cuts it into two ranges."""
    s = 300
    lengths = [0, 1, 50, 66, 136, 137, 200, 250, s]
    q, k, v = _inputs(3, len(lengths), hq, hkv, s, d)
    kw = dict(window=70, sinks=66)
    if n_splits is not None:
        kw["n_splits"] = n_splits
    jo, to = _both(q, k, v, lengths, **kw)
    assert_rel_l2(to, jo, tol=TOL)
    np.testing.assert_array_equal(to[0], 0.0)


@pytest.mark.parametrize("b,hkv,s,d", [
    (8, 4, 2048, 128),   # the serving shape
    (256, 1, 4096, 128),  # run_all.py's streaming rung
    (1, 1, 4096, 128),
    (1, 1, 100, 64),      # under two tiles
    (2, 2, 200, 64),
    (3, 8, 1000, 128),
    (64, 8, 8192, 64),
    (1, 4, 65, 128),
])
def test_default_splits_cover_every_key_once_in_whole_tiles(b, hkv, s, d):
    """The default splits [i * block_s, (i + 1) * block_s) are whole tiles,
    at least two unless one split holds the cache, every one starting below
    S (no empty split), together covering [0, S) once."""
    n = tfd.default_n_splits(b, hkv, s, d)
    block_s = tfd.default_block_s(s, n)
    assert n >= 1 and block_s % TILE == 0
    assert (n - 1) * block_s < s <= n * block_s
    assert n == 1 or block_s >= 2 * TILE
    # as many blocks as the card holds, and no more unless one split
    assert n == 1 or b * hkv * n <= H100_SMS * tfd._blocks_per_sm(d)


def test_default_splits_fill_the_card_or_take_one():
    """At the serving shape the splits bring B * Hkv = 32 blocks to at
    least the 132 SMs; where B * Hkv already fills the card (B 256 x Hkv
    1), one split; a cache of one tile, one split."""
    assert 8 * 4 * tfd.default_n_splits(8, 4, 2048) >= H100_SMS
    assert tfd.default_n_splits(256, 1, 4096) == 1
    assert tfd.default_n_splits(1, 1, TILE) == 1
    assert (tfd._blocks_per_sm(128), tfd._blocks_per_sm(64)) == (2, 4)


@pytest.mark.parametrize("window,sinks", [(None, 0), (70, 66)])
def test_output_does_not_change_with_the_split_count(window, sinks):
    """The default splits, one split and caller's splits off the tile give
    one function: only the order of the sums differs."""
    s = 700
    lengths = torch.tensor([0, 1, 64, 65, 333, 640, s], dtype=torch.int32)
    q, k, v = map(torch.from_numpy, _inputs(4, len(lengths), 8, 2, s, 64))
    kw = dict(window=window, sinks=sinks)
    one = tfd.flash_decode(q, k, v, lengths, n_splits=1, **kw)
    for n_splits in (None, 2, 3, 7, 11):
        got = tfd.flash_decode(q, k, v, lengths, n_splits=n_splits, **kw)
        assert_rel_l2(got.numpy(), one.numpy(), tol=SAME_TOL)


def test_split_rule_matches_the_kernel_header():
    """The rule's tile, ring depth and counter capacity are the kernel's
    (csrc/flash_decode_sm90.cuh)."""
    with open(HEADER) as f:
        src = f.read()

    def const(name):  # an integer, or 1 << n
        value = re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)
        base, _, shift = value.partition(" << ")
        return int(base) << int(shift or 0)

    assert const("kTile") == tfd._TILE
    assert const("kStages") == tfd._STAGES
    assert const("kMaxCounters") == tfd._MAX_COUNTERS
    assert re.search(r"kMinBlocks = D == 64 \? 4 : 2;", src)
