"""The port's 8-bit linear decode (`flash_decode_int8` / `flash_decode_fp8`,
kernel 7: csrc/flash_decode_sm90.cuh's 8-bit kernel, 64-key tiles, each
split in whole tiles from its first key, a window's sinks and band as two
key ranges) at the edges of its tiles and splits, against the JAX
package's `flash_decode_int8` (its Pallas kernel in interpret mode) on the
same 8-bit values and scales, in float32 on the CPU, where the port's
wrapper runs its plain version; and the split rule that sizes the
kernel's splits for any batch, tied to the kernel's header."""

import importlib
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattention_kernel_project_tpu_torch.models.convert import params_from_jax
from flashattention_kernel_project_tpu_torch.ops import flash_decode as tfd
from flashattention_kernel_project_tpu_torch.utils.platform import H100_SMS
from flashattention_kernel_project_tpu_torch.utils.testing import assert_rel_l2

jq = importlib.import_module("flashattention_kernel_project_tpu.ops.quant")
jfd = importlib.import_module("flashattention_kernel_project_tpu.ops.flash_decode")

torch.set_num_threads(1)

CPU = torch.device("cpu")
TOL = 1e-4  # float32 on both sides, the same 8-bit values and scales
SAME_TOL = 1e-5  # one function at two split counts: the sums' order alone
TILE = 64
S_OFF = 200  # a cache off a multiple of the tile
EDGE_LENGTHS = [0, 1, 63, 64, 65, S_OFF]
GROUPS = [(2, 2), (4, 2), (4, 1), (8, 1)]  # (hq, hkv): G = 1, 2, 4, 8
FMTS = ["int8", "fp8"]
J_QUANT = {"int8": jq.quantize_int8, "fp8": jq.quantize_fp8_tokenwise}
HEADER = os.path.join(os.path.dirname(tfd.__file__), os.pardir, "csrc",
                      "flash_decode_sm90.cuh")


def _inputs(seed, fmt, b, hq, hkv, s, d):
    """q (float32 numpy) and an 8-bit cache quantized by the JAX package:
    (k_q, k_scale, v_q, v_scale) as JAX arrays."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    cache = []
    for _ in range(2):
        x = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
        cache.extend(J_QUANT[fmt](jnp.asarray(x), axis=-1))
    return q, cache


def _both(fmt, q, cache, lengths, **kw):
    """(JAX's output, the port's) for the same call, as numpy."""
    lengths = np.asarray(lengths, np.int32)
    jfn = jfd.flash_decode_int8 if fmt == "int8" else jfd.flash_decode_fp8
    tfn = tfd.flash_decode_int8 if fmt == "int8" else tfd.flash_decode_fp8
    jo = jfn(jnp.asarray(q), *cache, jnp.asarray(lengths), interpret=True, **kw)
    tcache = [params_from_jax(np.asarray(x), CPU) for x in cache]
    to = tfn(torch.from_numpy(q), *tcache, torch.from_numpy(lengths), **kw)
    assert tuple(to.shape) == q.shape and to.dtype == torch.float32
    return np.asarray(jo), to.numpy()


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("hq,hkv", GROUPS)
def test_lengths_at_tile_edges_match_jax(hq, hkv, d, fmt):
    """Lengths 0, 1, 63, 64, 65 and S with S off the tile, at the port's
    default splits (whole tiles) and JAX's; a length of 0 gives zeros."""
    q, cache = _inputs(1, fmt, len(EDGE_LENGTHS), hq, hkv, S_OFF, d)
    jo, to = _both(fmt, q, cache, EDGE_LENGTHS)
    assert_rel_l2(to, jo, tol=TOL)
    np.testing.assert_array_equal(to[0], 0.0)


@pytest.mark.parametrize("fmt", FMTS)
def test_caller_splits_off_the_tile_match_jax(fmt):
    """A caller's n_splits = 3 over S = 200 gives splits of 67 keys (JAX
    pads them to 96): neither starts on a tile; lengths above S clamp."""
    lengths = [0, 66, 67, 134, 135, S_OFF, 999]
    q, cache = _inputs(2, fmt, len(lengths), 4, 1, S_OFF, 128)
    jo, to = _both(fmt, q, cache, np.minimum(lengths, S_OFF), n_splits=3)
    assert_rel_l2(to, jo, tol=TOL)
    tcache = [params_from_jax(np.asarray(x), CPU) for x in cache]
    over = tfd.flash_decode_int8(torch.from_numpy(q), *tcache,
                                 torch.tensor(lengths, dtype=torch.int32),
                                 n_splits=3)
    np.testing.assert_array_equal(over.numpy(), to)


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("n_splits", [None, 2, 3])
@pytest.mark.parametrize("hq,hkv,d", [(2, 2, 64), (8, 1, 128)])
def test_window_wider_than_a_tile_matches_jax(hq, hkv, d, n_splits, fmt):
    """A window of 70 keys and 66 sinks, each wider than a tile. At
    n_splits = 2 the first split [0, 150) of the length-200 row holds the
    sinks [0, 66) and the band's start [130, 150) with a gap between: the
    window cuts it into two ranges."""
    s = 300
    lengths = [0, 1, 50, 66, 136, 137, 200, 250, s]
    q, cache = _inputs(3, fmt, len(lengths), hq, hkv, s, d)
    kw = dict(window=70, sinks=66)
    if n_splits is not None:
        kw["n_splits"] = n_splits
    jo, to = _both(fmt, q, cache, lengths, **kw)
    assert_rel_l2(to, jo, tol=TOL)
    np.testing.assert_array_equal(to[0], 0.0)


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("window,sinks", [(None, 0), (70, 66)])
def test_output_does_not_change_with_the_split_count(window, sinks, fmt):
    """The default splits, one split and caller's splits off the tile give
    one function: only the order of the sums differs."""
    s = 700
    lengths = torch.tensor([0, 1, 64, 65, 333, 640, s], dtype=torch.int32)
    q, cache = _inputs(4, fmt, len(lengths), 8, 2, s, 64)
    q = torch.from_numpy(q)
    tcache = [params_from_jax(np.asarray(x), CPU) for x in cache]
    kw = dict(window=window, sinks=sinks)
    one = tfd.flash_decode_int8(q, *tcache, lengths, n_splits=1, **kw)
    for n_splits in (None, 2, 3, 7, 11):
        got = tfd.flash_decode_int8(q, *tcache, lengths, n_splits=n_splits, **kw)
        assert_rel_l2(got.numpy(), one.numpy(), tol=SAME_TOL)


@pytest.mark.parametrize("b,hkv,s,d", [
    (8, 4, 2048, 128),   # the serving shape
    (8, 4, 8192, 128),   # run_all.py's int8 decode rung
    (256, 1, 4096, 128),
    (1, 1, 4096, 128),
    (1, 1, 100, 64),      # under two tiles
    (2, 2, 200, 64),
    (3, 8, 1000, 128),
    (64, 8, 8192, 64),
    (1, 4, 65, 128),
])
def test_q_splits_cover_every_key_once_in_whole_tiles(b, hkv, s, d):
    """The 8-bit decode's default splits [i * block_s, (i + 1) * block_s)
    are whole tiles, at least two unless one split holds the cache, every
    one starting below S (no empty split), together covering [0, S) once,
    and bring no more blocks than the card holds unless one split."""
    n = tfd.q_n_splits(b, hkv, s, d)
    block_s = tfd.default_block_s(s, n)
    assert n >= 1 and block_s % TILE == 0
    assert (n - 1) * block_s < s <= n * block_s
    assert n == 1 or block_s >= 2 * TILE
    assert n == 1 or b * hkv * n <= H100_SMS * tfd._blocks_per_sm_q(d)


def test_q_splits_fill_the_card_or_take_one():
    """At the serving shape the splits bring B * Hkv = 32 blocks to at
    least the 132 SMs (11 splits of 192 keys: 352 blocks, the 3 an SM holds
    at d = 128); where B * Hkv already fills the card, one split; a cache
    of one tile, one split."""
    assert (tfd.q_n_splits(8, 4, 2048), tfd.default_block_s(2048, 11)) == (11, 192)
    assert 8 * 4 * tfd.q_n_splits(8, 4, 2048) >= H100_SMS
    assert tfd.q_n_splits(512, 1, 4096) == 1
    assert tfd.q_n_splits(1, 1, TILE) == 1
    assert (tfd._blocks_per_sm_q(128), tfd._blocks_per_sm_q(64)) == (3, 4)


def test_q_split_rule_matches_the_kernel_header():
    """The rule's stage bytes and blocks an SM holds are the 8-bit
    kernel's (csrc/flash_decode_sm90.cuh's LayoutQ), and the blocks the
    registers allow fit the SM's shared memory as the rule counts it."""
    with open(HEADER) as f:
        src = f.read()
    layout = src[src.index("struct LayoutQ {"):]
    layout = layout[:layout.index("};")]
    assert re.search(r"kMinBlocks = D == 64 \? 4 : 3;", layout)
    assert ("kStageBytes =\n      (2 * kTileBytes + 2 * kTile * 4 + 1023) / 1024 * 1024;"
            in layout)
    assert "kTileBytes = kTile * D;" in layout
    assert "kBytes = 1024 + kStages * kStageBytes;" in layout
    assert (tfd._Q_MIN_BLOCKS_D64, tfd._Q_MIN_BLOCKS) == (4, 3)
    for d, stage in ((64, 9216), (128, 17408)):
        assert tfd._q_stage_bytes(d) == stage
        # the shared memory holds at least the blocks the registers allow
        assert tfd._blocks_per_sm_q(d) == (4 if d == 64 else 3)

