"""The softmax-epilogue GEMM's wgmma route (kernels 16 and 17 on
csrc/gemm_softmax_sm90.cuh) on the CPU: the route a CUDA call takes, by
type and shape alone, at the edges of the TMA path's alignment; and the
wgmma rows kernel's rounding order (`_softmax_epilogue_tiles_plain`: the
tiles split between a cluster's two CTAs, each CTA's running row max, e
rounded to the output type, the two (m, l) merged, then the rescale)
against the JAX package's kernel in interpret mode and the float64 rows
reference, at ragged N and at many tiles. The resident form's arithmetic
is `_softmax_epilogue_resident_plain`'s on either route
(tests/test_torch_gemm.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattention_kernel_project_tpu import ops as jops
from flashattention_kernel_project_tpu_torch.ops import gemm as tgemm
from flashattention_kernel_project_tpu_torch.utils.testing import assert_rel_l2

torch.set_num_threads(1)

F32_TOL = 1e-5   # f32 on both sides: only the order of the sums differs
BF16_TOL = 1e-2  # bf16 outputs, the JAX suite's bound
SCALE = 0.125


def _tensor(shape, dtype, offset=0):
    """A CPU tensor of `shape` whose base lies `offset` elements into its
    storage (a storage base is 16-byte aligned)."""
    flat = torch.zeros(int(np.prod(shape)) + offset, dtype=dtype)
    return flat[offset:].view(shape)


def _path(k, n, dtype=torch.bfloat16, offset=0):
    a = _tensor((2, 24, k), dtype, offset)
    b = _tensor((2, k, n), dtype)
    return tgemm.softmax_epilogue_path(a.dtype, b.dtype, a.shape, b.shape,
                                       tgemm._aligned(a, b))


@pytest.mark.parametrize("k,n", [(8, 8), (16, 248), (72, 4104), (2048, 2048)])
def test_aligned_bf16_takes_the_wgmma_kernel(k, n):
    assert _path(k, n) == tgemm.PATH_SM90


@pytest.mark.parametrize("k,n", [(7, 8), (9, 8), (8, 7), (8, 9), (2047, 2048),
                                 (2049, 2048), (2048, 2047), (2048, 2049)])
def test_k_or_n_off_the_8_grid_takes_the_elementwise_kernel(k, n):
    """K or N at 8k +- 1: a TMA map needs rows of a multiple of 16 bytes."""
    assert _path(k, n) == tgemm.PATH_ELEMENTWISE


def test_unaligned_base_takes_the_elementwise_kernel():
    """A base 2 bytes off the 16-byte grid, K and N aligned."""
    assert _path(64, 64) == tgemm.PATH_SM90
    assert _path(64, 64, offset=1) == tgemm.PATH_ELEMENTWISE
    assert _path(64, 64, offset=8) == tgemm.PATH_SM90


@pytest.mark.parametrize("k,n", [(8, 8), (4, 4), (64, 64)])
def test_f32_operands_never_take_the_wgmma_kernel(k, n):
    """f32 operands (which the CUDA wrapper refuses before it launches)
    route to the mma.sync kernels, never to the bf16 wgmma one."""
    assert _path(k, n, torch.float32) == tgemm.PATH_ELEMENTWISE


def test_k_zero_takes_the_mma_sync_kernel():
    """K = 0 (the softmax of the bias alone) has no TMA map to make."""
    assert _path(0, 64) == tgemm.PATH_ELEMENTWISE


def _rows64(a, w, bias):
    z = (np.einsum("bmk,bkn->bmn", a.astype(np.float64), w.astype(np.float64))
         * SCALE + bias)
    e = np.exp(z - z.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


@pytest.mark.parametrize("n", [160, 200, 264, 4104])
@pytest.mark.parametrize("out", ["bf16", "f32"])
def test_tiles_plain_matches_jax_and_float64(rng, n, out):
    """The wgmma rows kernel's rounding order at ragged N (masked columns
    in the last tile) and at 4104 (17 and 33 tiles, the running max
    rising across them), in both tile widths, against JAX's kernel
    (interpret mode) and the float64 reference: 1e-2 for a bf16 output,
    F32_TOL for f32 (f32 operands there, as tests/test_torch_gemm.py's
    f32 case); rows sum to 1. The bias spreads the row max over the tiles,
    so that later tiles raise it."""
    b, m, k = 2, 24, 64
    a = rng.standard_normal((b, m, k)).astype(np.float32)
    w = rng.standard_normal((b, k, n)).astype(np.float32)
    bias = (np.linspace(-4.0, 4.0, n) + rng.standard_normal(n)).astype(np.float32)
    if out == "bf16":
        a = np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
        w = np.array(jnp.asarray(w, jnp.bfloat16).astype(jnp.float32))
        jdt, tdt, tol = jnp.bfloat16, torch.bfloat16, BF16_TOL
        ja, jw = jnp.asarray(a, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
        ta, tw = torch.from_numpy(a).bfloat16(), torch.from_numpy(w).bfloat16()
    else:
        jdt, tdt, tol = jnp.float32, torch.float32, F32_TOL
        ja, jw, ta, tw = jnp.asarray(a), jnp.asarray(w), torch.from_numpy(a), torch.from_numpy(w)
    want = np.asarray(jops.batched_matmul_softmax_epilogue(
        ja, jw, jnp.asarray(bias), scale=SCALE, block_m=8, block_k=64,
        out_dtype=jdt).astype(jnp.float32))
    ref = _rows64(a, w, bias)
    for tile_n in (128, 256):
        got = tgemm._softmax_epilogue_tiles_plain(ta, tw, torch.from_numpy(bias),
                                                  SCALE, tdt, tile_n)
        assert got.dtype == tdt and tuple(got.shape) == (b, m, n)
        got = got.float().numpy()
        assert_rel_l2(got, want, tol=tol)
        assert_rel_l2(got, ref, tol=tol)
        np.testing.assert_allclose(got.sum(-1), 1.0,
                                   rtol=1e-3 if out == "f32" else 2.0 ** -7)


@pytest.mark.parametrize("tile_n", [128, 256])
def test_tiles_plain_is_the_rows_function(rng, tile_n):
    """In f32 the rescale by exp2(m_t - m) gives the row-max form's values
    to f32's rounding; in bf16 the one extra rounding of e stays within
    two bf16 ulps of each value (relative 2^-7)."""
    a = torch.from_numpy(rng.standard_normal((3, 40, 32)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 32, 600)).astype(np.float32))
    bias = torch.from_numpy(np.linspace(-6.0, 6.0, 600).astype(np.float32))
    rows = tgemm._softmax_epilogue_plain(a, w, bias, SCALE, torch.float32)
    tiles = tgemm._softmax_epilogue_tiles_plain(a, w, bias, SCALE, torch.float32, tile_n)
    torch.testing.assert_close(tiles, rows, rtol=1e-5, atol=1e-9)
    rows16 = tgemm._softmax_epilogue_plain(a, w, bias, SCALE, torch.bfloat16).float()
    tiles16 = tgemm._softmax_epilogue_tiles_plain(a, w, bias, SCALE, torch.bfloat16,
                                                  tile_n).float()
    torch.testing.assert_close(tiles16, rows16, rtol=2.0 ** -7, atol=1e-30)


def test_cpu_calls_count_no_wgmma_launch(rng):
    """On CPU tensors the wrapper runs its plain versions and counts no
    launch of either route."""
    fn = tgemm.batched_matmul_softmax_epilogue
    before = (fn.launches, fn.resident_launches, fn.fallback_launches, fn.sm90_launches)
    a = torch.from_numpy(rng.standard_normal((1, 16, 8)).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.standard_normal((1, 8, 16)).astype(np.float32)).bfloat16()
    bias = torch.zeros(16)
    got = fn(a, w, bias, scale=SCALE, out_dtype=torch.float32)
    assert torch.equal(got, tgemm._softmax_epilogue_plain(a, w, bias, SCALE,
                                                          torch.float32))
    got = fn(a, w, bias, scale=SCALE, out_dtype=torch.float32, resident=True)
    assert torch.equal(got, tgemm._softmax_epilogue_resident_plain(
        a, w, bias, SCALE, torch.float32)[0])
    assert (fn.launches, fn.resident_launches, fn.fallback_launches,
            fn.sm90_launches) == before
