"""The f32 GEMM's split and six-pass product (csrc/gemm_f32_sm90.cuh, JAX's
Precision.HIGHEST) in plain PyTorch, on the CPU: the exact split of an f32
value into three bf16 pieces (`_f32_pieces`), and `_matmul_f32_split_plain`
against the JAX package's f32 matmul and batched_matmul (its Pallas kernels
in interpret mode, the blocks of tests/test_torch_gemm.py) at the tile
edges of tests/test_torch_gemm_tiles.py, against the fp64 oracle, and on
inf and NaN operands against torch.matmul f32. The kernel itself runs only
on the card, where chip_smoke.py holds it to these plain versions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattention_kernel_project_tpu import ops as jops
from flashattention_kernel_project_tpu_torch.ops import gemm as tgemm
from flashattention_kernel_project_tpu_torch.utils import oracles
from flashattention_kernel_project_tpu_torch.utils.testing import (
    assert_max_abs,
    assert_rel_l2,
)

torch.set_num_threads(1)

SPLIT_TOL = 1e-6  # rel-L2 against f32: the dropped mid.lo, lo.mid, lo.lo are ~2^-24
BF16_TOL = 1e-2   # bf16 outputs, the JAX suite's bound
MAX_ABS = 1e-2    # against the fp64 oracle (tests/test_gemm.py:19)
BLOCKS = dict(block_m=128, block_n=128, block_k=128)  # as tests/test_gemm.py
SUBNORMAL_BF16 = 2.0 ** -133  # the spacing of bf16's subnormals
FLT_MAX = float(np.finfo(np.float32).max)
SMALLEST_EXACT = 2.0 ** -110  # from here up the last piece stays a normal number

SHAPES = [  # m, k, n: tests/test_torch_gemm_tiles.py's, K and N multiples of 4
    (200, 136, 72), (129, 8, 264), (200, 72, 136), (260, 200, 264), (300, 328, 136),
]


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def _values(which: str) -> torch.Tensor:
    rng = np.random.default_rng(7)
    if which == "random":  # normal values over exponents -100 to 100
        x = rng.standard_normal(4096) * 2.0 ** rng.integers(-100, 100, 4096)
    elif which == "zeros":
        x = np.array([0.0, -0.0])
    elif which == "flt_max":  # FLT_MAX, its neighbours below, and their negatives
        x = np.nextafter(np.float32(FLT_MAX), np.float32(0), dtype=np.float32)
        x = np.array([FLT_MAX, x, np.nextafter(x, np.float32(0), dtype=np.float32),
                      np.float32(FLT_MAX) * np.float32(0.75)])
        x = np.concatenate([x, -x])
    else:  # the smallest x whose pieces stay normal, its neighbours above
        x = np.float32(SMALLEST_EXACT) * (1 + rng.integers(0, 2 ** 23, 256) * 2.0 ** -23)
        x = np.concatenate([[SMALLEST_EXACT, -SMALLEST_EXACT], x, -x])
    return torch.from_numpy(np.asarray(x, np.float32))


@pytest.mark.parametrize("which", ["random", "zeros", "flt_max", "smallest_normal"])
def test_split_is_exact(which):
    """hi + mid + lo == x bit for bit; every piece a bf16 value (its low 16
    bits zero), finite, none of them past x; hf == hi for finite x."""
    x = _values(which)
    hi, hf, mid, lo = tgemm._f32_pieces(x)
    assert torch.equal(_bits(hi + mid + lo), _bits(x))
    for piece in (hi, hf, mid, lo):
        assert torch.isfinite(piece).all()
        assert not (_bits(piece) & 0xFFFF).any()
    assert torch.equal(_bits(hf), _bits(hi))
    assert (hi.abs() <= x.abs()).all()


def test_split_below_the_smallest_exact():
    """Below 2^-110 the bits under bf16's subnormal spacing (2^-133) are
    lost, and no more: the pieces sum to x within 2^-133, f32 subnormals
    among them."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal(4096) * 2.0 ** rng.integers(-149, -110, 4096)
    x = torch.from_numpy(np.asarray(x, np.float32))
    hi, _, mid, lo = tgemm._f32_pieces(x)
    err = ((hi + mid + lo).double() - x.double()).abs()
    assert float(err.max()) < SUBNORMAL_BF16
    assert (err > 0).any()  # there are such bits to lose in this draw


def test_split_non_finite():
    """±inf and NaN keep hi (a NaN stays a NaN, whatever its payload),
    their hf, mid and lo are 0."""
    nan_low = torch.tensor([0x7F800001, 0x7FC00000, -0x7F0F], dtype=torch.int32)
    x = torch.cat([torch.tensor([float("inf"), -float("inf")]), nan_low.view(torch.float32)])
    hi, hf, mid, lo = tgemm._f32_pieces(x)
    assert torch.equal(hi[:2], x[:2]) and torch.isnan(hi[2:]).all()
    for piece in (hf, mid, lo):
        assert not piece.abs().any()


@pytest.mark.parametrize("out", ["f32", "bf16"])
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_split_product_matches_jax(rng, m, k, n, batch, out):
    """The six-pass product against JAX's f32 matmul (batch 1) and
    batched_matmul (batch 3), Precision.HIGHEST, in interpret mode: in f32
    within SPLIT_TOL, its bf16 rounding within the JAX suite's bound, and
    against the fp64 oracle within max-abs 1e-2."""
    a = rng.standard_normal((batch, m, k), dtype=np.float32)
    b = rng.standard_normal((batch, k, n), dtype=np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if out == "f32" else (jnp.bfloat16, torch.bfloat16)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    if batch == 1:
        want32 = jops.matmul(ja[0], jb[0], **BLOCKS)[None]
        want = jops.matmul(ja[0], jb[0], out_dtype=jdt, **BLOCKS)[None]
    else:
        want32 = jops.batched_matmul(ja, jb, **BLOCKS)
        want = jops.batched_matmul(ja, jb, out_dtype=jdt, **BLOCKS)
    got32 = tgemm._matmul_f32_split_plain(ta, tb, torch.float32)
    got = tgemm._matmul_f32_split_plain(ta, tb, tdt)
    assert got.dtype == tdt and tuple(got.shape) == (batch, m, n)
    assert torch.equal(got, got32.to(tdt))
    assert_rel_l2(got32.numpy(), np.asarray(want32), tol=SPLIT_TOL)
    if out == "bf16":
        assert_rel_l2(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                      tol=BF16_TOL)
    exact = np.stack([oracles.gemm(a[i], b[i]) for i in range(batch)])
    assert_max_abs(got32.numpy(), exact, tol=MAX_ABS)


@pytest.mark.parametrize("where", ["a", "b", "both"])
def test_split_product_non_finite_like_f32(rng, where):
    """inf and NaN operands: the six-pass product's non-finite entries are
    torch.matmul f32's (NaN, +inf, -inf at the same places), its finite
    ones within SPLIT_TOL; B holds bf16 values (zero mid and lo pieces),
    zeros and a row of ones, where an inf met a zero piece would be NaN."""
    a = rng.standard_normal((64, 48), dtype=np.float32)
    b = rng.standard_normal((48, 40), dtype=np.float32)
    b[:8] = np.asarray(jnp.asarray(b[:8]).astype(jnp.bfloat16).astype(jnp.float32))
    b[8, :] = 1.0
    b[9, ::3] = 0.0
    if where in ("a", "both"):
        a[3, 8] = np.inf
        a[5, 9] = -np.inf
        a[7, 2] = np.inf
        a[7, 8] = -np.inf
        a[11, 4] = np.nan
    if where in ("b", "both"):
        b[8, 5] = -np.inf
        b[2, 6] = np.inf
        b[9, 7] = np.nan
        b[0, 30] = np.inf
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = tgemm._matmul_f32_split_plain(ta, tb, torch.float32)
    want = torch.matmul(ta, tb)
    for test in (torch.isnan, torch.isposinf, torch.isneginf):
        assert torch.equal(test(got), test(want))
    assert (~torch.isfinite(want)).any()
    fin = torch.isfinite(want)
    assert_rel_l2(got[fin].numpy(), want[fin].numpy(), tol=SPLIT_TOL)
