"""The 8-bit GEMMs' wgmma routes on the CPU (kernel 19 on
csrc/gemm_w8_sm90.cu, kernel 20 on csrc/gemm_i8_sm90.cu): the route a CUDA
call takes, by shape and alignment alone, at the edges of the TMA maps'
alignment; kernel 19's tile plan for small M;
the plain versions against the JAX kernels in interpret mode at the new
tiles' edge shapes; and a CUDA call with no kernel library, which raises on
every route and runs no plain version."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattention_kernel_project_tpu_torch.ops import _build
from flashattention_kernel_project_tpu_torch.ops import gemm as tgemm
from flashattention_kernel_project_tpu_torch.ops import quant as tq
from flashattention_kernel_project_tpu_torch.utils.testing import assert_rel_l2

jq = importlib.import_module("flashattention_kernel_project_tpu.ops.quant")

torch.set_num_threads(1)

F32_TOL = 1e-5    # f32 on both sides: the same products, summed in another order
BF16_TOL = 1e-2   # bf16 outputs, the JAX suite's bound
I8_TOL = 1e-6     # kernel 20: exact int32 sums, the same f32 steps
H100_SMS = 132
SM90, ELEMENTWISE = tgemm.PATH_SM90, tgemm.PATH_ELEMENTWISE
J_TYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16}
T_TYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.mark.parametrize("k, n, bases, want", [
    (2048, 11008, True, SM90),   # the decode shape
    (8, 16, True, SM90),         # one 16-byte piece of x's row, of w_q's row
    (72, 144, True, SM90),
    (12, 16, True, ELEMENTWISE),  # K % 8: x's bf16 rows not whole pieces
    (4, 16, True, ELEMENTWISE),   # an f32 x of K 4 (16-byte rows) is rounded
                                  # to bf16 first: 8-byte rows
    (16, 24, True, ELEMENTWISE),  # N % 16: w_q's byte rows
    (16, 130, True, ELEMENTWISE),
    (0, 16, True, ELEMENTWISE),   # K = 0: the mma.sync kernel writes zeros
    (16, 16, False, ELEMENTWISE),  # a base off 16 bytes
])
def test_w8_path(k, n, bases, want):
    """Kernel 19's route: the wgmma kernel where K > 0, K % 8 and N % 16
    (x's bf16 rows and w_q's byte rows are whole 16-byte pieces for TMA)
    and the bases are 16-byte aligned; else the mma.sync kernel, element by
    element (it has no other instance)."""
    assert tq.w8_path(k, n, bases) == want


@pytest.mark.parametrize("k, n, bases, want", [
    (4096, 4096, True, SM90),
    (16, 16, True, SM90),
    (336, 272, True, SM90),
    (8, 16, True, ELEMENTWISE),    # K % 16: a_q's and B^T's byte rows
    (130, 72, True, ELEMENTWISE),
    (320, 150, True, ELEMENTWISE),  # N % 16: b_q's byte rows
    (0, 16, True, ELEMENTWISE),
    (16, 16, False, ELEMENTWISE),
])
def test_i8_path(k, n, bases, want):
    """Kernel 20's route: the transposing pass and the wgmma kernel where
    K > 0, K % 16 and N % 16 and the bases are 16-byte aligned; else the
    mma.sync kernel, element by element."""
    assert tq.i8_path(k, n, bases) == want


def test_w8_path_reads_the_rounded_x():
    """The wrapper decides on x's bf16 copy: an f32 x whose rows are 16
    bytes (K 4) but whose bf16 rows are 8 is not aligned, and one of K 8
    is, whatever x's own type."""
    for k, want in ((4, ELEMENTWISE), (8, SM90)):
        x = torch.zeros(3, k).to(torch.bfloat16).contiguous()
        assert tgemm._aligned(x) == (want == SM90)
        assert tq.w8_path(k, 16, x.data_ptr() % 16 == 0) == want


def _tiles(m, n, rows, cols):
    return -(-m // rows) * -(-n // cols)


def test_w8_plan_fills_the_card_at_the_decode_shape():
    """At the JAX engine's int8 projection (M 8, K 2048, N 11008) the plan
    takes 16 x 64 tiles (rows of x x columns of C): at least one tile an SM
    of the H100 (where 128 x 256 tiles made 43 blocks); at 4096^3 it takes
    256 x 128, the 32K-element tile of kernel 13 with x's rows as wgmma's
    N."""
    rows, cols = tq.w8_plan(8, 11008, H100_SMS)
    assert (rows, cols) == (16, 64)
    assert _tiles(8, 11008, rows, cols) >= H100_SMS
    assert _tiles(8, 11008, 128, 256) == 43
    assert tq.w8_plan(4096, 4096, H100_SMS) == (256, 128)


@pytest.mark.parametrize("m, n", [(1, 16), (8, 11008), (16, 64), (17, 64), (64, 144),
                                  (65, 144), (100, 16912), (128, 4096), (129, 4096),
                                  (200, 272), (1024, 1024), (4096, 4096), (1100, 4112)])
@pytest.mark.parametrize("sms", [1, 8, 132])
def test_w8_plan_rule(m, n, sms):
    """The plan is one of the built tiles, and its grid fills the card as
    far as the finest tile for its rows (16 x 64 where M <= 16, else 64 x
    64) could; a 128-column tile covers M in one row of tiles where M <=
    256, and is taken only where its grid has a tile an SM."""
    rows, cols = tq.w8_plan(m, n, sms)
    assert (rows, cols) in tq.W8_TILES
    finest = _tiles(m, n, 16 if m <= 16 else 64, 64)
    assert _tiles(m, n, rows, cols) >= min(sms, finest)
    if cols == 128:
        assert rows >= min(m, 256) and _tiles(m, n, rows, cols) >= sms


# (M, K, N) at the edges of the new tiles: M 1 and 8 (16-row tiles), 65
# and 129 (one row past a 64- or 128-row tile); N 16 (one 16-column
# group), 144, 272 (off 64, 128 and 256); K 16 and 72 (under or off a
# 64-deep slice, for kernel 20 a 128-deep one) and 2048
EDGES = [(1, 16, 16), (8, 2048, 272), (65, 72, 144), (129, 2048, 16),
         (129, 72, 272), (65, 16, 144), (8, 72, 16), (1, 2048, 144)]


def _weights(rng, k, n, fmt):
    w = rng.standard_normal((k, n)).astype(np.float32)
    if fmt == "int8":
        return (jq.quantize_int8(jnp.asarray(w), axis=0),
                tq.quantize_int8(torch.from_numpy(w), axis=0))
    return (jq.quantize_fp8_weights(jnp.asarray(w)),
            tq.quantize_fp8_weights(torch.from_numpy(w)))


@pytest.mark.parametrize("out", ["f32", "bf16"])
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("m, k, n", EDGES)
def test_w8_edges_match_jax(rng, m, k, n, fmt, out):
    """Kernel 19's function at the tiles' edge shapes against JAX's kernel
    in interpret mode: an f32 x (rounded to bf16 first by both) where M is
    odd, a bf16 x where not; f32 out within F32_TOL, bf16 within
    BF16_TOL."""
    x = rng.standard_normal((m, k)).astype(np.float32)
    (jwq, jws), (twq, tws) = _weights(rng, k, n, fmt)
    xdt = "f32" if m % 2 else "bf16"
    jfn, tfn = ((jq.matmul_int8_weights, tq.matmul_int8_weights) if fmt == "int8"
                else (jq.matmul_fp8_weights, tq.matmul_fp8_weights))
    want = np.asarray(jfn(jnp.asarray(x).astype(J_TYPES[xdt]), jwq, jws,
                          out_dtype=J_TYPES[out]), np.float32)
    got = tfn(torch.from_numpy(x).to(T_TYPES[xdt]), twq, tws, out_dtype=T_TYPES[out])
    assert got.dtype == T_TYPES[out] and tuple(got.shape) == (m, n)
    assert_rel_l2(got.float().numpy(), want, tol=F32_TOL if out == "f32" else BF16_TOL)


@pytest.mark.parametrize("out", ["f32", "bf16"])
@pytest.mark.parametrize("m, k, n", EDGES)
def test_i8_edges_match_jax(rng, m, k, n, out):
    """Kernel 20's function at the same shapes against JAX's kernel in
    interpret mode: the int32 sum exact on both sides, then the row and
    column scales in JAX's order (I8_TOL)."""
    a = rng.standard_normal((m, k)).astype(np.float32)
    ja = jq.quantize_int8(jnp.asarray(a), axis=1)
    ta = tq.quantize_int8(torch.from_numpy(a), axis=1)
    (jb, jbs), (tb, tbs) = _weights(rng, k, n, "int8")
    want = np.asarray(jq.matmul_int8(ja[0], ja[1], jb, jbs, out_dtype=J_TYPES[out]),
                      np.float32)
    got = tq.matmul_int8(ta[0], ta[1], tb, tbs, out_dtype=T_TYPES[out])
    assert got.dtype == T_TYPES[out] and tuple(got.shape) == (m, n)
    assert_rel_l2(got.float().numpy(), want, tol=I8_TOL)


class _OnTheCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device: it sends a wrapper down
    the card's path on a machine with no card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.mark.parametrize("kernel, n", [("w8", 16), ("w8", 24), ("fp8", 16),
                                       ("i8", 16), ("i8", 24)])
def test_cuda_8bit_call_without_a_library_raises(monkeypatch, kernel, n):
    """A call on CUDA tensors with no library to load raises the build's
    error on either route (N 16: the wgmma kernel; N 24: the mma.sync one):
    it never runs the plain version in the kernel's place, and counts no
    launch."""
    class NoLibrary(RuntimeError):
        pass

    def no_library():
        raise NoLibrary("no kernel library")

    def no_plain(*args, **kw):
        raise AssertionError("the plain version ran on the card's path")

    monkeypatch.setattr(_build, "library", no_library)
    for name in ("_matmul_w8_plain", "_matmul_i8_plain"):
        monkeypatch.setattr(tq, name, no_plain)
    cached = (tq._w8_kernel, tq._w8_sm90_kernel, tq._i8_kernel, tq._i8_sm90_kernel,
              tq._transpose_kernel)
    for fn in cached:
        fn.cache_clear()
    card = lambda x: x.as_subclass(_OnTheCard)  # noqa: E731
    k = 32
    if kernel == "i8":
        call = tq.matmul_int8
        args = (card(torch.ones(4, k, dtype=torch.int8)), card(torch.ones(4, 1)),
                card(torch.ones(k, n, dtype=torch.int8)), card(torch.ones(1, n)))
        assert tq.i8_path(k, n, True) == (SM90 if n == 16 else ELEMENTWISE)
    else:
        call = tq.matmul_int8_weights if kernel == "w8" else tq.matmul_fp8_weights
        wdt = torch.int8 if kernel == "w8" else torch.float8_e4m3fn
        args = (card(torch.ones(4, k)), card(torch.ones(k, n).to(wdt)),
                card(torch.ones(1, n)))
        assert tq.w8_path(k, n, True) == (SM90 if n == 16 else ELEMENTWISE)
    counts = ("launches", "sm90_launches", "transpose_launches")
    before = [getattr(call, c, 0) for c in counts]
    try:
        with pytest.raises(NoLibrary):
            call(*args)
    finally:
        for fn in cached:
            fn.cache_clear()
    assert [getattr(call, c, 0) for c in counts] == before
