"""The port's GEMM ladder against the JAX package's, on the CPU (the JAX
kernels in interpret mode, the port's wrappers on their plain versions):
matmul in f32 and bf16, the batched, fused-epilogue and softmax-epilogue
products (the rows structure and the resident fixed-max form with its
fallback), BASELINE.json configs 1 and 2 as slices at a small size, and the
port's numpy and native fp64 oracles against the JAX package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattention_kernel_project_tpu import ops as jops
from flashattention_kernel_project_tpu.utils import oracles as joracles
from flashattention_kernel_project_tpu.utils import testing as jtesting
from flashattention_kernel_project_tpu_torch import ops
from flashattention_kernel_project_tpu_torch.ops import gemm as tgemm
from flashattention_kernel_project_tpu_torch.runtime import native
from flashattention_kernel_project_tpu_torch.utils import oracles, testing
from flashattention_kernel_project_tpu_torch.utils.testing import (
    assert_max_abs,
    assert_rel_l2,
)

torch.set_num_threads(1)

F32_TOL = 1e-5   # f32 on both sides: only the order of the sums differs
BF16_TOL = 1e-2  # bf16 outputs, the JAX suite's bound
BLOCKS = dict(block_m=128, block_n=128, block_k=128)  # as tests/test_gemm.py


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t(x):
    return torch.from_numpy(np.array(x))


def _bf16(x):
    """x rounded to bf16, as float32 numpy."""
    return _np(jnp.asarray(x).astype(jnp.bfloat16))


@pytest.mark.parametrize("m,k,n", [(256, 256, 256), (512, 384, 256), (200, 130, 72)])
def test_matmul_fp32_matches_jax(rng, m, k, n):
    a = rng.standard_normal((m, k), dtype=np.float32)
    b = rng.standard_normal((k, n), dtype=np.float32)
    want = jops.matmul(jnp.asarray(a), jnp.asarray(b), **BLOCKS)
    got = ops.matmul(_t(a), _t(b))
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    assert_rel_l2(got.numpy(), _np(want), tol=F32_TOL)
    assert_max_abs(got.numpy(), oracles.gemm(a, b), tol=1e-2)


def test_matmul_xla_baseline_matches_jax(rng):
    a = rng.standard_normal((128, 256), dtype=np.float32)
    b = rng.standard_normal((256, 64), dtype=np.float32)
    got = ops.matmul_xla(_t(a), _t(b))
    assert_rel_l2(got.numpy(), _np(jops.matmul_xla(jnp.asarray(a), jnp.asarray(b))),
                  tol=F32_TOL)
    assert_max_abs(got.numpy(), oracles.gemm(a, b), tol=1e-2)


@pytest.mark.parametrize("out", ["f32", "bf16"])
def test_matmul_bf16_matches_jax(rng, out):
    """bf16 operands (f32 rounded), f32 accumulation, out in f32 or bf16."""
    a = rng.standard_normal((256, 256), dtype=np.float32)
    b = rng.standard_normal((256, 256), dtype=np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if out == "f32" else (jnp.bfloat16, torch.bfloat16)
    want = jops.matmul_bf16(jnp.asarray(a), jnp.asarray(b), out_dtype=jdt, **BLOCKS)
    got = ops.matmul_bf16(_t(a), _t(b), out_dtype=tdt)
    assert got.dtype == tdt
    tol = F32_TOL if out == "f32" else BF16_TOL
    assert_rel_l2(got.float().numpy(), _np(want), tol=tol)
    assert_rel_l2(got.float().numpy(), oracles.gemm(_bf16(a), _bf16(b)), tol=BF16_TOL)


@pytest.mark.parametrize("bsz", [1, 4])
def test_batched_matmul_matches_jax(rng, bsz):
    a = rng.standard_normal((bsz, 256, 128), dtype=np.float32)
    b = rng.standard_normal((bsz, 128, 192), dtype=np.float32)
    want = jops.batched_matmul(jnp.asarray(a), jnp.asarray(b), **BLOCKS)
    got = ops.batched_matmul(_t(a), _t(b))
    assert tuple(got.shape) == (bsz, 256, 192)
    assert_rel_l2(got.numpy(), _np(want), tol=F32_TOL)
    assert_max_abs(got.numpy(), oracles.gemm(a, b), tol=1e-2)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_matmul_fused_epilogue_matches_jax(rng, dtype):
    m, k, n = 256, 192, 256
    a = rng.standard_normal((m, k), dtype=np.float32)
    b = rng.standard_normal((k, n), dtype=np.float32)
    bias = rng.standard_normal(n, dtype=np.float32)
    res = rng.standard_normal((m, n), dtype=np.float32)
    if dtype == "bf16":
        a, b = _bf16(a), _bf16(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = _t(a), _t(b)
    if dtype == "bf16":
        ja, jb = ja.astype(jnp.bfloat16), jb.astype(jnp.bfloat16)
        ta, tb = ta.bfloat16(), tb.bfloat16()
    want = jops.matmul_fused_epilogue(ja, jb, jnp.asarray(bias), jnp.asarray(res),
                                      block_m=128, block_n=128, block_k=64)
    got = ops.matmul_fused_epilogue(ta, tb, _t(bias), _t(res))
    assert_rel_l2(got.numpy(), _np(want), tol=F32_TOL)
    assert_max_abs(got.numpy(), oracles.gemm_fused_epilogue(a, b, bias, res), tol=1e-2)


@pytest.mark.parametrize("side", ["bf16", "f32"])
@pytest.mark.parametrize("out", ["bf16", "f32"])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("m,k,n", [(200, 136, 264), (129, 72, 136)])
def test_matmul_fused_epilogue_tile_edges_match_jax(rng, m, k, n, dtype, out, side):
    """matmul_fused_epilogue at the wgmma kernels' tile edges (M off the
    128-row tiles, N a multiple of 8 but not of 256 or 128, K off the
    64-deep slices), bf16 and f32 operands, bf16 and f32 out, bias and
    residual given as bf16 and as f32, against JAX's in interpret mode:
    rel-L2 within F32_TOL for f32 out, BF16_TOL for bf16 out (the two
    round the same f32 value, which may sit on a rounding edge)."""
    a = rng.standard_normal((m, k), dtype=np.float32)
    b = rng.standard_normal((k, n), dtype=np.float32)
    bias = rng.standard_normal(n, dtype=np.float32)
    res = rng.standard_normal((m, n), dtype=np.float32)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
                else (jnp.float32, torch.float32))
    jside, tside = ((jnp.bfloat16, torch.bfloat16) if side == "bf16"
                    else (jnp.float32, torch.float32))
    jout, tout = ((jnp.bfloat16, torch.bfloat16) if out == "bf16"
                  else (jnp.float32, torch.float32))
    want = jops.matmul_fused_epilogue(
        jnp.asarray(a).astype(jdt), jnp.asarray(b).astype(jdt),
        jnp.asarray(bias).astype(jside), jnp.asarray(res).astype(jside),
        block_m=128, block_n=128, block_k=64, out_dtype=jout)
    got = ops.matmul_fused_epilogue(_t(a).to(tdt), _t(b).to(tdt), _t(bias).to(tside),
                                    _t(res).to(tside), out_dtype=tout)
    assert got.dtype == tout and tuple(got.shape) == (m, n)
    assert_rel_l2(got.float().numpy(), _np(want), tol=F32_TOL if out == "f32" else BF16_TOL)


def _softmax_rows(a, w, bias, scale):
    z = (np.einsum("bmk,bkn->bmn", a.astype(np.float64), w.astype(np.float64))
         * scale + bias)
    e = np.exp(z - z.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("dtype,out", [("f32", "f32"), ("bf16", "f32"), ("bf16", "bf16")])
def test_batched_matmul_softmax_epilogue_matches_jax(rng, dtype, out):
    """The softmax on the f32 accumulator with N = 160 (padded columns
    masked in the TPU kernel), against JAX, the float64 reference and rows
    summing to 1 (tests/test_gemm.py:62-82). With a bf16 output JAX takes
    exp2 in bf16, the port in f32 (ROADMAP.md, section C)."""
    b, m, k, n = 3, 96, 128, 160
    a = rng.standard_normal((b, m, k)).astype(np.float32)
    w = rng.standard_normal((b, k, n)).astype(np.float32)
    bias = rng.standard_normal((n,)).astype(np.float32)
    ja, jw, ta, tw = jnp.asarray(a), jnp.asarray(w), _t(a), _t(w)
    if dtype == "bf16":
        ja, jw = ja.astype(jnp.bfloat16), jw.astype(jnp.bfloat16)
        ta, tw = ta.bfloat16(), tw.bfloat16()
    jdt, tdt = (jnp.float32, torch.float32) if out == "f32" else (jnp.bfloat16, torch.bfloat16)
    want = jops.batched_matmul_softmax_epilogue(
        ja, jw, jnp.asarray(bias), scale=0.125, block_m=32, block_k=64, out_dtype=jdt)
    got = ops.batched_matmul_softmax_epilogue(ta, tw, _t(bias), scale=0.125,
                                              out_dtype=tdt)
    assert got.dtype == tdt and tuple(got.shape) == (b, m, n)
    got = got.float().numpy()
    tol = F32_TOL if (dtype, out) == ("f32", "f32") else BF16_TOL
    assert_rel_l2(got, _np(want), tol=tol)
    assert_rel_l2(got, _softmax_rows(a, w, bias, 0.125), tol=tol)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-3 if out == "f32" else 2.0 ** -8)


def test_softmax_epilogue_resident_matches_jax(rng):
    """resident=True (kernel 17, fixed-max with the l-range witness) at 2 x
    1088 x 256 x 200 in bf16: ragged against the TPU kernel's 1024-row
    panels and 128-column tiles, against JAX's resident=True and the
    float64 reference within 1e-2, rows summing to 1 within 1e-2
    (tests/test_gemm.py:86-107), the witness 0. resident None and False
    stay the rows structure, JAX's default."""
    b, m, k, n = 2, 1088, 256, 200
    a = rng.standard_normal((b, m, k)).astype(np.float32)
    w = rng.standard_normal((b, k, n)).astype(np.float32)
    bias = rng.standard_normal((n,)).astype(np.float32)
    want = jops.batched_matmul_softmax_epilogue(
        jnp.asarray(a, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16), jnp.asarray(bias),
        scale=0.125, out_dtype=jnp.bfloat16, resident=True)
    ta, tw = _t(a).bfloat16(), _t(w).bfloat16()
    fn = ops.batched_matmul_softmax_epilogue
    got = fn(ta, tw, _t(bias), scale=0.125, out_dtype=torch.bfloat16, resident=True)
    assert int(fn.witness) == 0
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (b, m, n)
    got = got.float().numpy()
    assert_rel_l2(got, _np(want), tol=BF16_TOL)
    assert_rel_l2(got, _softmax_rows(_bf16(a), _bf16(w), bias, 0.125), tol=BF16_TOL)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-2)
    rows = fn(ta, tw, _t(bias), scale=0.125, out_dtype=torch.bfloat16)
    for resident in (None, False):
        again = fn(ta, tw, _t(bias), scale=0.125, out_dtype=torch.bfloat16,
                   resident=resident)
        assert torch.equal(again, rows)


def test_softmax_epilogue_resident_falls_back(rng):
    """Inputs scaled by 40 (tests/test_gemm.py:110-127) breach the
    fixed-max range: the witness counts rows and the output is the rows
    structure's, bit for bit, and JAX's within float32's order of sums."""
    b, m, k, n = 1, 1024, 256, 128
    a = 40.0 * rng.standard_normal((b, m, k)).astype(np.float32)
    w = 40.0 * rng.standard_normal((b, k, n)).astype(np.float32)
    bias = rng.standard_normal((n,)).astype(np.float32)
    want = jops.batched_matmul_softmax_epilogue(
        jnp.asarray(a), jnp.asarray(w), jnp.asarray(bias), scale=1.0,
        out_dtype=jnp.float32, resident=True)
    fn = ops.batched_matmul_softmax_epilogue
    got = fn(_t(a), _t(w), _t(bias), resident=True)
    assert int(fn.witness) > 0
    assert torch.equal(got, fn(_t(a), _t(w), _t(bias)))
    assert_rel_l2(got.numpy(), _np(want), tol=F32_TOL)


@pytest.mark.parametrize("call", ["matmul", "batched", "fused", "softmax_epilogue"])
def test_gemm_shape_errors(call):
    """Shapes that make no product raise ValueError (JAX asserts)."""
    a, b = torch.zeros(4, 8), torch.zeros(6, 5)
    with pytest.raises(ValueError):
        if call == "matmul":
            ops.matmul(a, b)
        elif call == "batched":
            ops.batched_matmul(a[None], torch.zeros(2, 8, 5))
        elif call == "fused":
            ops.matmul_fused_epilogue(a, torch.zeros(8, 5), torch.zeros(4),
                                      torch.zeros(4, 5))
        else:
            ops.batched_matmul_softmax_epilogue(a[None], torch.zeros(1, 8, 5),
                                                torch.zeros(6))


def _operands(case):
    """(a, b) of a dispatch case, CPU tensors of its shapes and types."""
    bf, f32 = torch.bfloat16, torch.float32
    if case == "offset view":  # a contiguous view 2 bytes past an aligned base
        buf = torch.empty(256 * 256 + 1, dtype=bf)
        return buf[1:].view(1, 256, 256), torch.empty(1, 256, 256, dtype=bf)
    (bm, m, k, n), dt = {
        "4096^3 bf16": ((1, 4096, 4096, 4096), bf),
        "8 x 1024^3 bf16": ((8, 1024, 1024, 1024), bf),
        "K 136, N 72 bf16": ((1, 200, 136, 72), bf),
        "K 130 bf16": ((1, 200, 130, 72), bf),
        "N 75 bf16": ((1, 200, 136, 75), bf),
        "K 0 bf16": ((1, 200, 0, 72), bf),
        "2048^3 f32": ((1, 2048, 2048, 2048), f32),
        "K 132 f32": ((1, 200, 132, 72), f32),
        "K 130 f32": ((1, 200, 130, 72), f32),
        "K 0 f32": ((1, 200, 0, 72), f32),
        "batched f32": ((3, 200, 132, 72), f32),
        "epilogue bf16": ((1, 256, 256, 256), bf),
        "epilogue f32": ((1, 200, 132, 72), f32),
        "epilogue K 130 bf16": ((1, 200, 130, 72), bf),
        "epilogue K 0 bf16": ((1, 200, 0, 72), bf),
    }[case]
    return torch.empty(bm, m, k, dtype=dt), torch.empty(bm, k, n, dtype=dt)


@pytest.mark.parametrize("case,path", [
    ("4096^3 bf16", "sm90"), ("8 x 1024^3 bf16", "sm90"),
    ("K 136, N 72 bf16", "sm90"), ("K 130 bf16", "elementwise"),
    ("N 75 bf16", "elementwise"), ("K 0 bf16", "aligned"),
    ("2048^3 f32", "sm90_f32"), ("K 132 f32", "sm90_f32"),
    ("K 130 f32", "elementwise"), ("K 0 f32", "aligned"),
    ("batched f32", "sm90_f32"), ("epilogue bf16", "sm90"),
    ("epilogue f32", "sm90_f32"), ("epilogue K 130 bf16", "elementwise"),
    ("epilogue K 0 bf16", "aligned"), ("offset view", "elementwise"),
])
def test_gemm_path(case, path):
    """Which kernel a CUDA call takes (gemm_path, by type and shape alone):
    with K > 0 and aligned operands (K and N multiples of 16 bytes' worth of
    elements, 16-byte bases) the bf16 wgmma kernel for two bf16 operands
    and the f32 one for two f32 operands, with or without the fused
    epilogue; the mma.sync core otherwise, in 16-byte pieces where
    aligned (K = 0)."""
    a, b = _operands(case)
    want = dict(sm90=tgemm.PATH_SM90, sm90_f32=tgemm.PATH_SM90_F32,
                aligned=tgemm.PATH_ALIGNED, elementwise=tgemm.PATH_ELEMENTWISE)[path]
    got = tgemm.gemm_path(a.dtype, b.dtype, a.shape, b.shape, tgemm._aligned(a, b),
                          epilogue=case.startswith("epilogue"))
    assert got == want


@pytest.mark.parametrize("config", [1, 2])
def test_baseline_config_slice_matches_jax(rng, config):
    """BASELINE.json configs 1 and 2 at a small size: matmul (f32) or
    matmul_bf16 (f32 out), then the row softmax of the product, against
    the JAX package's same two calls and against the fp64 oracle (config 2
    on the bf16-rounded inputs) at BASELINE's max-abs 1e-2."""
    a = rng.standard_normal((128, 96), dtype=np.float32)
    b = rng.standard_normal((96, 160), dtype=np.float32)
    jmm, tmm = (jops.matmul, ops.matmul) if config == 1 else (jops.matmul_bf16, ops.matmul_bf16)
    want = jops.softmax(jmm(jnp.asarray(a), jnp.asarray(b), **BLOCKS))
    got = ops.softmax.softmax(tmm(_t(a), _t(b)))
    assert_max_abs(got.numpy(), _np(want), tol=F32_TOL)
    ref_in = (a, b) if config == 1 else (_bf16(a), _bf16(b))
    assert_max_abs(got.numpy(), native.softmax(native.gemm(*ref_in)), tol=1e-2)


@pytest.mark.parametrize("what", ["gemm", "softmax", "attention", "attention_causal",
                                  "attention_offset"])
def test_native_oracle_matches_jax_oracles(rng, what):
    """The port's C++ oracle (or its numpy fallback where g++ is missing)
    against the JAX package's numpy oracles (tests/test_native_oracle.py's
    cases and bounds)."""
    if what == "gemm":
        a = rng.standard_normal((128, 96), dtype=np.float32)
        b = rng.standard_normal((96, 64), dtype=np.float32)
        np.testing.assert_allclose(native.gemm(a, b), joracles.gemm(a, b), atol=1e-6)
    elif what == "softmax":
        x = rng.standard_normal((32, 517), dtype=np.float32) * 4
        np.testing.assert_allclose(native.softmax(x), joracles.softmax(x), atol=1e-6)
    else:
        causal, q_offset = {"attention": (False, 0), "attention_causal": (True, 0),
                            "attention_offset": (True, 32)}[what]
        q = rng.standard_normal((2, 8, 48, 32), dtype=np.float32)
        k = rng.standard_normal((2, 2, 80, 32), dtype=np.float32)
        v = rng.standard_normal((2, 2, 80, 32), dtype=np.float32)
        got = native.gqa_attention(q, k, v, causal=causal, q_offset=q_offset)
        want = joracles.gqa_attention(q, k, v, causal=causal, q_offset=q_offset)
        np.testing.assert_allclose(got, want, atol=1e-5)


def test_native_oracle_builds():
    """g++ is in the image: the oracle builds into the port's build/ from
    the port's own oracle.cpp."""
    assert native.available()
    assert native.ORACLE_SRC.startswith(
        native.os.path.dirname(native.os.path.abspath(native.__file__)))


@pytest.mark.parametrize("what", ["gemm", "gemm_fused_epilogue", "softmax", "attention",
                                  "gqa_attention", "online_softmax_merge"])
def test_numpy_oracles_equal_jax(rng, what):
    """The port's numpy oracles compute what the JAX package's do."""
    if what in ("gemm", "gemm_fused_epilogue"):
        a = rng.standard_normal((3, 40, 24), dtype=np.float32)
        b = rng.standard_normal((3, 24, 16), dtype=np.float32)
        args = (a, b)
        if what == "gemm_fused_epilogue":
            args = (a[0], b[0], rng.standard_normal(16, dtype=np.float32),
                    rng.standard_normal((40, 16), dtype=np.float32))
        pairs = [(getattr(oracles, what)(*args), getattr(joracles, what)(*args))]
    elif what == "softmax":
        x = rng.standard_normal((5, 7, 33), dtype=np.float32) * 4
        pairs = [(oracles.softmax(x, axis=ax), joracles.softmax(x, axis=ax)) for ax in (-1, 1)]
    elif what in ("attention", "gqa_attention"):
        hkv = 2 if what == "gqa_attention" else 4
        q = rng.standard_normal((1, 4, 40, 16), dtype=np.float32)
        k = rng.standard_normal((1, hkv, 72, 16), dtype=np.float32)
        v = rng.standard_normal((1, hkv, 72, 16), dtype=np.float32)
        fn, jfn = getattr(oracles, what), getattr(joracles, what)
        pairs = [(fn(q, k, v, **kw), jfn(q, k, v, **kw)) for kw in (
            {}, dict(causal=True, q_offset=32), dict(causal=True, q_offset=32, window=16),
            dict(causal=True, q_offset=32, window=16, sinks=4), dict(scale=0.3))]
    else:
        def state(rows=4, dv=8):
            return (rng.standard_normal(rows).astype(np.float32) * 3,
                    rng.random(rows).astype(np.float32) + 0.5,
                    rng.standard_normal((rows, dv)).astype(np.float32))
        sa, sb = state(), state()
        pairs = list(zip(oracles.online_softmax_merge(sa, sb),
                         joracles.online_softmax_merge(sa, sb)))
    for got, want in pairs:
        np.testing.assert_array_equal(got, want)


def test_error_metrics_equal_jax(rng):
    a = rng.standard_normal((7, 9))
    b = a + rng.standard_normal((7, 9)) * 1e-3
    assert testing.max_abs_diff(a, b) == jtesting.max_abs_diff(a, b)
    assert testing.rel_l2(a, b) == jtesting.rel_l2(a, b)
    testing.assert_max_abs(a, b, tol=1e-2)
    with pytest.raises(AssertionError, match="max-abs-diff"):
        testing.assert_max_abs(a, b, tol=1e-6)
