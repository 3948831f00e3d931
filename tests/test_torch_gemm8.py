"""The port's 8-bit GEMMs against the JAX package's, on the CPU (the JAX
kernels in interpret mode, the port's wrappers on their plain versions):
the weight-only GEMM over int8 and e4m3 weights (kernel 19) and the int8 x
int8 GEMM (kernel 20), at the JAX suite's ragged shapes, each operand
quantized from the same numpy data by both packages' quantizers."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattention_kernel_project_tpu_torch import ops
from flashattention_kernel_project_tpu_torch.models.convert import params_from_jax
from flashattention_kernel_project_tpu_torch.ops import quant as tq
from flashattention_kernel_project_tpu_torch.utils.testing import assert_rel_l2

jq = importlib.import_module("flashattention_kernel_project_tpu.ops.quant")

torch.set_num_threads(1)

F32_TOL = 1e-5    # f32 on both sides: the same products, summed in another order
ORACLE_TOL = 1e-2  # against the dequantized operands in float64 (BASELINE.md)
CPU = torch.device("cpu")
J_TYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16}
T_TYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _same(t, a):
    """Tensor t equals the JAX array a bit for bit (8-bit types kept)."""
    a = params_from_jax(np.asarray(a), CPU)
    if t.dtype != a.dtype or t.shape != a.shape:
        return False
    if t.element_size() == 1:
        return torch.equal(t.view(torch.uint8), a.view(torch.uint8))
    return torch.equal(t, a)


def _weights(rng, k, n, fmt):
    """[K, N] weights quantized per output column by both packages: (the
    JAX pair, the port's pair), checked bit-equal."""
    w = rng.standard_normal((k, n)).astype(np.float32)
    if fmt == "int8":
        jw = jq.quantize_int8(jnp.asarray(w), axis=0)
        tw = tq.quantize_int8(torch.from_numpy(w), axis=0)
    else:
        jw = jq.quantize_fp8_weights(jnp.asarray(w))
        tw = tq.quantize_fp8_weights(torch.from_numpy(w))
    assert _same(tw[0], jw[0]) and _same(tw[1], jw[1])
    return jw, tw


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("xdt", ["f32", "bf16"])
def test_matmul_weights_8bit_matches_jax(rng, fmt, xdt):
    """Kernel 19 at tests/test_quant.py's ragged 100 x 200 x 130: x rounded
    to bf16 first (the TPU kernel's first step), the widened weights, the
    column scale on the f32 accumulator; against JAX and against the
    dequantized float64 product."""
    m, k, n = 100, 200, 130
    x = rng.standard_normal((m, k)).astype(np.float32)
    (jwq, jws), (twq, tws) = _weights(rng, k, n, fmt)
    jx = jnp.asarray(x).astype(J_TYPES[xdt])
    tx = torch.from_numpy(x).to(T_TYPES[xdt])
    jfn, tfn = ((jq.matmul_int8_weights, ops.matmul_int8_weights) if fmt == "int8"
                else (jq.matmul_fp8_weights, ops.matmul_fp8_weights))
    want = np.asarray(jfn(jx, jwq, jws))
    got = tfn(tx, twq, tws)
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    assert_rel_l2(got.numpy(), want, tol=F32_TOL)
    xb = tx.to(torch.bfloat16).double().numpy()
    oracle = xb @ (twq.double() * tws.double()).numpy()
    assert_rel_l2(got.numpy(), oracle, tol=ORACLE_TOL)


def test_matmul_weights_8bit_bf16_out_matches_jax(rng):
    """The ladder rungs' bf16 output: the f32 result rounded once."""
    x = rng.standard_normal((64, 96)).astype(np.float32)
    (jwq, jws), (twq, tws) = _weights(rng, 96, 80, "int8")
    want = jq.matmul_int8_weights(jnp.asarray(x, jnp.bfloat16), jwq, jws,
                                  out_dtype=jnp.bfloat16)
    got = ops.matmul_int8_weights(torch.from_numpy(x).bfloat16(), twq, tws,
                                  out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert_rel_l2(got.float().numpy(), np.asarray(want, np.float32), tol=1e-2)


@pytest.mark.parametrize("out", ["f32", "bf16"])
def test_matmul_int8_matches_jax(rng, out):
    """Kernel 20 at tests/test_quant.py's 200 x 320 x 150: an exact int32
    sum, then the row and column scales in JAX's order."""
    m, k, n = 200, 320, 150
    a = rng.standard_normal((m, k)).astype(np.float32)
    ja, ta = jq.quantize_int8(jnp.asarray(a), axis=1), tq.quantize_int8(
        torch.from_numpy(a), axis=1)
    assert _same(ta[0], ja[0]) and _same(ta[1], ja[1])
    (jb, jbs), (tb, tbs) = _weights(rng, k, n, "int8")
    want = np.asarray(jq.matmul_int8(ja[0], ja[1], jb, jbs, out_dtype=J_TYPES[out]),
                      np.float32)
    got = ops.matmul_int8(ta[0], ta[1], tb, tbs, out_dtype=T_TYPES[out])
    assert got.dtype == T_TYPES[out] and tuple(got.shape) == (m, n)
    assert_rel_l2(got.float().numpy(), want, tol=1e-6)
    oracle = (ta[0].double() * ta[1].double()).numpy() @ (tb.double() * tbs.double()).numpy()
    assert_rel_l2(got.float().numpy(), oracle, tol=ORACLE_TOL)


def test_matmul_int8_plain_sum_is_exact(rng):
    """The plain version's sum through float64 equals numpy's exact int64
    sum, here at sums near the int32 range (K = 4096, values up to +-127):
    with unit scales the output is that sum rounded once to f32."""
    m, k, n = 8, 4096, 24
    a = rng.integers(-127, 128, size=(m, k)).astype(np.int8)
    b = rng.integers(-127, 128, size=(k, n)).astype(np.int8)
    a[0], b[:, 0] = 127, 127  # one sum of 4096 * 127^2 = 66,064,384
    exact = a.astype(np.int64) @ b.astype(np.int64)
    got = tq._matmul_i8_plain(torch.from_numpy(a), torch.ones(m, 1),
                              torch.from_numpy(b), torch.ones(1, n), torch.float32)
    np.testing.assert_array_equal(got.numpy(), exact.astype(np.float32))
    assert exact[0, 0] == k * 127 * 127


def test_8bit_gemm_checks_raise():
    """Shapes that make no product, scales of the wrong shape and operands
    of the wrong type raise (ValueError where JAX asserts a shape,
    TypeError for a type)."""
    x = torch.zeros(4, 8)
    wq, ws = tq.quantize_int8(torch.ones(8, 6), axis=0)
    fq, fs = tq.quantize_fp8_weights(torch.ones(8, 6))
    with pytest.raises(ValueError, match="product"):
        ops.matmul_int8_weights(x, wq[:5], ws)
    with pytest.raises(ValueError, match="w_scale"):
        ops.matmul_int8_weights(x, wq, ws[:, :5])
    with pytest.raises(TypeError, match="float8_e4m3fn"):
        ops.matmul_fp8_weights(x, wq, ws)
    with pytest.raises(TypeError, match="int8 or e4m3"):
        ops.matmul_int8_weights(x, wq.float(), ws)
    assert ops.matmul_int8_weights(x, fq, fs).shape == (4, 6)  # one kernel, as in JAX
    aq, as_ = tq.quantize_int8(torch.ones(4, 8), axis=1)
    with pytest.raises(ValueError, match="a_scale"):
        ops.matmul_int8(aq, as_.T, wq, ws)
    with pytest.raises(ValueError, match="product"):
        ops.matmul_int8(aq, as_, wq[:5], ws)
    with pytest.raises(TypeError, match="int8 operands"):
        ops.matmul_int8(aq.float(), as_, wq, ws)
