"""The port's bf16 GEMMs at the edges of the wgmma kernel's tiles against
the JAX package's, on the CPU (the JAX kernels in interpret mode with the
blocks of tests/test_torch_gemm.py, the port's wrappers on their plain
versions): matmul at batch 1 and batched_matmul, bf16 operands to bf16 and
to f32, at the shapes chip_smoke.py holds the kernel to on the card
(csrc/gemm_sm90.cuh: 128-row tiles, 64-deep K slices, 128- or 256-column
tiles) at a narrow width: M and N off the tile, K not a multiple of 64 and
K < 64, an N tile of 8 live columns, batch 3 with a ragged M."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattention_kernel_project_tpu import ops as jops
from flashattention_kernel_project_tpu_torch import ops
from flashattention_kernel_project_tpu_torch.utils import oracles
from flashattention_kernel_project_tpu_torch.utils.testing import assert_rel_l2

torch.set_num_threads(1)

F32_TOL = 1e-5   # f32 out: products of bf16 values are exact, only the sums' order differs
BF16_TOL = 1e-2  # bf16 outputs, the JAX suite's bound
BLOCKS = dict(block_m=128, block_n=128, block_k=128)  # as tests/test_gemm.py

SHAPES = [  # batch, m, k, n
    (1, 200, 136, 72),    # M, N off the tiles; K one slice and 8
    (1, 129, 8, 264),     # K < 64; one row past a tile; 8 live columns past 256
    (3, 200, 72, 136),    # batch 3, ragged M
    (2, 260, 200, 264),   # M, K, N ragged at batch 2
    (1, 300, 328, 136),   # K five slices and 8
]


@pytest.mark.parametrize("out", ["bf16", "f32"])
@pytest.mark.parametrize("batch,m,k,n", SHAPES)
def test_gemm_tile_edges_match_jax(rng, batch, m, k, n, out):
    a = rng.standard_normal((batch, m, k), dtype=np.float32)
    b = rng.standard_normal((batch, k, n), dtype=np.float32)
    ja, jb = jnp.asarray(a).astype(jnp.bfloat16), jnp.asarray(b).astype(jnp.bfloat16)
    ta, tb = torch.from_numpy(a).bfloat16(), torch.from_numpy(b).bfloat16()
    jdt, tdt = (jnp.float32, torch.float32) if out == "f32" else (jnp.bfloat16, torch.bfloat16)
    if batch == 1:
        want = jops.matmul(ja[0], jb[0], out_dtype=jdt, **BLOCKS)[None]
        got = ops.matmul(ta[0], tb[0], out_dtype=tdt)[None]
    else:
        want = jops.batched_matmul(ja, jb, out_dtype=jdt, **BLOCKS)
        got = ops.batched_matmul(ta, tb, out_dtype=tdt)
    assert got.dtype == tdt and tuple(got.shape) == (batch, m, n)
    want = np.asarray(want.astype(jnp.float32))
    assert_rel_l2(got.float().numpy(), want, tol=F32_TOL if out == "f32" else BF16_TOL)
    exact = oracles.gemm(np.asarray(ja.astype(jnp.float32)), np.asarray(jb.astype(jnp.float32)))
    assert_rel_l2(got.float().numpy(), exact, tol=BF16_TOL)
