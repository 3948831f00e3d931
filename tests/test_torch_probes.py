"""The port's stage probes (ops/probes.py) against the JAX package's, in
float32 on the CPU: the JAX probes in interpret mode, as tests/test_probes.py
runs them, the port's on their plain versions, on the same numpy inputs."""

import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattention_kernel_project_tpu.ops import probes as jprobes
from flashattention_kernel_project_tpu_torch.ops import probes
from flashattention_kernel_project_tpu_torch.utils.testing import rel_l2

torch.set_num_threads(1)

# q (1, 4, 128, 32) against 2 KV heads of 128 keys, JAX's blocks 32 x 64
B, HQ, HKV, N, S, D = 1, 4, 2, 128, 128, 32
BLOCKS = dict(block_q=32, block_k=64)
EXACT_RTOL = 1e-6   # copy, chain, stream copy: the same sums in the same order
SUM_ORDER_TOL = 1e-5  # qk, qk_kt, pv: rel-L2, the sums taken in another order
PROBES = ["copy_probe", "qk_probe", "pv_probe", "softmax_chain_probe"]


def _inputs(seed, shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _both(name, arrays, **kw):
    """The JAX probe (interpret mode) and the port's, as numpy."""
    jo = getattr(jprobes, name)(*(jnp.asarray(a) for a in arrays),
                                interpret=True, **kw)
    to = getattr(probes, name)(*(torch.from_numpy(a) for a in arrays), **kw)
    assert to.dtype == torch.float32
    return np.asarray(jo), to.numpy()


@pytest.mark.parametrize("name", PROBES + ["qk_kt_probe"])
def test_probe_matches_jax(name):
    q, k, v = _inputs(0, [(B, HQ, N, D), (B, HKV, S, D), (B, HKV, S, D)])
    jo, to = _both(name, (q, k, v), **BLOCKS)
    assert to.shape == jo.shape == (B, HQ, N, D)
    if name in ("copy_probe", "softmax_chain_probe"):
        np.testing.assert_allclose(to, jo, rtol=EXACT_RTOL)
    else:
        assert rel_l2(to, jo) <= SUM_ORDER_TOL


@pytest.mark.parametrize("name", ["copy_probe", "qk_probe", "pv_probe",
                                  "qk_kt_probe", "qk_packed_probe"])
def test_probe_matches_jax_at_the_hopper_blocks_tails(name):
    """copy, qk, pv, qk_kt and qk_packed run on the Hopper forward's block on
    the card (rows in blocks of 64 or 128, keys in tiles of 128): here N =
    192 and S = 320, multiples of 64 that end inside a 128-row block and a
    128-key tile, with blocks of 64 (the copy adds a row every 64 keys, two
    a key tile; qk_packed's 8/4 heads make 2 pairs of 384 rows and 640
    keys), held against JAX's on the same inputs."""
    if name == "qk_packed_probe":
        arrays = _inputs(9, [(1, 8, 192, 32), (1, 4, 320, 32)])
        want = (1, 2, 2, 192, 64)
    else:
        arrays = _inputs(8, [(1, 4, 192, 32), (1, 2, 320, 32), (1, 2, 320, 32)])
        want = (1, 4, 192, 32)
    jo, to = _both(name, arrays, block_q=64, block_k=64)
    assert to.shape == jo.shape == want
    if name == "copy_probe":
        np.testing.assert_allclose(to, jo, rtol=EXACT_RTOL)
    else:
        assert rel_l2(to, jo) <= SUM_ORDER_TOL


@pytest.mark.parametrize("stages", ["products", "chain"])
def test_stage_numbers_are_the_kernels(stages):
    """The stage numbers the wrapper passes are the kernels' own, all
    csrc/flash_fwd_sm90.cuh's FwdStage (probes_sm90.cu): copy, qk, pv, qk_kt
    and qk_packed, whose kForward (the whole forward) is none of them; and
    the softmax chain's kProbeChain."""
    path = os.path.join(os.path.dirname(probes.__file__), os.pardir, "csrc",
                        "flash_fwd_sm90.cuh")
    with open(path) as f:
        body = re.search(r"enum FwdStage : int {([^}]*)}", f.read()).group(1)
    got = {name: int(value) for name, value in re.findall(r"(k\w+) = (-?\d+)", body)}
    if stages == "chain":
        assert got["kProbeChain"] == probes._CHAIN
        return
    want = dict(kProbeCopy=probes._COPY, kProbeQK=probes._QK, kProbePV=probes._PV,
                kProbeQKT=probes._QKT, kProbePacked=probes._PACKED)
    assert {name: got[name] for name in want} == want
    assert got["kForward"] not in range(6)


@pytest.mark.parametrize("stage", range(7))
def test_probe_route(stage):
    """The sizes a stage's CUDA launch passes to fkp_probe_sm90 (every
    stage's entry, the softmax chain's too), from CPU tensors: the caller's
    q and k, qk_packed at its packed operands' (pairs as both head counts,
    G * N rows, 2S keys, 2d); no stage 6."""
    b, hq, hkv, n, s, d = 2, 8, 4, 192, 320, 32
    q, k = torch.zeros(b, hq, n, d), torch.zeros(b, hkv, s, d)
    if stage == 6:
        with pytest.raises(ValueError, match="no probe stage"):
            probes.probe_sizes(stage, q, k)
        return
    sizes = probes.probe_sizes(stage, q, k)
    if stage == probes._PACKED:
        assert sizes == (2, 2, 2 * n, 2 * s, 2 * d)
        q_in, kp = probes._pack(q, k, 64)
        assert sizes == (q_in.shape[1], kp.shape[1], q_in.shape[2], kp.shape[2],
                         kp.shape[3])
    else:
        assert sizes == (hq, hkv, n, s, d)


def test_copy_probe_reads_each_tiles_first_row():
    """copy_probe's output depends on block_k: rows 0, 32, 64, 96 at 32."""
    q, k, v = _inputs(1, [(B, HQ, N, D), (B, HKV, S, D), (B, HKV, S, D)])
    jo, to = _both("copy_probe", (q, k, v), block_q=32, block_k=32)
    np.testing.assert_allclose(to, jo, rtol=EXACT_RTOL)
    want = (k[:, :, ::32] + v[:, :, ::32]).sum(axis=2)  # [B, HKV, D]
    np.testing.assert_allclose(to[0, 3, 5], want[0, 1], rtol=1e-5)


def test_qk_packed_probe_matches_jax():
    """tests/test_probes.py:32's shape: 8/4 heads, 256 rows, d 32."""
    q, k = _inputs(2, [(1, 8, 256, 32), (1, 4, 256, 32)])
    jo, to = _both("qk_packed_probe", (q, k), block_q=64, block_k=64)
    assert to.shape == jo.shape == (1, 2, 2, 256, 64)
    np.testing.assert_allclose(to, jo, rtol=2e-4, atol=1e-2)  # JAX's own bound


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_stream_copy_probe_matches_jax(dtype):
    (x,) = _inputs(3, [(256, 128)])
    if dtype == "bfloat16":
        jo = jprobes.stream_copy_probe(jnp.asarray(x, jnp.bfloat16), interpret=True)
        to = probes.stream_copy_probe(torch.from_numpy(x).bfloat16())
        assert to.dtype == torch.bfloat16
        jo, to = np.asarray(jo.astype(jnp.float32)), to.float().numpy()
    else:
        jo, to = _both("stream_copy_probe", (x,))
    assert to.shape == (256, 128)
    np.testing.assert_allclose(to, jo, rtol=EXACT_RTOL)


@pytest.mark.parametrize("blocks", [dict(block_q=48, block_k=64),
                                    dict(block_q=32, block_k=48),
                                    dict(block_q=0, block_k=64)])
def test_block_that_does_not_divide_raises(blocks):
    """JAX's grid truncates (n // block_q) and leaves the tail unwritten;
    the port refuses such a block."""
    q, k, v = (torch.from_numpy(a) for a in
               _inputs(4, [(B, HQ, N, D), (B, HKV, S, D), (B, HKV, S, D)]))
    for name in PROBES + ["qk_kt_probe"]:
        with pytest.raises(ValueError, match="must divide"):
            getattr(probes, name)(q, k, v, **blocks)
    with pytest.raises(ValueError, match="must divide"):
        probes.qk_packed_probe(q, k, **blocks)


def test_packed_probe_needs_an_even_kv_head_count():
    q, k = (torch.from_numpy(a) for a in _inputs(5, [(1, 3, 64, 32), (1, 3, 64, 32)]))
    with pytest.raises(ValueError, match="even"):
        probes.qk_packed_probe(q, k, block_q=64, block_k=64)


def test_counters_stay_zero_on_cpu_tensors():
    q, k, v = (torch.from_numpy(a) for a in
               _inputs(6, [(B, HQ, N, D), (B, HKV, S, D), (B, HKV, S, D)]))
    fns = [getattr(probes, name) for name in PROBES + ["qk_kt_probe"]]
    for fn in fns:
        fn(q, k, v, **BLOCKS)
    probes.qk_packed_probe(q, k, **BLOCKS)
    probes.stream_copy_probe(q[0, 0])
    fns += [probes.qk_packed_probe, probes.stream_copy_probe]
    assert [fn.launches for fn in fns] == [0] * len(fns)


def test_cuda_checks_refuse_what_the_kernel_does_not_take():
    """The checks in front of the kernel run without a card: f32, a head
    dim outside {64, 128}, N not a multiple of the 64-row tile."""
    def t(*shape, dtype=torch.bfloat16):
        return torch.zeros(*shape, dtype=dtype)

    with pytest.raises(TypeError, match="bf16"):
        probes._check_cuda("qk_probe", t(1, 4, 128, 64, dtype=torch.float32),
                           t(1, 2, 128, 64), t(1, 2, 128, 64))
    with pytest.raises(ValueError, match="d in"):
        probes._check_cuda("qk_probe", t(1, 4, 128, 32), t(1, 2, 128, 32),
                           t(1, 2, 128, 32))
    with pytest.raises(ValueError, match="multiples of 64"):
        probes._check_cuda("qk_probe", t(1, 4, 96, 64), t(1, 2, 128, 64),
                           t(1, 2, 128, 64))


def test_packing_is_jaxs():
    """The packed operands built in torch for the kernel equal JAX's
    (probes.py:199-218): q pairs side by side, K tiles block-diagonal."""
    q, k = _inputs(7, [(1, 8, 128, 32), (1, 4, 128, 32)])
    q_in, kp = probes._pack(torch.from_numpy(q), torch.from_numpy(k), 64)
    b, pairs, group, n, d = 1, 2, 2, 128, 32
    jq = (q.reshape(b, pairs, 2, group, n, d).transpose(0, 1, 3, 4, 2, 5)
          .reshape(b, pairs, group * n, 2 * d))
    np.testing.assert_array_equal(q_in.numpy(), jq)
    ka = k[:, 0::2].reshape(b, pairs, 2, 64, d)
    kb = k[:, 1::2].reshape(b, pairs, 2, 64, d)
    z = np.zeros_like(ka)
    jk = np.concatenate([np.concatenate([ka, z], -1), np.concatenate([z, kb], -1)],
                        -2).reshape(b, pairs, 256, 2 * d)
    np.testing.assert_array_equal(kp.numpy(), jk)
    # the block-diagonal product's row sums are the packed probe's output
    sums = (q_in.double() @ kp.double().transpose(-1, -2)).sum(-1)
    want = probes.qk_packed_probe(torch.from_numpy(q), torch.from_numpy(k),
                                  block_q=64, block_k=64)
    np.testing.assert_allclose(want[..., 0].reshape(b, pairs, group * n).numpy(),
                               sums.numpy(), rtol=1e-4, atol=1e-3)


def test_probes_import_without_jax():
    code = ("import sys; import flashattention_kernel_project_tpu_torch.ops.probes; "
            "assert 'jax' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True)
