"""The port's ragged forward and chunked `extend` against the JAX package's,
on the same numpy inputs and (converted) parameters, in float32 on the CPU
(the JAX kernels in interpret mode, the port's wrappers on their plain
versions); and the rule that the port builds and imports nothing from the
JAX package's directory."""

import importlib
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattention_kernel_project_tpu import models as jmodels
from flashattention_kernel_project_tpu.models import engine as jengine
from flashattention_kernel_project_tpu_torch.models import engine, transformer
from flashattention_kernel_project_tpu_torch.models.convert import params_from_jax
from flashattention_kernel_project_tpu_torch.ops import flash_attention as tfa
from flashattention_kernel_project_tpu_torch.utils.oracles import gqa_attention
from flashattention_kernel_project_tpu_torch.utils.testing import assert_rel_l2

jfa = importlib.import_module("flashattention_kernel_project_tpu.ops.flash_attention")

torch.set_num_threads(1)

TOL = 1e-4  # float32 on both sides
CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the tiny config of tests/test_torch_serving.py
JCFG = jmodels.TransformerConfig(
    vocab_size=64, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_head=16, d_ff=128, dtype=jnp.float32, block_q=32, block_k=32,
)
CFG = transformer.TransformerConfig(
    vocab_size=64, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_head=16, d_ff=128, dtype=torch.float32,
)


@pytest.fixture(scope="module")
def both_params():
    jp = jmodels.init_params(JCFG, jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), CPU)


def _ragged_inputs(seed, d):
    """GQA 4/2, N = 13 queries, S_max = 48, per-row bounds with an empty
    row (kv_len 0) and a row whose chunk starts at 0."""
    rng = np.random.default_rng(seed)
    b, hq, hkv, n, s = 3, 4, 2, 13, 48
    q = rng.standard_normal((b, hq, n, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    kv_lens = np.array([13, 40, 0], np.int32)
    q_offsets = np.array([0, 27, 0], np.int32)
    return q, k, v, kv_lens, q_offsets


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [16, 64])
def test_flash_attention_ragged_matches_jax(d, causal):
    q, k, v, kv_lens, q_offsets = _ragged_inputs(0, d)
    jo = jfa.flash_attention_ragged(
        *(jnp.asarray(x) for x in (q, k, v, kv_lens, q_offsets)),
        causal=causal, block_q=16, block_k=16, interpret=True,
    )
    to = tfa.flash_attention_ragged(
        *(torch.from_numpy(x) for x in (q, k, v, kv_lens, q_offsets)),
        causal=causal,
    )
    assert to.shape == q.shape and to.dtype == torch.float32
    assert_rel_l2(to.numpy(), np.asarray(jo), tol=TOL)
    np.testing.assert_array_equal(to.numpy()[2], 0.0)  # kv_len 0 -> zeros
    for row in range(2):  # each live row against the float64 oracle
        n_kv = kv_lens[row]
        exp = gqa_attention(q[row:row + 1], k[row:row + 1, :, :n_kv],
                            v[row:row + 1, :, :n_kv], causal=causal,
                            q_offset=int(q_offsets[row]))
        assert_rel_l2(to.numpy()[row:row + 1], exp, tol=TOL)


def test_flash_attention_ragged_options():
    """stable="auto" is the online path (as in the JAX package); the
    fixed-max discipline runs and matches JAX's, over a bf16 cache and over
    an 8-bit one (tests/test_torch_stable.py covers it more); window and
    sinks run (tests/test_torch_window.py holds them to JAX) and narrow
    what a row sees; CPU tensors leave the launch counter at 0."""
    npargs = _ragged_inputs(1, 16)
    q, k, v, kv_lens, q_offsets = (torch.from_numpy(x) for x in npargs)
    args = (q, k, v, kv_lens, q_offsets)
    torch.testing.assert_close(tfa.flash_attention_ragged(*args, stable="auto"),
                               tfa.flash_attention_ragged(*args), rtol=0, atol=0)
    jfixed = jfa.flash_attention_ragged(
        *(jnp.asarray(x) for x in npargs), stable=False, block_q=16,
        block_k=16, interpret=True)
    assert_rel_l2(tfa.flash_attention_ragged(*args, stable=False).numpy(),
                  np.asarray(jfixed), tol=TOL)
    full = tfa.flash_attention_ragged(*args)
    for kwargs in (dict(window=8), dict(window=8, sinks=2)):
        got = tfa.flash_attention_ragged(*args, **kwargs)
        assert got.shape == full.shape and torch.isfinite(got).all()
        assert not torch.equal(got, full)  # the band bites
    k8, scale = k.to(torch.int8), torch.ones(*k.shape[:3], 1)
    qargs = (q, k8, scale, k8, scale, kv_lens, q_offsets)
    jfixed = jfa.flash_attention_ragged_kv_quant(
        *(jnp.asarray(x.numpy()) for x in qargs), stable=False, block_q=16,
        block_k=16, interpret=True)
    assert_rel_l2(tfa.flash_attention_ragged_kv_quant(*qargs, stable=False).numpy(),
                  np.asarray(jfixed), tol=TOL)
    got = tfa.flash_attention_ragged_kv_quant(*qargs, window=8)
    torch.testing.assert_close(
        got, tfa.flash_attention_ragged(q, k8.float(), k8.float(), kv_lens,
                                        q_offsets, window=8))
    assert tfa.flash_attention_ragged.launches == 0
    bf = torch.zeros(1, 2, 8, 64, dtype=torch.bfloat16)
    with pytest.raises(TypeError):  # int64 bounds are refused before any build
        tfa._check_ragged_bounds(bf, torch.ones(1, dtype=torch.int64),
                                 torch.zeros(1, dtype=torch.int32))


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, size=shape,
                                                dtype=np.int32)


@pytest.mark.parametrize("all_logits", [False, True])
def test_extend_matches_jax(both_params, all_logits):
    """prefill, then a ragged extend (n=) on a live cache: logits and every
    cache row match the JAX engine's; lengths advance by n."""
    jp, tp = both_params
    toks = _tokens(1, (2, 6))
    chunk = _tokens(2, (2, 5))
    n = np.array([5, 3], np.int32)
    jcache = jmodels.init_cache(JCFG, 2, 24)
    _, jcache = jmodels.prefill(JCFG, jp, jnp.asarray(toks), jcache)
    jl, jcache = jengine.extend(JCFG, jp, jnp.asarray(chunk), jcache,
                                n=jnp.asarray(n), all_logits=all_logits)
    cache = engine.init_cache(CFG, 2, 24, CPU)
    engine.prefill(CFG, tp, torch.from_numpy(toks), cache)
    tl, cache2 = engine.extend(CFG, tp, torch.from_numpy(chunk), cache,
                               n=torch.from_numpy(n), all_logits=all_logits)
    assert cache2 is cache
    assert tl.shape == ((2, 5, CFG.vocab_size) if all_logits
                        else (2, CFG.vocab_size))
    assert_rel_l2(tl.numpy(), np.asarray(jl), tol=TOL)
    np.testing.assert_array_equal(cache.lengths.numpy(), [11, 9])
    np.testing.assert_array_equal(cache.lengths.numpy(), np.asarray(jcache.lengths))
    for i in range(CFG.n_layers):
        assert_rel_l2(cache.k[i].numpy(), np.asarray(jcache.k[i]), tol=TOL)
        assert_rel_l2(cache.v[i].numpy(), np.asarray(jcache.v[i]), tol=TOL)


def test_chunked_extends_match_full_forward(both_params):
    """A prompt fed as ragged chunks of 5 (the last one padded) from an
    empty cache gives the full forward's last logits, and a decode step
    from that cache gives the forward's next ones."""
    _, tp = both_params
    toks = _tokens(3, (1, 13))
    cache = engine.init_cache(CFG, 1, 13 + 5, CPU)
    for j0 in range(0, 13, 5):
        nj = min(5, 13 - j0)
        chunk = np.zeros((1, 5), np.int32)
        chunk[0, :nj] = toks[0, j0:j0 + nj]
        logits, cache = engine.extend(CFG, tp, torch.from_numpy(chunk), cache,
                                      n=torch.tensor([nj], dtype=torch.int32))
    full = transformer.forward(CFG, tp, torch.from_numpy(toks))
    assert_rel_l2(logits.numpy(), full[:, -1].numpy(), tol=TOL)
    assert int(cache.lengths[0]) == 13
    nxt = logits.argmax(-1).to(torch.int32)
    logits2, _ = engine.decode_step(CFG, tp, nxt, cache)
    full2 = transformer.forward(
        CFG, tp, torch.cat([torch.from_numpy(toks), nxt[:, None]], dim=1))
    assert_rel_l2(logits2.numpy(), full2[:, -1].numpy(), tol=TOL)


def test_port_builds_and_imports_nothing_of_the_jax_package():
    """Every source the port compiles lies in its own package, and
    importing all of the port loads no module of JAX or of the JAX
    package."""
    from flashattention_kernel_project_tpu_torch.ops import _build
    from flashattention_kernel_project_tpu_torch.runtime import data, native

    port = os.path.join(ROOT, "flashattention_kernel_project_tpu_torch") + os.sep
    sources = [native.SCHEDULER_SRC, native.ORACLE_SRC, data.DATALOADER_SRC,
               *_build.kernel_sources()]
    assert len(sources) >= 12
    for src in sources:
        assert os.path.abspath(src).startswith(port), src
        assert os.path.exists(src), src
    code = (
        "import os, pkgutil, importlib, sys\n"
        "import flashattention_kernel_project_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "jax_pkg = os.path.join(os.getcwd(), 'flashattention_kernel_project_tpu') + os.sep\n"
        "bad = [n for n, m in sys.modules.items() if n == 'jax'"
        " or n.startswith('jax.') or n.split('.')[0] == 'flashattention_kernel_project_tpu'"
        " or (getattr(m, '__file__', None) or '').startswith(jax_pkg)]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
