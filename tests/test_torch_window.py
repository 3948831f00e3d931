"""The port's sliding window and attention sinks against the JAX package's,
in float32 on the CPU (the JAX kernels in interpret mode with 16-row
blocks, the port's wrappers on their plain versions): the forward, its LSE
and gradients, the ragged forward over bf16 and 8-bit caches, the linear
decodes, the argument checks, and a windowed model end to end (generate,
the loss and its gradients, the Scheduler in each mode)."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattention_kernel_project_tpu import models as jmodels
from flashattention_kernel_project_tpu.models.serving import Scheduler as JScheduler
from flashattention_kernel_project_tpu_torch.models import engine, transformer
from flashattention_kernel_project_tpu_torch.models.convert import params_from_jax
from flashattention_kernel_project_tpu_torch.models.serving import Scheduler
from flashattention_kernel_project_tpu_torch.ops import flash_attention as tfa
from flashattention_kernel_project_tpu_torch.ops import flash_decode as tfd
from flashattention_kernel_project_tpu_torch.ops import quant as tq
from flashattention_kernel_project_tpu_torch.utils.testing import assert_rel_l2

jfa = importlib.import_module("flashattention_kernel_project_tpu.ops.flash_attention")
jfd = importlib.import_module("flashattention_kernel_project_tpu.ops.flash_decode")
jq = importlib.import_module("flashattention_kernel_project_tpu.ops.quant")

torch.set_num_threads(1)

TOL = 1e-4        # float32 on both sides (tests/test_torch_ops.py)
GRAD_TOL = 1e-3   # gradients, through the log2(e) fold (tests/test_torch_backward.py)
BLK = 16          # the JAX kernels' blocks: windows and sinks cross them
CPU = torch.device("cpu")


def _inputs(seed, b, hq, hkv, n, s, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32) for shape in
                 ((b, hq, n, d), (b, hkv, s, d), (b, hkv, s, d), (b, hq, n, d)))


def _band_oracle(q, k, v, q_offset, window, sinks):
    """float64 numpy attention over the band: query i (position i +
    q_offset) sees key j iff j <= pos and (j > pos - window or j < sinks)."""
    b, hq, n, d = q.shape
    group = hq // k.shape[1]
    kf = np.repeat(k.astype(np.float64), group, axis=1)
    vf = np.repeat(v.astype(np.float64), group, axis=1)
    s = q.astype(np.float64) @ kf.swapaxes(-1, -2) / np.sqrt(d)
    pos = np.arange(n)[:, None] + q_offset
    col = np.arange(k.shape[2])[None, :]
    mask = (col <= pos) & ((col > pos - window) | (col < sinks))
    s = np.where(mask, s, -np.inf)
    m = s.max(-1, keepdims=True)
    p = np.where(mask, np.exp(s - np.where(np.isfinite(m), m, 0.0)), 0.0)
    l = p.sum(-1, keepdims=True)
    return (p @ vf) / np.where(l == 0, 1.0, l)


# b, hq, hkv, n, s, d, q_offset, window, sinks
CASES = {
    "window_below_block": (1, 2, 2, 40, 40, 16, 0, 5, 0),
    "window_across_blocks": (1, 4, 2, 64, 64, 16, 0, 24, 0),
    "sinks_below_block": (1, 4, 2, 64, 64, 16, 0, 20, 3),
    "sinks_above_block": (1, 2, 1, 80, 80, 16, 0, 12, 20),
    "q_offset": (2, 4, 2, 24, 56, 16, 32, 10, 2),
    "gqa_4": (1, 4, 1, 48, 48, 32, 0, 16, 4),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_lse_match_jax(case):
    b, hq, hkv, n, s, d, q_offset, window, sinks = CASES[case]
    q, k, v, _ = _inputs(0, b, hq, hkv, n, s, d)
    kw = dict(causal=True, q_offset=q_offset, window=window, sinks=sinks)
    jo, jl = jfa.flash_attention_with_lse(
        *map(jnp.asarray, (q, k, v)), block_q=BLK, block_k=BLK, interpret=True,
        **kw)
    to, tl = tfa.flash_attention_with_lse(*map(torch.from_numpy, (q, k, v)), **kw)
    assert_rel_l2(to.numpy(), np.asarray(jo), tol=TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    assert_rel_l2(to.numpy(), _band_oracle(q, k, v, q_offset, window, sinks),
                  tol=TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradients_match_jax(case):
    """autograd through the port's flash_attention against jax.grad through
    the JAX one, on tests/test_flash_attention.py's loss sum(o * cos(o));
    and `_bwd_plain` against `_bwd_pallas` on the same (o, lse)."""
    b, hq, hkv, n, s, d, q_offset, window, sinks = CASES[case]
    q, k, v, do = _inputs(1, b, hq, hkv, n, s, d)
    kw = dict(causal=True, q_offset=q_offset, window=window, sinks=sinks)

    def jloss(q, k, v):
        o = jfa.flash_attention(q, k, v, block_q=BLK, block_k=BLK,
                                interpret=True, **kw)
        return jnp.sum(o * jnp.cos(o))

    exp = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    o = tfa.flash_attention(*ts, **kw)
    got = torch.autograd.grad((o * torch.cos(o)).sum(), ts)
    for name, g, e in zip(("dq", "dk", "dv"), got, exp):
        assert_rel_l2(g.numpy(), np.asarray(e), tol=GRAD_TOL, msg=name)

    qj, kj, vj, doj = map(jnp.asarray, (q, k, v, do))
    jo, jl = jfa.flash_attention_with_lse(qj, kj, vj, block_q=BLK, block_k=BLK,
                                          interpret=True, **kw)
    exp = jfa._bwd_pallas((qj, kj, vj, jo, jl), doj, True, d ** -0.5, q_offset,
                          BLK, BLK, True, window=window, sinks=sinks)
    t = [torch.from_numpy(np.array(x)) for x in (q, k, v, jo, jl, do)]
    got = tfa._bwd_plain(*t, True, d ** -0.5, q_offset, window, sinks)
    for name, g, e in zip(("dq", "dk", "dv"), got, exp):
        assert_rel_l2(g.numpy(), np.asarray(e), tol=GRAD_TOL, msg=name)


def test_keys_no_row_sees_get_zero_gradients():
    """With q_offset = 40 and a window of 8, keys 4..32 lie between the
    sinks and every row's band: their dK and dV are exactly 0."""
    q, k, v, _ = _inputs(2, 1, 2, 1, 16, 56, 16)
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    o = tfa.flash_attention(*ts, causal=True, q_offset=40, window=8, sinks=4)
    o.sum().backward()
    for t in ts[1:]:
        assert not t.grad[:, :, 4:33].any() and t.grad[:, :, :4].abs().sum() > 0


def _ragged_inputs(seed, d=16):
    """A chunk of T = 20 queries against a cache of 96 rows: row 0 a
    fresh prompt, row 1 a chunk at offset 50 (past the window), row 2 an
    empty row, row 3 a chunk whose band crosses the sinks."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((4, 4, 20, d)).astype(np.float32)
    k = rng.standard_normal((4, 2, 96, d)).astype(np.float32)
    v = rng.standard_normal((4, 2, 96, d)).astype(np.float32)
    kv_lens = np.array([20, 70, 0, 37], np.int32)
    q_offsets = np.array([0, 50, 0, 17], np.int32)
    return q, k, v, kv_lens, q_offsets


@pytest.mark.parametrize("window,sinks", [(12, 0), (12, 3), (6, 20)])
def test_ragged_matches_jax(window, sinks):
    q, k, v, kv_lens, q_offsets = _ragged_inputs(3)
    kw = dict(causal=True, window=window, sinks=sinks)
    jo = jfa.flash_attention_ragged(
        *map(jnp.asarray, (q, k, v, kv_lens, q_offsets)), block_q=BLK,
        block_k=BLK, interpret=True, **kw)
    to = tfa.flash_attention_ragged(
        *map(torch.from_numpy, (q, k, v, kv_lens, q_offsets)), **kw)
    assert_rel_l2(to.numpy(), np.asarray(jo), tol=TOL)
    np.testing.assert_array_equal(to.numpy()[2], 0.0)  # kv_len 0 -> zeros
    for row in (0, 1, 3):  # each live row against the float64 oracle
        n_kv = kv_lens[row]
        exp = _band_oracle(q[row:row + 1], k[row:row + 1, :, :n_kv],
                           v[row:row + 1, :, :n_kv], int(q_offsets[row]),
                           window, sinks)
        assert_rel_l2(to.numpy()[row:row + 1], exp, tol=TOL)


def _quantize(x, fmt):
    """The JAX package's per-token quantizer: (values, scales) of x
    [..., D], the engine's 8-bit cache layout."""
    fn = jq.quantize_fp8_tokenwise if fmt == "fp8" else jq.quantize_int8
    vals, scales = fn(jnp.asarray(x), axis=-1)
    return np.asarray(vals), np.asarray(scales, np.float32)


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_ragged_8bit_matches_jax(fmt):
    q, k, v, kv_lens, q_offsets = _ragged_inputs(4)
    (kq, ks), (vq, vs) = _quantize(k, fmt), _quantize(v, fmt)
    kw = dict(causal=True, window=12, sinks=3)
    jo = jfa.flash_attention_ragged_kv_quant(
        *map(jnp.asarray, (q, kq, ks, vq, vs, kv_lens, q_offsets)),
        block_q=BLK, block_k=BLK, interpret=True, **kw)
    tq8 = [params_from_jax(x, CPU) for x in (kq, ks, vq, vs)]
    to = tfa.flash_attention_ragged_kv_quant(
        torch.from_numpy(q), *tq8,
        *map(torch.from_numpy, (kv_lens, q_offsets)), **kw)
    assert tq8[0].dtype == tq.cache_dtype(fmt)
    assert_rel_l2(to.numpy(), np.asarray(jo), tol=TOL)


def _decode_inputs(seed, s=96, d=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((5, 4, d)).astype(np.float32)
    k = rng.standard_normal((5, 2, s, d)).astype(np.float32)
    v = rng.standard_normal((5, 2, s, d)).astype(np.float32)
    # empty, shorter than the window, one past it, and two long rows whose
    # middle splits lie wholly in the gap between the sinks and the band
    lengths = np.array([0, 7, 13, 80, s], np.int32)
    return q, k, v, lengths


@pytest.mark.parametrize("window,sinks", [(12, 0), (12, 3), (12, 40)])
def test_decode_matches_jax(window, sinks):
    q, k, v, lengths = _decode_inputs(5)
    kw = dict(n_splits=6, window=window, sinks=sinks)  # splits of 16 keys
    jo = jfd.flash_decode(*map(jnp.asarray, (q, k, v, lengths)),
                          interpret=True, **kw)
    to = tfd.flash_decode(*map(torch.from_numpy, (q, k, v, lengths)), **kw)
    assert_rel_l2(to.numpy(), np.asarray(jo), tol=TOL)
    np.testing.assert_array_equal(to.numpy()[0], 0.0)
    # the decode is the forward's last row: a one-query ragged chunk at
    # offset length - 1
    live = lengths > 0
    ragged = tfa.flash_attention_ragged(
        *map(torch.from_numpy, (q[live][:, :, None], k[live], v[live],
                                lengths[live], lengths[live] - 1)),
        causal=True, window=window, sinks=sinks)
    torch.testing.assert_close(to[torch.from_numpy(live)], ragged[:, :, 0],
                               rtol=1e-5, atol=1e-5)


def test_decode_gap_splits_are_dead():
    """A split wholly between the sinks and the band contributes
    (NEG_INF, 0, 0): the partials of splits 1-3 of a length-96 row with
    window 12 and 3 sinks."""
    q, k, v, lengths = _decode_inputs(6)
    parts = tfd._decode_partials_plain(
        *map(torch.from_numpy, (q, k, v, lengths)), 6, 16, 0.25, 12, 3)
    m, l, y = (x[4, :, 1:5] for x in parts)
    assert (m == tfd.NEG_INF).all() and not l.any() and not y.any()
    # split 0 holds the sinks, split 5 the band
    assert parts[1][4, :, 0].gt(0).all() and parts[1][4, :, 5].gt(0).all()


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_decode_8bit_matches_jax(fmt):
    q, k, v, lengths = _decode_inputs(7)
    (kq, ks), (vq, vs) = _quantize(k, fmt), _quantize(v, fmt)
    kw = dict(n_splits=6, window=12, sinks=3)
    jfn = jfd.flash_decode_fp8 if fmt == "fp8" else jfd.flash_decode_int8
    jo = jfn(*map(jnp.asarray, (q, kq, ks, vq, vs, lengths)), interpret=True,
             **kw)
    tfn = tfd.flash_decode_fp8 if fmt == "fp8" else tfd.flash_decode_int8
    to = tfn(torch.from_numpy(q), *(params_from_jax(x, CPU) for x in (kq, ks, vq, vs)),
             torch.from_numpy(lengths), **kw)
    assert_rel_l2(to.numpy(), np.asarray(jo), tol=TOL)


def test_argument_checks():
    """The JAX package's asserts as ValueErrors: a window needs causal and
    window >= 1, sinks need a window; the decode ignores sinks without a
    window, as JAX's does, and refuses window < 1."""
    q, k, v = (torch.zeros(1, 2, 8, 16) for _ in range(3))
    lens = torch.tensor([8], dtype=torch.int32)
    for kwargs in (dict(causal=False, window=4), dict(causal=True, window=0),
                   dict(causal=True, sinks=2),
                   dict(causal=True, window=4, sinks=-1)):
        with pytest.raises(ValueError):
            tfa.flash_attention(q, k, v, **kwargs)
        with pytest.raises(ValueError):
            tfa.flash_attention_with_lse(q, k, v, **kwargs)
        with pytest.raises(ValueError):
            tfa.flash_attention_ragged(q, k, v, lens, lens * 0, **kwargs)
    with pytest.raises(ValueError):
        tfd.flash_decode(q[:, :, 0], k, v, lens, window=0)
    assert torch.equal(tfd.flash_decode(q[:, :, 0], k, v, lens, sinks=3),
                       tfd.flash_decode(q[:, :, 0], k, v, lens))


# a tiny windowed model: the window (10) and the sinks (3) bite at the
# tests' prompt lengths and cross the JAX model's 32-row blocks only at the
# longer prompts
JCFG = jmodels.TransformerConfig(
    vocab_size=64, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_head=16, d_ff=128, dtype=jnp.float32, block_q=32, block_k=32,
    attn_window=10, attn_sinks=3,
)
CFG = transformer.TransformerConfig(
    vocab_size=64, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_head=16, d_ff=128, dtype=torch.float32, attn_window=10, attn_sinks=3,
)
JDRAFT = dataclasses.replace(JCFG, n_layers=1, d_ff=64)
DRAFT = dataclasses.replace(CFG, n_layers=1, d_ff=64)


def _to_torch(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree), CPU)


@pytest.fixture(scope="module")
def both_params():
    jp = jmodels.init_params(JCFG, jax.random.PRNGKey(0))
    jd = jmodels.init_params(JDRAFT, jax.random.PRNGKey(99))
    return jp, _to_torch(jp), jd, _to_torch(jd)


@pytest.mark.parametrize("window,sinks", [(12, 0), (10, 4)])
def test_generate_matches_teacher_forcing_and_jax(both_params, window, sinks):
    """tests/test_model.py:222-250 in the port: windowed generate equals
    teacher forcing through the windowed forward, and JAX's generate."""
    jp, tp, _, _ = both_params
    jcfg = dataclasses.replace(JCFG, attn_window=window, attn_sinks=sinks)
    cfg = dataclasses.replace(CFG, attn_window=window, attn_sinks=sinks)
    prompt = np.random.default_rng(8).integers(
        0, cfg.vocab_size, size=(2, 20)).astype(np.int32)
    out = engine.generate(cfg, tp, torch.from_numpy(prompt), max_new_tokens=5,
                          n_splits=2)
    ref = torch.from_numpy(prompt)
    for _ in range(5):
        nxt = transformer.forward(cfg, tp, ref)[:, -1].argmax(-1)
        ref = torch.cat([ref, nxt[:, None].to(ref.dtype)], dim=1)
    np.testing.assert_array_equal(out.numpy(), ref.numpy())
    jout = jmodels.generate(jcfg, jp, jnp.asarray(prompt), max_new_tokens=5,
                            n_splits=2)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))


def test_loss_and_gradients_match_jax(both_params):
    jp, tp, _, _ = both_params
    toks = np.random.default_rng(9).integers(
        0, CFG.vocab_size, size=(2, 40)).astype(np.int32)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jmodels.loss_fn(JCFG, p, jnp.asarray(toks)))(jp)
    flat = transformer._leaves
    leaves = {k: x.clone().requires_grad_(True) for k, x in flat(tp).items()}
    loss = transformer.loss_fn(CFG, transformer._unflatten(leaves),
                               torch.from_numpy(toks))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=TOL)
    jflat = flat(jax.tree.map(np.asarray, jgrads))
    for (name, _), g in zip(leaves.items(), grads):
        assert_rel_l2(g.numpy(), jflat[name], tol=GRAD_TOL, msg=name)
    # a train step moves the windowed model as JAX's does
    new, loss = transformer.sgd_train_step(CFG, tp, torch.from_numpy(toks), 0.1)
    jnew, jl = jmodels.sgd_train_step(JCFG, jp, jnp.asarray(toks), lr=0.1)
    np.testing.assert_allclose(float(loss), float(jl), rtol=GRAD_TOL)
    assert_rel_l2(new["layers"]["wq"].numpy(), np.asarray(jnew["layers"]["wq"]),
                  tol=GRAD_TOL)


def _prompts(seed, lens, base=None):
    rng = np.random.default_rng(seed)
    out = [rng.integers(0, CFG.vocab_size, size=n).astype(np.int32) for n in lens]
    if base is not None:
        out = [np.concatenate([base, p]) for p in out]
    return out


def _run(sched, prompts, max_new):
    uids = [sched.submit(p, max_new_tokens=max_new) for p in prompts]
    out = sched.run()
    return [out[u] for u in uids]


# (kwargs, (prompt seed, lengths, shared prefix), max_new, max_batch,
# max_len): prompts longer than the window, so prefill, extend and decode
# all cut it
SCHEDULER_CASES = {
    "default": (dict(), (0, (14, 23, 6), 0), 6, 2, 64),
    "prefill_chunk": (dict(prefill_chunk=8), (1, (21, 13), 0), 5, 2, 64),
    "paged_prefix": (dict(paged=True, page_size=16, prefix_cache=True,
                          prefill_chunk=8), (2, (5, 9), 32), 4, 2, 128),
    "multi_step": (dict(multi_step=3), (3, (15, 22, 7), 0), 7, 2, 64),
    "spec_linear": (dict(spec_k=3), (4, (16, 12), 0), 6, 2, 64),
    "int8": (dict(quantized_cache=True), (5, (17, 11, 24), 0), 5, 2, 64),
}


@pytest.mark.parametrize("case", sorted(SCHEDULER_CASES))
def test_scheduler_matches_jax_scheduler(both_params, case):
    """The windowed Scheduler gives the JAX Scheduler's tokens in each mode
    (over a page pool the decode takes no window, in both packages)."""
    jp, tp, jd, td = both_params
    kwargs, (seed, lens, n_base), max_new, max_batch, max_len = \
        SCHEDULER_CASES[case]
    base = _prompts(seed + 50, (n_base,))[0] if n_base else None
    prompts = _prompts(seed, lens, base=base)
    kw = dict(max_batch=max_batch, max_len=max_len, **kwargs)
    jkw, tkw = dict(kw), dict(kw)
    if case.startswith("spec"):
        jkw.update(draft_cfg=JDRAFT, draft_params=jd)
        tkw.update(draft_cfg=DRAFT, draft_params=td)
    jout = _run(JScheduler(JCFG, jp, interpret=True, **jkw), prompts, max_new)
    sched = Scheduler(CFG, tp, **tkw)
    out = _run(sched, prompts, max_new)
    assert out == jout, (case, out, jout)
    assert all(len(o) == max_new for o in out)
    if sched.paged:
        assert sched.prefix_hits == 1
        assert sched._pool.free_pages == sched._n_pages - 1
        assert not sched._page_refs and not sched._prefix_index
