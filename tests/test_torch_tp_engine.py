"""The port's tensor- and sequence-parallel serving engine
(parallel/tp_engine.py) on gloo worlds of CPU ranks, against the JAX
package's single-device engine and its make_tp_engine, in float32: logits
within rel-L2 1e-4 and identical greedy tokens (tests/test_parallel.py's
bounds), the same on every rank.

One world of 4 ranks runs every scenario (a module fixture:
utils.testing.run_ranks; spawning ranks costs seconds), each scenario's
failure is reported by its own test. The rank functions are module-level
and this module imports JAX only inside functions, so a rank imports no
JAX."""

import dataclasses

import numpy as np
import pytest
import torch

from flashattention_kernel_project_tpu_torch import models, parallel
from flashattention_kernel_project_tpu_torch.models.convert import params_from_jax
from flashattention_kernel_project_tpu_torch.utils.sharding import P
from flashattention_kernel_project_tpu_torch.utils.testing import (
    assert_rel_l2,
    run_ranks,
)

CPU = torch.device("cpu")
TOL = 1e-4  # tests/test_parallel.py's engine bound, float32
# tests/test_parallel.py:273-276 (TP) and :394-397 (SP), less the TPU tiles
TP_CFG = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=8, n_kv_heads=4,
              d_head=16, d_ff=64)
SP_CFG = dict(TP_CFG, n_heads=4, n_kv_heads=2)


def _cfg(kw):
    return models.TransformerConfig(**kw, dtype=torch.float32)


def _jax_setup(kw, prompt_key, prompt_shape):
    """JAX's config, params at PRNGKey(0) and a prompt from PRNGKey(key),
    as tests/test_parallel.py draws them; the params also as numpy."""
    import jax
    import jax.numpy as jnp

    from flashattention_kernel_project_tpu import models as jmodels

    jcfg = jmodels.TransformerConfig(**kw, dtype=jnp.float32, block_q=16,
                                     block_k=16)
    jp = jmodels.init_params(jcfg, jax.random.PRNGKey(0))
    prompt = jax.random.randint(jax.random.PRNGKey(prompt_key), prompt_shape,
                                0, kw["vocab_size"])
    return jcfg, jp, jax.tree.map(np.asarray, jp), np.asarray(prompt, np.int32)


def _tp_rank(mesh, kw, params_np, prompt, chunk, nvec, quantized, steps):
    """prefill, a ragged extend and `steps` greedy decode steps through
    make_tp_engine over the mesh's "model" axis: each call's logits and the
    lengths."""
    cfg = _cfg(kw)
    prefill_fn, extend_fn, decode_fn, rules = parallel.make_tp_engine(
        cfg, mesh, n_splits=2)
    sparams = parallel.shard_params(params_from_jax(params_np, CPU), mesh, rules)
    cache = parallel.init_tp_cache(cfg, mesh, prompt.shape[0], 48,
                                   quantized=quantized)
    tp = parallel.axis_size(mesh, "model")
    assert cache.k[0].shape[1] == cfg.n_kv_heads // tp
    assert sparams["layers"]["w_down"].shape[1] == cfg.d_ff // tp
    out = []
    logits, cache = prefill_fn(sparams, torch.from_numpy(prompt), cache)
    out.append(logits.numpy())
    if chunk is not None:
        logits, cache = extend_fn(sparams, torch.from_numpy(chunk), cache,
                                  torch.from_numpy(nvec))
        out.append(logits.numpy())
    for _ in range(steps):
        cur = logits.argmax(-1).to(torch.int32)
        logits, cache = decode_fn(sparams, cur, cache)
        out.append(logits.numpy())
    return out, cache.lengths.numpy()


# name -> (mesh axes, rank function, its arguments' builder)
def _scenarios(jax_inputs):
    tp, tp_q, sp, sp_q = jax_inputs
    return {
        # tests/test_parallel.py:269, on a 4-rank model axis
        "tp": ({"model": 4}, _tp_rank,
               (TP_CFG, tp[2], tp[3], tp[4], tp[5], False, 3)),
        # :317, on a 2-rank model axis (data 2 x model 2)
        "tp_int8": ({"data": 2, "model": 2}, _tp_rank,
                    (TP_CFG, tp_q[2], tp_q[3], None, None, True, 1)),
        # :386 and :426, on a 4-rank seq axis
        "sp": ({"sp": 4}, _sp_rank, (SP_CFG, sp[2], sp[3], False, 4)),
        "sp_int8": ({"sp": 4}, _sp_rank, (SP_CFG, sp_q[2], sp_q[3], True, 3)),
    }


def _world_rank(rank, world, scenarios):
    """Every scenario on this rank: {name: result, or the traceback of its
    failure}."""
    import traceback

    out = {}
    for name, (axes, fn, args) in scenarios.items():
        try:
            out[name] = fn(parallel.make_mesh(axes, device_type="cpu"), *args)
        except Exception:  # reported by the scenario's own test
            out[name] = traceback.format_exc()
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    import jax

    tp = _jax_setup(TP_CFG, 1, (2, 12))
    chunk = np.asarray(jax.random.randint(jax.random.PRNGKey(2), (2, 4), 0, 64),
                       np.int32)
    inputs = (tp + (chunk, np.array([4, 2], np.int32)),
              _jax_setup(TP_CFG, 3, (2, 10)), _jax_setup(SP_CFG, 1, (2, 12)),
              _jax_setup(SP_CFG, 2, (2, 10)))
    ranks = run_ranks(_world_rank, 4, _scenarios(inputs),
                      tmpdir=str(tmp_path_factory.mktemp("tp_engine")))
    return inputs, ranks


def _results(world, name):
    """The scenario's result on every rank, failing on a rank's error."""
    out = [r[name] for r in world[1]]
    for rank, res in enumerate(out):
        assert not isinstance(res, str), f"rank {rank}:\n{res}"
    return out


def _jax_engine_logits(jcfg, jp, prompt, chunk, nvec, quantized, steps, fns=None):
    """The same calls through the JAX engine (or JAX's make_tp_engine's
    functions `fns` with their sharded params)."""
    import jax.numpy as jnp

    from flashattention_kernel_project_tpu import models as jmodels

    if fns is None:
        cache = jmodels.init_cache(jcfg, prompt.shape[0], 48, quantized=quantized)
        pre = lambda t, c: jmodels.prefill(jcfg, jp, t, c)  # noqa: E731
        ext = lambda t, c, n: jmodels.extend(jcfg, jp, t, c, n=n)  # noqa: E731
        dec = lambda t, c: jmodels.decode_step(jcfg, jp, t, c, n_splits=2)  # noqa: E731
    else:
        pre, ext, dec, cache = fns
    out = []
    logits, cache = pre(jnp.asarray(prompt), cache)
    out.append(np.asarray(logits))
    if chunk is not None:
        logits, cache = ext(jnp.asarray(chunk), cache, jnp.asarray(nvec))
        out.append(np.asarray(logits))
    for _ in range(steps):
        cur = jnp.argmax(logits, -1).astype(jnp.int32)
        logits, cache = dec(cur, cache)
        out.append(np.asarray(logits))
    return out, np.asarray(cache.lengths)


def _hold(ranks, ref, what):
    """Every rank's logits within TOL of the reference with the same greedy
    tokens, and bit-equal across the ranks; the same lengths."""
    for rank, (logits, lengths) in enumerate(ranks):
        np.testing.assert_array_equal(lengths, ref[1])
        for j, (got, want) in enumerate(zip(logits, ref[0])):
            assert_rel_l2(got, want, TOL, f"{what}: rank {rank}, call {j}")
            np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
            np.testing.assert_array_equal(got, ranks[0][0][j])


def test_tp_engine_matches_single_device(world):
    """tests/test_parallel.py:269: prefill, a ragged extend and 3 decode
    steps over a 4-rank model axis, against JAX's single-device engine and
    JAX's make_tp_engine over 4 devices."""
    import jax

    from flashattention_kernel_project_tpu import parallel as jparallel

    jcfg, jp, _, prompt, chunk, nvec = world[0][0]
    ranks = _results(world, "tp")
    ref = _jax_engine_logits(jcfg, jp, prompt, chunk, nvec, False, 3)
    _hold(ranks, ref, "vs the single-device engine")

    jmesh = jparallel.make_mesh({"model": 4}, devices=jax.devices()[:4])
    pf, ef, df, rules = jparallel.make_tp_engine(jcfg, jmesh, n_splits=2,
                                                 interpret=True)
    sp = jparallel.shard_params(jp, jmesh, rules)
    fns = (lambda t, c: pf(sp, t, c), lambda t, c, n: ef(sp, t, c, n),
           lambda t, c: df(sp, t, c), jparallel.init_tp_cache(jcfg, jmesh, 2, 48))
    jtp = _jax_engine_logits(jcfg, jp, prompt, chunk, nvec, False, 3, fns)
    _hold(ranks, jtp, "vs JAX's make_tp_engine")


def test_tp_engine_quantized_cache(world):
    """tests/test_parallel.py:317: the TP engine over an int8 cache cut over
    its KV heads, prefill and one decode step, on a 2-rank model axis."""
    jcfg, jp, _, prompt = world[0][1]
    ref = _jax_engine_logits(jcfg, jp, prompt, None, None, True, 1)
    _hold(_results(world, "tp_int8"), ref, "int8 cache")


def _sp_rank(mesh, kw, params_np, prompt, quantized, steps):
    """A single-device prefill whose cache is cut along its length over the
    mesh's "sp" axis, then `steps` SP decode steps (make_sp_decode_step),
    and the same again through make_sp_decode_steps from the same cache."""
    from flashattention_kernel_project_tpu_torch.models import engine

    cfg = _cfg(kw)
    params = params_from_jax(params_np, CPU)
    full = engine.init_cache(cfg, prompt.shape[0], 64, CPU, quantized=quantized)
    logits, full = engine.prefill(cfg, params, torch.from_numpy(prompt), full)
    spec = parallel.tp_engine.sp_cache_specs(cfg.n_layers, quantized=quantized)
    cache = parallel.init_sp_cache(cfg, mesh, prompt.shape[0], 64,
                                   quantized=quantized)
    for name in ("k", "v", "k_scale", "v_scale"):
        for dst, src, s in zip(getattr(cache, name) or [],
                               getattr(full, name) or [], getattr(spec, name) or []):
            dst.copy_(parallel.mesh.shard(src, mesh, s))
    cache.lengths.copy_(full.lengths)
    snapshot = [t.clone() for t in cache.k + cache.v + (cache.k_scale or [])
                + (cache.v_scale or [])] + [cache.lengths.clone()]
    dec = parallel.make_sp_decode_step(cfg, mesh, n_splits=2)
    out = [logits.numpy()]
    cur = logits.argmax(-1).to(torch.int32)
    first = cur.clone()
    for _ in range(steps):
        logits, cache = dec(params, cur, cache)
        out.append(logits.numpy())
        cur = logits.argmax(-1).to(torch.int32)
    lengths = cache.lengths.numpy().copy()
    # the window from the prefilled state gives the single steps' tokens
    for t, saved in zip(cache.k + cache.v + (cache.k_scale or [])
                        + (cache.v_scale or []) + [cache.lengths], snapshot):
        t.copy_(saved)
    steps_fn = parallel.tp_engine.make_sp_decode_steps(
        cfg, mesh, n_steps=steps, n_splits=2)
    toks, _ = steps_fn(params, first, cache)
    return (out, lengths), toks.numpy()


def _jax_sp_reference(jcfg, jp, prompt, quantized, steps):
    import jax.numpy as jnp

    from flashattention_kernel_project_tpu import models as jmodels

    cache = jmodels.init_cache(jcfg, prompt.shape[0], 64, quantized=quantized)
    logits, cache = jmodels.prefill(jcfg, jp, jnp.asarray(prompt), cache)
    out = [np.asarray(logits)]
    for _ in range(steps):
        cur = jnp.argmax(logits, -1).astype(jnp.int32)
        logits, cache = jmodels.decode_step(jcfg, jp, cur, cache, n_splits=2)
        out.append(np.asarray(logits))
    return out, np.asarray(cache.lengths)


@pytest.mark.parametrize("quantized", [False, True])
def test_sp_decode_engine_matches_single_device(world, quantized):
    """tests/test_parallel.py:386 and :426: the decode step over a cache cut
    along its length on 4 ranks (a new row written only by the rank that
    holds its position, partials gathered and merged), the bf16 layout in
    float32 and int8, against JAX's single-device decode; the multi-step
    window gives the single steps' greedy tokens."""
    steps = 3 if quantized else 4
    jcfg, jp, _, prompt = world[0][3 if quantized else 2]
    ranks = _results(world, "sp_int8" if quantized else "sp")
    ref = _jax_sp_reference(jcfg, jp, prompt, quantized, steps)
    _hold([r[0] for r in ranks], ref, "SP")
    for _, window in ranks:
        np.testing.assert_array_equal(window, _window_tokens(ref[0], steps))


def _window_tokens(logits, steps):
    """The greedy tokens a window of `steps` steps emits from the prefill's
    logits: the argmax after each step."""
    return np.stack([lg.argmax(-1) for lg in logits[1:steps + 1]], axis=1)


def test_param_shardings_are_jax_specs():
    """The port's param_shardings gives JAX's specs entry for entry (the
    engine tests shard by them), dense and MoE (the experts on the model
    axis, the router whole: JAX's transformer.py:137-144)."""
    from jax.sharding import PartitionSpec

    from flashattention_kernel_project_tpu.models import transformer as jtfm

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            return {k2: v2 for k, v in tree.items()
                    for k2, v2 in flat(v, f"{prefix}{k}.").items()}
        return {prefix[:-1]: tuple(tree)}

    cfg = _cfg(TP_CFG)
    jcfg, _, _, _ = _jax_setup(TP_CFG, 1, (1, 1))
    for moe in (0, 4):
        ours = models.param_shardings(dataclasses.replace(cfg, moe_experts=moe))
        theirs = jtfm.param_shardings(dataclasses.replace(jcfg, moe_experts=moe))
        assert flat(ours) == flat(theirs)
        assert list(ours["layers"]) == list(theirs["layers"])
        assert isinstance(ours["layers"]["wq"], P)
        assert isinstance(theirs["layers"]["wq"], PartitionSpec)
    assert ours["layers"]["moe_w1"] == P(None, "model", None, None)
    assert ours["layers"]["moe_router"] == P(None, None, None)


def test_local_config_divides_heads_and_width():
    cfg = _cfg(TP_CFG)
    lcfg = parallel.local_config(cfg, 4)
    assert (lcfg.n_heads, lcfg.n_kv_heads, lcfg.d_ff) == (2, 1, 16)
    assert lcfg.d_model == cfg.d_model and lcfg.d_head == cfg.d_head
    for tp in (3, 8):
        with pytest.raises(ValueError, match="divisible"):
            parallel.local_config(cfg, tp)
    # an MoE config divides its heads and d_ff too, as JAX's does
    from flashattention_kernel_project_tpu.parallel import tp_engine as jtp

    moe = dataclasses.replace(cfg, moe_experts=4)
    jcfg, _, _, _ = _jax_setup(TP_CFG, 1, (1, 1))
    theirs = jtp.local_config(dataclasses.replace(jcfg, moe_experts=4), 2)
    ours = parallel.local_config(moe, 2)
    assert ((ours.n_heads, ours.n_kv_heads, ours.d_ff, ours.moe_experts)
            == (theirs.n_heads, theirs.n_kv_heads, theirs.d_ff,
                theirs.moe_experts) == (4, 2, 32, 4))
