"""The port's GPipe pipeline (parallel/pipeline.py) on a gloo world of 4 CPU
ranks (4 stages of one layer), in float32 at tests/test_pipeline.py's config
and bounds, on the JAX package's parameters (params_from_jax) and tokens:
the pipeline's loss against the single-device loss and JAX's pp_loss_fn
(rtol 2e-5), one step against the single-device SGD step and JAX's
make_pp_train_step (params within atol 2e-5: no factor on any gradient),
losses falling, remat against no remat, an MoE slab's loss against JAX's,
and the MoE tree that pp_param_specs (dense keys only, as JAX's) refuses.

One world runs every scenario (a module fixture: spawning ranks costs
seconds); each scenario's failure is reported by its own test. The rank
function is module-level and this module imports JAX only inside functions,
so a rank imports no JAX."""

import numpy as np
import pytest
import torch

from flashattention_kernel_project_tpu_torch import models, parallel
from flashattention_kernel_project_tpu_torch.models import transformer as tfm
from flashattention_kernel_project_tpu_torch.models.convert import params_from_jax
from flashattention_kernel_project_tpu_torch.utils.sharding import P
from flashattention_kernel_project_tpu_torch.utils.testing import run_ranks

WORLD = 4
CPU = torch.device("cpu")
AXES = {"pipe": WORLD}
# tests/test_pipeline.py:15-18, less the TPU tiles
CFG = dict(vocab_size=64, d_model=32, n_layers=4, n_heads=4, n_kv_heads=2,
           d_head=8, d_ff=64)
MOE = dict(CFG, moe_experts=2)


def _cfg(kw):
    return models.TransformerConfig(**kw, dtype=torch.float32)


def _jax_cfg(kw):
    import jax.numpy as jnp

    from flashattention_kernel_project_tpu import models as jmodels

    return jmodels.TransformerConfig(**kw, dtype=jnp.float32, block_q=16,
                                     block_k=16)


def _jax_setup(kw, tkey):
    """JAX's params at PRNGKey(0) (a JAX tree, and as numpy) and tokens
    [4, 32] from PRNGKey(tkey), as tests/test_pipeline.py draws them."""
    import jax

    from flashattention_kernel_project_tpu import models as jmodels

    jp = jmodels.init_params(_jax_cfg(kw), jax.random.PRNGKey(0))
    tokens = jax.random.randint(jax.random.PRNGKey(tkey), (4, 32), 0,
                                kw["vocab_size"])
    return jp, jax.tree.map(np.asarray, jp), np.array(tokens, np.int32)


def _moe_specs():
    """pp_param_specs' layout for an MoE tree (JAX's specs list the dense
    keys only): every layer leaf cut over the pipe axis."""
    layers = ("rms_attn", "rms_mlp", "wq", "wk", "wv", "wo", "moe_router",
              "moe_w1", "moe_w2")
    return {"embed": P(), "rms_final": P(),
            "layers": {k: P("pipe") for k in layers}}


def _numpy_leaves(params) -> dict:
    return {k: x.detach().numpy() for k, x in tfm._leaves(params).items()}


def _jax_leaves(tree) -> dict:
    import jax

    return _numpy_leaves(params_from_jax(jax.tree.map(np.asarray, tree), CPU))


def _loss_rank(mesh, kw, params_np, tokens, specs):
    params = params_from_jax(params_np, CPU)
    local = parallel.shard_params(params, mesh, specs or parallel.pp_param_specs())
    return float(parallel.pp_loss_fn(_cfg(kw), local, torch.from_numpy(tokens),
                                     mesh=mesh, n_micro=2, remat=False))


def _step_rank(mesh, kw, params_np, tokens, lr, steps, remat):
    """`steps` pipeline steps: (losses, the stage's leaves after the first)."""
    step, specs = parallel.make_pp_train_step(_cfg(kw), mesh, n_micro=2, lr=lr,
                                              remat=remat)
    p = parallel.shard_params(params_from_jax(params_np, CPU), mesh, specs)
    losses, first = [], None
    for _ in range(steps):
        p, loss = step(p, torch.from_numpy(tokens))
        losses.append(float(loss))
        first = first or _numpy_leaves(p)
    return losses, first


def _moe_refused_rank(mesh, kw, params_np, tokens):
    """What the pipeline makes of an MoE tree: the step builds, then
    shard_params by its specs and the step on the tree each raise (the
    exception's type name), as JAX's shard_params and shard_map do."""
    step, specs = parallel.make_pp_train_step(_cfg(kw), mesh, n_micro=2)
    params = params_from_jax(params_np, CPU)
    out = []
    for call in (lambda: parallel.shard_params(params, mesh, specs),
                 lambda: step(parallel.shard_params(params, mesh, _moe_specs()),
                              torch.from_numpy(tokens))):
        try:
            call()
            out.append(None)
        except Exception as e:  # the test reads which exception it was
            out.append(type(e).__name__)
    return out


def _uneven_rank(mesh):
    try:
        parallel.make_pp_train_step(_cfg(dict(CFG, n_layers=6)), mesh)
    except ValueError as e:
        return type(e).__name__
    return None


def _scenarios(inputs):
    loss, dec, match, moe = inputs
    return {
        # tests/test_pipeline.py:21, :43, :56
        "loss": (_loss_rank, (CFG, loss[1], loss[2], None)),
        "decreases": (_step_rank, (CFG, dec[1], dec[2], 0.1, 4, True)),
        "step": (_step_rank, (CFG, match[1], match[2], 1e-2, 1, False)),
        "step remat": (_step_rank, (CFG, match[1], match[2], 1e-2, 1, True)),
        "moe loss": (_loss_rank, (MOE, moe[1], moe[2], _moe_specs())),
        "moe refused": (_moe_refused_rank, (MOE, moe[1], moe[2])),
        "uneven": (_uneven_rank, ()),
    }


def _world_rank(rank, world, scenarios):
    """Every scenario on this rank: {name: result, or the traceback of its
    failure}."""
    import traceback

    out = {}
    for name, (fn, args) in scenarios.items():
        try:
            out[name] = fn(parallel.make_mesh(AXES, device_type="cpu"), *args)
        except Exception:  # reported by the scenario's own test
            out[name] = traceback.format_exc()
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    inputs = (_jax_setup(CFG, 1), _jax_setup(CFG, 2), _jax_setup(CFG, 3),
              _jax_setup(MOE, 1))
    ranks = run_ranks(_world_rank, WORLD, _scenarios(inputs),
                      tmpdir=str(tmp_path_factory.mktemp("pipeline")))
    return inputs, ranks


def _results(world, name):
    out = [r[name] for r in world[1]]
    for rank, res in enumerate(out):
        assert not isinstance(res, str) or name == "uneven", f"rank {rank}:\n{res}"
    return out


def _jax_pp_loss(kw, jp, tokens, specs):
    """JAX's pp_loss_fn under shard_map over 4 devices, as
    tests/test_pipeline.py:28-38 calls it."""
    import functools

    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as JP

    from flashattention_kernel_project_tpu import parallel as jparallel

    mesh = jparallel.make_mesh(AXES, devices=jax.devices()[:WORLD])
    jspecs = jax.tree.map(lambda s: JP(*s), specs,
                          is_leaf=lambda s: isinstance(s, P))
    fn = jax.jit(shard_map(
        functools.partial(jparallel.pp_loss_fn, _jax_cfg(kw), n_micro=2,
                          interpret=True, remat=False),
        mesh=mesh, in_specs=(jspecs, JP()), out_specs=JP(), check_vma=False))
    return float(fn(jp, jnp.asarray(tokens)))


def test_pp_loss_matches_reference(world):
    """tests/test_pipeline.py:21: the pipeline's loss (2 microbatches, 4
    stages) against the single-device loss (the port's and JAX's) and JAX's
    pp_loss_fn, rtol 2e-5, the same on every stage."""
    import jax.numpy as jnp

    from flashattention_kernel_project_tpu import models as jmodels

    jp, params_np, tokens = world[0][0]
    got = _results(world, "loss")
    assert all(g == got[0] for g in got)
    ref = models.loss_fn(_cfg(CFG), params_from_jax(params_np, CPU),
                         torch.from_numpy(tokens))
    jref = jmodels.loss_fn(_jax_cfg(CFG), jp, jnp.asarray(tokens), interpret=True)
    jpp = _jax_pp_loss(CFG, jp, tokens, parallel.pp_param_specs())
    for want in (float(ref), float(jref), jpp):
        np.testing.assert_allclose(got[0], want, rtol=2e-5)


def test_pp_train_step_decreases_loss(world):
    """:43: 4 steps at lr 0.1 with remat, the loss finite and falling."""
    losses = _results(world, "decreases")[0][0]
    assert np.isfinite(losses[0]) and losses[-1] < losses[0]


def test_pp_train_step_matches_single_device(world):
    """:56: one pipeline step against the single-device SGD step (the port's
    and JAX's) and JAX's make_pp_train_step: loss rtol 1e-4, params rtol
    2e-3, atol 2e-5 (the embedding and final norm, summed over the stages,
    bit-equal on every stage)."""
    import jax
    import jax.numpy as jnp

    from flashattention_kernel_project_tpu import models as jmodels
    from flashattention_kernel_project_tpu import parallel as jparallel

    jp, params_np, tokens = world[0][2]
    runs = _results(world, "step")
    mesh = jparallel.make_mesh(AXES, devices=jax.devices()[:WORLD])
    jstep, jspecs = jparallel.make_pp_train_step(
        _jax_cfg(CFG), mesh, n_micro=2, lr=1e-2, interpret=True, remat=False)
    jnew, jloss = jstep(jparallel.shard_params(jp, mesh, jspecs),
                        jnp.asarray(tokens))
    snew, sloss = jmodels.sgd_train_step(_jax_cfg(CFG), jp, jnp.asarray(tokens),
                                         lr=1e-2, interpret=True)
    pnew, ploss = models.sgd_train_step(_cfg(CFG), params_from_jax(params_np, CPU),
                                        torch.from_numpy(tokens), lr=1e-2)
    specs = tfm._leaves(parallel.pp_param_specs())
    for loss, whole in ((jloss, _jax_leaves(jnew)), (sloss, _jax_leaves(snew)),
                        (ploss, _numpy_leaves(pnew))):
        for stage, (losses, leaves) in enumerate(runs):
            np.testing.assert_allclose(losses[0], float(loss), rtol=1e-4)
            for k, got in leaves.items():
                want = np.split(whole[k], WORLD)[stage] if specs[k] else whole[k]
                np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-5,
                                           err_msg=f"stage {stage}, {k}")
                if not specs[k]:
                    np.testing.assert_array_equal(got, runs[0][1][k])


def test_pp_remat_matches_no_remat(world):
    """Checkpointing each layer of the slab changes nothing but memory:
    loss rtol 1e-6, params atol 1e-6."""
    for (la, pa), (lb, pb) in zip(_results(world, "step"),
                                  _results(world, "step remat")):
        np.testing.assert_allclose(la, lb, rtol=1e-6)
        for k in pa:
            np.testing.assert_allclose(pa[k], pb[k], atol=1e-6, err_msg=k)


def test_pp_loss_moe(world):
    """JAX's pp_loss_fn takes an MoE slab (each microbatch routes its own
    tokens, bubble ticks kept out of the aux): the port's against JAX's
    under the same specs, rtol 2e-5."""
    jp, _, tokens = world[0][3]
    got = _results(world, "moe loss")
    assert all(g == got[0] for g in got)
    np.testing.assert_allclose(got[0], _jax_pp_loss(MOE, jp, tokens, _moe_specs()),
                               rtol=2e-5)


def test_pp_step_refuses_moe(world):
    """pp_param_specs lists the dense keys only, as JAX's: on an MoE tree
    make_pp_train_step builds, and shard_params by its specs and the step
    raise ValueError, as JAX's shard_params and shard_map do."""
    for res in _results(world, "moe refused"):
        assert res == ["ValueError", "ValueError"], res


def test_pp_layers_must_divide(world):
    """JAX asserts n_layers % n_stages == 0: ValueError here (6 layers over
    4 stages), before any collective."""
    for res in _results(world, "uneven"):
        assert res == "ValueError", res
