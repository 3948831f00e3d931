"""The port's training steps over a mesh (parallel/train.py) on a gloo world
of 4 CPU ranks, in float32 at tests/test_train_parallel.py's config and
bounds, on the JAX package's parameters (params_from_jax) and tokens: the
DP x TP step (data 2 x model 2; JAX's test runs 2 x 4) against JAX's
make_train_step and the single-device step, the CP step (a 4-rank ring)
dense and on a 2-expert MoE config, the optimizer step with AdamW and
global-norm clipping against a single-device torch AdamW and JAX's
make_optax_train_step with optax.adamw, SGD with momentum, remat against no
remat, and losses falling. Updated parameters within atol 2e-5 of the
single-device SGD step: a constant factor on any leaf's gradient (lr * g
~1e-4) cannot hide there.

One world runs every scenario (a module fixture: spawning ranks costs
seconds); each scenario's failure is reported by its own test. The rank
function is module-level and this module imports JAX only inside functions,
so a rank imports no JAX."""

import functools

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
# tests/test_train_parallel.py:11-22, less the TPU tiles
CFG = dict(vocab_size=64, d_model=64, n_layers=2, n_heads=8, n_kv_heads=4,
           d_head=16, d_ff=128)
MOE = dict(CFG, moe_experts=2)
TP_AXES = {"data": 2, "model": 2}
ADAMW = dict(lr=1e-2, weight_decay=1e-4)  # optax.adamw(1e-2)'s decay
MOMENTUM = dict(lr=1e-1, momentum=0.9)


def _cfg(kw):
    return models.TransformerConfig(**kw, dtype=torch.float32)


def _jax_cfg(kw):
    import jax.numpy as jnp

    from flashattention_kernel_project_tpu import models as jmodels

    return jmodels.TransformerConfig(**kw, dtype=jnp.float32, block_q=32,
                                     block_k=32)


def _jax_setup(kw, pkey, tkey, shape):
    """JAX's params at PRNGKey(pkey) (a JAX tree, and as numpy) and tokens
    from PRNGKey(tkey), as tests/test_train_parallel.py draws them."""
    import jax

    from flashattention_kernel_project_tpu import models as jmodels

    jp = jmodels.init_params(_jax_cfg(kw), jax.random.PRNGKey(pkey))
    tokens = jax.random.randint(jax.random.PRNGKey(tkey), shape, 0,
                                kw["vocab_size"])
    return jp, jax.tree.map(np.asarray, jp), np.array(tokens, np.int32)


def _numpy_leaves(params) -> dict:
    return {k: x.detach().numpy() for k, x in tfm._leaves(params).items()}


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _tp_rank(mesh, kw, params_np, tokens, lr, steps, remat):
    """`steps` DP x TP SGD steps: (losses, the rank's leaves after the first
    step)."""
    step, rules = parallel.make_train_step(_cfg(kw), mesh, lr=lr, remat=remat)
    p = parallel.shard_params(params_from_jax(params_np, CPU), mesh, rules)
    toks = parallel.mesh.shard(torch.from_numpy(tokens), mesh, P("data", None))
    losses, first = [], None
    for _ in range(steps):
        p, loss = step(p, toks)
        losses.append(float(loss))
        first = first or _numpy_leaves(p)
    return losses, first


def _tp_remat_rank(mesh, kw, params_np, tokens, lr):
    return [_tp_rank(mesh, kw, params_np, tokens, lr, 1, remat)
            for remat in (False, True)]


def _cp_rank(mesh, kw, params_np, tokens, lr, steps):
    """`steps` CP SGD steps: (losses, the leaves after the first step)."""
    step, rules = parallel.make_cp_train_step(_cfg(kw), mesh, lr=lr)
    p = parallel.shard_params(params_from_jax(params_np, CPU), mesh, rules)
    losses, first = [], None
    for _ in range(steps):
        p, loss = step(p, torch.from_numpy(tokens))
        losses.append(float(loss))
        first = first or _numpy_leaves(p)
    return losses, first


def _optim_rank(mesh, kw, params_np, tokens, kind, clip, steps):
    """`steps` optimizer steps (AdamW or SGD with momentum) with clipping:
    (losses, the rank's leaves after the last step, opt_state_specs)."""
    cls, hyper = ((torch.optim.AdamW, ADAMW) if kind == "adamw"
                  else (torch.optim.SGD, MOMENTUM))
    params = params_from_jax(params_np, CPU)
    init, step, rules, sspecs = parallel.make_optax_train_step(
        _cfg(kw), mesh, functools.partial(cls, **hyper), params,
        clip_norm=clip)
    p = parallel.shard_params(params, mesh, rules)
    state = init(p)
    toks = parallel.mesh.shard(torch.from_numpy(tokens), mesh, P("data", None))
    losses = []
    for _ in range(steps):
        p, state, loss = step(p, state, toks)
        losses.append(float(loss))
    return losses, _numpy_leaves(p), sspecs


def _scenarios(inputs):
    tp, dec, cp, cp_dec, moe, adamw, mom, remat = inputs
    return {
        # tests/test_train_parallel.py:25, :48, :62, :80, :95, :135, :167
        "tp": (TP_AXES, _tp_rank, (CFG, tp[1], tp[2], 1e-2, 1, False)),
        "tp decreases": (TP_AXES, _tp_rank, (CFG, dec[1], dec[2], 5e-2, 4, False)),
        "cp": ({"sp": WORLD}, _cp_rank, (CFG, cp[1], cp[2], 1e-2, 1)),
        "cp decreases": ({"sp": WORLD}, _cp_rank,
                         (CFG, cp_dec[1], cp_dec[2], 1e-1, 4)),
        "cp moe": ({"sp": WORLD}, _cp_rank, (MOE, moe[1], moe[2], 1e-2, 1)),
        "adamw": (TP_AXES, _optim_rank, (CFG, adamw[1], adamw[2], "adamw", 1.0, 3)),
        "momentum": (TP_AXES, _optim_rank, (CFG, mom[1], mom[2], "sgd", 0.5, 3)),
        "remat": (TP_AXES, _tp_remat_rank, (CFG, remat[1], remat[2], 1e-2)),
        # the MoE branch: one expert a rank of the model axis
        "tp moe": (TP_AXES, _tp_remat_rank, (MOE, moe[1], moe[2], 1e-2)),
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
    inputs = (_jax_setup(CFG, 0, 1, (4, 32)), _jax_setup(CFG, 2, 3, (4, 32)),
              _jax_setup(CFG, 0, 2, (2, 64)), _jax_setup(CFG, 3, 4, (2, 64)),
              _jax_setup(MOE, 0, 2, (2, 64)), _jax_setup(CFG, 4, 5, (4, 32)),
              _jax_setup(CFG, 6, 7, (4, 32)), _jax_setup(CFG, 8, 9, (4, 32)))
    ranks = run_ranks(_world_rank, WORLD, _scenarios(inputs),
                      tmpdir=str(tmp_path_factory.mktemp("train_parallel")))
    return inputs, ranks


def _results(world, name):
    out = [r[name] for r in world[1]]
    for rank, res in enumerate(out):
        assert not isinstance(res, str), f"rank {rank}:\n{res}"
    return out


# ---------------------------------------------------------------------------
# references and comparisons
# ---------------------------------------------------------------------------

def _block(x, spec, axes, rank):
    """The block of the whole array x that `rank` holds under `spec` on a
    row-major mesh of `axes`."""
    coords = dict(zip(axes, np.unravel_index(rank, tuple(axes.values()))))
    for dim, axis in enumerate(spec or ()):
        if axis in axes:
            size = x.shape[dim] // axes[axis]
            x = np.take(x, range(coords[axis] * size, (coords[axis] + 1) * size),
                        axis=dim)
    return x


def _hold_leaves(ranks_leaves, whole, specs, axes, rtol, atol, what):
    """Every rank's leaves within (rtol, atol) of its blocks of `whole`
    ({name: array}), matched by name; the leaves each spec leaves whole
    bit-equal across the ranks."""
    for rank, leaves in enumerate(ranks_leaves):
        assert set(leaves) == set(whole), what
        for k, got in leaves.items():
            want = _block(whole[k], specs[k], axes, rank)
            np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                       err_msg=f"{what}: rank {rank}, {k}")
            if not any(a in axes for a in (specs[k] or ())):
                np.testing.assert_array_equal(got, ranks_leaves[0][k])


def _port_sgd(kw, params_np, tokens, lr):
    new, loss = models.sgd_train_step(_cfg(kw), params_from_jax(params_np, CPU),
                                      torch.from_numpy(tokens), lr=lr)
    return float(loss), _numpy_leaves(new)


def _jax_leaves(tree) -> dict:
    import jax

    return _numpy_leaves(params_from_jax(jax.tree.map(np.asarray, tree), CPU))


def _tp_specs(kw):
    return tfm._leaves(tfm.param_shardings(_cfg(kw)))


def _jax_mesh(axes):
    import jax

    from flashattention_kernel_project_tpu import parallel as jparallel

    return jparallel.make_mesh(axes, devices=jax.devices()[:WORLD])


def test_tp_dp_step_matches_single_device(world):
    """tests/test_train_parallel.py:25: one DP x TP step against JAX's
    make_train_step over 2 x 2 devices and the single-device SGD step (the
    port's and JAX's): loss rtol 1e-4, params rtol 2e-3, atol 2e-5."""
    import jax.numpy as jnp

    from flashattention_kernel_project_tpu import models as jmodels
    from flashattention_kernel_project_tpu import parallel as jparallel

    jp, params_np, tokens = world[0][0]
    runs = _results(world, "tp")
    specs = _tp_specs(CFG)
    jstep, jrules = jparallel.make_train_step(_jax_cfg(CFG), _jax_mesh(TP_AXES),
                                              lr=1e-2)
    jnew, jloss = jstep(jparallel.shard_params(jp, _jax_mesh(TP_AXES), jrules),
                        jnp.asarray(tokens))
    snew, sloss = jmodels.sgd_train_step(_jax_cfg(CFG), jp, jnp.asarray(tokens),
                                         lr=1e-2)
    ploss, pnew = _port_sgd(CFG, params_np, tokens, 1e-2)
    for loss, new, what in ((jloss, _jax_leaves(jnew), "JAX's TP step"),
                            (sloss, _jax_leaves(snew), "JAX's single-device step"),
                            (ploss, pnew, "the port's single-device step")):
        for losses, _ in runs:
            np.testing.assert_allclose(losses[0], float(loss), rtol=1e-4)
        _hold_leaves([r[1] for r in runs], new, specs, TP_AXES, 2e-3, 2e-5, what)


def test_tp_dp_loss_decreases(world):
    """:48: 4 steps at lr 5e-2, the loss the same on every rank."""
    runs = _results(world, "tp decreases")
    losses = runs[0][0]
    assert losses[-1] < losses[0]
    assert all(r[0] == losses for r in runs)


def test_cp_step_matches_single_device(world):
    """:62: one CP step (a 4-rank ring, the sequence of 64 in shards of 16)
    against JAX's make_cp_train_step and the single-device SGD step, at the
    same bounds; every leaf bit-equal on the ranks."""
    import jax.numpy as jnp

    from flashattention_kernel_project_tpu import parallel as jparallel

    jp, params_np, tokens = world[0][2]
    runs = _results(world, "cp")
    axes = {"sp": WORLD}
    specs = dict.fromkeys(_tp_specs(CFG), P())
    jstep, jrules = jparallel.make_cp_train_step(_jax_cfg(CFG), _jax_mesh(axes),
                                                 lr=1e-2)
    jnew, jloss = jstep(jparallel.shard_params(jp, _jax_mesh(axes), jrules),
                        jnp.asarray(tokens))
    ploss, pnew = _port_sgd(CFG, params_np, tokens, 1e-2)
    for loss, new, what in ((jloss, _jax_leaves(jnew), "JAX's CP step"),
                            (ploss, pnew, "the port's single-device step")):
        for losses, _ in runs:
            np.testing.assert_allclose(losses[0], float(loss), rtol=1e-4)
        _hold_leaves([r[1] for r in runs], new, specs, axes, 2e-3, 2e-5, what)


def test_cp_step_loss_decreases(world):
    """:80: 4 CP steps at lr 1e-1."""
    losses = _results(world, "cp decreases")[0][0]
    assert losses[-1] < losses[0]


def test_cp_step_moe(world):
    """The CP step on a 2-expert MoE config runs (its replicated specs do
    not go through param_shardings, whose MoE layout is expert-parallel):
    against JAX's make_cp_train_step on the same config (each slice routes
    its own tokens, in both), loss rtol 1e-4, params rtol 2e-3, atol 2e-5."""
    import jax.numpy as jnp

    from flashattention_kernel_project_tpu import parallel as jparallel

    jp, params_np, tokens = world[0][4]
    runs = _results(world, "cp moe")
    axes = {"sp": WORLD}
    jstep, jrules = jparallel.make_cp_train_step(_jax_cfg(MOE), _jax_mesh(axes),
                                                 lr=1e-2)
    jnew, jloss = jstep(jparallel.shard_params(jp, _jax_mesh(axes), jrules),
                        jnp.asarray(tokens))
    new = _jax_leaves(jnew)
    assert "layers.moe_w1" in new
    for losses, _ in runs:
        np.testing.assert_allclose(losses[0], float(jloss), rtol=1e-4)
    _hold_leaves([r[1] for r in runs], new, dict.fromkeys(new, P()), axes, 2e-3,
                 2e-5, "JAX's CP step on MoE")


def _single_optim(kw, params_np, tokens, kind, clip, steps):
    """The single-device reference: the port's loss_fn, the global norm
    clipped as optax.clip_by_global_norm does, then torch's optimizer."""
    cfg = _cfg(kw)
    flat = {k: x.clone().requires_grad_(True)
            for k, x in tfm._leaves(params_from_jax(params_np, CPU)).items()}
    cls, hyper = ((torch.optim.AdamW, ADAMW) if kind == "adamw"
                  else (torch.optim.SGD, MOMENTUM))
    opt = cls(list(flat.values()), **hyper)
    losses = []
    for _ in range(steps):
        opt.zero_grad()
        loss = models.loss_fn(cfg, tfm._unflatten(flat), torch.from_numpy(tokens))
        loss.backward()
        with torch.no_grad():
            norm = torch.sqrt(sum(x.grad.square().sum() for x in flat.values()))
            for x in flat.values():
                x.grad *= torch.clamp(clip / norm, max=1.0)
        opt.step()
        losses.append(loss.item())
    return losses, {k: x.detach().numpy() for k, x in flat.items()}


def _jax_optim(jp, tokens, opt, clip, steps):
    """JAX's make_optax_train_step over 2 x 2 devices with `opt`."""
    import jax.numpy as jnp

    from flashattention_kernel_project_tpu import parallel as jparallel

    mesh = _jax_mesh(TP_AXES)
    init, step, rules, _ = jparallel.make_optax_train_step(
        _jax_cfg(CFG), mesh, opt, jp, clip_norm=clip)
    p = jparallel.shard_params(jp, mesh, rules)
    s = init(p)
    losses = []
    for _ in range(steps):
        p, s, loss = step(p, s, jnp.asarray(tokens))
        losses.append(float(loss))
    return losses, _jax_leaves(p)


@pytest.mark.parametrize("kind", ["adamw", "momentum"])
def test_optimizer_step_matches_single_device(world, kind):
    """:95 and :135: 3 optimizer steps over data 2 x model 2 with global-norm
    clipping (AdamW at 1.0; SGD with momentum 0.9 at 0.5) against a
    single-device torch optimizer with the same clip and JAX's
    make_optax_train_step with optax.adamw / optax.sgd: every step's loss
    rtol 1e-4, the params atol 5e-4 (and rtol 2e-3 for the linear SGD)."""
    import optax

    jp, params_np, tokens = world[0][5 if kind == "adamw" else 6]
    runs = _results(world, kind)
    clip = 1.0 if kind == "adamw" else 0.5
    opt = (optax.adamw(ADAMW["lr"]) if kind == "adamw"
           else optax.sgd(MOMENTUM["lr"], momentum=MOMENTUM["momentum"]))
    rtol = 0 if kind == "adamw" else 2e-3
    specs = _tp_specs(CFG)
    for (losses, new), what in ((_single_optim(CFG, params_np, tokens, kind, clip, 3),
                                 "torch's optimizer on one device"),
                                (_jax_optim(jp, tokens, opt, clip, 3),
                                 "JAX's make_optax_train_step")):
        for got, _, _ in runs:
            np.testing.assert_allclose(got, losses, rtol=1e-4, err_msg=what)
        _hold_leaves([r[1] for r in runs], new, specs, TP_AXES, rtol, 5e-4, what)
    # the state's layout: parameter i's spec, in the order of the leaves
    names = list(tfm._leaves(params_from_jax(params_np, CPU)))
    assert runs[0][2] == {i: specs[k] for i, k in enumerate(names)}


def test_tp_remat_matches_no_remat(world):
    """:167: checkpointing each layer changes nothing but memory: loss rtol
    1e-6, params atol 1e-6."""
    for (la, pa), (lb, pb) in _results(world, "remat"):
        np.testing.assert_allclose(la, lb, rtol=1e-6)
        for k in pa:
            np.testing.assert_allclose(pa[k], pb[k], atol=1e-6, err_msg=k)


def test_tp_step_moe_raises(world):
    """The TP step's MoE branch runs (it raised before it was ported): the
    experts cut over the model axis, remat or not to 1e-6, the loss within
    JAX's 5e-3 of one device (each data shard routes its own tokens) and
    the replicated leaves bit-equal across the ranks. The JAX package is
    held to tightly in tests/test_torch_ep.py."""
    inputs = world[0]
    _, params_np, tokens = inputs[4]
    cfg = _cfg(MOE)
    _, want = models.sgd_train_step(cfg, params_from_jax(params_np, CPU),
                                    torch.from_numpy(tokens), lr=1e-2)
    specs = tfm._leaves(models.param_shardings(cfg))
    assert specs["layers.moe_w1"] == P(None, "model", None, None)
    runs = _results(world, "tp moe")
    for (la, pa), (lb, pb) in runs:
        np.testing.assert_allclose(la, lb, rtol=1e-6)
        np.testing.assert_allclose(la[0], float(want), rtol=5e-3)
        for k in pa:
            np.testing.assert_allclose(pa[k], pb[k], atol=1e-6, err_msg=k)
    for k, spec in specs.items():
        if not any(spec):
            for (_, p), _ in runs:
                np.testing.assert_array_equal(p[k], runs[0][0][1][k])


def test_tiling_knobs_dropped():
    with pytest.raises(TypeError):
        parallel.make_train_step(_cfg(CFG), None, interpret=True)
    with pytest.raises(TypeError):
        parallel.make_cp_train_step(_cfg(CFG), None,
                                    interpret=True)
