"""Expert parallelism in the port on a gloo world of 4 CPU ranks, held to the
JAX package on 4 host devices with the same seeded numpy inputs, in float32:
make_ep_moe (tests/test_moe.py:90, :99, :111, :208) in its dense, sort and
auto forms over {"expert": 4} and {"data": 2, "expert": 2}, with its
gradients; the MoE branch of the DP x TP SGD step (:160, :175) and of the
torch.optim step with clipping; and Scheduler(seq_mesh=) over an MoE model
against JAX's Scheduler(seq_mesh=), token for token.

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
from flashattention_kernel_project_tpu_torch.utils.testing import rel_l2, run_ranks

WORLD = 4
CPU = torch.device("cpu")
EP_TOL = 1e-5     # tests/test_moe.py:96, the EP output against one device
SORT_TOL = 1e-6   # :208, the sort dispatch against the dense one
# tests/test_moe.py:17 and its tight-capacity config (:193)
MOE = dict(d_model=32, d_ff=64, num_experts=8, top_k=2, capacity_factor=2.0)
TIGHT = dict(MOE, capacity_factor=0.5)
# :130, less the TPU tiles
TFM = dict(vocab_size=64, d_model=64, n_layers=2, n_heads=8, n_kv_heads=8,
           d_head=16, d_ff=128, moe_experts=8, moe_top_k=2)
# tests/test_serving.py:12's config with 4 experts
SERVE = dict(vocab_size=64, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
             d_head=16, d_ff=128, moe_experts=4)
ADAMW = dict(lr=1e-2, weight_decay=1e-4)  # optax.adamw(1e-2)'s decay


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 64, size=n).astype(np.int32) for n in lens]


# name -> (mesh axes, make_ep_moe's options, the MoE config, x)
EP = {
    "dense": ({"expert": 4}, dict(dispatch="dense"), MOE, _x(0, (2, 16, 32))),
    "sort": ({"expert": 4}, dict(dispatch="sort"), MOE, _x(1, (2, 40, 32))),
    "sort tight": ({"expert": 4}, dict(dispatch="sort"), TIGHT,
                   _x(2, (2, 40, 32))),
    # 2048 tokens: "auto" takes the sort form (the dense pair passes 64 MB)
    "auto": ({"expert": 4}, dict(dispatch="auto"), MOE, _x(3, (1, 2048, 32))),
    "data dense": ({"data": 2, "expert": 2},
                   dict(dispatch="dense", data_axis="data", return_aux=True),
                   MOE, _x(4, (4, 8, 32))),
    "data sort": ({"data": 2, "expert": 2},
                  dict(dispatch="sort", data_axis="data", return_aux=True),
                  MOE, _x(5, (4, 8, 32))),
}
GRADS = ("dense", "sort")  # the scenarios that also differentiate mean(y^2)
# name -> (mesh axes, the step: "sgd" or "adamw", steps)
TP = {
    "tp 1x4": ({"data": 1, "model": 4}, "sgd", 1),
    "tp 2x2": ({"data": 2, "model": 2}, "sgd", 1),
    "adamw 2x2": ({"data": 2, "model": 2}, "adamw", 3),
}
# name -> (Scheduler options, prompts, max_new)
SP = {
    "sp": (dict(max_len=64), _prompts(14, (6, 11, 4)), 4),
    "sp int8": (dict(max_len=64, quantized_cache=True), _prompts(7, (6, 11, 4)), 5),
    "sp multi_step": (dict(max_len=64, multi_step=4), _prompts(37, (6, 11, 4)), 7),
}


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _ep_rank(mesh, opts, kw, params_np, x, grads):
    """make_ep_moe on this rank's shards: (output, aux or None, the
    gradients of mean(y^2) by leaf and for x, or None)."""
    cfg = models.MoEConfig(**kw)
    fn = models.make_ep_moe(mesh, cfg, **opts)
    params = {k: torch.from_numpy(v) for k, v in params_np.items()}
    p = parallel.shard_params(params, mesh, models.moe_param_shardings(cfg))
    xs = torch.from_numpy(x)
    if opts.get("data_axis"):
        xs = parallel.mesh.shard(xs, mesh, P(opts["data_axis"]))
    if grads:
        p = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        xs = xs.clone().requires_grad_(True)
    out = fn(p, xs)
    out, aux = out if opts.get("return_aux") else (out, None)
    g = None
    if grads:
        (out * out).mean().backward()
        g = {k: v.grad.numpy() for k, v in p.items()}
        g["x"] = xs.grad.numpy()
    return (out.detach().numpy(), None if aux is None else float(aux), g)


def _indivisible_rank(mesh):
    """make_ep_moe with 6 experts over 4 ranks: ValueError's message."""
    try:
        models.make_ep_moe(mesh, models.MoEConfig(**dict(MOE, num_experts=6)))
    except ValueError as e:
        return str(e)
    return None


def _numpy_leaves(params) -> dict:
    return {k: x.detach().numpy() for k, x in tfm._leaves(params).items()}


def _tp_rank(mesh, params_np, tokens, kind, steps):
    """`steps` DP x TP steps of the MoE decoder, SGD at lr 1e-2 or AdamW
    with clip_norm 1.0: (losses, the rank's leaves after the last step)."""
    cfg = models.TransformerConfig(**TFM, dtype=torch.float32)
    params = params_from_jax(params_np, CPU)
    toks = parallel.mesh.shard(torch.from_numpy(tokens), mesh, P("data", None))
    losses = []
    if kind == "sgd":
        step, rules = parallel.make_train_step(cfg, mesh, lr=1e-2)
        p = parallel.shard_params(params, mesh, rules)
        for _ in range(steps):
            p, loss = step(p, toks)
            losses.append(float(loss))
        return losses, _numpy_leaves(p)
    init, step, rules, _ = parallel.make_optax_train_step(
        cfg, mesh, functools.partial(torch.optim.AdamW, **ADAMW), params,
        clip_norm=1.0)
    p = parallel.shard_params(params, mesh, rules)
    state = init(p)
    for _ in range(steps):
        p, state, loss = step(p, state, toks)
        losses.append(float(loss))
    return losses, _numpy_leaves(p)


def _sp_rank(mesh, params_np, kw, prompts, max_new):
    """Scheduler(seq_mesh=) over the MoE model: the tokens of the prompts,
    in submission order."""
    from flashattention_kernel_project_tpu_torch.models.serving import Scheduler

    cfg = models.TransformerConfig(**SERVE, dtype=torch.float32)
    sched = Scheduler(cfg, params_from_jax(params_np, CPU), max_batch=2,
                      seq_mesh=mesh, **kw)
    uids = [sched.submit(p, max_new_tokens=max_new) for p in prompts]
    res = sched.run()
    return [res[u] for u in uids]


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


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.numpy()


def _moe_params(kw):
    """moe_ffn's parameters from seed 0, as numpy (both packages take
    them)."""
    return _numpy(models.init_moe_params(
        models.MoEConfig(**kw), torch.Generator().manual_seed(0), CPU))


def _decoder_params(kw, seed):
    return _numpy(models.init_params(
        models.TransformerConfig(**kw, dtype=torch.float32),
        torch.Generator().manual_seed(seed), CPU))


def _jax_tree(tree):
    import jax
    import jax.numpy as jnp

    return jax.tree.map(jnp.asarray, tree)


def _jax_cfg(kw):
    import jax.numpy as jnp

    from flashattention_kernel_project_tpu import models as jmodels

    return jmodels.TransformerConfig(**kw, dtype=jnp.float32, block_q=16,
                                     block_k=16)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    moe_np = {kw["capacity_factor"]: _moe_params(kw) for kw in (MOE, TIGHT)}
    tfm_np, serve_np = _decoder_params(TFM, 0), _decoder_params(SERVE, 1)
    tokens = np.random.default_rng(1).integers(0, 64, (4, 32)).astype(np.int32)
    scenarios = {f"ep {name}": (axes, _ep_rank,
                                (opts, kw, moe_np[kw["capacity_factor"]], x,
                                 name in GRADS))
                 for name, (axes, opts, kw, x) in EP.items()}
    scenarios["ep indivisible"] = ({"expert": 4}, _indivisible_rank, ())
    scenarios.update({name: (axes, _tp_rank, (tfm_np, tokens, kind, steps))
                      for name, (axes, kind, steps) in TP.items()})
    scenarios.update({name: ({"sp": WORLD}, _sp_rank, (serve_np, kw, prompts, n))
                      for name, (kw, prompts, n) in SP.items()})
    ranks = run_ranks(_world_rank, WORLD, scenarios,
                      tmpdir=str(tmp_path_factory.mktemp("ep")), timeout=240.0)
    return dict(moe=moe_np, jtfm=_jax_tree(tfm_np), jserve=_jax_tree(serve_np),
                tokens=tokens), ranks


def _results(world, name):
    out = [r[name] for r in world[1]]
    for rank, res in enumerate(out):
        assert not (isinstance(res, str) and "Traceback" in res), \
            f"rank {rank}:\n{res}"
    return out


def _jax_mesh(axes):
    import jax

    from flashattention_kernel_project_tpu import parallel as jparallel

    return jparallel.make_mesh(axes, devices=jax.devices()[:WORLD])


def _coords(axes, rank):
    return dict(zip(axes, np.unravel_index(rank, tuple(axes.values()))))


def _block(x, spec, axes, rank):
    """The block of the whole array x that `rank` holds under `spec` on a
    row-major mesh of `axes`."""
    coords = _coords(axes, rank)
    for dim, axis in enumerate(spec or ()):
        if axis in axes:
            size = x.shape[dim] // axes[axis]
            x = np.take(x, range(coords[axis] * size, (coords[axis] + 1) * size),
                        axis=dim)
    return x


# ---------------------------------------------------------------------------
# make_ep_moe
# ---------------------------------------------------------------------------

def _jax_ep(name, params_np, grads):
    """JAX's make_ep_moe on the scenario's mesh: (output, aux or None, the
    gradients of mean(y^2) by leaf and for x, or None)."""
    import jax
    import jax.numpy as jnp

    from flashattention_kernel_project_tpu import models as jmodels

    axes, opts, kw, x = EP[name]
    fn = jmodels.make_ep_moe(_jax_mesh(axes), jmodels.MoEConfig(**kw), **opts)
    jp = {k: jnp.asarray(v) for k, v in params_np.items()}
    out = fn(jp, jnp.asarray(x))
    out, aux = out if opts.get("return_aux") else (out, None)
    g = None
    if grads:
        def loss(p, x):
            y = fn(p, x)
            return jnp.mean(y * y)

        gp, gx = jax.grad(loss, argnums=(0, 1))(jp, jnp.asarray(x))
        g = {k: np.asarray(v) for k, v in gp.items()}
        g["x"] = np.asarray(gx)
    return np.asarray(out), None if aux is None else float(aux), g


@pytest.mark.parametrize("name", list(EP))
def test_ep_moe_matches_jax(world, name):
    """Each form and mesh: every rank's output within EP_TOL (rel-L2) of
    JAX's make_ep_moe on the same mesh and of moe_ffn on one device (each
    data shard on its own rows, :99), bit-equal on the ranks of an expert
    axis; with a data axis the aux loss within 1e-5 of JAX's (pmean'd)."""
    axes, opts, kw, x = EP[name]
    params_np = world[0]["moe"][kw["capacity_factor"]]
    runs = _results(world, f"ep {name}")
    want, want_aux, _ = _jax_ep(name, params_np, grads=False)
    cfg = models.MoEConfig(**kw)
    torch_p = {k: torch.from_numpy(v) for k, v in params_np.items()}
    data = opts.get("data_axis")
    n_data = axes.get("data", 1)
    rows = x.shape[0] // n_data
    for rank, (out, aux, _) in enumerate(runs):
        part = _coords(axes, rank).get("data", 0)
        sl = slice(part * rows, (part + 1) * rows) if data else slice(None)
        assert out.shape == x[sl].shape
        assert rel_l2(out, want[sl]) <= EP_TOL, (rank, rel_l2(out, want[sl]))
        one = models.moe_ffn(torch_p, torch.from_numpy(x[sl]), cfg,
                             dispatch=opts["dispatch"]).numpy()
        assert rel_l2(out, one) <= EP_TOL, (rank, rel_l2(out, one))
        if aux is not None:
            np.testing.assert_allclose(aux, want_aux, rtol=1e-5)
        # the ranks of this rank's expert axis hold the same bits
        same = [r for r in range(WORLD)
                if _coords(axes, r).get("data", 0) == part]
        np.testing.assert_array_equal(out, runs[same[0]][0])


@pytest.mark.parametrize("name", ["sort", "sort tight", "auto"])
def test_ep_sort_matches_dense(world, name):
    """:208: the EP sort form (also "auto" at 2048 tokens, which takes it)
    equals the dense dispatch on one device to SORT_TOL (rtol and atol), the
    same routing and drops."""
    _, _, kw, x = EP[name]
    params_np = world[0]["moe"][kw["capacity_factor"]]
    torch_p = {k: torch.from_numpy(v) for k, v in params_np.items()}
    dense = models.moe_ffn(torch_p, torch.from_numpy(x), models.MoEConfig(**kw),
                           dispatch="dense").numpy()
    for out, _, _ in _results(world, f"ep {name}"):
        np.testing.assert_allclose(out, dense, rtol=SORT_TOL, atol=SORT_TOL)


@pytest.mark.parametrize("name", GRADS)
def test_ep_grads_match_jax(world, name):
    """The gradients of mean(y^2) through make_ep_moe against JAX's through
    its make_ep_moe (which equal one device's): each rank's w1 and w2
    gradients its block of JAX's, w_gate's and x's whole, each within
    EP_TOL rel-L2 and bit-equal on every rank; no factor of the axis size,
    no partial sum."""
    axes, _, kw, _ = EP[name]
    params_np = world[0]["moe"][kw["capacity_factor"]]
    _, _, want = _jax_ep(name, params_np, grads=True)
    specs = dict(models.moe_param_shardings(models.MoEConfig(**kw)), x=P())
    runs = _results(world, f"ep {name}")
    for rank, (_, _, g) in enumerate(runs):
        assert set(g) == set(want)
        for k, got in g.items():
            block = _block(want[k], specs[k], axes, rank)
            assert rel_l2(got, block) <= EP_TOL, (rank, k, rel_l2(got, block))
            if not any(specs[k]):
                np.testing.assert_array_equal(got, runs[0][2][k])


def test_ep_indivisible_raises(world):
    """JAX asserts that the experts divide over the axis; the port raises
    ValueError."""
    for msg in _results(world, "ep indivisible"):
        assert msg is not None and "do not divide" in msg


def test_moe_param_shardings_are_jax_specs():
    """moe_param_shardings and param_shardings on an MoE config give JAX's
    specs entry for entry."""
    from flashattention_kernel_project_tpu import models as jmodels

    ours = models.moe_param_shardings(models.MoEConfig(**MOE), "e")
    theirs = jmodels.moe_param_shardings(jmodels.MoEConfig(**MOE), "e")
    assert {k: tuple(v) for k, v in ours.items()} == \
        {k: tuple(v) for k, v in theirs.items()}
    from flashattention_kernel_project_tpu.models import transformer as jtfm

    cfg = models.TransformerConfig(**TFM, dtype=torch.float32)
    ours = tfm._leaves(models.param_shardings(cfg, model_axis="m"))
    theirs = tfm._leaves(jtfm.param_shardings(_jax_cfg(TFM), model_axis="m"))
    assert {k: tuple(v) for k, v in ours.items()} == \
        {k: tuple(v) for k, v in theirs.items()}
    assert ours["layers.moe_w1"] == P(None, "m", None, None)


# ---------------------------------------------------------------------------
# the TP steps' MoE branch
# ---------------------------------------------------------------------------

def _jax_leaves(tree) -> dict:
    import jax

    return _numpy_leaves(params_from_jax(jax.tree.map(np.asarray, tree), CPU))


def _hold(runs, whole, axes, atol, what):
    """Every rank's leaves within atol of its blocks of `whole`; the
    leaves that are whole bit-equal on every rank."""
    specs = tfm._leaves(tfm.param_shardings(
        models.TransformerConfig(**TFM, dtype=torch.float32)))
    for rank, (_, leaves) in enumerate(runs):
        assert set(leaves) == set(whole)
        for k, got in leaves.items():
            np.testing.assert_allclose(got, _block(whole[k], specs[k], axes, rank),
                                       rtol=0, atol=atol,
                                       err_msg=f"{what}: rank {rank}, {k}")
            if not any(specs[k]):
                np.testing.assert_array_equal(got, runs[0][1][k])


def _jax_tp(jp, tokens, axes):
    import jax.numpy as jnp

    from flashattention_kernel_project_tpu import parallel as jparallel

    mesh = _jax_mesh(axes)
    step, rules = jparallel.make_train_step(_jax_cfg(TFM), mesh, lr=1e-2)
    new, loss = step(jparallel.shard_params(jp, mesh, rules), jnp.asarray(tokens))
    return float(loss), _jax_leaves(new)


@pytest.fixture(scope="module")
def single_loss(world):
    """JAX's single-device SGD step's loss on the TP tests' params and
    tokens."""
    import jax.numpy as jnp

    from flashattention_kernel_project_tpu import models as jmodels

    jp, tokens = world[0]["jtfm"], world[0]["tokens"]
    _, loss = jmodels.sgd_train_step(_jax_cfg(TFM), jp, jnp.asarray(tokens),
                                     lr=1e-2)
    return float(loss)


def test_tp_moe_step_model_axis_only(world, single_loss):
    """:160: data 1 x model 4, every rank routing every token: the loss
    within rtol 1e-4 of JAX's TP step and of one device's, the params
    within 1e-5 of JAX's TP step."""
    axes = TP["tp 1x4"][0]
    runs = _results(world, "tp 1x4")
    loss, new = _jax_tp(world[0]["jtfm"], world[0]["tokens"], axes)
    for losses, _ in runs:
        np.testing.assert_allclose(losses[0], loss, rtol=1e-4)
        np.testing.assert_allclose(losses[0], single_loss, rtol=1e-4)
    _hold(runs, new, axes, 1e-5, "JAX's TP step")


def test_tp_moe_step_data_and_model(world, single_loss):
    """:175: data 2 x model 2, each data shard routing its own tokens: the
    loss within JAX's 5e-3 of one device's, and loss and params within
    1e-5 of JAX's own TP step."""
    axes = TP["tp 2x2"][0]
    runs = _results(world, "tp 2x2")
    loss, new = _jax_tp(world[0]["jtfm"], world[0]["tokens"], axes)
    for losses, _ in runs:
        np.testing.assert_allclose(losses[0], single_loss, rtol=5e-3)
        np.testing.assert_allclose(losses[0], loss, rtol=1e-5)
    _hold(runs, new, axes, 1e-5, "JAX's TP step")


def test_optimizer_step_moe_matches_jax(world):
    """3 AdamW steps with clip_norm 1.0 over data 2 x model 2 on the MoE
    decoder against JAX's make_optax_train_step with optax.adamw(1e-2):
    every loss rtol 1e-4, the params atol 5e-4 (the bounds of the dense
    step's test, tests/test_torch_train_parallel.py)."""
    import jax.numpy as jnp
    import optax

    from flashattention_kernel_project_tpu import parallel as jparallel

    jp, tokens = world[0]["jtfm"], world[0]["tokens"]
    axes = TP["adamw 2x2"][0]
    mesh = _jax_mesh(axes)
    init, step, rules, _ = jparallel.make_optax_train_step(
        _jax_cfg(TFM), mesh, optax.adamw(ADAMW["lr"]), jp, clip_norm=1.0)
    p = jparallel.shard_params(jp, mesh, rules)
    s = init(p)
    losses = []
    for _ in range(3):
        p, s, loss = step(p, s, jnp.asarray(tokens))
        losses.append(float(loss))
    runs = _results(world, "adamw 2x2")
    for got, _ in runs:
        np.testing.assert_allclose(got, losses, rtol=1e-4)
    _hold(runs, _jax_leaves(p), axes, 5e-4, "JAX's make_optax_train_step")
    assert runs[0][0][-1] < runs[0][0][0]


# ---------------------------------------------------------------------------
# Scheduler(seq_mesh=) over an MoE model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(SP))
def test_sp_scheduler_moe_matches_jax(world, name):
    """JAX serves an MoE model through Scheduler(seq_mesh=) (its parameters
    whole, its SP step routing the whole batch, empty slots included): the
    port's gives the same greedy tokens on every rank, over the float32,
    int8 and multi_step=4 paths."""
    from flashattention_kernel_project_tpu.models.serving import Scheduler as JS

    kw, prompts, max_new = SP[name]
    ref = JS(_jax_cfg(SERVE), world[0]["jserve"], max_batch=2, interpret=True,
             seq_mesh=_jax_mesh({"sp": WORLD}), **kw)
    uids = [ref.submit(p, max_new_tokens=max_new) for p in prompts]
    res = ref.run()
    want = [res[u] for u in uids]
    for rank, tokens in enumerate(_results(world, name)):
        assert tokens == want, (rank, tokens, want)
