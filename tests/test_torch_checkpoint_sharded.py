"""Sharded checkpoints (models/checkpoint.py over torch.distributed.checkpoint)
on a gloo world of 4 CPU ranks, after the JAX package's tests/test_checkpoint.py:
a single-device checkpoint restored straight into a {"data": 2, "model": 2}
layout (:44), the torch.optim DP x TP step saved mid-run from the mesh,
restored into it and continued with the uninterrupted run's losses and
parameters (:82), and the mesh's checkpoint restored on one device, for the
dense decoder and an MoE one (its experts cut over the model axis).

One world runs every scenario (a module fixture: spawning ranks costs
seconds); each scenario's failure is reported by its own test. The rank
function is module-level and imports no JAX; the parent writes the
single-device checkpoints and reads the mesh's back."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from flashattention_kernel_project_tpu_torch import models, parallel
from flashattention_kernel_project_tpu_torch.models import checkpoint as ck
from flashattention_kernel_project_tpu_torch.models import transformer as tfm
from flashattention_kernel_project_tpu_torch.utils.sharding import P
from flashattention_kernel_project_tpu_torch.utils.testing import run_ranks

WORLD = 4
AXES = {"data": 2, "model": 2}
CPU = torch.device("cpu")
# tests/test_checkpoint.py:17-21, less the TPU tiles, and with 4 experts
CFG = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
           d_head=8, d_ff=64)
KINDS = {"dense": CFG, "moe": dict(CFG, moe_experts=4)}
ADAMW = dict(lr=1e-2)  # optax.adamw(1e-2), :90


def _cfg(kw):
    return models.TransformerConfig(**kw, dtype=torch.float32)


def _params(kw, seed):
    return models.init_params(_cfg(kw), torch.Generator().manual_seed(seed), CPU)


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.numpy() if isinstance(tree, torch.Tensor) else tree


def _ckpt_rank(rank, world, root, tokens):
    """Both kinds on this rank: (a) the parent's single-device checkpoint
    restored into the mesh layout; (b) 4 AdamW steps uninterrupted, and 2
    steps, a sharded save, a restore into the mesh and 2 more. Returns by
    kind the restored shards, both runs' losses and final shards, and the
    shards (params and optimizer state) saved at step 2."""
    from torch.distributed.tensor import DTensor

    mesh = parallel.make_mesh(AXES, device_type="cpu")
    out = {}
    for kind, kw in KINDS.items():
        cfg = _cfg(kw)
        params = _params(kw, 0)
        rules = models.param_shardings(cfg)
        # (a) :44, a template of DTensors in the mesh layout
        zeros = {k: torch.zeros_like(v) for k, v in tfm._leaves(params).items()}
        template = ck.to_dtensors(
            parallel.shard_params(tfm._unflatten(zeros), mesh, rules), mesh, rules)
        got = ck.restore_checkpoint(f"{root}/single-{kind}",
                                    params_template=template)
        leaves = tfm._leaves(got["params"])
        assert all(isinstance(x, DTensor) for x in leaves.values())
        restored = {k: x.to_local().numpy() for k, x in leaves.items()}

        # (b) :82, the optimizer step over data 2 x model 2
        init, step, rules, sspecs = parallel.make_optax_train_step(
            cfg, mesh, functools.partial(torch.optim.AdamW, **ADAMW), params)
        toks = parallel.mesh.shard(torch.from_numpy(tokens), mesh, P("data", None))

        def run(p, s, n):
            losses = []
            for _ in range(n):
                p, s, loss = step(p, s, toks)
                losses.append(float(loss))
            return p, s, losses

        first = parallel.shard_params(params, mesh, rules)
        p_ref, _, losses_ref = run(first, init(first), 4)
        first = parallel.shard_params(params, mesh, rules)
        p2, s2, losses = run(first, init(first), 2)
        saved = (_numpy(tfm._leaves(p2)), _numpy(s2["state"]))
        specs = ck.optimizer_specs(s2, sspecs)
        ck.save_checkpoint(f"{root}/mid-{kind}", ck.to_dtensors(p2, mesh, rules),
                           step=2, opt_state=ck.to_dtensors(s2, mesh, specs),
                           config=cfg)
        got = ck.restore_checkpoint(
            f"{root}/mid-{kind}", params_template=ck.to_dtensors(p2, mesh, rules),
            opt_state_template=ck.to_dtensors(s2, mesh, specs))
        assert got["step"] == 2 and got["config"]["d_model"] == cfg.d_model
        p3, _, resumed = run(ck.from_dtensors(got["params"]),
                             ck.from_dtensors(got["opt_state"]), 2)
        out[kind] = dict(restored=restored, losses_ref=losses_ref,
                         losses=losses + resumed,
                         ref=_numpy(tfm._leaves(p_ref)),
                         resumed=_numpy(tfm._leaves(p3)), saved=saved,
                         sspecs=sspecs)
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt_sharded")
    for kind, kw in KINDS.items():
        models.save_checkpoint(str(root / f"single-{kind}"), _params(kw, 0),
                               step=1)
    tokens = np.random.default_rng(1).integers(0, 64, (4, 32)).astype(np.int32)
    ranks = run_ranks(_ckpt_rank, WORLD, str(root), tokens, tmpdir=str(root),
                      timeout=180.0)
    return root, ranks


def _block(x, spec, rank):
    """The block of the whole array x that `rank` holds under `spec` on the
    row-major AXES mesh."""
    coords = dict(zip(AXES, np.unravel_index(rank, tuple(AXES.values()))))
    for dim, axis in enumerate(spec or ()):
        if axis in AXES:
            size = x.shape[dim] // AXES[axis]
            x = np.take(x, range(coords[axis] * size, (coords[axis] + 1) * size),
                        axis=dim)
    return x


def _specs(kind):
    return tfm._leaves(models.param_shardings(_cfg(KINDS[kind])))


@pytest.mark.parametrize("kind", list(KINDS))
def test_single_device_checkpoint_restores_into_mesh(world, kind):
    """:44: each rank restores its blocks of the single-device checkpoint,
    bit for bit, as DTensors in param_shardings' layout."""
    whole = {k: x.numpy() for k, x in tfm._leaves(_params(KINDS[kind], 0)).items()}
    specs = _specs(kind)
    for rank, r in enumerate(world[1]):
        for k, got in r[kind]["restored"].items():
            np.testing.assert_array_equal(got, _block(whole[k], specs[k], rank),
                                          err_msg=f"rank {rank}, {k}")
    if kind == "moe":
        assert world[1][0][kind]["restored"]["layers.moe_w1"].shape[1] == 2


@pytest.mark.parametrize("kind", list(KINDS))
def test_resume_through_sharded_checkpoint(world, kind):
    """:82: 2 steps, a sharded save, a restore into the mesh and 2 more
    steps give the uninterrupted run's losses and parameters, bit for bit
    (JAX's bound: rtol 1e-6, atol 1e-6), the same on every rank."""
    for rank, r in enumerate(world[1]):
        run = r[kind]
        np.testing.assert_array_equal(run["losses"], run["losses_ref"])
        assert run["losses"] == world[1][0][kind]["losses"]
        for k, got in run["resumed"].items():
            np.testing.assert_array_equal(got, run["ref"][k],
                                          err_msg=f"rank {rank}, {k}")


@pytest.mark.parametrize("kind", list(KINDS))
def test_mesh_checkpoint_restores_on_one_device(world, kind):
    """The checkpoint written over the mesh restores in this process (no
    process group) into plain whole tensors, which the ranks' saved shards
    put together make, bit for bit; its optimizer state, restored with no
    template, likewise (parameter i's entries by its spec, the step counts
    whole)."""
    root, ranks = world
    cfg = _cfg(KINDS[kind])
    template = {k: torch.zeros_like(v) for k, v in
                tfm._leaves(_params(KINDS[kind], 0)).items()}
    got = models.restore_checkpoint(f"{root}/mid-{kind}",
                                    params_template=tfm._unflatten(template))
    assert got["step"] == 2 and got["config"]["n_layers"] == cfg.n_layers
    whole = _numpy(tfm._leaves(got["params"]))
    state = got["opt_state"]["state"]
    specs = _specs(kind)
    for rank, r in enumerate(ranks):
        params, opt = r[kind]["saved"]
        sspecs = r[kind]["sspecs"]
        for k, shard in params.items():
            np.testing.assert_array_equal(shard, _block(whole[k], specs[k], rank),
                                          err_msg=f"rank {rank}, {k}")
        for i, entries in opt.items():
            for name, shard in entries.items():
                full = state[str(i)][name].numpy()
                spec = sspecs[i] if shard.ndim else None
                np.testing.assert_array_equal(shard, _block(full, spec, rank),
                                              err_msg=f"rank {rank}, {i}.{name}")


def test_sharded_item_needs_matching_template(world):
    """A template whose shapes differ from the saved arrays raises
    ValueError, as the torch file's check does."""
    root, _ = world
    cfg = dataclasses.replace(_cfg(CFG), d_model=16)
    bad = models.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    with pytest.raises(ValueError, match="does not match"):
        models.restore_checkpoint(f"{root}/mid-dense", params_template=bad)
