"""The port's Ulysses attention (parallel/ulysses.py) on a gloo world of 4
CPU ranks, against the JAX package's ulysses_attention over 4 devices, the
oracle and the single-device kernels, in float32 at tests/test_parallel.py's
shapes and bounds: the forward causal and not, the gradients, and the head
counts that do not divide over the axis.

One world runs every scenario (a module fixture: spawning ranks costs
seconds); each scenario's failure is reported by its own test. The rank
function is module-level and this module imports JAX only inside functions,
so a rank imports no JAX."""

import numpy as np
import pytest
import torch

from flashattention_kernel_project_tpu_torch import parallel
from flashattention_kernel_project_tpu_torch.ops import flash_attention as tfa
from flashattention_kernel_project_tpu_torch.utils.testing import (
    assert_rel_l2,
    run_ranks,
)

WORLD = 4


def _inputs():
    """tests/test_parallel.py's shapes, from numpy seed 42."""
    rng = np.random.default_rng(42)

    def qkv(b, h, hkv, n, d):
        return tuple(rng.standard_normal(s, dtype=np.float32)
                     for s in ((b, h, n, d), (b, hkv, n, d), (b, hkv, n, d)))

    return {
        "fwd": qkv(1, 8, 8, 128, 32),    # :103, 8 heads over 4 ranks
        "gqa": qkv(1, 8, 4, 128, 32),    # GQA: 8/4 heads over 4 ranks
        "grads": qkv(1, 4, 4, 128, 32),  # :238
        "uneven": qkv(1, 8, 2, 128, 32),  # 2 KV heads do not divide over 4
    }


def _ulysses_rank(mesh, causal, grad, arrays):
    """The rank's slice of the output, and with grad its gradients of
    sum(o cos o)."""
    fn = parallel.ulysses_attention(mesh, causal=causal, data_axis=None)
    shards = [parallel.mesh.shard(torch.from_numpy(a), mesh, fn.spec)
              .requires_grad_(grad) for a in arrays]
    o = fn(*shards)
    if not grad:
        return [o.numpy()]
    (o * o.cos()).sum().backward()
    return [o.detach().numpy()] + [s.grad.numpy() for s in shards]


def _scenarios(x):
    out = {f"fwd causal={c}": (c, False, x["fwd"]) for c in (False, True)}
    out["gqa"] = (True, False, x["gqa"])
    out["grads"] = (True, True, x["grads"])
    out["uneven"] = (True, False, x["uneven"])
    return out


def _world_rank(rank, world, scenarios):
    """Every scenario on this rank: {name: its outputs, or the traceback of
    its failure}."""
    import traceback

    mesh = parallel.make_mesh({"sp": world}, device_type="cpu")
    out = {}
    for name, args in scenarios.items():
        try:
            out[name] = _ulysses_rank(mesh, *args)
        except Exception:  # reported by the scenario's own test
            out[name] = traceback.format_exc()
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    x = _inputs()
    ranks = run_ranks(_world_rank, WORLD, _scenarios(x),
                      tmpdir=str(tmp_path_factory.mktemp("ulysses")))
    return x, ranks


def _gathered(world, name):
    """The scenario's outputs, each the ranks' slices joined along the
    sequence, failing on a rank's error."""
    per_rank = [r[name] for r in world[1]]
    for rank, res in enumerate(per_rank):
        assert not isinstance(res, str), f"rank {rank}:\n{res}"
    return [np.concatenate(parts, axis=2) for parts in zip(*per_rank)]


def _jax_ulysses(causal):
    import jax

    from flashattention_kernel_project_tpu import parallel as jparallel

    mesh = jparallel.make_mesh({"sp": WORLD}, devices=jax.devices()[:WORLD])
    return jparallel.ulysses_attention(mesh, causal=causal, data_axis=None,
                                       block_q=32, block_k=32)


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_attention(world, causal):
    """tests/test_parallel.py:103: against JAX's Ulysses (1e-5) and the
    oracle (1e-2)."""
    import jax.numpy as jnp

    from flashattention_kernel_project_tpu.utils import oracles

    (got,) = _gathered(world, f"fwd causal={causal}")
    q, k, v = world[0]["fwd"]
    want = _jax_ulysses(causal)(*(jnp.asarray(a) for a in (q, k, v)))
    assert_rel_l2(got, np.asarray(want), 1e-5)
    assert_rel_l2(got, oracles.gqa_attention(q, k, v, causal=causal), 1e-2)


def test_ulysses_attention_gqa(world):
    """GQA with the KV heads dividing over the axis: the port's
    single-device kernel's output, exactly (each rank runs it on whole
    sequences of its heads)."""
    (got,) = _gathered(world, "gqa")
    q, k, v = world[0]["gqa"]
    want = tfa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               causal=True)
    np.testing.assert_array_equal(got, want.numpy())


def test_ulysses_gradients(world):
    """:238: the gradients through the all-to-alls against jax.grad through
    JAX's Ulysses and through the single-device kernel, and autograd
    through the port's (rel-L2 1e-3)."""
    import jax
    import jax.numpy as jnp

    from flashattention_kernel_project_tpu import ops as jops

    got = _gathered(world, "grads")
    q, k, v = world[0]["grads"]

    def single(q, k, v):
        return jops.flash_attention(q, k, v, causal=True, block_q=32,
                                    block_k=32)

    for attend in (_jax_ulysses(True), single):
        def loss(q, k, v):
            o = attend(q, k, v)
            return jnp.sum(o * jnp.cos(o))

        grads = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                                   for a in (q, k, v)))
        for g, w in zip(got[1:], grads):
            assert_rel_l2(g, np.asarray(w), 1e-3)

    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = tfa.flash_attention(tq, tk, tv, causal=True)
    (o * o.cos()).sum().backward()
    for g, w in zip(got, (o.detach(), tq.grad, tk.grad, tv.grad)):
        assert_rel_l2(g, w.numpy(), 1e-3)


def test_ulysses_heads_must_divide(world):
    """JAX's assumption heads % P == 0 as a ValueError: 2 KV heads over 4
    ranks."""
    for rank, res in enumerate(r["uneven"] for r in world[1]):
        assert isinstance(res, str) and "ValueError" in res, f"rank {rank}: {res}"


def test_tiling_knobs_dropped():
    with pytest.raises(TypeError):
        parallel.ulysses_attention(None, block_q=32)
