"""The port's ring attention (parallel/ring_attention.py) on a gloo world of
4 CPU ranks, against the JAX package's ring_attention,
ring_attention_kv_quant and ring_attention_trainable over 4 devices, the
single-device kernels and the oracle, in float32 at tests/test_parallel.py's
shapes and bounds (the JAX tests' 8-device rings run on 4 ranks here):
causal and not, the 8-bit ring, the windowed ring (bf16 and 8-bit), the
trainable ring's value and gradients; and merge_normalized.

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
WINDOWS = (48, 100, 200)  # < a shard, spanning 2 shards, spanning 4


def _inputs():
    """tests/test_parallel.py's shapes, from numpy seed 42."""
    rng = np.random.default_rng(42)

    def qkv(b, h, n, d):
        return tuple(rng.standard_normal((b, h, n, d), dtype=np.float32)
                     for _ in range(3))

    return {
        "ring": qkv(1, 4, 256, 32),      # :71, 64 tokens a shard
        "single": qkv(2, 2, 128, 32),    # :86
        "quant": qkv(1, 4, 256, 32),     # :134
        "grads": qkv(1, 2, 128, 32),     # :191
        "window": qkv(1, 2, 256, 32),    # :349, 4 shards of 64
    }


def _quantized(k, v):
    """JAX's quantize_kv of k, v as numpy (int8 values, float32 scales)."""
    import jax.numpy as jnp

    from flashattention_kernel_project_tpu import ops as jops

    return tuple(np.array(x) for x in jops.quantize_kv(jnp.asarray(k),
                                                         jnp.asarray(v)))


def _shards(mesh, spec, arrays, grad=False):
    return [parallel.mesh.shard(torch.from_numpy(a), mesh, spec)
            .requires_grad_(grad) for a in arrays]


def _ring_rank(mesh, kind, causal, window, arrays):
    """The rank's slice of the ring's output ("bf16", "int8"), or of the
    trainable ring's output and its gradients of sum(o cos o)."""
    if kind == "trainable":
        fn = parallel.ring_attention_trainable(mesh, causal=causal,
                                               data_axis=None)
        shards = _shards(mesh, fn.spec, arrays, grad=True)
        o = fn(*shards)
        (o * o.cos()).sum().backward()
        return [o.detach().numpy()] + [s.grad.numpy() for s in shards]
    make = (parallel.ring_attention if kind == "bf16"
            else parallel.ring_attention_kv_quant)
    fn = make(mesh, causal=causal, data_axis=None, window=window)
    return [fn(*_shards(mesh, fn.spec, arrays)).numpy()]


def _scenarios(x, quant):
    q, k, v = x["quant"]
    wq, wk, wv = x["window"]
    out = {f"ring causal={c}": ("bf16", c, None, x["ring"]) for c in (False, True)}
    out["single"] = ("bf16", True, None, x["single"])
    out.update({f"int8 causal={c}": ("int8", c, None, (q, *quant["quant"]))
                for c in (False, True)})
    out.update({f"window {w}": ("bf16", True, w, x["window"]) for w in WINDOWS})
    out["int8 window"] = ("int8", True, 100, (wq, *quant["window"]))
    out.update({f"trainable causal={c}": ("trainable", c, None, x["grads"])
                for c in (False, True)})
    return out


def _world_rank(rank, world, scenarios):
    """Every scenario on this rank: {name: its outputs, or the traceback of
    its failure}."""
    import traceback

    mesh = parallel.make_mesh({"sp": world}, device_type="cpu")
    out = {}
    for name, args in scenarios.items():
        try:
            out[name] = _ring_rank(mesh, *args)
        except Exception:  # reported by the scenario's own test
            out[name] = traceback.format_exc()
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    x = _inputs()
    quant = {"quant": _quantized(*x["quant"][1:]),
             "window": _quantized(*x["window"][1:])}
    ranks = run_ranks(_world_rank, WORLD, _scenarios(x, quant),
                      tmpdir=str(tmp_path_factory.mktemp("ring")))
    return x, quant, ranks


def _gathered(world, name):
    """The scenario's outputs, each the ranks' slices joined along the
    sequence, failing on a rank's error."""
    per_rank = [r[name] for r in world[2]]
    for rank, res in enumerate(per_rank):
        assert not isinstance(res, str), f"rank {rank}:\n{res}"
    return [np.concatenate(parts, axis=2) for parts in zip(*per_rank)]


def _jax_mesh():
    import jax

    from flashattention_kernel_project_tpu import parallel as jparallel

    return jparallel.make_mesh({"sp": WORLD}, devices=jax.devices()[:WORLD])


def _jax_ring(make, causal, arrays, window=None):
    import jax.numpy as jnp

    fn = make(_jax_mesh(), causal=causal, data_axis=None, window=window,
              block_q=32, block_k=32)
    return np.asarray(fn(*(jnp.asarray(a) for a in arrays)))


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention(world, causal):
    """tests/test_parallel.py:71: the ring against JAX's ring and the oracle."""
    from flashattention_kernel_project_tpu import parallel as jparallel
    from flashattention_kernel_project_tpu.utils import oracles

    (got,) = _gathered(world, f"ring causal={causal}")
    q, k, v = world[0]["ring"]
    assert_rel_l2(got, _jax_ring(jparallel.ring_attention, causal, (q, k, v)),
                  1e-5)
    assert_rel_l2(got, oracles.gqa_attention(q, k, v, causal=causal), 1e-2)


def test_ring_attention_matches_single_device_kernel(world):
    """:86: the ring over 4 shards against the port's fused kernel on one
    device (1e-3) and JAX's."""
    import jax.numpy as jnp

    from flashattention_kernel_project_tpu import ops as jops

    (got,) = _gathered(world, "single")
    q, k, v = world[0]["single"]
    single = tfa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                 causal=True)
    assert_rel_l2(got, single.numpy(), 1e-3)
    jsingle = jops.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                   causal=True, block_q=32, block_k=32)
    assert_rel_l2(got, np.asarray(jsingle), 1e-3)


def test_merge_normalized_identity():
    """:118: merging with an empty partial (o 0, lse NEG_INF) is the
    identity, as in JAX."""
    from flashattention_kernel_project_tpu_torch.ops.softmax import NEG_INF

    o = torch.ones((2, 3, 4, 8))
    lse = torch.zeros((2, 3, 4))
    o2, lse2 = parallel.merge_normalized(o, lse, torch.zeros_like(o),
                                         torch.full_like(lse, NEG_INF))
    torch.testing.assert_close(o2, o, rtol=1e-6, atol=0)
    torch.testing.assert_close(lse2, lse, rtol=1e-6, atol=0)


def test_merge_normalized_against_jax():
    """merge_normalized against JAX's on random partials, and on two empty
    partials (both lse NEG_INF: o stays 0 and finite, lse NEG_INF)."""
    import jax.numpy as jnp

    from flashattention_kernel_project_tpu import parallel as jparallel
    from flashattention_kernel_project_tpu_torch.ops.softmax import NEG_INF

    rng = np.random.default_rng(3)
    o_a, o_b = (rng.standard_normal((2, 3, 5, 8), dtype=np.float32)
                for _ in range(2))
    lse_a, lse_b = (rng.standard_normal((2, 3, 5), dtype=np.float32) * 4
                    for _ in range(2))
    lse_b[0, 0] = NEG_INF  # rows whose second partial is empty
    for args in ((o_a, lse_a, o_b, lse_b),
                 (np.zeros_like(o_a), np.full_like(lse_a, NEG_INF),
                  np.zeros_like(o_b), np.full_like(lse_b, NEG_INF))):
        got = parallel.merge_normalized(*(torch.from_numpy(a) for a in args))
        want = jparallel.merge_normalized(*(jnp.asarray(a) for a in args))
        for g, w in zip(got, want):
            assert torch.isfinite(g).all()
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-6)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_kv_quant(world, causal):
    """:134: the ring over int8 shards (values and scales rotate together)
    against JAX's 8-bit ring and the port's single-device 8-bit kernel
    (1e-3), and the dequantized-cache oracle (1e-2)."""
    from flashattention_kernel_project_tpu import parallel as jparallel
    from flashattention_kernel_project_tpu.utils import oracles

    (got,) = _gathered(world, f"int8 causal={causal}")
    q = world[0]["quant"][0]
    k_q, k_s, v_q, v_s = world[1]["quant"]
    assert_rel_l2(got, _jax_ring(jparallel.ring_attention_kv_quant, causal,
                                 (q, k_q, k_s, v_q, v_s)), 1e-3)
    single = tfa.flash_attention_kv_quant(
        *(torch.from_numpy(a) for a in (q, k_q, k_s, v_q, v_s)), causal=causal)
    assert_rel_l2(got, single.numpy(), 1e-3)
    kd = k_q.astype(np.float32) * k_s
    vd = v_q.astype(np.float32) * v_s
    assert_rel_l2(got, oracles.gqa_attention(q, kd, vd, causal=causal), 1e-2)


@pytest.mark.parametrize("window", WINDOWS)
def test_ring_attention_window(world, window):
    """:344: the windowed ring (truncated to its depth, the off-diagonal
    shards causal at q_offset t * 64) against JAX's windowed ring and the
    port's single-device windowed kernel, at 1e-5."""
    from flashattention_kernel_project_tpu import parallel as jparallel

    (got,) = _gathered(world, f"window {window}")
    q, k, v = world[0]["window"]
    assert_rel_l2(got, _jax_ring(jparallel.ring_attention, True, (q, k, v),
                                 window), 1e-5)
    single = tfa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                 causal=True, window=window)
    assert_rel_l2(got, single.numpy(), 1e-5)


def test_ring_attention_kv_quant_window(world):
    """:367: the windowed 8-bit ring against JAX's and the port's
    single-device windowed 8-bit kernel, at 1e-5."""
    from flashattention_kernel_project_tpu import parallel as jparallel

    (got,) = _gathered(world, "int8 window")
    arrays = (world[0]["window"][0], *world[1]["window"])
    assert_rel_l2(got, _jax_ring(jparallel.ring_attention_kv_quant, True,
                                 arrays, 100), 1e-5)
    single = tfa.flash_attention_kv_quant(
        *(torch.from_numpy(a) for a in arrays), causal=True, window=100)
    assert_rel_l2(got, single.numpy(), 1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_trainable_grads(world, causal):
    """:189: the trainable ring's value and gradients of sum(o cos o)
    against jax.grad through JAX's trainable ring and through the
    single-device kernel, and against autograd through the port's (rel-L2
    1e-3)."""
    import jax
    import jax.numpy as jnp

    from flashattention_kernel_project_tpu import ops as jops
    from flashattention_kernel_project_tpu import parallel as jparallel

    got = _gathered(world, f"trainable causal={causal}")
    q, k, v = world[0]["grads"]
    ring = jparallel.ring_attention_trainable(
        _jax_mesh(), causal=causal, data_axis=None, block_q=32, block_k=32)

    def single(q, k, v):
        return jops.flash_attention(q, k, v, causal=causal, block_q=32,
                                    block_k=32)

    for attend in (ring, single):
        def loss(q, k, v):
            o = attend(q, k, v)
            return jnp.sum(o * jnp.cos(o))

        o = attend(*(jnp.asarray(a) for a in (q, k, v)))
        grads = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                                   for a in (q, k, v)))
        for g, w in zip(got, (o, *grads)):
            assert_rel_l2(g, np.asarray(w), 1e-3)

    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = tfa.flash_attention(tq, tk, tv, causal=causal)
    (o * o.cos()).sum().backward()
    for g, w in zip(got, (o.detach(), tq.grad, tk.grad, tv.grad)):
        assert_rel_l2(g, w.numpy(), 1e-3)


def test_tiling_knobs_dropped():
    """JAX's block_q, block_k and interpret are TPU tiling knobs: the port's
    rings take none of them."""
    for make in (parallel.ring_attention, parallel.ring_attention_kv_quant,
                 parallel.ring_attention_trainable):
        with pytest.raises(TypeError):
            make(None, block_q=32)
