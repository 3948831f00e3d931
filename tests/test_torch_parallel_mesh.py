"""The port's mesh (parallel/mesh.py) on a gloo world of 4 CPU ranks:
make_mesh, the head-sharded attention and decodes (bf16 layout in float32,
and 8-bit) and the sequence-sharded decode, each rank's output against its
block of the JAX mesh function's output (tests/test_parallel.py's shapes);
and return_partials of the linear decodes against JAX's, with rows and
shards that hold no live key.

One world runs every mesh scenario (a module fixture: spawning ranks costs
seconds); each scenario's failure is reported by its own test. The rank
function is module-level and this module imports JAX only inside functions,
so a rank imports no JAX."""

import numpy as np
import pytest
import torch

from flashattention_kernel_project_tpu_torch import parallel
from flashattention_kernel_project_tpu_torch.ops import flash_decode as tfd
from flashattention_kernel_project_tpu_torch.utils.sharding import P
from flashattention_kernel_project_tpu_torch.utils.testing import (
    assert_rel_l2,
    run_ranks,
)

WORLD = 4
TOL = 1e-5  # float32, the same arithmetic in another order of sums


def _inputs():
    """tests/test_parallel.py's shapes, from numpy seed 42."""
    rng = np.random.default_rng(42)

    def f(*shape):
        return rng.standard_normal(shape, dtype=np.float32)

    return {
        # :28 (the 8-device model axis) and :39 (data 2 x model 4)
        "attn": (f(2, 16, 128, 32), f(2, 8, 128, 32), f(2, 8, 128, 32)),
        "attn_2d": (f(4, 8, 64, 32), f(4, 4, 64, 32), f(4, 4, 64, 32)),
        # :50 and :160
        "decode": (f(2, 16, 32), f(2, 8, 96, 32), f(2, 8, 96, 32),
                   np.array([96, 41], np.int32)),
        # :218: row 1 lives on 2 of the 4 shards
        "seq": (f(2, 8, 32), f(2, 2, 256, 32), f(2, 2, 256, 32),
                np.array([256, 100], np.int32)),
        # with a data axis: rows 2 and 3 on one shard of two, row 3 empty
        "seq_2d": (f(4, 8, 64), f(4, 2, 128, 64), f(4, 2, 128, 64),
                   np.array([128, 70, 64, 0], np.int32)),
    }


def _quantized(k, v):
    """k, v quantized by the JAX package's quantize_kv (int8), as numpy."""
    import jax.numpy as jnp

    from flashattention_kernel_project_tpu.ops import quantize_kv

    return tuple(np.asarray(x) for x in quantize_kv(jnp.asarray(k),
                                                    jnp.asarray(v)))


def _mesh_rank(rank, world, x, quant):
    """Every mesh scenario on this rank: {name: (coordinates, output block)
    or the traceback of its failure}."""
    import traceback

    t = {k: [torch.from_numpy(a) for a in v] for k, v in x.items()}
    tq = [torch.from_numpy(a) for a in quant]
    out = {}

    def run(name, axes, make, args):
        try:
            mesh = parallel.make_mesh(axes, device_type="cpu")
            fn = make(mesh)
            spec = fn.kv_spec
            q_spec = P(spec[0], spec[1] if spec[1] else None)
            sharded = [parallel.mesh.shard(a, mesh, q_spec if i == 0 else
                                           (P(spec[0]) if a.dim() == 1 else spec))
                       for i, a in enumerate(args)]
            coords = {a: (parallel.axis_index(mesh, a), parallel.axis_size(mesh, a))
                      for a in mesh.mesh_dim_names}
            out[name] = (coords, fn(*sharded).numpy())
        except Exception:  # reported by the scenario's own test
            out[name] = traceback.format_exc()

    run("attn", {"model": 4},
        lambda m: parallel.head_sharded_attention(m, causal=True), t["attn"])
    run("attn_2d", {"data": 2, "model": 2},
        lambda m: parallel.head_sharded_attention(m, causal=True), t["attn_2d"])
    run("decode", {"model": 4},
        lambda m: parallel.head_sharded_decode(m, n_splits=2), t["decode"])
    q, _, _, lengths = t["decode"]
    run("decode_quant", {"model": 4},
        lambda m: parallel.head_sharded_decode_quant(m, n_splits=2),
        [q, *tq, lengths])
    run("seq", {"sp": 4},
        lambda m: parallel.seq_sharded_decode(m, data_axis=None), t["seq"])
    run("seq_2d", {"data": 2, "sp": 2},
        lambda m: parallel.seq_sharded_decode(m, n_splits=3), t["seq_2d"])
    try:
        mesh = parallel.make_mesh({"data": -1, "model": 2}, device_type="cpu")
        errors = []
        for bad in ({"model": 3}, {"data": -1, "model": -1}):
            try:
                parallel.make_mesh(bad, device_type="cpu")
            except ValueError as e:
                errors.append(str(e))
        out["make_mesh"] = (tuple(mesh.mesh_dim_names), tuple(mesh.shape),
                            parallel.axis_size(mesh, "data"), len(errors))
    except Exception:
        out["make_mesh"] = traceback.format_exc()
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    x = _inputs()
    quant = _quantized(x["decode"][1], x["decode"][2])
    ranks = run_ranks(_mesh_rank, WORLD, x, quant,
                      tmpdir=str(tmp_path_factory.mktemp("mesh")))
    return x, quant, ranks


def _jax_mesh_outputs(name, x, quant):
    """The JAX mesh function's whole output for scenario `name`."""
    import jax
    import jax.numpy as jnp

    from flashattention_kernel_project_tpu import parallel as jparallel

    mesh8 = jparallel.make_mesh({"model": 8})
    if name == "attn":
        fn = jparallel.head_sharded_attention(mesh8, causal=True, block_q=64,
                                              block_k=64)
        args = x["attn"]
    elif name == "attn_2d":
        fn = jparallel.head_sharded_attention(
            jparallel.make_mesh({"data": 2, "model": 4}), causal=True,
            block_q=32, block_k=32)
        args = x["attn_2d"]
    elif name == "decode":
        fn = jparallel.head_sharded_decode(mesh8, n_splits=2)
        args = x["decode"]
    elif name == "decode_quant":
        fn = jparallel.head_sharded_decode_quant(mesh8, n_splits=2)
        args = (x["decode"][0], *quant, x["decode"][3])
    elif name == "seq":
        fn = jparallel.seq_sharded_decode(
            jparallel.make_mesh({"sp": 4}, devices=jax.devices()[:4]),
            data_axis=None)
        args = x["seq"]
    else:
        fn = jparallel.seq_sharded_decode(
            jparallel.make_mesh({"data": 2, "sp": 2}, devices=jax.devices()[:4]),
            n_splits=3)
        args = x["seq_2d"]
    return np.asarray(fn(*(jnp.asarray(a) for a in args)))


def _block(whole, coords, axes_of_dims):
    """The block of `whole` at the rank's coordinates ({axis: (index,
    size)}), dimension i cut over the mesh axis axes_of_dims[i] (None:
    whole)."""
    out = whole
    for dim, axis in enumerate(axes_of_dims):
        if axis is None or axis not in coords:
            continue
        i, n = coords[axis]
        size = whole.shape[dim] // n
        out = np.take(out, range(i * size, (i + 1) * size), axis=dim)
    return out


# scenario -> the axes of its output's dimensions
OUT_AXES = {"attn": ("data", "model"), "attn_2d": ("data", "model"),
            "decode": ("data", "model"), "decode_quant": ("data", "model"),
            "seq": ("data", None), "seq_2d": ("data", None)}


@pytest.mark.parametrize("name", list(OUT_AXES))
def test_mesh_function_matches_jax(world, name):
    """Each rank's output is its block of the JAX mesh function's output
    (the whole output for the sequence-sharded decode, bit-equal on every
    rank)."""
    x, quant, ranks = world
    results = [r[name] for r in ranks]
    for rank, res in enumerate(results):
        assert not isinstance(res, str), f"rank {rank}:\n{res}"
    want = _jax_mesh_outputs(name, x, quant)
    for rank, (coords, got) in enumerate(results):
        assert_rel_l2(got, _block(want, coords, OUT_AXES[name]), TOL,
                      f"{name}, rank {rank} at {coords}")
        assert np.isfinite(got).all()
        if name.startswith("seq"):
            same = [r for r, (c, _) in enumerate(results)
                    if c.get("data") == coords.get("data")]
            np.testing.assert_array_equal(got, results[same[0]][1])


def test_make_mesh(world):
    """-1 takes the ranks left; sizes that do not cover the world raise."""
    for res in (r["make_mesh"] for r in world[2]):
        assert not isinstance(res, str), res
        assert res == (("data", "model"), (2, 2), 2, 2)
    with pytest.raises(RuntimeError, match="initialised process group"):
        parallel.make_mesh({"model": 1}, device_type="cpu")


def _decode_case(fmt, rng):
    b, hq, hkv, s, d = 4, 8, 2, 200, 32
    q = rng.standard_normal((b, hq, d), dtype=np.float32)
    k = rng.standard_normal((b, hkv, s, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, s, d), dtype=np.float32)
    # an empty row, a row within the first split, a row at the cache's end
    lengths = np.array([0, 37, 200, 130], np.int32)
    return q, k, v, lengths


def _jax_partials(fmt, q, k, v, lengths, n_splits, mxu):
    import importlib

    import jax.numpy as jnp

    from flashattention_kernel_project_tpu.ops import quantize_kv

    # the module, which the package's `flash_decode` function shadows
    jfd = importlib.import_module("flashattention_kernel_project_tpu.ops.flash_decode")
    j = [jnp.asarray(a) for a in (q, k, v, lengths)]
    if fmt is None:
        out = jfd.flash_decode(j[0], j[1], j[2], j[3], n_splits=n_splits,
                               return_partials=True, interpret=True)
        return [np.asarray(o) for o in out], None
    kq, ks, vq, vs = quantize_kv(j[1], j[2], fmt=fmt)
    out = jfd.flash_decode_int8(j[0], kq, ks, vq, vs, j[3], n_splits=n_splits,
                                return_partials=True, interpret=True, mxu=mxu)
    cache = [np.asarray(a) for a in (kq, ks, vq, vs)]
    return [np.asarray(o) for o in out], cache


def _port_cache(cache):
    kq, ks, vq, vs = cache
    return [torch.from_numpy(np.array(a)) if a.dtype.name != "float8_e4m3fn"
            else torch.from_numpy(np.array(a).view(np.uint8)).view(torch.float8_e4m3fn)
            for a in (kq, ks, vq, vs)]


@pytest.mark.parametrize("fmt,mxu", [(None, False), ("int8", False),
                                     ("int8", True), ("fp8", False)])
def test_return_partials_match_jax(fmt, mxu):
    """flash_decode and flash_decode_int8 (mxu False and True, int8 and
    e4m3) return JAX's folded partials (m, l, y) of shapes [B, Hkv, G, 1],
    [B, Hkv, G, 1], [B, Hkv, G, D]; an empty row has l = 0 and y = 0."""
    q, k, v, lengths = _decode_case(fmt, np.random.default_rng(3))
    want, cache = _jax_partials(fmt, q, k, v, lengths, 3, mxu)
    args = (torch.from_numpy(q),)
    if fmt is None:
        got = tfd.flash_decode(*args, torch.from_numpy(k), torch.from_numpy(v),
                               torch.from_numpy(lengths), n_splits=3,
                               return_partials=True)
    else:
        got = tfd.flash_decode_int8(*args, *_port_cache(cache),
                                    torch.from_numpy(lengths), n_splits=3,
                                    return_partials=True, mxu=mxu)
    m, l, y = (t.numpy() for t in got)
    assert m.shape == l.shape == (4, 2, 4, 1) and y.shape == (4, 2, 4, 32)
    live = l[..., 0] > 0
    assert not live[0].any() and live[1:].all()
    assert (y[0] == 0).all() and (l[0] == 0).all()
    np.testing.assert_allclose(m[live], want[0][live], rtol=TOL, atol=TOL)
    assert_rel_l2(l, want[1], TOL)
    assert_rel_l2(y, want[2], TOL)


@pytest.mark.parametrize("fmt,mxu", [(None, False), ("int8", False),
                                     ("int8", True)])
def test_partials_merge_across_a_dead_shard(fmt, mxu):
    """The cache cut in two along its length, each half's partials at the
    clipped lengths (the second half holds no live key for rows 0-2),
    merged as seq_sharded_decode merges them: the whole decode's output, no
    NaN, zeros for the empty row."""
    q, k, v, lengths = _decode_case(fmt, np.random.default_rng(4))
    lengths = np.array([0, 37, 100, 130], np.int32)
    half = k.shape[2] // 2
    if fmt is None:
        caches = [torch.from_numpy(k), torch.from_numpy(v)]
        dec = tfd.flash_decode
    else:
        _, cache = _jax_partials(fmt, q, k, v, lengths, 2, mxu)
        caches = _port_cache(cache)
        dec = lambda q_, *rest, **kw: tfd.flash_decode_int8(  # noqa: E731
            q_, *rest, mxu=mxu, **kw)
    tq, tl = torch.from_numpy(q), torch.from_numpy(lengths)
    parts = []
    for lo in (0, half):
        shard = [c[:, :, lo:lo + half].contiguous() for c in caches]
        parts.append(dec(tq, *shard, (tl - lo).clamp(0, half).to(torch.int32),
                         n_splits=2, return_partials=True))
    st = [torch.stack([p[i] for p in parts], dim=-3) for i in range(3)]
    merged = tfd.merge_partials(*st).reshape(q.shape)
    whole = dec(tq, *caches, tl, n_splits=4)
    assert torch.isfinite(merged).all()
    assert (merged[0] == 0).all()
    assert_rel_l2(merged.numpy(), whole.numpy(), 1e-5 if not mxu else 2e-2)
