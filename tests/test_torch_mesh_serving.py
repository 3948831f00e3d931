"""The port's Scheduler over a device mesh (Scheduler(mesh=, seq_mesh=)) on
a gloo world of 4 CPU ranks, against the JAX package's single-device
Scheduler token for token, in float32, with the same tokens on every rank:
tests/test_serving.py's mesh tests (tensor parallel over the linear cache,
the page pool with the prefix cache, multi_step and speculative decoding;
sequence parallel, with multi_step), the 8-bit caches over both meshes, and
the JAX Scheduler's walls.

One world runs every scenario (a module fixture: spawning ranks costs
seconds), each scenario's failure is reported by its own test. The rank
function is module-level and this module imports JAX only inside functions,
so a rank imports no JAX."""

import numpy as np
import pytest
import torch

from flashattention_kernel_project_tpu_torch import models, parallel
from flashattention_kernel_project_tpu_torch.models.convert import params_from_jax
from flashattention_kernel_project_tpu_torch.models.serving import Scheduler
from flashattention_kernel_project_tpu_torch.utils.testing import run_ranks

CPU = torch.device("cpu")
WORLD = 4
# tests/test_serving.py's configs: CFG (:12) and the TP tests' (:117)
CFG = dict(vocab_size=64, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
           d_head=16, d_ff=128)
TP_CFG = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=8, n_kv_heads=4,
              d_head=16, d_ff=64)
DRAFT_CFG = dict(TP_CFG, n_layers=1, d_ff=32, n_heads=4, n_kv_heads=2)


def _prompts(seed, lens, base=0):
    rng = np.random.default_rng(seed)
    if base:
        b = rng.integers(0, 64, size=base).astype(np.int32)
        return [np.concatenate([b, rng.integers(0, 64, size=e).astype(np.int32)])
                for e in lens]
    return [rng.integers(0, 64, size=n).astype(np.int32) for n in lens]


# name -> (model, mesh axes, the mesh Scheduler's options, prompts, max_new,
# the reference Scheduler's options), after tests/test_serving.py
SCENARIOS = {
    # :108, prefill in chunks of 5
    "tp": ("tp", dict(mesh={"model": 4}), dict(max_len=64, prefill_chunk=5),
           _prompts(3, (6, 11, 4)), 4, dict(max_len=64)),
    # :403, linear and paged
    "tp_multi_step": ("tp", dict(mesh={"model": 4}),
                      dict(max_len=64, multi_step=3), _prompts(21, (6, 11, 4)),
                      7, dict(max_len=64)),
    "tp_multi_step_paged": ("tp", dict(mesh={"model": 4}),
                            dict(max_len=64, multi_step=3, paged=True,
                                 page_size=8),
                            _prompts(21, (6, 11, 4)), 7, dict(max_len=64)),
    # :494
    "tp_paged_prefix": ("tp", dict(mesh={"model": 4}),
                        dict(max_len=96, paged=True, page_size=16,
                             prefix_cache=True, prefill_chunk=16),
                        _prompts(13, (3, 6, 2), base=32), 4,
                        dict(max_len=96, paged=True, page_size=16)),
    # :615
    "sp": ("cfg", dict(seq_mesh={"sp": 4}), dict(max_len=64),
           _prompts(14, (6, 11, 4)), 4, dict(max_len=64)),
    # :641, the draft whole on every rank
    "tp_spec": ("tp", dict(mesh={"model": 4}),
                dict(max_len=64, draft=True, spec_k=3), _prompts(15, (6, 9)), 5,
                dict(max_len=64)),
    # :745
    "tp_spec_paged": ("tp", dict(mesh={"model": 4}),
                      dict(max_len=64, paged=True, page_size=8, draft=True,
                           spec_k=3),
                      _prompts(23, (6, 11, 4)), 6, dict(max_len=64)),
    # :782
    "sp_multi_step": ("cfg", dict(seq_mesh={"sp": 4}),
                      dict(max_len=64, multi_step=3), _prompts(37, (6, 11, 4)),
                      7, dict(max_len=64)),
    # the int8 cache over a 2-rank model axis (a 2 x 2 data x model mesh),
    # linear and paged, and over a 4-rank seq axis, against the JAX
    # Scheduler's int8 cache (tests/test_serving.py:88)
    "tp_int8": ("tp", dict(mesh={"data": 2, "model": 2}),
                dict(max_len=64, quantized_cache=True, prefill_chunk=8),
                _prompts(5, (6, 11, 4)), 5,
                dict(max_len=64, quantized_cache=True)),
    "tp_int8_paged": ("tp", dict(mesh={"data": 2, "model": 2}),
                      dict(max_len=64, quantized_cache=True, paged=True,
                           page_size=16, prefix_cache=True),
                      _prompts(6, (4, 7, 3), base=16), 5,
                      dict(max_len=64, quantized_cache=True, paged=True,
                           page_size=16)),
    "sp_int8": ("cfg", dict(seq_mesh={"sp": 4}),
                dict(max_len=64, quantized_cache=True, multi_step=2),
                _prompts(7, (6, 11, 4)), 5,
                dict(max_len=64, quantized_cache=True)),
}


# the scenarios that also serve a sampled request
SAMPLED = ("tp", "sp")


def _mesh_rank(rank, world, scenarios, params_np):
    """Every scenario on this rank: {name: tokens in submission order, or
    the traceback of its failure}. The plain TP and SP scenarios also serve
    one request sampled from an identically seeded generator, which every
    rank must draw alike."""
    import traceback

    cfgs = {"tp": TP_CFG, "cfg": CFG}
    params = {k: params_from_jax(v, CPU) for k, v in params_np.items()}
    out = {}
    for name, (model, axes, kw, prompts, max_new, _) in scenarios.items():
        try:
            kw = dict(kw)
            cfg = models.TransformerConfig(**cfgs[model], dtype=torch.float32)
            if kw.pop("draft", False):
                kw.update(draft_cfg=models.TransformerConfig(
                    **DRAFT_CFG, dtype=torch.float32),
                    draft_params=params["draft"])
            (key, shape), = axes.items()
            mesh = parallel.make_mesh(shape, device_type="cpu")
            sched = Scheduler(cfg, params[model], max_batch=2, **{key: mesh},
                              **kw)
            uids = [sched.submit(p, max_new_tokens=max_new) for p in prompts]
            res = sched.run()
            tokens = [res[u] for u in uids]
            extra = {}
            if sched.paged:
                extra["pages_back"] = (sched._pool.free_pages
                                       == sched._n_pages - 1)
                extra["prefix_hits"] = getattr(sched, "prefix_hits", 0)
            if name in SAMPLED:
                samp = Scheduler(cfg, params[model], max_batch=2, **{key: mesh},
                                 temperature=0.8, top_k=16,
                                 generator=torch.Generator().manual_seed(5),
                                 **kw)
                u = samp.submit(prompts[0], max_new_tokens=max_new)
                extra["sampled"] = samp.run()[u]
            out[name] = (tokens, extra)
        except Exception:  # reported by the scenario's own test
            out[name] = traceback.format_exc()
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    import jax

    jp = {k: _jax_params(cfg, seed)
          for k, (cfg, seed) in dict(tp=(TP_CFG, 0), cfg=(CFG, 0),
                                     draft=(DRAFT_CFG, 9)).items()}
    params_np = {k: jax.tree.map(np.asarray, v) for k, v in jp.items()}
    ranks = run_ranks(_mesh_rank, WORLD, SCENARIOS, params_np,
                      tmpdir=str(tmp_path_factory.mktemp("mesh_serving")),
                      timeout=240.0)
    return jp, ranks


def _jax_cfg(kw):
    import jax.numpy as jnp

    from flashattention_kernel_project_tpu import models as jmodels

    return jmodels.TransformerConfig(**kw, dtype=jnp.float32, block_q=16,
                                     block_k=16)


def _jax_params(kw, seed):
    import jax

    from flashattention_kernel_project_tpu import models as jmodels

    return jmodels.init_params(_jax_cfg(kw), jax.random.PRNGKey(seed))


_JAX_TOKENS = {}  # scenarios with the same reference run it once


def _jax_tokens(model, jp, prompts, max_new, kw):
    key = (model, tuple(map(bytes, prompts)), max_new, tuple(sorted(kw.items())))
    if key not in _JAX_TOKENS:
        _JAX_TOKENS[key] = _jax_scheduler_tokens(model, jp, prompts, max_new, kw)
    return _JAX_TOKENS[key]


def _jax_scheduler_tokens(model, jp, prompts, max_new, kw):
    from flashattention_kernel_project_tpu.models.serving import Scheduler as JS

    cfg = _jax_cfg(TP_CFG if model == "tp" else CFG)
    ref = JS(cfg, jp[model], max_batch=2, interpret=True, **kw)
    uids = [ref.submit(p, max_new_tokens=max_new) for p in prompts]
    out = ref.run()
    return [out[u] for u in uids]


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_mesh_scheduler_matches_jax_scheduler(world, name):
    """Each mode gives the JAX single-device Scheduler's greedy tokens on
    every rank; a paged run returns every page to the pool; the sampled
    request is the same on every rank."""
    jp, ranks = world
    model, _, kw, prompts, max_new, ref_kw = SCENARIOS[name]
    results = [r[name] for r in ranks]
    for rank, res in enumerate(results):
        assert not isinstance(res, str), f"rank {rank}:\n{res}"
    want = _jax_tokens(model, jp, prompts, max_new, ref_kw)
    for rank, (tokens, extra) in enumerate(results):
        assert tokens == want, (rank, tokens, want)
        assert extra == results[0][1], (rank, extra, results[0][1])
        if "pages_back" in extra:
            assert extra["pages_back"]
    if kw.get("prefix_cache"):
        assert results[0][1]["prefix_hits"] > 0
    if name in SAMPLED:
        assert len(results[0][1]["sampled"]) == max_new


def test_mesh_walls_raise_as_jax():
    """The JAX Scheduler's walls raise NotImplementedError with its
    messages in both packages, before the mesh is touched; an MoE model
    over a TP mesh is refused as JAX's refuses it, and served over a
    seq_mesh."""
    import jax

    from flashattention_kernel_project_tpu import parallel as jparallel
    from flashattention_kernel_project_tpu.models.serving import Scheduler as JS

    cfg = models.TransformerConfig(**TP_CFG, dtype=torch.float32)
    jp = _jax_params(TP_CFG, 0)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), CPU)
    draft = dict(draft_cfg=cfg, draft_params=tp)
    jmesh = jparallel.make_mesh({"model": 4}, devices=jax.devices()[:4])
    walls = [
        (dict(seq_mesh=1, mesh=1), "seq_mesh .length-sharded cache. is a linear"),
        (dict(seq_mesh=1, paged=True), "seq_mesh .length-sharded cache. is a linear"),
        (dict(seq_mesh=1, spec=True), "no seq_mesh"),
        (dict(mesh=1, paged=True, quantized_cache=True, spec=True),
         "TP paged verify is wired bf16-only"),
        (dict(mesh=1, multi_step=3, temperature=0.8, sample=True),
         "multi_step sampling over a mesh"),
    ]
    for kw, msg in walls:
        kw = dict(kw)
        spec, sample = kw.pop("spec", False), kw.pop("sample", False)
        ours = {k: (object() if k in ("mesh", "seq_mesh") else v)
                for k, v in kw.items()}
        theirs = {k: (jmesh if k in ("mesh", "seq_mesh") else v)
                  for k, v in kw.items()}
        if spec:
            ours.update(draft)
            theirs.update(draft_cfg=_jax_cfg(TP_CFG), draft_params=jp)
        if sample:
            ours["generator"] = torch.Generator()
            theirs["key"] = jax.random.PRNGKey(0)
        with pytest.raises(NotImplementedError, match=msg):
            Scheduler(cfg, tp, max_batch=2, max_len=64, **ours)
        with pytest.raises(NotImplementedError, match=msg):
            JS(_jax_cfg(TP_CFG), jp, max_batch=2, max_len=64, interpret=True,
               **theirs)
    # an MoE model: mesh= refuses it (JAX's TP engine has no MoE form and
    # raises KeyError: 'w_gate'), linear and paged; seq_mesh= serves it
    # (tests/test_torch_ep.py holds its tokens to JAX's)
    moe_kw = dict(TP_CFG, moe_experts=4)
    moe = models.TransformerConfig(**moe_kw, dtype=torch.float32)
    jmoe = _jax_params(moe_kw, 0)
    mp = params_from_jax(jax.tree.map(np.asarray, jmoe), CPU)
    for paged in ({}, dict(paged=True, page_size=16)):
        with pytest.raises(NotImplementedError, match="no MoE form"):
            Scheduler(moe, mp, max_batch=2, max_len=64, mesh=object(), **paged)
        with pytest.raises(KeyError, match="w_gate"):
            ref = JS(_jax_cfg(moe_kw), jmoe, max_batch=2, max_len=64,
                     interpret=True, mesh=jmesh, **paged)
            ref.submit(np.arange(4, dtype=np.int32), max_new_tokens=2)
            ref.run()
    _serve_on_one_rank(moe, mp)


def _serve_on_one_rank(cfg, params):
    """Scheduler(seq_mesh=) accepts the MoE model: a one-rank gloo world in
    this process, torn down after."""
    import tempfile

    import torch.distributed as dist

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", store=dist.FileStore(f"{tmp}/store", 1),
                                rank=0, world_size=1)
        try:
            mesh = parallel.make_mesh({"sp": 1}, device_type="cpu")
            sched = Scheduler(cfg, params, max_batch=2, max_len=64,
                              seq_mesh=mesh)
            uid = sched.submit(np.arange(5, dtype=np.int32), max_new_tokens=3)
            assert len(sched.run()[uid]) == 3
        finally:
            dist.destroy_process_group()
