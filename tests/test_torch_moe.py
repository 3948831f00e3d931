"""The port's MoE FFN (models/moe.py) against the JAX package's, in float32
on the CPU, on the same (converted) parameters and inputs made from numpy
seeds: the chosen experts, the outputs of the dense and the sort dispatch,
the load-balancing loss, the gradients, the capacity drops and the
capacity rule. Each counterparts a single-device test of tests/test_moe.py
(:63, :71, :78, :189, :220)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattention_kernel_project_tpu import models as jmodels
from flashattention_kernel_project_tpu.models import moe as jmoe
from flashattention_kernel_project_tpu_torch.models import moe
from flashattention_kernel_project_tpu_torch.models.convert import params_from_jax
from flashattention_kernel_project_tpu_torch.utils.testing import assert_rel_l2

torch.set_num_threads(1)

CPU = torch.device("cpu")
# tests/test_moe.py's CFG, and the tight capacity of its sort test (:189),
# which forces drops
JCFGS = {
    "cap2.0": jmodels.MoEConfig(d_model=32, d_ff=64, num_experts=8, top_k=2,
                                capacity_factor=2.0),
    "cap0.5": jmodels.MoEConfig(d_model=32, d_ff=64, num_experts=8, top_k=2,
                                capacity_factor=0.5),
}
OUT_TOL = 1e-5    # rtol and atol of the outputs
AUX_TOL = 1e-6
GRAD_TOL = 1e-5   # rel-L2 of the gradients


def _cfg(jcfg):
    return moe.MoEConfig(d_model=jcfg.d_model, d_ff=jcfg.d_ff,
                         num_experts=jcfg.num_experts, top_k=jcfg.top_k,
                         capacity_factor=jcfg.capacity_factor)


@pytest.fixture(scope="module")
def both_params():
    jp = jmodels.init_moe_params(jax.random.key(0), JCFGS["cap2.0"])
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), CPU)


def _x(seed, shape=(2, 40, 32)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _choices(jp, tp, x, top_k):
    """Each package's chosen experts [T, k] for tokens x."""
    x2 = x.reshape(-1, x.shape[-1])
    jprobs = jax.nn.softmax(jnp.asarray(x2) @ jp["w_gate"], axis=-1)
    _, jmasks, _ = jmoe._top_k_choices(jprobs, top_k)
    tprobs = torch.softmax(torch.from_numpy(x2) @ tp["w_gate"], dim=-1)
    _, tmasks, _ = moe._top_k_choices(tprobs, top_k)
    return (np.stack([np.asarray(m).argmax(-1) for m in jmasks], -1),
            torch.stack([m.argmax(-1) for m in tmasks], -1).numpy())


def test_init_moe_params_shapes_and_scales(both_params):
    cfg = moe.MoEConfig(d_model=64, d_ff=256, num_experts=4)
    p = moe.init_moe_params(cfg, torch.Generator().manual_seed(0), CPU)
    assert set(p) == set(both_params[0])
    assert p["w_gate"].shape == (64, 4) and p["w1"].shape == (4, 64, 256)
    assert p["w2"].shape == (4, 256, 64)
    assert all(w.dtype == torch.float32 for w in p.values())
    assert abs(float(p["w1"].std()) - 64 ** -0.5) < 0.01
    assert abs(float(p["w2"].std()) - 256 ** -0.5) < 0.01


@pytest.mark.parametrize("dispatch", ["dense", "sort"])
@pytest.mark.parametrize("cap", sorted(JCFGS))
def test_moe_ffn_matches_jax(both_params, cap, dispatch):
    """The same experts chosen, and the outputs within 1e-5, at capacity 2.0
    and at 0.5 (drops forced), through each dispatch."""
    jp, tp = both_params
    jcfg = JCFGS[cap]
    x = _x(1)
    jc, tc = _choices(jp, tp, x, jcfg.top_k)
    np.testing.assert_array_equal(tc, jc)
    exp = np.asarray(jmodels.moe_ffn(jp, jnp.asarray(x), jcfg, dispatch=dispatch))
    got = moe.moe_ffn(tp, torch.from_numpy(x), _cfg(jcfg), dispatch=dispatch)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), exp, rtol=OUT_TOL, atol=OUT_TOL)


@pytest.mark.parametrize("cap", sorted(JCFGS))
def test_moe_sort_dispatch_matches_dense(both_params, cap):
    """The port's two dispatches route and drop alike: equal to f32
    rounding (tests/test_moe.py:205's bound)."""
    _, tp = both_params
    cfg = _cfg(JCFGS[cap])
    x = torch.from_numpy(_x(2))
    dense = moe.moe_ffn(tp, x, cfg, dispatch="dense")
    srt = moe.moe_ffn(tp, x, cfg, dispatch="sort")
    np.testing.assert_allclose(dense.numpy(), srt.numpy(), rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("zeros", [False, True], ids=["random", "uniform"])
@pytest.mark.parametrize("dispatch", ["dense", "sort"])
def test_moe_aux_loss_matches_jax(both_params, dispatch, zeros):
    """The load-balancing loss equal within 1e-6, on random tokens and on
    zeros (a uniform router: every argmax a tie, the first expert)."""
    jp, tp = both_params
    jcfg = JCFGS["cap2.0"]
    x = np.zeros((64, 32), np.float32) if zeros else _x(3)
    _, jaux = jmodels.moe_ffn(jp, jnp.asarray(x), jcfg, return_aux=True,
                              dispatch=dispatch)
    _, taux = moe.moe_ffn(tp, torch.from_numpy(x), _cfg(jcfg), return_aux=True,
                          dispatch=dispatch)
    assert abs(float(taux) - float(jaux)) <= AUX_TOL
    assert np.isfinite(float(taux))


@pytest.mark.parametrize("dispatch", ["dense", "sort"])
@pytest.mark.parametrize("cap", sorted(JCFGS))
def test_moe_grads_match_jax(both_params, cap, dispatch):
    """The gradients of (o**2).sum() + 0.01 * aux, with respect to the
    router, both expert weights and the tokens, against jax.grad's."""
    jp, tp = both_params
    jcfg = JCFGS[cap]
    x = _x(4, (2, 24, 32))

    def jloss(p, xx):
        o, aux = jmodels.moe_ffn(p, xx, jcfg, return_aux=True, dispatch=dispatch)
        return (o ** 2).sum() + 0.01 * aux

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    o, aux = moe.moe_ffn(leaves, xt, _cfg(jcfg), return_aux=True,
                         dispatch=dispatch)
    ((o ** 2).sum() + 0.01 * aux).backward()
    for k, leaf in leaves.items():
        assert_rel_l2(leaf.grad.numpy(), np.asarray(jgp[k]), tol=GRAD_TOL)
    assert_rel_l2(xt.grad.numpy(), np.asarray(jgx), tol=GRAD_TOL)


# the JAX package's dispatches, compiled once a capacity
jit_dispatch = jax.jit(jmoe._top_k_dispatch, static_argnums=(1, 2))
jit_dispatch_sort = jax.jit(jmoe._top_k_dispatch_sort, static_argnums=(1, 2))


def _drops_jax(probs, top_k, cap):
    dsp, _, _ = jit_dispatch(probs, top_k, cap)
    _, slot_tk, _, _ = jit_dispatch_sort(probs, top_k, cap)
    e = probs.shape[1]
    return (top_k * probs.shape[0] - int(np.asarray(dsp).sum()),
            int((np.asarray(slot_tk) == e * cap).sum()))


def _drops_port(probs, top_k, cap):
    dsp, _, _ = moe._top_k_dispatch(probs, top_k, cap)
    _, slot_tk, _, _ = moe._top_k_dispatch_sort(probs, top_k, cap)
    e = probs.shape[1]
    return (top_k * probs.shape[0] - int(dsp.sum()),
            int((slot_tk == e * cap).sum()))


@pytest.mark.parametrize("factor", [0.1, 0.5, 1.25, 2.0])
def test_moe_capacity_drops_match_jax(both_params, factor):
    """The choices dropped past each expert's capacity: the same count in
    both dispatches of both packages (tests/test_moe.py:78's 0.1 drops
    most), the slots each kept choice fills equal, and the output of the
    tightest finite."""
    jp, tp = both_params
    x = _x(5, (64, 32))
    jcfg = jmodels.MoEConfig(d_model=32, d_ff=64, num_experts=8, top_k=2,
                             capacity_factor=factor)
    cap = jcfg.capacity(64)
    jprobs = jax.nn.softmax(jnp.asarray(x) @ jp["w_gate"], axis=-1)
    tprobs = torch.softmax(torch.from_numpy(x) @ tp["w_gate"], dim=-1)
    jd, td = _drops_jax(jprobs, 2, cap), _drops_port(tprobs, 2, cap)
    assert jd[0] == jd[1] == td[0] == td[1]
    if factor < 1.0:
        assert td[0] > 0
    jslots = np.asarray(jit_dispatch_sort(jprobs, 2, cap)[1])
    tslots = moe._top_k_dispatch_sort(tprobs, 2, cap)[1].numpy()
    np.testing.assert_array_equal(tslots, jslots)
    out = moe.moe_ffn(tp, torch.from_numpy(x), _cfg(jcfg))
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("top_k,experts", [(1, 8), (2, 8), (2, 4), (3, 16)])
def test_moe_capacity_rule_matches_jax(top_k, experts):
    """MoEConfig.capacity equal to JAX's for t in 1..4096 (the max(8, ...)
    rounding from 8 tokens, max(1, cap) below)."""
    for factor in (0.1, 0.5, 1.0, 1.25, 2.0):
        jcfg = jmodels.MoEConfig(num_experts=experts, top_k=top_k,
                                 capacity_factor=factor)
        cfg = moe.MoEConfig(num_experts=experts, top_k=top_k,
                            capacity_factor=factor)
        got = [cfg.capacity(t) for t in range(1, 4097)]
        assert got == [jcfg.capacity(t) for t in range(1, 4097)]


def test_moe_ffn_rejects_an_unknown_dispatch(both_params):
    _, tp = both_params
    with pytest.raises(ValueError, match="dispatch"):
        moe.moe_ffn(tp, torch.zeros(4, 32), _cfg(JCFGS["cap2.0"]),
                    dispatch="gather")
