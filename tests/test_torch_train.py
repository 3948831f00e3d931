"""The port's training path against the JAX package's, in float32 on the
CPU: loss_fn and every parameter gradient against jax.value_and_grad, SGD
steps, the token loader batch for batch, and a checkpoint round trip."""

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattention_kernel_project_tpu import models as jmodels
from flashattention_kernel_project_tpu.runtime import data as jdata
from flashattention_kernel_project_tpu_torch.models import checkpoint, transformer
from flashattention_kernel_project_tpu_torch.models.convert import params_from_jax
from flashattention_kernel_project_tpu_torch.ops import flash_attention as tfa
from flashattention_kernel_project_tpu_torch.runtime import data
from flashattention_kernel_project_tpu_torch.utils.testing import assert_rel_l2

torch.set_num_threads(1)

CPU = torch.device("cpu")
LOSS_TOL = 1e-4   # float32 on both sides
GRAD_TOL = 1e-3   # rel-L2 of each gradient leaf and of the stepped params
JCFG = jmodels.TransformerConfig(
    vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_head=16, d_ff=128, dtype=jnp.float32, block_q=32, block_k=32,
)
CFG = transformer.TransformerConfig(
    vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_head=16, d_ff=128, dtype=torch.float32,
)


@pytest.fixture(scope="module")
def both_params():
    jp = jmodels.init_params(JCFG, jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), CPU)


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, size=shape,
                                                dtype=np.int32)


_flat = transformer._leaves  # {"layers.wq": tensor, ...}


def test_loss_and_every_gradient_match_jax(both_params):
    jp, tp = both_params
    toks = _tokens(0, (2, 24))
    jloss, jgrads = jax.value_and_grad(
        lambda p: jmodels.loss_fn(JCFG, p, jnp.asarray(toks)))(jp)
    leaves = {k: x.clone().requires_grad_(True) for k, x in _flat(tp).items()}
    loss = transformer.loss_fn(CFG, transformer._unflatten(leaves),
                               torch.from_numpy(toks))
    assert loss.dtype == torch.float32 and loss.dim() == 0
    grads = torch.autograd.grad(loss, list(leaves.values()))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_TOL)
    assert abs(loss.item() - np.log(CFG.vocab_size)) < 1.0
    jflat = _flat(jax.tree.map(np.asarray, jgrads))
    assert set(jflat) == set(leaves)
    for (name, _), g in zip(leaves.items(), grads):
        assert g.shape == jflat[name].shape, name
        assert_rel_l2(g.numpy(), jflat[name], tol=GRAD_TOL, msg=name)


def test_sgd_train_steps_match_jax(both_params):
    jp, tp = both_params
    toks = _tokens(1, (2, 24))
    for step in range(3):
        jp, jloss = jmodels.sgd_train_step(JCFG, jp, jnp.asarray(toks), lr=1e-1)
        new, loss = transformer.sgd_train_step(CFG, tp, torch.from_numpy(toks),
                                               lr=1e-1)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=GRAD_TOL,
                                   err_msg=f"step {step}")
        assert not loss.requires_grad
        assert new["layers"]["wq"] is not tp["layers"]["wq"]
        tp = new
    jflat = _flat(jax.tree.map(np.asarray, jp))
    for name, x in _flat(tp).items():
        assert x.dtype == torch.float32 and not x.requires_grad
        assert_rel_l2(x.numpy(), jflat[name], tol=GRAD_TOL, msg=name)
    assert tfa._bwd.launches == 0  # CPU tensors: the plain backward


def test_sgd_train_step_keeps_bf16_leaves():
    cfg = dataclasses.replace(CFG, dtype=torch.bfloat16)
    p = transformer.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    new, loss = transformer.sgd_train_step(
        cfg, p, torch.from_numpy(_tokens(2, (1, 16))), lr=1e-1)
    assert torch.isfinite(loss)
    assert new["layers"]["wq"].dtype == torch.bfloat16
    assert new["rms_final"].dtype == torch.float32
    assert not torch.equal(new["layers"]["w_up"], p["layers"]["w_up"])


@pytest.fixture(scope="module")
def token_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("data") / "toks.bin")
    data.write_token_file(path, np.arange(5000, dtype=np.uint32) % 777)
    return path


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("native", [False, True])
def test_token_loader_matches_jax(token_file, native, shuffle):
    """Batch for batch the same as the JAX loader for one file and seed,
    with one prefetch worker for the native backend (several workers
    deliver in a racy order in both)."""
    if native and shutil.which("g++") is None:
        pytest.skip("no g++ to build the native loader")
    kw = dict(batch=3, seq_len=40, seed=5, shuffle=shuffle, n_threads=1,
              native=native, shard=(1, 2))
    with data.TokenLoader(token_file, **kw) as got, \
            jdata.TokenLoader(token_file, **kw) as exp:
        assert got.native == exp.native == native
        assert got.n_tokens == exp.n_tokens == 5000
        for _ in range(6):
            b = got.next_batch()
            assert b.shape == (3, 41) and b.dtype == np.uint32
            np.testing.assert_array_equal(b, exp.next_batch())


def test_token_loader_rejects_a_short_shard(tmp_path):
    path = str(tmp_path / "short.bin")
    data.write_token_file(path, np.arange(100, dtype=np.uint32))
    with pytest.raises(OSError):
        data.TokenLoader(path, batch=1, seq_len=60, shard=(0, 2), native=False)


def test_checkpoint_round_trip(tmp_path, both_params):
    _, tp = both_params
    opt = {"momentum": {"embed": torch.ones(3, 2)}}
    path = checkpoint.save_checkpoint(str(tmp_path / "ck"), tp, step=7,
                                      opt_state=opt, config=CFG)
    state = checkpoint.restore_checkpoint(path, params_template=tp)
    assert state["step"] == 7
    assert state["config"]["dtype"] == "float32"
    assert state["config"]["d_model"] == CFG.d_model
    torch.testing.assert_close(state["opt_state"], opt, rtol=0, atol=0)
    restored = _flat(state["params"])
    for name, x in _flat(tp).items():
        assert restored[name].dtype == x.dtype
        assert torch.equal(restored[name], x), name
    # a params-only checkpoint restores without the optimizer state
    only = checkpoint.save_checkpoint(str(tmp_path / "p"), tp)
    assert set(checkpoint.restore_checkpoint(only)) == {"params", "step"}
    bad = dict(tp, rms_final=tp["rms_final"].double())
    with pytest.raises(ValueError):
        checkpoint.restore_checkpoint(path, params_template=bad)
