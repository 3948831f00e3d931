"""The port's serving path on the CPU: the Scheduler against the JAX
Scheduler token for token, its unported modes, the native admission core
against its Python fallback, the retry policy, and the rule that the port
never imports JAX."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattention_kernel_project_tpu import models as jmodels
from flashattention_kernel_project_tpu.models.serving import Scheduler as JScheduler
from flashattention_kernel_project_tpu_torch.models import transformer
from flashattention_kernel_project_tpu_torch.models.convert import params_from_jax
from flashattention_kernel_project_tpu_torch.models.serving import Scheduler
from flashattention_kernel_project_tpu_torch.runtime.native import (
    BatchSchedulerCore,
    scheduler_available,
)
from flashattention_kernel_project_tpu_torch.utils import health

torch.set_num_threads(1)

CPU = torch.device("cpu")
# the tiny config of tests/test_serving.py
JCFG = jmodels.TransformerConfig(
    vocab_size=64, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_head=16, d_ff=128, dtype=jnp.float32, block_q=32, block_k=32,
)
CFG = transformer.TransformerConfig(
    vocab_size=64, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_head=16, d_ff=128, dtype=torch.float32,
)


@pytest.fixture(scope="module")
def both_params():
    jp = jmodels.init_params(JCFG, jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), CPU)


def test_scheduler_matches_jax_scheduler(both_params):
    """4 staggered requests on 3 slots (one queues): the port's Scheduler
    gives the JAX Scheduler's tokens, request for request."""
    jp, tp = both_params
    rng = np.random.default_rng(0)
    prompts = [
        rng.integers(0, CFG.vocab_size, size=n).astype(np.int32)
        for n in (5, 9, 3, 12)
    ]
    jsched = JScheduler(JCFG, jp, max_batch=3, max_len=128)
    juids = [jsched.submit(p, max_new_tokens=4) for p in prompts]
    jout = jsched.run()

    seen = []
    sched = Scheduler(CFG, tp, max_batch=3, max_len=128)
    uids = [
        sched.submit(p, max_new_tokens=4,
                     on_token=lambda u, t, d: seen.append((u, t, d)))
        for p in prompts
    ]
    out = sched.run()
    for uid, juid in zip(uids, juids):
        assert out[uid] == jout[juid], (uid, out[uid], jout[juid])
    assert sorted(u for u, _, d in seen if d) == sorted(uids)
    m = sched.metrics()
    assert m.requests == 4 and m.tokens == 16
    assert 0 < m.ttft_s_mean <= m.latency_s_mean
    # every slot retired: all lengths are back to 0 after the last step
    assert sched.core.active() == 0 and sched.core.pending() == 0


def test_scheduler_eos_cancel_and_slot_reuse(both_params):
    _, tp = both_params
    sched = Scheduler(CFG, tp, max_batch=1, max_len=128)
    p = np.array([1, 2, 3], np.int32)
    u1 = sched.submit(p, max_new_tokens=2)
    u2 = sched.submit(p, max_new_tokens=2)
    u3 = sched.submit(p, max_new_tokens=2)
    assert sched.cancel(u3) and not sched.cancel(999)
    out = sched.run()
    assert set(out) == {u1, u2}
    assert out[u1] == out[u2] and len(out[u1]) == 2  # clean slot reuse
    first = out[u1][0]
    eos = Scheduler(CFG, tp, max_batch=1, max_len=128, eos_token=first)
    ue = eos.submit(p, max_new_tokens=8)
    assert eos.run()[ue] == [first]  # EOS on the first token ends it
    with pytest.raises(ValueError):
        eos.submit(np.zeros(120, np.int32), max_new_tokens=16)


def test_scheduler_sampling_uses_generator(both_params):
    _, tp = both_params
    p = np.array([4, 5, 6, 7], np.int32)
    outs = []
    for _ in range(2):
        sched = Scheduler(CFG, tp, max_batch=2, max_len=64, temperature=1.0,
                          top_k=8, generator=torch.Generator().manual_seed(3))
        u = sched.submit(p, max_new_tokens=6)
        g = sched.submit(p, max_new_tokens=6, temperature=0.0)
        outs.append(sched.run())
    assert outs[0] == outs[1]  # deterministic given the generator's seed
    greedy = Scheduler(CFG, tp, max_batch=1, max_len=64)
    ug = greedy.submit(p, max_new_tokens=6)
    assert outs[0][g] == greedy.run()[ug]  # a temperature-0 request is greedy
    assert len(outs[0][u]) == 6
    with pytest.raises(ValueError):
        Scheduler(CFG, tp, max_batch=1, max_len=64).submit(p, temperature=0.5)


@pytest.mark.parametrize(
    "mode",
    [dict(quantized_cache=True), dict(prefill_chunk=16), dict(mesh=object()),
     dict(seq_mesh=object()), dict(paged=True), dict(prefix_cache=True),
     dict(draft_cfg=CFG), dict(multi_step=4)],
)
def test_scheduler_unported_modes_raise(both_params, mode):
    _, tp = both_params
    with pytest.raises(NotImplementedError, match="ROADMAP item A"):
        Scheduler(CFG, tp, max_batch=2, max_len=64, **mode)


def _drive_core(core):
    log = [core.submit(10, 3), core.submit(100, 10), core.submit(70, 2),
           core.submit(5, 1)]
    log.append(core.fill())
    log.append(core.cancel(log[1]))
    for step in range(4):
        for slot in range(core.n_slots):
            if core.slot_uid(slot) >= 0:
                log.append((slot, core.on_token(slot, 7 + step, eos=9)))
        log.append(core.fill())
    log += [core.active(), core.pending(), core.bucket(130), core.bucket(1)]
    return log


def test_native_core_matches_python_fallback():
    assert scheduler_available()
    native = BatchSchedulerCore(2, 100)
    fallback = BatchSchedulerCore(2, 100, native=False)
    assert native.native and not fallback.native
    assert _drive_core(native) == _drive_core(fallback)


def test_with_retries_retries_only_transient_errors():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 2:
            raise RuntimeError("UNAVAILABLE: worker process crashed or restarted")
        return "ok"

    assert health.with_retries(flaky, cooldown_s=0.0) == "ok" and len(calls) == 2

    def cuda_fault():
        calls.append(1)
        raise RuntimeError("CUDA error: an illegal memory access (UNAVAILABLE)")

    calls.clear()
    with pytest.raises(RuntimeError):
        health.with_retries(cuda_fault, cooldown_s=0.0)
    assert len(calls) == 1  # a CUDA error is never retried
    assert not health.is_transient_error(ValueError("shape mismatch"))


def test_importing_the_port_leaves_jax_out():
    code = (
        "import sys\n"
        "import flashattention_kernel_project_tpu_torch as p\n"
        "import flashattention_kernel_project_tpu_torch.models.serving\n"
        "import flashattention_kernel_project_tpu_torch.models.convert\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('flashattention_kernel_project_tpu.')"
        " or m == 'flashattention_kernel_project_tpu']\n"
        "assert not bad, bad\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
