#!/usr/bin/env python3
"""Where an MoE model's cached decode and its full forward part, and what
makes chip_smoke.py's trained MoE weights differ from run to run.

    python3 tools/moe_repro.py

1. The native TokenLoader (runtime/data.py, shuffle=True, two prefetch
   threads) opened six times with seed 0 on one token file: whether each
   gives the first one's seven batches in the same order (on the CPU too).
2. On a CUDA card, bench_train.py --moe-experts 8's model (chip_smoke.py's
   MOE_TRAIN, bf16, TF32 off) from its seed-0 weights: the gradients of
   one batch taken twice, and 5 SGD steps over seeded batches taken twice,
   each compared bit for bit.
3. chip_smoke.py's phase_consistency on the seed-0 weights (capacity factor
   E / top_k) with the forward left to route by itself (its per-step
   rel-L2, which its gate then refuses), and as chip_smoke.py runs it,
   the forward taking the decode's experts where they differ (RoutePin).

Prints one line a result, each with the card's name and power limit.
Exits 1 if the pinned consistency fails.
"""

import dataclasses
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402


def loader_orders():
    from flashattention_kernel_project_tpu_torch.runtime.data import (
        TokenLoader,
        write_token_file,
    )

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tokens.bin")
        write_token_file(path, np.random.default_rng(0).integers(0, 32000, 2_000_000))
        runs = []
        for _ in range(6):
            with TokenLoader(path, cs.TRAIN_BATCH, cs.TRAIN_SEQ, seed=0,
                             native=True) as loader:
                runs.append([loader.next_batch().copy() for _ in range(7)])
    same = [all(np.array_equal(a, b) for a, b in zip(runs[0], r)) for r in runs[1:]]
    print(f"TokenLoader(seed=0, native, 2 threads) x 6: the first's batch order "
          f"repeated by {sum(same)} of 5 ({same})", flush=True)


def main() -> int:
    loader_orders()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: parts 2 and 3 need one", file=sys.stderr)
        return 2
    from flashattention_kernel_project_tpu_torch.models import transformer as tfm
    from flashattention_kernel_project_tpu_torch.ops import _build
    from flashattention_kernel_project_tpu_torch.utils import platform

    _build.library()
    label = platform.card_label()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tfm.TransformerConfig(**cs.MOE_TRAIN, dtype=torch.bfloat16)

    def init():
        return tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)

    def batch(gen):
        return torch.randint(0, cfg.vocab_size, (cs.TRAIN_BATCH, cs.TRAIN_SEQ),
                             generator=gen, device=dev, dtype=torch.int32)

    def equal(a, b):
        return all(torch.equal(x, y) for x, y in
                   zip(tfm._leaves(a).values(), tfm._leaves(b).values()))

    p0 = init()
    toks = batch(torch.Generator(device=dev).manual_seed(5))

    def grads():
        flat = {k: x.detach().requires_grad_(True)
                for k, x in tfm._leaves(p0).items()}
        with torch.enable_grad():
            loss = tfm.loss_fn(cfg, tfm._unflatten(flat), toks)
            return tfm._unflatten(dict(zip(
                flat, torch.autograd.grad(loss, list(flat.values())))))

    def train(steps=5):
        p, gen = p0, torch.Generator(device=dev).manual_seed(7)
        for _ in range(steps):
            p, _ = tfm.sgd_train_step(cfg, p, batch(gen), cs.TRAIN_LR)
        return p

    print(f"MoE step from the seed-0 weights: gradients twice bit-equal "
          f"{equal(grads(), grads())}; 5 steps twice bit-equal "
          f"{equal(train(), train())} [{label}]", flush=True)

    ccfg = dataclasses.replace(cfg, moe_capacity_factor=cfg.moe_experts / cfg.moe_top_k)
    pinned = cs.moe_choices
    cs.moe_choices = lambda pin=None: pinned(None)  # the forward routes itself
    try:
        cs.phase_consistency(dev, ccfg, p0, n_prompt=128, n_steps=16, label=label,
                             what=" (MoE, seed-0 weights, forward unpinned)")
        print("unpinned: within the gate", flush=True)
    except AssertionError as e:
        print(f"unpinned: {e}", flush=True)
    finally:
        cs.moe_choices = pinned
    cs.phase_consistency(dev, ccfg, p0, n_prompt=128, n_steps=16, label=label,
                         what=" (MoE, seed-0 weights)")
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except AssertionError as e:
        print(f"FAILED: {e}", file=sys.stderr)
        sys.exit(1)
