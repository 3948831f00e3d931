"""Continuous-batching serving scheduler over a linear KV cache.

Counterpart of flashattention_kernel_project_tpu/models/serving.py in its
default mode: a fixed decode batch of `max_batch` slots; new requests are
prefilled one at a time (prompt padded to a length bucket), spliced into a
free slot and decoded with the rest of the batch; a finished slot is freed
at once. Every decode step runs the whole batch: an empty slot has length 0
and the decode kernel gives it zeros. All scheduling decisions (admission
order, slot choice, budget/EOS finish, bucketing) live in the native core
(runtime/native.py).

The other modes of the JAX Scheduler raise NotImplementedError naming the
ROADMAP item that brings them.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable

import numpy as np
import torch

from flashattention_kernel_project_tpu_torch.models import engine
from flashattention_kernel_project_tpu_torch.models import transformer as tfm
from flashattention_kernel_project_tpu_torch.runtime.native import (
    BatchSchedulerCore,
)
from flashattention_kernel_project_tpu_torch.utils.health import with_retries


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray  # [T] int32
    max_new_tokens: int
    generated: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    temperature: float | None = None  # None -> the scheduler default
    # observability (seconds, time.perf_counter clock)
    t_submit: float = 0.0
    t_first_token: float = 0.0
    t_done: float = 0.0


@dataclasses.dataclass
class ServingMetrics:
    """Aggregate serving stats over the finished requests."""

    requests: int
    tokens: int
    wall_s: float
    tok_per_s: float
    ttft_s_mean: float      # submit -> first committed token
    ttft_s_p95: float
    latency_s_mean: float   # submit -> done
    latency_s_p95: float

    def __str__(self):
        return (
            f"{self.requests} req, {self.tokens} tok in {self.wall_s:.2f}s "
            f"= {self.tok_per_s:,.0f} tok/s | TTFT mean {self.ttft_s_mean*1e3:.0f}ms "
            f"p95 {self.ttft_s_p95*1e3:.0f}ms | latency mean "
            f"{self.latency_s_mean*1e3:.0f}ms p95 {self.latency_s_p95*1e3:.0f}ms"
        )


# mode -> the ROADMAP.md item that brings it to the port
_NOT_PORTED = {
    "quantized_cache": "A.7 (8-bit KV caches)",
    "prefill_chunk": "A.6 (ragged extend and chunked prefill)",
    "mesh": "A.9 (multi-device)",
    "seq_mesh": "A.9 (multi-device)",
    "paged": "A.8 (paged KV)",
    "prefix_cache": "A.8 (paged KV)",
    "draft_cfg": "A.6 (speculative decoding)",
    "multi_step": "A.6 (multi_step windows)",
}


class Scheduler:
    """Slot-based continuous batching over the KV-cache engine.

    Sampling (temperature > 0, per request or for the scheduler) draws from
    `generator`, a torch.Generator on the parameters' device; without one
    every request is greedy."""

    def __init__(
        self,
        cfg: tfm.TransformerConfig,
        params: dict,
        *,
        max_batch: int = 8,
        max_len: int = 2048,
        quantized_cache: bool = False,
        eos_token: int | None = None,
        n_splits: int | None = None,
        prefill_chunk: int | None = None,
        mesh=None,
        seq_mesh=None,
        paged: bool = False,
        prefix_cache: bool = False,
        draft_cfg: tfm.TransformerConfig | None = None,
        multi_step: int = 1,
        temperature: float = 0.0,
        top_k: int | None = None,
        top_p: float | None = None,
        generator: torch.Generator | None = None,
    ):
        requested = dict(
            quantized_cache=quantized_cache, prefill_chunk=prefill_chunk,
            mesh=mesh is not None, seq_mesh=seq_mesh is not None, paged=paged,
            prefix_cache=prefix_cache, draft_cfg=draft_cfg is not None,
            multi_step=multi_step > 1,
        )
        for mode, on in requested.items():
            if on:
                raise NotImplementedError(
                    f"Scheduler({mode}=...) is not ported: ROADMAP item "
                    f"{_NOT_PORTED[mode]}"
                )
        self.cfg = cfg
        self.params = params
        self.device = params["embed"].device
        self.max_len = max_len
        self.eos_token = eos_token
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self._generator = generator
        self.sampling = temperature > 0.0 and generator is not None
        # per-slot effective temperature (0 = greedy)
        self._slot_temp = np.zeros(max_batch, np.float32)
        self.cache = engine.init_cache(cfg, max_batch, max_len, self.device)
        self.slots: list[Request | None] = [None] * max_batch
        self.cur_tokens = np.zeros(max_batch, np.int32)
        self.finished: list[Request] = []
        self.core = BatchSchedulerCore(max_batch, max_len)
        self._callbacks: dict[int, Callable[[int, int, bool], None]] = {}
        self._requests: dict[int, Request] = {}
        self._decode_params = engine.fuse_decode_params(cfg, params)
        self._decode = functools.partial(
            engine.decode_step, cfg, n_splits=n_splits
        )
        self._wall_s = 0.0

    # ----------------------------------------------------------------- API
    def submit(
        self,
        prompt: np.ndarray,
        max_new_tokens: int = 32,
        on_token: Callable[[int, int, bool], None] | None = None,
        temperature: float | None = None,
    ) -> int:
        """Queue a request. on_token(uid, token, done) streams each token
        as it lands. temperature overrides the scheduler default for this
        request (needs a generator; 0 = greedy)."""
        prompt = np.asarray(prompt, np.int32)
        if temperature is not None and temperature > 0.0 and self._generator is None:
            raise ValueError("per-request temperature needs a generator")
        uid = self.core.submit(len(prompt), max_new_tokens)
        if uid < 0:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new ({max_new_tokens}) "
                f"exceeds capacity {self.max_len}"
            )
        self._requests[uid] = Request(
            uid, prompt, max_new_tokens, t_submit=time.perf_counter(),
            temperature=temperature,
        )
        if on_token is not None:
            self._callbacks[uid] = on_token
        return uid

    def cancel(self, uid: int) -> bool:
        """Abort a request: a pending one leaves the queue, a running one is
        evicted and its slot freed at once. Its partial output is dropped.
        Returns False for an unknown or finished uid."""
        rc = self.core.cancel(uid)
        if rc == 0:
            return False
        self._requests.pop(uid, None)
        self._callbacks.pop(uid, None)
        if rc == 2:
            for slot, req in enumerate(self.slots):
                if req is not None and req.uid == uid:
                    self.slots[slot] = None
                    self._release_slot(slot)
                    break
        return True

    def run(self) -> dict[int, list[int]]:
        """Drain all requests; returns {uid: generated tokens}."""
        t0 = time.perf_counter()
        while self.core.pending() or self.core.active():
            self._fill_slots()
            self._decode_once()
        self._wall_s += time.perf_counter() - t0
        return {r.uid: r.generated for r in self.finished}

    def metrics(self) -> ServingMetrics:
        """Aggregate stats over the requests finished so far."""
        fin = self.finished
        ttft = np.array([r.t_first_token - r.t_submit for r in fin])
        lat = np.array([r.t_done - r.t_submit for r in fin])
        toks = sum(len(r.generated) for r in fin)
        wall = self._wall_s
        return ServingMetrics(
            requests=len(fin),
            tokens=toks,
            wall_s=wall,
            tok_per_s=toks / wall if wall > 0 else 0.0,
            ttft_s_mean=float(ttft.mean()) if len(fin) else 0.0,
            ttft_s_p95=float(np.percentile(ttft, 95)) if len(fin) else 0.0,
            latency_s_mean=float(lat.mean()) if len(fin) else 0.0,
            latency_s_p95=float(np.percentile(lat, 95)) if len(fin) else 0.0,
        )

    # ------------------------------------------------------------ internals
    def _fill_slots(self):
        for uid, slot, bucket in self.core.fill():
            self._insert(slot, self._requests[uid], bucket)

    def _insert(self, slot: int, req: Request, tb: int):
        """Prefill the prompt as a batch-1 sequence padded to its bucket
        `tb`, splice its KV into the batch cache at `slot`, and record the
        first generated token."""
        t = len(req.prompt)
        prompt = np.zeros((1, tb), np.int32)
        prompt[0, :t] = req.prompt
        cache1 = engine.init_cache(self.cfg, 1, tb, self.device)
        logits, cache1 = with_retries(
            engine.prefill, self.cfg, self.params,
            torch.from_numpy(prompt).to(self.device), cache1,
        )
        # the padded tail cannot change position t-1 (causal), but prefill
        # returns the logits of position tb-1: recompute the true last
        # position when the prompt is shorter than its bucket
        if t != tb:
            logits = self._exact_last_logits(req.prompt)
        self._splice_linear(slot, cache1, tb, t)
        self.slots[slot] = req
        t_eff = req.temperature
        if t_eff is None:
            t_eff = self.temperature if self.sampling else 0.0
        self._slot_temp[slot] = t_eff
        first = int(self._pick(logits, temps=[t_eff])[0])
        self.cur_tokens[slot] = first
        req.generated.append(first)
        req.t_first_token = time.perf_counter()
        self._on_token(slot, first)

    def _splice_linear(self, slot: int, cache1: engine.KVCache, tb: int, t: int):
        """Copy the batch-1 cache's rows [0, tb) into the batch cache at
        `slot` (in place) and set the slot's length to t."""
        for big, small in zip(self.cache.k, cache1.k):
            big[slot, :, :tb] = small[0, :, :tb]
        for big, small in zip(self.cache.v, cache1.v):
            big[slot, :, :tb] = small[0, :, :tb]
        self.cache.lengths[slot] = t

    def _exact_last_logits(self, prompt: np.ndarray):
        tokens = torch.from_numpy(np.asarray(prompt, np.int32)[None, :])
        logits = tfm.forward(self.cfg, self.params, tokens.to(self.device))
        return logits[:, -1]

    def _decode_once(self):
        if not self.core.active():
            return
        tokens = torch.from_numpy(self.cur_tokens.copy()).to(self.device)
        logits, self.cache = with_retries(
            self._decode, self._decode_params, tokens, self.cache,
        )
        nxt = self._pick(logits)
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            tok = int(nxt[i])
            req.generated.append(tok)
            self.cur_tokens[i] = tok
            self._on_token(i, tok)

    def _pick(self, logits, temps=None) -> np.ndarray:
        """Per-slot greedy or temperature/top-k/top-p choice [B, V] -> [B]
        (host int32). temps: per-row temperatures (default: the slots');
        rows with temperature <= 0 take the argmax."""
        if temps is None:
            temps = self._slot_temp[: logits.shape[0]]
        temps = np.asarray(temps, np.float32)
        greedy = logits.argmax(dim=-1).to(torch.int32)
        if self._generator is None or not (temps > 0).any():
            return greedy.cpu().numpy()
        t = torch.from_numpy(temps).to(logits.device)
        scaled = logits / t.clamp(min=1e-6)[:, None]
        sampled = engine._sample(
            scaled, 1.0, self._generator, self.top_k, self.top_p,
        )
        return torch.where(t > 0, sampled, greedy).cpu().numpy()

    def _on_token(self, slot: int, token: int):
        """Report the token to the core; on finish, retire the request and
        zero the slot's length so the decode kernel masks it."""
        eos = -1 if self.eos_token is None else self.eos_token
        finished = self.core.on_token(slot, token, eos)
        req_now = self.slots[slot]
        cb = self._callbacks.get(req_now.uid) if req_now else None
        if cb is not None:
            cb(req_now.uid, token, finished)
        if finished:
            req = self.slots[slot]
            req.done = True
            req.t_done = time.perf_counter()
            self.finished.append(req)
            self.slots[slot] = None
            self._requests.pop(req.uid, None)
            self._callbacks.pop(req.uid, None)
            self._release_slot(slot)

    def _release_slot(self, slot: int):
        """Free a slot's device-side state (at retirement or cancel): zero
        its length so decode masks it. The slot keeps riding the batch
        decode, its length growing from 0; the cache write clamps at the
        buffer's end."""
        self._slot_temp[slot] = 0.0
        self.cache.lengths[slot] = 0
