"""Continuous-batching serving scheduler over a linear or a paged KV cache.

Counterpart of flashattention_kernel_project_tpu/models/serving.py: a fixed
decode batch of `max_batch` slots; new requests are prefilled one at a time,
put into a free slot and decoded with the rest of the batch; a finished slot
is freed at once. Every decode step runs the whole batch: an empty slot has
length 0 and the decode kernel gives it zeros. All scheduling decisions
(admission order, slot choice, budget/EOS finish, bucketing) live in the
native core (runtime/native.py).

Modes, as in the JAX Scheduler:
- default: a prompt padded to its length bucket runs through `prefill` into
  a batch-1 cache whose rows are copied into the slot's linear buffer;
- `prefill_chunk`: the prompt enters in chunks through the ragged `extend`,
  with a decode step of the live batch between chunks;
- `paged`: a shared page pool with per-slot block tables replaces the
  per-slot `max_len` buffers; pages are allocated at insert for the
  request's whole budget and recycled at retirement;
- `prefix_cache` (paged only): full prompt pages are indexed by a chained
  hash of their tokens; a request whose prompt starts with resident pages
  shares them (refcounted) and runs `extend` over its suffix only;
- `multi_step`: that many greedy (or scheduler-level sampled) decode steps
  per round, with the tokens past a slot's EOS or budget dropped and its
  length rolled back;
- speculative decoding (`draft_cfg`, `draft_params`, `spec_k`, linear or
  paged): each round the draft proposes spec_k tokens from its own linear
  cache and the target verifies them in one multi-token extend (`extend`
  or `extend_paged`); greedy slots commit exactly the target's greedy
  tokens, sampled slots go through the rejection rule;
- `quantized_cache`, with any of the above: the batch cache (linear or
  paged) is int8 with per-token scales, half the bytes of bf16. A linear
  cache's batch-1 prefill cache is int8 too and the splice carries its
  scales; a paged Scheduler prefills in full precision and the page
  scatter quantizes; a prefix hit dequantizes the shared pages into the
  suffix's linear cache. The draft keeps its full-precision cache;
- `mesh` (tensor parallel over `model_axis`, parallel/tp_engine.py): the
  parameters cut in the Megatron layout, the cache (linear or paged) cut
  over its KV heads, two all-reduces a layer; prefill always runs the
  chunked ragged `extend`. It composes with `paged` + `prefix_cache`,
  `multi_step`, speculative decoding (linear or paged) and
  `quantized_cache`; the draft stays whole on every rank;
- `seq_mesh` (sequence parallel over `seq_axis`): the linear cache (bf16 or
  8-bit) cut along its length, the parameters whole; prefill runs whole on
  every rank and each rank keeps only its key range; with `multi_step`
  too.

Over a mesh every rank runs its own Scheduler on its shards (torch.
distributed runs one process a rank where JAX runs one controller), with
the same submits in the same order. The logits are the same on every rank,
so every host decision (admission, slots, pages, prefix hits, argmax,
sampling from an identically seeded generator, speculative accepts) is too,
and run() returns the same tokens on every rank. The JAX Scheduler's walls
raise NotImplementedError with its messages. An MoE model serves over
`seq_mesh` (its parameters whole and split on every rank, its layers
routing the whole batch as on one device); `mesh` refuses it, the JAX
tensor-parallel engine having no MoE form.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import time
from typing import Callable

import numpy as np
import torch

from flashattention_kernel_project_tpu_torch.models import engine
from flashattention_kernel_project_tpu_torch.models import transformer as tfm
from flashattention_kernel_project_tpu_torch.ops.paged_decode import PagePool
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


def _host_filtered_probs(z, t, top_k, top_p):
    """numpy mirror of engine._sample's temperature, top-k and top-p
    filter: the probabilities its draw takes, [..., V] f32 logits ->
    float64 probabilities. These are the draft's proposal q and the
    target's p of the rejection rule."""
    z = np.asarray(z, np.float64) / float(t)
    v = z.shape[-1]
    use_k = top_k is not None and 0 < top_k < v
    use_p = top_p is not None and 0.0 < top_p < 1.0
    if use_k or use_p:
        sd = -np.sort(-z, axis=-1)
        if use_k:
            kth = sd[..., top_k - 1][..., None]
            z = np.where(z < kth, -np.inf, z)
        if use_p:
            if use_k:
                sd = np.where(np.arange(v) < top_k, sd, -np.inf)
            e = np.exp(sd - sd.max(-1, keepdims=True))
            probs = e / e.sum(-1, keepdims=True)
            cum = np.cumsum(probs, -1)
            keep = cum - probs < top_p
            cutoff = np.min(np.where(keep, sd, np.inf), axis=-1, keepdims=True)
            z = np.where(z < cutoff, -np.inf, z)
    z = z - z.max(-1, keepdims=True)
    e = np.exp(z)
    return e / e.sum(-1, keepdims=True)


class Scheduler:
    """Slot-based continuous batching over the KV-cache engine.

    Sampling (temperature > 0, per request or for the scheduler) draws from
    `generator`, a torch.Generator on the parameters' device; without one
    every request is greedy. With `draft_cfg` and `draft_params` the
    scheduler decodes speculatively, `spec_k` draft tokens a round. `mesh`
    (a DeviceMesh from parallel.make_mesh, cut over `model_axis`) or
    `seq_mesh` (over `seq_axis`) serve over a mesh; `params` are then the
    whole parameters on the rank's device, which the Scheduler shards."""

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
        model_axis: str = "model",
        seq_mesh=None,
        seq_axis: str = "sp",
        paged: bool = False,
        page_size: int = 128,
        n_pages: int | None = None,
        prefix_cache: bool = False,
        draft_cfg: tfm.TransformerConfig | None = None,
        draft_params: dict | None = None,
        spec_k: int = 4,
        multi_step: int = 1,
        temperature: float = 0.0,
        top_k: int | None = None,
        top_p: float | None = None,
        generator: torch.Generator | None = None,
    ):
        if seq_mesh is not None and (mesh is not None or paged):
            raise NotImplementedError(
                "seq_mesh (length-sharded cache) is a linear single-TP mode")
        if prefix_cache and not paged:
            raise ValueError("prefix_cache requires paged=True")
        # speculative decoding: the verify extend writes spec_k + 1 rows past
        # each slot's committed length, which admission reserves
        self.spec = draft_cfg is not None
        if self.spec:
            if multi_step > 1:
                raise NotImplementedError("multi_step: no spec composition")
            if seq_mesh is not None:
                raise NotImplementedError(
                    "speculative decoding: linear or paged cache (no seq_mesh)")
            if paged and quantized_cache and mesh is not None:
                raise NotImplementedError(
                    "speculative x paged x quantized x TP: the TP paged "
                    "verify is wired bf16-only (compose any three)")
            if draft_params is None:
                raise ValueError("draft_cfg needs draft_params")
            if draft_cfg.vocab_size != cfg.vocab_size:
                raise ValueError("the draft and the target need the same vocabulary")
        on_mesh = mesh is not None or seq_mesh is not None
        if (multi_step > 1 and on_mesh and temperature > 0.0
                and generator is not None):
            raise NotImplementedError(
                "multi_step sampling over a mesh: not wired (the mesh windows "
                "are greedy; single-device linear/paged sampling windows are "
                "supported)")
        if on_mesh:
            from flashattention_kernel_project_tpu_torch.parallel import (
                axis_group,
                axis_index,
                axis_size,
                shard_params,
                tp_engine,
            )

            if mesh is not None and cfg.moe_experts:
                raise NotImplementedError(
                    "Scheduler(mesh=): the tensor-parallel engine has no MoE "
                    "form (the JAX package's raises KeyError: 'w_gate' there); "
                    "serve an MoE model over seq_mesh=")
        self.cfg = cfg
        self.params = params
        self.device = params["embed"].device
        self.mesh = mesh
        # the config of this rank's caches and engine calls (TP: its heads
        # and d_ff) and the model axis' group the engine all-reduces over
        # (None on one device); the first global row of the rank's key
        # range (SP)
        self._lcfg, self._axis, self._seq_lo = cfg, None, 0
        if mesh is not None:
            self._lcfg = tp_engine.local_config(cfg,
                                                axis_size(mesh, model_axis))
            self._axis = axis_group(mesh, model_axis)
        self._steps = None  # the SP multi-step window
        self.max_len = max_len
        self.eos_token = eos_token
        self.n_splits = n_splits
        self.prefill_chunk = prefill_chunk
        self.paged = paged
        self.prefix_cache = prefix_cache
        self.multi_step = multi_step
        self.quantized_cache = quantized_cache
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self._generator = generator
        self.sampling = temperature > 0.0 and generator is not None
        # per-slot effective temperature (0 = greedy)
        self._slot_temp = np.zeros(max_batch, np.float32)
        if paged:
            # a shared page pool replaces the per-slot max_len buffers. Pages
            # are allocated at insert for the request's whole budget and
            # returned at retirement; n_pages below
            # max_batch * max_len / page_size + 1 bets that requests retire
            # early, and alloc raises MemoryError when the bet fails. Page 0
            # is the junk page: empty slots' block tables point at it, so
            # their masked decode appends land there.
            self._page = page_size
            self._pages_per_seq = -(-max_len // page_size)
            self._n_pages = n_pages or (max_batch * self._pages_per_seq + 1)
            self.cache = engine.init_paged_cache(
                self._lcfg, max_batch, self._n_pages, self.device,
                page_size=page_size, max_pages_per_seq=self._pages_per_seq,
                quantized=quantized_cache,
            )
            self._pool = PagePool(self._n_pages)
            self._slot_pages: list[list[int]] = [[] for _ in range(max_batch)]
            # prefix caching: full prompt pages keyed by a position-chained
            # hash; a prompt that starts with a resident chain shares those
            # pages (refcounted) and skips their prefill
            self._prefix_index: dict[bytes, int] = {}  # key -> page id
            self._page_refs: dict[int, int] = {}       # page id -> refs
            self._page_key: dict[int, bytes] = {}      # page id -> key
            self.prefix_hits = 0  # inserts that reused resident pages
            self._decode = functools.partial(engine.decode_step_paged,
                                             self._lcfg, axis=self._axis)
        elif seq_mesh is not None:
            self.cache = tp_engine.init_sp_cache(
                cfg, seq_mesh, max_batch, max_len, quantized=quantized_cache,
                seq_axis=seq_axis)
            self._seq_lo = (axis_index(seq_mesh, seq_axis)
                            * self.cache.k[0].shape[2])
        else:
            self.cache = engine.init_cache(self._lcfg, max_batch, max_len,
                                           self.device, quantized=quantized_cache)
            self._decode = functools.partial(
                engine.decode_step, self._lcfg, n_splits=n_splits,
                axis=self._axis,
            )
        if self.spec:
            # the draft keeps its own linear cache; its decode params are
            # fused once, its split params serve its prefill
            self.draft_cfg = draft_cfg
            self.spec_k = spec_k
            self.dcache = engine.init_cache(draft_cfg, max_batch, max_len,
                                            self.device)
            self._draft_split_params = draft_params
            self._draft_params = engine.fuse_decode_params(draft_cfg,
                                                           draft_params)
            # acceptance: tokens committed by verify rounds, over the live
            # slots those rounds verified (1 to spec_k + 1 a slot-round)
            self.spec_committed = 0
            self.spec_slot_rounds = 0
        self.slots: list[Request | None] = [None] * max_batch
        self.cur_tokens = np.zeros(max_batch, np.int32)
        self.finished: list[Request] = []
        # a spec round or a multi_step window writes up to spec_k + 1 or
        # multi_step rows past the committed length before the host sees EOS
        # or the budget: reserve them
        self._reserve = (spec_k + 1 if self.spec
                         else multi_step if multi_step > 1 else 0)
        self.core = BatchSchedulerCore(max_batch, max_len - self._reserve)
        self._callbacks: dict[int, Callable[[int, int, bool], None]] = {}
        self._requests: dict[int, Request] = {}
        if mesh is not None:
            # the rank's shards of the parameters, in the split layout (its
            # decode too)
            self.params = self._decode_params = shard_params(
                params, mesh, tfm.param_shardings(cfg, model_axis=model_axis))
        elif seq_mesh is not None:
            # the parameters stay whole and split, as JAX's SP step takes them
            self._decode_params = params
            self._decode = tp_engine.make_sp_decode_step(
                cfg, seq_mesh, seq_axis=seq_axis, n_splits=n_splits)
            if multi_step > 1:
                self._steps = tp_engine.make_sp_decode_steps(
                    cfg, seq_mesh, n_steps=multi_step, seq_axis=seq_axis,
                    n_splits=n_splits)
        else:
            self._decode_params = engine.fuse_decode_params(cfg, params)
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
        if temperature is not None and temperature > 0.0:
            if self._generator is None:
                raise ValueError("per-request temperature needs a generator")
            if self.multi_step > 1:
                raise ValueError(
                    "multi_step: per-request temperature overrides are not "
                    "supported (scheduler-level sampling is)"
                )
        uid = self.core.submit(len(prompt), max_new_tokens)
        if uid < 0:
            extra = (
                f" (= max_len {self.max_len} minus {self._reserve} scratch "
                f"rows reserved by spec/multi_step)" if self._reserve else ""
            )
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new ({max_new_tokens}) "
                f"exceeds capacity {self.max_len - self._reserve}{extra}"
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
        """Prefill the prompt as a batch-1 sequence (bucket `tb`), move its
        KV into the batch cache at `slot`, and record the first generated
        token.

        With `prefill_chunk` set, the prompt enters in chunks through the
        ragged `extend` (n= gathers the logits at the last real position, so
        they are exact for a padded chunk), with a decode step of the live
        batch between chunks: a long prompt stalls the batch for one chunk
        at a time. A prompt whose leading full pages are resident in the
        prefix cache runs `extend` over its suffix only."""
        t = len(req.prompt)
        shared: list[int] = []
        keys: list[bytes] = []
        if self.prefix_cache:
            shared, keys = self._match_prefix(req.prompt)
            # hold the shared pages from here: a decode step between the
            # suffix's chunks may retire their other holders
            for pid in shared:
                self._page_refs[pid] += 1
        try:
            logits, cache1 = self._prefill_prompt(req, tb, shared)
            if self.paged:
                self._insert_pages(slot, req, cache1, t, shared, keys)
            else:
                self._splice_linear(slot, cache1, tb, t)
        except BaseException:
            # a failed insert (the prefill, or alloc's MemoryError) keeps
            # no page: drop the references it took, shared and new
            if self.paged:
                self._drop_refs(self._slot_pages[slot] or shared)
                self._slot_pages[slot] = []
                self.cache.block_tables[slot] = 0
            raise
        if self.spec:
            # the draft's prompt logits are never used, only its K/V rows,
            # and rows [0, t) of a bucket-padded one-shot prefill are exact
            dprompt = np.zeros((1, tb), np.int32)
            dprompt[0, :t] = req.prompt
            dcache1 = engine.init_cache(self.draft_cfg, 1, tb, self.device)
            _, dcache1 = engine.prefill(
                self.draft_cfg, self._draft_split_params,
                torch.from_numpy(dprompt).to(self.device), dcache1)
            self._splice_linear(slot, dcache1, tb, t, into=self.dcache)
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

    def _prefill_prompt(self, req: Request, tb: int, shared: list[int]):
        """The prompt's (last-position logits, batch-1 cache): the suffix
        after the resident `shared` pages, chunks of `prefill_chunk`, or
        one prefill of the prompt padded to its bucket `tb`."""
        if shared:
            self.prefix_hits += 1
            return self._chunked_prefill(req, tb, prefix_pages=shared)
        if self.prefill_chunk or self.mesh is not None:
            # over a TP mesh prefill always takes the ragged extend
            return self._chunked_prefill(req, tb)
        t = len(req.prompt)
        prompt = np.zeros((1, tb), np.int32)
        prompt[0, :t] = req.prompt
        cache1 = self._init_cache1(tb)
        logits, cache1 = with_retries(
            engine.prefill, self.cfg, self.params,
            torch.from_numpy(prompt).to(self.device), cache1,
        )
        # the padded tail cannot change position t-1 (causal), but prefill
        # returns the logits of position tb-1: recompute the true last
        # position when the prompt is shorter than its bucket
        if t != tb:
            logits = self._exact_last_logits(req.prompt)
        return logits, cache1

    def _init_cache1(self, rows: int) -> engine.KVCache:
        """A batch-1 prefill cache of `rows` rows: 8-bit over a linear 8-bit
        batch cache (the splice copies values and scales); full precision
        over a page pool, whose page scatter quantizes. Over a TP mesh it
        holds the rank's KV heads."""
        return engine.init_cache(self._lcfg, 1, rows, self.device,
                                 quantized=self.quantized_cache and not self.paged)

    def _splice_linear(self, slot: int, cache1: engine.KVCache, tb: int, t: int,
                       into: engine.KVCache | None = None):
        """Copy the batch-1 cache's rows [0, tb) into the batch cache at
        `slot` (in place; `into` another linear cache, the draft's) and set
        the slot's length to t. An 8-bit cache's scales go with them. Over
        a seq_mesh the batch cache holds the rank's key range, and only the
        rows in it are copied."""
        target = self.cache if into is None else into
        lo = self._seq_lo if into is None else 0
        hi = min(tb, lo + target.k[0].shape[2])
        pairs = [(target.k, cache1.k), (target.v, cache1.v)]
        if target.quantized:
            pairs += [(target.k_scale, cache1.k_scale),
                      (target.v_scale, cache1.v_scale)]
        for bigs, smalls in pairs:
            for big, small in zip(bigs, smalls):
                big[slot, :, :max(hi - lo, 0)] = small[0, :, lo:hi]
        target.lengths[slot] = t

    def _match_prefix(self, prompt: np.ndarray):
        """The longest chain of resident full prompt pages. Returns (their
        page ids, the chained keys of every full prompt page). A key hashes
        the page's tokens after the previous page's key, so a page matches
        only at the same absolute positions (its K rows carry RoPE
        positions). A page-aligned prompt never matches its last page: the
        suffix extend needs at least one token to give the first logits."""
        page = self._page
        t = len(prompt)
        n_full = t // page
        keys: list[bytes] = []
        prev = b""
        for j in range(n_full):
            h = hashlib.blake2b(digest_size=16)
            h.update(prev)
            h.update(np.ascontiguousarray(prompt[j * page:(j + 1) * page]))
            prev = h.digest()
            keys.append(prev)
        shared: list[int] = []
        for j in range(min(n_full, (t - 1) // page)):
            pid = self._prefix_index.get(keys[j])
            if pid is None:
                break
            shared.append(pid)
        return shared, keys

    def _insert_pages(self, slot: int, req: Request, cache1, t: int,
                      shared: list[int], keys: list[bytes]):
        """Allocate pages for the request's whole budget (the shared prefix
        pages, already held by `_insert`, count), copy the prefilled rows
        past them into the new pages, install the block table, and index the
        request's own full prompt pages."""
        # + reserve: a multi_step window appends up to `reserve` rows past
        # the budget before the host drops them; they must land in this
        # slot's own pages, not on the junk page
        n_total = -(-(t + req.max_new_tokens + self._reserve) // self._page)
        new_pages = self._pool.alloc(n_total - len(shared))
        for pid in new_pages:
            self._page_refs[pid] = 1
        pages = list(shared) + new_pages
        self._slot_pages[slot] = pages
        row = self._pool.table_for(pages, self._pages_per_seq)
        k_seq = [k[0, :, :t] for k in cache1.k]
        v_seq = [v[0, :, :t] for v in cache1.v]
        engine.paged_insert(self.cache, slot, row, k_seq, v_seq, t,
                            start_page=len(shared))
        if self.prefix_cache:
            # the tail's partial page and generated tokens' pages are never
            # shared; a key already indexed keeps its page, this one stays
            # private
            for j in range(len(shared), t // self._page):
                if keys[j] not in self._prefix_index:
                    self._prefix_index[keys[j]] = pages[j]
                    self._page_key[pages[j]] = keys[j]

    def _chunked_prefill(self, req: Request, tb: int, prefix_pages=None):
        """Feed the prompt through the ragged `extend` in chunks of
        `prefill_chunk` tokens against a batch-1 cache, decoding the live
        batch between chunks. The cache has tb + C rows: the last chunk's
        padded tail still writes C - n rows past the prompt. With
        `prefix_pages`, the cache starts as their rows and only the suffix
        runs."""
        c = min(self.prefill_chunk or tb, tb)
        t = len(req.prompt)
        if prefix_pages:
            s = len(prefix_pages) * self._page
            cache1 = engine.cache_from_pages(self._lcfg, self.cache,
                                             prefix_pages, s, tb + c)
        else:
            s = 0
            cache1 = self._init_cache1(tb + c)
        logits = None
        for j0 in range(s, t, c):
            nj = min(c, t - j0)
            chunk = np.zeros((1, c), np.int32)
            chunk[0, :nj] = req.prompt[j0:j0 + nj]
            n = torch.full((1,), nj, dtype=torch.int32, device=self.device)
            tokens = torch.from_numpy(chunk).to(self.device)
            logits, cache1 = with_retries(functools.partial(
                engine.extend, self._lcfg, self.params, tokens, cache1, n=n,
                axis=self._axis))
            if j0 + nj < t:
                self._decode_once()
        return logits, cache1

    def _exact_last_logits(self, prompt: np.ndarray):
        tokens = torch.from_numpy(np.asarray(prompt, np.int32)[None, :])
        logits = tfm.forward(self.cfg, self.params, tokens.to(self.device))
        return logits[:, -1]

    def _decode_once(self):
        if not self.core.active():
            return
        if self.spec:
            return self._spec_round()
        if self.multi_step > 1:
            return self._multi_step_round()
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

    def _spec_round(self):
        """One speculative round over the live batch: spec_k + 1 draft
        decode steps propose spec_k tokens, one target extend over
        [cur, d_1..d_k] (`extend(all_logits=True)`, or `extend_paged` on the
        page pool) verifies every slot, and each slot commits its accepted
        prefix and the target's correction or bonus token. Rollback is the
        lengths vector: K/V past a slot's accepted prefix is dead and later
        rounds overwrite it. An EOS or a spent budget in mid-round retires
        the slot and drops the rest of its round; empty slots go back to
        length 0."""
        k = self.spec_k
        cur = torch.from_numpy(self.cur_tokens.copy()).to(self.device)
        temps = self._slot_temp[:len(self.slots)]
        any_sampled = bool((temps > 0).any()) and self._generator is not None
        draft = functools.partial(engine.decode_step, self.draft_cfg,
                                  self._draft_params)
        dl, self.dcache = with_retries(draft, cur, self.dcache)
        drafts, dl_steps = [], []  # sampled slots need q, the draft's dist
        for _ in range(k):
            if any_sampled:
                dl_steps.append(dl.float().cpu().numpy())
                # greedy rows take the argmax, sampled rows draw from the
                # filtered softmax(logits / temperature): the q used below
                d_j = torch.from_numpy(self._pick(dl)).to(self.device)
            else:
                d_j = dl.argmax(dim=-1).to(torch.int32)
            drafts.append(d_j)
            dl, self.dcache = with_retries(draft, d_j, self.dcache)
        d = torch.stack(drafts, dim=1)                    # [B, k]
        chunk = torch.cat([cur[:, None], d], dim=1)       # [B, k+1]
        old_len = self.cache.lengths.cpu().numpy().copy()
        if self.paged:
            verify = functools.partial(engine.extend_paged, self._lcfg,
                                       self.params, chunk, self.cache,
                                       axis=self._axis)
        else:
            verify = functools.partial(engine.extend, self._lcfg, self.params,
                                       chunk, self.cache, all_logits=True,
                                       axis=self._axis)
        all_l, self.cache = with_retries(verify)
        d_np = d.cpu().numpy()
        greedy = engine.greedy_accept(
            all_l.argmax(dim=-1).to(torch.int32).cpu().numpy(), d_np)
        if any_sampled:
            # a host rng for the rejection rule, drawn from the generator
            # each round: the run is deterministic given its seed
            host_rng = engine.host_rng_from(self._generator)
            all_np = all_l.float().cpu().numpy()    # [B, k+1, V]
            dq_np = np.stack(dl_steps, axis=1)      # [B, k, V]

        new_len = old_len.copy()
        for i, req in enumerate(self.slots):
            if req is None:
                new_len[i] = 0  # an empty slot: undo the extend's advance
                continue
            if any_sampled and temps[i] > 0:
                # the rejection rule with p the target's and q the draft's
                # filtered distributions: the committed tokens are
                # distributed as target-only sampling for this slot
                p_i = _host_filtered_probs(all_np[i], temps[i], self.top_k,
                                           self.top_p)
                q_i = _host_filtered_probs(dq_np[i], temps[i], self.top_k,
                                           self.top_p)
                take = engine.speculative_accept(p_i, q_i, d_np[i], host_rng)
            else:
                take = greedy[i]
            committed = 0
            for tok in take:
                committed += 1
                req.generated.append(tok)
                self.cur_tokens[i] = tok
                self._on_token(i, tok)
                if self.slots[i] is None:
                    break  # retired mid-round: drop the rest
            new_len[i] = 0 if self.slots[i] is None else old_len[i] + committed
            self.spec_committed += committed
            self.spec_slot_rounds += 1
        lengths = torch.from_numpy(new_len)
        self.cache.lengths.copy_(lengths)
        # the draft consumed [cur, d_1..d_k]: resync it to the target's view
        self.dcache.lengths.copy_(lengths)

    def _multi_step_round(self):
        """multi_step decode steps in one call (engine.decode_steps or
        decode_steps_paged), with no host round trip between them. Tokens a
        slot produced past its EOS or budget are dropped and its length
        rolled back. Scheduler-level sampling runs inside the steps."""
        m = self.multi_step
        old_len = self.cache.lengths.cpu().numpy().copy()
        samp = dict(temperature=self.temperature, generator=self._generator,
                    top_k=self.top_k, top_p=self.top_p) if self.sampling else {}
        tokens = torch.from_numpy(self.cur_tokens.copy()).to(self.device)
        if self._steps is not None:
            step_fn = functools.partial(self._steps, self._decode_params,
                                        tokens, self.cache)
        elif self.paged:
            step_fn = functools.partial(
                engine.decode_steps_paged, self._lcfg, self._decode_params,
                tokens, self.cache, n_steps=m, axis=self._axis, **samp)
        else:
            step_fn = functools.partial(
                engine.decode_steps, self._lcfg, self._decode_params, tokens,
                self.cache, n_steps=m, n_splits=self.n_splits,
                axis=self._axis, **samp)
        toks, self.cache = with_retries(step_fn)
        toks = toks.cpu().numpy()
        new_len = old_len.copy()
        for i, req in enumerate(self.slots):
            if req is None:
                new_len[i] = 0  # an empty slot: undo the window's advance
                continue
            committed = 0
            for j in range(m):
                committed += 1
                tok = int(toks[i, j])
                req.generated.append(tok)
                self.cur_tokens[i] = tok
                self._on_token(i, tok)
                if self.slots[i] is None:
                    break  # retired mid-window: drop the rest
            new_len[i] = 0 if self.slots[i] is None else old_len[i] + committed
        self.cache.lengths.copy_(torch.from_numpy(new_len))

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
        its length so decode masks it, and recycle its pages. The slot keeps
        riding the batch decode, its length growing from 0; a linear cache
        write clamps at the buffer's end, a paged one lands on the junk
        page."""
        self._slot_temp[slot] = 0.0
        self.cache.lengths[slot] = 0
        if self.paged:
            # drop this slot's references, then point the table at the junk
            # page, so that the slot's appends never land in pages another
            # request owns
            self._drop_refs(self._slot_pages[slot])
            self._slot_pages[slot] = []
            self.cache.block_tables[slot] = 0

    def _drop_refs(self, pids: list[int]):
        """Drop one reference on each page; free the pages nobody holds any
        more, and unindex them."""
        dead = []
        for pid in pids:
            self._page_refs[pid] -= 1
            if self._page_refs[pid] == 0:
                dead.append(pid)
                del self._page_refs[pid]
                key = self._page_key.pop(pid, None)
                if key is not None:
                    self._prefix_index.pop(key, None)
        self._pool.free(dead)
