"""Continuous-batching serving over the paged KV cache — port of
``paddle_tpu/inference/serving.py`` with its synchronous engine.

Every scheduler round packs ONE unified step (``models/gpt.py
build_unified_step``) over a per-step token budget:

- every running slot with exactly one context token left to feed is a
  DECODE lane — those pack first, one token each;
- the remaining budget fills with PREFILL CHUNKS (FIFO by request age, up
  to ``chunk`` tokens per slot per step) from admitting or
  preemption-replaying requests;
- a chunk that reaches the end of its context yields that slot's next
  token (greedy argmax, or the seeded temperature / top-k / top-p
  epilogue).

Admission matches the prompt against the page-granular prefix registry
(``KVCacheManager.admit_prefix``) and skips the prefill of every hit page;
prompts register their pages as their chunks land. Writes into a shared
page ride the step's copy-on-write lanes. Capacity pressure preempts the
YOUNGEST running request back to the queue (recompute mode); its replay
re-hits its own registered pages.

The scheduling code is the reference's, so on the same weights and
prompts the port and the reference's synchronous engine
(``async_engine=False``) allocate the same pages and emit the same greedy
tokens. Not ported here: the async dispatch-ahead engine
(``async_engine=True`` raises), the legacy two-program path, SLO
shedding, deadlines and fault injection; config flags of speculation,
quantized KV or weights, the mega kernels and MoE raise.
"""
from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

from .._device import resolve_device
from ..observability import MetricsRegistry
from ..ops.paged_attention import CHUNK_DEFAULT, PAGE_SIZE_DEFAULT
from .kv_cache import KVCacheManager, pages_needed

WAITING, RUNNING, FINISHED, FAILED = ("waiting", "running", "finished",
                                      "failed")
MAX_STEP_RETRIES = 3   # requeues of a lane that cannot grow before it fails


def stream_done(output_ids, max_new_tokens, eos_token_id) -> bool:
    """The budget/eos stop rule over a materialized output stream."""
    if len(output_ids) >= max_new_tokens:
        return True
    return (eos_token_id is not None and bool(output_ids)
            and output_ids[-1] == eos_token_id)


class Request:
    """One generation request; ``output_ids`` fills as steps land."""

    _next_id = [0]

    def __init__(self, prompt_ids, max_new_tokens=32, eos_token_id=None,
                 temperature=0.0, top_k=0, top_p=1.0, seed=None):
        self.req_id = Request._next_id[0]
        Request._next_id[0] += 1
        self.prompt_ids = [int(t) for t in np.asarray(prompt_ids).reshape(-1)]
        if not self.prompt_ids:
            raise ValueError("empty prompt")
        self.max_new_tokens = int(max_new_tokens)
        self.eos_token_id = eos_token_id
        self.error: dict | None = None
        self.retry_count = 0
        # temperature == 0 -> greedy argmax; the seed defaults to the
        # request id so a preemption replay re-samples the SAME stream
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.seed = self.req_id if seed is None else int(seed)
        self.output_ids: list[int] = []
        self.state = WAITING
        self.preempt_count = 0
        self.truncated = False  # stopped by the max_seq_len ceiling
        self.submit_time = time.monotonic()
        self.first_token_time: float | None = None
        self.cached_prefix_len = 0
        self._registered = False     # prompt pages in the prefix registry

    @property
    def done(self) -> bool:
        return self.truncated or stream_done(
            self.output_ids, self.max_new_tokens, self.eos_token_id)

    @property
    def _ctx_len(self) -> int:
        return len(self.prompt_ids) + len(self.output_ids)

    @property
    def ttft(self) -> float | None:
        """Seconds from submission to the first generated token."""
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.submit_time

    def _context_ids(self) -> list[int]:
        """Prompt + generated-so-far — what a replay after preemption
        re-prefills."""
        return self.prompt_ids + self.output_ids


class ServingPredictor:
    """Continuous-batching predictor for a GPT model (synchronous engine).

    ``add_request`` enqueues; ``step`` runs one scheduler round (retire /
    admit / grow / preempt around ONE unified-step launch, then lands its
    tokens); ``generate`` drives ``step`` until a set of prompts finishes.
    The model's weights are stacked once (``serving_params``), cast to
    ``dtype`` when given, and moved to ``device`` (``None`` = ``cuda:0``).
    """

    def __init__(self, model, *, max_batch=8, num_pages=None, page_size=None,
                 dtype=None, chunk=None, async_engine=None, device=None):
        from ..models.gpt import build_unified_step, serving_params

        gpt = model.gpt if hasattr(model, "gpt") else model
        self.config = cfg = gpt.config
        if async_engine:
            raise NotImplementedError(
                "the async dispatch-ahead engine is a later port slice; "
                "async_engine=None/False runs the synchronous engine")
        self.device = resolve_device(device)
        self.metrics = MetricsRegistry()
        self._init_instruments()
        params = serving_params(model)

        def place(t):
            return t.to(device=self.device,
                        dtype=dtype if dtype is not None else t.dtype)

        self.params = {k: (place(v) if k != "layers"
                           else {n: place(w) for n, w in v.items()})
                       for k, v in params.items()}
        self.max_seq_len = cfg.max_seq_len
        self.max_batch = int(max_batch)
        page_size = int(page_size or PAGE_SIZE_DEFAULT)
        if num_pages is None:
            # default pool: every lane can reach max_seq_len
            num_pages = self.max_batch * pages_needed(self.max_seq_len,
                                                      page_size)
        self.chunk = int(chunk or CHUNK_DEFAULT)
        # config flags of unported paths (quantized KV, speculation, mega
        # kernels, MoE, quantized weights) raise here
        self._unified = build_unified_step(
            cfg, page_size, self.chunk, kv_quant=bool(cfg.kv_cache_dtype),
            spec_k=cfg.spec_decode_k, mega=cfg.mega_decode)
        self.cache = KVCacheManager(
            cfg.num_layers, cfg.num_heads, cfg.head_dim,
            num_pages=num_pages, max_batch=self.max_batch,
            max_seq_len=self.max_seq_len, page_size=page_size,
            dtype=self.params["tok_emb"].dtype, enable_prefix_cache=True,
            metrics=self.metrics, device=self.device)
        self.token_budget = self.max_batch + self.chunk
        self.waiting: deque[Request] = deque()
        self.running: dict[int, Request] = {}   # slot -> request
        b, t = self.max_batch, self.token_budget
        self._zeros_t = torch.zeros((t,), dtype=torch.int32,
                                    device=self.device)
        self._zeros_b = torch.zeros((b,), dtype=torch.int32,
                                    device=self.device)

    def _init_instruments(self):
        m = self.metrics
        self._m_steps = m.counter(
            "serving_steps", "scheduler rounds that dispatched a step")
        self._m_tokens = m.counter(
            "serving_tokens_emitted", "tokens emitted")
        self._m_preempt = m.counter(
            "serving_preemptions", "requests preempted back to the queue")
        self._m_admitted = m.counter(
            "serving_requests_admitted", "admissions incl. replay")
        self._m_finished = m.counter(
            "serving_requests_finished", "requests reaching FINISHED")
        self._m_failed = m.counter(
            "serving_requests_failed", "requests reaching terminal FAILED")
        self._m_fail_reasons = m.counter(
            "serving_fail_reasons", "terminal failures by error code",
            labels=("reason",))
        self._m_retries = m.counter(
            "serving_step_retries", "lane requeues after a failed step")
        self._m_step_s = m.counter(
            "serving_step_seconds", "host wall seconds inside step()")
        self._m_ttft = m.histogram(
            "serving_ttft_ms", "submit -> first generated token",
            buckets=(1, 2, 5, 10, 25, 50, 100, 250, 1000, 5000))
        self._m_running = m.gauge(
            "serving_running_lanes", "slots in RUNNING after a step")
        self._m_waiting = m.gauge(
            "serving_waiting_requests", "queued requests after a step")

    # -- read surface ------------------------------------------------------

    @property
    def steps(self) -> int:
        return int(self._m_steps.value)

    @property
    def tokens_emitted(self) -> int:
        return int(self._m_tokens.value)

    @property
    def decode_trace_count(self) -> int:
        """Builds of the serving step (one per predictor)."""
        return self._unified.trace_count

    @property
    def prefix_hit_rate(self) -> float:
        return self.cache.prefix_hit_rate

    def telemetry(self) -> dict[str, float]:
        """Flat snapshot of the serving-stack registry (predictor + KV
        cache instruments)."""
        return self.metrics.snapshot_flat()

    # -- queue API ---------------------------------------------------------

    def add_request(self, prompt_ids, max_new_tokens=32, eos_token_id=None,
                    temperature=0.0, top_k=0, top_p=1.0, seed=None) -> Request:
        req = Request(prompt_ids, max_new_tokens, eos_token_id,
                      temperature=temperature, top_k=top_k, top_p=top_p,
                      seed=seed)
        if len(req.prompt_ids) > self.max_seq_len:
            raise ValueError(
                f"prompt of {len(req.prompt_ids)} tokens exceeds "
                f"max_seq_len {self.max_seq_len}")
        self.waiting.append(req)
        return req

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    # -- lifecycle ---------------------------------------------------------

    def _preempt_youngest(self) -> None:
        """Free the youngest running request back to the waiting queue."""
        slot = max(self.running, key=lambda s: self.running[s].req_id)
        req = self.running.pop(slot)
        self.cache.free(slot)
        req.state = WAITING
        req.preempt_count += 1
        req._registered = False   # fresh pages on replay; re-register
        self.waiting.appendleft(req)
        self._m_preempt.inc()

    def _finish(self, req: Request) -> None:
        req.state = FINISHED
        self._m_finished.inc()

    def _fail(self, req: Request, code: str, message) -> None:
        """Terminal FAILED with an error record; the caller has released
        the request's slot and pages."""
        req.state = FAILED
        req.error = {"code": code, "message": str(message)[:300]}
        self._m_failed.inc()
        self._m_fail_reasons.labels(reason=code).inc()

    def _requeue_one(self, slot: int, exc, code: str) -> None:
        """Send a lane that cannot grow back through the replay path;
        past ``MAX_STEP_RETRIES`` such requeues the request FAILS."""
        req = self.running.pop(slot)
        self.cache.free(slot)
        if req.done:
            self._finish(req)    # nothing left to replay
            return
        req._registered = False
        req.retry_count += 1
        if req.retry_count > MAX_STEP_RETRIES:
            self._fail(req, code, f"step failed {req.retry_count} times "
                                  f"over this request; last: {exc!r}")
            return
        req.state = WAITING
        self._m_retries.inc()
        self.waiting.appendleft(req)

    def _retire_finished(self) -> None:
        for slot in [s for s, r in self.running.items() if r.done]:
            req = self.running.pop(slot)
            self.cache.free(slot)
            self._finish(req)

    def _admit_waiting(self) -> None:
        while self.waiting and self.cache.free_slot_count:
            req = self.waiting[0]
            if req.done:
                self.waiting.popleft()
                self._finish(req)
                continue
            if req._ctx_len > self.max_seq_len:
                # preempted while sitting at the length ceiling
                self.waiting.popleft()
                req.truncated = True
                self._finish(req)
                continue
            # vLLM-style watermark: with others running keep one free page
            # of growth headroom
            hit = self.cache.admit_prefix(
                req._context_ids(), headroom=1 if self.running else 0,
                soft=True)
            if hit is None:
                if (not self.running and self.cache.available_page_count
                        == self.cache.num_pages):
                    # can NEVER fit: fail it, keep admitting behind it
                    self.waiting.popleft()
                    need = self.cache.pages_needed(len(req._context_ids()))
                    self._fail(req, "never_admittable",
                               f"context of {len(req._context_ids())} "
                               f"tokens needs {need} pages but the pool "
                               f"only has {self.cache.num_pages}")
                    continue
                break
            slot, cached = hit
            req.cached_prefix_len = cached
            req.state = RUNNING
            self.running[slot] = req
            self._m_admitted.inc()
            self.waiting.popleft()

    def _register_prefixes(self) -> None:
        """Register prompt prefills progressively: full pages as their
        chunks land, the partial tail once the whole prompt is in."""
        cache = self.cache
        for slot, req in self.running.items():
            if req._registered:
                continue
            plen = len(req.prompt_ids)
            written = min(cache.seq_len(slot), plen)
            if written >= plen:
                cache.register_prefix(slot, req.prompt_ids)
                req._registered = True
            elif written >= cache.page_size:
                cache.register_prefix(slot, req.prompt_ids[:written],
                                      include_tail=False)

    # -- the step ----------------------------------------------------------

    def _schedule(self) -> tuple[dict[int, int], dict[int, tuple]]:
        """Pack the token budget (decode lanes first, then prefill chunks
        FIFO by age), then run the capacity pass: ceiling stops, page
        growth, CoW claims, preempting the youngest under pressure.
        Returns ``(slot -> tokens this step, slot -> (src, dst))``."""
        cache = self.cache
        budget = self.token_budget
        sched: dict[int, int] = {}
        decode_slots, prefill_slots = [], []
        for slot in sorted(self.running):
            req = self.running[slot]
            remaining = req._ctx_len - cache.seq_len(slot)
            (decode_slots if remaining == 1 else prefill_slots).append(slot)
        for slot in decode_slots:
            if budget <= 0:
                break
            sched[slot] = 1
            budget -= 1
        for slot in sorted(prefill_slots,
                           key=lambda s: self.running[s].req_id):
            if budget <= 0:
                break
            req = self.running[slot]
            n = min(self.chunk, req._ctx_len - cache.seq_len(slot), budget)
            if n > 0:
                sched[slot] = n
                budget -= n
        cows: dict[int, tuple[int, int]] = {}
        for slot in sorted(sched):
            if slot not in self.running:
                continue
            req = self.running[slot]
            written = cache.seq_len(slot)
            if written + 1 > self.max_seq_len:
                # length ceiling: stop before any write past the table
                del sched[slot]
                self.running.pop(slot)
                req.truncated = True
                cache.free(slot)
                self._finish(req)
                continue
            n = sched[slot] = min(sched[slot], self.max_seq_len - written)
            while True:
                if cache.ensure_capacity(slot, written + n) and (
                        not cache.needs_cow(slot, written)
                        or cache.available_page_count >= 1):
                    cow = cache.prepare_write(slot, written)
                    if cow is not None:
                        cows[slot] = cow
                    break
                victim_is_self = (max(self.running,
                                      key=lambda s: self.running[s].req_id)
                                  == slot)
                if victim_is_self and len(self.running) == 1:
                    self._requeue_one(slot, RuntimeError(
                        f"slot {slot}: cannot grow to {written + n} tokens "
                        "— page pool too small for this sequence"),
                        code="pool_exhausted")
                    break
                self._preempt_youngest()
                if slot not in self.running:  # preempted itself
                    break
            if slot not in self.running:
                sched.pop(slot, None)
        sched = {s: n for s, n in sched.items() if s in self.running}
        return sched, {s: c for s, c in cows.items() if s in sched}

    def _dispatch(self, sched, cows) -> dict[int, list[int]]:
        """Build the packed step arrays, run the unified step, land the
        completing lanes' tokens."""
        cache, b, t = self.cache, self.max_batch, self.token_budget
        tok_ids = np.zeros((t,), np.int32)
        tok_slot = np.full((t,), -1, np.int32)
        tok_pos = np.zeros((t,), np.int32)
        last_idx = np.full((b,), t, np.int32)   # idle-lane sentinel
        q_lens = np.zeros((b,), np.int32)
        emit_mask = np.zeros((b,), np.int32)
        produced_n = np.zeros((b,), np.int32)
        seeds = np.zeros((b,), np.int64)
        temp = np.zeros((b,), np.float32)
        top_k = np.zeros((b,), np.int32)
        top_p = np.ones((b,), np.float32)
        completing = []
        w = 0
        for slot in sorted(sched):
            n = sched[slot]
            req = self.running[slot]
            written = cache.seq_len(slot)
            tok_ids[w:w + n] = req._context_ids()[written:written + n]
            tok_slot[w:w + n] = slot
            tok_pos[w:w + n] = np.arange(written, written + n)
            last_idx[slot] = w + n - 1
            q_lens[slot] = n
            w += n
            if written + n == req._ctx_len:
                emit_mask[slot] = 1
                produced_n[slot] = len(req.output_ids)
                seeds[slot] = req.seed
                temp[slot] = req.temperature
                top_k[slot] = req.top_k
                top_p[slot] = req.top_p
                completing.append((slot, req))
        cow_src = cow_dst = None
        if cows:
            src = np.full((b,), cache.num_pages, np.int32)
            dst = src.copy()
            for slot, (s, d) in cows.items():
                src[slot], dst[slot] = s, d
            cow_src, cow_dst = self._put(src), self._put(dst)
        # page-table / seq-len views are taken BEFORE this step's advance:
        # kv_lens counts tokens cached before the step
        next_toks, _, _, _ = self._unified(
            self.params, self._put(tok_ids), self._put(tok_slot),
            self._put(tok_pos), self._put(q_lens), cache.seq_lens_device(),
            self._put(last_idx), self._zeros_t, self._zeros_b,
            self._put(emit_mask), self._put(produced_n), cache.k_pool,
            cache.v_pool, cache.page_table_device(), cow_src, cow_dst,
            self._put(seeds), self._put(temp), self._put(top_k),
            self._put(top_p), sample=bool((temp > 0).any()))
        self._m_steps.inc()
        for slot, n in sched.items():
            cache.advance(slot, n)
        out = next_toks.cpu().numpy()
        produced: dict[int, list[int]] = {}
        for slot, req in completing:
            if stream_done(req.output_ids, req.max_new_tokens,
                           req.eos_token_id):
                continue
            tok = int(out[slot])
            req.output_ids.append(tok)
            self._m_tokens.inc()
            if req.first_token_time is None:
                req.first_token_time = time.monotonic()
                self._m_ttft.observe(req.ttft * 1e3)
            produced[req.req_id] = [tok]
        return produced

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(self.device)

    def step(self) -> dict[int, list[int]]:
        """One scheduler round. Returns ``{req_id: [token]}`` for the
        tokens produced this round; a round that only advanced prefill
        chunks produces none."""
        t0 = time.monotonic()
        try:
            self._retire_finished()
            self._admit_waiting()
            if not self.running:
                return {}
            sched, cows = self._schedule()
            if not sched:
                return {}
            produced = self._dispatch(sched, cows)
            self._register_prefixes()
            return produced
        finally:
            self._m_step_s.inc(time.monotonic() - t0)
            self._m_running.set(len(self.running))
            self._m_waiting.set(len(self.waiting))

    def generate(self, prompts, max_new_tokens=32, eos_token_id=None,
                 max_steps=None, **sampling):
        """Enqueue ``prompts`` (lists of ids) and drive steps until all
        finish. Returns the output-id lists in prompt order. ``sampling``
        forwards temperature / top_k / top_p / seed to every request."""
        reqs = [self.add_request(p, max_new_tokens, eos_token_id, **sampling)
                for p in prompts]
        pre_rounds = sum(len(r.prompt_ids) // self.chunk + 1 for r in reqs)
        limit = max_steps or ((len(prompts) * (max_new_tokens + 2)
                               + pre_rounds) * (self.max_batch + 1))
        n = 0
        while any(r.state not in (FINISHED, FAILED) for r in reqs):
            self.step()
            if not self.has_work():
                break
            n += 1
            if n > limit:
                raise RuntimeError("serving loop exceeded step budget "
                                   f"({limit}) — scheduler stuck")
        return [list(r.output_ids) for r in reqs]


__all__ = ["Request", "ServingPredictor", "stream_done", "WAITING",
           "RUNNING", "FINISHED", "FAILED"]
