"""Continuous-batching serving over the paged KV cache — port of
``paddle_tpu/inference/serving.py``.

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

``unified=False`` runs the reference's legacy two-program path instead,
its A/B baseline: admission prefills all but the last context token at
once (``build_prefill``, prompts padded to ``prefill_bucket`` multiples),
and every round is one decode step over all running slots
(``build_decode_step``: the paged decode kernel) — greedy only, fp KV
only, no prefix cache by default.

The scheduling code is the reference's, so on the same weights and
prompts the port and the reference's synchronous engine
(``async_engine=False``) allocate the same pages and emit the same greedy
tokens. Quantized serving follows the config: ``GPTConfig.weight_dtype``
(``"int8"`` / ``"int4"``, with ``weight_quant_group_size``) quantizes the
stacked weights after the cast to ``dtype``, and ``kv_cache_dtype="int8"``
(or the config's) keeps the KV pools int8; ``mega_decode=True`` (or the
config's) serves every round through the mega kernels. MoE configs
(``moe_experts``) serve on the per-op unified step, their expert stacks
quantized per expert with the weights.

The async dispatch-ahead engine (the default on the unified path, as in
the reference; ``async_engine=False`` selects the synchronous engine, the
same pack and capacity code at pipeline depth zero): ``step()`` packs and
dispatches round N, then lands round N-1's tokens. Decode lanes whose
input token is still on the device read it from the previous step's
``next_toks`` (the ``feedback`` lanes), so host bookkeeping that needs
only token COUNTS (page growth, admission, budget retirement, prefix
registration) runs at pack time and bookkeeping that needs token VALUES
(``output_ids``, eos, TTFT, preemption-replay contexts) reconciles one
step behind. A step whose emissions could finish a request (eos set, or
the output budget reachable) reconciles behind-by-one; steps that cannot
complete anything defer up to ``max_inflight_steps`` and land in one
batch (``flush()``). Every upload goes through pinned staging
(``inference/staging.py``) into persistent device buffers: the step on a
CUDA device is a captured graph that reads them, and no upload waits for
the step in flight. The one hard sync is the reconcile's wait for a ring
entry's copied-out ``next_toks``. Greedy streams are bit-identical, and
seeded sampled streams identical, to the synchronous engine's.

Speculative decoding (``spec_decode_k``, or the config's): every decode
lane may feed up to ``spec_k`` draft tokens after its last context token,
and the one unified step verifies them (``build_unified_step(spec_k=)``):
a lane emits its accepted drafts and one token more, so greedy and seeded
streams are those of plain decode. The drafts come from the request's
n-gram table (``draft_source="ngram"``, the default) or from the model's
first ``draft_layers`` layers (``"model"``, or ``spec_draft_layers`` in the
config), drafted for every lane in one pass a round
(``inference/draft.py``). Drafts claim only pages no one else needs
(``KVCacheManager.draft_allowance``); a rejected draft's pages go back at
reconcile (``trim_pages``), so page accounting equals a never-speculated
run's. The token budget grows to ``max_batch * (1 + spec_k) + chunk``
(``token_budget`` overrides it). In the async engine a step with drafts
reconciles at the start of the next round (behind by one), and a round
with none rides the plain deferral. Speculation with MoE and the legacy
path raise.

The resilience layer: a request ends FINISHED or FAILED, a failure with
an error record ``{"code", "message"}`` — never-admittable contexts,
exhausted step retries, shed admissions and missed deadlines fail one
request while the predictor serves the rest. ``deadline_s`` gives a
request a wall-clock budget from its submission: a waiting request past
it is shed at the next round, a running one retires at the next round
(both ``deadline_exceeded``). ``slo=SLOConfig(...)`` sheds at
``add_request`` (a bounded queue, and with a backlog the pool occupancy,
the in-flight depth and the TTFT-p99 EMA); ``admission_verdict()`` and
``healthz()`` are the load signals a router reads. A step is
crash-consistent: an injected fault (``inference/faults.py``) or a CUDA
out-of-memory error inside the pack, the upload, the launch or the
reconcile drops the failed ring entries, takes back the tokens they
charged and requeues every affected lane through the preemption replay
(its greedy stream is the fault-free run's; in bf16 on a CUDA device the
replay's chunked recompute of its context can round otherwise than the
decode steps did, and a stream may leave it at a near tie), with
bounded retries
(``max_step_retries``) and exponential backoff (``retry_backoff_s``)
before a request fails. Other exceptions propagate: a CUDA error that
poisons the context (an illegal address, a device-side assert) cannot be
recovered in the process. With no plan armed, no deadline and
``slo=None``, every seam is one module-global check and the engine's
streams and page accounting are those of the engine without the layer.

Observability: ``pack_dispatch`` / ``dispatch`` / ``reconcile`` /
``flush`` host spans, one async lane a request (admit, prefill chunks,
decode / spec_verify rounds, preempt, retry, first_token, eos / failed)
and the ``inflight_steps`` counter track are recorded while a profiler
window is open (``paddle_tpu_torch.profiler``); otherwise each is one
flag check. The engine's clock is ``observability.monotonic``.
"""
from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

from .._device import resolve_device
from ..observability import (MetricsRegistry, counter_event, monotonic,
                             request_begin, request_end, request_event,
                             span, tracing_active)
from ..ops.paged_attention import CHUNK_DEFAULT, PAGE_SIZE_DEFAULT
from ..profiler.record import recorder as _recorder
from .faults import InjectedFault, fault_point
from .kv_cache import KVCacheManager, kv_cache_quantized, pages_needed
from .quantize import quantize_serving_params
from .staging import Feed

WAITING, RUNNING, FINISHED, FAILED = ("waiting", "running", "finished",
                                      "failed")
#: the failures a step recovers from: they leave the CUDA context usable
RECOVERABLE = (InjectedFault, torch.cuda.OutOfMemoryError)


def stream_done(output_ids, max_new_tokens, eos_token_id) -> bool:
    """The budget/eos stop rule over a materialized output stream."""
    if len(output_ids) >= max_new_tokens:
        return True
    return (eos_token_id is not None and bool(output_ids)
            and output_ids[-1] == eos_token_id)


def deadline_passed(submit_time, deadline_s, now=None) -> bool:
    """Whether a deadline of ``deadline_s`` seconds from ``submit_time`` (on
    the ``observability.monotonic`` clock) has passed; ``None`` never
    does."""
    if deadline_s is None:
        return False
    return (monotonic() if now is None else now) >= submit_time + deadline_s


class Request:
    """One generation request; ``output_ids`` fills as steps land.
    ``deadline_s`` is its wall-clock budget from ``submit_time`` (the
    submission; a preemption replay keeps it); a FAILED request carries
    ``error = {"code", "message"}``."""

    _next_id = [0]

    def __init__(self, prompt_ids, max_new_tokens=32, eos_token_id=None,
                 temperature=0.0, top_k=0, top_p=1.0, seed=None,
                 deadline_s=None):
        self.req_id = Request._next_id[0]
        Request._next_id[0] += 1
        self.prompt_ids = [int(t) for t in np.asarray(prompt_ids).reshape(-1)]
        if not self.prompt_ids:
            raise ValueError("empty prompt")
        self.max_new_tokens = int(max_new_tokens)
        self.eos_token_id = eos_token_id
        self.deadline_s = None if deadline_s is None else float(deadline_s)
        if self.deadline_s is not None and self.deadline_s < 0:
            raise ValueError(f"deadline_s must be >= 0, got {deadline_s}")
        self.error: dict | None = None
        # failure-driven requeues (not preemptions), bounded by the
        # predictor's max_step_retries
        self.retry_count = 0
        self._finish_counted = False
        # temperature == 0 -> greedy argmax; the seed defaults to the
        # request id so a preemption replay re-samples the SAME stream
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.seed = self.req_id if seed is None else int(seed)
        self.output_ids: list[int] = []
        # tokens the async engine dispatched for this request whose values
        # have not reached the host yet: they count toward the output
        # budget and the context length; their values land at reconcile
        self._pending_n = 0
        self.state = WAITING
        self.preempt_count = 0
        self.truncated = False  # stopped by the max_seq_len ceiling
        self.submit_time = monotonic()
        self.first_token_time: float | None = None
        self.cached_prefix_len = 0
        self._registered = False     # prompt pages in the prefix registry

    @property
    def done(self) -> bool:
        if self.truncated:
            return True
        if len(self.output_ids) + self._pending_n >= self.max_new_tokens:
            return True
        return (self.eos_token_id is not None and bool(self.output_ids)
                and self.output_ids[-1] == self.eos_token_id)

    @property
    def _ctx_len(self) -> int:
        """Context length including dispatched tokens not yet landed — what
        the count-based packing sees."""
        return len(self.prompt_ids) + len(self.output_ids) + self._pending_n

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

    def past_deadline(self, now=None) -> bool:
        return deadline_passed(self.submit_time, self.deadline_s, now)


class SLOConfig:
    """Admission control for one predictor: ``slo=None`` never sheds; an
    armed config fails a request at ``add_request`` with a ``shed_*`` code
    instead of queueing it into an overload.

    - ``max_waiting`` — the bounded waiting queue (``shed_queue_full``);
    - ``max_pool_occupancy`` — with a backlog, the KV pool's claimed
      fraction at or above this (``shed_pool_pressure``);
    - ``max_inflight_depth`` — with a backlog, the async ring at or above
      this depth (``shed_inflight_depth``);
    - ``ttft_p99_slo_ms`` — with a backlog, the TTFT-p99 EMA above this
      (``shed_ttft_slo``); ``ema_alpha`` smooths it.

    Every threshold but ``max_waiting`` defaults to off.
    """

    def __init__(self, *, max_waiting=256, max_pool_occupancy=None,
                 max_inflight_depth=None, ttft_p99_slo_ms=None,
                 ema_alpha=0.2):
        self.max_waiting = None if max_waiting is None else int(max_waiting)
        if self.max_waiting is not None and self.max_waiting < 1:
            raise ValueError(f"max_waiting must be >= 1, got {max_waiting}")
        self.max_pool_occupancy = (None if max_pool_occupancy is None
                                   else float(max_pool_occupancy))
        if self.max_pool_occupancy is not None \
                and not 0.0 < self.max_pool_occupancy <= 1.0:
            raise ValueError(f"max_pool_occupancy is a fraction in (0, 1], "
                             f"got {max_pool_occupancy}")
        self.max_inflight_depth = (None if max_inflight_depth is None
                                   else int(max_inflight_depth))
        if self.max_inflight_depth is not None \
                and self.max_inflight_depth < 0:
            raise ValueError(f"max_inflight_depth must be >= 0, "
                             f"got {max_inflight_depth}")
        self.ttft_p99_slo_ms = (None if ttft_p99_slo_ms is None
                                else float(ttft_p99_slo_ms))
        if self.ttft_p99_slo_ms is not None and self.ttft_p99_slo_ms <= 0:
            raise ValueError(f"ttft_p99_slo_ms must be > 0, "
                             f"got {ttft_p99_slo_ms}")
        self.ema_alpha = float(ema_alpha)
        if not 0.0 < self.ema_alpha <= 1.0:
            raise ValueError(f"ema_alpha must be in (0, 1], got {ema_alpha}")


class _Pending:
    """One dispatched, not yet reconciled unified step: an entry of the
    async engine's in-flight ring. ``out`` is the host copy of the step's
    ``next_toks`` (speculative: its ``out_ids``, and ``ne`` of its
    ``n_emit``), filled by queued device-to-host copies; ``ready`` is their
    CUDA event (``None`` on the CPU). ``completing`` holds the ``(slot,
    req, drafts, was_decode)`` lanes that emit, ``spec_slots`` the lanes
    that drafted (they advance by ``n_emit`` at reconcile), ``must_sync``
    whether an emission could finish a request."""

    __slots__ = ("out", "ne", "ready", "completing", "spec_slots",
                 "must_sync")

    def __init__(self, out, ne, ready, completing, spec_slots, must_sync):
        self.out = out
        self.ne = ne
        self.ready = ready
        self.completing = completing
        self.spec_slots = spec_slots
        self.must_sync = must_sync


class ServingPredictor:
    """Continuous-batching predictor for a GPT model.

    ``add_request`` enqueues; ``step`` runs one scheduler round (retire /
    admit / grow / preempt around ONE unified-step launch); ``generate``
    drives ``step`` until a set of prompts finishes. The model's weights
    are stacked once (``serving_params``), cast to ``dtype`` when given,
    moved to ``device`` (``None`` = ``cuda:0``) and then, when
    ``config.weight_dtype`` is set, quantized
    (``quantize_serving_params``). ``kv_cache_dtype`` (default: the
    config's) ``"int8"`` stores the KV pools int8. ``mega_decode``
    (default: the config's) runs every step's layers through the two mega
    kernels (``ops/mega_decode.py``) instead of the per-op chain; MoE
    configs cannot take it (``ValueError``, as in the reference).
    ``async_engine`` (default: on for the unified path) dispatches ahead
    and lands tokens one step behind (see the module docstring);
    ``flush()`` lands every step in flight; ``max_inflight_steps`` bounds
    the steps deferred. ``unified=False`` runs the reference's legacy
    two-program path (per-bucket prefill at admission + the decode step),
    eager and synchronous; it refuses the async engine, an int8 KV cache,
    speculation, ``mega_decode`` and MoE with the reference's
    ``ValueError``s. ``max_seq_len`` (capped at the config's) bounds every
    context; ``prefix_cache`` defaults to ``unified``. ``spec_decode_k``
    (default: the config's) turns on speculative decoding with drafts from
    ``draft_source`` (``"ngram"``, or ``"model"`` with ``draft_layers``,
    the default when the config's ``spec_draft_layers`` is set) and a
    draft pool of ``draft_num_pages`` (see the module docstring);
    ``token_budget`` overrides the packed step's token count.

    The resilience knobs: ``slo`` (an :class:`SLOConfig` or ``None``),
    ``max_step_retries`` failure requeues of a request before it fails,
    ``retry_backoff_s`` the first backoff after a failed step (doubling
    with consecutive failures, capped at 1 s). ``metrics`` is the
    registry the predictor and its cache feed (an enabled one; default: a
    fresh one). ``replica_id`` and ``role`` name the predictor in
    ``healthz()`` (``role`` is identity only: the predictor serves the
    same in every role). ``host_tier_bytes`` sizes the KV cache's host
    tier (0: off).
    """

    def __init__(self, model, *, max_batch=8, num_pages=None, page_size=None,
                 max_seq_len=None, prefill_bucket=16, dtype=None,
                 unified=None, chunk=None, prefix_cache=None,
                 kv_cache_dtype=None, async_engine=None,
                 max_inflight_steps=4, device=None, mega_decode=None,
                 token_budget=None, spec_decode_k=None, draft_source=None,
                 draft_layers=None, draft_num_pages=None, metrics=None,
                 slo=None, max_step_retries=3, retry_backoff_s=0.02,
                 replica_id=0, role="colocated", host_tier_bytes=0):
        from ..models.gpt import (build_decode_step, build_prefill,
                                  build_unified_step, draft_config,
                                  serving_params)

        gpt = model.gpt if hasattr(model, "gpt") else model
        self.config = cfg = gpt.config
        self.unified = unified is None or bool(unified)
        self.async_engine = bool(self.unified if async_engine is None
                                 else async_engine)
        if self.async_engine and not self.unified:
            raise ValueError(
                "the async engine rides the unified step's device-resident "
                "token feedback; the legacy two-jit path serves sync only")
        self.max_inflight_steps = max(1, int(max_inflight_steps))
        self.device = resolve_device(device)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        if not self.metrics.enabled:
            # these counters back the read surface (tokens, steps, TTFT,
            # telemetry): a disabled registry would report zeros
            raise ValueError(
                "ServingPredictor requires an enabled metrics registry; "
                "the one passed is disabled")
        self._init_instruments()
        if slo is not None and not isinstance(slo, SLOConfig):
            raise ValueError(f"slo must be an SLOConfig or None, "
                             f"got {type(slo).__name__}")
        self.slo = slo
        self.replica_id = int(replica_id)
        if self.replica_id < 0:
            raise ValueError(f"replica_id must be >= 0, got {replica_id}")
        if role not in ("colocated", "prefill", "decode"):
            raise ValueError(f"role must be 'colocated', 'prefill' or "
                             f"'decode', got {role!r}")
        self.role = role
        self.max_step_retries = int(max_step_retries)
        if self.max_step_retries < 0:
            raise ValueError(f"max_step_retries must be >= 0, "
                             f"got {max_step_retries}")
        self.retry_backoff_s = float(retry_backoff_s)
        # the deadline sweep arms with the first deadlined request
        self._deadlines_armed = False
        self._consec_failures = 0
        self._ttft_ema_ms: float | None = None
        self._last_round_end = monotonic()
        # req_id -> recorder generation of its lane's recorded 'b': a lane
        # is open only in the window (generation) that recorded its begin
        self._traced_reqs: dict[int, int] = {}
        self.kv_quant = kv_cache_quantized(kv_cache_dtype
                                           or cfg.kv_cache_dtype)
        if self.kv_quant and not self.unified:
            raise ValueError(
                "int8 KV cache rides the unified step's quantize-on-write "
                "lanes; the legacy two-jit path serves fp only")
        # the model's position table bounds every context
        self.max_seq_len = min(int(max_seq_len or cfg.max_seq_len),
                               cfg.max_seq_len)
        self.max_batch = int(max_batch)
        self.prefill_bucket = int(prefill_bucket)
        page_size = int(page_size or PAGE_SIZE_DEFAULT)
        if num_pages is None:
            # default pool: every lane can reach max_seq_len
            num_pages = self.max_batch * pages_needed(self.max_seq_len,
                                                      page_size)
        self.chunk = int(chunk or CHUNK_DEFAULT)
        self.mega_decode = bool(cfg.mega_decode if mega_decode is None
                                else mega_decode)
        self.spec_k = int(cfg.spec_decode_k if spec_decode_k is None
                          else spec_decode_k)
        if self.spec_k < 0:
            raise ValueError(f"spec_decode_k must be >= 0, got "
                             f"{self.spec_k}")
        if self.spec_k and not self.unified:
            raise ValueError(
                "speculative decoding rides the unified step's verify "
                "rows; the legacy two-jit path serves plain decode only")
        if self.spec_k and self.spec_k >= self.chunk:
            raise ValueError(
                f"spec_decode_k {self.spec_k} needs 1 + k <= chunk "
                f"{self.chunk} (verify rows ride the per-slot chunk block)")
        self.draft_layers = int(cfg.spec_draft_layers if draft_layers is None
                                else draft_layers)
        if draft_source is None:
            draft_source = ("model" if self.spec_k and self.draft_layers
                            else "ngram")
        if draft_source not in ("ngram", "model"):
            raise ValueError(f"draft_source must be 'ngram' or 'model', "
                             f"got {draft_source!r}")
        self.draft_source = draft_source
        if draft_source == "model":
            if not self.spec_k:
                raise ValueError("draft_source='model' needs spec_decode_k "
                                 "> 0 (there is nothing to draft)")
            draft_config(cfg, self.draft_layers)   # rejects bad depths
        if self.mega_decode and not self.unified:
            raise ValueError(
                "mega_decode rides the unified step's packed layout; the "
                "legacy two-jit path serves the per-op chain only")
        # what the mega kernels cannot serve (MoE, int4 weights, head dims
        # on the card) and speculation with MoE raise here; the legacy
        # builders refuse MoE
        self._unified = self._prefill = self._decode = None
        if self.unified:
            self._unified = build_unified_step(
                cfg, page_size, self.chunk, kv_quant=self.kv_quant,
                spec_k=self.spec_k, mega=self.mega_decode,
                device=self.device)
        else:
            self._decode = build_decode_step(cfg, page_size)
            self._prefill = build_prefill(cfg, page_size)
        # every refusal above comes before any weight reaches the device
        params = serving_params(model)

        def place(t):
            return t.to(device=self.device,
                        dtype=dtype if dtype is not None else t.dtype)

        self.params = {k: (place(v) if k != "layers"
                           else {n: place(w) for n, w in v.items()})
                       for k, v in params.items()}
        if cfg.weight_dtype is not None:
            # after the cast, as the reference does: a bf16 model's scales
            # are bf16-rounded
            self.params = quantize_serving_params(
                self.params, cfg.weight_dtype, cfg.weight_quant_group_size)
        slots = self.max_inflight_steps + 1
        self.cache = KVCacheManager(
            cfg.num_layers, cfg.num_heads, cfg.head_dim,
            num_pages=num_pages, max_batch=self.max_batch,
            max_seq_len=self.max_seq_len, page_size=page_size,
            dtype=self.params["tok_emb"].dtype,
            enable_prefix_cache=(self.unified if prefix_cache is None
                                 else bool(prefix_cache)),
            quantize_kv=self.kv_quant, metrics=self.metrics,
            host_tier_bytes=host_tier_bytes, device=self.device,
            staging_slots=slots)
        self.token_budget = int(token_budget or (
            self.max_batch * (1 + self.spec_k) + self.chunk))
        self._draft_engine = None
        if self.draft_source == "model":
            from .draft import ModelDraftEngine

            self._draft_engine = ModelDraftEngine(
                cfg, self.params, self.draft_layers,
                page_size=self.cache.page_size, chunk=self.chunk,
                max_batch=self.max_batch, max_seq_len=self.max_seq_len,
                num_pages=draft_num_pages, kv_quant=self.kv_quant,
                max_k=self.spec_k, mega=self.mega_decode,
                device=self.device, staging_slots=slots)
        # req_id -> draft proposer, kept across preemption (the replayed
        # context proposes the same drafts and resumes the backoff)
        self._drafts: dict[int, object] = {}
        self._accept_ema: float | None = None
        self.waiting: deque[Request] = deque()
        self.running: dict[int, Request] = {}   # slot -> request
        b, t = self.max_batch, self.token_budget
        # the step's inputs: the per-round arrays, uploaded every round,
        # and the slowly-changing ones (copy-on-write lanes, sampling
        # parameters), uploaded when their bytes change
        self._feed = Feed(
            [(n, t, "i32") for n in ("tok_ids", "tok_slot", "tok_pos",
                                     "feedback")]
            + [(n, b, "i32") for n in ("q_lens", "last_idx", "emit_mask",
                                       "produced")]
            + ([("spec_len", b, "i32")] if self.spec_k else []),
            self.device, slots)
        self._slow = Feed(
            [("cow_src", b, "i32"), ("cow_dst", b, "i32"),
             ("seeds", b, "i32"), ("temp", b, "f32"), ("top_k", b, "i32"),
             ("top_p", b, "f32")], self.device, slots, cached=True)
        # the feedback carry: the last dispatch's next_toks (the sync
        # engine keeps it zero: its lanes never read it)
        self._prev = torch.zeros((b,), dtype=torch.int32, device=self.device)
        self._lane_seeds = np.zeros((b,), np.uint32)
        self._inflight: deque[_Pending] = deque()
        self._did_sync = False   # set by _reconcile_one, charged per call
        # steady-decode pack cache (async): the last full pack re-served
        # while the schedule signature holds
        self._steady: dict | None = None
        # perf accounting: wall intervals with no step in flight bound the
        # device's idle gaps between steps from above; the window marks
        # (reset_perf_stats) are plain timestamps
        self._span_start = None
        self._last_event = None
        self._idle_since = None
        self._w_marks = {"step_s": 0.0, "sync_s": 0.0, "gap_s": 0.0,
                         "calls": 0.0, "draft_s": 0.0}
        # the legacy path's per-slot decode input: each running slot's next
        # token to feed
        self._next_token = np.zeros((b,), np.int32)

    def _init_instruments(self):
        m = self.metrics
        self._m_steps = m.counter(
            "serving_steps", "scheduler rounds that dispatched a step")
        self._m_step_calls = m.counter(
            "serving_step_calls", "step() invocations (perf-window unit)")
        self._m_tokens = m.counter(
            "serving_tokens_emitted", "tokens emitted")
        self._m_hard_syncs = m.counter(
            "serving_hard_syncs", "step()/flush() calls that materialized")
        self._m_steady = m.counter(
            "serving_steady_hits", "async steady-decode pack-cache hits")
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
            "serving_step_seconds", "host wall seconds inside step()/flush()")
        self._m_sync_s = m.counter(
            "serving_sync_seconds", "seconds blocked materializing outputs")
        self._m_gap_s = m.counter(
            "serving_gap_seconds", "wall seconds with no step in flight")
        self._m_ttft = m.histogram(
            "serving_ttft_ms", "submit -> first generated token",
            buckets=(1, 2, 5, 10, 25, 50, 100, 250, 1000, 5000))
        self._m_inflight = m.gauge(
            "serving_inflight_depth", "dispatched-unreconciled steps")
        self._m_running = m.gauge(
            "serving_running_lanes", "slots in RUNNING after a step")
        self._m_waiting = m.gauge(
            "serving_waiting_requests", "queued requests after a step")
        # speculative decoding, per completing decode lane-step
        self._m_spec_lane_steps = m.counter(
            "serving_spec_lane_steps", "decode lane-steps while spec is on")
        self._m_spec_emitted = m.counter(
            "serving_spec_tokens_emitted", "tokens emitted by spec lanes")
        self._m_draft_proposed = m.counter(
            "serving_draft_proposed", "draft tokens proposed")
        self._m_draft_accepted = m.counter(
            "serving_draft_accepted", "draft tokens accepted by verify")
        self._m_draft_rollback = m.counter(
            "serving_draft_rollback_pages", "over-allocated pages trimmed")
        self._m_draft_model_steps = m.counter(
            "serving_draft_model_steps",
            "draft-model launches (catch-up chunks + chains)")
        self._m_draft_src = m.counter(
            "serving_draft_tokens_proposed",
            "draft tokens proposed, by source", labels=("source",))
        self._m_spec_deferred = m.counter(
            "serving_spec_async_deferred_steps",
            "spec-build dispatches reconciled behind-by-one or deferred")
        self._m_draft_s = m.counter(
            "serving_draft_seconds",
            "host wall seconds inside the draft-model proposal pass")
        # the resilience layer
        self._m_shed = m.counter(
            "serving_requests_shed", "admissions shed by the SLO policy")
        self._m_deadline = m.counter(
            "serving_deadline_misses", "requests failed past their deadline")
        self._m_step_failures = m.counter(
            "serving_step_failures", "pack/dispatch/reconcile failures")
        self._m_faults = m.counter(
            "serving_faults_injected", "injected faults observed, by seam",
            labels=("seam",))

    # -- read surface ------------------------------------------------------

    @property
    def steps(self) -> int:
        return int(self._m_steps.value)

    @property
    def tokens_emitted(self) -> int:
        return int(self._m_tokens.value)

    @property
    def hard_syncs(self) -> int:
        return int(self._m_hard_syncs.value)

    @property
    def steady_hits(self) -> int:
        return int(self._m_steady.value)

    @property
    def spec_lane_steps(self) -> int:
        return int(self._m_spec_lane_steps.value)

    @property
    def spec_emitted(self) -> int:
        return int(self._m_spec_emitted.value)

    @property
    def spec_proposed(self) -> int:
        return int(self._m_draft_proposed.value)

    @property
    def spec_accepted(self) -> int:
        return int(self._m_draft_accepted.value)

    @property
    def accepted_tokens_per_step(self) -> float:
        """Tokens emitted per completing decode lane-step while speculation
        is on (1.0: plain decode)."""
        if not self.spec_lane_steps:
            return 1.0
        return self.spec_emitted / self.spec_lane_steps

    @property
    def draft_acceptance_rate(self) -> float:
        """The share of proposed drafts the verify step accepted."""
        if not self.spec_proposed:
            return 0.0
        return self.spec_accepted / self.spec_proposed

    @property
    def draft_overhead_frac(self) -> float:
        """The share of the measured window's ``step()`` wall time spent in
        the model draft pass (0.0 for the n-gram source)."""
        step = self._window("step_s", self._m_step_s)
        if step <= 0:
            return 0.0
        return min(1.0, self._window("draft_s", self._m_draft_s) / step)

    @property
    def spec_accept_ema(self) -> float:
        """EMA over the drafted lane-steps' acceptance shares (0.0 before
        any drafted step)."""
        return 0.0 if self._accept_ema is None else self._accept_ema

    @property
    def draft_trace_count(self) -> int:
        """Captures of the model draft programs (the catch-up step and one
        chain per length run; on the CPU the geometries that ran); 0 for
        the n-gram source."""
        eng = self._draft_engine
        return 0 if eng is None else eng.trace_count

    @property
    def decode_trace_count(self) -> int:
        """Programs of the serving step: on the unified path the step's
        captures on a CUDA device (one per geometry; the CPU counts the
        geometries that ran), on the legacy path the decode step's builds
        (one)."""
        return (self._unified if self.unified else self._decode).trace_count

    @property
    def prefill_trace_count(self) -> int:
        """Prompt-bucket shapes the legacy prefill has run (the reference's
        executables per bucket); the unified step has no prefill program
        (0)."""
        return 0 if self.unified else self._prefill.trace_count

    @property
    def prefix_hit_rate(self) -> float:
        return self.cache.prefix_hit_rate

    def telemetry(self) -> dict[str, float]:
        """Flat snapshot of the serving-stack registry (predictor + KV
        cache instruments)."""
        return self.metrics.snapshot_flat()

    # -- perf accounting ---------------------------------------------------

    def _mark_dispatch(self) -> None:
        """A step was dispatched: any interval since the pipeline last
        drained was a host-side bubble the device could not fill."""
        now = monotonic()
        if self._span_start is None:
            self._span_start = now
        if self._idle_since is not None:
            self._m_gap_s.inc(now - self._idle_since)
            self._idle_since = None
        self._last_event = now

    def _mark_drained(self) -> None:
        """No dispatched, unmaterialized work remains."""
        now = monotonic()
        self._idle_since = now
        self._last_event = now

    def _window(self, key: str, counter) -> float:
        """A duration counter's accumulation since the last
        :meth:`reset_perf_stats`."""
        return max(0.0, counter.value - self._w_marks[key])

    @property
    def step_gap_frac(self) -> float:
        """Fraction of the measured window with no step in flight: the
        host-observable upper bound on the device's idle gaps between
        steps (the sync engine's pack and bookkeeping bubble; near 0 for
        the async engine). The window starts at the first dispatch after
        :meth:`reset_perf_stats`."""
        if self._span_start is None or self._last_event is None:
            return 0.0
        window = self._last_event - self._span_start
        if window <= 0:
            return 0.0
        return min(1.0, self._window("gap_s", self._m_gap_s) / window)

    @property
    def host_ms_per_step(self) -> float:
        """Host milliseconds per ``step()`` outside the blocking waits for
        the device: the scheduling and bookkeeping cost the async engine
        overlaps with device execution."""
        calls = self._window("calls", self._m_step_calls)
        if not calls:
            return 0.0
        busy = (self._window("step_s", self._m_step_s)
                - self._window("sync_s", self._m_sync_s))
        return max(0.0, busy * 1e3 / calls)

    def reset_perf_stats(self) -> None:
        """Start a fresh measurement window (after a warm-up): the registry
        counters are monotonic, the window is their delta against the
        marks taken here."""
        self._span_start = None
        self._last_event = None
        self._idle_since = None if self._inflight else monotonic()
        if self._idle_since is not None:
            self._span_start = self._idle_since
            self._last_event = self._idle_since
        self._w_marks = {"step_s": self._m_step_s.value,
                         "sync_s": self._m_sync_s.value,
                         "gap_s": self._m_gap_s.value,
                         "calls": self._m_step_calls.value,
                         "draft_s": self._m_draft_s.value}

    # -- queue API ---------------------------------------------------------

    def add_request(self, prompt_ids, max_new_tokens=32, eos_token_id=None,
                    temperature=0.0, top_k=0, top_p=1.0, seed=None,
                    deadline_s=None) -> Request:
        """Enqueue one request; with ``slo`` armed and the verdict a shed,
        the request comes back FAILED (``shed_<reason>``) unqueued."""
        req = Request(prompt_ids, max_new_tokens, eos_token_id,
                      temperature=temperature, top_k=top_k, top_p=top_p,
                      seed=seed, deadline_s=deadline_s)
        if len(req.prompt_ids) > self.max_seq_len:
            raise ValueError(
                f"prompt of {len(req.prompt_ids)} tokens exceeds "
                f"max_seq_len {self.max_seq_len}")
        if self.slo is not None:
            verdict = self.admission_verdict()
            if verdict is not None:
                self._m_shed.inc()
                self._fail(req, "shed_" + verdict,
                           f"admission shed under load ({verdict}): "
                           f"{len(self.waiting)} waiting, "
                           f"{len(self.running)} running")
                return req
        if req.deadline_s is not None:
            self._deadlines_armed = True
        self.waiting.append(req)
        return req

    # -- load signals ------------------------------------------------------

    @property
    def pool_occupancy(self) -> float:
        """The KV pool's claimed fraction (evictable prefix pages count as
        available)."""
        cache = self.cache
        return 1.0 - cache.available_page_count / max(1, cache.num_pages)

    @property
    def ttft_p99_ema_ms(self) -> float:
        """EMA over the TTFT histogram's p99 estimate (0.0 before the first
        token): the SLO shedding signal."""
        return 0.0 if self._ttft_ema_ms is None else self._ttft_ema_ms

    def admission_verdict(self) -> str | None:
        """Would :meth:`add_request` shed now? ``None`` admits, else the
        reason (``queue_full`` / ``pool_pressure`` / ``inflight_depth`` /
        ``ttft_slo``). A pure read."""
        slo = self.slo
        if slo is None:
            return None
        if (slo.max_waiting is not None
                and len(self.waiting) >= slo.max_waiting):
            return "queue_full"
        # backlog-gated: a full pool with an empty queue is a saturated
        # batch, not an overload
        if self.waiting:
            if (slo.max_pool_occupancy is not None
                    and self.pool_occupancy >= slo.max_pool_occupancy):
                return "pool_pressure"
            if (slo.max_inflight_depth is not None
                    and len(self._inflight) >= slo.max_inflight_depth):
                return "inflight_depth"
            if (slo.ttft_p99_slo_ms is not None
                    and self.ttft_p99_ema_ms > slo.ttft_p99_slo_ms):
                return "ttft_slo"
        return None

    def healthz(self) -> dict:
        """One JSON-able health and load snapshot (the reference's keys):
        status and shed reason, identity, the seconds since the last
        completed round, queue, ring, slot, pool and host-tier occupancy,
        the TTFT and acceptance EMAs, and the resilience counters."""
        verdict = self.admission_verdict()
        cache = self.cache
        return {
            "status": "shedding" if verdict is not None else "ok",
            "shed_reason": verdict,
            "replica_id": self.replica_id,
            "role": self.role,
            # unacknowledged KV-page frames: the fleet slice's router
            # stamps them (not ported yet), so none here
            "transfer_backlog": 0,
            "snapshot_age_s": round(
                max(0.0, monotonic() - self._last_round_end), 6),
            "waiting": len(self.waiting),
            "running": len(self.running),
            "inflight_steps": len(self._inflight),
            "free_slots": cache.free_slot_count,
            "pool_occupancy": round(self.pool_occupancy, 4),
            "withheld_pages": cache.withheld_page_count,
            "host_tier_occupancy": round(cache.host_tier_occupancy, 4),
            "host_tier_bytes": int(cache.host_tier_bytes_used),
            "ttft_p99_ema_ms": round(self.ttft_p99_ema_ms, 3),
            "spec_accept_ema": round(self.spec_accept_ema, 4),
            "steps": self.steps,
            "tokens_emitted": self.tokens_emitted,
            "requests_shed": int(self._m_shed.value),
            "deadline_misses": int(self._m_deadline.value),
            "requests_failed": int(self._m_failed.value),
            "step_failures": int(self._m_step_failures.value),
            "step_retries": int(self._m_retries.value),
        }

    def has_work(self) -> bool:
        return bool(self.waiting or self.running or self._inflight)

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
        self._req_event(req.req_id, "preempt",
                        args={"count": req.preempt_count})

    def _count_finished(self, req: Request) -> None:
        """Count a finished request once, when its emissions are final (no
        token of it still in flight)."""
        if not req._finish_counted and req._pending_n == 0:
            req._finish_counted = True
            self._m_finished.inc()

    def _close_request(self, req: Request, event: str, args) -> None:
        """Terminal teardown: drop the request's draft proposer and draft
        lane (preemption keeps both: the replay heals against them) and
        close its trace lane."""
        self._drafts.pop(req.req_id, None)
        if self._draft_engine is not None:
            self._draft_engine.release(req.req_id)
        if tracing_active():
            self._req_event(req.req_id, event, args=args)
            request_end(req.req_id)
        self._traced_reqs.pop(req.req_id, None)

    def _finish(self, req: Request) -> None:
        req.state = FINISHED
        self._count_finished(req)
        self._close_request(req, "truncated" if req.truncated else "eos",
                            {"outputs": len(req.output_ids)})

    def _fail(self, req: Request, code: str, message) -> None:
        """Terminal FAILED with an error record (every failure path: shed,
        deadline, never-admittable, retries exhausted, stuck); the caller
        has released the request's slot and pages."""
        req.state = FAILED
        req.error = {"code": code, "message": str(message)[:300]}
        self._m_failed.inc()
        self._m_fail_reasons.labels(reason=code).inc()
        self._close_request(req, "failed", dict(req.error))

    # -- crash-consistent step retry ----------------------------------------

    def _note_step_failure(self, exc) -> None:
        self._m_step_failures.inc()
        self._consec_failures += 1
        if isinstance(exc, InjectedFault):
            self._m_faults.labels(seam=exc.seam).inc()

    def _after_failure_backoff(self) -> None:
        """Sleep after a failed step: ``retry_backoff_s`` doubled a
        consecutive failure, at most 1 s (a successful dispatch resets
        the count)."""
        if self.retry_backoff_s > 0:
            time.sleep(min(
                self.retry_backoff_s * (2 ** (self._consec_failures - 1)),
                1.0))

    def _requeue_req(self, req: Request, exc, code: str) -> None:
        """The bounded-retry policy: count a failure requeue, FAIL the
        request past ``max_step_retries``, else send it back through the
        preemption replay. The caller has released its slot and pages."""
        req._registered = False
        req.retry_count += 1
        if req.retry_count > self.max_step_retries:
            self._fail(req, code,
                       f"step failed {req.retry_count} times over this "
                       f"request; last: {exc!r}")
            return
        req.state = WAITING
        self._m_retries.inc()
        self._req_event(req.req_id, "retry",
                        args={"count": req.retry_count})
        self.waiting.appendleft(req)

    def _requeue_one(self, slot: int, exc,
                     code: str = "step_retry_exhausted") -> None:
        """Requeue one running lane after a failed step: ``free()`` gives
        back its page claims (shared and registered pages stay with their
        other references); a request whose landed output is final
        finishes instead."""
        req = self.running.pop(slot)
        self.cache.free(slot)
        if req.done and req._pending_n == 0:
            self._finish(req)    # nothing left to replay
            return
        self._requeue_req(req, exc, code)

    def _requeue_running(self, exc) -> None:
        # youngest first with appendleft: the queue front is oldest first
        for slot in sorted(self.running,
                           key=lambda s: -self.running[s].req_id):
            self._requeue_one(slot, exc)

    def _recover_dispatch_failure(self, exc) -> None:
        """A failure inside ``_pack_dispatch`` (schedule, pack, upload or
        launch): the entry never entered the ring and nothing was charged,
        so requeueing every running lane returns this step's claims.
        Older ring entries ran and stay; the requeued lanes' tokens in
        flight make the value barrier land them before any replay."""
        self._note_step_failure(exc)
        self._requeue_running(exc)
        self._steady = None
        self._after_failure_backoff()

    def _recover_reconcile_failure(self, e: _Pending, exc) -> None:
        """A failure landing ring entry ``e``: its token values are lost
        and every younger entry fed on its carry, so the whole ring drops.
        Each dropped entry's charged tokens are taken back, a request
        finished by count whose final tokens were in it reopens, and every
        running lane requeues for its replay."""
        self._note_step_failure(exc)
        dropped = [e] + list(self._inflight)
        self._inflight.clear()
        self._m_inflight.set(0)
        counter_event("inflight_steps", 0)
        reopen: dict[int, Request] = {}
        for entry in dropped:
            for _slot, req, _k, _decode in entry.completing:
                req._pending_n = max(0, req._pending_n - 1)
                if req.state == FINISHED and not req.done:
                    reopen[req.req_id] = req
                elif req.state == FINISHED:
                    # done before the dropped token (eos landed earlier):
                    # its deferred finished count lands here
                    self._count_finished(req)
        self._requeue_running(exc)
        for req in reopen.values():
            # retirement already freed its slot
            self._requeue_req(req, exc, "step_retry_exhausted")
        # a replayed lane reads neither the dropped steps' next_toks nor a
        # pack built for them
        self._prev.zero_()
        self._steady = None
        self._mark_drained()
        self._after_failure_backoff()

    def _retire_finished(self) -> None:
        for slot in [s for s, r in self.running.items() if r.done]:
            req = self.running.pop(slot)
            self.cache.free(slot)
            self._finish(req)

    def _finish_waiting_unservable(self, req: Request) -> bool:
        """Queue-head checks shared by both admission paths: a request done
        while waiting, or preempted while sitting at the length ceiling,
        finishes off the queue (True)."""
        if req.done:
            self.waiting.popleft()
            self._finish(req)
            return True
        if req._ctx_len > self.max_seq_len:
            self.waiting.popleft()
            req.truncated = True
            self._finish(req)
            return True
        return False

    def _shed_expired(self) -> None:
        """The deadline sweep, once a round after the first deadlined
        request: expired waiting requests leave the queue and expired
        running ones retire, both FAILED ``deadline_exceeded``."""
        now = monotonic()
        if any(r.deadline_s is not None for r in self.waiting):
            keep: deque[Request] = deque()
            while self.waiting:
                req = self.waiting.popleft()
                if req.past_deadline(now):
                    self._m_deadline.inc()
                    self._fail(req, "deadline_exceeded",
                               f"queued past its {req.deadline_s}s "
                               "deadline")
                else:
                    keep.append(req)
            self.waiting = keep
        for slot in [s for s, r in self.running.items()
                     if r.past_deadline(now)]:
            req = self.running.pop(slot)
            self.cache.free(slot)
            self._m_deadline.inc()
            self._fail(req, "deadline_exceeded",
                       f"still running past its {req.deadline_s}s "
                       f"deadline with {len(req.output_ids)} tokens out")

    def _note_admit(self, req, slot, cached) -> None:
        """One admission (or replay): the counter, and on the request's
        lane ``admit`` (``readmit`` when its lane is open already)."""
        self._m_admitted.inc()
        if not tracing_active():
            return
        self._req_event(req.req_id,
                        "readmit" if self._lane_open(req.req_id) else "admit",
                        args={"slot": slot, "cached_prefix": int(cached)})

    def _lane_open(self, req_id) -> bool:
        return self._traced_reqs.get(req_id) == _recorder.generation

    def _req_event(self, req_id, name, args=None) -> None:
        """An instant on one request's lane, opening the lane first when
        this recording window has no begin of it yet (every window's trace
        stands alone: no instant or end without its begin)."""
        if not tracing_active():
            return
        if not self._lane_open(req_id):
            if request_begin(req_id, args={"req_id": req_id}):
                self._traced_reqs[req_id] = _recorder.generation
        request_event(req_id, name, args=args)

    def _fail_never_admittable(self, req: Request, need: int) -> None:
        """A context that can never fit the pool fails on its own; the
        caller has popped it off the queue."""
        self._fail(req, "never_admittable",
                   f"context of {len(req._context_ids())} tokens needs "
                   f"{need} pages but the pool only has "
                   f"{self.cache.num_pages}")

    def _admit_waiting(self) -> None:
        while self.waiting and self.cache.free_slot_count:
            req = self.waiting[0]
            if self._finish_waiting_unservable(req):
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
                    self._fail_never_admittable(req, self.cache.pages_needed(
                        len(req._context_ids())))
                    continue
                break
            slot, cached = hit
            req.cached_prefix_len = cached
            req.state = RUNNING
            self.running[slot] = req
            self._note_admit(req, slot, cached)
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

    # -- speculation: the draft proposers ------------------------------------

    def _proposer_for(self, req: Request):
        """The request's draft proposer, made on first use and kept across
        preemption (its backoff resumes where it left off)."""
        prop = self._drafts.get(req.req_id)
        if prop is None:
            from .draft import DraftProposer, ModelDraftProposer

            if self._draft_engine is not None:
                prop = ModelDraftProposer(self.spec_k, self._draft_engine,
                                          req.req_id)
            else:
                prop = DraftProposer(self.spec_k)
            self._drafts[req.req_id] = prop
        return prop

    def _proposer_k(self, req: Request) -> int:
        """The lane's adaptive speculation length, without making a
        proposer (a fresh request starts at ``spec_k``)."""
        prop = self._drafts.get(req.req_id)
        return prop.k if prop is not None else self.spec_k

    def _draft_room(self, slot, req, budget_room: int) -> int:
        """The per-lane draft clamp of both sources: the token budget, the
        chunk block, the request's output budget, the length ceiling and
        the pages claimable without evicting or preempting
        (``draft_allowance``). The capacity pass clamps again at claim
        time; this one saves draft work."""
        written = self.cache.seq_len(slot)
        return min(budget_room, self._proposer_k(req), self.chunk - 1,
                   req.max_new_tokens - len(req.output_ids) - 1,
                   self.max_seq_len - written - 1,
                   self.cache.draft_allowance(slot))

    def _draft_propose(self, slot, req, budget_room: int) -> list:
        """N-gram drafts for one decode lane."""
        prop = self._proposer_for(req)
        room = self._draft_room(slot, req, budget_room)
        return prop.propose(req._context_ids(), room) if room > 0 else []

    def _propose_model_drafts(self, decode_slots, budget: int) -> dict:
        """One draft-engine pass for every decode lane that may speculate
        this round, with the rooms of the n-gram path's budget split (every
        lane's base token reserved first). The engine's launches count as
        a dispatch (the device has draft work) and its one host sync as a
        hard sync of this call."""
        lanes: dict[int, tuple] = {}
        n_left = len(decode_slots)
        for slot in decode_slots:
            n_left -= 1
            req = self.running[slot]
            self._proposer_for(req)
            r = self._draft_room(slot, req, budget - 1 - n_left)
            budget -= 1
            if r > 0:
                lanes[slot] = (req.req_id, req._context_ids(), r)
                budget -= r
        if not lanes:
            return {}
        eng = self._draft_engine
        launches, syncs = eng.model_steps, eng.chain_syncs
        t0 = monotonic()
        try:
            return eng.propose(lanes)
        finally:
            self._m_draft_s.inc(monotonic() - t0)
            if eng.model_steps != launches:
                # the device had draft work
                self._m_draft_model_steps.inc(eng.model_steps - launches)
                self._mark_dispatch()
            if eng.chain_syncs != syncs:
                self._did_sync = True

    # -- the unified step --------------------------------------------------

    def _schedule(self):
        """Pack the token budget (decode lanes first, each with its drafts
        under speculation, then prefill chunks FIFO by age), then run the
        capacity pass: ceiling stops, the claim-time draft clamp, page
        growth, CoW claims, preempting the youngest under pressure.
        Returns ``(slot -> tokens this step, slot -> (src, dst) of every
        CoW claimed, slot -> draft tokens, the decode slots)``."""
        cache = self.cache
        budget = self.token_budget
        sched: dict[int, int] = {}
        drafts: dict[int, list] = {}
        decode_slots, prefill_slots = [], []
        for slot in sorted(self.running):
            req = self.running[slot]
            remaining = req._ctx_len - cache.seq_len(slot)
            (decode_slots if remaining == 1 else prefill_slots).append(slot)
        model_drafts: dict[int, list] = {}
        if self._draft_engine is not None and decode_slots:
            model_drafts = self._propose_model_drafts(decode_slots, budget)
        for idx, slot in enumerate(decode_slots):
            if budget <= 0:
                break
            # drafts spend only budget left after every decode lane still
            # to pack has its base token
            room = budget - 1 - (len(decode_slots) - idx - 1)
            if self._draft_engine is not None:
                d = model_drafts.get(slot, [])[:max(0, room)]
            else:
                d = (self._draft_propose(slot, self.running[slot], room)
                     if self.spec_k else [])
            if d:
                drafts[slot] = d
            sched[slot] = 1 + len(d)
            budget -= 1 + len(d)
        for slot in sorted(prefill_slots,
                           key=lambda s: self.running[s].req_id):
            if budget <= 0:
                break
            req = self.running[slot]
            n = min(self.chunk, req._ctx_len - cache.seq_len(slot), budget)
            if n > 0:
                sched[slot] = n
                budget -= n
        # the pages each scheduled slot claims for its plain tokens, held
        # back from the drafts of the slots before it
        plain_need: dict[int, int] = {}
        pending_need = 0
        if drafts:
            plain_need = {s: cache.plain_step_page_need(
                s, sched[s] - len(drafts.get(s, []))) for s in sched}
            pending_need = sum(plain_need.values())
        cows: dict[int, tuple[int, int]] = {}
        for slot in sorted(sched):
            pending_need -= plain_need.pop(slot, 0)
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
            n = min(sched[slot], self.max_seq_len - written)
            if slot in drafts:
                # the claim-time clamp: slots before this one may have
                # taken the free pages counted at propose time
                keep = max(0, min(len(drafts[slot]), n - 1,
                                  cache.draft_allowance(
                                      slot, reserve=pending_need)))
                drafts[slot] = drafts[slot][:keep]
                if not keep:
                    del drafts[slot]
                n = 1 + keep
            sched[slot] = n
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
        drafts = {s: d for s, d in drafts.items() if s in sched}
        return sched, cows, drafts, set(decode_slots)

    def _pack(self, sched, cows, drafts, decode_set):
        """Fill the host arrays of a full pack; returns the completing
        ``(slot, req, drafts, was_decode)`` lanes."""
        cache = self.cache
        h, sh = self._feed.host, self._slow.host
        self._feed.array[...] = 0
        h["tok_slot"][...] = -1
        h["last_idx"][...] = self.token_budget   # idle-lane sentinel
        sh["cow_src"][...] = cache.num_pages     # no-copy sentinel
        sh["cow_dst"][...] = cache.num_pages
        for slot, (src, dst) in cows.items():
            if slot in sched:
                sh["cow_src"][slot], sh["cow_dst"][slot] = src, dst
        sh["temp"][...] = 0.0
        sh["top_k"][...] = 0
        sh["top_p"][...] = 1.0
        completing = []
        w = 0
        for slot in sorted(sched):
            n = sched[slot]
            req = self.running[slot]
            written = cache.seq_len(slot)
            d = drafts.get(slot, [])
            if d:
                # a drafting lane (its context value-complete) feeds its
                # last context token, then its drafts
                h["tok_ids"][w:w + n] = [req._context_ids()[written]] + d
                h["spec_len"][slot] = len(d)
            elif req._pending_n:
                # only a decode lane can have a token in flight (replays
                # and prefills are value-barriered), and that token is the
                # one it feeds: read it from the device carry
                h["feedback"][w] = 1
            else:
                h["tok_ids"][w:w + n] = req._context_ids()[written:
                                                           written + n]
            h["tok_slot"][w:w + n] = slot
            h["tok_pos"][w:w + n] = np.arange(written, written + n)
            # the row whose logits decide the next token: the first verify
            # row of a drafting lane, else the last row fed
            h["last_idx"][slot] = w + n - 1 - len(d)
            h["q_lens"][slot] = n
            w += n
            if written + n - len(d) == req._ctx_len:
                h["emit_mask"][slot] = 1
                h["produced"][slot] = len(req.output_ids) + req._pending_n
                sh["temp"][slot] = req.temperature
                sh["top_k"][slot] = req.top_k
                sh["top_p"][slot] = req.top_p
                if req.temperature > 0:
                    self._lane_seeds[slot] = req.seed & 0xFFFFFFFF
                completing.append((slot, req, len(d), slot in decode_set))
        sh["seeds"][...] = self._lane_seeds.view(np.int32)
        return completing

    def _pack_dispatch(self) -> _Pending | None:
        """Schedule, pack the step's arrays and DISPATCH the unified step —
        everything that needs only token counts. Returns the in-flight
        entry (``None`` when nothing was scheduled); reads no device
        value."""
        cache = self.cache
        sched, cows, drafts, decode_set = self._schedule()
        if not sched:
            return None
        # steady decode (async only): every scheduled lane is a feedback
        # decode lane and the schedule matches the last full pack's, so the
        # packed arrays differ only in positions and produced counts
        steady_sig = None
        if (self.async_engine and not cows and not drafts
                and all(n == 1 for n in sched.values())
                and all(self.running[s]._pending_n > 0 for s in sched)):
            steady_sig = tuple((s, self.running[s].req_id)
                               for s in sorted(sched))
        st = self._steady
        if steady_sig is not None and st is not None \
                and st["sig"] == steady_sig:
            self._m_steady.inc()
            completing = st["completing"]
            h = self._feed.host
            for w, (slot, req, _, _) in enumerate(completing):
                h["tok_pos"][w] = cache.seq_len(slot)
                h["produced"][slot] = len(req.output_ids) + req._pending_n
        else:
            completing = self._pack(sched, cows, drafts, decode_set)
            self._steady = (dict(sig=steady_sig, completing=completing)
                            if steady_sig is not None else None)
        # could an emission of this step FINISH a request? (the engine's
        # sync-boundary predicate: eos set, or the output budget reachable,
        # up to 1 + drafts tokens for a drafting lane)
        must_sync = any(req.eos_token_id is not None
                        or len(req.output_ids) + req._pending_n + 1 + k_i
                        >= req.max_new_tokens
                        for _, req, k_i, _ in completing)
        fault_point("h2d")
        self._feed.upload()
        self._slow.upload()
        d, sd = self._feed.dev, self._slow.dev
        # the page-table / seq-len views are refreshed BEFORE this step's
        # advance: kv_lens counts the tokens cached before the step
        head = (d["tok_ids"], d["tok_slot"], d["tok_pos"], d["q_lens"],
                cache.seq_lens_device(), d["last_idx"])
        if self.spec_k:
            head += (d["spec_len"],)
        if tracing_active():
            # what kind of work each scheduled request got this step
            for slot, n in sched.items():
                kind = (("spec_verify" if slot in drafts else "decode")
                        if slot in decode_set else "prefill_chunk")
                self._req_event(self.running[slot].req_id, kind,
                                args={"tokens": int(n)})
        fault_point("slow_step")
        fault_point("dispatch")
        with span("dispatch"):
            res = self._unified(
                self.params, *head, d["feedback"], self._prev,
                d["emit_mask"], d["produced"], *cache.pools(),
                cache.page_table_device(), sd["cow_src"], sd["cow_dst"],
                sd["seeds"], sd["temp"], sd["top_k"], sd["top_p"])
        self._mark_dispatch()
        out_dev, ne_dev = (res[0], res[1]) if self.spec_k else (res[0], None)
        if self.async_engine:
            self._prev.copy_(res[2] if self.spec_k else res[0])
        spec_slots = sorted(drafts)
        out = ne = ready = None
        if completing:
            # queued behind the step: reconcile waits on these copies
            # alone, not on the steps dispatched after it
            out = out_dev.to("cpu", non_blocking=True)
            if spec_slots:
                ne = ne_dev.to("cpu", non_blocking=True)
            if out_dev.is_cuda:
                ready = torch.cuda.Event()
                ready.record()
        for _, req, _, _ in completing:
            req._pending_n += 1
        # drafting lanes advance at reconcile, by n_emit (a device value)
        for slot, n in sched.items():
            if slot not in drafts:
                cache.advance(slot, n)
        return _Pending(out, ne, ready, completing, spec_slots, must_sync)

    def _emit(self, req: Request, tok: int) -> None:
        req.output_ids.append(tok)
        self._m_tokens.inc()
        if req.first_token_time is None:
            self._note_first_token(req)

    def _note_first_token(self, req: Request) -> None:
        """TTFT: the histogram, its p99 EMA (the shedding signal) and the
        lane's ``first_token`` instant."""
        req.first_token_time = monotonic()
        self._m_ttft.observe(req.ttft * 1e3)
        a = self.slo.ema_alpha if self.slo is not None else 0.2
        p99 = self._m_ttft.quantile(0.99)
        self._ttft_ema_ms = (p99 if self._ttft_ema_ms is None
                             else (1 - a) * self._ttft_ema_ms + a * p99)
        self._req_event(req.req_id, "first_token")

    def _reconcile_one(self) -> dict[int, list[int]]:
        """Land the OLDEST in-flight step (see :meth:`_reconcile_entry`).
        A recoverable failure drops the whole ring and requeues every
        affected lane (:meth:`_recover_reconcile_failure`)."""
        with span("reconcile"):
            e = self._inflight.popleft()
            self._m_inflight.set(len(self._inflight))
            # the ring-depth track going down too: a drain shows it empty
            counter_event("inflight_steps", len(self._inflight))
            try:
                return self._reconcile_entry(e)
            except RECOVERABLE as exc:
                self._recover_reconcile_failure(e, exc)
                return {}

    def _reconcile_entry(self, e: _Pending) -> dict[int, list[int]]:
        """Wait for ``e``'s copied-out tokens (the hard sync), advance its
        drafting lanes by ``n_emit`` and trim their rejected drafts' pages,
        append the tokens, charge TTFT, the token and the speculation
        counters. A token past a request's budget or eos (as landed), or
        of a request FAILED meanwhile, is dropped."""
        out = ne = None
        if e.completing:
            fault_point("reconcile")
            t0 = monotonic()
            if e.ready is not None:
                e.ready.synchronize()
            out = e.out.numpy()
            ne = None if e.ne is None else e.ne.numpy()
            self._m_sync_s.inc(monotonic() - t0)
            self._did_sync = True
        if not self._inflight:
            self._mark_drained()
        for slot in e.spec_slots:
            # the context token and the accepted drafts are the valid K/V;
            # the pages past them go back, as if never speculated
            self.cache.advance(slot, int(ne[slot]))
            self._m_draft_rollback.inc(self.cache.trim_pages(slot))
        produced: dict[int, list[int]] = {}
        for slot, req, k_i, was_decode in e.completing:
            if self.spec_k:
                m = int(ne[slot]) if k_i else 1
                toks = [int(x) for x in out[slot, :m]]
            else:
                toks = [int(out[slot])]
            emitted = 0
            for tok in toks:
                if req.state == FAILED or stream_done(
                        req.output_ids, req.max_new_tokens,
                        req.eos_token_id):
                    break
                self._emit(req, tok)
                emitted += 1
                produced.setdefault(req.req_id, []).append(tok)
            # the pack charged one pending token a completing lane; a
            # drafting lane's accepted drafts land beside it
            req._pending_n = max(0, req._pending_n - 1)
            if req.state == FINISHED:
                self._count_finished(req)
            if self.spec_k and was_decode:
                acc = int(ne[slot]) - 1 if k_i else 0
                self._m_spec_lane_steps.inc()
                self._m_spec_emitted.inc(emitted)
                self._m_draft_proposed.inc(k_i)
                self._m_draft_src.labels(source=self.draft_source).inc(k_i)
                self._m_draft_accepted.inc(acc)
                if k_i:
                    frac = acc / k_i
                    self._accept_ema = (
                        frac if self._accept_ema is None
                        else 0.8 * self._accept_ema + 0.2 * frac)
                    self._req_event(req.req_id, "spec_accept",
                                    args={"proposed": k_i, "accepted": acc})
                prop = self._drafts.get(req.req_id)
                if prop is not None:
                    prop.update(k_i, acc)
        return produced

    @staticmethod
    def _merge_produced(dst: dict, src: dict) -> None:
        for rid, toks in src.items():
            dst.setdefault(rid, []).extend(toks)

    def _reconcile_all(self) -> dict[int, list[int]]:
        produced: dict[int, list[int]] = {}
        # bounded by the ring at entry: each turn lands one entry, or a
        # failure's recovery empties the ring
        for _ in range(len(self._inflight)):
            if not self._inflight:
                break
            self._merge_produced(produced, self._reconcile_one())
        return produced

    def flush(self) -> dict[int, list[int]]:
        """Land every step in flight (a hard sync) and return the tokens,
        merged in emission order; nothing to do for the sync engine or the
        legacy path."""
        t0 = monotonic()
        self._did_sync = False
        try:
            with span("flush"):
                out = self._reconcile_all()
                self._register_prefixes()
                return out
        finally:
            if self._did_sync:
                self._m_hard_syncs.inc()
            self._m_step_s.inc(monotonic() - t0)
            self._last_round_end = monotonic()

    def _step_unified(self) -> dict[int, list[int]]:
        produced: dict[int, list[int]] = {}
        # speculation's behind-by-one: a drafted step's advance, rollback
        # and proposer feedback land before this round schedules anything,
        # and so does a ring holding the input token of a lane that may
        # draft again (its proposal reads the value-complete context)
        if self._inflight and self.spec_k and (
                any(p.spec_slots for p in self._inflight)
                or any(r._pending_n and self._proposer_k(r) > 0
                       for r in self.running.values())):
            self._merge_produced(produced, self._reconcile_all())
            # a lane whose last prompt token rode the drained step can
            # register its partial tail page only now
            self._register_prefixes()
        # the deadline sweep frees slots, so it runs after the drafted
        # ring landed (its advance still references them)
        if self._deadlines_armed:
            self._shed_expired()
        # value barrier: admission replays a preempted request's context
        # (token VALUES), so a waiting request with tokens in flight lands
        # the whole ring first
        if self._inflight and any(r._pending_n for r in self.waiting):
            self._merge_produced(produced, self._reconcile_all())
        self._retire_finished()
        self._admit_waiting()
        if not self.running:
            self._merge_produced(produced, self._reconcile_all())
            return produced
        with span("pack_dispatch"):
            try:
                entry = self._pack_dispatch()
            except RECOVERABLE as exc:
                # the claims go back with the requeued lanes; the next
                # step() retries
                self._recover_dispatch_failure(exc)
                return produced
        if entry is None:
            self._merge_produced(produced, self._reconcile_all())
            return produced
        self._consec_failures = 0
        self._inflight.append(entry)
        self._m_inflight.set(len(self._inflight))
        counter_event("inflight_steps", len(self._inflight))
        self._m_steps.inc()
        if not self.async_engine:
            # pipeline depth zero: land the step just dispatched
            self._merge_produced(produced, self._reconcile_all())
        elif entry.spec_slots:
            # a drafted step reconciles at the start of the next round
            pass
        else:
            # behind-by-one while an emission boundary is in the ring;
            # otherwise defer up to max_inflight_steps
            while self._inflight and (
                    len(self._inflight) > self.max_inflight_steps
                    or (len(self._inflight) > 1
                        and any(p.must_sync
                                for p in list(self._inflight)[:-1]))):
                self._merge_produced(produced, self._reconcile_one())
        if self.spec_k and self._inflight and self._inflight[-1] is entry:
            # a speculative step whose reconcile outlived this call
            self._m_spec_deferred.inc()
        self._register_prefixes()
        return produced

    # -- legacy (two-program) path -----------------------------------------

    def _bucket(self, n: int) -> int:
        b = self.prefill_bucket
        return max(b, ((n + b - 1) // b) * b)

    def _admit_one_legacy(self, req: Request) -> bool:
        """Claim a slot + pages and prefill ``req``'s context into them."""
        ctx = req._context_ids()
        # all but the LAST context token prefill; the last token becomes
        # the next decode step's input, which produces its successor. A
        # 1-token context prefills the token itself and takes the
        # prefill's greedy argmax as the first output instead.
        prefix, last = ctx[:-1], ctx[-1]
        if not prefix:
            prefix, last = ctx, None
        need_len = len(prefix)
        headroom = 1 if self.running else 0
        if (not self.cache.can_admit(need_len)
                or self.cache.available_page_count
                < self.cache.pages_needed(need_len) + headroom):
            return False
        slot = self.cache.admit(need_len)
        self._note_admit(req, slot, 0)
        # bucket rounding must not push the prefill shape past the model's
        # position table (max_seq_len need not be a bucket multiple)
        padded = min(self._bucket(need_len), self.config.max_seq_len)
        ids = np.zeros((1, padded), np.int32)
        ids[0, :need_len] = prefix
        next_ids = self._prefill(
            self.params, self._put(ids),
            self._put(np.array([need_len], np.int32)), self.cache.k_pool,
            self.cache.v_pool, self.cache.slot_pages(slot)[None])[0]
        if last is None:
            tok = int(next_ids[0])
            self._emit(req, tok)
            self._next_token[slot] = tok
        else:
            self._next_token[slot] = last
        req.state = RUNNING
        self.running[slot] = req
        return True

    def _admit_waiting_legacy(self) -> None:
        while self.waiting and self.cache.free_slot_count:
            req = self.waiting[0]
            if self._finish_waiting_unservable(req):
                continue
            if not self._admit_one_legacy(req):
                if (not self.running and self.cache.available_page_count
                        == self.cache.num_pages):
                    self.waiting.popleft()
                    self._fail_never_admittable(req, self.cache.pages_needed(
                        len(req._context_ids()) - 1))
                    continue
                break
            self.waiting.popleft()

    def _step_legacy(self) -> dict[int, list[int]]:
        if self._deadlines_armed:
            self._shed_expired()
        self._retire_finished()
        # admit/retire to fixpoint: a fresh prompt whose prefill token
        # already satisfies done (budget 1, or eos) retires BEFORE the
        # decode step, and its freed lane can admit the next request
        while True:
            self._admit_waiting_legacy()
            if not any(r.done for r in self.running.values()):
                break
            self._retire_finished()
        if not self.running:
            return {}
        # growth: every running sequence needs room for one more token;
        # sorted() snapshots the slots, as preemption removes entries
        cache = self.cache
        for slot in sorted(self.running):
            if slot not in self.running:
                continue
            if cache.seq_len(slot) + 1 > self.max_seq_len:
                # the length ceiling: stop the sequence now
                req = self.running.pop(slot)
                req.truncated = True
                cache.free(slot)
                self._finish(req)
                continue
            while not cache.ensure_capacity(slot, cache.seq_len(slot) + 1):
                victim_is_self = (max(self.running,
                                      key=lambda s: self.running[s].req_id)
                                  == slot)
                if victim_is_self and len(self.running) == 1:
                    self._requeue_one(slot, RuntimeError(
                        f"slot {slot}: cannot grow to "
                        f"{cache.seq_len(slot) + 1} tokens — page pool too "
                        "small for this sequence"), code="pool_exhausted")
                    break
                self._preempt_youngest()
                if slot not in self.running:  # preempted itself
                    break
        if not self.running:
            return {}
        with span("dispatch"):
            next_ids = self._decode(
                self.params, self._put(self._next_token),
                cache.seq_lens_device(), cache.k_pool, cache.v_pool,
                cache.page_table_device())[0]
        self._mark_dispatch()
        self._m_steps.inc()
        t_sync = monotonic()
        out = next_ids.cpu().numpy()
        self._m_sync_s.inc(monotonic() - t_sync)
        self._did_sync = True
        self._mark_drained()
        produced = {}
        for slot, req in self.running.items():
            tok = int(out[slot])
            self._emit(req, tok)
            self._next_token[slot] = tok
            cache.advance(slot)
            produced[req.req_id] = [tok]
        return produced

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        """A blocking upload (the legacy path is synchronous)."""
        return torch.from_numpy(arr).to(self.device)

    def step(self) -> dict[int, list[int]]:
        """One scheduler round. Returns ``{req_id: [token]}`` for the
        tokens landed this round: the async engine lands them one step (or
        up to ``max_inflight_steps``) behind the dispatch — drain with
        :meth:`flush`; a unified round that only advanced prefill chunks
        produces none (a legacy round's admission prefill of a 1-token
        context emits outside the returned map, as in the reference)."""
        t0 = monotonic()
        self._did_sync = False
        # the pool-squeeze seam ticks every round, above the early returns
        # of an empty round: a squeeze must expire even while its pages
        # are what blocks the next admission
        fault_point("pool", cache=self.cache)
        try:
            if self.unified:
                return self._step_unified()
            return self._step_legacy()
        finally:
            if self._did_sync:
                # ONE hard sync per call however many entries it landed:
                # the oldest blocks, the rest are already on the host
                self._m_hard_syncs.inc()
            self._m_step_s.inc(monotonic() - t0)
            self._m_step_calls.inc()
            self._m_running.set(len(self.running))
            self._m_waiting.set(len(self.waiting))
            self._last_round_end = monotonic()

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
                # no request is left non-terminal, and the predictor stays
                # serviceable for everyone else
                self._fail_stragglers(
                    reqs, f"serving loop exceeded step budget ({limit})")
                raise RuntimeError("serving loop exceeded step budget "
                                   f"({limit}) — scheduler stuck")
        # a request can finish by count with its last tokens in flight
        self.flush()
        return [list(r.output_ids) for r in reqs]

    def _fail_stragglers(self, reqs, message: str) -> None:
        """FAIL every non-terminal request of ``reqs`` with
        ``scheduler_stuck``, releasing the slots and pages they hold."""
        stuck = [r for r in reqs if r.state not in (FINISHED, FAILED)]
        if not stuck:
            return
        ids = {id(r) for r in stuck}
        for slot in [s for s, r in self.running.items() if id(r) in ids]:
            self.running.pop(slot)
            self.cache.free(slot)
        if any(id(r) in ids for r in self.waiting):
            self.waiting = deque(r for r in self.waiting
                                 if id(r) not in ids)
        for req in stuck:
            self._fail(req, "scheduler_stuck", message)


__all__ = ["Request", "ServingPredictor", "SLOConfig", "deadline_passed",
           "stream_done", "RECOVERABLE", "WAITING", "RUNNING", "FINISHED",
           "FAILED"]
