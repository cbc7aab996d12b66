"""Continuous-batching inference engine (PyTorch port, main path).

Slot-based, like the JAX engine: a fixed-width batch of ``max_slots``
lanes decodes together, requests are admitted into and retired from lanes
between steps, and inactive lanes run at ``ctx = 0`` against the null KV
block.

  * **Batched bucketed prefill** -- up to ``max_prefills_per_step`` pending
    prompts are ingested in one ``[P, bucket]`` prefill call (padding lanes
    inactive) and their first tokens are sampled from its logits.
  * **Chunked prefill** -- a prompt longer than the top bucket occupies a
    *prefilling* slot; its chunks stream one batched round per step
    (fewest remaining tokens first), attending to the paged prefix.
  * **K-step decode** -- ``decode_steps_per_iter`` decode steps run as a
    Python loop on device tensors with per-lane ``act``/``done``/
    ``remaining`` masking exactly as the JAX scan does it: ``-1`` marks a
    step where a lane was idle and a masked lane runs at ``ctx = 0``.  The
    host reads the ``[K, B]`` token matrix once per call.
  * Retirement on EOS or on ``max_tokens``; submit-time tail truncation
    keeps ``prompt + max_tokens`` within the per-sequence capacity.
  * Grammar-constrained sampling (``set_grammar``, ``SamplingParams.
    constrained``): a device-resident ``[max_slots]`` FSM state masks each
    lane's logits before sampling and advances with the sampled token, at
    admission, at the final chunk and through the K-step loop.  State 0 is
    FREE, so free and constrained lanes share every call.
  * Sampled decode steps take ``sample_tokens_bounded`` (one top-k over
    ``sample_topk_cap`` logits) when every sampling lane has ``0 < top_k
    <= sample_topk_cap``.
  * The surface ``serving/service.py`` drives: ``token_sink`` (tokens as
    they reach the host, then the result), ``poll``, the queue gauges,
    class-ordered ``should_shed``, queue TTL and per-request deadlines, the
    ``health`` and ``brownout`` slots, SLO-class admission order, and the
    request and phase spans (observability/tracing.py).
  * What the supervisor and the server read: ``release_pool`` (the
    factory frees a dead engine's pages before building the next),
    ``ttft_ema_by_class``, ``kv_tier_stats`` (the device tier) and the
    counters of the mechanisms not ported, at their values with the
    mechanism off.

Reconciliation is synchronous: each dispatch is read back before the next.
Dispatch-ahead, the inflight watchdog and pipeline resets are not ported
(they wait for the decode loop as a CUDA graph and streams).  Where the
JAX engine donates the page arrays to its jitted programs, this engine
updates them in place.  Preemption (and with it voluntary class-ordered
eviction, ``max_preemptions``), speculative decoding, prefix reuse and the
host KV tier are not ported yet; the resident pool may be int8/fp8
(``EngineConfig.kv_dtype``).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Optional

import numpy as np
import torch

from k8s_llm_monitor_tpu_torch.models import llama
from k8s_llm_monitor_tpu_torch.models.config import ModelConfig
from k8s_llm_monitor_tpu_torch.ops.attention import (
    paged_decode_attention,
    select_decode_impl,
    select_prefill_impl,
)
from k8s_llm_monitor_tpu_torch.observability.metrics import ClassHistogram
from k8s_llm_monitor_tpu_torch.observability.tracing import get_tracer
from k8s_llm_monitor_tpu_torch.ops.sampling import (
    fsm_advance,
    fsm_mask_logits,
    greedy_tokens,
    sample_tokens,
    sample_tokens_bounded,
)
from k8s_llm_monitor_tpu_torch.resilience.slo import DEFAULT_CLASS, SLO_RANK
from k8s_llm_monitor_tpu_torch.resilience.tenancy import (
    DEFAULT_TENANT,
    normalize_tenant,
)
from k8s_llm_monitor_tpu_torch.serving.kv_cache import (
    BlockAllocator,
    OutOfBlocks,
    page_slice_bytes,
)


@dataclasses.dataclass
class SamplingParams:
    max_tokens: int = 256
    temperature: float = 0.0   # <= 0 -> greedy
    top_k: int = 0             # <= 0 -> disabled
    top_p: float = 1.0         # >= 1 -> disabled
    # Grammar-constrained decoding (diagnosis/grammar.py): every sampled
    # token is masked by the engine's installed TokenFSM.  Needs
    # ``set_grammar()`` before submit; max_tokens is raised to the
    # grammar's max_len so the forced EOS is always reachable.
    constrained: bool = False


@dataclasses.dataclass
class GenerationRequest:
    request_id: str
    prompt_ids: list[int]
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    submit_time: float = dataclasses.field(default_factory=time.monotonic)
    # Set on first admission; tokens past this index in prompt_ids would be
    # generated output folded back in (by preemption, not ported yet).
    orig_prompt_len: int = -1
    first_token_time: float = 0.0
    # Wall-clock budget from submit (seconds); 0 = none.  Enforced at
    # admission and per step(): an expired request fails with a
    # "deadline exceeded" cause.
    deadline_s: float = 0.0
    # SLO class (resilience/slo.py): "interactive" | "standard" | "batch";
    # orders admission and shedding.  Host-side metadata only.
    slo_class: str = DEFAULT_CLASS
    # Tenant namespace (resilience/tenancy.py).  Host-side metadata only.
    tenant: str = DEFAULT_TENANT
    # Trace context (observability/tracing.py TraceContext) captured at
    # EngineService.submit; the engine records phase spans against it.
    # None when the request is untraced.
    trace: Any = None


@dataclasses.dataclass
class GenerationResult:
    request_id: str
    token_ids: list[int]
    finish_reason: str         # "eos" | "length" | "error"
    ttft_s: float              # submit -> first token
    latency_s: float           # submit -> completion
    error: str = ""            # set when finish_reason == "error"


def prefill_bucket_for(n: int, buckets) -> int:
    """Smallest bucket in ascending ``buckets`` covering ``n`` tokens; ``n``
    past the top bucket raises (longer prompts are chunked)."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(
        f"{n} tokens exceeds the largest prefill bucket "
        f"{buckets[-1]} -- chunk before bucketing")


@dataclasses.dataclass
class EngineConfig:
    max_slots: int = 16
    num_blocks: int = 512
    block_size: int = 16
    max_blocks_per_seq: int = 64
    prefill_buckets: tuple[int, ...] = (32, 64, 128, 256, 512, 1024, 2048)
    # Requests ingested per batched-prefill call (the prefill lane count).
    max_prefills_per_step: int = 8
    # Batched-prefill admission rounds per scheduler step.
    max_admission_rounds: int = 4
    # Decode steps per decode call between host reads.
    decode_steps_per_iter: int = 8
    # ops/attention.py:select_decode_impl -- "auto" | "fused" | "pallas" |
    # "gather".
    decode_path: str = "auto"
    # ops/attention.py:select_prefill_impl -- "auto" | "flash" | "dense".
    prefill_path: str = "auto"
    # Resident KV representation: "auto" keeps the model's dtype ("fp16",
    # "bf16" and "none" mean the same); "int8" / "fp8" hold 1-byte codes
    # plus per-(token, head) float32 scales (models/llama.py:KVPages).
    kv_dtype: str = "auto"
    # When every sampling lane of a decode call has 0 < top_k <= this cap,
    # it samples from the top ``sample_topk_cap`` logits (one torch.topk)
    # instead of sorting the whole vocabulary each step; exact in that
    # regime (ops/sampling.py:sample_tokens_bounded).  0 disables.
    sample_topk_cap: int = 64
    # Time-to-live for requests waiting in the pending queue (seconds;
    # 0 = none).  A request with its own deadline_s uses that instead.
    queue_ttl_s: float = 0.0
    # Load-shedding thresholds (0 = disabled): should_shed() reports a
    # reason when the queued prompt tokens of a class and above, or the
    # admission-wait EMA, cross them.
    shed_queue_tokens: int = 0
    shed_slot_wait_s: float = 0.0
    # Brownout clamp on batch-class max_tokens at admission while the
    # ladder sits at DEGRADED or worse; 0 disables the clamp.
    brownout_batch_max_tokens: int = 64
    # What counts as KV headroom in should_shed()'s capacity clause:
    # "tier" arms it only with a host KV tier (not ported: unarmed),
    # "device" counts free device blocks, "off" disables it.
    kv_admission: str = "tier"


# Sink signature: (request_id, new_token_ids, result_or_none).  ``result`` is
# set exactly once per request, when it completes (or errors); new tokens are
# delivered as they reach the host, the EOS token included.
TokenSink = Callable[[str, list[int], Optional[GenerationResult]], None]


class _Slot:
    __slots__ = ("req", "blocks", "ctx_len", "generated", "prefill_pos",
                 "prefilling", "cancel_requested", "abort_cause")

    def __init__(self, req: GenerationRequest, blocks: list[int]):
        self.req = req
        self.blocks = blocks
        self.ctx_len = 0          # tokens in the KV cache
        self.generated: list[int] = []
        # Long-prompt streaming admission: tokens ingested so far and
        # whether chunks remain (decode skips prefilling slots).
        self.prefill_pos = 0
        self.prefilling = False
        self.cancel_requested = False
        # When set, retirement gives an error result with this cause
        # (deadline expiry, out of KV blocks) instead of eos/length.
        self.abort_cause = ""

    @property
    def remaining(self) -> int:
        return self.req.sampling.max_tokens - len(self.generated)


class InferenceEngine:
    """Single-process engine over batched prefill and K-step decode.

    ``device`` defaults to ``cuda`` (llama.resolve_device); the model's
    weights must live there.  Not thread-safe: one thread owns the engine
    (serving/service.py is the concurrent front end).
    """

    def __init__(self, cfg: ModelConfig, model: llama.LlamaModel,
                 engine_cfg: EngineConfig | None = None, tokenizer=None,
                 eos_id: Optional[int] = None, seed: int = 0, device=None):
        self.device = llama.resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model weights are on {model.device}, the "
                             f"engine runs on {self.device}")
        self.cfg = cfg
        self.model = model
        self.ecfg = ec = engine_cfg or EngineConfig()
        self.tokenizer = tokenizer
        self.eos_id = eos_id if eos_id is not None else (
            tokenizer.eos_id if tokenizer is not None else -1)
        self.token_sink: Optional[TokenSink] = None
        # Attached by EngineService: a resilience.health.HealthMonitor and
        # a brownout-level source (callable -> 0..2).
        self.health = None
        self.brownout = None
        # Resolved before the pool is allocated: "" for a pool in the
        # model's dtype, "int8" / "fp8" for the quantized tier.
        if ec.kv_dtype in ("auto", "fp16", "bf16", "none"):
            self.kv_quant = ""
        elif ec.kv_dtype in ("int8", "fp8"):
            self.kv_quant = ec.kv_dtype
        else:
            raise ValueError(
                f"unknown kv_dtype {ec.kv_dtype!r} (auto | int8 | fp8)")
        self._prefill_attn = select_prefill_impl(self.device, cfg,
                                                 ec.prefill_path)
        self._decode_attn = select_decode_impl(
            self.device, cfg, ec.decode_path, kv_quant=self.kv_quant)
        self.prefill_path = "flash" if self._prefill_attn is not None else "dense"
        impl = self._decode_attn
        if self.kv_quant:
            # Without the fused quant kernel, decode_step runs its gather/
            # dequant branch whatever impl it is handed.
            self.decode_path = ("fused" if llama.is_fused_quant_decode_impl(
                impl) else "gather")
        elif llama.is_fused_decode_impl(impl):
            self.decode_path = "fused"
        elif impl is paged_decode_attention:
            self.decode_path = "gather"
        else:
            self.decode_path = "pallas"
        self.pages = llama.init_kv_pages(cfg, ec.num_blocks, ec.block_size,
                                         self.device,
                                         model.embed.weight.dtype,
                                         kv_quant=self.kv_quant)
        self.allocator = BlockAllocator(ec.num_blocks, ec.block_size)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._tok_state = torch.zeros(ec.max_slots, dtype=torch.int32,
                                      device=self.device)
        # Grammar-constrained decoding (set_grammar): the host TokenFSM, its
        # table on the device, the all-False block that pads the allowed
        # mask past the grammar vocab, and the per-lane FSM state on the
        # device (0 = FREE), rewritten for every lane admitted once a
        # grammar is installed.
        self._grammar = None
        self._fsm_trans: Optional[torch.Tensor] = None
        self._fsm_pad: Optional[torch.Tensor] = None
        self._fsm_state = torch.zeros(ec.max_slots, dtype=torch.int32,
                                      device=self.device)
        self._pending: deque[GenerationRequest] = deque()
        self._slots: list[Optional[_Slot]] = [None] * ec.max_slots
        self._results: dict[str, GenerationResult] = {}
        self.steps = 0            # step() calls
        self.decode_steps = 0     # decode_step calls
        self.decode_tokens = 0    # tokens emitted by decode calls
        self.decode_s = 0.0       # wall time of decode calls (synchronized)
        self.bounded_decode_steps = 0   # decode steps sampled top-k bounded
        self.deadline_expired = 0
        self.brownout_clamps = 0
        # Per-class TTFT EMA (seconds), keyed on first observation; the
        # server's /api/v1/stats reads it.
        self.ttft_ema_by_class: dict[str, float] = {}
        # Counters of mechanisms not ported yet, read by the server's
        # /health and /api/v1/stats: the values the JAX engine has with the
        # mechanism off.  Dispatch-ahead and its watchdog (ROADMAP A2):
        self.dispatch_failures = 0
        self.consecutive_dispatch_failures = 0
        self.watchdog_trips = 0
        # Preemption and the prefix cache (ROADMAP A3):
        self.requeues = 0
        self.preemptions_by_class: dict[str, int] = {}
        self.prefix_cache = None
        self.prefix_deferrals = 0
        # EMA of submit -> admission wait: a shed signal when slots churn
        # slower than requests arrive.
        self.slot_wait_ema_s = 0.0
        # Request-lifecycle histograms per SLO class, with exemplar trace
        # ids, observed on the step thread only.
        _lat = (0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)
        self.hist_ttft = ClassHistogram(_lat)
        self.hist_e2e = ClassHistogram(_lat)
        self.hist_queue_wait = ClassHistogram(_lat)
        self._tracer = get_tracer()

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    @property
    def pool_bytes(self) -> int:
        """Device bytes of the paged KV pool, pages and scales, over every
        layer (serving/kv_cache.py:page_slice_bytes per block)."""
        cfg, ec = self.cfg, self.ecfg
        return cfg.num_layers * ec.num_blocks * page_slice_bytes(
            cfg.num_kv_heads, cfg.head_dim_, ec.block_size,
            self.pages.k[0].element_size(),
            scale_bytes=4 if self.kv_quant else 0)

    def kv_tier_stats(self) -> dict:
        """KV tier byte accounting for /api/v1/stats, in the JAX engine's
        keys.  Only the device tier exists here (the host tier is ROADMAP
        A5), so its counters are 0."""
        return {
            "kv_quant": self.kv_quant,
            "page_dtype": str(self.pages.k[0].dtype).removeprefix("torch."),
            "device_bytes": self.pool_bytes,
            "host_bytes": 0,
            "host_entries": 0,
            "spills": 0,
            "restores": 0,
            "host_lost": 0,
        }

    def release_pool(self) -> None:
        """Drop the KV pool so the caching allocator can give its memory to
        the engine that replaces this one (the supervisor's factory calls
        it on the engine it rebuilds, which serves nothing afterwards).  A
        thread still inside a step keeps the tensors it holds alive until
        it lets go of them."""
        self.pages = None

    @property
    def capacity_tokens(self) -> int:
        """Max cached tokens for one sequence (per-seq table cap and pool)."""
        ec = self.ecfg
        return min(ec.max_blocks_per_seq, ec.num_blocks - 1) * ec.block_size

    def _cap_request(self, req: GenerationRequest) -> None:
        """Enforce prompt_len + max_tokens <= capacity, keeping the prompt
        tail (diagnosis prompts front-load boilerplate)."""
        cap = self.capacity_tokens
        sp = req.sampling
        if sp.max_tokens >= cap:
            req.sampling = dataclasses.replace(sp, max_tokens=cap - 1)
            sp = req.sampling
        overflow = len(req.prompt_ids) + sp.max_tokens - cap
        if overflow > 0:
            req.prompt_ids = req.prompt_ids[overflow:]
            if req.orig_prompt_len >= 0:
                req.orig_prompt_len = max(0, req.orig_prompt_len - overflow)

    def set_grammar(self, fsm) -> None:
        """Install the ``diagnosis.grammar.TokenFSM`` constrained requests
        decode against (one grammar per engine).  The table moves to the
        device here, once; the mask's pad past the grammar vocab is built
        here too, for the widest call (decode lanes or prefill lanes)."""
        if fsm.vocab_size > self.cfg.vocab_size:
            raise ValueError(
                f"grammar vocab {fsm.vocab_size} exceeds model vocab "
                f"{self.cfg.vocab_size}")
        if fsm.eos_id != self.eos_id:
            raise ValueError(
                f"grammar eos_id {fsm.eos_id} != engine eos_id {self.eos_id}")
        extra = self.cfg.vocab_size - fsm.vocab_size
        if extra > 0 and (self._fsm_pad is None
                          or self._fsm_pad.shape[1] != extra):
            rows = max(self.ecfg.max_slots, self.ecfg.max_prefills_per_step)
            self._fsm_pad = torch.zeros((rows, extra), dtype=torch.bool,
                                        device=self.device)
        elif extra == 0:
            self._fsm_pad = None
        self._grammar = fsm
        self._fsm_trans = torch.from_numpy(
            np.ascontiguousarray(fsm.trans, np.int32)).to(self.device)

    def _fsm_entry(self, req: GenerationRequest) -> int:
        """FSM state for ``req``'s next sampled token: the grammar start
        walked through any generated tokens folded back into the prompt; a
        fold the grammar rejects restarts from the start state."""
        if not req.sampling.constrained or self._grammar is None:
            return 0
        gen = (req.prompt_ids[req.orig_prompt_len:]
               if req.orig_prompt_len >= 0 else [])
        state = self._grammar.walk(gen)
        return state if state > 0 else self._grammar.start

    def submit(self, req: GenerationRequest) -> None:
        if not req.prompt_ids:
            raise ValueError("empty prompt")
        if req.sampling.max_tokens < 1:
            raise ValueError("max_tokens must be >= 1")
        # The service normalized already; a raw-engine caller must not
        # smuggle an unvalidated namespace in.
        req.tenant = normalize_tenant(req.tenant, default=DEFAULT_TENANT)
        if req.sampling.constrained:
            if self._grammar is None:
                raise ValueError(
                    "constrained sampling requires set_grammar() first")
            # The grammar's longest accepted sequence bounds generation:
            # raising max_tokens to it never produces more tokens, it only
            # keeps the forced EOS reachable (before the capacity cap).
            ml = self._grammar.max_len
            if ml > 0 and req.sampling.max_tokens < ml:
                req.sampling = dataclasses.replace(req.sampling,
                                                   max_tokens=ml)
        self._cap_request(req)
        self._pending.append(req)

    def submit_text(self, request_id: str, prompt: str,
                    sampling: SamplingParams | None = None) -> None:
        if self.tokenizer is None:
            raise ValueError("submit_text needs a tokenizer")
        self.submit(GenerationRequest(
            request_id=request_id, prompt_ids=self.tokenizer.encode(prompt),
            sampling=sampling or SamplingParams()))

    def poll(self, request_id: str) -> Optional[GenerationResult]:
        return self._results.pop(request_id, None)

    def cancel(self, request_id: str) -> bool:
        """Stop generating for a request.  A pending request fails at once;
        an active slot retires at the start of the next step.  Returns True
        if found."""
        for i, req in enumerate(self._pending):
            if req.request_id == request_id:
                del self._pending[i]
                self._fail_request(req, "cancelled")
                return True
        for s in self._slots:
            if s is not None and s.req.request_id == request_id:
                s.cancel_requested = True
                return True
        return False

    @property
    def has_work(self) -> bool:
        return bool(self._pending) or any(s is not None for s in self._slots)

    @property
    def queue_depth(self) -> int:
        return len(self._pending)

    @property
    def queue_tokens(self) -> int:
        """Prompt-token backlog waiting for admission (shed signal)."""
        return sum(len(r.prompt_ids) for r in self._pending)

    def queue_tokens_by_class(self) -> dict[str, int]:
        """Prompt-token backlog per SLO class (only classes with queued
        work appear)."""
        out: dict[str, int] = {}
        for r in self._pending:
            out[r.slo_class] = out.get(r.slo_class, 0) + len(r.prompt_ids)
        return out

    @property
    def active_slots(self) -> int:
        return sum(1 for s in self._slots if s is not None)

    def admission_headroom_tokens(self) -> int:
        """KV capacity (tokens) admission may count on: the free device
        blocks.  The JAX engine's "tier" policy adds prefix-cache blocks a
        host spill could reclaim; without a prefix cache and a host tier
        that bonus is 0."""
        return self.allocator.free_blocks * self.ecfg.block_size

    def should_shed(self, slo_class: str = DEFAULT_CLASS,
                    need_tokens: int = 0) -> str:
        """Non-empty reason when new work of ``slo_class`` should be shed:
        queue-token backlog or admission-wait EMA above the configured
        thresholds, or (``kv_admission="device"``) a KV footprint
        ``need_tokens`` beyond the free blocks.  EngineService.submit turns
        it into a retriable ``OverloadedError``.

        Class-ordered: a request is charged only for backlog of its own
        class and above, and none is shed while strictly lower-class work
        is queued.  With single-class traffic this is the flat threshold."""
        ec = self.ecfg
        rank = SLO_RANK.get(slo_class, SLO_RANK[DEFAULT_CLASS])
        by_class = self.queue_tokens_by_class()
        ahead = sum(t for c, t in by_class.items()
                    if SLO_RANK.get(c, SLO_RANK[DEFAULT_CLASS]) <= rank)
        lower_queued = any(
            t > 0 and SLO_RANK.get(c, SLO_RANK[DEFAULT_CLASS]) > rank
            for c, t in by_class.items())
        if lower_queued:
            return ""
        if 0 < ec.shed_queue_tokens <= ahead:
            return (f"queue token backlog {ahead} >= "
                    f"{ec.shed_queue_tokens} for class {slo_class}")
        if 0 < ec.shed_slot_wait_s <= self.slot_wait_ema_s:
            return (f"admission wait EMA {self.slot_wait_ema_s:.2f}s >= "
                    f"{ec.shed_slot_wait_s:.2f}s")
        # "tier" arms the capacity clause only with a host tier, which the
        # port does not have yet: as in the JAX engine without one.
        if need_tokens > 0 and ec.kv_admission == "device":
            headroom = self.admission_headroom_tokens()
            if need_tokens > headroom:
                return (f"kv capacity: request needs {need_tokens} tokens, "
                        f"admission headroom is {headroom} "
                        f"(kv_admission={ec.kv_admission})")
        return ""

    def generate(self, prompts: list[list[int]],
                 sampling: SamplingParams | None = None) -> list[GenerationResult]:
        """Synchronous batch generation (runs the loop to completion)."""
        ids = [f"gen-{i}" for i in range(len(prompts))]
        for rid, p in zip(ids, prompts):
            self.submit(GenerationRequest(rid, list(p),
                                          sampling or SamplingParams()))
        while self.has_work:
            self.step()
        return [self._results.pop(rid) for rid in ids]

    def generate_text(self, prompt: str,
                      sampling: SamplingParams | None = None) -> str:
        if self.tokenizer is None:
            raise ValueError("generate_text needs a tokenizer")
        res = self.generate([self.tokenizer.encode(prompt)], sampling)[0]
        return self.tokenizer.decode(res.token_ids)

    # ------------------------------------------------------------------
    # deadlines, SLO classes, brownout, spans
    # ------------------------------------------------------------------

    def _deadline_of(self, req: GenerationRequest, queued: bool) -> float:
        """Absolute monotonic deadline for ``req``; +inf when unbounded.  A
        per-request deadline_s always applies; the queue TTL only bounds
        time spent waiting."""
        if req.deadline_s > 0:
            return req.submit_time + req.deadline_s
        if queued and self.ecfg.queue_ttl_s > 0:
            return req.submit_time + self.ecfg.queue_ttl_s
        return float("inf")

    def _enforce_deadlines(self) -> None:
        """Fail expired queued requests and abort expired running slots
        (they retire with the cause at the cancel check of this step)."""
        now = time.monotonic()
        if self._pending:
            keep: deque[GenerationRequest] = deque()
            for req in self._pending:
                if now > self._deadline_of(req, queued=True):
                    self.deadline_expired += 1
                    self._fail_request(
                        req, f"deadline exceeded after "
                             f"{now - req.submit_time:.2f}s in queue")
                else:
                    keep.append(req)
            self._pending = keep
        for s in self._slots:
            if (s is not None and not s.cancel_requested
                    and now > self._deadline_of(s.req, queued=False)):
                self.deadline_expired += 1
                s.abort_cause = (f"deadline exceeded after "
                                 f"{now - s.req.submit_time:.2f}s "
                                 f"({len(s.generated)} tokens generated)")
                s.cancel_requested = True

    def _note_admission_wait(self, req: GenerationRequest) -> None:
        """Track how long requests wait for a slot (the shed_slot_wait_s
        signal) and record the queue-wait span."""
        now = time.monotonic()
        wait = now - req.submit_time
        self.slot_wait_ema_s = (wait if self.slot_wait_ema_s == 0.0
                                else 0.9 * self.slot_wait_ema_s + 0.1 * wait)
        self.hist_queue_wait.observe(wait, req.slo_class, self._trace_id(req))
        self._span("engine.queue_wait", req.submit_time, now, req)

    def _sort_pending_by_class(self) -> None:
        """Stable-sort the pending queue by SLO rank (FIFO within a class);
        skipped for single-class traffic.  The JAX engine follows this with
        voluntary eviction of lower-class lanes (``max_preemptions``), which
        waits for preemption."""
        if len(self._pending) > 1 and len(
                {r.slo_class for r in self._pending}) > 1:
            self._pending = deque(sorted(
                self._pending,
                key=lambda r: SLO_RANK.get(r.slo_class,
                                           SLO_RANK[DEFAULT_CLASS])))

    def _brownout_level(self) -> int:
        """Current brownout ladder level; 0 when no controller attached."""
        return 0 if self.brownout is None else int(self.brownout())

    def _clamp_for_brownout(self, req: GenerationRequest) -> None:
        """At DEGRADED or worse, clamp batch-class budgets at admission.
        Constrained requests are exempt: the grammar's forced EOS needs its
        longest accepting path reachable."""
        cap = self.ecfg.brownout_batch_max_tokens
        if (cap <= 0 or req.slo_class != "batch"
                or req.sampling.constrained
                or req.sampling.max_tokens <= cap
                or self._brownout_level() < 1):
            return
        req.sampling = dataclasses.replace(req.sampling, max_tokens=cap)
        self.brownout_clamps += 1

    @staticmethod
    def _trace_id(req: GenerationRequest) -> str:
        """Exemplar trace id for histograms ('' when untraced/unsampled)."""
        ctx = req.trace
        return ctx.trace_id if ctx is not None and ctx.sampled else ""

    def _span(self, name: str, t0: float, t1: float,
              req: GenerationRequest, status: str = "ok", **attrs) -> None:
        """Record one engine phase span under ``req``'s trace; a no-op for
        untraced or unsampled requests."""
        ctx = req.trace
        if ctx is None or not ctx.sampled:
            return
        attrs["request_id"] = req.request_id
        attrs["class"] = req.slo_class
        self._tracer.record(name, t0, t1, ctx, attrs=attrs, status=status)

    def _end_request_span(self, req: GenerationRequest, status: str,
                          **attrs) -> None:
        """Close the per-request root span (submit -> terminal outcome)
        under the context's own span id, so phase spans nest under it."""
        ctx = req.trace
        if ctx is None or not ctx.sampled:
            return
        attrs["request_id"] = req.request_id
        attrs["class"] = req.slo_class
        self._tracer.record(
            "engine.request", req.submit_time, time.monotonic(), ctx,
            span_id=ctx.span_id, parent_id=ctx.parent_id,
            attrs=attrs, status=status)

    # ------------------------------------------------------------------
    # engine loop
    # ------------------------------------------------------------------

    def step(self) -> None:
        """One scheduler iteration: expire deadlines, order the queue by SLO
        class, retire cancelled slots, run up to ``max_admission_rounds``
        batched prefills, one chunk round and one K-step decode call."""
        self.steps += 1
        self._enforce_deadlines()
        self._sort_pending_by_class()
        for i, s in enumerate(self._slots):
            if s is not None and s.cancel_requested:
                self._retire(i)
        rounds = 0
        while rounds < self.ecfg.max_admission_rounds and self._admit_round():
            rounds += 1
        self._prefill_chunks()
        self._decode()

    def _bucket(self, n: int) -> int:
        return prefill_bucket_for(n, self.ecfg.prefill_buckets)

    def _lane_count(self, n: int) -> int:
        """Smallest power of two covering ``n``, capped at
        ``max_prefills_per_step``."""
        P = 1
        while P < n:
            P <<= 1
        return min(P, self.ecfg.max_prefills_per_step)

    def _table_width(self, max_tokens_covered: int) -> int:
        """Block-table width for a chunk round: the deepest lane's blocks,
        rounded up to 32 (the gather path reads table-width keys)."""
        bs = self.ecfg.block_size
        need = (max_tokens_covered + bs - 1) // bs
        return min(self.ecfg.max_blocks_per_seq, (need + 31) // 32 * 32)

    def _lane_buffers(self, P: int, bucket: int, table_width: int):
        return (np.zeros((P, bucket), np.int32), np.zeros((P,), np.int32),
                np.zeros((P,), np.int32), np.zeros((P, table_width), np.int32),
                np.zeros((P,), np.float32), np.zeros((P,), np.int32),
                np.ones((P,), np.float32))

    def _t(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _first_tokens(self, logits, temp, topk, topp, greedy: bool,
                      fstate: Optional[np.ndarray] = None):
        """First tokens of a prefill call's lanes, and with ``fstate`` (the
        lanes' FSM states, 0 for free lanes) their logits masked by the
        grammar first and the states after the sampled tokens.  Returns
        (tokens, next FSM states or None)."""
        fnext = None
        if fstate is not None:
            fst = self._t(fstate)
            logits = fsm_mask_logits(logits, fst, self._fsm_trans,
                                     self._fsm_pad)
        if greedy:
            first = greedy_tokens(logits)
        else:
            first = sample_tokens(self._gen, logits,
                                  temperature=self._t(temp),
                                  top_k=self._t(topk), top_p=self._t(topp))
        if fstate is not None:
            fnext = fsm_advance(fst, self._fsm_trans, first)
        return first, fnext

    def _fail_request(self, req: GenerationRequest, msg: str) -> None:
        result = GenerationResult(
            request_id=req.request_id,
            token_ids=(req.prompt_ids[req.orig_prompt_len:]
                       if req.orig_prompt_len >= 0 else []),
            finish_reason="error", ttft_s=0.0,
            latency_s=time.monotonic() - req.submit_time, error=msg)
        self._results[req.request_id] = result
        self.hist_e2e.observe(result.latency_s, req.slo_class,
                              self._trace_id(req))
        self._end_request_span(req, "error", finish_reason="error",
                               error=msg[:200])
        if self.token_sink is not None:
            self.token_sink(req.request_id, [], result)

    def _emit(self, req: GenerationRequest, toks: list[int]) -> None:
        if self.token_sink is not None and toks:
            self.token_sink(req.request_id, toks, None)

    def _admit_round(self) -> bool:
        """Admit pending prompts into free slots: short ones in one batched
        prefill call (first token sampled from its logits), long ones into
        prefilling slots for chunk rounds.  Returns True if anything was
        admitted."""
        ec = self.ecfg
        top = ec.prefill_buckets[-1]
        free = [i for i, s in enumerate(self._slots) if s is None]
        admitted_long = 0
        batch: list[tuple[int, GenerationRequest, list[int]]] = []
        while len(batch) < ec.max_prefills_per_step and self._pending and free:
            req = self._pending[0]
            if time.monotonic() > self._deadline_of(req, queued=True):
                self._pending.popleft()
                self.deadline_expired += 1
                self._fail_request(
                    req, f"deadline exceeded after "
                         f"{time.monotonic() - req.submit_time:.2f}s in queue")
                continue
            L = len(req.prompt_ids)
            if L + 1 > self.capacity_tokens:
                # submit() caps requests, so only internal misuse gets here.
                self._pending.popleft()
                self._fail_request(req, f"prompt of {L} tokens exceeds "
                                        f"capacity {self.capacity_tokens}")
                continue
            if not self.allocator.can_alloc(L + 1):
                break
            self._pending.popleft()
            if req.orig_prompt_len < 0:
                req.orig_prompt_len = L
            blocks = self.allocator.alloc(L + 1)
            self._note_admission_wait(req)
            self._clamp_for_brownout(req)
            if L > top:
                slot = _Slot(req, blocks)
                slot.ctx_len = L
                slot.prefilling = True
                self._slots[free.pop(0)] = slot
                admitted_long += 1
                continue
            batch.append((free.pop(0), req, blocks))
        if not batch:
            return admitted_long > 0

        P = self._lane_count(len(batch))
        bucket = self._bucket(max(len(r.prompt_ids) for _, r, _ in batch))
        tokens, _, lengths, tables, temp, topk, topp = self._lane_buffers(
            P, bucket, ec.max_blocks_per_seq)
        fstate = np.zeros((P,), np.int32)
        for j, (_, req, blocks) in enumerate(batch):
            L = len(req.prompt_ids)
            tokens[j, :L] = req.prompt_ids
            lengths[j] = L
            tables[j, :len(blocks)] = blocks
            sp = req.sampling
            temp[j], topk[j], topp[j] = sp.temperature, sp.top_k, sp.top_p
            fstate[j] = self._fsm_entry(req)
        t0 = time.monotonic()
        logits, _ = llama.prefill(self.model, self._t(tokens),
                                  self._t(lengths), self.pages,
                                  self._t(tables), attn_impl=self._prefill_attn)
        greedy = all(r.sampling.temperature <= 0.0 for _, r, _ in batch)
        # Any constrained lane masks the call; free lanes ride at state 0.
        constrained = any(r.sampling.constrained for _, r, _ in batch)
        first, fnext = self._first_tokens(logits, temp, topk, topp, greedy,
                                          fstate if constrained else None)
        lanes = []
        for j, (slot_idx, req, blocks) in enumerate(batch):
            slot = _Slot(req, blocks)
            slot.ctx_len = len(req.prompt_ids)
            self._slots[slot_idx] = slot
            lanes.append((j, slot_idx))
        self._place_first_tokens(first, lanes, fnext, "engine.prefill", t0,
                                 {"bucket": bucket, "lanes": len(batch)})
        return True

    def _prefill_chunks(self) -> bool:
        """One batched chunk round for slots in prefilling state, fewest
        remaining tokens first; lanes whose chunk is final sample their
        first token from its logits."""
        ec = self.ecfg
        top = ec.prefill_buckets[-1]
        cands = [(i, s) for i, s in enumerate(self._slots)
                 if s is not None and s.prefilling]
        if not cands:
            return False
        cands.sort(key=lambda t: (len(t[1].req.prompt_ids) - t[1].prefill_pos,
                                  t[1].req.submit_time))
        cands = cands[:ec.max_prefills_per_step]
        P = self._lane_count(len(cands))
        bucket = self._bucket(min(top, max(
            len(s.req.prompt_ids) - s.prefill_pos for _, s in cands)))
        W = self._table_width(max(
            s.prefill_pos + min(bucket, len(s.req.prompt_ids) - s.prefill_pos)
            for _, s in cands))
        tokens, start, lengths, tables, temp, topk, topp = self._lane_buffers(
            P, bucket, W)
        fstate = np.zeros((P,), np.int32)
        lanes = []
        greedy = True
        constrained = False
        for j, (i, s) in enumerate(cands):
            L = len(s.req.prompt_ids)
            n = min(bucket, L - s.prefill_pos)
            tokens[j, :n] = s.req.prompt_ids[s.prefill_pos:s.prefill_pos + n]
            start[j] = s.prefill_pos
            lengths[j] = n
            nb = min(len(s.blocks), W)
            tables[j, :nb] = s.blocks[:nb]
            s.prefill_pos += n
            if s.prefill_pos >= L:
                s.prefilling = False
                sp = s.req.sampling
                temp[j], topk[j], topp[j] = sp.temperature, sp.top_k, sp.top_p
                greedy = greedy and sp.temperature <= 0.0
                # Only final lanes sample, so only they consult the FSM.
                fstate[j] = self._fsm_entry(s.req)
                constrained = constrained or sp.constrained
                lanes.append((j, i))
        t0 = time.monotonic()
        logits, _ = llama.prefill_chunk(
            self.model, self._t(tokens), self._t(start), self._t(lengths),
            self.pages, self._t(tables), attn_impl=self._prefill_attn)
        if lanes:
            first, fnext = self._first_tokens(
                logits, temp, topk, topp, greedy,
                fstate if constrained else None)
            self._place_first_tokens(first, lanes, fnext,
                                     "engine.prefill_chunk", t0,
                                     {"bucket": bucket, "lanes": len(cands)})
        return True

    def _place_first_tokens(self, first: torch.Tensor, lanes,
                            fnext: Optional[torch.Tensor], span: str,
                            t0: float, span_attrs: dict) -> None:
        """Write first tokens (and, with a grammar installed, every admitted
        lane's FSM state: the state after its first token for a constrained
        lane, 0 for a free one, which clears what a constrained occupant of
        a reused slot left) into the device buffers, then reconcile them:
        emission, TTFT, retirement."""
        rows = torch.tensor([j for j, _ in lanes], device=self.device)
        idx = torch.tensor([i for _, i in lanes], device=self.device)
        self._tok_state[idx] = first[rows]
        if self._fsm_trans is not None:
            self._fsm_state[idx] = (fnext[rows] if fnext is not None else 0)
        host = first.cpu().tolist()
        now = time.monotonic()
        for j, slot_idx in lanes:
            s = self._slots[slot_idx]
            tok = int(host[j])
            s.generated.append(tok)
            req = s.req
            if req.first_token_time == 0.0:
                req.first_token_time = now
                ttft = now - req.submit_time
                self.hist_ttft.observe(ttft, req.slo_class,
                                       self._trace_id(req))
                prev = self.ttft_ema_by_class.get(req.slo_class)
                self.ttft_ema_by_class[req.slo_class] = (
                    ttft if prev is None else 0.9 * prev + 0.1 * ttft)
            self._span(span, t0, now, req,
                       constrained=req.sampling.constrained, **span_attrs)
            self._emit(req, [tok])
            if self._is_finished(s):
                self._retire(slot_idx)

    def _decode(self) -> bool:
        """One K-step decode call over the lanes with budget left."""
        ec = self.ecfg
        B = ec.max_slots
        lanes = [(i, s) for i, s in enumerate(self._slots)
                 if s is not None and not s.prefilling and s.remaining > 0
                 and not s.cancel_requested]
        if not lanes:
            return False
        kmax = min(ec.decode_steps_per_iter, max(s.remaining for _, s in lanes))
        K = 1 << (kmax.bit_length() - 1)
        ctx = np.zeros((B,), np.int32)
        remaining = np.zeros((B,), np.int32)
        table = np.zeros((B, ec.max_blocks_per_seq), np.int32)
        temp = np.zeros((B,), np.float32)
        topk = np.zeros((B,), np.int32)
        topp = np.ones((B,), np.float32)
        for i, s in list(lanes):
            steps_i = min(K, s.remaining)
            try:
                self.allocator.extend(s.blocks, s.ctx_len + steps_i)
            except OutOfBlocks as exc:
                # Preemption is not ported: the lane ends with an error.
                s.abort_cause = f"out of KV blocks: {exc}"
                self._retire(i)
                lanes.remove((i, s))
                continue
            ctx[i] = s.ctx_len
            remaining[i] = steps_i
            table[i, :len(s.blocks)] = s.blocks
            sp = s.req.sampling
            temp[i], topk[i], topp[i] = sp.temperature, sp.top_k, sp.top_p
        if not lanes:
            return False
        greedy = all(s.req.sampling.temperature <= 0.0 for _, s in lanes)
        # Any constrained lane masks the call (free lanes at state 0); greedy
        # lanes then take the argmax of the masked logits.
        constrained = self._fsm_trans is not None and any(
            s.req.sampling.constrained for _, s in lanes)
        cap = ec.sample_topk_cap
        bounded = not greedy and cap > 0 and all(
            0 < s.req.sampling.top_k <= cap
            for _, s in lanes if s.req.sampling.temperature > 0.0)
        t0 = time.monotonic()
        toks = self._decode_call(K, self._t(ctx), self._t(remaining),
                                 self._t(table), temp, topk, topp, greedy,
                                 bounded, constrained)
        arr = toks.cpu().numpy()
        now = time.monotonic()
        self.decode_s += now - t0
        self.decode_steps += K
        if bounded:
            self.bounded_decode_steps += K
        for i, s in lanes:
            new = [int(t) for t in arr[:, i] if t >= 0]
            self.decode_tokens += len(new)
            self._span("engine.decode", t0, now, s.req,
                       steps=int(remaining[i]), emitted=len(new))
            if not new:
                continue
            s.ctx_len += len(new)
            s.generated.extend(new)
            self._emit(s.req, new)
            if self._is_finished(s):
                self._retire(i)
        return True

    def _decode_call(self, K: int, ctx, remaining, table, temp, topk, topp,
                     greedy: bool, bounded: bool,
                     constrained: bool) -> torch.Tensor:
        """K decode steps with on-device token feedback.  The masking is the
        JAX scan's: a lane is active while it started active, has not hit
        EOS and has steps left; an idle lane runs at ctx 0 (null block) and
        emits -1.  ``constrained`` carries the per-lane FSM state through
        the steps (masked logits, advanced on active lanes only);
        ``bounded`` samples from the top ``sample_topk_cap`` logits.
        Returns the [K, max_slots] token matrix."""
        if not greedy:
            temp_t, topk_t, topp_t = self._t(temp), self._t(topk), self._t(topp)
        active0 = ctx > 0
        done = torch.zeros_like(active0)
        tokens = self._tok_state
        fstate = self._fsm_state
        outs = []
        for i in range(K):
            act = active0 & ~done & (i < remaining)
            ctx_eff = torch.where(act, ctx, torch.zeros_like(ctx))
            logits, _ = llama.decode_step(self.model, tokens, ctx_eff,
                                          self.pages, table,
                                          attn_impl=self._decode_attn)
            if constrained:
                logits = fsm_mask_logits(logits, fstate, self._fsm_trans,
                                         self._fsm_pad)
            if greedy:
                nxt = greedy_tokens(logits)
            elif bounded:
                nxt = sample_tokens_bounded(
                    self._gen, logits, temperature=temp_t, top_k=topk_t,
                    top_p=topp_t, k_cap=self.ecfg.sample_topk_cap)
            else:
                nxt = sample_tokens(self._gen, logits, temperature=temp_t,
                                    top_k=topk_t, top_p=topp_t)
            nxt = torch.where(act, nxt, tokens)
            if constrained:
                fstate = torch.where(
                    act, fsm_advance(fstate, self._fsm_trans, nxt), fstate)
            done = done | (act & (nxt == self.eos_id))
            ctx = torch.where(act, ctx + 1, ctx)
            outs.append(torch.where(act, nxt, torch.full_like(nxt, -1)))
            tokens = nxt
        self._tok_state = tokens
        self._fsm_state = fstate
        return torch.stack(outs)

    def _is_finished(self, s: _Slot) -> bool:
        return bool(s.generated) and (
            s.generated[-1] == self.eos_id
            or len(s.generated) >= s.req.sampling.max_tokens)

    def _retire(self, slot_idx: int) -> None:
        s = self._slots[slot_idx]
        now = time.monotonic()
        req = s.req
        toks = req.prompt_ids[req.orig_prompt_len:] + s.generated
        reason = "eos" if toks and toks[-1] == self.eos_id else "length"
        if reason == "eos":
            toks = toks[:-1]
        error = s.abort_cause
        if error:
            reason = "error"
        result = GenerationResult(
            request_id=req.request_id, token_ids=toks, finish_reason=reason,
            ttft_s=(req.first_token_time - req.submit_time
                    if req.first_token_time > 0.0 else 0.0),
            latency_s=now - req.submit_time, error=error)
        self._results[req.request_id] = result
        self.hist_e2e.observe(result.latency_s, req.slo_class,
                              self._trace_id(req))
        self._end_request_span(
            req, "error" if error else "ok", finish_reason=reason,
            tokens=len(toks), ttft_s=round(result.ttft_s, 6))
        self.allocator.free(s.blocks)
        self._slots[slot_idx] = None
        if self.token_sink is not None:
            self.token_sink(req.request_id, [], result)
