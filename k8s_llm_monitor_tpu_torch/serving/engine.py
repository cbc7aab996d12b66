"""Continuous-batching inference engine (PyTorch port, main path).

Slot-based, like the JAX engine: a fixed-width batch of ``max_slots``
lanes decodes together, requests are admitted into and retired from lanes
between steps, and inactive lanes run at ``ctx = 0`` against the null KV
block.

  * **Batched bucketed prefill** -- up to ``max_prefills_per_step`` pending
    prompts are ingested in one ``[P, bucket]`` prefill call (padding lanes
    inactive) and their first tokens are sampled from its logits.  With
    the flash prefill kernel the bucket ladder gains 4096 and 8192 where
    the per-sequence capacity allows, as in the JAX engine.
  * **Prefix reuse** (``prefix_cache_entries``, serving/kv_cache.py:
    ``PrefixCache``) -- each candidate looks up its longest cached prefix
    (tenant-namespaced digests) and prefills only its suffix over the
    shared pages; a round with any hit runs the chunked program with
    per-lane starts.  Pages publish at dispatch.  Cold-burst dedup holds a
    candidate back one round behind a same-prefix lane of the round, and a
    chunk-path candidate behind a streaming publisher (``defer_budget``,
    ``prefix_deferrals``).
  * **Chunked prefill** -- a prompt (suffix) longer than the top bucket
    occupies a *prefilling* slot; its chunks stream one batched round per
    step (fewest remaining tokens first), attending to the paged prefix;
    ``interactive_chunk_bucket`` shrinks rounds while interactive work
    waits.
  * **K-step decode program** -- ``decode_steps_per_iter`` decode steps
    run as one program per (K, sampler, constrained), the counterpart of
    the JAX engine's compiled scan (``_DecodeProgram``), with per-lane
    ``act``/``done``/``remaining`` masking exactly as the scan does it:
    ``-1`` marks a step where a lane was idle and a masked lane runs at
    ``ctx = 0``.  On CUDA each program is captured into a CUDA graph at
    first use and replayed (``EngineConfig.decode_graphs``).
  * **Calls in flight** -- admission rounds (``admit``), chunk rounds
    (``chunk``) and decode calls (``decode``) are queued in dispatch order;
    up to ``max_inflight`` stay in flight after ``step()`` returns.  Each
    call fills a pinned host stage of its own, copies it in and its sampled
    tokens back with ``non_blocking`` copies behind a CUDA event, so the
    host never waits for a call to dispatch the next; first tokens are
    placed into the device token and FSM buffers on the stream.  The next
    call is planned from the lanes' predicted state (``pending_admit``,
    ``ctx_pred``, ``remaining_pred``).  Reconciliation emits tokens and
    retires lanes; a lane's steps past its EOS in a later call (zombie
    steps) write its own pages and are dropped, and a retired lane's pages
    are freed once the newest call that may reference them is reconciled.
  * **Preemption** -- a lane that cannot extend its pages first evicts LRU
    prefix entries, then reconciles everything in flight, then preempts
    the lowest-class, youngest lane by recompute (its generated tokens
    folded into the prompt, requeued at the head of the queue); a strictly
    higher-class request waiting with no free slot evicts lower-class
    lanes the same way (``max_preemptions`` per step).
  * **Recovery** -- fault points (resilience/faults.py:
    ``prefill_dispatch``, ``decode_dispatch``, ``decode_stuck``,
    ``lane_eviction``, ``slow_host_callback``, the allocator's
    ``alloc_exhaustion``), dispatch-failure accounting with rollback, the
    in-flight watchdog (``dispatch_timeout_s``) and the pipeline reset:
    calls in flight are dropped, the prefix cache is cleared and every
    live lane is requeued by recompute (``max_requeues``).  The port's
    pages are updated in place on one stream, so a dropped call cannot
    poison them; the reset keeps the JAX engine's semantics all the same
    (ids and counters match), and keeps the decode graphs.
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
  * **Speculative decoding** (``spec_k``, serving/spec.py) -- a decode
    call may instead run ``spec_rounds_per_iter`` verify rounds: each
    proposes ``spec_k`` drafts per lane by n-gram lookup over the lane's
    token history (``_hist``, written at admission and extended on the
    device), verifies the ``spec_k + 1`` positions in one forward
    (llama.verify_step: flash prefill when it is on, else the split paged
    attention kernel on a bf16 pool, else the gather) and accepts
    a draft prefix plus the model's token (argmax, or the delta-draft
    sampling rule).  A spec call drains the pipeline first (its emission is
    data-dependent); constrained lanes, brownout level >= 1 and a request
    class whose acceptance EMA sits under ``spec_min_accept`` (probed every
    ``spec_probe_every`` dispatches) take the plain decode program.  The
    spec program is a sibling of the decode program (``_SpecProgram``),
    captured as a CUDA graph the same way.
  * The surface ``serving/service.py`` drives: ``token_sink`` (tokens as
    they reach the host, then the result), ``poll``, the queue gauges,
    class-ordered ``should_shed``, queue TTL and per-request deadlines, the
    ``health`` and ``brownout`` slots, SLO-class scheduling, and the
    request and phase spans (observability/tracing.py).
  * **KV tiers** (serving/kv_tier.py) -- rung 1, the resident pool: the
    model's dtype, ``ModelConfig.kv_dtype`` (``float8_e4m3fn``,
    ``float8_e5m2``, ``float16``: unscaled pages on the same kernels) or
    the int8/fp8 tier with scale planes (``EngineConfig.kv_dtype``).  Rung 2 (``host_spill_bytes`` or a
    ``host_kv_tier`` the supervisor's factory keeps across rebuilds): a
    pressured prefix-cache eviction spills its page rows to host RAM, and
    an admission whose prompt hits a spilled prefix writes them back in
    place instead of prefilling it.  Rung 3: ``export_prefix`` /
    ``install_prefix`` move a cached prefix between engines as a KVX1 blob
    that either package's engine installs.
  * What the supervisor and the server read: ``release_pool`` (the
    factory frees a dead engine's pages before building the next),
    ``ttft_ema_by_class``, ``kv_tier_stats`` (the device and host tiers
    and the per-tenant cached blocks), the prefix cache's counters and the
    recovery counters.

  * **Tensor parallelism** (``mesh``, parallel/mesh.py; the model built on
    the same mesh): this engine is rank 0 and schedules; every device call
    (``_device``: admission and chunk rounds, decode and spec programs,
    the grammar table, history rows, the pool's release) is sent to the
    workers' copies of the engine before it runs here, so every rank runs
    the same program on its kv-head slice of the pages (allocated at the
    local width; block ids stay global).  Under a mesh the fused decode
    kernels are off (the split path with B3 per shard), and
    ``tp_overlap`` "on" swaps the decode step's all-reduces for the
    reduce-scatter / all-gather schedule (parallel/overlap.py).  Under
    gloo the decode programs run eagerly (``decode_graphs`` False).  The
    host tier and KVX1 blobs hold whole rows (every kv head): a spill or
    an export gathers the ranks' page slices, a restore or an install
    broadcasts the rows and each rank writes its slice.  The decode
    collective shares use the all-reduce's bus rate measured on the mesh
    at this engine's payload (``Mesh.bus_gbs``).  A mesh with a ``seq``
    axis splits every admission, chunk and prefix-hit round's positions
    over it (models/llama.py; a prefill bucket the seq degree does not
    divide raises at build, as in the JAX engine); decode, verify and
    spec calls, and the ``data`` axis, are replicated.  Over NCCL this
    rank's prefill launches are paced and its reconcile waits poll
    (parallel/mesh.py: ``LaunchPacer``, ``Mesh.wait_event``), so a dead
    rank's collective never holds it inside an enqueue.
    A call that raises on this rank after the workers were sent it, or a
    worker that fails or exits, breaks the mesh: the step raises
    ``MeshBroken`` (no retry), and the supervisor's factory builds a new
    mesh (monitor/analysis.py).

As in the JAX engine, ``K8SLLM_KV_DTYPE``, ``K8SLLM_PREFILL_PATH``,
``K8SLLM_DECODE_PATH`` and ``K8SLLM_TP_OVERLAP`` override ``kv_dtype``,
``prefill_path``, ``decode_path`` and ``tp_overlap``.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import time
from collections import deque
from typing import Any, Callable, Optional

import numpy as np
import torch

from k8s_llm_monitor_tpu_torch.devtools.lockcheck import make_lock
from k8s_llm_monitor_tpu_torch.models import llama
from k8s_llm_monitor_tpu_torch.models.config import ModelConfig
from k8s_llm_monitor_tpu_torch.ops.attention import (
    paged_decode_attention,
    select_decode_impl,
    select_prefill_impl,
    select_verify_impl,
)
from k8s_llm_monitor_tpu_torch.observability.flight import get_flight_recorder
from k8s_llm_monitor_tpu_torch.observability.metrics import ClassHistogram
from k8s_llm_monitor_tpu_torch.observability.tracing import get_tracer
from k8s_llm_monitor_tpu_torch.ops.paged_attention import (
    KERNEL_WRAPPERS,
    count_launches,
    thread_launches,
)
from k8s_llm_monitor_tpu_torch.parallel.mesh import LaunchPacer, MeshBroken
from k8s_llm_monitor_tpu_torch.parallel.overlap import (
    overlap_decode_step,
    overlap_supported,
)
from k8s_llm_monitor_tpu_torch.parallel.sharding import kv_sharded
from k8s_llm_monitor_tpu_torch.ops.sampling import (
    fsm_advance,
    fsm_mask_logits,
    greedy_tokens,
    sample_tokens,
    sample_tokens_bounded,
)
from k8s_llm_monitor_tpu_torch.resilience.faults import FaultError, get_injector
from k8s_llm_monitor_tpu_torch.resilience.slo import DEFAULT_CLASS, SLO_RANK
from k8s_llm_monitor_tpu_torch.resilience.tenancy import (
    DEFAULT_TENANT,
    normalize_tenant,
)
from k8s_llm_monitor_tpu_torch.serving.kv_cache import (
    BlockAllocator,
    OutOfBlocks,
    PrefixCache,
    page_slice_bytes,
    shareable_blocks,
)
from k8s_llm_monitor_tpu_torch.serving.kv_tier import (
    BlobError,
    HostKVTier,
    SpilledPrefix,
    pack_prefix_blob,
    unpack_prefix_blob,
)
from k8s_llm_monitor_tpu_torch.serving.spec import (
    AcceptanceEMA,
    accept_greedy,
    accept_sampled,
    propose_drafts,
)

logger = logging.getLogger("k8s_llm_monitor_tpu_torch.serving.engine")

# The environment overrides a mesh's workers take from rank 0.
_ENV_OVERRIDES = ("K8SLLM_KV_DTYPE", "K8SLLM_PREFILL_PATH",
                  "K8SLLM_DECODE_PATH", "K8SLLM_TP_OVERLAP")

# Interleaved timing rounds of ``profile_decode_phases`` on the card.
DECODE_PHASE_TRIALS = 5


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
    # Set on first admission; tokens past this index in prompt_ids are
    # generated output folded back in by preemption or a requeue.
    orig_prompt_len: int = -1
    first_token_time: float = 0.0
    # Cold-burst dedup: set the first time admission holds this request
    # back so a same-prefix lane can publish the shared pages first; caps
    # the same-round rule at one round and counts each request once.
    prefix_deferred: bool = False
    # Wall-clock budget from submit (seconds); 0 = none.  Enforced at
    # admission and per step(): an expired request fails with a
    # "deadline exceeded" cause.
    deadline_s: float = 0.0
    # Recompute requeues by pipeline resets and failed admissions,
    # bounded by EngineConfig.max_requeues.
    requeues: int = 0
    # SLO class (resilience/slo.py): "interactive" | "standard" | "batch";
    # orders admission, shedding and eviction.  Host-side metadata only.
    slo_class: str = DEFAULT_CLASS
    # Tenant namespace (resilience/tenancy.py): seeds the request's
    # prefix-cache digest chain, so its KV reuse stays within its tenant.
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


def _page_dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of a page dtype ("bfloat16", "float8_e4m3fn",
    "float8_e5m2", "float16", "int8", "float32"): the JAX engine's
    ``kv_tier_stats`` and blob META name."""
    return str(dtype).removeprefix("torch.")


# Host arrays of the pool's leaves, for the spill tier and the blobs: numpy
# has no bf16 or fp8, so those rows are held as their bytes (uint16, uint8),
# and fp16 rows alike (uint16).
_HOST_DTYPE = {torch.bfloat16: np.uint16, torch.float8_e4m3fn: np.uint8,
               torch.float8_e5m2: np.uint8, torch.float16: np.uint16,
               torch.int8: np.int8, torch.float32: np.float32}


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
    # Dispatch-ahead depth: calls (admission, chunk and decode) left in
    # flight when step() returns; 0 reconciles each call in the step that
    # dispatched it.
    max_inflight: int = 2
    # False reads each admission and chunk round's first tokens back in the
    # round that dispatched it, waiting for every call in flight (the loop
    # before admission calls went in flight; kept to compare the two).
    admit_inflight: bool = True
    # While chunk rounds are pending, a decode call is dispatched only every
    # Nth step, so a long prompt's chunks reach its first token sooner; N
    # bounds the stall of lanes already decoding.  1 = strict alternation.
    decode_every_n_chunk_rounds: int = 3
    # While an interactive-class request waits in the queue, chunk rounds
    # clamp their bucket to this size (rounded up to a prefill bucket), so
    # the queued request's admission is not held behind a full chunk.
    # 0 disables.
    interactive_chunk_bucket: int = 0
    # On CUDA, run each K-step decode program as a CUDA graph captured at
    # its first call; False runs it eagerly (to compare the two on the
    # card).  The CPU always runs it eagerly.
    decode_graphs: bool = True
    # ops/attention.py:select_decode_impl -- "auto" | "fused" | "pallas" |
    # "gather"; K8SLLM_DECODE_PATH overrides it.
    decode_path: str = "auto"
    # ops/attention.py:select_prefill_impl -- "auto" | "flash" | "dense";
    # K8SLLM_PREFILL_PATH overrides it.
    prefill_path: str = "auto"
    # Resident KV representation: "auto" keeps the model's dtype ("fp16",
    # "bf16" and "none" mean the same); "int8" / "fp8" hold 1-byte codes
    # plus per-(token, head) float32 scales (models/llama.py:KVPages).
    # K8SLLM_KV_DTYPE overrides it.  (ModelConfig.kv_dtype picks the page
    # dtype of the "auto" pool: float8_e4m3fn, float8_e5m2 or float16.)
    kv_dtype: str = "auto"
    # Host-RAM spill tier capacity in bytes (rung 2): pressured prefix-cache
    # evictions demote page rows to a HostKVTier of this size instead of
    # dropping them, and the next hit rehydrates without re-prefill.
    # 0 disables (pressured evictions drop, as before).
    host_spill_bytes: int = 0
    # When every sampling lane of a decode call has 0 < top_k <= this cap,
    # it samples from the top ``sample_topk_cap`` logits (one torch.topk)
    # instead of sorting the whole vocabulary each step; exact in that
    # regime (ops/sampling.py:sample_tokens_bounded).  0 disables.
    sample_topk_cap: int = 64
    # Prompt-prefix KV reuse (serving/kv_cache.py:PrefixCache): LRU entry
    # cap, one entry per cached prefix length; 0 disables.
    prefix_cache_entries: int = 1024
    # Multi-tenant fairness of the prefix cache: the share of cached
    # blocks one tenant may hold while another is resident before its own
    # LRU entries go first.  1.0 disables the cap.
    kv_max_tenant_share: float = 1.0
    # Time-to-live for requests waiting in the pending queue (seconds;
    # 0 = none).  A request with its own deadline_s uses that instead.
    queue_ttl_s: float = 0.0
    # In-flight watchdog: seconds the oldest call in flight may take to
    # become ready at reconcile time (0 = wait forever).  On expiry the
    # pipeline resets: calls in flight are dropped and live lanes are
    # requeued by recompute.
    dispatch_timeout_s: float = 0.0
    # Recompute requeues per request across resets and failed admissions;
    # past it the request fails with the cause.
    max_requeues: int = 2
    # Load-shedding thresholds (0 = disabled): should_shed() reports a
    # reason when the queued prompt tokens of a class and above, or the
    # admission-wait EMA, cross them.
    shed_queue_tokens: int = 0
    shed_slot_wait_s: float = 0.0
    # Voluntary class-ordered preemptions per step(): with no free slot and
    # a strictly higher-class request queued, the lowest-class running lane
    # is evicted by recompute.  0 disables (page-pressure preemption in the
    # decode path still runs).
    max_preemptions: int = 2
    # Brownout clamp on batch-class max_tokens at admission while the
    # ladder sits at DEGRADED or worse; 0 disables the clamp.
    brownout_batch_max_tokens: int = 64
    # What counts as KV headroom in should_shed()'s capacity clause:
    # "tier" arms it only with a host KV tier and counts the cached blocks
    # a spill could reclaim, "device" counts free device blocks, "off"
    # disables it.
    kv_admission: str = "tier"
    # Prompt-lookup speculative decoding (serving/spec.py): drafts per
    # verify pass; 0 disables.  Greedy lanes accept by argmax match (the
    # ids of plain decode), sampled ones by the distribution-exact
    # delta-draft rule.  A spec call drains the pipeline first.
    spec_k: int = 0
    # Verify rounds per spec call (the decode_steps_per_iter of spec).
    spec_rounds_per_iter: int = 4
    # Adaptive speculation: below this EMA of tokens emitted per
    # lane-round (accepted drafts plus the model's token, so the floor is
    # 1.0) a request class takes the plain decode program, re-probing with
    # one spec call every spec_probe_every dispatches.
    spec_min_accept: float = 1.2
    spec_probe_every: int = 32
    # History window of the n-gram match per lane (tokens; at most the
    # per-sequence capacity).
    spec_hist_cap: int = 4096
    # Decode-step collective schedule under a mesh (parallel/overlap.py):
    # "auto" and "off" keep the all-reduce schedule; "on" takes the
    # reduce-scatter / all-gather schedule, and raises where
    # overlap_supported() refuses (cfg, mesh).  "auto" differs from the
    # JAX engine's, which takes the schedule where it is supported: here
    # the collectives block the stream, so the schedule hides nothing and
    # issues two collectives where the all-reduce is one.
    # K8SLLM_TP_OVERLAP overrides it.
    tp_overlap: str = "auto"


# Sink signature: (request_id, new_token_ids, result_or_none).  ``result`` is
# set exactly once per request, when it completes (or errors); new tokens are
# delivered as they reach the host, the EOS token included.
TokenSink = Callable[[str, list[int], Optional[GenerationResult]], None]


class _Slot:
    __slots__ = ("req", "blocks", "ctx_len", "generated", "pending_admit",
                 "inflight_decode", "first_token_time", "retired",
                 "cancel_requested", "prefill_pos", "prefilling",
                 "inflight_chunks", "abort_cause")

    def __init__(self, req: GenerationRequest, blocks: list[int]):
        self.req = req
        self.blocks = blocks
        self.ctx_len = 0          # reconciled tokens in the KV cache
        self.generated: list[int] = []   # reconciled sampled tokens
        self.pending_admit = True        # first token not yet reconciled
        self.inflight_decode = 0         # decode steps dispatched, unreconciled
        self.first_token_time = 0.0
        self.retired = False
        self.cancel_requested = False
        # When set, retirement gives an error result with this cause
        # (deadline expiry, a requeue given up) instead of eos/length.
        self.abort_cause = ""
        # Long-prompt streaming admission: tokens dispatched so far and
        # whether chunks remain (decode skips prefilling slots).
        self.prefill_pos = 0
        self.prefilling = False
        self.inflight_chunks = 0         # chunk calls dispatched, unreconciled

    # -- predicted (dispatch-side) state: every dispatched step emits a
    # token unless the lane hits EOS first.

    @property
    def gen_pred(self) -> int:
        return (len(self.generated) + self.inflight_decode
                + (1 if self.pending_admit else 0))

    @property
    def ctx_pred(self) -> int:
        return self.ctx_len + self.inflight_decode

    @property
    def remaining_pred(self) -> int:
        return self.req.sampling.max_tokens - self.gen_pred


@dataclasses.dataclass
class _Inflight:
    """One dispatched call, until it is reconciled."""
    kind: str                 # "admit" | "chunk" | "decode" | "spec"
    call_id: int
    # admit: [(slot_idx, req)], row j of the call is lane j; chunk:
    # [(row, slot_idx, req)] for the final lanes; decode and spec:
    # [(slot_idx, slot, steps_i)] -- the slot object, since by reconcile
    # time the index may hold another request.
    lanes: list[tuple]
    stage: "_Stage"
    event: Any                # torch.cuda.Event after the copy; None on CPU
    t0: float                 # dispatch time (host clock)
    # Token rows of a decode (steps) or spec (rounds * (spec_k + 1)) call.
    K: int = 0
    # chunk: every slot the call advanced (inflight_chunks drains).
    touched: list = dataclasses.field(default_factory=list)
    span_attrs: dict = dataclasses.field(default_factory=dict)
    # The ``decode_stuck`` fault: the call never reads as ready and its
    # tokens cannot be read (the JAX engine's ``_StuckPayload``).
    stuck: bool = False
    # An admission or chunk call whose first tokens were delivered before
    # its reconcile (_deliver_first_tokens).
    delivered: bool = False


def _decode_inputs(buf, B: int, f32):
    """(ctx, remaining, top_k, temperature, top_p, table) views of a packed
    int32 decode-input buffer of ``B * (5 + table width)`` entries, numpy
    or torch; the temperature and top_p planes hold float32 bits
    (``f32`` = that library's float32)."""
    ctx, rem, topk, temp, topp = (buf[i * B:(i + 1) * B] for i in range(5))
    return (ctx, rem, topk, temp.view(f32), topp.view(f32),
            buf[5 * B:].reshape(B, -1))


def _prefill_inputs(buf, P: int, S: int, W: int, f32):
    """(tokens [P, S], start, lengths, rows, idx, top_k, temperature,
    top_p, FSM state, table [P, W]) views of a packed int32 prefill-input
    buffer of ``P * (S + 8 + W)`` entries, numpy or torch.  ``rows`` and
    ``idx`` pair the call's rows whose first token is placed with their
    slots (the first n entries, n known to the host)."""
    n = P * S
    planes = [buf[n + i * P:n + (i + 1) * P] for i in range(8)]
    start, lengths, rows, idx, topk, temp, topp, fstate = planes
    return (buf[:n].reshape(P, S), start, lengths, rows, idx, topk,
            temp.view(f32), topp.view(f32), fstate,
            buf[n + 8 * P:n + 8 * P + P * W].reshape(P, W))


class _Stage:
    """Host buffers of one call in flight: its packed inputs and its
    sampled tokens, pinned on CUDA so both copies run without the host
    waiting.  A call holds its stage until it is reconciled, so no dispatch
    rewrites inputs that a copy still reads; a call dropped by a pipeline
    reset still runs on the stream, so its stage waits for its event."""

    def __init__(self, n_in: int, n_out: int, pinned: bool):
        self.inp = torch.zeros(n_in, dtype=torch.int32, pin_memory=pinned)
        self.out = torch.zeros(n_out, dtype=torch.int32, pin_memory=pinned)
        self.inp_np = self.inp.numpy()
        self.out_np = self.out.numpy()


# Serializes decode-graph captures across the engines of a process.
_CAPTURE_LOCK = make_lock("engine.graph_capture")


class _DecodeProgram:
    """K decode steps with on-device token feedback: the counterpart of the
    JAX engine's ``_decode_program`` (``serving/engine.py:2379``, a
    ``lax.scan``), one per (K, sampler, constrained, top-k cap).

    The masking is the scan's: a lane is active while it started active
    (``ctx > 0``), has not hit EOS and has steps left; an idle lane runs at
    ctx 0 (the null block) and emits -1.  ``constrained`` carries the
    per-lane FSM state through the steps (masked logits, advanced on active
    lanes only); ``sampler`` is "greedy", "bounded" (the top ``k_cap``
    logits) or "full".

    It works on static buffers only: the engine's packed inputs
    (``_dec_in``), pages, grammar table and pad, the carried ``_tok_state``
    and ``_fsm_state`` (updated in place) and its own [K, max_slots] token
    matrix ``out``.  On CUDA with ``EngineConfig.decode_graphs`` the first
    call runs the steps eagerly on the engine's capture stream -- that
    call's work, and the warm-up that sets the kernels' first-launch
    attributes and cuBLAS's workspace -- then captures them into a CUDA
    graph in the engine's graph pool, with the engine's generator
    registered for a sampler; later calls replay the graph and add the
    kernel launches the capture recorded to the wrappers' counts.  A
    capture or replay that fails raises.  Elsewhere the steps run eagerly
    on the same buffers.
    """

    def __init__(self, eng: "InferenceEngine", K: int, sampler: str,
                 constrained: bool, k_cap: int):
        self.eng = eng
        self.K = K
        self.sampler = sampler
        self.constrained = constrained
        self.k_cap = k_cap
        self.out = torch.full((K, eng.ecfg.max_slots), -1, dtype=torch.int32,
                              device=eng.device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        # Kernel launches of one run, per KERNEL_WRAPPERS entry.
        self.launches: list[int] = []
        # The engine's buffers as the first call found them
        # (InferenceEngine.live_buffers): the addresses a graph captured.
        self.bound: Optional[dict[str, tuple[int, ...]]] = None

    def __call__(self) -> torch.Tensor:
        eng = self.eng
        if self.bound is None:
            self.bound = eng.live_buffers()
        if not eng.decode_graphs:
            self._run()
        elif self.graph is None:
            self._capture()
        else:
            self.graph.replay()
            for fn, n in zip(KERNEL_WRAPPERS, self.launches):
                count_launches(fn, n)
        return self.out

    def _capture(self) -> None:
        # One capture at a time in the process: the step threads of two
        # engines on one card (a fleet's local replicas) capturing at once
        # recorded graphs whose replays decoded nothing.
        with _CAPTURE_LOCK:
            self._capture_locked()

    def _capture_locked(self) -> None:
        eng = self.eng
        t0 = time.monotonic()
        main = torch.cuda.current_stream(eng.device)
        side = eng._graph_stream
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self._run()
        main.wait_stream(side)
        before = thread_launches()
        graph = torch.cuda.CUDAGraph()
        if self.sampler != "greedy":
            graph.register_generator_state(eng._gen)
        with torch.cuda.graph(graph, pool=eng._graph_pool, stream=side,
                              capture_error_mode="thread_local"):
            self._run()
        # The capture launched nothing: take back what the wrappers counted
        # (this thread's counts: another engine's step thread may launch
        # meanwhile).
        after = thread_launches()
        self.launches = [after[fn.__name__] - before[fn.__name__]
                         for fn in KERNEL_WRAPPERS]
        for fn, n in zip(KERNEL_WRAPPERS, self.launches):
            count_launches(fn, -n)
        self.graph = graph
        eng.graph_captures += 1
        eng.graph_capture_s += time.monotonic() - t0

    def _run(self) -> None:
        eng = self.eng
        ctx, remaining, topk, temp, topp, table = eng._dec_views
        active0 = ctx > 0
        done = torch.zeros_like(active0)
        tokens = eng._tok_state
        fstate = eng._fsm_state
        for i in range(self.K):
            act = active0 & ~done & (i < remaining)
            ctx_eff = torch.where(act, ctx, torch.zeros_like(ctx))
            logits, _ = eng._decode_step(eng.model, tokens, ctx_eff,
                                         eng.pages, table,
                                         attn_impl=eng._decode_attn)
            if self.constrained:
                logits = fsm_mask_logits(logits, fstate, eng._fsm_trans,
                                         eng._fsm_pad)
            if self.sampler == "greedy":
                nxt = greedy_tokens(logits)
            elif self.sampler == "bounded":
                nxt = sample_tokens_bounded(
                    eng._gen, logits, temperature=temp, top_k=topk,
                    top_p=topp, k_cap=self.k_cap)
            else:
                nxt = sample_tokens(eng._gen, logits, temperature=temp,
                                    top_k=topk, top_p=topp)
            nxt = torch.where(act, nxt, tokens)
            if self.constrained:
                fstate = torch.where(
                    act, fsm_advance(fstate, eng._fsm_trans, nxt), fstate)
            done = done | (act & (nxt == eng.eos_id))
            ctx = torch.where(act, ctx + 1, ctx)
            self.out[i].copy_(torch.where(act, nxt, torch.full_like(nxt, -1)))
            tokens = nxt
        eng._tok_state.copy_(tokens)
        if self.constrained:
            eng._fsm_state.copy_(fstate)


class _SpecProgram(_DecodeProgram):
    """``rounds`` speculative verify rounds of ``k`` drafts with on-device
    token and history feedback: the JAX engine's ``_spec_program`` (a
    ``lax.scan``, ``serving/engine.py:2714``), keyed like it by (k, rounds,
    sampled, filtered).

    Each round writes the current token into its lane's history row,
    proposes ``k`` drafts (spec.propose_drafts), verifies the ``k + 1``
    positions in one forward (llama.verify_step on the engine's verify
    path), accepts a draft prefix plus the model's token (argmax, or the
    delta-draft rule when ``sampled``; ``filtered`` adds the top-k/top-p
    filters), appends the emitted tokens to the history and advances ctx
    by the count.  Rejected positions' K/V stays past ctx: masked, then
    overwritten.  A lane is active while it started active, has not hit
    EOS and has quota left.  ``out`` [rounds * (k + 1), max_slots] holds
    each round's emission with -1 padding, chronological per lane;
    ``stats`` [2] the rounds that ran a forward with an active lane and the
    active lane-rounds.  Captured and replayed as ``_DecodeProgram`` is.
    """

    def __init__(self, eng: "InferenceEngine", k: int, rounds: int,
                 sampled: bool, filtered: bool):
        super().__init__(eng, rounds * (k + 1),
                         "sampled" if sampled else "greedy", False, 0)
        self.k = k
        self.rounds = rounds
        self.filtered = filtered
        self.stats = torch.zeros(2, dtype=torch.int32, device=eng.device)

    def _run(self) -> None:
        eng = self.eng
        k = self.k
        ctx, quota, topk, temp, topp, table = eng._dec_views
        hist = eng._hist                       # [B, H + 1]: column H sinks
        H = hist.shape[1] - 1
        hv = hist[:, :H]
        active0 = ctx > 0
        done = torch.zeros_like(active0)
        tok = eng._tok_state
        offs = torch.arange(k + 1, dtype=torch.int32, device=eng.device)
        zero = torch.zeros_like(ctx)
        sink = torch.full_like(ctx, H)
        ran = torch.zeros((), dtype=torch.int32, device=eng.device)
        lane_rounds = torch.zeros_like(ran)
        for r in range(self.rounds):
            act = active0 & ~done & (quota > 0)
            # The current token enters the history at its own position.
            wcol = torch.where(act & (ctx < H), ctx, sink)
            hist.scatter_(1, wcol.long()[:, None], tok[:, None])
            drafts = propose_drafts(hv, ctx, tok, k)
            toks_in = torch.cat([tok[:, None], drafts], dim=1)
            lengths = torch.where(act, torch.full_like(ctx, k + 1), zero)
            logits, _ = llama.verify_step(eng.model, toks_in, ctx, lengths,
                                          eng.pages, table,
                                          attn_impl=eng._verify_attn)
            if self.sampler == "sampled":
                emit, out = accept_sampled(
                    eng._gen, logits, drafts, quota, act, eng.eos_id, temp,
                    top_k=topk if self.filtered else None,
                    top_p=topp if self.filtered else None)
            else:
                greedy = torch.argmax(logits, dim=-1).to(torch.int32)
                emit, out = accept_greedy(greedy, drafts, quota, act,
                                          eng.eos_id)
            # The emitted tokens extend the history at ctx + 1 + i.
            cols = ctx[:, None] + 1 + offs[None, :]
            cols = torch.where((out >= 0) & (cols < H), cols, sink[:, None])
            hist.scatter_(1, cols.long(), out)
            last = torch.gather(out, 1, (emit - 1).clamp(min=0).long()[:, None])
            tok = torch.where(act & (emit > 0), last[:, 0], tok)
            # The -1 padding must not match an eos_id of -1.
            done = done | (act & ((out == eng.eos_id) & (out >= 0)).any(dim=1))
            step = torch.where(act, emit, zero)
            ctx = ctx + step
            quota = quota - step
            self.out[r * (k + 1):(r + 1) * (k + 1)].copy_(out.t())
            ran = ran + act.any().to(torch.int32)
            lane_rounds = lane_rounds + act.sum().to(torch.int32)
        self.stats.copy_(torch.stack([ran, lane_rounds]))
        eng._tok_state.copy_(tok)


class InferenceEngine:
    """Engine over batched prefill and K-step decode.

    ``device`` defaults to ``cuda`` (llama.resolve_device); the model's
    weights must live there.  ``mesh`` (default: the model's) serves a
    model built on a mesh, this engine as rank 0.  Not thread-safe: one
    thread owns the engine (serving/service.py is the concurrent front
    end).
    """

    def __init__(self, cfg: ModelConfig, model: llama.LlamaModel,
                 engine_cfg: EngineConfig | None = None, tokenizer=None,
                 eos_id: Optional[int] = None, seed: int = 0, device=None,
                 host_kv_tier: Optional[HostKVTier] = None, mesh=None):
        if mesh is None:
            mesh = model.mesh
        elif model.mesh is not (mesh if mesh.size > 1 else None):
            raise ValueError("the model was not built on this mesh")
        self.mesh = mesh
        # The model (tensor-parallel) degree.
        self.tp = mesh.tp if mesh is not None else 1
        # Rank 0 of a mesh sends every device call to the workers.
        self._leader = mesh is not None and mesh.is_leader
        self.device = (mesh.device if mesh is not None and device is None
                       else llama.resolve_device(device))
        if model.device != self.device:
            raise ValueError(f"model weights are on {model.device}, the "
                             f"engine runs on {self.device}")
        if self._leader:
            model.check_current()
        engine_cfg_in = engine_cfg
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
        # model's dtype, "int8" / "fp8" for the quantized tier.  The
        # environment wins over EngineConfig, as in the JAX engine.
        kvd = os.environ.get("K8SLLM_KV_DTYPE", ec.kv_dtype) or "auto"
        if kvd in ("auto", "fp16", "bf16", "none"):
            self.kv_quant = ""
        elif kvd in ("int8", "fp8"):
            self.kv_quant = kvd
        else:
            raise ValueError(f"unknown kv_dtype {kvd!r} (auto | int8 | fp8)")
        pmode = os.environ.get("K8SLLM_PREFILL_PATH", ec.prefill_path) or "auto"
        self._prefill_attn = select_prefill_impl(self.device, cfg, pmode,
                                                 tp=self.tp)
        self.prefill_path = "flash" if self._prefill_attn is not None else "dense"
        if self._prefill_attn is not None:
            # The flash kernel reads K/V from the pages, so long prompts
            # take 4096/8192-token rounds where the per-sequence capacity
            # allows (the dense path would build [B, H, S, T] scores).
            cap = min(ec.max_blocks_per_seq,
                      ec.num_blocks - 1) * ec.block_size
            extra = tuple(b for b in (4096, 8192)
                          if b > max(ec.prefill_buckets) and b <= cap)
            if extra:
                ec = dataclasses.replace(
                    ec, prefill_buckets=tuple(ec.prefill_buckets) + extra)
                self.ecfg = ec
        # Sequence-sharded prefill: every round's positions split evenly
        # over the seq axis (the JAX engine's check, after the ladder).
        seq_deg = mesh.sp if mesh is not None else 1
        if seq_deg > 1:
            for b in ec.prefill_buckets:
                if b % seq_deg:
                    raise ValueError(
                        f"prefill bucket {b} is not divisible by the mesh "
                        f"seq axis ({seq_deg}); choose bucket sizes that "
                        f"split evenly")
        self._decode_attn = select_decode_impl(
            self.device, cfg,
            os.environ.get("K8SLLM_DECODE_PATH", ec.decode_path),
            kv_quant=self.kv_quant, tp=self.tp)
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
        # The verify pass of speculative decoding, as the JAX engine picks
        # it: flash prefill whenever it is on (a quantized pool's scale
        # planes ride as kwargs), else the split paged attention kernel on
        # a bf16 pool (select_verify_impl), else None (the gather).
        if ec.spec_k > 0 and self._prefill_attn is not None:
            self._verify_attn = self._prefill_attn
        elif ec.spec_k > 0 and not self.kv_quant:
            self._verify_attn = select_verify_impl(self.device, cfg,
                                                   tp=self.tp)
        else:
            self._verify_attn = None
        # The decode-step collective schedule (read where the JAX engine
        # reads it; the environment wins).
        overlap_mode = os.environ.get("K8SLLM_TP_OVERLAP",
                                      ec.tp_overlap) or "auto"
        if overlap_mode not in ("auto", "on", "off"):
            raise ValueError(
                f"unknown tp_overlap {overlap_mode!r} (auto | on | off)")
        self.tp_overlap = overlap_mode == "on"
        if self.tp_overlap:
            why_not = overlap_supported(cfg, mesh, model=model)
            if why_not:
                raise ValueError(
                    f"tp_overlap=on but the overlap schedule cannot serve "
                    f"this (cfg, mesh): {why_not}")
        self._decode_step = (overlap_decode_step if self.tp_overlap
                             else llama.decode_step)
        self.pages = llama.init_kv_pages(cfg, ec.num_blocks, ec.block_size,
                                         self.device,
                                         model.dtype,
                                         kv_quant=self.kv_quant, tp=self.tp)
        # Read by the byte accounting, which a scrape may run on an engine
        # whose pool the supervisor's factory has released.
        self._page_dtype = self.pages.k[0].dtype
        self.allocator = BlockAllocator(ec.num_blocks, ec.block_size)
        self.prefix_cache: Optional[PrefixCache] = (
            PrefixCache(self.allocator, ec.prefix_cache_entries,
                        max_tenant_share=ec.kv_max_tenant_share)
            if ec.prefix_cache_entries > 0 else None)
        # Cold-burst dedup: requests whose admission waited for a lane to
        # publish their prefix.
        self.prefix_deferrals = 0
        # Host-RAM spill tier (rung 2).  A caller-provided tier (the
        # supervisor's engine_factory closes over one) survives engine
        # rebuilds, so spilled prefixes outlive a crash-recovery cycle.
        if host_kv_tier is None and ec.host_spill_bytes > 0:
            host_kv_tier = HostKVTier(ec.host_spill_bytes,
                                      max_tenant_share=ec.kv_max_tenant_share)
        self.host_kv_tier = host_kv_tier
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
        if ec.max_inflight < 0 or ec.decode_every_n_chunk_rounds < 1:
            raise ValueError(
                f"max_inflight {ec.max_inflight} must be >= 0 and "
                f"decode_every_n_chunk_rounds "
                f"{ec.decode_every_n_chunk_rounds} >= 1")
        # The decode programs' packed inputs on the device (_decode_inputs)
        # and their views; each call copies its _Stage in.
        self._dec_in = torch.zeros(ec.max_slots * (5 + ec.max_blocks_per_seq),
                                   dtype=torch.int32, device=self.device)
        self._dec_views = _decode_inputs(self._dec_in, ec.max_slots,
                                         torch.float32)
        self._programs: dict[tuple, _DecodeProgram] = {}
        # CUDA graphs of the decode programs: one capture stream and one
        # memory pool for all of them (replays never overlap: one stream).
        # A gloo mesh runs its collectives through the host, which a graph
        # cannot hold: its programs run eagerly.
        cuda = self.device.type == "cuda"
        self.decode_graphs = (ec.decode_graphs and cuda
                              and not (self.tp > 1
                                       and mesh.backend == "gloo"))
        self._graph_stream = torch.cuda.Stream(self.device) if cuda else None
        self._graph_pool = torch.cuda.graph_pool_handle() if cuda else None
        self.graph_captures = 0
        self.graph_capture_s = 0.0
        self._inflight: deque[_Inflight] = deque()
        # Stage sizes: the larger of a decode call's and of the widest
        # prefill round's inputs and tokens.
        top = ec.prefill_buckets[-1]
        self._stage_in = max(
            ec.max_slots * (5 + ec.max_blocks_per_seq),
            ec.max_prefills_per_step * (top + 8 + ec.max_blocks_per_seq))
        self._stage_out = max(ec.decode_steps_per_iter * ec.max_slots,
                              ec.max_prefills_per_step,
                              ec.spec_rounds_per_iter * (ec.spec_k + 1)
                              * ec.max_slots + 2 if ec.spec_k > 0 else 0)
        # Speculative decoding: each lane's token history for the n-gram
        # proposer, [max_slots, H + 1] with a sink column H for the writes
        # the JAX engine drops; rows are written whole at admission, then
        # extended on the device as tokens are accepted.
        self._hist: Optional[torch.Tensor] = None
        if ec.spec_k > 0:
            H = min(self.capacity_tokens, ec.spec_hist_cap)
            self._hist = torch.full((ec.max_slots, H + 1), -1,
                                    dtype=torch.int32, device=self.device)
        self.spec_tokens = 0         # tokens emitted by spec calls
        self.spec_verify_steps = 0   # verify forwards those tokens cost
        self.spec_lane_rounds = 0    # active lanes summed over those forwards
        # Per-request-class acceptance EMA (serving/spec.py:AcceptanceEMA).
        self._spec_accept = AcceptanceEMA(floor=ec.spec_min_accept,
                                          probe_every=ec.spec_probe_every)
        self._stages: list[_Stage] = []
        # (stage, event) of calls dropped by a reset: back to _stages once
        # the event has completed (their copies may still land).
        self._limbo: list[tuple[_Stage, Any]] = []
        self._next_call_id = 0
        # (newest call id at retirement, blocks): a retired lane's pages,
        # freed once that call is reconciled (its zombie steps write them).
        self._deferred_frees: list[tuple[int, list[int]]] = []
        self._chunks_since_decode = 0
        self._pending: deque[GenerationRequest] = deque()
        self._slots: list[Optional[_Slot]] = [None] * ec.max_slots
        self._results: dict[str, GenerationResult] = {}
        self.step_calls = 0       # step() calls
        self.steps = 0            # decode steps dispatched, as JAX counts
        self.decode_tokens = 0    # tokens emitted by decode calls
        self.prefills = 0         # prompts whose first token was dispatched
        # Host wall time with a decode call in flight (dispatch to
        # reconcile, overlapping calls counted once).
        self.decode_s = 0.0
        self._decode_mark = 0.0
        self.bounded_decode_steps = 0   # decode steps sampled top-k bounded
        # Prompt tokens (rows) the prefill calls computed, padding excluded,
        # and the host seconds their dispatch took (on the card the launch
        # queue holds the host back while the device is a round behind).
        self.prefill_tokens = 0
        self.prefill_dispatch_s = 0.0
        # step() calls in which the host waited, before the step's last
        # dispatch, for a call the device had not finished.
        self.admission_waits = 0
        self._step_waited = False
        self._dispatching = False
        # EMA of a prefill call's dispatch -> reconcile ms; rounds per
        # bucket; chunk rounds clamped by interactive_chunk_bucket and the
        # bucket of the newest chunk round.
        self.prefill_attn_ms = 0.0
        self.prefill_bucket_rounds: dict[int, int] = {}
        self.chunk_shrinks = 0
        self.last_chunk_bucket = 0
        self.deadline_expired = 0
        self.brownout_clamps = 0
        # Recovery (resilience/faults.py points, the watchdog, resets).
        self._faults = get_injector()
        self.dispatch_failures = 0
        self.consecutive_dispatch_failures = 0
        self.watchdog_trips = 0
        self.requeues = 0
        self.preemptions = 0
        self.preemptions_by_class: dict[str, int] = {}
        # EMA of submit -> admission wait: a shed signal when slots churn
        # slower than requests arrive.
        self.slot_wait_ema_s = 0.0
        # Per-class admission-wait and TTFT EMAs (seconds), keyed on first
        # observation so the exporter can mark a class that never carried
        # traffic NaN; /api/v1/stats reads the TTFT one.
        self.slot_wait_ema_by_class: dict[str, float] = {}
        self.ttft_ema_by_class: dict[str, float] = {}
        # TTFT histogram (Prometheus semantics: cumulative le buckets +
        # sum/count), observed once per request with its first token.
        self.ttft_buckets: tuple[float, ...] = (
            0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)
        self.ttft_counts = [0] * (len(self.ttft_buckets) + 1)  # +Inf last
        self.ttft_sum = 0.0
        self.ttft_count = 0
        # Decode phase attribution (monitor/exporter.py gauges):
        # decode_host_gap_ms, an EMA of host time blocked per decode/spec
        # reconcile (~0 when dispatch-ahead hides the device);
        # decode_attn_ms / decode_sample_ms, per-step attention / sampling
        # cost, set by profile_decode_phases() only.
        # decode_collective_share and decode_collective_hidden_share (the
        # collectives' share of a decode step, and the share of it the
        # overlap schedule hides): 0.0 off a mesh; on one the share is
        # filled by profile_decode_phases(), as in the JAX engine, and the
        # hidden share stays 0.0 (the port's collectives block the stream,
        # so the overlap schedule hides nothing).
        self.decode_host_gap_ms = 0.0
        self.decode_attn_ms = 0.0
        self.decode_sample_ms = 0.0
        self.decode_collective_share = 0.0
        self.decode_collective_hidden_share = 0.0
        # The all-reduce's bus rate (GB/s) on the mesh at this engine's
        # decode payload, measured below (rank 0 only; 0.0 off a mesh).
        self.collective_bus_gbs = 0.0
        # Whether the pages split on kv-head boundaries (a spill or an
        # install then gathers or scatters the ranks' slices).
        self._kv_sharded = self.tp > 1 and kv_sharded(cfg.num_kv_heads,
                                                      self.tp)
        # The host rows an install or a restore hands to _op_write_rows.
        self._rows_in: Optional[np.ndarray] = None
        # Request-lifecycle histograms per SLO class, with exemplar trace
        # ids, observed on the step thread only.
        _lat = (0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)
        self.hist_ttft = ClassHistogram(_lat)
        self.hist_e2e = ClassHistogram(_lat)
        self.hist_queue_wait = ClassHistogram(_lat)
        # Per decode-step seconds (call wall time / steps in call).
        self.hist_decode_step = ClassHistogram(
            (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 1.0))
        self._tracer = get_tracer()
        self._flight = get_flight_recorder()
        # Cache maintenance with no owning request (the KV spill) records
        # its spans under a synthetic root of its own, as in the JAX engine.
        self._maint_ctx = self._tracer.new_trace()
        if self._maint_ctx is not None and self._maint_ctx.sampled:
            t_now = time.monotonic()
            self._tracer.record(
                "engine.maintenance", t_now, t_now, self._maint_ctx,
                span_id=self._maint_ctx.span_id, parent_id="")
        # The workers build their copy of this engine last, from what this
        # one was given (and the overrides it read).
        self._mesh_token = 0
        if self._leader:
            mesh.send("engine", dict(cfg=cfg, engine_cfg=engine_cfg_in,
                                     eos_id=self.eos_id, seed=seed),
                      {k: os.environ.get(k) for k in _ENV_OVERRIDES})
            mesh.engine_token += 1
            self._mesh_token = mesh.engine_token
            self.collective_bus_gbs = mesh.bus_gbs(self._collective_payload())

    # ------------------------------------------------------------------
    # device calls (replayed on a mesh's workers)
    # ------------------------------------------------------------------

    def _device(self, op: str, *args, fault: str = ""):
        """Run device call ``_op_<op>``; on rank 0 of a mesh, send it to the
        workers first (host tensors go as numpy arrays).  ``fault`` names
        the dispatch's fault point, which fires just before the call: on
        rank 0 of a mesh that is after the send, so the call it fails is
        one the workers run, and the mesh breaks (``Mesh.replay``)."""
        def run():
            if fault:
                self._faults.maybe_raise(fault)
            return getattr(self, "_op_" + op)(*args)

        if not self._leader:
            return run()
        if self._mesh_token != self.mesh.engine_token:
            raise RuntimeError("the mesh's workers hold another engine "
                               "(one engine lives on a mesh at a time)")
        return self.mesh.replay(("op", op, tuple(
            a.numpy() if isinstance(a, torch.Tensor) else a
            for a in args)), run)

    def _mesh_check(self) -> None:
        """On rank 0 of a mesh, raise ``MeshBroken`` before reading what a
        call returned if the mesh broke (over NCCL an aborted collective
        ends with garbage in place of its result)."""
        if self._leader:
            self.mesh.check()

    def _op_prefill(self, inp: torch.Tensor, P: int, S: int, W: int,
                    chunked: bool, greedy: bool, constrained: bool, n: int):
        """Copy a round's packed inputs in, run the prefill (``prefill_chunk``
        with per-lane starts over the paged prefix when ``chunked``), sample
        each row's first token (the logits masked by the lanes' FSM states
        when ``constrained``), and place the first tokens of the ``n``
        placed rows into the device token buffer (and, with a grammar
        installed, those lanes' FSM states: the state after the first token
        for a constrained lane, 0 for a free one, which clears what a
        constrained occupant of a reused slot left).  Returns (first tokens
        [P], next FSM states or None, rows, idx) on the device."""
        buf = torch.empty(inp.numel(), dtype=torch.int32, device=self.device)
        buf.copy_(inp, non_blocking=True)
        (tokens, start, lengths, rows, idx, topk, temp, topp, fstate,
         table) = _prefill_inputs(buf, P, S, W, torch.float32)
        # Rank 0 delivers first tokens between layers; over NCCL it is
        # paced there too (parallel/mesh.py: LaunchPacer).
        on_layer = None
        if self.mesh is None or self.mesh.rank == 0:
            on_layer = self._deliver_first_tokens
            if self.mesh is not None and self.mesh.paced:
                pace = LaunchPacer(self.mesh)

                def on_layer():
                    pace()
                    self._deliver_first_tokens()
        if chunked:
            logits, _ = llama.prefill_chunk(
                self.model, tokens, start, lengths, self.pages, table,
                attn_impl=self._prefill_attn, on_layer=on_layer)
        else:
            logits, _ = llama.prefill(self.model, tokens, lengths,
                                      self.pages, table,
                                      attn_impl=self._prefill_attn,
                                      on_layer=on_layer)
        if constrained:
            logits = fsm_mask_logits(logits, fstate, self._fsm_trans,
                                     self._fsm_pad)
        if greedy:
            first = greedy_tokens(logits)
        else:
            first = sample_tokens(self._gen, logits, temperature=temp,
                                  top_k=topk, top_p=topp).to(torch.int32)
        fnext = fsm_advance(fstate, self._fsm_trans, first) if constrained \
            else None
        if n:
            ix, rw = idx[:n].long(), rows[:n].long()
            self._tok_state.index_copy_(0, ix, first.index_select(0, rw))
            if self._fsm_trans is not None:
                self._fsm_state.index_copy_(
                    0, ix, fnext.index_select(0, rw) if fnext is not None
                    else torch.zeros(n, dtype=torch.int32,
                                     device=self.device))
        return first, fnext, rows, idx

    def _program(self, key: tuple) -> "_DecodeProgram":
        prog = self._programs.get(key)
        if prog is None:
            prog = self._programs[key] = (
                _SpecProgram(self, *key[1:]) if key[0] == "spec"
                else _DecodeProgram(self, *key))
        return prog

    def _op_decode(self, inp: torch.Tensor, key: tuple) -> "_DecodeProgram":
        """Copy a decode call's packed inputs in and run its program (built
        at its first call); returns the program (its ``out`` and, for a
        spec program, ``stats``)."""
        prog = self._program(key)
        self._dec_in.copy_(inp, non_blocking=True)
        prog()
        return prog

    def _op_zero_tok(self) -> None:
        self._tok_state.zero_()

    def _op_hist(self, rows: np.ndarray, idx: np.ndarray) -> None:
        """History rows of freshly occupied slots (``_write_hist``).  On the
        card the rows go through pinned memory with ``non_blocking``
        copies, so no call in flight is waited for."""
        r, i = torch.from_numpy(rows), torch.from_numpy(idx)
        if self.device.type == "cuda":
            r = r.pin_memory().to(self.device, non_blocking=True)
            i = i.pin_memory().to(self.device, non_blocking=True)
        self._hist.index_copy_(0, i, r)

    def _op_grammar(self, trans: np.ndarray) -> None:
        """Copy a grammar's transition table into the device buffer
        (``set_grammar``)."""
        states, vg = trans.shape
        old = self._fsm_trans
        if old is None or old.shape[1] != vg or old.shape[0] < states:
            rows = states if old is None or old.shape[1] != vg else max(
                states, old.shape[0])
            self._fsm_trans = torch.empty((rows, vg), dtype=torch.int32,
                                          device=self.device)
            extra = self.cfg.vocab_size - vg
            self._fsm_pad = None if extra == 0 else torch.zeros(
                (max(self.ecfg.max_slots, self.ecfg.max_prefills_per_step),
                 extra), dtype=torch.bool, device=self.device)
            self._programs = {k: p for k, p in self._programs.items()
                              if not p.constrained}
        table = np.full(self._fsm_trans.shape, -1, np.int32)
        table[:states] = trans
        self._fsm_trans.copy_(torch.from_numpy(table))

    def _op_release(self) -> None:
        self.pages = None
        self._programs.clear()
        self._graph_pool = None

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def live_buffers(self) -> dict[str, tuple[int, ...]]:
        """Device addresses of what the decode programs read and write in
        place: every layer's pages (and scale planes), the packed inputs,
        the carried token and FSM states, the grammar table and the spec
        history.  A captured graph replays on the addresses it was
        captured on (``_DecodeProgram.bound``), so these must never be
        rebound while the programs live (devtools/traceguard.py)."""
        pages = self.pages
        out = {"pages": () if pages is None else tuple(
            t.data_ptr() for t in (*pages.k, *pages.v, *pages.k_scale,
                                   *pages.v_scale)),
               "_dec_in": (self._dec_in.data_ptr(),),
               "_tok_state": (self._tok_state.data_ptr(),),
               "_fsm_state": (self._fsm_state.data_ptr(),)}
        if self._fsm_trans is not None:
            out["_fsm_trans"] = (self._fsm_trans.data_ptr(),)
        if self._hist is not None:
            out["_hist"] = (self._hist.data_ptr(),)
        return out

    @property
    def pool_bytes(self) -> int:
        """Device bytes of this rank's paged KV pool, pages and scales, over
        every layer (serving/kv_cache.py:page_slice_bytes per block: the
        rank's kv-head slice under a mesh)."""
        return self._pool_bytes(self.tp)

    def _pool_bytes(self, tp: int) -> int:
        cfg, ec = self.cfg, self.ecfg
        return cfg.num_layers * ec.num_blocks * page_slice_bytes(
            cfg.num_kv_heads, cfg.head_dim_, ec.block_size,
            self._page_dtype.itemsize, tp=tp,
            scale_bytes=4 if self.kv_quant else 0)

    def kv_tier_stats(self) -> dict:
        """KV tier byte accounting for /api/v1/stats, in the JAX engine's
        keys: the device tier (``page_dtype`` numpy's name of the page
        dtype), the host tier's bytes, entries and spill/restore counters,
        and with a prefix cache its distinct cached blocks per tenant."""
        out = {
            "kv_quant": self.kv_quant,
            "page_dtype": _page_dtype_name(self._page_dtype),
            # The whole pool, the JAX engine's view (a rank holds
            # pool_bytes of it).
            "device_bytes": self._pool_bytes(1),
            "host_bytes": 0,
            "host_entries": 0,
            "spills": 0,
            "restores": 0,
            "host_lost": 0,
        }
        if self.host_kv_tier is not None:
            st = self.host_kv_tier.stats()
            out.update(host_bytes=st["bytes"], host_entries=st["entries"],
                       spills=st["spills"], restores=st["restores"],
                       host_lost=st["lost"],
                       host_tenant_bytes=st["tenant_bytes"])
        if self.prefix_cache is not None:
            out["tenant_blocks"] = self.prefix_cache.blocks_by_tenant()
        return out

    def release_pool(self) -> None:
        """Drop the KV pool, the decode programs and their CUDA graphs (and
        with them the graph pool), so the caching allocator can give the
        memory to the engine that replaces this one (the supervisor's
        factory calls it on the engine it rebuilds, which serves nothing
        afterwards).  A thread still inside a step keeps the tensors it
        holds alive until it lets go of them.  A mesh's workers release
        theirs when this engine is the one they hold."""
        if self._leader and (self._mesh_token != self.mesh.engine_token
                             or self.mesh.broken is not None):
            self._op_release()
            return
        self._device("release")

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
                # A folded prompt re-capped: the dropped tokens come off the
                # original prompt, not the generated tail.
                req.orig_prompt_len = max(0, req.orig_prompt_len - overflow)

    def set_grammar(self, fsm) -> None:
        """Install the ``diagnosis.grammar.TokenFSM`` constrained requests
        decode against (one grammar at a time).  The table is copied into
        one device buffer that keeps its address while grammars of the same
        vocab and no more states replace each other (rows past a grammar's
        states are unreachable), so the captured constrained programs read
        the installed grammar; a wider or taller table gets a new buffer,
        and the constrained programs are dropped with the old one.  The
        mask's pad past the grammar vocab is built with the buffer, for
        the widest call (decode lanes or prefill lanes)."""
        if fsm.vocab_size > self.cfg.vocab_size:
            raise ValueError(
                f"grammar vocab {fsm.vocab_size} exceeds model vocab "
                f"{self.cfg.vocab_size}")
        if fsm.eos_id != self.eos_id:
            raise ValueError(
                f"grammar eos_id {fsm.eos_id} != engine eos_id {self.eos_id}")
        self._device("grammar", np.ascontiguousarray(fsm.trans, np.int32))
        self._grammar = fsm

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
        # smuggle an unvalidated namespace into the digest seeds.
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
        an active slot takes no new decode steps and retires once its calls
        in flight settle (its first token's call retires it at once).
        Returns True if found."""
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
        return (bool(self._pending) or bool(self._inflight)
                or any(s is not None for s in self._slots))

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
        blocks, and under ``kv_admission="tier"`` with a host tier the
        prefix-cache blocks a lossless spill could reclaim, bounded by the
        tier's free bytes (the JAX engine's policy)."""
        ec = self.ecfg
        free_blocks = self.allocator.free_blocks
        if (ec.kv_admission == "tier" and self.prefix_cache is not None
                and self.host_kv_tier is not None):
            evictable = self.prefix_cache.evictable_blocks()
            if evictable > 0:
                blk_bytes = self.pool_bytes // ec.num_blocks
                st = self.host_kv_tier.stats()
                host_free = max(st["max_bytes"] - st["bytes"], 0)
                free_blocks += min(evictable, host_free // max(blk_bytes, 1))
        return free_blocks * ec.block_size

    def should_shed(self, slo_class: str = DEFAULT_CLASS,
                    need_tokens: int = 0) -> str:
        """Non-empty reason when new work of ``slo_class`` should be shed:
        queue-token backlog or admission-wait EMA above the configured
        thresholds, or a KV footprint ``need_tokens`` beyond
        ``admission_headroom_tokens`` (``kv_admission`` "device", or "tier"
        with a host tier).  EngineService.submit turns it into a retriable
        ``OverloadedError``.

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
        # "tier" arms the capacity clause only with a host tier: without
        # one the headroom says nothing the queue and the OutOfBlocks
        # pushback do not already handle.
        capacity_armed = (ec.kv_admission == "device"
                          or (ec.kv_admission == "tier"
                              and self.host_kv_tier is not None))
        if need_tokens > 0 and capacity_armed:
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
    # deadlines, failure recovery, SLO classes, brownout, spans
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
        (they retire with the cause once their calls in flight settle)."""
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
            if (s is not None and not s.retired and not s.cancel_requested
                    and now > self._deadline_of(s.req, queued=False)):
                self.deadline_expired += 1
                s.abort_cause = (f"deadline exceeded after "
                                 f"{now - s.req.submit_time:.2f}s "
                                 f"({len(s.generated)} tokens generated)")
                s.cancel_requested = True

    def _record_dispatch_failure(self, exc: BaseException) -> None:
        self.dispatch_failures += 1
        self.consecutive_dispatch_failures += 1
        self._flight.note("dispatch_failure", error=repr(exc)[:200],
                          consecutive=self.consecutive_dispatch_failures)
        if self.health is not None:
            self.health.record_dispatch_failure()

    def _record_dispatch_ok(self) -> None:
        self.consecutive_dispatch_failures = 0
        if self.health is not None:
            self.health.record_dispatch_ok()

    def _note_admission_wait(self, req: GenerationRequest) -> None:
        """Track how long requests wait for a slot (the shed_slot_wait_s
        signal) and record the queue-wait span."""
        now = time.monotonic()
        wait = now - req.submit_time
        self.slot_wait_ema_s = (wait if self.slot_wait_ema_s == 0.0
                                else 0.9 * self.slot_wait_ema_s + 0.1 * wait)
        prev = self.slot_wait_ema_by_class.get(req.slo_class)
        self.slot_wait_ema_by_class[req.slo_class] = (
            wait if prev is None else 0.9 * prev + 0.1 * wait)
        self.hist_queue_wait.observe(wait, req.slo_class, self._trace_id(req))
        self._span("engine.queue_wait", req.submit_time, now, req)

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

    def _eviction_victim(self, worse_than: int = -1) -> int:
        """Running lane to evict under pressure: lowest SLO class first,
        youngest within a class.  ``worse_than`` >= 0 keeps only lanes
        strictly below that rank (voluntary preemption evicts only lanes a
        queued request outranks).  Cancelled lanes are skipped.  Returns -1
        when no lane qualifies."""
        best = -1
        best_key: tuple[int, float] | None = None
        for j, sl in enumerate(self._slots):
            if sl is None or sl.retired or sl.cancel_requested:
                continue
            r = SLO_RANK.get(sl.req.slo_class, SLO_RANK[DEFAULT_CLASS])
            if 0 <= worse_than < r or worse_than < 0:
                key = (r, sl.req.submit_time)
                if best_key is None or key > best_key:
                    best, best_key = j, key
        return best

    def _schedule_classes(self) -> None:
        """Stable-sort the pending queue by SLO rank, then evict
        lower-class running lanes by recompute while a strictly
        higher-class request waits with no free slot, at most
        ``max_preemptions`` per step."""
        self._sort_pending_by_class()
        budget = self.ecfg.max_preemptions
        preempted = 0
        while preempted < budget and self._pending:
            if any(s is None for s in self._slots):
                return          # a free slot exists: admission fills it
            best = min(SLO_RANK.get(r.slo_class, SLO_RANK[DEFAULT_CLASS])
                       for r in self._pending)
            if self._eviction_victim(worse_than=best) < 0:
                return
            # Recompute preemption needs reconciled lanes: the folded
            # prompt must hold every sampled token.
            self._reconcile_all()
            if any(s is None for s in self._slots):
                continue        # the drain freed a slot
            victim = self._eviction_victim(worse_than=best)
            if victim < 0:
                return
            try:
                self._faults.maybe_raise("lane_eviction")
            except FaultError as exc:
                # Running lanes are untouched and every lane preempted so
                # far is queued: record it and stop evicting this step.
                self._record_dispatch_failure(exc)
                return
            self._preempt(victim)
            # The victim went to the queue head: re-sort so the request it
            # was evicted for is admitted first (else the victim reclaims
            # its slot and is evicted again next step).
            self._sort_pending_by_class()
            preempted += 1

    def _sort_pending_by_class(self) -> None:
        """Stable-sort the pending queue by SLO rank (FIFO within a class);
        skipped for single-class traffic."""
        if len(self._pending) > 1 and len(
                {r.slo_class for r in self._pending}) > 1:
            self._pending = deque(sorted(
                self._pending,
                key=lambda r: SLO_RANK.get(r.slo_class,
                                           SLO_RANK[DEFAULT_CLASS])))

    def _requeue_or_fail(self, slot_idx: int, cause: str) -> None:
        """Recover a lane whose calls in flight were dropped (a pipeline
        reset): requeue it by recompute, its generated tokens folded into
        the prompt, at most ``max_requeues`` times, then fail it with the
        cause.  The caller has zeroed its in-flight counts and released
        the deferred frees."""
        s = self._slots[slot_idx]
        self.allocator.free(s.blocks)
        self._slots[slot_idx] = None
        s.retired = True
        req = s.req
        if s.cancel_requested or req.requeues >= self.ecfg.max_requeues:
            # Nobody to retry for, or the budget is spent: finish now, the
            # partial output folded into the prompt so the error carries it.
            if s.generated:
                req.prompt_ids = req.prompt_ids + s.generated
            if s.cancel_requested:
                self._fail_request(req, s.abort_cause or "cancelled")
            else:
                self._fail_request(
                    req, f"{cause} (gave up after {req.requeues} requeues)")
            return
        req.requeues += 1
        self.requeues += 1
        consumed = len(s.generated)
        if consumed:
            req.prompt_ids = req.prompt_ids + s.generated
            req.sampling = dataclasses.replace(
                req.sampling,
                max_tokens=max(1, req.sampling.max_tokens - consumed))
        self._cap_request(req)
        self._pending.appendleft(req)
        t_now = time.monotonic()
        self._span("engine.requeue", t_now, t_now, req, status="error",
                   cause=cause[:200], requeues=req.requeues)
        self._flight.note("requeue", request_id=req.request_id,
                          cause=cause, requeues=req.requeues)

    def _reset_pipeline(self, cause: str, extra_calls: tuple = ()) -> None:
        """Drop every call in flight and requeue every live lane by
        recompute after a stuck or failed call (the JAX engine's reset).

        The JAX engine's pages are suspect after a lost call (later calls
        consumed its donated buffers).  Here they are updated in place on
        one stream, so a dropped call, which still runs, writes before any
        later one; the reset keeps the JAX semantics all the same -- the
        prefix cache is cleared and lanes recompute -- so ids and counters
        match.  The decode graphs stay.  The allocator's free count
        returns to its idle baseline."""
        self._flight.note("pipeline_reset", cause=cause,
                          inflight=len(self._inflight) + len(extra_calls),
                          watchdog_trips=self.watchdog_trips)
        self._flight.dump("pipeline_reset", extra={"cause": cause})
        calls = list(extra_calls) + list(self._inflight)
        self._inflight.clear()
        for call in calls:
            if call.kind in ("decode", "spec"):
                for _, s, _steps in call.lanes:
                    s.inflight_decode = 0
            elif call.kind == "chunk":
                for s in call.touched:
                    s.inflight_chunks = 0
            # Its copy into the stage may still land.
            self._limbo.append((call.stage, call.event))
        for _, blocks in self._deferred_frees:
            self.allocator.free(blocks)
        self._deferred_frees.clear()
        if self.prefix_cache is not None:
            self.prefix_cache.clear()
        for i, s in enumerate(self._slots):
            if s is None:
                continue
            s.inflight_decode = 0
            s.inflight_chunks = 0
            self._requeue_or_fail(i, cause)

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
        """One scheduler iteration (the JAX engine's ``step``): expire
        deadlines, schedule by SLO class (voluntary eviction), dispatch up
        to ``max_admission_rounds`` admission rounds and one chunk round,
        dispatch one K-step decode call (while chunk rounds are pending,
        only every ``decode_every_n_chunk_rounds``-th step), then
        reconcile: every call the device has finished, then the oldest
        calls down to ``max_inflight`` in flight, or one call when nothing
        was dispatched."""
        ec = self.ecfg
        self.step_calls += 1
        self._step_waited = False
        self._dispatching = True
        self._enforce_deadlines()
        self._schedule_classes()
        dispatched = False
        rounds = 0
        while rounds < ec.max_admission_rounds and self._admit_round():
            rounds += 1
            dispatched = True
        chunked = self._dispatch_prefill_chunks()
        if chunked:
            dispatched = True
            self._chunks_since_decode += 1
        self._deliver_first_tokens()
        if (not chunked or self._chunks_since_decode
                >= ec.decode_every_n_chunk_rounds):
            if self._dispatch_decode():
                dispatched = True
                self._chunks_since_decode = 0
        self._dispatching = False
        # Results the device already has cost no wait, and reconciling them
        # frees slots and pages a step earlier.
        while self._inflight and self._call_ready(self._inflight[0]):
            self._reconcile_one()
        if dispatched:
            while len(self._inflight) > ec.max_inflight:
                self._reconcile_one()
        elif self._inflight:
            self._reconcile_one()
        if self._step_waited:
            self.admission_waits += 1

    def _deliver_first_tokens(self) -> None:
        """On the card, deliver the first tokens of the admission and chunk
        calls in flight that the device has finished, ahead of their
        reconcile: after each layer of a later round's prefill and before
        the step's decode call.  The device's launch queue holds the host
        back while it dispatches a step's rounds (each is about a thousand
        launches), so the dispatches last about as long as the prefill
        work, and the first tokens would otherwise wait for the step's
        end.  Each lane's token is recorded, stamped and emitted; the
        call's reconcile still retires the lanes that are done, so slots
        change hands when they would without this.  A CPU call has no
        event and waits for its reconcile, as in the JAX engine."""
        self._mesh_check()
        for call in self._inflight:
            if (call.kind in ("admit", "chunk") and not call.delivered
                    and not call.stuck and call.event is not None
                    and call.event.query()):
                call.delivered = True
                self._first_tokens(call, time.monotonic())

    @staticmethod
    def _call_ready(call: _Inflight) -> bool:
        """True when reconciling ``call`` would not wait for the device (a
        CPU call is done when it returns; a stuck call never is)."""
        return not call.stuck and (call.event is None or call.event.query())

    def _reconcile_all(self) -> None:
        while self._inflight:
            self._reconcile_one()

    def _take_stage(self) -> _Stage:
        """A free host stage: one of a reconciled call's, one of a dropped
        call's whose copies have landed, or a new one."""
        if self._limbo:
            keep = []
            for stage, event in self._limbo:
                if event is None or event.query():
                    self._stages.append(stage)
                else:
                    keep.append((stage, event))
            self._limbo = keep
        if self._stages:
            return self._stages.pop()
        return _Stage(self._stage_in, self._stage_out,
                      pinned=self.device.type == "cuda")

    def _drop_stage(self, stage: _Stage) -> None:
        """Give back the stage of a dispatch that failed: whatever it
        queued on the stream may still read it."""
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        self._limbo.append((stage, event))

    def _bucket(self, n: int) -> int:
        return prefill_bucket_for(n, self.ecfg.prefill_buckets)

    def _free_slots(self) -> list[int]:
        return [i for i, s in enumerate(self._slots) if s is None]

    def _lane_count(self, n: int) -> int:
        """Smallest power of two covering ``n``, capped at
        ``max_prefills_per_step``."""
        P = 1
        while P < n:
            P <<= 1
        return min(P, self.ecfg.max_prefills_per_step)

    def _table_width(self, max_tokens_covered: int) -> int:
        """Block-table width for a chunked call: the deepest lane's blocks,
        rounded up to 32 (the gather path reads table-width keys)."""
        bs = self.ecfg.block_size
        need = (max_tokens_covered + bs - 1) // bs
        return min(self.ecfg.max_blocks_per_seq, (need + 31) // 32 * 32)

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

    # -- prefix cache ---------------------------------------------------

    def _ensure_free(self, num_tokens: int) -> bool:
        """Make room for ``num_tokens`` of new blocks, evicting LRU prefix
        entries if needed (a block returns to the free list only when no
        live slot shares it)."""
        while not self.allocator.can_alloc(num_tokens):
            if not self._evict_prefix_lru():
                return False
        return True

    # -- host KV tier (spill / restore, serving/kv_tier.py) --------------

    def _evict_prefix_lru(self) -> bool:
        """Pressured prefix-cache eviction, demoting to the host tier.

        With a :class:`HostKVTier` attached, the LRU victim's page rows are
        fetched to the host and stored under its chain digest before the
        device-side eviction: the next prompt that would have hit it
        rehydrates (``_try_restore``) instead of prefilling again.  The
        spill is best-effort, as in the JAX engine: a failure degrades to
        the drop."""
        pc = self.prefix_cache
        if pc is None:
            return False
        tier = self.host_kv_tier
        if tier is not None:
            peek = pc.peek_lru()
            if peek is not None:
                digest, blocks = peek
                victim_tenant = pc.peek_lru_tenant() or DEFAULT_TENANT
                t_spill = time.monotonic()
                try:
                    tier.put(digest, self._fetch_rows(blocks),
                             tenant=victim_tenant)
                except Exception as exc:  # noqa: BLE001 -- spill must never block eviction
                    logger.warning("KV spill failed (%s); dropping entry",
                                   exc)
                else:
                    if (self._maint_ctx is not None
                            and self._maint_ctx.sampled):
                        self._tracer.record(
                            "engine.kv_spill", t_spill, time.monotonic(),
                            self._maint_ctx, attrs={"blocks": len(blocks)})
                    self._flight.note("kv_spill", blocks=len(blocks))
        return pc.evict_lru()

    def _leaves(self) -> list[tuple[torch.Tensor, ...]]:
        """Per layer, the pool tensors a block's rows live in: (k, v) or,
        on a quantized pool, (k, v, k_scale, v_scale) -- the JAX engine's
        leaf order, which the blobs keep."""
        p = self.pages
        if p.quantized:
            return list(zip(p.k, p.v, p.k_scale, p.v_scale))
        return list(zip(p.k, p.v))

    def _row_shape(self, a: torch.Tensor) -> tuple[int, ...]:
        """The shape of one block's rows of pool tensor ``a`` with every kv
        head (a rank's slice of sharded pages widened ``tp`` times)."""
        return (*a.shape[1:-1], a.shape[-1] * (self.tp if self._kv_sharded
                                               else 1))

    def _fetch_rows(self, blocks: list[int]) -> SpilledPrefix:
        """The page rows of ``blocks`` on the host, every kv head: one
        gather of every leaf's rows as bytes on the device (on a mesh with
        sharded pages, of the ranks' slices), then one copy to the host,
        which waits for the engine's stream (the price of demotion, as in
        the JAX engine).  bf16 and fp8 rows are held as their bytes."""
        k = len(blocks)
        idx = np.asarray(blocks, np.int64)
        host = (self._device("fetch_rows", idx) if self._kv_sharded
                else self._op_fetch_rows(idx))
        layers: list[tuple[np.ndarray, ...]] = []
        off = 0
        for leaf in self._leaves():
            arrs = []
            for a in leaf:
                shape = self._row_shape(a)
                n = k * math.prod(shape) * a.element_size()
                arrs.append(host[off:off + n].view(_HOST_DTYPE[a.dtype])
                            .reshape(k, *shape))
                off += n
            layers.append(tuple(arrs))
        return SpilledPrefix(n_blocks=k, layers=layers)

    def _op_fetch_rows(self, blocks: np.ndarray) -> Optional[np.ndarray]:
        """Every leaf's rows at ``blocks`` as one byte vector, leaf by
        leaf, each [k, ..., every kv head's lanes]: on a mesh with sharded
        pages the ranks' slices are all-gathered and joined on the lane
        dim in rank order.  The host copy on rank 0 (None on a worker)."""
        if self.mesh is not None and (self.mesh.seq_rank
                                      or self.mesh.data_rank):
            return None     # replicas of seq coordinate 0's model group
        k = len(blocks)
        idx = torch.from_numpy(blocks).to(self.device)
        leaves = [a for leaf in self._leaves() for a in leaf]
        mine = torch.cat([a[idx].reshape(-1).view(torch.uint8)
                          for a in leaves])
        if self._kv_sharded:
            ranks = self.mesh.all_gather(mine).view(self.tp, -1)
            parts, off = [], 0
            for a in leaves:
                n = k * a[0].numel() * a.element_size()
                rows = ranks[:, off:off + n].reshape(
                    self.tp, k, *a.shape[1:-1],
                    a.shape[-1] * a.element_size())
                parts.append(torch.cat(rows.unbind(0), dim=-1).reshape(-1))
                off += n
            mine = torch.cat(parts)
        if self.mesh is not None and self.mesh.rank != 0:
            return None
        if self.mesh is not None and self.mesh.paced:
            done = torch.cuda.Event()
            done.record()
            self.mesh.wait_event(done)
        return mine.cpu().numpy()

    def _write_rows(self, blocks: list[int], layers: list[tuple]) -> None:
        """Write host rows (every kv head) back into the pool at
        ``blocks``, in place through byte views (torch has no
        ``index_copy_`` for fp8 on the CPU): the pool keeps its addresses,
        so the decode and spec CUDA graphs stay valid.  On the card the
        rows go through pinned memory with ``non_blocking`` copies, queued
        on the engine's stream before the prefill or chunk call that reads
        them; on a mesh they are broadcast from rank 0 and each rank
        writes its slice.  Block 0, the null block, is never among
        ``blocks``."""
        host = np.concatenate([np.ascontiguousarray(a).reshape(-1)
                               .view(np.uint8)
                               for leaf in layers for a in leaf])
        self._rows_in = host
        try:
            self._device("write_rows", np.asarray(blocks, np.int64),
                         host.size)
        finally:
            self._rows_in = None

    def _op_write_rows(self, blocks: np.ndarray, nbytes: int) -> None:
        k = len(blocks)
        h_idx = torch.from_numpy(blocks)
        if self._rows_in is not None:
            h_rows = torch.from_numpy(self._rows_in)
            if self.device.type == "cuda":
                h_rows = h_rows.pin_memory()
                h_idx = h_idx.pin_memory()
            rows = h_rows.to(self.device, non_blocking=True)
        else:   # a worker: rank 0 broadcasts the rows
            rows = torch.empty(nbytes, dtype=torch.uint8, device=self.device)
        idx = h_idx.to(self.device, non_blocking=True)
        if self.mesh is not None:
            rows = self.mesh.broadcast(rows)
        off = 0
        for leaf in self._leaves():
            for a in leaf:
                dst = a.view(torch.uint8)
                width = dst.shape[-1]
                full = width * (self.tp if self._kv_sharded else 1)
                n = k * dst[0].numel() // width * full
                src = rows[off:off + n].view(k, *dst.shape[1:-1], full)
                if full != width:
                    src = src.narrow(-1, self.mesh.model_rank * width, width)
                dst[idx] = src
                off += n

    def _try_restore(self, prompt_ids: list[int], shared: list[int],
                     shared_toks: int, *,
                     tenant: str = DEFAULT_TENANT) -> tuple[list[int], int]:
        """Host-tier lookup behind a device prefix-cache miss (or a
        shorter-than-spilled hit): rehydrate the longest spilled prefix of
        ``prompt_ids`` into freshly allocated blocks, re-register it, and
        return the caller-owned span exactly as ``PrefixCache.lookup``
        would have.  Any failure returns the inputs unchanged: a lost
        spill is just a miss."""
        tier = self.host_kv_tier
        pc = self.prefix_cache
        if tier is None or pc is None or len(tier) == 0:
            return shared, shared_toks
        bs = self.ecfg.block_size
        n = shareable_blocks(len(prompt_ids), bs)
        have = shared_toks // bs
        if n <= have:
            return shared, shared_toks
        digests = pc.digest_chain(prompt_ids, n, tenant=tenant)
        for k in range(n, have, -1):
            dg = digests[k - 1]
            entry = tier.peek(dg)
            if entry is None or entry.n_blocks != k:
                continue
            if not self._ensure_free(k * bs):
                return shared, shared_toks
            try:
                blocks = self.allocator.alloc(k * bs)
            except OutOfBlocks:
                return shared, shared_toks
            entry = tier.take(dg)
            if entry is None:
                self.allocator.free(blocks)
                return shared, shared_toks
            try:
                self._write_rows(blocks, entry.layers)
            except Exception as exc:  # noqa: BLE001 -- a failed restore degrades to a miss
                logger.warning("KV restore failed (%s); falling back to "
                               "re-prefill", exc)
                self.allocator.free(blocks)
                return shared, shared_toks
            # Re-publish for every prefix length (the extra token only
            # satisfies the shareable-span rule: digests cover whole
            # blocks).
            pc.register(prompt_ids[:k * bs + 1], blocks, tenant=tenant)
            if shared:
                self.allocator.free(shared)
            return blocks, k * bs
        return shared, shared_toks

    # -- cross-replica prefix migration (kv_tier rung 3) -----------------

    def _kv_geometry(self) -> dict:
        """The geometry contract a migration blob must match exactly: a
        mismatched receiver refuses the install, never writes pages."""
        cfg, ec = self.cfg, self.ecfg
        return {
            "model": cfg.name,
            "layers": cfg.num_layers,
            "kv_heads": cfg.num_kv_heads,
            "head_dim": cfg.head_dim_,
            "block_size": ec.block_size,
            "kv_quant": self.kv_quant,
            "page_dtype": _page_dtype_name(self._page_dtype),
        }

    def export_prefix(self, prompt_ids: list[int], *,
                      tenant: str = DEFAULT_TENANT) -> Optional[bytes]:
        """Frame the longest cached prefix of ``prompt_ids`` (within
        ``tenant``'s namespace) as a KVX1 blob: META, then each layer's
        leaves as raw bytes in the JAX engine's order, so either package's
        engine installs it.  None on a miss.  The lookup's references pin
        the blocks for the fetch, then go: export never changes what the
        cache holds.  Each leaf holds every kv head (a mesh's ranks'
        slices gathered), so a blob moves between engines of any TP
        degree."""
        pc = self.prefix_cache
        if pc is None:
            return None
        shared, shared_toks = pc.lookup(prompt_ids, tenant=tenant)
        if not shared:
            return None
        try:
            entry = self._fetch_rows(shared)
            meta = dict(
                self._kv_geometry(),
                n_blocks=len(shared),
                tokens=[int(t) for t in prompt_ids[:shared_toks]],
                tenant=tenant)
            return pack_prefix_blob(
                meta, [a for leaf in entry.layers for a in leaf])
        finally:
            self.allocator.free(shared)

    def install_prefix(self, blob: bytes, *,
                       expected_tenant: str | None = None) -> str:
        """Install a migrated prefix blob into the pool and the prefix cache
        (under the blob's own tenant).  Returns ``"installed"``,
        ``"cached"`` (already resident), ``"incompatible"`` (the geometry
        contract differs), ``"tenant_mismatch"`` (the caller expected
        another namespace; the pages are refused unseen) or ``"nospace"``.
        Framing or CRC damage raises :class:`BlobError`: a torn transfer
        is a miss, never a partial install."""
        meta, raw = unpack_prefix_blob(blob)
        geo = self._kv_geometry()
        if any(meta.get(key) != geo[key] for key in geo):
            return "incompatible"
        try:
            blob_tenant = normalize_tenant(
                meta.get("tenant"), default=DEFAULT_TENANT)
        except ValueError:
            return "incompatible"
        if expected_tenant is not None and blob_tenant != expected_tenant:
            return "tenant_mismatch"
        pc = self.prefix_cache
        cfg, ec = self.cfg, self.ecfg
        bs = ec.block_size
        tokens = [int(t) for t in meta.get("tokens", ())]
        k = int(meta.get("n_blocks", 0))
        leaves = self._leaves()
        if (pc is None or k <= 0 or len(tokens) != k * bs
                or len(raw) != cfg.num_layers * len(leaves[0])):
            return "incompatible"
        # The +1 probe/register token never enters a digest (whole blocks
        # only); it just satisfies the shareable-span rule.
        probe = tokens + [0]
        shared, st = pc.lookup(probe, tenant=blob_tenant)
        if shared:
            self.allocator.free(shared)
            if st >= k * bs:
                return "cached"
        layers: list[tuple] = []
        it = iter(raw)
        try:
            for leaf in leaves:
                layers.append(tuple(
                    np.frombuffer(next(it), _HOST_DTYPE[a.dtype])
                    .reshape(k, *self._row_shape(a)) for a in leaf))
        except ValueError as e:
            raise BlobError(f"ARRAY record does not match geometry: {e}") from e
        if not self._ensure_free(k * bs):
            return "nospace"
        try:
            blocks = self.allocator.alloc(k * bs)
        except OutOfBlocks:
            return "nospace"
        try:
            self._write_rows(blocks, layers)
        except Exception:
            self.allocator.free(blocks)
            raise
        pc.register(probe, blocks, tenant=blob_tenant)
        # The cache entries hold their own references now: the pages are
        # the cache's alone (LRU-evictable, spillable), as a prefilled
        # span's are.
        self.allocator.free(blocks)
        return "installed"

    def _pending_prefix_gain(self, cand: list[int],
                             publishers: list[list[int]]) -> int:
        """Tokens of ``cand``'s prefix that become cache-sharable once the
        ``publishers`` prompts register their pages (whole blocks, capped
        at both prompts' shareable spans)."""
        bs = self.ecfg.block_size
        cand_blocks = shareable_blocks(len(cand), bs)
        if cand_blocks <= 0:
            return 0
        best = 0
        for other in publishers:
            if cand[:bs] != other[:bs]:
                continue
            nb = min(shareable_blocks(len(other), bs), cand_blocks)
            if nb <= 0:
                continue
            k = 1
            while k < nb and cand[k * bs:(k + 1) * bs] == other[k * bs:(k + 1) * bs]:
                k += 1
            best = max(best, k * bs)
        return best

    # -- admission and chunk rounds -------------------------------------

    def _prefill_call(self, stage: _Stage, P: int, S: int, W: int,
                      chunked: bool, greedy: bool, constrained: bool, n: int):
        """Run a round from its stage's packed inputs (``_op_prefill``,
        replayed on a mesh's workers), placing the first tokens of its
        ``n`` placed rows.  Returns (first tokens [P], next FSM states or
        None, rows, idx) on the device."""
        t0 = time.monotonic()
        out = self._device("prefill", stage.inp[:P * (S + 8 + W)], P, S, W,
                           chunked, greedy, constrained, n,
                           fault="prefill_dispatch")
        self.prefill_dispatch_s += time.monotonic() - t0
        return out

    def _admit_round(self) -> bool:
        """Admit pending prompts into free slots through one batched
        prefill call (the JAX engine's ``_admit_round``).  Returns True if
        anything was admitted.

        Each candidate first consults the prefix cache; a hit prefills only
        its suffix over the shared pages, and a round with any hit runs the
        chunked program over a table narrowed to the deepest prompt.  A
        suffix longer than the top bucket occupies a prefilling slot for
        chunk rounds instead.  Cold-burst dedup, both rules gated on the
        published span covering at least half the candidate's remaining
        prefill: a candidate sharing a prefix with a lane admitted this
        round (pages publish at dispatch) is held back one round; a
        chunk-path candidate sharing one with a slot still streaming its
        chunks waits until that publisher's final chunk registers."""
        ec = self.ecfg
        top = ec.prefill_buckets[-1]
        free = self._free_slots()
        admitted_long = 0
        deferred: list[GenerationRequest] = []
        round_prompts: list[list[int]] = []
        # Prompts whose pages register when their chunks complete.
        publishing: list[list[int]] = (
            [s.req.prompt_ids for s in self._slots
             if s is not None and s.prefilling and not s.retired
             and not s.cancel_requested]
            if self.prefix_cache is not None else [])
        # Past this many held-back candidates the scan stops: a deep cold
        # queue must not stall the step inside one round.
        defer_budget = 4 * ec.max_prefills_per_step
        # (slot_idx, req, blocks, shared tokens)
        batch: list[tuple[int, GenerationRequest, list[int], int]] = []
        while len(batch) < ec.max_prefills_per_step and self._pending and free:
            if len(deferred) >= defer_budget:
                break
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
            shared: list[int] = []
            shared_toks = 0
            if self.prefix_cache is not None:
                shared, shared_toks = self.prefix_cache.lookup(
                    req.prompt_ids, tenant=req.tenant)
                if self.host_kv_tier is not None:
                    # A spilled entry longer than the device hit rehydrates
                    # here; its write is queued on the stream before the
                    # prefill call that reads the pages.
                    t_res = time.monotonic()
                    pre_toks = shared_toks
                    shared, shared_toks = self._try_restore(
                        req.prompt_ids, shared, shared_toks,
                        tenant=req.tenant)
                    if shared_toks > pre_toks:
                        self._span("engine.kv_restore", t_res,
                                   time.monotonic(), req,
                                   tokens=shared_toks - pre_toks)
                        self._flight.note(
                            "kv_restore", request_id=req.request_id,
                            tokens=shared_toks - pre_toks)
                suffix = L - shared_toks

                def worth(gain: int) -> bool:
                    return (gain > shared_toks
                            and 2 * (gain - shared_toks) >= suffix)

                defer = False
                if not req.prefix_deferred and round_prompts:
                    defer = worth(self._pending_prefix_gain(
                        req.prompt_ids, round_prompts))
                if not defer and suffix > top and publishing:
                    defer = worth(self._pending_prefix_gain(
                        req.prompt_ids, publishing))
                if defer:
                    if shared:
                        self.allocator.free(shared)
                    if not req.prefix_deferred:
                        req.prefix_deferred = True
                        self.prefix_deferrals += 1
                    self._pending.popleft()
                    deferred.append(req)
                    continue
            if not self._ensure_free(L + 1 - shared_toks):
                if shared:
                    self.allocator.free(shared)
                break
            self._pending.popleft()
            if self.prefix_cache is not None:
                # Admissions count, not lookups (a deferred request looks up
                # again).
                if shared_toks > 0:
                    self.prefix_cache.hits += 1
                else:
                    self.prefix_cache.misses += 1
            if req.orig_prompt_len < 0:
                req.orig_prompt_len = L
            try:
                blocks = shared + self.allocator.alloc(L + 1 - shared_toks)
            except OutOfBlocks:
                # Injected exhaustion (or a racing sharer): push back.
                if shared:
                    self.allocator.free(shared)
                self._pending.appendleft(req)
                break
            self._note_admission_wait(req)
            self._clamp_for_brownout(req)
            if L - shared_toks > top:
                slot = _Slot(req, blocks)
                slot.ctx_len = L
                slot.prefill_pos = shared_toks
                slot.prefilling = True
                slot_idx = free.pop(0)
                self._slots[slot_idx] = slot
                self._write_hist([(slot_idx, req)])
                admitted_long += 1
                if self.prefix_cache is not None:
                    publishing.append(req.prompt_ids)
                continue
            batch.append((free.pop(0), req, blocks, shared_toks))
            round_prompts.append(req.prompt_ids)
        if deferred:
            # Back to the queue head in order: the next round's lookups hit
            # the pages this round publishes.
            self._pending.extendleft(reversed(deferred))
        if not batch:
            return admitted_long > 0

        P = self._lane_count(len(batch))
        any_shared = any(st > 0 for _, _, _, st in batch)
        bucket = self._bucket(
            max(len(r.prompt_ids) - st for _, r, _, st in batch))
        # The chunked program reads table-width keys per lane on the gather
        # path: narrow it to the deepest prompt.
        W = (self._table_width(max(len(r.prompt_ids) for _, r, _, _ in batch))
             if any_shared else ec.max_blocks_per_seq)
        stage = self._take_stage()
        n_in = P * (bucket + 8 + W)
        stage.inp_np[:n_in] = 0
        (tokens, start, lengths, rows, idx, topk, temp, topp, fstate,
         tables) = _prefill_inputs(stage.inp_np, P, bucket, W, np.float32)
        topp[:] = 1.0
        for j, (slot_idx, req, blocks, st) in enumerate(batch):
            L = len(req.prompt_ids)
            tokens[j, :L - st] = req.prompt_ids[st:]
            start[j] = st
            lengths[j] = L - st
            # blocks cover L + 1 tokens; the prefill touches positions < L.
            nb = min(len(blocks), W)
            tables[j, :nb] = blocks[:nb]
            rows[j] = j
            idx[j] = slot_idx
            sp = req.sampling
            temp[j], topk[j], topp[j] = sp.temperature, sp.top_k, sp.top_p
            fstate[j] = self._fsm_entry(req)
        greedy = all(r.sampling.temperature <= 0.0 for _, r, _, _ in batch)
        # Any constrained lane masks the call; free lanes ride at state 0.
        constrained = any(r.sampling.constrained for _, r, _, _ in batch)
        t0 = time.monotonic()
        try:
            out = self._prefill_call(stage, P, bucket, W, any_shared, greedy,
                                     constrained, len(batch))
        except MeshBroken:
            raise
        except Exception as exc:
            # No slot is occupied and nothing is registered: free the
            # round's pages and requeue its candidates, at most
            # max_requeues times each, then fail them with the cause.
            self._drop_stage(stage)
            self._record_dispatch_failure(exc)
            requeue: list[GenerationRequest] = []
            for _, req, blocks, _ in batch:
                self.allocator.free(blocks)
                if req.requeues >= ec.max_requeues:
                    self._fail_request(
                        req, f"prefill dispatch failed: {exc} "
                             f"(gave up after {req.requeues} requeues)")
                else:
                    req.requeues += 1
                    self.requeues += 1
                    requeue.append(req)
            self._pending.extendleft(reversed(requeue))
            return admitted_long > 0
        self._record_dispatch_ok()
        self.prefill_bucket_rounds[bucket] = (
            self.prefill_bucket_rounds.get(bucket, 0) + 1)
        self.prefill_tokens += int(lengths.sum())
        if self.prefix_cache is not None:
            for _, req, blocks, _ in batch:
                self.prefix_cache.register(req.prompt_ids, blocks,
                                           tenant=req.tenant)
        lanes = []
        for slot_idx, req, blocks, _ in batch:
            slot = _Slot(req, blocks)
            slot.ctx_len = len(req.prompt_ids)
            self._slots[slot_idx] = slot
            lanes.append((slot_idx, req))
        self.prefills += len(batch)
        self._write_hist(lanes)
        self._queue_inflight("admit", out, len(lanes), P, stage, lanes, t0,
                             span_attrs={"bucket": bucket,
                                         "lanes": len(batch),
                                         "shared": any_shared})
        return True

    def _dispatch_prefill_chunks(self) -> bool:
        """One batched chunk round for slots in prefilling state, fewest
        remaining tokens first; lanes whose chunk is final sample their
        first token from its logits and publish their prompt's pages."""
        ec = self.ecfg
        top = ec.prefill_buckets[-1]
        cands = [(i, s) for i, s in enumerate(self._slots)
                 if s is not None and s.prefilling and not s.retired
                 and not s.cancel_requested]
        if not cands:
            return False
        cands.sort(key=lambda t: (len(t[1].req.prompt_ids) - t[1].prefill_pos,
                                  t[1].req.submit_time))
        cands = cands[:ec.max_prefills_per_step]
        P = self._lane_count(len(cands))
        bucket = self._bucket(min(top, max(
            len(s.req.prompt_ids) - s.prefill_pos for _, s in cands)))
        # Queued interactive work shrinks the round, so its admission is
        # not held behind a full-bucket chunk.
        icb = ec.interactive_chunk_bucket
        if icb > 0 and any(r.slo_class == "interactive"
                           for r in self._pending):
            small = self._bucket(min(icb, top))
            if small < bucket:
                bucket = small
                self.chunk_shrinks += 1
        self.last_chunk_bucket = bucket
        W = self._table_width(max(
            s.prefill_pos + min(bucket, len(s.req.prompt_ids) - s.prefill_pos)
            for _, s in cands))
        stage = self._take_stage()
        n_in = P * (bucket + 8 + W)
        stage.inp_np[:n_in] = 0
        (tokens, start, lengths, rows, idx, topk, temp, topp, fstate,
         tables) = _prefill_inputs(stage.inp_np, P, bucket, W, np.float32)
        topp[:] = 1.0
        lanes = []
        touched: list[_Slot] = []
        greedy = True
        constrained = False
        # (slot, chunk length, became final): enough to roll back.
        muts: list[tuple[_Slot, int, bool]] = []
        to_register: list[_Slot] = []
        for j, (i, s) in enumerate(cands):
            L = len(s.req.prompt_ids)
            n = min(bucket, L - s.prefill_pos)
            tokens[j, :n] = s.req.prompt_ids[s.prefill_pos:s.prefill_pos + n]
            start[j] = s.prefill_pos
            lengths[j] = n
            nb = min(len(s.blocks), W)
            tables[j, :nb] = s.blocks[:nb]
            s.prefill_pos += n
            s.inflight_chunks += 1
            touched.append(s)
            became_final = False
            if s.prefill_pos >= L:
                s.prefilling = False
                became_final = True
                sp = s.req.sampling
                temp[j], topk[j], topp[j] = sp.temperature, sp.top_k, sp.top_p
                greedy = greedy and sp.temperature <= 0.0
                # Only final lanes sample, so only they consult the FSM.
                fstate[j] = self._fsm_entry(s.req)
                constrained = constrained or sp.constrained
                rows[len(lanes)] = j
                idx[len(lanes)] = i
                lanes.append((j, i, s.req))
                if self.prefix_cache is not None:
                    to_register.append(s)
            muts.append((s, n, became_final))
        t0 = time.monotonic()
        try:
            out = self._prefill_call(stage, P, bucket, W, True, greedy,
                                     constrained, len(lanes))
        except MeshBroken:
            raise
        except Exception as exc:
            # Rewind the round, so the next step dispatches the same chunks.
            self._drop_stage(stage)
            for s, n, became_final in muts:
                s.prefill_pos -= n
                s.inflight_chunks -= 1
                if became_final:
                    s.prefilling = True
            self._record_dispatch_failure(exc)
            return False
        self._record_dispatch_ok()
        self.prefill_bucket_rounds[bucket] = (
            self.prefill_bucket_rounds.get(bucket, 0) + 1)
        self.prefill_tokens += int(lengths.sum())
        for s in to_register:
            self.prefix_cache.register(s.req.prompt_ids, s.blocks,
                                       tenant=s.req.tenant)
        self.prefills += len(lanes)
        self._queue_inflight("chunk", out, len(lanes), P, stage, lanes, t0,
                             touched=touched,
                             span_attrs={"bucket": bucket,
                                         "lanes": len(cands)})
        return True

    def _queue_inflight(self, kind: str, out, n: int, P: int, stage: _Stage,
                        lanes, t0: float, touched=(), span_attrs=None) -> None:
        """Tail of an admission or chunk dispatch (its first tokens already
        placed by ``_op_prefill``): start the copy of the tokens into the
        stage, and queue the call."""
        stage.out[:P].copy_(out[0], non_blocking=True)
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        self._inflight.append(_Inflight(
            kind=kind, call_id=self._next_call_id, lanes=list(lanes),
            stage=stage, event=event, t0=t0, touched=list(touched),
            span_attrs=span_attrs or {}))
        self._next_call_id += 1
        if not self.ecfg.admit_inflight:
            self._reconcile_all()

    # -- speculative decoding -------------------------------------------

    def _write_hist(self, entries: list[tuple[int, GenerationRequest]]) -> None:
        """Load the prompts of freshly occupied slots into their history
        rows (the JAX engine's ``_write_hist``): one row each, the prompt's
        head where it is longer than the window (matches past it stop
        proposing, which lowers acceptance, never correctness), -1 after.
        On the card the rows go through pinned memory with ``non_blocking``
        copies, so no call in flight is waited for."""
        if self._hist is None or not entries:
            return
        H = self._hist.shape[1] - 1
        rows = np.full((len(entries), H + 1), -1, np.int32)
        idx = np.empty(len(entries), np.int64)
        for j, (slot_idx, req) in enumerate(entries):
            L = min(len(req.prompt_ids), H)
            rows[j, :L] = req.prompt_ids[:L]
            idx[j] = slot_idx
        self._device("hist", rows, idx)

    @staticmethod
    def _spec_class(lanes) -> str:
        """Request class of adaptive speculation: greedy and sampled traffic
        accept at very different rates, so each has its own EMA; a mixed
        batch counts as sampled."""
        return ("greedy"
                if all(s.req.sampling.temperature <= 0.0 for _, s in lanes)
                else "sampled")

    @property
    def _spec_ema(self) -> Optional[float]:
        """The best class's acceptance EMA, or None before a measurement."""
        snap = self._spec_accept.snapshot()
        return max(snap.values()) if snap else None

    def spec_accept_ema(self) -> dict:
        """{request class: EMA of tokens emitted per lane-round}."""
        return self._spec_accept.snapshot()

    def profile_decode_phases(self, reps: int = 3) -> dict[str, float]:
        """Attribute the decode step: attention vs sampling cost (JAX
        ``profile_decode_phases``).

        Runs the decode programs -- on the card their CUDA graphs, captured
        here if no request has used them yet, replayed otherwise -- on a
        synthetic full-batch state (all ``max_slots`` lanes live on one
        table row of blocks 1..width) and differences their times:

          * long-context minus short-context greedy -> ``decode_attn_ms``
            (only paged attention scales with the context), and
          * sampled minus greedy at short context -> ``decode_sample_ms``.

        On the card attention is a fraction of a percent of a step whose
        weight reads dominate, and the first timed run after an idle spell
        is slower while the clocks come up; so there every program is
        warmed first, then timed in ``DECODE_PHASE_TRIALS`` interleaved
        rounds of ``reps`` calls, and each keeps its fastest round.

        The state goes into the programs' fixed input buffers with
        ``copy_``, before each run; the steps append garbage rows into ``self.pages``, so
        this runs only on an IDLE engine (it raises otherwise), never on a
        /metrics scrape.  Times are CUDA events on the card, the host clock
        elsewhere.  Returns all four figures and the collective share (the
        byte model of ``_ring_wire_ms`` over the short-context step; 0.0
        off a mesh)."""
        if self._inflight or any(s is not None for s in self._slots):
            raise RuntimeError(
                "profile_decode_phases() requires an idle engine "
                "(it clobbers KV pages)")
        ec = self.ecfg
        K, B = ec.decode_steps_per_iter, ec.max_slots
        width = ec.max_blocks_per_seq
        nblk = min(width, ec.num_blocks - 1)
        ctx_hi = max(nblk * ec.block_size - K - 1, 1)
        cap = ec.sample_topk_cap
        cuda = self.device.type == "cuda"

        def inputs(ctx_val: int, sampled: bool) -> torch.Tensor:
            inp = torch.zeros(B * (5 + width), dtype=torch.int32)
            ctx, remaining, topk, temp, topp, table = _decode_inputs(
                inp, B, torch.float32)
            ctx[:] = ctx_val
            remaining[:] = 10 ** 6
            table[:, :nblk] = torch.arange(1, 1 + nblk, dtype=torch.int32)
            temp[:] = 0.7 if sampled else 0.0
            topk[:] = max(min(cap, 8), 1) if sampled else 0
            topp[:] = 0.9 if sampled else 1.0
            return inp

        def run(key: tuple, inp: torch.Tensor) -> float:
            self._device("zero_tok")
            if cuda:
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                for _ in range(reps):
                    self._device("decode", inp, key)
                t1.record()
                t1.synchronize()
                ms = t0.elapsed_time(t1)
            else:
                h0 = time.monotonic()
                for _ in range(reps):
                    self._device("decode", inp, key)
                ms = (time.monotonic() - h0) * 1e3
            return ms / (reps * K)

        sampler = "bounded" if cap > 0 else "full"
        cases = (((K, "greedy", False, 0), inputs(1, False)),
                 ((K, "greedy", False, 0), inputs(ctx_hi, False)),
                 ((K, sampler, False, cap), inputs(1, True)))
        for key, inp in cases:        # warm: builds or captures once
            self._device("zero_tok")
            self._device("decode", inp, key)
        trials = DECODE_PHASE_TRIALS if cuda else 1
        t_lo, t_hi, t_samp = (min(ts) for ts in zip(*(
            [run(key, inp) for key, inp in cases] for _ in range(trials))))
        self._device("zero_tok")
        self.decode_attn_ms = max(t_hi - t_lo, 0.0)
        self.decode_sample_ms = max(t_samp - t_lo, 0.0)
        self.decode_collective_share = self._estimate_collective_share(t_lo)
        return {
            "decode_step_ms_short_ctx": t_lo,
            "decode_step_ms_long_ctx": t_hi,
            "decode_attn_ms": self.decode_attn_ms,
            "decode_sample_ms": self.decode_sample_ms,
            "decode_collective_share": self.decode_collective_share,
        }

    def _collective_payload(self) -> int:
        """Bytes of one decode all-reduce: a [max_slots, hidden]
        activation."""
        act_bytes = 4 if self.cfg.dtype == "float32" else 2
        return self.ecfg.max_slots * self.cfg.hidden_size * act_bytes

    def _ring_wire_ms(self) -> float:
        """Per-step wire time of the TP decode collectives (the JAX
        engine's byte model, ms): row-parallel o and down each move
        ``2 (tp - 1) / tp`` of a [max_slots, hidden] activation per rank
        per layer, over the all-reduce's bus rate measured on this mesh at
        that payload (``collective_bus_gbs``).  0.0 off a mesh."""
        if self.tp <= 1 or self.collective_bus_gbs <= 0.0:
            return 0.0
        per_rank = (2 * self.cfg.num_layers * 2.0 * (self.tp - 1) / self.tp
                    * self._collective_payload())
        return per_rank / (self.collective_bus_gbs * 1e9) * 1e3

    def _estimate_collective_share(self, step_ms: float) -> float:
        """``decode_collective_share``: the wire time's share of a decode
        step of ``step_ms``, in [0, 1] (0.0 off a mesh)."""
        wire_ms = self._ring_wire_ms()
        if wire_ms <= 0.0 or step_ms <= 0.0:
            return 0.0
        return min(1.0, wire_ms / step_ms)

    def mesh_axes(self) -> dict[str, int]:
        """{axis: size} of the serving mesh ({} off a mesh): the exporter's
        ``mesh_axes`` topology gauge."""
        return dict(self.mesh.shape) if self.mesh is not None else {}

    # -- decode ---------------------------------------------------------

    def _decode_lanes(self) -> list[tuple[int, _Slot]]:
        """Slots a decode call may take now: decoding, with predicted
        budget left, not cancelled."""
        return [(i, s) for i, s in enumerate(self._slots)
                if s is not None and not s.retired and not s.prefilling
                and s.remaining_pred > 0 and not s.cancel_requested]

    def _dispatch_decode(self) -> bool:
        """Dispatch one K-step decode call over the lanes with predicted
        budget (JAX ``_dispatch_decode``): retire cancelled lanes that have
        settled, extend each lane's pages for its steps -- under pressure
        evicting prefix entries, then reconciling every call in flight,
        then preempting the lowest-class youngest lane (the lane itself as
        the last resort) -- fill a host stage with the call's inputs, copy
        it in, run the program and start the copy of its tokens back.
        Returns True if a call was dispatched."""
        ec = self.ecfg
        B = ec.max_slots
        # A cancelled slot still mid-prefill never reaches the admission
        # reconcile that clears pending_admit: it settles once its chunk
        # calls drain.
        for i, s in enumerate(self._slots):
            if (s is not None and s.cancel_requested
                    and s.inflight_decode == 0 and s.inflight_chunks == 0
                    and (s.prefilling or not s.pending_admit)):
                self._retire(i)
        lanes = self._decode_lanes()
        if not lanes:
            return False
        if any(c.kind == "spec" for c in self._inflight):
            # A spec call's emission is data-dependent, so its lanes'
            # ctx_pred is an upper bound while it is in flight: any next
            # decode call waits for the reconciled ctx, or it would run at
            # positions whose attention covers rejected drafts' K/V.
            self._reconcile_all()
            lanes = self._decode_lanes()
            if not lanes:
                return False
        # Constrained lanes take no drafts (the verify pass samples from
        # unmasked logits), brownout sheds the gamble first, and a class
        # whose acceptance sits under the floor drafts only to probe.
        spec = ec.spec_k > 0 and not any(
            s.req.sampling.constrained for _, s in lanes)
        if spec and self._brownout_level() >= 1:
            spec = False
        if spec:
            spec = self._spec_accept.should_draft(self._spec_class(lanes))
        if spec:
            # Drain the pipeline: a spec call trades dispatch-ahead depth
            # for multi-token verify rounds.
            if self._inflight:
                self._reconcile_all()
                lanes = self._decode_lanes()
                if not lanes:
                    return False
            # Per-lane quota: the most a call emits if every draft holds.
            K = ec.spec_rounds_per_iter * (ec.spec_k + 1)
        else:
            kmax = min(ec.decode_steps_per_iter,
                       max(s.remaining_pred for _, s in lanes))
            K = 1 << (kmax.bit_length() - 1)
        for i, s in sorted(lanes, key=lambda t: t[1].req.submit_time):
            if self._slots[i] is not s or s.retired:
                continue        # evicted or retired in the loop below
            steps_i = max(1, min(K, s.remaining_pred))
            while True:
                try:
                    self.allocator.extend(s.blocks, s.ctx_pred + steps_i)
                    break
                except OutOfBlocks:
                    # Cheapest relief first: cached prefixes nobody uses.
                    if self._evict_prefix_lru():
                        continue
                    self._reconcile_all()
                    if self._slots[i] is not s or s.retired:
                        break
                    try:
                        self.allocator.extend(s.blocks, s.ctx_pred + steps_i)
                        break
                    except OutOfBlocks:
                        victim = self._eviction_victim()
                        if victim < 0:
                            victim = i  # only cancelled lanes left
                        try:
                            self._faults.maybe_raise("lane_eviction")
                        except FaultError as exc:
                            # Evicting the requesting lane itself is always
                            # safe and leaves no unextended lane behind.
                            self._record_dispatch_failure(exc)
                            victim = i
                        self._preempt(victim)
                        if victim == i:
                            break
        lanes = self._decode_lanes()
        if not lanes:
            return False
        stage = self._take_stage()
        n_in = B * (5 + ec.max_blocks_per_seq)
        stage.inp_np[:n_in] = 0
        ctx, remaining, topk, temp, topp, table = _decode_inputs(
            stage.inp_np[:n_in], B, np.float32)
        topp[:] = 1.0
        meta = []
        for i, s in lanes:
            steps_i = min(K, s.remaining_pred)
            ctx[i] = s.ctx_pred
            remaining[i] = steps_i
            table[i, :len(s.blocks)] = s.blocks
            sp = s.req.sampling
            temp[i], topk[i], topp[i] = sp.temperature, sp.top_k, sp.top_p
            s.inflight_decode += steps_i
            meta.append((i, s, steps_i))
        greedy = all(s.req.sampling.temperature <= 0.0 for _, s in lanes)
        # Any constrained lane masks the call (free lanes at state 0); greedy
        # lanes then take the argmax of the masked logits.
        constrained = self._fsm_trans is not None and any(
            s.req.sampling.constrained for _, s in lanes)
        spec = spec and not constrained
        cap = ec.sample_topk_cap
        bounded = not spec and not greedy and cap > 0 and all(
            0 < s.req.sampling.top_k <= cap
            for _, s in lanes if s.req.sampling.temperature > 0.0)
        if spec:
            # Filters matter only on lanes that sample: a greedy lane with
            # a top_p (a common client default) keeps the plain variant.
            filtered = not greedy and any(
                s.req.sampling.temperature > 0.0
                and (s.req.sampling.top_k > 0 or s.req.sampling.top_p < 1.0)
                for _, s in lanes)
            key = ("spec", ec.spec_k, ec.spec_rounds_per_iter, not greedy,
                   filtered)
        else:
            sampler = "greedy" if greedy else "bounded" if bounded else "full"
            key = (K, sampler, constrained, cap if bounded else 0)
        t0 = time.monotonic()
        try:
            prog = self._device("decode", stage.inp[:n_in], key,
                                fault="decode_dispatch")
            stage.out[:K * B].view(K, B).copy_(prog.out, non_blocking=True)
            if spec:
                stage.out[K * B:K * B + 2].copy_(prog.stats,
                                                 non_blocking=True)
        except MeshBroken:
            raise
        except Exception as exc:
            # Undo the in-flight accounting so the same lanes dispatch
            # again next step (ctx_pred rewinds with inflight_decode).
            self._drop_stage(stage)
            for _, s, steps_i in meta:
                s.inflight_decode -= steps_i
            self._record_dispatch_failure(exc)
            return False
        self._record_dispatch_ok()
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        self._inflight.append(_Inflight(
            kind="spec" if spec else "decode", call_id=self._next_call_id,
            lanes=meta, stage=stage, event=event, t0=t0, K=K,
            span_attrs={"steps": K, "lanes": len(lanes),
                        "constrained": constrained},
            stuck=self._faults.should_fire("decode_stuck")))
        self._next_call_id += 1
        if not spec:
            # A spec call counts the verify forwards it ran at reconcile.
            self.steps += K
        if bounded:
            self.bounded_decode_steps += K
        return True

    # -- reconciliation -------------------------------------------------

    def _reconcile_one(self) -> None:
        """Wait for the oldest call in flight, apply it, then free the pages
        of retired lanes that no call in flight references.  With
        ``dispatch_timeout_s`` the wait polls, and a call not ready in time
        resets the pipeline (the watchdog); a call that cannot be applied
        resets it too."""
        call = self._inflight.popleft()
        budget = self.ecfg.dispatch_timeout_s
        if budget > 0 and not self._call_ready(call):
            t0 = time.monotonic()
            while not self._call_ready(call):
                if time.monotonic() - t0 >= budget:
                    self.watchdog_trips += 1
                    if self.health is not None:
                        self.health.record_watchdog_trip()
                    self._reset_pipeline(
                        f"dispatch watchdog: {call.kind} call not ready "
                        f"after {budget:.2f}s", extra_calls=(call,))
                    return
                time.sleep(0.002)
        if self._faults.should_fire("slow_host_callback"):
            time.sleep(self._faults.delay_s("slow_host_callback"))
        try:
            gap_t0 = time.monotonic()
            if call.event is not None:
                if self._dispatching and not call.event.query():
                    self._step_waited = True
                if self.mesh is not None and self.mesh.paced:
                    self.mesh.wait_event(call.event)
                else:
                    call.event.synchronize()
            if call.stuck:
                raise FaultError("decode_stuck")
            self._mesh_check()
            if call.kind in ("decode", "spec"):
                # Host time blocked on this device call: ~0 whenever
                # dispatch-ahead hid the device latency.
                gap_ms = (time.monotonic() - gap_t0) * 1e3
                self.decode_host_gap_ms = (
                    gap_ms if self.decode_host_gap_ms == 0.0
                    else 0.9 * self.decode_host_gap_ms + 0.1 * gap_ms)
            self._apply_call(call)
        except MeshBroken:
            raise
        except Exception as exc:
            self._record_dispatch_failure(exc)
            self._reset_pipeline(
                f"reconcile of {call.kind} call failed: {exc}",
                extra_calls=(call,))
            return
        self._stages.append(call.stage)
        if self._deferred_frees:
            still = []
            for after_id, blocks in self._deferred_frees:
                if after_id <= call.call_id:
                    self.allocator.free(blocks)
                else:
                    still.append((after_id, blocks))
            self._deferred_frees = still

    def _apply_call(self, call: _Inflight) -> None:
        """Apply one reconciled call (JAX ``_apply_call``): an admission or
        chunk call's first tokens (TTFT, emission, retirement), a decode
        call's tokens (emission, retirement; a retired lane's zombie steps
        are dropped)."""
        now = time.monotonic()
        if call.kind in ("admit", "chunk"):
            pf_ms = max(0.0, now - call.t0) * 1e3
            self.prefill_attn_ms = (
                pf_ms if self.prefill_attn_ms == 0.0
                else 0.9 * self.prefill_attn_ms + 0.1 * pf_ms)
            for s in call.touched:
                s.inflight_chunks -= 1
            if not call.delivered:
                self._first_tokens(call, now)
            for _, (slot_idx, req) in self._first_rows(call):
                s = self._slots[slot_idx]
                if (s is not None and s.req is req
                        and (self._is_finished(s) or s.cancel_requested)):
                    self._retire(slot_idx)
            return
        n = call.K * self.ecfg.max_slots
        arr = call.stage.out_np[:n].reshape(call.K, -1)
        spec = call.kind == "spec"
        if spec:
            ran, lane_rounds = (int(x) for x in call.stage.out_np[n:n + 2])
            self.spec_verify_steps += ran
            self.spec_lane_rounds += lane_rounds
            self.steps += ran
            if lane_rounds:
                # The class of the slots this call ran (the slot objects:
                # a reused lane index cannot misattribute).
                self._spec_accept.update(
                    self._spec_class((i, s) for i, s, _ in call.lanes),
                    int(np.sum(arr >= 0)), lane_rounds)
        self.decode_s += now - max(call.t0, self._decode_mark)
        self._decode_mark = now
        for slot_idx, s, steps_i in call.lanes:
            if self._slots[slot_idx] is not s or s.retired:
                continue      # retired since dispatch: drop zombie steps
            new = [int(t) for t in arr[:, slot_idx] if t >= 0]
            s.inflight_decode -= steps_i
            self.decode_tokens += len(new)
            if steps_i > 0:
                self.hist_decode_step.observe(
                    max(0.0, now - call.t0) / steps_i, s.req.slo_class,
                    self._trace_id(s.req))
            if spec:
                self.spec_tokens += len(new)
                self._span("engine.spec_decode", call.t0, now, s.req,
                           steps=steps_i, emitted=len(new),
                           rounds=self.ecfg.spec_rounds_per_iter)
            else:
                self._span("engine.decode", call.t0, now, s.req,
                           steps=steps_i, emitted=len(new))
            if not new:
                continue
            s.ctx_len += len(new)
            s.generated.extend(new)
            self._emit(s.req, new)
            if self._is_finished(s) or (s.cancel_requested
                                        and s.inflight_decode == 0):
                self._retire(slot_idx)

    @staticmethod
    def _first_rows(call: _Inflight) -> list:
        """[(row, (slot_idx, req))] of an admission or chunk call's lanes
        that sample their first token."""
        if call.kind == "admit":
            return list(enumerate(call.lanes))
        return [(row, (slot_idx, req)) for row, slot_idx, req in call.lanes]

    def _first_tokens(self, call: _Inflight, now: float) -> None:
        """Record, stamp (TTFT) and emit the first token of each lane of an
        admission or chunk call that still holds its slot."""
        span = ("engine.prefill" if call.kind == "admit"
                else "engine.prefill_chunk")
        arr = call.stage.out_np
        for j, (slot_idx, req) in self._first_rows(call):
            s = self._slots[slot_idx]
            if s is None or s.req is not req:
                continue        # preempted before reconcile
            tok = int(arr[j])
            s.pending_admit = False
            s.generated.append(tok)
            if req.first_token_time == 0.0:
                req.first_token_time = now
                self._observe_ttft(now - req.submit_time, req.slo_class,
                                   trace_id=self._trace_id(req))
            s.first_token_time = req.first_token_time
            self._span(span, call.t0, now, req,
                       constrained=req.sampling.constrained,
                       **call.span_attrs)
            self._emit(req, [tok])

    def _observe_ttft(self, ttft_s: float, slo_class: str = DEFAULT_CLASS,
                      trace_id: str = "") -> None:
        self.hist_ttft.observe(ttft_s, slo_class, trace_id)
        for i, le in enumerate(self.ttft_buckets):
            if ttft_s <= le:
                self.ttft_counts[i] += 1
                break
        else:
            self.ttft_counts[-1] += 1
        self.ttft_sum += ttft_s
        self.ttft_count += 1
        prev = self.ttft_ema_by_class.get(slo_class)
        self.ttft_ema_by_class[slo_class] = (
            ttft_s if prev is None else 0.9 * prev + 0.1 * ttft_s)

    def _is_finished(self, s: _Slot) -> bool:
        return bool(s.generated) and (
            s.generated[-1] == self.eos_id
            or len(s.generated) >= s.req.sampling.max_tokens)

    def _retire(self, slot_idx: int) -> None:
        s = self._slots[slot_idx]
        now = time.monotonic()
        req = s.req
        # Tokens generated before a preemption live in the folded prompt.
        toks = req.prompt_ids[req.orig_prompt_len:] + s.generated
        reason = "eos" if toks and toks[-1] == self.eos_id else "length"
        if reason == "eos":
            toks = toks[:-1]
        error = s.abort_cause
        if error:
            reason = "error"
        result = GenerationResult(
            request_id=req.request_id, token_ids=toks, finish_reason=reason,
            # A slot cancelled mid-prefill retires with no first token.
            ttft_s=(s.first_token_time - req.submit_time
                    if s.first_token_time > 0.0 else 0.0),
            latency_s=now - req.submit_time, error=error)
        self._results[req.request_id] = result
        self.hist_e2e.observe(result.latency_s, req.slo_class,
                              self._trace_id(req))
        self._end_request_span(
            req, "error" if error else "ok", finish_reason=reason,
            tokens=len(toks), ttft_s=round(result.ttft_s, 6))
        if self.token_sink is not None:
            self.token_sink(req.request_id, [], result)
        if self._inflight:
            # A call in flight may still write these pages (zombie steps):
            # free them once the newest dispatched call is reconciled.
            self._deferred_frees.append((self._next_call_id - 1, s.blocks))
        else:
            self.allocator.free(s.blocks)
        s.retired = True
        self._slots[slot_idx] = None

    def _preempt(self, slot_idx: int) -> None:
        """Evict a lane by recompute: its generated tokens fold into the
        prompt, its budget shrinks by as many, and it is requeued at the
        head of the queue.  Only on reconciled state (the callers drain
        every call in flight first), so ``generated`` is complete."""
        s = self._slots[slot_idx]
        assert s.inflight_decode == 0 and s.inflight_chunks == 0
        self.allocator.free(s.blocks)
        self._slots[slot_idx] = None
        s.retired = True
        req = s.req
        consumed = len(s.generated)
        req.prompt_ids = req.prompt_ids + s.generated
        req.sampling = dataclasses.replace(
            req.sampling, max_tokens=max(1, req.sampling.max_tokens - consumed))
        self._cap_request(req)
        self._pending.appendleft(req)
        self.preemptions += 1
        self.preemptions_by_class[req.slo_class] = (
            self.preemptions_by_class.get(req.slo_class, 0) + 1)
        t_now = time.monotonic()
        self._span("engine.preempt", t_now, t_now, req,
                   tokens_folded=consumed)
        self._flight.note("preempt", request_id=req.request_id,
                          slo_class=req.slo_class, tokens_folded=consumed)
