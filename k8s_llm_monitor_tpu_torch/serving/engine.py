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

Reconciliation is synchronous: each dispatch is read back before the next
(no dispatch-ahead).  Where the JAX engine donates the page arrays to its
jitted programs, this engine updates them in place.  Preemption,
deadlines, SLO classes, tenancy, tracing, speculative decoding, prefix
reuse and the host KV tier are not ported yet; the resident pool may be
int8/fp8 (``EngineConfig.kv_dtype``).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from k8s_llm_monitor_tpu_torch.models import llama
from k8s_llm_monitor_tpu_torch.models.config import ModelConfig
from k8s_llm_monitor_tpu_torch.ops.attention import (
    paged_decode_attention,
    select_decode_impl,
    select_prefill_impl,
)
from k8s_llm_monitor_tpu_torch.ops.sampling import greedy_tokens, sample_tokens
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


@dataclasses.dataclass
class GenerationRequest:
    request_id: str
    prompt_ids: list[int]
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    submit_time: float = dataclasses.field(default_factory=time.monotonic)
    first_token_time: float = 0.0


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


class _Slot:
    __slots__ = ("req", "blocks", "ctx_len", "generated", "prefill_pos",
                 "prefilling", "cancel_requested")

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

    @property
    def remaining(self) -> int:
        return self.req.sampling.max_tokens - len(self.generated)


class InferenceEngine:
    """Single-process engine over batched prefill and K-step decode.

    ``device`` defaults to ``cuda`` (llama.resolve_device); the model's
    weights must live there.  Not thread-safe: one thread owns the engine.
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
        self._pending: deque[GenerationRequest] = deque()
        self._slots: list[Optional[_Slot]] = [None] * ec.max_slots
        self._results: dict[str, GenerationResult] = {}
        self.steps = 0            # step() calls
        self.decode_steps = 0     # decode_step calls
        self.decode_tokens = 0    # tokens emitted by decode calls
        self.decode_s = 0.0       # wall time of decode calls (synchronized)

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

    def submit(self, req: GenerationRequest) -> None:
        if not req.prompt_ids:
            raise ValueError("empty prompt")
        if req.sampling.max_tokens < 1:
            raise ValueError("max_tokens must be >= 1")
        self._cap_request(req)
        self._pending.append(req)

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
    # engine loop
    # ------------------------------------------------------------------

    def step(self) -> None:
        """One scheduler iteration: retire cancelled slots, run up to
        ``max_admission_rounds`` batched prefills, one chunk round and one
        K-step decode call."""
        self.steps += 1
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

    def _first_tokens(self, logits, temp, topk, topp, greedy: bool):
        if greedy:
            return greedy_tokens(logits)
        return sample_tokens(self._gen, logits, temperature=self._t(temp),
                             top_k=self._t(topk), top_p=self._t(topp))

    def _fail_request(self, req: GenerationRequest, msg: str) -> None:
        self._results[req.request_id] = GenerationResult(
            request_id=req.request_id, token_ids=[], finish_reason="error",
            ttft_s=0.0, latency_s=time.monotonic() - req.submit_time,
            error=msg)

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
            blocks = self.allocator.alloc(L + 1)
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
        for j, (_, req, blocks) in enumerate(batch):
            L = len(req.prompt_ids)
            tokens[j, :L] = req.prompt_ids
            lengths[j] = L
            tables[j, :len(blocks)] = blocks
            sp = req.sampling
            temp[j], topk[j], topp[j] = sp.temperature, sp.top_k, sp.top_p
        logits, _ = llama.prefill(self.model, self._t(tokens),
                                  self._t(lengths), self.pages,
                                  self._t(tables), attn_impl=self._prefill_attn)
        greedy = all(r.sampling.temperature <= 0.0 for _, r, _ in batch)
        first = self._first_tokens(logits, temp, topk, topp, greedy)
        lanes = []
        for j, (slot_idx, req, blocks) in enumerate(batch):
            slot = _Slot(req, blocks)
            slot.ctx_len = len(req.prompt_ids)
            self._slots[slot_idx] = slot
            lanes.append((j, slot_idx))
        self._place_first_tokens(first, lanes)
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
        lanes = []
        greedy = True
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
                lanes.append((j, i))
        logits, _ = llama.prefill_chunk(
            self.model, self._t(tokens), self._t(start), self._t(lengths),
            self.pages, self._t(tables), attn_impl=self._prefill_attn)
        if lanes:
            first = self._first_tokens(logits, temp, topk, topp, greedy)
            self._place_first_tokens(first, lanes)
        return True

    def _place_first_tokens(self, first: torch.Tensor, lanes) -> None:
        """Write first tokens into the device token buffer and reconcile
        them: emission, TTFT, retirement."""
        rows = torch.tensor([j for j, _ in lanes], device=self.device)
        idx = torch.tensor([i for _, i in lanes], device=self.device)
        self._tok_state[idx] = first[rows]
        host = first.cpu().tolist()
        now = time.monotonic()
        for j, slot_idx in lanes:
            s = self._slots[slot_idx]
            s.generated.append(int(host[j]))
            if s.req.first_token_time == 0.0:
                s.req.first_token_time = now
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
                self._retire(i, error=f"out of KV blocks: {exc}")
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
        t0 = time.monotonic()
        toks = self._decode_call(K, self._t(ctx), self._t(remaining),
                                 self._t(table), temp, topk, topp, greedy)
        arr = toks.cpu().numpy()
        self.decode_s += time.monotonic() - t0
        self.decode_steps += K
        for i, s in lanes:
            new = [int(t) for t in arr[:, i] if t >= 0]
            self.decode_tokens += len(new)
            s.ctx_len += len(new)
            s.generated.extend(new)
            if self._is_finished(s):
                self._retire(i)
        return True

    def _decode_call(self, K: int, ctx, remaining, table, temp, topk, topp,
                     greedy: bool) -> torch.Tensor:
        """K decode steps with on-device token feedback.  The masking is the
        JAX scan's: a lane is active while it started active, has not hit
        EOS and has steps left; an idle lane runs at ctx 0 (null block) and
        emits -1.  Returns the [K, max_slots] token matrix."""
        if not greedy:
            temp_t, topk_t, topp_t = self._t(temp), self._t(topk), self._t(topp)
        active0 = ctx > 0
        done = torch.zeros_like(active0)
        tokens = self._tok_state
        outs = []
        for i in range(K):
            act = active0 & ~done & (i < remaining)
            ctx_eff = torch.where(act, ctx, torch.zeros_like(ctx))
            logits, _ = llama.decode_step(self.model, tokens, ctx_eff,
                                          self.pages, table,
                                          attn_impl=self._decode_attn)
            if greedy:
                nxt = greedy_tokens(logits)
            else:
                nxt = sample_tokens(self._gen, logits, temperature=temp_t,
                                    top_k=topk_t, top_p=topp_t)
            nxt = torch.where(act, nxt, tokens)
            done = done | (act & (nxt == self.eos_id))
            ctx = torch.where(act, ctx + 1, ctx)
            outs.append(torch.where(act, nxt, torch.full_like(nxt, -1)))
            tokens = nxt
        self._tok_state = tokens
        return torch.stack(outs)

    def _is_finished(self, s: _Slot) -> bool:
        return bool(s.generated) and (
            s.generated[-1] == self.eos_id
            or len(s.generated) >= s.req.sampling.max_tokens)

    def _retire(self, slot_idx: int, error: str = "") -> None:
        s = self._slots[slot_idx]
        now = time.monotonic()
        toks = list(s.generated)
        reason = "eos" if toks and toks[-1] == self.eos_id else "length"
        if reason == "eos":
            toks = toks[:-1]
        if error:
            reason = "error"
        req = s.req
        self._results[req.request_id] = GenerationResult(
            request_id=req.request_id, token_ids=toks, finish_reason=reason,
            ttft_s=(req.first_token_time - req.submit_time
                    if req.first_token_time > 0.0 else 0.0),
            latency_s=now - req.submit_time, error=error)
        self.allocator.free(s.blocks)
        self._slots[slot_idx] = None
