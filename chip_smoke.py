#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py                 # every phase, one GPU
    python3 chip_smoke.py --phases 0,1    # build + kernel checks only
    python3 chip_smoke.py --phases 0,1,4 --only flash_prefill
                                          # check + time one kernel
    python3 chip_smoke.py --phases 0,1,4 --only fused_decode
    python3 chip_smoke.py --phases 0,1,4 --only paged_attn
    python3 chip_smoke.py --phases 0,2,5  # the engine, then the request's way in
    python3 chip_smoke.py --phases 0,6    # the monitor's front door alone
    python3 chip_smoke.py --phases 0,7    # prefix reuse, preemption, recovery
    python3 chip_smoke.py --phases 0,8    # llama-1b and speculative decoding
    python3 chip_smoke.py --phases 0,9    # Qwen2-7B, int8 / W8A8, a checkpoint
    python3 chip_smoke.py --phases 0,10   # the unscaled fp8 pool, KV tiers

Phase 0  card name and power limit, torch/CUDA versions, builds the CUDA
         kernels from k8s_llm_monitor_tpu_torch/csrc (one nvcc per source,
         started together) and prints the build seconds.
Phase 1  each kernel against its plain PyTorch version on the card, at the
         Llama-3-8B head geometry (H=32, KVH=8, D=128, block 16) with bf16
         activations: flash prefill over bf16, int8 and fp8 pools (ragged
         S 128 and 1024, a chunk at start > 0, an empty lane, a lane one
         token below block alignment, the S=2048 chunk shape, a
         continuation chunk starting inside a key tile, qpk 8 (64/8 heads)
         and qpk 1 (32/32) at ragged lengths, blocks of 12 tokens, a
         prefix-hit admission round (8 lanes in the 256 bucket, starts 0
         and 1,024..1,536, suffixes 32..160) and the 4096 bucket),
         fused decode over bf16, int8 and fp8 pools (decode_cases: B=32
         at contexts up to 2048, qpk 8 and 1, blocks of 12; each with
         positions on both sides of the split kernel's chunk boundaries,
         one cached row, an inactive lane, the table's last row and a
         lane past the table; outputs and pages, and the appended codes
         and scales bit for bit against the quant plain versions on the
         card), and split paged attention at QS=1 through the decode
         wrapper (decode_b3_cases) and at QS=1..8 through the verify
         wrapper (PAGED_CASES): horizons on both sides of the 256-key
         chunk boundaries, qpk 1, 2, 4 and 8, blocks of 12, rows past
         qlens and empty lanes exactly zero.  The same at head_dim 64
         (llama-1b's 32/8 heads and 16/2): fused decode over the three
         pools (decode_cases_d64) and split paged attention at QS=1..8
         (PAGED_CASES_D64), QS > 1 held as paged_attn_verify_d64; and flash
         prefill at the spec verify shape (VERIFY_SHAPE: 32 lanes, S=5 at
         the lanes' positions, some empty), held as flash_prefill_verify.
         At 7 query heads per kv head (Qwen2-7B's 28/4, D=128, the _qpk7
         records; 14/2 at D=64 under the _d64 ones): flash prefill over the
         three pools at ragged lengths across the 16-position row slabs,
         blocks of 12, a 2048 chunk and the verify shape; fused decode over
         the three pools; split paged attention at QS 1, 2, 4, 5 and 8
         (every row-tile count).
Phase 2  the engine at full Llama-3-8B width (32 layers, random bf16 weights
         from a seeded generator on the card): a bf16 pool (8 GiB), an int8
         and an fp8 pool, and decode_path="pallas".  15 prompts of
         20..1500 tokens plus one of 2300 (chunked prefill), greedy, 32 new
         tokens, the prefix cache off.  Each engine runs at the defaults
         (the K-step decode programs as CUDA graphs, admission, chunk and
         decode calls in flight, max_inflight 2); the bf16, int8 and
         pallas engines also run the eager loop that reads each admission
         round back as it runs and reconciles each decode call in its own
         step (decode_graphs=False, max_inflight=0, admit_inflight=False),
         and bf16 the eager loop with dispatch-ahead: greedy ids and launch
         counts must be equal across one engine's settings.  For each run
         the launch counts are set to 0 just before it and read just
         after: every request must finish, every kernel of its path must
         have launched, and a second identical run must give identical
         ids.  Prints TTFT p50, decode tokens/s, weight and pool bytes, the
         share of steps that waited on the device while dispatching, the
         prefill rounds by bucket, and the decode graphs captured, their
         seconds and the graph pool's bytes.  A third run of each bf16, int8 and pallas setting traces
         its decode steps (after the last prefill) with torch.profiler,
         which sees the kernels a graph replays: wall and device busy ms
         per step, the device's idle share of the window, device time per
         kernel (the attention kernels by name, each must show time: the
         split and merge kernels of the fused and of the split paged
         attention) and the number of device kernels.
Phase 3  the kernel path against the plain path on the same weights cut to
         4 layers: first-token and decode-step logits of flash/fused and
         flash/pallas against dense/gather (bf16 pool), and of the int8 and
         fp8 kernels against their plain versions (not against dense: fresh
         dense prefill attends to the unquantized in-flight K/V), with the
         argmax agreement over the 20 rows (a row whose plain-path top two
         logits lie within the logit tolerance counts as agreeing); and a
         small float32 model, whose greedy ids on the card must equal the
         CPU's, free and under the verdict grammar (constrained greedy).
Phase 4  per-kernel timings at the main path's shapes (CUDA events): the
         kernel, its plain version, one PyTorch call computing the same
         function on K/V gathered (and dequantized) beforehand
         (scaled_dot_product_attention, a yardstick the port never calls)
         and the least time the card could take for the same bytes and
         flops; launches per engine step.  Flash prefill is recorded at
         three shapes (the ``shape`` key): an admission round, a 2048 chunk
         and phase 1's prefix-hit round;
         beside the wrapper's time it prints the kernel's alone (launched on
         pre-scaled q), which leaves out the wrapper's q-scale pass.  Fused
         decode is recorded at the engine's mid-decode batch and a full
         batch, both over the engine's 256-block table, with the kernels'
         time alone (20 launches on prepared arguments replayed from one
         CUDA graph: device time only) and, at the engine shape, alone at
         chunks of 128, 256 and 512 keys.  Split paged attention likewise
         over the same table: the decode_path="pallas" engine's shape
         (QS=1) and a verify shape (the same lanes, 8 query tokens ending
         at the engine position), through the wrapper, alone, and alone at
         chunks of 128, 256 and 512 keys.  At head_dim 64 (llama-1b's
         heads, the same 32 lanes and table): fused decode over the three
         pools, split paged attention at QS=1 and at QS=5 from each lane's
         position, and the verify threshold: QS=5 through the kernel
         against the gather path over tables of 1,024 and 4,096 tokens.
         Flash prefill at the verify shape (S=5 at each lane's position),
         bf16 and int8.  At Qwen2-7B's 28/4 heads (the _qpk7 records): flash
         prefill at the admission shape (bf16, int8) and the verify shape,
         fused decode (bf16, int8) and split paged attention at QS=1 and 5
         at the head_dim 64 block's shapes.

Phase 5  the request's way in: phase 2's Llama-3-8B model in an engine
         with a bf16 pool (the prefix cache off), ByteTokenizer and the
         verdict grammar's token
         FSM, wrapped in the port's LocalEngineBackend (EngineService step
         thread).  A burst from 25 threads: 16 generate_constrained
         evidence questions of 200..1500 bytes, 8 generate calls at
         temperature 0.7 and top_k 40 (the bounded sampler) and 1
         generate_stream.  The launch counts are set to 0 just before the
         burst and read once every handle has resolved: flash prefill and
         fused decode must have launched.  Every verdict must parse, no
         result may be an error, and a lone constrained question must give
         the same ids through the service as through engine.generate.
         Prints the burst's TTFT p50/p99, decode tokens/s,
         constrained_decode_overhead_ms, the decode graphs captured (their
         seconds, the graph pool's bytes), and the wall time per sampled
         decode step with sample_topk_cap 64 against 0 (one run at each
         that captures their graphs, then in turns), beside
         the two samplers alone on [32, 128256] logits (CUDA events).
Phase 6  the monitor's front door: the earlier phases' model is freed, then
         the port's build_server boots in process on port 0 over the demo
         FakeCluster with llm.provider "tpu" at llama3-8b (bf16 weights and
         pool, kv_blocks 4096, max_batch 32, spec_k 0, max_tokens 64, a
         journal in a temporary directory, telemetry and remediation off):
         cmd/server's chain down to EngineSupervisor -> EngineService ->
         InferenceEngine.step.  One cold request of 8 greedy tokens (a
         prefill and three decode calls, each one's graph captured) must
         not trip the heartbeat watchdog; /health and /readyz must be
         ready.  A burst
         over HTTP from 24 threads (16 POST /api/v1/query, 4 POST
         /api/v1/analyze root_cause, 1 streamed query, 3 GET /api/v1/stats)
         with the launch counts set to 0 just before it and read after it:
         every response 200 and "success", every verdict of the grammar's
         schema, flash prefill and fused decode launched (it prints
         constrained_decode_overhead_ms and the graph captures); then the
         same burst again, its graphs captured, for the warm walls, and
         the prefix cache's hits and the deferrals (the cache on).  Then
         Warning
         BackOff events in the FakeCluster reach the diagnosis pipeline
         through the Watcher, and GET /api/v1/diagnoses must show a verdict;
         eight greedy backend.generate calls run without and then with one
         step_loop_crash partway through: one restart, the same texts, no
         token delivered twice, every journaled admit tombstoned, and the
         dead engine's pool released before the new one is allocated
         (memory_allocated before/after, max_memory_allocated across);
         supervisor.shutdown flips /readyz to 503 and seals the journal.
         Last, python -m k8s_llm_monitor_tpu_torch.cmd.server --cluster
         fake (tiny model) in its own process answers a query and exits 0
         on SIGTERM.
Phase 7  prefix reuse, preemption and recovery at full Llama-3-8B width
         (phase 2's model; it runs before phase 6, which frees it).  7a:
         32 greedy requests sharing a 1,536-token prefix, each with its own
         32..160-token tail, 32 new tokens, submitted at once, on phase 2's
         bf16 engine with the prefix cache on and off and on the int8 engine
         with it on: hits >= 31 and the prefill rows computed with the
         cache on at most a quarter of those with it off; prints hits,
         misses, deferrals, rows, flash launches, burst wall, TTFT p50/p99,
         decode tokens/s and the id sequences equal to the cache-off run's;
         every run complete and its free count back at the idle baseline.
         Then, on 4 layers, the first-token logits of 4 prompts prefilled
         as hits (their tails over a publisher's pages) against whole
         prefills, by phase 3's rule.  7b: 16 slots over a pool of 512 x
         16 tokens, 16 greedy requests of 300..400-token prompts with 400
         new tokens in two SLO classes: lanes are preempted, every request
         returns its 400 tokens, the free count returns; the id sequences
         equal to an unpressured run's are printed.  7c: on the 7b engine
         (dispatch_timeout_s 2.0), decode_stuck, prefill_dispatch and
         lane_eviction armed once each: one watchdog trip or dispatch
         failure each, every request complete, no decode graph recaptured.

Phase 8  llama-1b and speculative decoding (runs after phase 3, before 4:
         its launch counts are phase 4's records').  8a: llama-1b at full
         width (16 layers, hidden 2048, vocab 128,256, random bf16 weights
         from a seed, 32 slots, 256 x 16 table), phase 2's 16 prompts and
         32 new tokens on bf16, int8, fp8 and decode_path="pallas" pools,
         spec off: prefill dense (flash keeps head_dim 128), decode on the
         fused, fused-quant and split kernels at D=64, each launched.  On 4
         layers, verify_step's logits (B3 at QS=5) against 5 sequential
         fused decode steps, by phase 3's rule.  Then the model is made to
         quote (the JAX bench's spec_quote_accept construction: attention
         and MLP outputs zeroed, the unembed walking a 200-token cycle) and
         16 prompts of three cycle periods take 128 tokens, spec off (it
         must walk the cycle) and spec_k 4 with spec_min_accept 0: the
         split paged attention kernel launches at QS=5 and the spec program
         is captured as a graph and replayed.  8b: phase 2's Llama-3-8B
         model, spec off and spec_k 4 (spec_min_accept 0) on the bf16 and
         int8 pools: flash prefill launches inside the spec calls (B1, B5);
         on 4 layers verify_step against sequential decode on both pools.
         Between the two, 8c: the monitor's default config as
         load_config(None) gives it (llama-1b, quantize w8a8, spec_k 4,
         spec_min_accept 1.2, 32 slots, 512 x 16 blocks), telemetry and
         remediation off, through build_server and phase 6's HTTP burst:
         every response succeeds, the split paged attention kernel
         launches in spec calls and fused decode in decode calls, no
         dispatch failure.
         Each spec run prints its acceptance (tokens per lane-round),
         decode tokens/s against spec off, spec_accept_ema() and how many
         id sequences equal the spec-off run's.

Phase 9  weights and Qwen2-7B (runs last: phase 6 has freed the earlier
         model).  9a: Qwen2-7B at full width (28 layers, hidden 3584, 28/4
         heads, vocab 152,064, qkv bias; random bf16 weights from a seed,
         about 15.2 GB; a 4096 x 16 pool), phase 2's 16 prompts and 32 new
         tokens on bf16 and int8 pools and decode_path="pallas", and on
         the unscaled fp8 pool with either decode path (flash prefill,
         fused and split paged attention launched at 7 query heads per kv
         head; two identical runs give identical ids); on 4
         layers flash/fused and flash/pallas against dense/gather and the
         int8 kernels against their plain versions, by phase 3's rule;
         spec_k 4 (spec_min_accept 0) verifying through flash prefill, and
         with prefill dense through split paged attention at QS=5.  9b:
         llama-1b with int8 weights from init_params_quantized, run
         weight-only and W8A8, beside the same weights dequantized to
         bf16: decode graphs against the eager loop (ids equal), weight
         bytes and warm decode tok/s of the three; torch._int_mm at every
         (rows, in, out) shape the W8A8 engines called equal to a float64
         product; on 4 layers the int8 and W8A8 logits against the bf16
         model's, cosine at least 0.98 per position.  9c: llama-1b's shape
         written as an index-sharded bf16 safetensors checkpoint (1 GiB
         shards, an HF config.json; a writer of this script's own) to a
         temporary directory and read back with load_hf_checkpoint: every
         tensor bit for bit, the quantized load equal to quantize_params,
         load seconds and GB/s, greedy ids equal the in-memory model's;
         without transformers, from_config on the checkpoint must raise.

Phase 10 the unscaled fp8 KV pool (ModelConfig.kv_dtype = "float8_e4m3fn",
         B8) and the KV tiers (A5), after phase 7, on phase 2's model.
         10a: each e4m3 instance against its plain version on its first
         call: cast_e4m3 on the card equals the CPU's (edges, NaN,
         subnormals); flash prefill at phase 4's admission, chunk, hit and
         verify shapes at qpk 4 and 7; fused decode at D 128 (qpk 4, 7)
         and 64 (llama-1b) with rows holding +-448..512 appended bit for
         bit; split paged attention at QS=1 and 5, rows past qlens and
         empty lanes zero.  10b: the e4m3 records timed by phase 4's
         method at its shapes (the _qpk7 ones as phase 4's, launched by
         phase 9a's fp8-pool Qwen2-7B engines).  10c: Llama-3-8B, then llama-1b, with an
         fp8 pool through auto, pallas and spec_k 4 engines (launches
         counted, the pool half of bf16's, TTFT and tok/s beside phase
         2's), and 4-layer logits against the bf16 pool (cosine >= 0.98).
         10d: the host tier on bf16, int8 and fp8 pools of 512 x 16
         blocks cycling 6 distinct 1,536-token prefixes (each run fresh,
         then as a device hit), then again: spills and restores, each
         second-pass prompt restored to its whole prefix with the device
         hit's ids, no graph recaptured, fetch and write GB/s, TTFT of a
         restored hit against a fresh prefill and a device hit.  10e: export/install between two engines on one
         model's weights, every outcome, the receiver's ids equal the
         owner's; then over HTTP through the server's /api/v1/kv routes.

Prints one JSON line of kernel records, the card's name and power limit,
then ``{"ok": true, "device": {...}}`` as the last line.  Any failed phase
prints its reason and exits non-zero.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import statistics
import subprocess
import sys
import time

# Published H100 SXM peaks (dense): bf16 tensor cores and HBM3 bandwidth.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_S = 3.35e12
H, KVH, D, BS = 32, 8, 128, 16
ENGINE_TABLE = 256                 # phase 2's EngineConfig.max_blocks_per_seq
TOL = dict(atol=2e-2, rtol=2e-2)   # bf16 kernel vs bf16 plain version
# ... and, scale-aware, in bf16 ulps of each (row, head)'s largest value:
# rows deep in a long context have small outputs, where atol alone is loose.
ULP_TOL = 2
LOGIT_ATOL = 0.1                   # bf16 logits after 4 layers
# ... over an int8/fp8 pool the kernels also round p * v_scale to bf16
# before the PV product and append codes from their own f32 RoPE (one code
# step apart at ties), which 4 layers of random weights amplify: the first
# run measured 0.0625 (int8) and 0.094 (fp8) against the plain versions.
QUANT_LOGIT_ATOL = 0.2
MIN_ARGMAX_AGREE = 0.95            # of the 20 logit rows of phase 3


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def wanted(st, kernel: str) -> bool:
    """Whether phases 1 and 4 check and time ``kernel`` (``--only``)."""
    return st.get("only") in (None, kernel)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- helpers


def _tables(torch, rng, B, nb_per_lane, num_blocks):
    """Distinct non-null blocks per lane, in shuffled order."""
    perm = rng.permutation(num_blocks - 1)[: B * nb_per_lane] + 1
    return torch.as_tensor(perm.reshape(B, nb_per_lane), dtype=torch.int32)


def prefill_case(torch, rng, gen, B, S, starts, lengths, heads=(H, KVH),
                 bs=BS, d=D):
    """q, pages, table, starts, lengths of one flash prefill call;
    ``heads`` = (query heads, kv heads), ``bs`` tokens per block, ``d`` the
    head dim."""
    nh, nkv = heads
    ctx = max(s + n for s, n in zip(starts, lengths))
    nbl = (ctx + bs - 1) // bs + 1
    num_blocks = B * nbl + 1
    dev = "cuda"
    q = torch.randn(B, S, nh, d, generator=gen, device=dev).to(torch.bfloat16)
    kp = torch.randn(num_blocks, bs, nkv * d, generator=gen, device=dev).to(torch.bfloat16)
    vp = torch.randn(num_blocks, bs, nkv * d, generator=gen, device=dev).to(torch.bfloat16)
    table = _tables(torch, rng, B, nbl, num_blocks).to(dev)
    st = torch.tensor(starts, dtype=torch.int32, device=dev)
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, kp, vp, table, st, ln


def decode_case(torch, rng, gen, positions, nbl, heads=(H, KVH), bs=BS,
                d=D):
    """q, k_new, v_new, cos, sin, pages, table, positions of one fused
    decode call; ``nbl`` table blocks per lane, ``d`` the head dim."""
    B = len(positions)
    num_blocks = B * nbl + 1
    nh, nkv = heads
    dev = "cuda"
    from k8s_llm_monitor_tpu_torch.ops.rope import rope_angles

    q = torch.randn(B, 1, nh, d, generator=gen, device=dev).to(torch.bfloat16)
    kn = torch.randn(B, 1, nkv, d, generator=gen, device=dev).to(torch.bfloat16)
    vn = torch.randn(B, 1, nkv, d, generator=gen, device=dev).to(torch.bfloat16)
    kp = torch.randn(num_blocks, bs, nkv * d, generator=gen, device=dev).to(torch.bfloat16)
    vp = torch.randn(num_blocks, bs, nkv * d, generator=gen, device=dev).to(torch.bfloat16)
    table = _tables(torch, rng, B, nbl, num_blocks).to(dev)
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
    cos, sin = rope_angles(pos[:, None], d, 500_000.0)
    return q, kn, vn, cos, sin, kp, vp, table, pos


QUANTS = ("int8", "fp8")
# The unscaled fp8 pool (ModelConfig.kv_dtype = "float8_e4m3fn", B8): its
# kernel instances' symbol suffix and record tag.
E4M3 = "e4m3"


def _page_bytes(kv_quant, d=D):
    """Bytes one cached position of one kv head costs in the K or V plane:
    ``d`` page elements (2 bytes on a bf16 pool, 1 on an unscaled e4m3
    one), plus a float32 scale on a quantized pool."""
    return {"": 2 * d, E4M3: d}.get(kv_quant, d + 4)


def quantize_pages(torch, pages, kv_quant, d=D):
    """(codes, scales) of a bf16 pool, by the port's own quantize_kv."""
    from k8s_llm_monitor_tpu_torch.models.llama import kv_quant_spec, quantize_kv

    qdtype, qmax = kv_quant_spec(kv_quant)
    return quantize_kv(pages, pages.shape[-1] // d, qdtype, qmax)


def quant_prefill_case(torch, rng, gen, B, S, starts, lengths, kv_quant,
                       heads=(H, KVH), bs=BS):
    """prefill_case over a quantized pool: (args, scale kwargs)."""
    q, kp, vp, table, st, ln = prefill_case(torch, rng, gen, B, S, starts,
                                            lengths, heads, bs)
    kq, ks = quantize_pages(torch, kp, kv_quant)
    vq, vs = quantize_pages(torch, vp, kv_quant)
    return (q, kq, vq, table, st, ln), dict(k_scale=ks, v_scale=vs)


def quant_decode_case(torch, rng, gen, positions, nbl, kv_quant,
                      heads=(H, KVH), bs=BS, d=D):
    """decode_case over a quantized pool, in the fused quant wrapper's
    argument order."""
    q, kn, vn, cos, sin, kp, vp, table, pos = decode_case(
        torch, rng, gen, positions, nbl, heads, bs, d)
    kq, ks = quantize_pages(torch, kp, kv_quant, d)
    vq, vs = quantize_pages(torch, vp, kv_quant, d)
    return q, kn, vn, cos, sin, kq, vq, ks, vs, table, pos


def prefill_work(starts, lengths, S, kv_quant="", heads=(H, KVH)):
    """(bytes, flops) the flash prefill must move and do for these inputs:
    each input read once, each output written once, causal pairs only.
    Rows past ``lengths`` are padding no caller reads, so q and out count
    only the valid rows."""
    nh, nkv = heads
    B = len(starts)
    qo = 2 * sum(lengths) * nh * D * 2                  # q in, out
    kv = sum((s + n) * nkv * _page_bytes(kv_quant) * 2
             for s, n in zip(starts, lengths))
    table = 4 * B * (2 + max((s + n + BS - 1) // BS for s, n in zip(starts, lengths)))
    pairs = sum(n * s + n * (n + 1) // 2 for s, n in zip(starts, lengths))
    return qo + kv + table, 4 * D * nh * pairs


def decode_work(positions, kv_quant="", heads=(H, KVH), d=D):
    """(bytes, flops) of one fused decode step: the cached rows (and
    scales) read, q, k_new, v_new, angles and positions read, out and the
    appended rows (and scales) written."""
    nh, nkv = heads
    B = len(positions)
    row = nkv * _page_bytes(kv_quant, d)
    cached = sum(p * row * 2 for p in positions)
    io = B * (2 * nh * d * 2 + 2 * nkv * d * 2 + 2 * row + 2 * d * 4 + 4)
    table = 4 * sum((p + BS) // BS for p in positions)
    flops = sum(4 * nh * d * (p + 1) for p in positions if p > 0)
    return cached + io + table, flops


def paged_attn_work(starts, qlens, heads=(H, KVH), d=D, page_bytes=2):
    """(bytes, flops) of the split paged attention: the keys the live
    tokens see (K and V of ``page_bytes``-byte elements), q and out of the
    live tokens, table, starts and qlens."""
    nh, nkv = heads
    keys = [s + n for s, n in zip(starts, qlens)]
    kv = sum(keys) * nkv * d * page_bytes * 2
    qo = 2 * sum(qlens) * nh * d * 2
    table = 4 * sum((k + BS - 1) // BS for k in keys) + 8 * len(starts)
    flops = sum(4 * nh * d * (s + i + 1)
                for s, n in zip(starts, qlens) for i in range(n))
    return kv + qo + table, flops


def bound(bytes_, flops):
    tb, tf = bytes_ / PEAK_BYTES_S * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def ulp_err(torch, got, want):
    """Largest |got - want| over the last axis, in bf16 ulps of the largest
    |want| of that (row, head): a bf16 ulp at x in [2^(e-1), 2^e) is
    2^(e-8)."""
    w = want.float()
    _, e = torch.frexp(w.abs().amax(-1))
    ulp = torch.ldexp(torch.ones_like(e, dtype=torch.float32), e - 8)
    return float(((got.float() - w).abs().amax(-1) / ulp).max())


def flash_alone(torch, pa, case, scales):
    """A call that launches the flash kernel alone on pre-scaled q: the
    wrapper's time less its q-scale pass, checks and allocation."""
    q, kp, vp, table, st, ln = case
    qs = (q * D ** -0.5).contiguous()
    out = torch.empty_like(qs)
    suffix = pa._check_pool(kp, vp, scales.get("k_scale"),
                            scales.get("v_scale"), D, "flash prefill")
    sc = ([] if not scales else
          [scales["k_scale"].data_ptr(), scales["v_scale"].data_ptr()])
    fn = pa._kernel(f"flash_prefill_{suffix}")
    args = (qs.data_ptr(), kp.data_ptr(), vp.data_ptr(), *sc,
            table.data_ptr(), st.data_ptr(), ln.data_ptr(), out.data_ptr(),
            *q.shape[:3], kp.shape[-1] // D, kp.shape[1], table.shape[1],
            torch.cuda.current_stream().cuda_stream)

    def call():
        check(fn(*args) == 0, "flash kernel launch failed")
    call.tensors = qs, out          # what the pointers in args point into
    return call


def decode_alone(torch, pa, case):
    """A call that launches the fused decode kernels alone (the split
    kernel and its merge) on arguments prepared once: the wrapper's time
    less its checks, casts and allocations (timed by graph_ms)."""
    q, kn, vn, cos, sin, kp, vp = case[:7]
    scales, (table, pos) = case[7:-2], case[-2:]
    B, _, nh, d = q.shape
    nkv = kp.shape[-1] // d
    cs = cos.float().reshape(B, d).contiguous()
    sn = sin.float().reshape(B, d).contiguous()
    nsplit, chunk = pa.decode_splits(table.shape[1], kp.shape[1],
                                     kp.element_size())
    ws = torch.empty(pa.decode_workspace_floats(B, nkv, nh // nkv, nsplit, d),
                     dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    suffix = pa._check_pool(kp, vp, *(scales or (None, None)), d,
                            "fused decode")
    fn = pa._kernel(f"fused_decode_{suffix}")
    args = (q.data_ptr(), kn.data_ptr(), vn.data_ptr(), cs.data_ptr(),
            sn.data_ptr(), kp.data_ptr(), vp.data_ptr(),
            *(t.data_ptr() for t in scales), table.data_ptr(), pos.data_ptr(),
            out.data_ptr(), ws.data_ptr(), B, nh, nkv, d, kp.shape[1],
            table.shape[1], nsplit, chunk, d ** -0.5)

    def call():      # on the current stream: graph_ms captures it
        check(fn(*args, torch.cuda.current_stream().cuda_stream) == 0,
              "fused decode launch failed")
    call.tensors = cs, sn, ws, out   # what the pointers in args point into
    return call


def paged_alone(torch, pa, q, kp, vp, table, lengths=None, starts=None,
                qlens=None):
    """A call that launches the split paged-attention kernels alone (the
    split kernel and its merge) on arguments prepared once: decode with
    ``lengths``, verify with ``starts`` and ``qlens`` (timed by
    graph_ms)."""
    B, QS, nh, d = q.shape
    nkv = kp.shape[-1] // d
    out = torch.empty_like(q)
    nsplit, chunk = pa.decode_splits(table.shape[1], kp.shape[1],
                                     kp.element_size())
    ws = torch.empty(pa.decode_workspace_floats(B, nkv, QS * (nh // nkv),
                                                nsplit, d),
                     dtype=torch.float32, device=q.device)
    suffix = pa._check_pool(kp, vp, None, None, d, "paged attention")
    if lengths is not None:
        sym, lanes, dims = f"paged_attn_decode_{suffix}", (lengths,), (B,)
    else:
        sym, lanes, dims = f"paged_attn_{suffix}", (starts, qlens), (B, QS)
    fn = pa._kernel(sym)
    args = (q.data_ptr(), kp.data_ptr(), vp.data_ptr(), table.data_ptr(),
            *(t.data_ptr() for t in lanes), out.data_ptr(), ws.data_ptr(),
            *dims, nh, nkv, d, kp.shape[1], table.shape[1], nsplit, chunk,
            d ** -0.5)

    def call():      # on the current stream: graph_ms captures it
        check(fn(*args, torch.cuda.current_stream().cuda_stream) == 0,
              "paged attention launch failed")
    call.tensors = ws, out   # what the pointers in args point into
    return call


def time_ms(torch, fn, reps=20, warmup=3, rounds=1):
    """ms per call over ``reps`` back-to-back calls, the best of
    ``rounds`` such batches (a call whose host work outlasts its kernels
    measures the host, which other processes on the machine slow down)."""
    for _ in range(warmup):
        fn()
    best = float("inf")
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        torch.cuda.synchronize()
        best = min(best, t0.elapsed_time(t1) / reps)
    return best


def device_ms(torch, fn, reps=20):
    """Device time per call of ``fn`` (the sum of its kernels' times in a
    torch.profiler trace of ``reps`` calls): what the card spends, without
    the host time between launches that CUDA events also count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA)
    check(us > 0, "the profiler saw no device time")
    return us / 1e3 / reps


def graph_ms(torch, fn, reps=20, rounds=5):
    """Device ms per call: ``reps`` calls captured in one CUDA graph and
    replayed, the best of ``rounds`` replays; no host time is in it."""
    fn()                       # outside the capture: builds, configures
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return time_ms(torch, graph.replay, reps=1, warmup=1,
                   rounds=rounds) / reps


def truncated(model, n_layers, **cfg):
    """A view of ``model`` with its first ``n_layers`` layers (weights
    shared, nothing copied), its config changed by ``cfg`` as well."""
    from torch import nn

    m = copy.copy(model)
    m._modules = dict(model._modules)
    m.layers = nn.ModuleList(list(model.layers)[:n_layers])
    m.cfg = dataclasses.replace(model.cfg, num_layers=n_layers, **cfg)
    return m


# ----------------------------------------------------------------- phases


def phase0(torch, st):
    from k8s_llm_monitor_tpu_torch.ops import _build

    st["gpu"] = gpu_line()
    print(f"phase 0: gpu: {st['gpu']}")
    print(f"phase 0: python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t0 = time.monotonic()
    built = _build.build_all()
    secs = time.monotonic() - t0
    print(f"phase 0: built {built or 'nothing (up to date)'} in {secs:.2f} s")
    for name in _build.KERNELS:
        log = (_build.BUILD_DIR / f"{name}.ptxas.txt")
        lines = log.read_text().splitlines() if log.exists() else []
        for line in lines:
            if "registers" in line or "spill" in line or "error" in line:
                print(f"phase 0: ptxas {name}: {line.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def code_steps(torch, got, want):
    """Largest difference between two code planes in steps of the storage
    type: int8 steps are 1; an e4m3 step at x in [2^e, 2^(e+1)) is
    2^(e-3), at least 2^-9 (subnormals)."""
    g, w = got.float(), want.float()
    if got.dtype == torch.int8:
        return float((g - w).abs().max())
    mag = torch.maximum(g.abs(), w.abs()).clamp(min=2.0 ** -6)
    step = torch.exp2(torch.floor(torch.log2(mag)) - 3)
    return float(((g - w).abs() / step).max())


def check_rows(torch, name, got, want, rows, errs, ulps):
    """Hold ``got`` to ``want`` on the rows ``rows`` selects: atol/rtol and
    bf16 ulps of each (row, head)'s largest value; fold the errors into
    errs[name] / ulps[name]."""
    g, w = got[rows].float(), want[rows].float()
    err = float((g - w).abs().max())
    ulp = ulp_err(torch, g, w)
    errs[name] = max(errs.get(name, 0.0), err)
    ulps[name] = max(ulps.get(name, 0.0), ulp)
    check(bool(torch.isfinite(got.float()).all()), f"{name}: non-finite output")
    if not (ulp <= ULP_TOL and torch.allclose(g, w, **TOL)):
        # Which lanes, and how far: the first index of ``got``.
        lanes = (rows.nonzero().flatten().tolist() if torch.is_tensor(rows)
                 else list(range(got.shape[0]))[rows])
        per = [(lane, round(ulp_err(torch, g[i], w[i]), 3),
                float((g[i] - w[i]).abs().max())) for i, lane in
               enumerate(lanes)]
        print(f"phase 1: {name}: (lane, ulps, max abs err) {per}")
    check(torch.allclose(g, w, **TOL), f"{name}: max abs err {err:.4g}")
    check(ulp <= ULP_TOL, f"{name}: err {ulp:.3g} ulps")


# A prefix-hit admission round (phase 7a's): 8 lanes in the 256 bucket,
# hits that start past a cached prefix of 1,024..1,536 tokens beside
# misses that start at 0, suffixes of 32..160 tokens.
HIT_SHAPE = ([0, 1536, 1024, 1536, 0, 1280, 1536, 1100],
             [160, 32, 96, 128, 48, 160, 77, 140])

# A verify call of the spec engines (phase 8): 32 lanes, each verifying
# spec_k + 1 = 5 tokens from its position (page and chunk boundaries,
# deep contexts), every fifth lane empty.
VERIFY_SHAPE = ([(37 * i * i + 11 * i) % 2043 for i in range(32)],
                [0 if i % 5 == 3 else 5 for i in range(32)])

# Qwen2-7B's heads (phase 9): 28 query heads over 4 kv heads, head_dim 128.
HEADS_QWEN = (28, 4)


def qpk_suffix(heads, d) -> str:
    """Record-name suffix of a head geometry: 7 query heads per kv head at
    head_dim 128 (Qwen2-7B) are records of their own; at head_dim 64 they
    are held under the _d64 records."""
    return "_qpk7" if d == D and heads[0] // heads[1] == 7 else ""


# Flash prefill cases of phase 1: (query heads, kv heads, S, starts,
# lengths, tokens per block).  The Llama-3-8B heads (qpk 4) and block 16
# unless stated.
PREFILL_CASES = [
    # fresh, continuation, empty lane, ends one below block alignment
    (H, KVH, 128, [0, 37, 0, 300], [128, 91, 0, 19], BS),
    (H, KVH, 1024, [0, 1000], [1024, 700], BS),
    # an admission round of 8 prompts and a long prompt's last chunk
    (H, KVH, 1024, [0] * 8, [20, 181, 298, 407, 462, 515, 632, 1024], BS),
    (H, KVH, 256, [2048], [252], BS),
    # the chunk shape phase 4 times, and a continuation chunk that starts
    # inside a 64-key tile and crosses several
    (H, KVH, 2048, [0], [2048], BS),
    (H, KVH, 512, [1000], [500], BS),
    # qpk 8 (Qwen2-72B: 64 query heads over 8 kv heads) and qpk 1 (32
    # heads, no grouping), ragged
    (64, 8, 256, [0, 700, 5, 0], [256, 200, 77, 0], BS),
    (32, 32, 256, [0, 300, 13], [256, 131, 1], BS),
    # blocks of 12 tokens: the kernel divides positions by the block size
    # itself, by multiply and shift
    (H, KVH, 128, [0, 37, 300], [128, 91, 19], 12),
    # a prefix-hit admission round (HIT_SHAPE) and the 4096 bucket the
    # flash path adds (a 2,300-token prompt admitted in one round)
    (H, KVH, 256, *HIT_SHAPE, BS),
    (H, KVH, 4096, [0], [2300], BS),
    # speculative verify (VERIFY_SHAPE): 32 lanes, spec_k + 1 = 5 query
    # tokens at the lanes' positions, some lanes empty
    (H, KVH, 5, *VERIFY_SHAPE, BS),
    # qpk 7 (Qwen2-7B: 28 query heads over 4 kv heads; 16-position row
    # slabs, the eighth dead): ragged lengths across the slabs' tile
    # boundaries, an empty lane, blocks of 12, a 2048 chunk, the verify
    # shape
    (*HEADS_QWEN, 256, [0, 700, 5, 0, 33], [256, 200, 77, 0, 17], BS),
    (*HEADS_QWEN, 128, [0, 37, 300], [128, 91, 19], 12),
    (*HEADS_QWEN, 2048, [0], [2048], BS),
    (*HEADS_QWEN, 5, *VERIFY_SHAPE, BS),
]


def decode_cases(rng, chunks):
    """Fused decode cases of phase 1: (heads, positions, table blocks per
    lane, tokens per block).  Every case has an inactive lane (0), a lane
    with one cached row (1), both sides of the split kernel's chunk
    boundaries (chunk - 1, chunk, chunk + 1, 2 chunk, for the chunk of
    every page type), the last row of the table and a lane past it (its
    output is undefined and not compared; its row goes to the null
    block)."""
    edges = sorted({0, 1} | {p for c in chunks
                             for p in (c - 1, c, c + 1, 2 * c)})
    fixed = edges + [15, 16, 17, 2047, 2051]
    return [
        # B=32 at the Llama-3-8B heads, page boundaries, random contexts
        ((H, KVH), fixed + [int(x) for x in rng.integers(
            1, 2048, size=32 - len(fixed))], 128, BS),
        # qpk 8 (64/8 heads) and qpk 1 (32/32)
        ((64, 8), edges + [1000, 2047, 2051], 128, BS),
        ((32, 32), edges + [1000, 2047, 2051], 128, BS),
        # blocks of 12 tokens: the kernel divides by multiply and shift
        ((H, KVH), edges + [11, 12, 1535, 1539], 128, 12),
        # qpk 7 (Qwen2-7B): a warp's softmax heads past the group
        (HEADS_QWEN, edges + [15, 16, 1000, 2047, 2051], 128, BS),
    ]


# llama-1b's heads: head_dim 64, 32 query heads over 8 kv heads (qpk 4), and
# a qpk-8 geometry at the same head_dim (16 over 2).
D64 = 64
HEADS_1B = (32, 8)


def decode_cases_d64(rng, chunks):
    """decode_cases at head_dim 64: the same positions (chunk boundaries,
    an inactive lane, one cached row, the table's last row and a lane past
    it), llama-1b's heads and 16/2, and blocks of 12."""
    edges = sorted({0, 1} | {p for c in chunks
                             for p in (c - 1, c, c + 1, 2 * c)})
    fixed = edges + [15, 16, 17, 2047, 2051]
    return [
        (HEADS_1B, fixed + [int(x) for x in rng.integers(
            1, 2048, size=32 - len(fixed))], 128, BS),
        ((16, 2), edges + [1000, 2047, 2051], 128, BS),
        (HEADS_1B, edges + [11, 12, 1535, 1539], 128, 12),
        ((14, 2), edges + [1000, 2047, 2051], 128, BS),
    ]


def decode_b3_cases(rng, heads=((H, KVH), (64, 8), (32, 32))):
    """Split paged attention at QS=1, through the decode wrapper: (heads,
    positions, tokens per block).  Positions (the new token's, length - 1)
    on both sides of the 256-key chunk boundaries, one key (0), and lane
    1, which phase 1 empties (length 0)."""
    edges = [0, 5, 1, 15, 16, 17, 255, 256, 257, 511, 512, 513, 2047]
    main = heads[0]
    return [
        (main, edges + [int(x) for x in rng.integers(
            1, 2048, size=32 - len(edges))], BS),
        # the other query heads per kv head (qpk 8 and 1 at head_dim 128)
        *((h, edges, BS) for h in heads[1:]),
        # blocks of 12 tokens: the kernel divides by multiply and shift
        (main, edges + [11, 12, 1535], 12),
    ]


# Split paged attention through the verify wrapper: (heads, QS, starts,
# qlens, tokens per block).  Horizons on both sides of the 256-key chunk
# boundaries (a lane's last token at 255, 256, 257, 511, 512; its first at
# 255, 256, 257, 511, 512), rows past qlens and an empty lane; the
# Llama-3-8B heads (qpk 4) and block 16 unless stated.
PAGED_CASES = [
    ((H, KVH), 8, [248, 249, 250, 255, 256, 257, 504, 505, 511, 512, 0, 3,
                   1000, 2040, 766, 0],
     [8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 5, 3, 8, 8, 0], BS),
    ((H, KVH), 5, [0, 3, 15, 700, 2000, 1, 64, 0, 252, 253],
     [5, 5, 1, 4, 5, 2, 0, 3, 5, 4], BS),
    ((H, KVH), 1, [0, 255, 256, 1000, 0], [1, 1, 1, 1, 0], BS),
    # qpk 8 (64/8 heads) and qpk 1 (32/32)
    ((64, 8), 8, [0, 250, 255, 256, 1000, 0], [8, 8, 8, 8, 6, 0], BS),
    ((32, 32), 8, [0, 250, 255, 256, 1000, 0], [8, 8, 8, 8, 6, 0], BS),
    # blocks of 12 tokens
    ((H, KVH), 8, [0, 37, 250, 255, 300, 0], [8, 8, 8, 8, 3, 0], 12),
    # the other row counts of a group (QS * qpk) and so row tiles of the
    # tensor-core path: 16 (qpk 8), 12 (qpk 4) and 16 (qpk 2) in one tile,
    # 24 in two and 40 in four (qpk 8)
    ((64, 8), 2, [0, 255, 700], [2, 2, 1], BS),
    ((H, KVH), 3, [0, 254, 700], [3, 3, 2], BS),
    ((16, 8), 8, [0, 250, 700], [8, 8, 4], BS),
    ((64, 8), 3, [0, 254, 700], [3, 3, 2], BS),
    ((64, 8), 5, [0, 253, 700], [5, 5, 4], BS),
    # qpk 7 (Qwen2-7B) at every row-tile count: QS 2 (14 rows, one tile),
    # 4 (28, two), 5 and 8 (35 and 56, four), and QS 1 on the CUDA cores
    *((HEADS_QWEN, qs, [0, 256 - qs, 700, 2000, 0], [qs, qs, qs - 1, qs, 0],
       BS) for qs in (1, 2, 4, 5, 8)),
    (HEADS_QWEN, 5, [0, 37, 250, 300], [5, 5, 5, 3], 12),
]


# PAGED_CASES at head_dim 64: llama-1b's heads (qpk 4) at QS 1..8, the
# spec verify shape (QS 5: 20 rows, two row tiles) among them, and 16/2
# heads (qpk 8: 16, 24 and 40 rows, one, two and four row tiles).
PAGED_CASES_D64 = [
    (HEADS_1B, 8, [248, 249, 250, 255, 256, 257, 504, 505, 511, 512, 0, 3,
                   1000, 2040, 766, 0],
     [8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 5, 3, 8, 8, 0], BS),
    (HEADS_1B, 5, [0, 3, 15, 700, 2000, 1, 64, 0, 252, 253, 254, 255],
     [5, 5, 1, 4, 5, 2, 0, 3, 5, 4, 5, 5], BS),
    (HEADS_1B, 1, [0, 255, 256, 1000, 0], [1, 1, 1, 1, 0], BS),
    *((HEADS_1B, qs, [0, 256 - qs, 700, 0], [qs, qs, qs - 1, 0], BS)
      for qs in (2, 3, 4, 6, 7)),
    ((16, 2), 8, [0, 250, 255, 256, 1000, 0], [8, 8, 8, 8, 6, 0], BS),
    ((16, 2), 2, [0, 255, 700], [2, 2, 1], BS),
    ((16, 2), 3, [0, 254, 700], [3, 3, 2], BS),
    ((16, 2), 5, [0, 253, 700], [5, 5, 4], BS),
    (HEADS_1B, 5, [0, 37, 250, 255, 300, 0], [5, 5, 5, 5, 3, 0], 12),
    *(((14, 2), qs, [0, 256 - qs, 700, 0], [qs, qs, qs - 1, 0], BS)
      for qs in (1, 2, 4, 5, 8)),
]


def phase1(torch, np, st):
    from k8s_llm_monitor_tpu_torch.ops import paged_attention as pa

    rng = np.random.default_rng(1)
    gen = torch.Generator(device="cuda").manual_seed(1)
    errs, ulps = {}, {}
    for kvq in ("",) + QUANTS if wanted(st, "flash_prefill") else ():
        for nh, nkv, S, starts, lengths, bs in PREFILL_CASES:
            # The verify shape (S = spec_k + 1) is held under its own name:
            # the spec path's kernel record.
            name = ((f"flash_prefill_{kvq}" if kvq else "flash_prefill")
                    + ("_verify" if S <= pa.MAX_QUERY_TOKENS else "")
                    + qpk_suffix((nh, nkv), D))
            if kvq:
                case, scales = quant_prefill_case(
                    torch, rng, gen, len(starts), S, starts, lengths, kvq,
                    (nh, nkv), bs)
            else:
                case, scales = prefill_case(torch, rng, gen, len(starts), S,
                                            starts, lengths, (nh, nkv),
                                            bs), {}
            got = pa.flash_prefill_attention(*case, **scales)
            want = pa.flash_prefill_attention_plain(*case, **scales)
            torch.cuda.synchronize()
            for b, n in enumerate(lengths):
                if n == 0:
                    check(bool((got[b] == 0).all()),
                          f"{name} S={S}: empty lane {b} not zeroed")
                    continue
                check_rows(torch, f"{name}", got[b, :n], want[b, :n],
                           slice(None), errs, ulps)
            print(f"phase 1: {name} H={nh} KVH={nkv} bs={bs} S={S} "
                  f"starts={starts} lengths={lengths}: ok, max abs err "
                  f"{errs[name]:.4g}, max err {ulps[name]:.3g} ulps of the "
                  "row")
            del case, scales, got, want
        torch.cuda.empty_cache()

    # fused decode over bf16, int8 and fp8 pools, every case of
    # decode_cases: outputs of the lanes the table covers (bf16: an
    # inactive lane's output is exactly its v_new), pages, codes, scales.
    chunks = set(pa.DECODE_CHUNK.values())
    dcases = [(D, c) for c in decode_cases(rng, chunks)] + [
        (D64, c) for c in decode_cases_d64(rng, chunks)]
    for d, (heads, positions, nbl, bs) in dcases if wanted(
            st, "fused_decode") else ():
        nh, nkv = heads
        pos_t = torch.tensor(positions, device="cuda")
        covered = (pos_t > 0) & (pos_t < nbl * bs)
        for kvq in ("",) + QUANTS:
            name = ((f"fused_decode_{kvq}" if kvq else "fused_decode")
                    + ("_d64" if d == D64 else qpk_suffix(heads, d)))
            if kvq:
                case = quant_decode_case(torch, rng, gen, positions, nbl,
                                         kvq, heads, bs, d)
                kernel = pa.paged_decode_attention_fused_quant
                plain = pa.paged_decode_attention_fused_quant_plain
            else:
                case = decode_case(torch, rng, gen, positions, nbl, heads, bs,
                                   d)
                kernel = pa.paged_decode_attention_fused
                plain = pa.paged_decode_attention_fused_plain
            ck = [t.clone() for t in case]
            cp = [t.clone() for t in case]
            got = kernel(*ck)
            want = plain(*cp)
            torch.cuda.synchronize()
            check(got[1].data_ptr() == ck[5].data_ptr()
                  and (not kvq or got[3].data_ptr() == ck[7].data_ptr()),
                  f"{name}: pool not updated in place")
            # The quant plain version folds the current token alone for an
            # inactive lane, as the kernel does; the bf16 one reads the
            # lane's table, so there the kernel is held to v_new itself.
            check_rows(torch, name, got[0], want[0],
                       covered | (pos_t == 0) if kvq else covered, errs, ulps)
            if not kvq:
                idle = (pos_t == 0).nonzero().flatten().tolist()
                vnew = case[2].repeat_interleave(nh // nkv, dim=2)
                check(all(bool((got[0][b] == vnew[b]).all()) for b in idle),
                      f"{name}: an inactive lane's output is not v_new")
                for pname, a, b in (("k", got[1], want[1]),
                                    ("v", got[2], want[2])):
                    perr = float((a.float() - b.float()).abs().max())
                    errs[name] = max(errs[name], perr)
                    check(torch.allclose(a.float(), b.float(), **TOL),
                          f"{name}: {pname} pages differ, max abs err "
                          f"{perr:.4g}")
                extra = "outputs and pages"
            else:
                # The appended codes and scales, bit for bit: the plain
                # version divides by qmax on the card as the kernel does.
                ncodes = sum(int((got[i].view(torch.uint8)
                                  != want[i].view(torch.uint8)).sum())
                             for i in (1, 2))
                nscales = sum(int((got[i].view(torch.int32)
                                   != want[i].view(torch.int32)).sum())
                              for i in (3, 4))
                steps = max(code_steps(torch, got[i], want[i]) for i in (1, 2))
                check(ncodes == 0, f"{name}: {ncodes} codes differ, by up to "
                      f"{steps:.3g} steps")
                check(nscales == 0, f"{name}: {nscales} scales differ, by up "
                      "to " + str(max(float((got[i] - want[i]).abs().max())
                                      for i in (3, 4))))
                extra = (f"outputs; {ncodes} codes and {nscales} scales "
                         "differ")
            print(f"phase 1: {name} H={nh} KVH={nkv} D={d} bs={bs} table "
                  f"{nbl}x{bs} B={len(positions)} positions "
                  f"{positions[:12]}{'...' if len(positions) > 12 else ''}: "
                  f"ok, max abs err {errs[name]:.4g}, max err "
                  f"{ulps[name]:.3g} ulps of the row ({extra})")
            del case, ck, cp, got, want
        torch.cuda.empty_cache()

    # split paged attention: decode (QS=1, through the decode wrapper, with
    # an empty lane) and PAGED_CASES (through the verify wrapper): rows of
    # live tokens at 2 ulps, rows past qlens and empty lanes exactly zero.
    b3 = [(D, "", decode_b3_cases(rng, ((H, KVH), (64, 8), (32, 32),
                                        HEADS_QWEN)), PAGED_CASES),
          (D64, "_d64",
           decode_b3_cases(rng, (HEADS_1B, (16, 2), (14, 2))),
           PAGED_CASES_D64)]
    for d, sfx, dec_cases, ver_cases in b3 if wanted(
            st, "paged_attn") else ():
        for heads, positions, bs in dec_cases:
            name = "paged_attn" + (sfx or qpk_suffix(heads, d))
            nbl = 2048 // bs + 1
            q, _, _, _, _, kp, vp, table, pos = decode_case(
                torch, rng, gen, positions, nbl, heads, bs, d)
            lens = pos + 1
            lens[1] = 0                                  # an empty lane
            got = pa.paged_decode_attention_pallas(q, kp, vp, table, lens)
            want = pa.flash_prefill_attention_plain(
                q, kp, vp, table, (lens - 1).clamp(min=0), lens.clamp(max=1))
            torch.cuda.synchronize()
            check(bool((got[1] == 0).all()),
                  f"{name} QS=1: the empty lane is not zeroed")
            check_rows(torch, name, got, want, lens > 0, errs, ulps)
            print(f"phase 1: {name} QS=1 H={heads[0]} KVH={heads[1]} D={d} "
                  f"bs={bs} B={len(positions)} lengths "
                  f"{lens.tolist()[:12]}...: ok, max abs err "
                  f"{errs[name]:.4g}, max err "
                  f"{ulps[name]:.3g} ulps of the row")
        for (nh, nkv), QS, starts, qlens, bs in ver_cases:
            vcase = prefill_case(torch, rng, gen, len(starts), QS, starts,
                                 qlens, (nh, nkv), bs, d)
            got = pa.paged_verify_attention_pallas(*vcase)
            want = pa.flash_prefill_attention_plain(*vcase)
            torch.cuda.synchronize()
            # QS > 1 is held under its own name: the spec verify path's
            # record.
            rname = ("paged_attn" + ("_verify" if QS > 1 else "")
                     + (sfx or qpk_suffix((nh, nkv), d)))
            for b, n in enumerate(qlens):
                check(bool((got[b, n:] == 0).all()),
                      f"{rname} QS={QS}: rows past qlens of lane {b} not "
                      "zeroed")
                if n:
                    check_rows(torch, rname, got[b, :n], want[b, :n],
                               slice(None), errs, ulps)
            print(f"phase 1: {rname} QS={QS} H={nh} KVH={nkv} D={d} bs={bs} "
                  f"starts={starts} qlens={qlens}: ok, max abs err "
                  f"{errs[rname]:.4g}, max err "
                  f"{ulps[rname]:.3g} ulps of the row")
            del vcase, got, want
    print(f"phase 1: tolerance atol {TOL['atol']} rtol {TOL['rtol']} and "
          f"{ULP_TOL} bf16 ulps of each (row, head)'s largest value; "
          "appended codes and scales bit for bit")
    st["max_abs_err"] = errs


# Engines of phase 2: (label, EngineConfig overrides, expected prefill/decode
# paths, {record name: wrapper whose count it reads}).
ENGINES = (
    ("bf16", {}, ("flash", "fused"),
     {"flash_prefill": "flash_prefill_attention",
      "fused_decode": "paged_decode_attention_fused"}),
    ("int8", {"kv_dtype": "int8"}, ("flash", "fused"),
     {"flash_prefill_int8": "flash_prefill_attention",
      "fused_decode_int8": "paged_decode_attention_fused_quant"}),
    ("fp8", {"kv_dtype": "fp8"}, ("flash", "fused"),
     {"flash_prefill_fp8": "flash_prefill_attention",
      "fused_decode_fp8": "paged_decode_attention_fused_quant"}),
    ("pallas", {"decode_path": "pallas"}, ("flash", "pallas"),
     {"paged_attn": "paged_decode_attention_pallas"}),
)


def graph_pool_bytes(torch, eng) -> int:
    """Device bytes of the segments in ``eng``'s CUDA-graph memory pool."""
    pool = tuple(eng._graph_pool)
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == pool)


def graph_line(torch, eng) -> str:
    """The engine's decode-graph captures, their seconds and pool bytes."""
    return (f"{eng.graph_captures} decode graphs captured in "
            f"{eng.graph_capture_s:.2f} s, graph pool "
            f"{graph_pool_bytes(torch, eng)} B")


def run_engine(torch, st, model, prompts, name, overrides, paths, kernels,
               phase=2):
    """One engine of phase 2 (or ``phase``) at one decode setting: two
    identical runs with the launch counts set to 0 just before the first
    and read just after it.  Returns the engine, the first run's ids, its
    launch counts, its (engine steps, decode steps) and the second run's
    decode tok/s."""
    from k8s_llm_monitor_tpu_torch.ops import paged_attention as pa
    from k8s_llm_monitor_tpu_torch.utils.quantize import param_bytes
    from k8s_llm_monitor_tpu_torch.serving.engine import (
        EngineConfig, InferenceEngine, SamplingParams)
    from k8s_llm_monitor_tpu_torch.utils.tokenizer import ByteTokenizer

    cfg = model.cfg
    # The prefix cache off: the second and third runs of the same prompts
    # must give the first run's ids, and a hit computes its prefill as
    # another sum (phase 7 holds the hits).
    ecfg = EngineConfig(max_slots=32, num_blocks=4096, block_size=16,
                        max_blocks_per_seq=ENGINE_TABLE,
                        max_prefills_per_step=8, decode_steps_per_iter=8,
                        prefix_cache_entries=0, **overrides)
    eng = InferenceEngine(cfg, model, ecfg, tokenizer=ByteTokenizer())
    check((eng.prefill_path, eng.decode_path) == paths,
          f"{name} engine paths {eng.prefill_path}/{eng.decode_path}, "
          f"expected {'/'.join(paths)}")
    sp = SamplingParams(max_tokens=32)
    pa.reset_launch_counts()
    steps0, waits0 = eng.steps, eng.admission_waits
    t0 = time.monotonic()
    res = eng.generate(prompts, sp)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    waits = eng.admission_waits - waits0
    pre_s = eng.prefill_dispatch_s
    launches = {rec: getattr(pa, fn).launches for rec, fn in kernels.items()}
    steps = eng.steps - steps0
    for r in res:
        check(r.finish_reason in ("eos", "length"),
              f"{name} {r.request_id}: finish {r.finish_reason} {r.error}")
        check(len(r.token_ids) <= 32 and all(
            0 <= t < cfg.vocab_size for t in r.token_ids),
            f"{name} {r.request_id}: bad ids")
    check(all(n > 0 for n in launches.values()),
          f"{name}: a kernel never launched on the main path: {launches}")
    check(eng.dispatch_failures == 0 and eng.watchdog_trips == 0,
          f"{name}: {eng.dispatch_failures} dispatch failures, "
          f"{eng.watchdog_trips} watchdog trips")
    check(eng.pool_bytes == eng.pages.nbytes(),
          f"{name}: pool bytes {eng.pool_bytes} != {eng.pages.nbytes()}")
    first_run = (steps, eng.decode_steps)
    ttft = statistics.median(r.ttft_s for r in res)
    tok_s = eng.decode_tokens / eng.decode_s
    graphs = f"; {graph_line(torch, eng)}" if ecfg.decode_graphs else ""
    print(f"phase {phase}: {name}: {len(res)} requests done in {wall:.2f} s "
          f"over {steps} engine steps ({waits} waited on the device while "
          f"dispatching, share {waits / steps:.3f}; prefill rounds by "
          f"bucket {eng.prefill_bucket_rounds}, {pre_s * 1e3:.1f} ms of host "
          f"time dispatching them); launches "
          f"{launches}{graphs}")
    print(f"phase {phase}: {name}: first (cold) run: ttft p50 "
          f"{ttft * 1e3:.1f} ms, decode {tok_s:.1f} tok/s "
          f"({eng.decode_tokens} tokens in {eng.decode_s:.2f} s, "
          f"{eng.decode_steps} decode steps), weights "
          f"{param_bytes(model)} B, pool {eng.pool_bytes} B "
          f"[{st['gpu']}]")
    tokens0, secs0 = eng.decode_tokens, eng.decode_s
    res2 = eng.generate(prompts, sp)
    check([r.token_ids for r in res] == [r.token_ids for r in res2],
          f"{name}: second identical run gave different ids")
    ttft2 = statistics.median(r.ttft_s for r in res2)
    tok_s2 = (eng.decode_tokens - tokens0) / (eng.decode_s - secs0)
    print(f"phase {phase}: {name}: second (warm) run identical: ttft p50 "
          f"{ttft2 * 1e3:.1f} ms, decode {tok_s2:.1f} tok/s, pool "
          f"{eng.pool_bytes} B [{st['gpu']}]")
    st.setdefault("runs", {})[name] = dict(
        ttft=ttft, ttft_warm=ttft2, tok_s=tok_s2, pool=eng.pool_bytes)
    return eng, [r.token_ids for r in res], launches, first_run, tok_s2


def prompt_lengths(rng):
    """Phase 2's 16 prompt lengths (the first draws of ``rng``): 15 of
    20..1500 tokens, sorted, and one of 2300."""
    lens = sorted(int(x) for x in rng.integers(20, 1501, size=15)) + [2300]
    lens[0], lens[-2] = 20, 1500
    return lens


# Decode settings phase 2 compares on one engine: the eager loop that
# reads each admission round back as it runs and reconciles each decode
# call in the step that dispatched it (the loop before the decode graphs
# and in-flight admission), the eager loop with dispatch-ahead, and the
# defaults (CUDA graphs, every call kind in flight, max_inflight 2).
SETTINGS = {"eager": {"decode_graphs": False, "max_inflight": 0,
                      "admit_inflight": False},
            "eager+ahead": {"decode_graphs": False},
            "graph": {}}
# The settings each engine runs, the defaults last: that run's launch
# counts are the main path's.
RUNS = {"bf16": ("eager", "eager+ahead", "graph"), "int8": ("eager", "graph"),
        "fp8": ("graph",), "pallas": ("eager", "graph")}


def phase2(torch, np, st):
    from k8s_llm_monitor_tpu_torch.models import llama
    from k8s_llm_monitor_tpu_torch.models.config import LLAMA3_8B
    from k8s_llm_monitor_tpu_torch.serving.engine import SamplingParams

    cfg = LLAMA3_8B
    t0 = time.monotonic()
    model = llama.LlamaModel(cfg, seed=0)
    torch.cuda.synchronize()
    print(f"phase 2: {cfg.name} ({cfg.num_layers} layers, hidden "
          f"{cfg.hidden_size}) random bf16 weights in "
          f"{time.monotonic() - t0:.1f} s")
    rng = np.random.default_rng(2)
    lens = prompt_lengths(rng)
    prompts = [[int(t) for t in rng.integers(3, cfg.vocab_size, size=n)]
               for n in lens]
    print(f"phase 2: prompt lengths {lens}")
    st.update(launches={}, engine_steps={})
    for label, overrides, paths, kernels in ENGINES:
        ref = None
        for setting in RUNS[label]:
            name = f"{label} {setting}"
            eng, ids, launches, steps, _ = run_engine(
                torch, st, model, prompts, name,
                dict(overrides, **SETTINGS[setting]), paths, kernels)
            if ref is None:
                ref = (setting, ids, launches)
            else:
                check(ids == ref[1], f"{name}: greedy ids differ from the "
                                     f"{ref[0]} run's")
                check(launches == ref[2], f"{name}: launches {launches}, the "
                                          f"{ref[0]} run's {ref[2]}")
            if label == "bf16" and setting == "graph":
                text = eng.generate_text(
                    "why is pod web-1 in CrashLoopBackOff?",
                    SamplingParams(max_tokens=8))
                check(isinstance(text, str), "generate_text returned no text")
                print(f"phase 2: generate_text ok ({len(text)} chars)")
            if label in TRACED:
                trace_decode(torch, eng, prompts,
                             SamplingParams(max_tokens=32), ids, st, name,
                             TRACED[label])
            del eng
            torch.cuda.empty_cache()
        if len(RUNS[label]) > 1:
            print(f"phase 2: {label}: greedy ids and launches equal across "
                  f"{', '.join(RUNS[label])}")
        st["launches"].update(launches)
        st["engine_steps"][label] = steps
    st.update(model=model, prompt_lens=lens)


# Engines whose decode steps phase 2 traces, and the attention kernels it
# reports (by name: each must show device time in the window).
FUSED_KERNELS = ("fused_decode_split_kernel", "fused_decode_merge_kernel")
TRACED = {"bf16": FUSED_KERNELS, "int8": FUSED_KERNELS,
          "pallas": ("paged_attn_split_kernel", "paged_attn_merge_kernel")}


def trace_decode(torch, eng, prompts, sp, want_ids, st, name, kernels,
                 phase=2):
    """Run the prompts once more; once every prompt is prefilled, trace the
    remaining engine steps (decode only) with torch.profiler and split the
    window's wall time into device time per kernel and device idle time.
    The profiler sees the kernels a CUDA graph replays as it sees the
    others; each of ``kernels`` (attention, by name) must show time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from k8s_llm_monitor_tpu_torch.serving.engine import GenerationRequest

    ids = [f"trace-{i}" for i in range(len(prompts))]
    for rid, p in zip(ids, prompts):
        eng.submit(GenerationRequest(rid, list(p), sp))
    # The engine keeps no public prefill flag: read its queue and slots.
    while eng._pending or any(s is not None and s.prefilling
                              for s in eng._slots):
        eng.step()
    torch.cuda.synchronize()
    steps0, tokens0 = eng.decode_steps, eng.decode_tokens
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        while eng.has_work:
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    got = [eng._results.pop(rid).token_ids for rid in ids]
    check(got == want_ids, f"{name}: traced run gave different ids")
    per: dict[str, float] = {}
    per_n: dict[str, int] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per[e.name] = per.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
            per_n[e.name] = per_n.get(e.name, 0) + 1
    steps = eng.decode_steps - steps0
    busy = sum(per.values())
    n_kernels = sum(per_n.values())
    check(steps > 0, f"{name}: no decode step in the traced window")
    check(busy > 0, f"{name}: the profiler saw no device time in the decode "
                    "window")
    kms = {}
    for kernel in kernels:
        kms[kernel] = sum(v for k, v in per.items() if kernel in k)
        check(kms[kernel] > 0, f"{name}: no device time for {kernel} in "
              "the traced decode window")
    attn = sum(kms.values())
    print(f"phase {phase}: {name}: traced decode window: {steps} decode "
          f"steps, "
          f"{eng.decode_tokens - tokens0} tokens, wall {wall_ms:.2f} ms "
          f"({wall_ms / steps:.3f} ms/step); device busy {busy:.2f} ms "
          f"({busy / steps:.3f} ms/step), idle share "
          f"{1 - busy / wall_ms:.3f}; attention "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in kms.items())
          + f" = {attn / wall_ms:.3f} of wall, {attn / steps:.3f} ms/step; "
          f"{n_kernels} device kernels ({n_kernels / steps:.1f} per step) "
          f"[{st['gpu']}]")
    for kname, ms in sorted(per.items(), key=lambda kv: -kv[1])[:8]:
        print(f"phase {phase}: {name}: trace: {ms:9.3f} ms "
              f"{ms / wall_ms:6.3f} of wall  {kname[:90]}")


def argmax_agreement(got, want, tol):
    """(share of rows whose argmax agrees, near-ties, rows) over the logit
    tensors ``got`` and ``want``.  A row whose ``want`` top two logits lie
    within ``tol`` is a near-tie of that path itself, which another
    summation order may flip: it counts as agreeing."""
    n_rows = n_agree = n_ties = 0
    for a, b in zip(got, want):
        top2 = b.float().topk(2, dim=-1).values
        tie = (top2[:, 0] - top2[:, 1]) <= tol
        n_agree += int(((a.argmax(-1) == b.argmax(-1)) | tie).sum())
        n_ties += int(tie.sum())
        n_rows += tie.numel()
    return n_agree / n_rows, n_ties, n_rows


def marked(fn, **markers):
    """``fn`` as an attention impl carrying the wrapper markers that
    models/llama.py dispatches on (to run a plain version on the card)."""
    def impl(*args, **kwargs):
        return fn(*args, **kwargs)

    impl.__dict__.update(markers)
    return impl


def paths_logits(torch, np, model, pairs, tag):
    """On ``model`` (cut to a few layers): for each (label, kv_quant,
    kernel (prefill, decode) impls, plain impls) of ``pairs``, the
    first-token and 4 decode-step logits of 4 prompts (100..1024 tokens)
    on the kernel path against the plain path, held to the logit tolerance
    and the argmax agreement with the plain path's near-ties counted.
    Returns the generator it drew the prompts from."""
    from k8s_llm_monitor_tpu_torch.models import llama

    dev = torch.device("cuda")
    cfg = model.cfg
    rng = np.random.default_rng(3)
    lens = [100, 517, 1024, 33]
    B, S = len(lens), 1024
    toks = np.zeros((B, S), np.int32)
    for b, n in enumerate(lens):
        toks[b, :n] = rng.integers(3, cfg.vocab_size, size=n)
    nbl = 1024 // BS + 4
    tables = torch.arange(1, B * nbl + 1, dtype=torch.int32,
                          device=dev).reshape(B, nbl)
    tok_t = torch.from_numpy(toks).to(dev)
    len_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    feed = torch.from_numpy(rng.integers(3, cfg.vocab_size, size=(4, B))
                            .astype(np.int32)).to(dev)

    def run(kv_quant, pimpl, dimpl):
        pages = llama.init_kv_pages(cfg, B * nbl + 1, BS, dev,
                                    kv_quant=kv_quant)
        logits, _ = llama.prefill(model, tok_t, len_t, pages, tables,
                                  attn_impl=pimpl)
        steps = [logits]
        ctx = len_t.clone()
        for nxt in feed:           # the same tokens on every path
            lg, _ = llama.decode_step(model, nxt, ctx, pages, tables,
                                      attn_impl=dimpl)
            steps.append(lg)
            ctx = ctx + 1
        torch.cuda.synchronize()
        return steps

    for label, kv_quant, kernel, plain in pairs:
        got, want = run(kv_quant, *kernel), run(kv_quant, *plain)
        errs = [float((a - b).abs().max()) for a, b in zip(got, want)]
        tol = QUANT_LOGIT_ATOL if kv_quant else LOGIT_ATOL
        agree, n_ties, n_rows = argmax_agreement(got, want, tol)
        print(f"{tag}, {label}: logit max abs err "
              f"prefill {errs[0]:.4g}, decode steps "
              f"{[round(e, 4) for e in errs[1:]]} (tolerance {tol}); "
              f"argmax agreement {agree:.3f} (at least {MIN_ARGMAX_AGREE}; "
              f"{n_ties} of {n_rows} rows are plain-path near-ties within "
              f"{tol}, counted as agreeing)")
        # A row whose argmax moves: how far apart the plain path's two
        # candidates were (a near-tie is within the logit tolerance).
        for step, (a, b) in enumerate(zip(got, want)):
            ia, ib = a.argmax(-1), b.argmax(-1)
            for r in (ia != ib).nonzero().flatten().tolist():
                gap = float(b[r, ib[r]] - b[r, ia[r]])
                print(f"{tag}, {label}: step {step} row {r}: argmax "
                      f"{int(ia[r])} vs {int(ib[r])}, plain-path logits "
                      f"{gap:.4g} apart")
        check(max(errs) <= tol, f"{label}: logits differ by {max(errs):.4g}")
        check(agree >= MIN_ARGMAX_AGREE,
              f"{label}: argmax agreement {agree:.3f}")
    return rng


def phase3(torch, np, st):
    from k8s_llm_monitor_tpu_torch.diagnosis.grammar import (
        parse_verdict, verdict_fsm)
    from k8s_llm_monitor_tpu_torch.models import llama
    from k8s_llm_monitor_tpu_torch.models.config import ModelConfig
    from k8s_llm_monitor_tpu_torch.ops import paged_attention as pa
    from k8s_llm_monitor_tpu_torch.ops.attention import paged_decode_attention
    from k8s_llm_monitor_tpu_torch.serving.engine import (
        EngineConfig, InferenceEngine, SamplingParams)
    from k8s_llm_monitor_tpu_torch.utils.tokenizer import ByteTokenizer

    model = truncated(st["model"], 4)
    flash_plain = marked(pa.flash_prefill_attention_plain, flash_prefill=True)
    quant_plain = marked(pa.paged_decode_attention_fused_quant_plain,
                         fused_decode=True, quant_kv=True)
    pairs = [
        ("flash/fused vs dense/gather", "",
         (pa.flash_prefill_attention, pa.paged_decode_attention_fused),
         (None, paged_decode_attention)),
        ("flash/pallas vs dense/gather", "",
         (pa.flash_prefill_attention, pa.paged_decode_attention_pallas),
         (None, paged_decode_attention)),
    ] + [(f"{q} flash/fused kernels vs their plain versions", q,
          (pa.flash_prefill_attention, pa.paged_decode_attention_fused_quant),
          (flash_plain, quant_plain)) for q in QUANTS]
    rng = paths_logits(torch, np, model, pairs, "phase 3: 4-layer Llama-3-8B")
    dev = torch.device("cuda")

    # Small float32 model: the engine on the card against the CPU.  The
    # kernels take bf16, so auto selects the plain path for float32 here.
    small = ModelConfig(name="small", vocab_size=512, hidden_size=256,
                        intermediate_size=512, num_layers=2, num_heads=4,
                        num_kv_heads=2, dtype="float32", rope_theta=10_000.0)
    ec = EngineConfig(max_slots=4, num_blocks=128, block_size=16,
                      max_blocks_per_seq=16, prefill_buckets=(32, 64),
                      max_prefills_per_step=4)
    m_gpu = llama.LlamaModel(small, device=dev, seed=5)
    m_cpu = llama.LlamaModel(small, device="cpu", seed=None)
    m_cpu.load_state_dict({k: v.cpu() for k, v in m_gpu.state_dict().items()})
    prompts = [[int(t) for t in rng.integers(3, 512, size=n)]
               for n in (5, 40, 100, 300)]        # 100: chunked, 300: cut
    ids, verdicts = {}, {}
    # Constrained: a table of 64 blocks holds prompt + the longest verdict.
    ec_v = dataclasses.replace(ec, max_blocks_per_seq=64)
    for name, m, d in (("gpu", m_gpu, dev), ("cpu", m_cpu, "cpu")):
        eng = InferenceEngine(small, m, ec, eos_id=-1, device=d)
        ids[name] = [r.token_ids for r in eng.generate(
            prompts, SamplingParams(max_tokens=12))]
        if name == "gpu":
            paths = f"{eng.prefill_path}/{eng.decode_path}"
        eng = InferenceEngine(small, m, ec_v, tokenizer=ByteTokenizer(),
                              device=d)
        eng.set_grammar(verdict_fsm(eos_id=ByteTokenizer.EOS))
        verdicts[name] = [(r.token_ids, r.finish_reason) for r in eng.generate(
            prompts[:3], SamplingParams(max_tokens=1, constrained=True))]
    check(ids["gpu"] == ids["cpu"], "float32 greedy ids differ card vs CPU")
    check(verdicts["gpu"] == verdicts["cpu"],
          "float32 constrained greedy ids differ card vs CPU")
    for toks, reason in verdicts["gpu"]:
        check(reason == "eos", f"constrained verdict ended {reason}")
        parse_verdict(ByteTokenizer().decode(toks))
    print(f"phase 3: float32 small model ({paths} on the card): greedy ids "
          "equal on the card and the CPU, free and constrained (3 verdicts "
          f"of {[len(t) for t, _ in verdicts['gpu']]} tokens, all parse)")


# Evidence lines of phase 5's questions (a seeded draw per line).
EVIDENCE = (
    '- pod "{ns}/{pod}" CrashLoopBackOff, restarts={n}, last exit code 137',
    '- event Warning BackOff {ns}/{pod}: back-off restarting failed container',
    '- node "node-{n}" condition MemoryPressure=True for {n}m',
    '- pod "{ns}/{pod}" OOMKilled, memory limit 512Mi, usage peak {n}Mi',
    '- service "{ns}/{pod}" has 0 ready endpoints of {n}',
    '- log {ns}/{pod}: dial tcp 10.0.{n}.7:5432: connect: connection refused',
)


def evidence_question(rng, n_bytes: int) -> str:
    """A diagnosis prompt of about ``n_bytes`` bytes: evidence lines drawn
    from ``rng``, then the question."""
    pods = ("web-1", "api-0", "db-2", "cache-3", "worker-4")
    nss = ("default", "kube-system", "payments")
    pod, ns = pods[rng.integers(len(pods))], nss[rng.integers(len(nss))]
    question = f"## Question\nwhy is pod {ns}/{pod} failing?\n"
    lines = ["## Evidence"]
    while sum(len(x) + 1 for x in lines) + len(question) < n_bytes:
        lines.append(EVIDENCE[rng.integers(len(EVIDENCE))].format(
            ns=nss[rng.integers(len(nss))], pod=pods[rng.integers(len(pods))],
            n=int(rng.integers(1, 999))))
    text = "\n".join(lines) + "\n" + question
    return text[len(text) - n_bytes:] if len(text) > n_bytes else text


def burst(backend, questions, frees, stream_q):
    """Fire every call of the burst from its own thread at once; returns
    (per-request results seen by the service, outputs by call, exceptions,
    burst wall seconds)."""
    import threading

    results, outs, errors = [], {}, []
    backend.service.observer = (
        lambda rid, toks, res: res is not None and results.append(res))
    calls = [(f"verdict-{i}", backend.generate_constrained, (q,), {})
             for i, q in enumerate(questions)]
    calls += [(f"free-{i}", backend.generate, (q,),
               dict(max_tokens=64, temperature=0.7, top_k=40))
              for i, q in enumerate(frees)]
    calls.append(("stream", lambda q, **kw: list(
        backend.generate_stream(q, **kw)), (stream_q,),
        dict(max_tokens=64, temperature=0.0)))
    go = threading.Event()

    def run(name, fn, args, kw):
        go.wait()
        try:
            outs[name] = fn(*args, **kw)
        except Exception as exc:            # reported by the caller
            errors.append(f"{name}: {type(exc).__name__}: {exc}")

    threads = [threading.Thread(target=run, args=c) for c in calls]
    for t in threads:
        t.start()
    t0 = time.monotonic()
    go.set()
    for t in threads:
        t.join(timeout=600)
    wall = time.monotonic() - t0
    backend.service.observer = None
    check(not any(t.is_alive() for t in threads), "a burst call hung")
    return results, outs, errors, wall


def phase5(torch, np, st):
    from k8s_llm_monitor_tpu_torch.diagnosis.grammar import (
        parse_verdict, verdict_fsm)
    from k8s_llm_monitor_tpu_torch.models import llama
    from k8s_llm_monitor_tpu_torch.models.config import LLAMA3_8B
    from k8s_llm_monitor_tpu_torch.monitor.analysis import LocalEngineBackend
    from k8s_llm_monitor_tpu_torch.ops import paged_attention as pa
    from k8s_llm_monitor_tpu_torch.ops import sampling
    from k8s_llm_monitor_tpu_torch.serving.engine import (
        EngineConfig, InferenceEngine, SamplingParams)
    from k8s_llm_monitor_tpu_torch.utils.tokenizer import ByteTokenizer

    gpu = st["gpu"]
    model = st.get("model") or llama.LlamaModel(LLAMA3_8B, seed=0)
    cfg, tok = model.cfg, ByteTokenizer()
    # 256 blocks of 16 per sequence: a 1500-byte question and the longest
    # verdict (469 tokens) fit, so no verdict is cut.  The prefix cache is
    # off: the lone question runs twice and its ids are compared, and a
    # hit computes its prefill as another sum (phase 7 holds the hits).
    ecfg = EngineConfig(max_slots=32, num_blocks=4096, block_size=16,
                        max_blocks_per_seq=ENGINE_TABLE,
                        max_prefills_per_step=8, decode_steps_per_iter=8,
                        prefix_cache_entries=0)
    eng = InferenceEngine(cfg, model, ecfg, tokenizer=tok)
    check((eng.prefill_path, eng.decode_path, eng.kv_quant)
          == ("flash", "fused", ""),
          f"engine paths {eng.prefill_path}/{eng.decode_path} "
          f"pool {eng.kv_quant or 'bf16'}")
    fsm = verdict_fsm(eos_id=tok.eos_id)
    eng.set_grammar(fsm)
    rng = np.random.default_rng(5)
    sizes = sorted(int(x) for x in rng.integers(200, 1501, size=16))
    sizes[0], sizes[-1] = 200, 1500
    questions = [evidence_question(rng, n) for n in sizes]
    frees = [evidence_question(rng, int(n))
             for n in rng.integers(200, 1501, size=8)]
    stream_q = evidence_question(rng, 600)
    print(f"phase 5: {cfg.name}, bf16 pool, verdict grammar {fsm.trans.shape} "
          f"max_len {fsm.max_len}; 16 questions of {sizes} bytes, 8 sampled "
          f"generate calls, 1 stream")

    # The lone question through engine.generate, before the service owns
    # the engine (one thread touches it at a time).
    constrained = SamplingParams(max_tokens=1, constrained=True)
    lone_ids = tok.encode(questions[0])
    [ref] = eng.generate([lone_ids], constrained)
    check(ref.finish_reason == "eos", f"lone verdict ended {ref.finish_reason}")
    parse_verdict(tok.decode(ref.token_ids))

    backend = LocalEngineBackend(engine=eng, tokenizer=tok)
    try:
        steps0 = (eng.decode_steps, eng.bounded_decode_steps)
        tokens0, secs0 = eng.decode_tokens, eng.decode_s
        pa.reset_launch_counts()
        results, outs, errors, wall = burst(backend, questions, frees,
                                            stream_q)
        torch.cuda.synchronize()
        launches = {"flash_prefill": pa.flash_prefill_attention.launches,
                    "fused_decode": pa.paged_decode_attention_fused.launches}
        check(not errors, f"burst calls failed: {errors}")
        check(len(results) == 25, f"{len(results)} results of 25")
        check(eng.dispatch_failures == 0 and eng.watchdog_trips == 0,
              f"{eng.dispatch_failures} dispatch failures, "
              f"{eng.watchdog_trips} watchdog trips in the burst")
        bad = [r.request_id for r in results if r.finish_reason == "error"]
        check(not bad, f"error results: {bad}")
        for i in range(16):
            parse_verdict(outs[f"verdict-{i}"])
        check(all(n > 0 for n in launches.values()),
              f"a kernel never launched on the burst's path: {launches}")
        bounded = eng.bounded_decode_steps - steps0[1]
        check(bounded > 0, "no decode step took the bounded sampler")
        ttfts = sorted(r.ttft_s for r in results)
        tok_s = (eng.decode_tokens - tokens0) / (eng.decode_s - secs0)
        lens = [len(outs[f"verdict-{i}"]) for i in range(16)]
        print(f"phase 5: burst of 25 through LocalEngineBackend -> "
              f"EngineService: {wall:.2f} s wall, {eng.decode_steps - steps0[0]}"
              f" decode steps ({bounded} bounded-sampled); ttft p50 "
              f"{np.percentile(ttfts, 50) * 1e3:.1f} ms, p99 "
              f"{np.percentile(ttfts, 99) * 1e3:.1f} ms; decode {tok_s:.1f} "
              f"tok/s; constrained_decode_overhead_ms "
              f"{backend.constrained_decode_overhead_ms:.3f}; launches "
              f"{launches}; steps that waited on the device while "
              f"dispatching {eng.admission_waits} of {eng.steps}; "
              f"{eng.prefill_dispatch_s * 1e3:.1f} ms of host time "
              f"dispatching prefill rounds [{gpu}]")
        print(f"phase 5: 16 verdicts parse ({min(lens)}..{max(lens)} chars); "
              f"8 sampled and 1 streamed answer, no error; "
              f"{graph_line(torch, eng)} [{gpu}]")
        via = backend.service.submit(lone_ids, constrained).result(timeout=300)
        check(via.token_ids == ref.token_ids and
              via.finish_reason == ref.finish_reason,
              "the lone question's ids differ through the service")
        print(f"phase 5: lone verdict ({len(ref.token_ids)} tokens): the same "
              f"ids through the service as through engine.generate [{gpu}]")
        # The same burst again, once the decode graphs it uses exist: a
        # first token is read back when its admission call is reconciled,
        # so in the cold burst it waits behind the captures.
        results, outs, errors, wall = burst(backend, questions, frees,
                                            stream_q)
        check(not errors and len(results) == 25 and not any(
            r.finish_reason == "error" for r in results),
              f"the warm burst: {errors or [r.error for r in results]}")
        ttfts = sorted(r.ttft_s for r in results)
        print(f"phase 5: the same burst again (warm): {wall:.2f} s wall; "
              f"ttft p50 {np.percentile(ttfts, 50) * 1e3:.1f} ms, p99 "
              f"{np.percentile(ttfts, 99) * 1e3:.1f} ms; "
              f"{graph_line(torch, eng)} [{gpu}]")
    finally:
        backend.service.stop()
    eng.token_sink = None

    # The sampled decode step with the bounded sampler (cap 64) against the
    # full-vocabulary sort (cap 0), in turns on the same engine, after one
    # untimed run at each cap that captures their decode graphs.
    prompts = [[int(t) for t in rng.integers(3, cfg.vocab_size, size=100)]
               for _ in range(32)]
    sp = SamplingParams(max_tokens=64, temperature=0.7, top_k=40)
    per_step = {64: [], 0: [], "cold": []}
    for cap in (64, 0, 64, 0, 0, 64):
        eng.ecfg.sample_topk_cap = cap
        s0, d0, b0 = eng.decode_s, eng.decode_steps, eng.bounded_decode_steps
        res = eng.generate(prompts, sp)
        check(all(r.finish_reason in ("eos", "length") for r in res),
              f"sampled run at cap {cap}: {[r.error for r in res]}")
        check((eng.bounded_decode_steps > b0) == (cap > 0), "sampler choice")
        per_step[cap if len(per_step["cold"]) == 2 else "cold"].append(
            (eng.decode_s - s0) / (eng.decode_steps - d0))
    eng.ecfg.sample_topk_cap = 64
    gen = torch.Generator(device="cuda").manual_seed(0)
    logits = torch.randn(32, cfg.vocab_size, generator=gen, device="cuda",
                         dtype=torch.bfloat16)
    kw = dict(temperature=torch.full((32,), 0.7, device="cuda"),
              top_k=torch.full((32,), 40, dtype=torch.int32, device="cuda"),
              top_p=torch.ones(32, device="cuda"))
    samplers = {
        "full sort": lambda: sampling.sample_tokens(gen, logits, **kw),
        "bounded top-64": lambda: sampling.sample_tokens_bounded(
            gen, logits, k_cap=64, **kw)}
    alone = {name: (time_ms(torch, fn), device_ms(torch, fn))
             for name, fn in samplers.items()}
    print(f"phase 5: sampled decode step (32 lanes, top_k 40), wall per step "
          f"with the captures, cap 64 / cap 0: "
          + " / ".join(f"{t * 1e3:.3f}" for t in per_step["cold"])
          + " ms; then cap 64 / cap 0 / cap 0 / cap 64: "
          + " / ".join(f"{t * 1e3:.3f}" for t in (
              per_step[64][0], per_step[0][0], per_step[0][1],
              per_step[64][1]))
          + f" ms; the samplers alone on [32, {cfg.vocab_size}] bf16 logits "
          "(per call, CUDA events / device time in the profiler): "
          + ", ".join(f"{name} {ev:.4f} / {dev:.4f} ms"
                      for name, (ev, dev) in alone.items())
          + f" [{gpu}]")
    del eng
    torch.cuda.empty_cache()


QUERIES = (
    "why is the web frontend pod restarting?",
    "which nodes are under memory pressure?",
    "is the api backend reachable from the web frontend?",
    "what should I fix first in this cluster?",
)
SHUTDOWN_GRACE_S = 60.0          # phase 6: supervisor.shutdown(grace_s)


def http_call(port, method, path, body=None, timeout=600.0):
    """One HTTP request to the server under test: (status, JSON body or
    raw bytes, wall seconds)."""
    import http.client

    t0 = time.monotonic()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        data = json.dumps(body).encode() if body is not None else None
        conn.request(method, path, body=data, headers=(
            {"Content-Type": "application/json"} if data else {}))
        resp = conn.getresponse()
        raw = resp.read()
        ctype = resp.getheader("Content-Type") or ""
    finally:
        conn.close()
    out = json.loads(raw) if ctype.startswith("application/json") else raw
    return resp.status, out, time.monotonic() - t0


def http_stream(port, question, timeout=600.0):
    """POST /api/v1/query with ``stream``: (status, events, seconds to the
    first event, wall seconds)."""
    import http.client

    t0 = time.monotonic()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", "/api/v1/query", body=json.dumps(
            {"question": question, "stream": True}).encode(),
            headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        first, buf = None, b""
        while True:
            chunk = resp.read1(65536)
            if not chunk:
                break
            if first is None and b"data:" in buf + chunk:
                first = time.monotonic() - t0
            buf += chunk
    finally:
        conn.close()
    events = [json.loads(line[len("data: "):])
              for line in buf.decode().split("\n") if line.startswith("data: ")]
    return resp.status, events, first, time.monotonic() - t0


def check_verdict(v, what):
    """``v`` (a verdict as the API returns it, parsed by parse_verdict)
    satisfies VERDICT_SCHEMA: its keys, the severity enum, the string
    lengths and a numeric confidence."""
    from k8s_llm_monitor_tpu_torch.diagnosis.grammar import VERDICT_SCHEMA

    props = VERDICT_SCHEMA["properties"]
    ok = isinstance(v, dict) and set(v) == set(VERDICT_SCHEMA["required"])
    ok = ok and v["severity"] in props["severity"]["enum"]
    for key in ("component", "root_cause", "recommendation"):
        ok = ok and isinstance(v[key], str) and (
            props[key]["minLength"] <= len(v[key]) <= props[key]["maxLength"])
    ok = ok and isinstance(v["confidence"], (int, float))
    check(ok, f"{what}: not a verdict of the grammar's schema: {v!r}")


def front_door_burst(port):
    """24 threads at once: 16 queries, 4 root-cause analyses, 1 streamed
    query, 3 stats reads.  Returns {name: (status, body, wall)} and the
    stream's (status, events, first-event seconds, wall)."""
    import threading

    calls = [(f"query-{i}", "POST", "/api/v1/query",
              {"question": QUERIES[i % len(QUERIES)] + f" (case {i})"})
             for i in range(16)]
    calls += [(f"analyze-{i}", "POST", "/api/v1/analyze",
               {"type": "root_cause", "parameters": {
                   "namespace": "default",
                   "pod": ("web-frontend-7d4b9c6f5-x2x1p",
                           "api-backend-6f5d8b7c9-k3k2m", "", "")[i],
                   "symptom": "restarts and timeouts"}})
              for i in range(4)]
    calls += [(f"stats-{i}", "GET", "/api/v1/stats", None) for i in range(3)]
    out, errors, stream = {}, [], {}
    go = threading.Event()

    def run(name, method, path, body):
        go.wait()
        try:
            out[name] = http_call(port, method, path, body)
        except Exception as exc:            # reported by the caller
            errors.append(f"{name}: {type(exc).__name__}: {exc}")

    def run_stream():
        go.wait()
        try:
            stream["s"] = http_stream(port, QUERIES[0] + " (streamed)")
        except Exception as exc:
            errors.append(f"stream: {type(exc).__name__}: {exc}")

    threads = [threading.Thread(target=run, args=c) for c in calls]
    threads.append(threading.Thread(target=run_stream))
    for t in threads:
        t.start()
    t0 = time.monotonic()
    go.set()
    for t in threads:
        t.join(timeout=900)
    wall = time.monotonic() - t0
    check(not any(t.is_alive() for t in threads), "a burst request hung")
    check(not errors, f"burst requests failed: {errors}")
    return out, stream["s"], wall


def check_burst(out, stream):
    """Every response of a front_door_burst 200 and "success", every
    verdict of the grammar's schema, the stream ended without an error."""
    for name, (status, body, _) in out.items():
        # /api/v1/stats' envelope has no "status" key (as in the JAX
        # server): it must carry the engine block instead.
        ok = (body["engine"] is not None if name.startswith("stats")
              else body.get("status") == "success")
        check(status == 200 and ok, f"{name}: HTTP {status} "
                                    f"{str(body)[:300]}")
    for i in range(4):
        check_verdict(out[f"analyze-{i}"][1]["result"]["verdict"],
                      f"analyze-{i}")
    s_status, events, _, _ = stream
    check(s_status == 200 and events and events[-1].get("done")
          and not any("error" in e for e in events),
          f"stream: HTTP {s_status}, events {events[-3:]}")


def greedy_eight(backend, eng, prompts, arm_after_steps=None):
    """Eight greedy backend.generate calls at once; with
    ``arm_after_steps`` the step_loop_crash injector is armed once, after
    that many decode steps of this run.  Returns the texts and the seconds
    from arming to the supervisor serving again (None without a crash)."""
    import threading

    from k8s_llm_monitor_tpu_torch.resilience.faults import get_injector

    texts, errors = {}, []

    def run(i):
        try:
            texts[i] = backend.generate(prompts[i], max_tokens=48,
                                        temperature=0.0)
        except Exception as exc:
            errors.append(f"generate {i}: {type(exc).__name__}: {exc}")

    d0 = eng.decode_steps
    threads = [threading.Thread(target=run, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    if arm_after_steps is not None:
        deadline = time.monotonic() + 300
        while (eng.decode_steps < d0 + arm_after_steps
               and time.monotonic() < deadline):
            time.sleep(0.001)
        check(eng.decode_steps >= d0 + arm_after_steps,
              "the greedy calls never reached the crash point")
        sup = backend.supervisor
        restarts = sup.restarts
        t0 = time.monotonic()
        get_injector().arm("step_loop_crash", rate=1.0, times=1)
        while ((sup.restarts == restarts or sup.state != "serving")
               and time.monotonic() - t0 < 300):
            time.sleep(0.001)
        rebuild_s = time.monotonic() - t0
    for t in threads:
        t.join(timeout=600)
    check(not any(t.is_alive() for t in threads), "a greedy call hung")
    check(not errors, f"greedy calls failed: {errors}")
    return ([texts[i] for i in range(8)],
            rebuild_s if arm_after_steps is not None else None)


def journal_ids(directory, prompts_ids):
    """The journal's two admits of each prompt, in admission order (the
    uncrashed run, then the crashed one); their progress records carry
    every token delivered to the caller."""
    from k8s_llm_monitor_tpu_torch.resilience.journal import scan_journal

    reqs, _ = scan_journal(directory)
    by_prompt = {}
    for rid in sorted(reqs, key=lambda r: int(r.rsplit("-", 1)[1])):
        by_prompt.setdefault(tuple(reqs[rid].prompt_ids), []).append(reqs[rid])
    out = [by_prompt.get(tuple(p), []) for p in prompts_ids]
    check(all(len(rs) == 2 for rs in out),
          f"journaled admits per prompt: {[len(rs) for rs in out]}, wanted 2")
    return out


def phase6(torch, np, st):
    import gc
    import os
    import shutil
    import signal
    import socket
    import tempfile

    from k8s_llm_monitor_tpu_torch.monitor.cluster import (
        FakeCluster, seed_demo_cluster)
    from k8s_llm_monitor_tpu_torch.monitor.config import load_config
    from k8s_llm_monitor_tpu_torch.monitor.server import build_server
    from k8s_llm_monitor_tpu_torch.monitor.watcher import Watcher
    from k8s_llm_monitor_tpu_torch.ops import paged_attention as pa
    from k8s_llm_monitor_tpu_torch.resilience.journal import scan_journal
    from k8s_llm_monitor_tpu_torch.serving.engine import SamplingParams

    gpu = st["gpu"]
    # The earlier phases' model goes first: the server builds its own.
    st.pop("model", None)
    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_front_door_")
    journal_dir = os.path.join(tmp, "journal")
    cfg = load_config(None)
    cfg.server.host, cfg.server.port = "127.0.0.1", 0
    cfg.llm.provider = "tpu"
    cfg.llm.max_tokens = 64
    tc = cfg.llm.tpu
    tc.model, tc.quantize, tc.spec_k = "llama3-8b", "", 0
    tc.kv_blocks, tc.max_batch = 4096, 32
    cfg.lifecycle.journal_dir = journal_dir
    cfg.telemetry.enabled = False
    cfg.remediation.enabled = False
    cfg.diagnosis.enabled = True
    fake = seed_demo_cluster(FakeCluster())
    mem0 = torch.cuda.memory_allocated()
    t0 = time.monotonic()
    srv = build_server(cfg, backend=fake)
    boot_s = time.monotonic() - t0
    backend = srv.analysis.backend
    sup = backend.supervisor
    watcher = None
    try:
        check(sup is not None, "the backend is not supervised")
        check(backend.supports_grammar, "no verdict grammar on the engine")
        eng = backend.engine
        check((eng.prefill_path, eng.decode_path, eng.kv_quant, eng.device.type)
              == ("flash", "fused", "", "cuda"),
              f"engine paths {eng.prefill_path}/{eng.decode_path} pool "
              f"{eng.kv_quant or 'bf16'} on {eng.device}")
        print(f"phase 6: build_server(llama3-8b, bf16 pool of "
              f"{eng.pool_bytes} B, {tc.max_batch} slots) in {boot_s:.2f} s, "
              f"{torch.cuda.memory_allocated() - mem0} B allocated [{gpu}]")
        # The first request, cold (cuBLAS set-up, the first 8B prefill, and
        # the captures of its decode graphs: 7 greedy decode steps as calls
        # of 4, 2 and 1), must not trip the supervisor's heartbeat watchdog.
        cold = sup.submit(backend.tokenizer.encode("warm-up"),
                          SamplingParams(max_tokens=8, temperature=0.0)
                          ).result(timeout=300)
        check(cold.finish_reason in ("eos", "length"),
              f"first request ended {cold.finish_reason}: {cold.error}")
        check(sup.restarts == 0, "the first request tripped a restart")
        print(f"phase 6: first request (8 tokens, cold): "
              f"{cold.latency_s * 1e3:.1f} ms with "
              f"{eng.graph_captures} decode graphs captured in "
              f"{eng.graph_capture_s:.2f} s; heartbeat timeout "
              f"{sup.heartbeat_timeout_s:.0f} s, restarts 0 [{gpu}]")
        srv.start()
        port = srv.port
        for path in ("/health", "/readyz"):
            status, body, _ = http_call(port, "GET", path)
            check(status == 200 and body["ready"], f"{path}: {status} {body}")

        pa.reset_launch_counts()
        out, stream, wall = front_door_burst(port)
        torch.cuda.synchronize()
        launches = {"flash_prefill": pa.flash_prefill_attention.launches,
                    "fused_decode": pa.paged_decode_attention_fused.launches}
        check_burst(out, stream)
        s_status, events, first_s, s_wall = stream
        check(all(n > 0 for n in launches.values()),
              f"a kernel never launched on the front door's path: {launches}")
        st["front_door_launches"] = launches
        for rec in st.get("records", []):
            if rec["name"] in launches:
                rec["launches_front_door"] = launches[rec["name"]]
        q_walls = sorted(out[f"query-{i}"][2] for i in range(16))
        a_walls = sorted(out[f"analyze-{i}"][2] for i in range(4))
        print(f"phase 6: burst of 24 over HTTP (16 query, 4 analyze "
              f"root_cause, 1 streamed query, 3 stats) in {wall:.2f} s: "
              f"query wall p50 {np.percentile(q_walls, 50) * 1e3:.1f} ms, "
              f"p99 {np.percentile(q_walls, 99) * 1e3:.1f} ms; analyze wall "
              f"p50 {np.percentile(a_walls, 50) * 1e3:.1f} ms; stream first "
              f"event {first_s * 1e3:.1f} ms of {s_wall * 1e3:.1f} ms "
              f"({len(events)} events); all 200/success, 4 verdicts parse; "
              f"constrained_decode_overhead_ms "
              f"{backend.constrained_decode_overhead_ms:.3f}; launches "
              f"{launches}; {graph_line(torch, eng)} [{gpu}]")
        # The same burst again, once the decode graphs it uses exist.
        out2, _, wall2 = front_door_burst(port)
        check(all(status == 200 for status, _, _ in out2.values()),
              "the second burst: a request failed")
        q2 = sorted(out2[f"query-{i}"][2] for i in range(16))
        a2 = sorted(out2[f"analyze-{i}"][2] for i in range(4))
        print(f"phase 6: the same burst again in {wall2:.2f} s: query wall "
              f"p50 {np.percentile(q2, 50) * 1e3:.1f} ms, p99 "
              f"{np.percentile(q2, 99) * 1e3:.1f} ms; analyze wall p50 "
              f"{np.percentile(a2, 50) * 1e3:.1f} ms; "
              f"constrained_decode_overhead_ms "
              f"{backend.constrained_decode_overhead_ms:.3f}; "
              f"{graph_line(torch, eng)} [{gpu}]")
        pc = eng.prefix_cache
        check(eng.dispatch_failures == 0 and eng.watchdog_trips == 0,
              f"{eng.dispatch_failures} dispatch failures, "
              f"{eng.watchdog_trips} watchdog trips in the bursts")
        print(f"phase 6: the engine after both bursts: prefix cache hits "
              f"{pc.hits}, misses {pc.misses}, entries {len(pc)}; "
              f"deferrals {eng.prefix_deferrals}; prefill rows "
              f"{eng.prefill_tokens}; steps that waited on the device "
              f"while dispatching {eng.admission_waits} of {eng.steps} "
              f"[{gpu}]")

        # The standing diagnosis loop: a crash-loop burst of Warning events
        # in the cluster, through the watcher, to a verdict.
        watcher = Watcher(srv.client, srv.diagnosis.handler,
                          namespaces=cfg.k8s.watch_namespaces)
        watcher.start()
        t0 = time.monotonic()
        added = 0
        while srv.diagnosis.triggers_total == 0 and added < 60:
            time.sleep(0.2)         # the watch streams subscribe
            for i in range(cfg.diagnosis.burst_threshold + 1):
                fake.add_event(type_="Warning", reason="BackOff",
                               message="Back-off restarting failed "
                                       f"container web (try {added + i})",
                               involved_object="web-frontend-7d4b9c6f5-x2x1p")
            added += cfg.diagnosis.burst_threshold + 1
            time.sleep(1.0)
        check(srv.diagnosis.triggers_total >= 1,
              f"{added} Warning events never triggered a diagnosis")
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline:
            status, payload, _ = http_call(port, "GET", "/api/v1/diagnoses")
            if payload.get("count", 0) >= 1:
                break
            time.sleep(0.25)
        check(status == 200 and payload.get("count", 0) >= 1,
              f"no diagnosis within 300 s: {str(payload)[:300]}")
        entry = payload["diagnoses"][0]
        check_verdict(entry["verdict"], "diagnosis")
        check("BackOff" in entry["trigger"], f"trigger {entry['trigger']!r}")
        print(f"phase 6: diagnosis pipeline: {added} Warning BackOff events "
              f"-> verdict {entry['verdict']['severity']} in "
              f"{time.monotonic() - t0:.2f} s (queries "
              f"{payload['pipeline']['queries']}) [{gpu}]")
        watcher.stop()
        watcher = None

        # A rebuild: eight greedy calls without, then with one step-loop
        # crash partway through.
        prompts = [f"Summarize the health of node k3d-demo-agent-{i} and its "
                   f"pods in one paragraph ({i})." for i in range(8)]
        ids_of = [backend.tokenizer.encode(p) for p in prompts]
        ref, _ = greedy_eight(backend, eng, prompts)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mem_before = torch.cuda.memory_allocated()
        t_run = time.monotonic()
        got, rebuild_s = greedy_eight(backend, eng, prompts,
                                      arm_after_steps=2)
        torch.cuda.synchronize()
        mem_after = torch.cuda.memory_allocated()
        peak = torch.cuda.max_memory_allocated()
        snap = sup.snapshot()
        status, health, _ = http_call(port, "GET", "/health")
        check(health["lifecycle"]["restarts"] == 1 and snap["restarts"] == 1,
              f"restarts {health['lifecycle']['restarts']}, wanted 1")
        check(got == ref, "greedy texts differ after the rebuild: "
              + str([(i, a, b) for i, (a, b) in enumerate(zip(ref, got))
                     if a != b])[:600])
        n_same = 0
        for i, (first, second) in enumerate(journal_ids(journal_dir, ids_of)):
            check(len(second.emitted) <= 48,
                  f"prompt {i}: {len(second.emitted)} tokens delivered for a "
                  "48-token budget (a duplicate)")
            n_same += second.emitted == first.emitted
        reqs, _ = scan_journal(journal_dir)
        check(all(r.completed for r in reqs.values()),
              "a journaled admit is not tombstoned")
        new_eng = backend.engine
        check(new_eng is not eng and eng.pages is None,
              "the rebuilt engine did not release the dead one's pool")
        print(f"phase 6: rebuild: 1 restart, {snap['replayed_total']} "
              f"replayed, {rebuild_s:.3f} s from the crash to serving again "
              f"(backoff {cfg.lifecycle.restart_backoff_s} s), "
              f"{time.monotonic() - t_run:.2f} s for the crashed run; 8 "
              f"greedy texts equal the uncrashed run's, {n_same} of 8 "
              f"id sequences equal; {len(reqs)} journaled admits, all "
              f"tombstoned; memory_allocated {mem_before} B before, "
              f"{mem_after} B after, max_memory_allocated {peak} B across "
              f"the rebuild (pool {new_eng.pool_bytes} B; the new engine: "
              f"{graph_line(torch, new_eng)}) [{gpu}]")

        drained = sup.shutdown(grace_s=SHUTDOWN_GRACE_S)
        status, body, _ = http_call(port, "GET", "/readyz")
        check(status == 503 and not body["ready"],
              f"/readyz after shutdown: {status} {body}")
        check(scan_journal(journal_dir)[1], "the journal is not sealed")
        print(f"phase 6: shutdown: drained={drained}, /readyz 503 "
              f"({body['reason']}), journal sealed")
    finally:
        if watcher is not None:
            watcher.stop()
        sup.shutdown(grace_s=0.0)
        srv.stop()
        del backend, sup, srv
        gc.collect()
        torch.cuda.empty_cache()

    # cmd.server in its own process: boot, one query, SIGTERM, exit 0.
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, LLM_TPU_MODEL="tiny", LLM_TPU_QUANTIZE="",
               LLM_TPU_SPEC_K="0", TELEMETRY_ENABLED="false",
               REMEDIATION_ENABLED="false", LLM_MAX_TOKENS="16",
               LIFECYCLE_JOURNAL_DIR=os.path.join(tmp, "cmd-journal"),
               K8SLLM_FLIGHT_DIR=os.path.join(tmp, "flight"))
    log_path = os.path.join(tmp, "cmd_server.log")
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.monotonic()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "k8s_llm_monitor_tpu_torch.cmd.server",
             "--cluster", "fake", "--host", "127.0.0.1", "--port", str(port)],
            cwd=root, env=env, stdout=log, stderr=subprocess.STDOUT)
    try:
        ready = False
        while time.monotonic() - t0 < 180 and proc.poll() is None:
            try:
                status, body, _ = http_call(port, "GET", "/readyz",
                                            timeout=5.0)
                ready = status == 200 and body["ready"]
            except OSError:
                pass
            if ready:
                break
            time.sleep(0.25)
        check(ready, f"cmd.server never became ready (rc {proc.poll()})")
        ready_s = time.monotonic() - t0
        status, body, q_s = http_call(port, "POST", "/api/v1/query",
                                      {"question": "why crashloop?"})
        check(status == 200 and body["status"] == "success",
              f"cmd.server query: {status} {str(body)[:300]}")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        check(rc == 0, f"cmd.server exited {rc} on SIGTERM")
        print(f"phase 6: cmd.server (tiny, --cluster fake): ready in "
              f"{ready_s:.1f} s, query 200 in {q_s * 1e3:.1f} ms "
              f"({body['result']['model']}), SIGTERM -> exit 0")
    except BaseException:
        with open(log_path) as f:
            print(f.read()[-4000:], file=sys.stderr)
        raise
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)


PREFIX_LEN = 1536                # phase 7a: the burst's shared prefix
HIT_TOL = LOGIT_ATOL             # phase 7a: a hit's logits, 4 layers, bf16


def drive(eng, reqs, sp_of):
    """Submit ``reqs`` ((id, prompt, SLO class)) together, step the engine
    to the end and return (results by id, wall seconds)."""
    import torch

    from k8s_llm_monitor_tpu_torch.serving.engine import GenerationRequest

    t0 = time.monotonic()
    for rid, prompt, cls in reqs:
        eng.submit(GenerationRequest(rid, list(prompt), sp_of(rid),
                                     slo_class=cls))
    steps = 0
    while eng.has_work:
        eng.step()
        steps += 1
        check(steps < 20_000, "the engine did not drain")
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    return {rid: eng.poll(rid) for rid, _, _ in reqs}, wall


def check_complete(res, n_tokens, what):
    """Every result ``length`` with exactly ``n_tokens`` valid ids."""
    for rid, r in res.items():
        check(r.finish_reason == "length" and len(r.token_ids) == n_tokens,
              f"{what} {rid}: {r.finish_reason} with {len(r.token_ids)} "
              f"tokens {r.error}")


def check_baseline(eng, baseline, what):
    """Idle, and the allocator back at its idle free count once the prefix
    cache lets go of its own blocks."""
    check(not eng._inflight and not eng._deferred_frees
          and not any(eng._slots), f"{what}: the engine is not idle")
    if eng.prefix_cache is not None:
        eng.prefix_cache.clear()
    check(eng.allocator.free_blocks == baseline,
          f"{what}: {eng.allocator.free_blocks} blocks free after the run, "
          f"{baseline} before")


def prefix_burst(torch, np, st, model, prompts, name, overrides):
    """Phase 7a: the 32 requests at once on one engine (phase 2's bf16
    geometry).  Returns the run's figures and its ids."""
    from k8s_llm_monitor_tpu_torch.ops import paged_attention as pa
    from k8s_llm_monitor_tpu_torch.serving.engine import (
        EngineConfig, InferenceEngine, SamplingParams)

    eng = InferenceEngine(model.cfg, model, EngineConfig(
        max_slots=32, num_blocks=4096, block_size=16,
        max_blocks_per_seq=ENGINE_TABLE, max_prefills_per_step=8,
        decode_steps_per_iter=8, **overrides))
    baseline = eng.allocator.free_blocks
    sp = SamplingParams(max_tokens=32)
    reqs = [(f"{name}-{i}", p, "standard") for i, p in enumerate(prompts)]
    pa.reset_launch_counts()
    res, wall = drive(eng, reqs, lambda rid: sp)
    flash = pa.flash_prefill_attention.launches
    check_complete(res, 32, name)
    check(eng.dispatch_failures == 0 and eng.watchdog_trips == 0,
          f"{name}: {eng.dispatch_failures} dispatch failures, "
          f"{eng.watchdog_trips} watchdog trips")
    check(flash > 0, f"{name}: flash prefill never launched")
    pc = eng.prefix_cache
    ttfts = sorted(r.ttft_s for r in res.values())
    fig = dict(hits=pc.hits if pc else 0, misses=pc.misses if pc else 0,
               deferrals=eng.prefix_deferrals, rows=eng.prefill_tokens,
               flash=flash, wall=wall,
               ttft50=float(np.percentile(ttfts, 50)),
               ttft99=float(np.percentile(ttfts, 99)),
               tok_s=eng.decode_tokens / eng.decode_s,
               rounds=dict(eng.prefill_bucket_rounds),
               dispatch_s=eng.prefill_dispatch_s)
    check_baseline(eng, baseline, name)
    del eng
    torch.cuda.empty_cache()
    return fig, [res[rid].token_ids for rid, _, _ in reqs]


def hit_logits(torch, np, st, model, prompts):
    """Phase 7a's model-level check on 4 layers: the first-token logits of
    4 prompts prefilled as prefix hits (``prefill_chunk`` of their tails
    over the pages a publisher wrote) against a whole ``prefill`` of the
    same prompts, both through the flash kernel."""
    from k8s_llm_monitor_tpu_torch.models import llama
    from k8s_llm_monitor_tpu_torch.ops import paged_attention as pa

    dev = torch.device("cuda")
    m4 = truncated(model, 4)
    B = len(prompts)
    lens = [len(p) for p in prompts]
    nbl = (max(lens) + BS - 1) // BS + 1
    shared = PREFIX_LEN // BS

    def table(rows):
        return torch.tensor(rows, dtype=torch.int32, device=dev)

    # Whole prompts, each over blocks of its own.
    pages = llama.init_kv_pages(m4.cfg, B * nbl + 1, BS, dev)
    toks = np.zeros((B, 2048), np.int32)
    for b, p in enumerate(prompts):
        toks[b, :len(p)] = p
    whole, _ = llama.prefill(
        m4, torch.from_numpy(toks).to(dev), table(lens), pages,
        table([[1 + b * nbl + i for i in range(nbl)] for b in range(B)]),
        attn_impl=pa.flash_prefill_attention)
    # Hits: a publisher (the first prompt) writes the prefix's blocks, the
    # tails attend to them from their own blocks.
    pages = llama.init_kv_pages(m4.cfg, B * nbl + shared + 1, BS, dev)
    pub = [1 + i for i in range(nbl)]
    llama.prefill(m4, torch.from_numpy(toks[:1]).to(dev), table(lens[:1]),
                  pages, table([pub]), attn_impl=pa.flash_prefill_attention)
    rows, tails = [], np.zeros((B, 256), np.int32)
    for b, p in enumerate(prompts):
        own = [1 + nbl + b * (nbl - shared) + i for i in range(nbl - shared)]
        rows.append(pub[:shared] + own)
        tails[b, :len(p) - PREFIX_LEN] = p[PREFIX_LEN:]
    hit, _ = llama.prefill_chunk(
        m4, torch.from_numpy(tails).to(dev),
        table([PREFIX_LEN] * B), table([n - PREFIX_LEN for n in lens]),
        pages, table(rows), attn_impl=pa.flash_prefill_attention)
    torch.cuda.synchronize()
    err = float((hit - whole).abs().max())
    agree, ties, n = argmax_agreement([hit], [whole], HIT_TOL)
    print(f"phase 7: 4-layer model, {B} prompts as prefix hits "
          f"(prefill_chunk of their {[n - PREFIX_LEN for n in lens]}-token "
          f"tails over the {PREFIX_LEN} shared tokens) against whole "
          f"prefills: first-token logit max abs err {err:.4g} (tolerance "
          f"{HIT_TOL}); argmax agreement {agree:.3f} (at least "
          f"{MIN_ARGMAX_AGREE}; {ties} of {n} rows near-ties within "
          f"{HIT_TOL}) [{st['gpu']}]")
    check(bool(torch.isfinite(hit).all()), "hit logits not finite")
    check(err <= HIT_TOL, f"hit logits differ by {err:.4g}")
    check(agree >= MIN_ARGMAX_AGREE, f"hit argmax agreement {agree:.3f}")
    del pages
    torch.cuda.empty_cache()


def pressure_engine(model, **overrides):
    """Phase 7b's engine: 16 slots over a pool of 512 x 16 tokens (8,192),
    bf16, the watchdog at 2 s."""
    from k8s_llm_monitor_tpu_torch.serving.engine import (
        EngineConfig, InferenceEngine)

    return InferenceEngine(model.cfg, model, EngineConfig(**dict(dict(
        max_slots=16, num_blocks=512, block_size=16, max_blocks_per_seq=64,
        max_prefills_per_step=8, decode_steps_per_iter=8,
        dispatch_timeout_s=2.0), **overrides)))


def phase7(torch, np, st):
    from k8s_llm_monitor_tpu_torch.models import llama
    from k8s_llm_monitor_tpu_torch.models.config import LLAMA3_8B
    from k8s_llm_monitor_tpu_torch.resilience.faults import get_injector
    from k8s_llm_monitor_tpu_torch.serving.engine import SamplingParams

    gpu = st["gpu"]
    model = st.get("model") or llama.LlamaModel(LLAMA3_8B, seed=0)
    st["model"] = model
    V = model.cfg.vocab_size
    rng = np.random.default_rng(7)

    # 7a: 32 greedy requests sharing a 1,536-token prefix, each with its own
    # tail of 32..160 tokens, 32 new tokens, submitted at once.
    prefix = [int(t) for t in rng.integers(3, V, size=PREFIX_LEN)]
    tails = [int(n) for n in rng.integers(32, 161, size=32)]
    prompts = [prefix + [int(t) for t in rng.integers(3, V, size=n)]
               for n in tails]
    runs = {}
    for name, overrides in (("bf16 cache on", {}),
                            ("bf16 cache off", {"prefix_cache_entries": 0}),
                            ("int8 cache on", {"kv_dtype": "int8"})):
        runs[name] = prefix_burst(torch, np, st, model, prompts, name,
                                  overrides)
    off_ids = runs["bf16 cache off"][1]
    for name, (fig, ids) in runs.items():
        same = sum(a == b for a, b in zip(ids, off_ids))
        print(f"phase 7: {name}: 32 requests sharing {PREFIX_LEN} tokens "
              f"(tails {min(tails)}..{max(tails)}): prefix hits "
              f"{fig['hits']}, misses {fig['misses']}, deferrals "
              f"{fig['deferrals']}; prefill rows computed {fig['rows']} "
              f"(rounds by bucket {fig['rounds']}, dispatched in "
              f"{fig['dispatch_s'] * 1e3:.1f} ms of host time); flash "
              f"prefill launches "
              f"{fig['flash']}; burst wall {fig['wall']:.3f} s, ttft p50 "
              f"{fig['ttft50'] * 1e3:.1f} ms, p99 {fig['ttft99'] * 1e3:.1f} "
              f"ms, decode {fig['tok_s']:.1f} tok/s; {same} of 32 id "
              f"sequences equal the cache-off run's [{gpu}]")
    on, off = runs["bf16 cache on"][0], runs["bf16 cache off"][0]
    for name in ("bf16 cache on", "int8 cache on"):
        fig = runs[name][0]
        check(fig["hits"] >= 31, f"{name}: {fig['hits']} prefix hits")
        check(4 * fig["rows"] <= off["rows"],
              f"{name}: {fig['rows']} prefill rows against {off['rows']} "
              "with the cache off")
    print(f"phase 7: prefill rows with the cache on / off: {on['rows']} / "
          f"{off['rows']} = {on['rows'] / off['rows']:.3f} (at most 0.25; "
          f"{PREFIX_LEN} + the tails {sum(tails)} = "
          f"{PREFIX_LEN + sum(tails)} expected on) [{gpu}]")
    hit_logits(torch, np, st, model, prompts[:4])

    # 7b: 16 greedy requests of 300..400-token prompts, 400 new tokens
    # each, in two SLO classes, against 8,192 cached tokens: lanes must be
    # preempted.  Then the same requests on a pool that holds them all.
    reqs = [(f"p{i}", [int(t) for t in rng.integers(3, V, size=int(n))],
             "standard" if i % 2 == 0 else "batch")
            for i, n in enumerate(rng.integers(300, 401, size=16))]
    need = sum(len(p) + 400 for _, p, _ in reqs)
    sp = SamplingParams(max_tokens=400)
    eng = pressure_engine(model)
    baseline = eng.allocator.free_blocks
    res, wall = drive(eng, reqs, lambda rid: sp)
    check_complete(res, 400, "7b")
    check(sum(eng.preemptions_by_class.values()) > 0,
          "7b: no lane was preempted")
    check(eng.dispatch_failures == 0 and eng.watchdog_trips == 0,
          f"7b: {eng.dispatch_failures} dispatch failures, "
          f"{eng.watchdog_trips} watchdog trips")
    ttfts = sorted(r.ttft_s for r in res.values())
    print(f"phase 7: 7b: 16 requests of 300..400 prompt tokens and 400 new "
          f"(about {need} tokens) on a pool of {eng.allocator.num_blocks} x "
          f"16: all complete in {wall:.2f} s, preemptions by class "
          f"{eng.preemptions_by_class}, requeues {eng.requeues}, prefill "
          f"rows {eng.prefill_tokens}, decode steps {eng.decode_steps}, "
          f"ttft p50 {np.percentile(ttfts, 50) * 1e3:.1f} ms; "
          f"{graph_line(torch, eng)} [{gpu}]")
    check_baseline(eng, baseline, "7b")
    free_eng = pressure_engine(model, num_blocks=2048)
    ref, ref_wall = drive(free_eng, reqs, lambda rid: sp)
    check_complete(ref, 400, "7b unpressured")
    check(sum(free_eng.preemptions_by_class.values()) == 0,
          "7b: the unpressured run preempted")
    same = sum(res[rid].token_ids == ref[rid].token_ids for rid, _, _ in reqs)
    print(f"phase 7: 7b: {same} of 16 id sequences equal the unpressured "
          f"run's (a pool of 2048 x 16, {ref_wall:.2f} s, no preemption) "
          f"[{gpu}]")
    del free_eng
    torch.cuda.empty_cache()

    # 7c: recovery on the 7b engine (its graphs captured): a stuck decode
    # call trips the watchdog and the reset requeues every lane without
    # recapturing a graph; a failed admission dispatch is requeued; a
    # lane_eviction fault during 7b's traffic falls back to the lane itself.
    inj = get_injector()
    short = SamplingParams(max_tokens=64)
    programs = dict(eng._programs)
    captures = eng.graph_captures
    for point, traffic, sp_run in (("decode_stuck", reqs[:8], short),
                                   ("prefill_dispatch", reqs[:8], short),
                                   ("lane_eviction", reqs, sp)):
        trips, fails, requeues = (eng.watchdog_trips, eng.dispatch_failures,
                                  eng.requeues)
        inj.arm(point, rate=1.0, times=1)
        try:
            res, wall = drive(eng, [(f"{point}-{rid}", p, c)
                                    for rid, p, c in traffic],
                              lambda rid: sp_run)
        finally:
            fired = inj.fired(point)
            inj.disarm(point)
        check(fired == 1, f"7c: {point} fired {fired} times")
        check_complete(res, sp_run.max_tokens, f"7c {point}")
        d_trips = eng.watchdog_trips - trips
        d_fails = eng.dispatch_failures - fails
        d_requeues = eng.requeues - requeues
        want = {"decode_stuck": (1, 0), "prefill_dispatch": (0, 1),
                "lane_eviction": (0, 1)}[point]
        check((d_trips, d_fails) == want,
              f"7c {point}: {d_trips} watchdog trips, {d_fails} dispatch "
              f"failures, wanted {want}")
        if point != "lane_eviction":
            check(d_requeues >= 1, f"7c {point}: nothing requeued")
        print(f"phase 7: 7c: {point} armed once: fired {fired}, watchdog "
              f"trips +{d_trips}, dispatch failures +{d_fails}, requeues "
              f"+{d_requeues}; {len(res)} requests complete in {wall:.2f} "
              f"s [{gpu}]")
        check_baseline(eng, baseline, f"7c {point}")
    grown = {k: p for k, p in eng._programs.items() if k not in programs}
    check(all(eng._programs[k] is p and p.graph is not None
              for k, p in programs.items()),
          "7c: a decode program was rebuilt across the resets")
    check(eng.graph_captures == captures + len(grown),
          f"7c: {eng.graph_captures - captures} captures for "
          f"{len(grown)} new programs: a graph was recaptured")
    print(f"phase 7: 7c: decode graphs {captures} before the faults, "
          f"{eng.graph_captures} after ({len(grown)} new programs, none "
          f"recaptured) [{gpu}]")
    del eng
    torch.cuda.empty_cache()


def clone_pages(pages):
    """A deep copy of a KVPages pool (pages and scale planes)."""
    return dataclasses.replace(
        pages, k=[t.clone() for t in pages.k], v=[t.clone() for t in pages.v],
        k_scale=[t.clone() for t in pages.k_scale],
        v_scale=[t.clone() for t in pages.v_scale])


def verify_vs_decode(torch, np, model, label, kv_quant, prefill_impl,
                     verify_impl, decode_impl):
    """On ``model`` (4 layers): verify_step's logits at each of the 5
    positions of a draft chain against 5 sequential decode_step calls fed
    the same tokens over a copy of the same pool, held by phase 3's rule
    (logit tolerance, argmax agreement with the near-ties counted)."""
    from k8s_llm_monitor_tpu_torch.models import llama

    dev = torch.device("cuda")
    cfg = model.cfg
    rng = np.random.default_rng(8)
    lens = [100, 517, 1024, 33]
    B, S = len(lens), 1024
    toks = np.zeros((B, S), np.int32)
    for b, n in enumerate(lens):
        toks[b, :n] = rng.integers(3, cfg.vocab_size, size=n)
    nbl = 1024 // BS + 4
    tables = torch.arange(1, B * nbl + 1, dtype=torch.int32,
                          device=dev).reshape(B, nbl)
    len_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    pages = llama.init_kv_pages(cfg, B * nbl + 1, BS, dev, kv_quant=kv_quant)
    llama.prefill(model, torch.from_numpy(toks).to(dev), len_t, pages,
                  tables, attn_impl=prefill_impl)
    fed = torch.from_numpy(rng.integers(3, cfg.vocab_size, size=(B, 5))
                           .astype(np.int32)).to(dev)
    got, _ = llama.verify_step(model, fed, len_t, torch.full_like(len_t, 5),
                               clone_pages(pages), tables,
                               attn_impl=verify_impl)
    want = []
    for i in range(5):
        lg, _ = llama.decode_step(model, fed[:, i], len_t + i, pages, tables,
                                  attn_impl=decode_impl)
        want.append(lg)
    torch.cuda.synchronize()
    got = [got[:, i] for i in range(5)]
    errs = [float((a - b).abs().max()) for a, b in zip(got, want)]
    tol = QUANT_LOGIT_ATOL if kv_quant else LOGIT_ATOL
    agree, n_ties, n_rows = argmax_agreement(got, want, tol)
    print(f"phase 8: 4-layer {cfg.name}, {label}: verify_step vs 5 "
          f"sequential decode steps: logit max abs err per position "
          f"{[round(e, 4) for e in errs]} (tolerance {tol}); argmax "
          f"agreement {agree:.3f} (at least {MIN_ARGMAX_AGREE}; {n_ties} of "
          f"{n_rows} rows are decode-path near-ties within {tol})")
    check(max(errs) <= tol, f"{label}: verify logits differ by "
                            f"{max(errs):.4g}")
    check(agree >= MIN_ARGMAX_AGREE, f"{label}: argmax agreement {agree:.3f}")


class SpecCalls:
    """While installed, counts the engine's spec program calls and the
    kernel launches they add to the wrappers' counts (the count deltas
    around each call: a captured program's first call runs its work once,
    a replay adds the launches the capture recorded)."""

    def __enter__(self):
        from k8s_llm_monitor_tpu_torch.ops.paged_attention import (
            KERNEL_WRAPPERS)
        from k8s_llm_monitor_tpu_torch.serving.engine import _SpecProgram

        self.calls = 0
        self.launches = {fn.__name__: 0 for fn in KERNEL_WRAPPERS}
        # The class inherits __call__: restored by deleting the override.
        orig = _SpecProgram.__call__

        def call(prog):
            before = [fn.launches for fn in KERNEL_WRAPPERS]
            out = orig(prog)
            self.calls += 1
            for fn, b in zip(KERNEL_WRAPPERS, before):
                self.launches[fn.__name__] += fn.launches - b
            return out

        _SpecProgram.__call__ = call
        return self

    def __exit__(self, *exc):
        from k8s_llm_monitor_tpu_torch.serving.engine import _SpecProgram

        del _SpecProgram.__call__


def spec_run(torch, st, model, prompts, name, overrides, max_tokens,
             paths, want_launch, phase=8):
    """One phase 8 engine: 32 slots, the 256-block table, greedy; the
    prompts run twice, launch counts set to 0 just before the first run
    and read just after it.  Every request must finish, no dispatch may
    fail, and each wrapper of ``want_launch`` must have launched.  Returns
    (engine, the first run's ids, its launches, the second (warm) run's
    decode tok/s: the first captures the graphs, and the two runs'
    SpecCalls)."""
    from k8s_llm_monitor_tpu_torch.ops import paged_attention as pa
    from k8s_llm_monitor_tpu_torch.serving.engine import (
        EngineConfig, InferenceEngine, SamplingParams)

    ecfg = EngineConfig(max_slots=32, num_blocks=4096, block_size=16,
                        max_blocks_per_seq=ENGINE_TABLE,
                        max_prefills_per_step=8, decode_steps_per_iter=8,
                        prefix_cache_entries=0, **overrides)
    eng = InferenceEngine(model.cfg, model, ecfg)
    check((eng.prefill_path, eng.decode_path) == paths,
          f"{name}: paths {eng.prefill_path}/{eng.decode_path}, expected "
          f"{'/'.join(paths)}")
    pa.reset_launch_counts()
    t0 = time.monotonic()
    with SpecCalls() as first:
        res = eng.generate(prompts, SamplingParams(max_tokens=max_tokens))
        torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {fn.__name__: fn.launches for fn in pa.KERNEL_WRAPPERS}
    for r in res:
        check(r.finish_reason in ("eos", "length")
              and all(0 <= t < model.cfg.vocab_size for t in r.token_ids),
              f"{name} {r.request_id}: {r.finish_reason} {r.error}")
    check(all(launches[w] > 0 for w in want_launch),
          f"{name}: a kernel of its path never launched: {launches}")
    cold = eng.decode_tokens / eng.decode_s
    tokens0, secs0 = eng.decode_tokens, eng.decode_s
    with SpecCalls() as second:
        res2 = eng.generate(prompts, SamplingParams(max_tokens=max_tokens))
        torch.cuda.synchronize()
    check(all(r.finish_reason in ("eos", "length") for r in res2),
          f"{name}: the second run did not finish")
    check(eng.dispatch_failures == 0 and eng.watchdog_trips == 0,
          f"{name}: {eng.dispatch_failures} dispatch failures")
    tok_s = (eng.decode_tokens - tokens0) / (eng.decode_s - secs0)
    same = sum(a.token_ids == b.token_ids for a, b in zip(res, res2))
    print(f"phase {phase}: {name}: {len(res)} requests in {wall:.2f} s, "
          f"decode "
          f"{cold:.1f} tok/s cold, {tok_s:.1f} tok/s warm ({same} of "
          f"{len(res)} id sequences equal across the two runs; "
          f"{eng.decode_tokens} tokens, {eng.decode_steps} decode steps in "
          f"both), launches { {k: v for k, v in launches.items() if v} } "
          f"(first run); {graph_line(torch, eng)} [{st['gpu']}]")
    return eng, [r.token_ids for r in res], launches, tok_s, (first, second)


def spec_report(torch, eng, name, ids, ref_ids, tok_s, ref_tok_s, spec,
                verify, phase=8):
    """Print a spec run's acceptance, speed against spec off, EMA and ids
    against the spec-off run's; require a spec program captured as a graph
    and replayed, and the ``verify`` wrapper launched once per layer in
    every round of every spec call of the first run.  Returns those
    launches."""
    first, second = spec
    acc = eng.spec_tokens / max(eng.spec_lane_rounds, 1)
    progs = [p for k, p in eng._programs.items() if k[0] == "spec"]
    calls = first.calls + second.calls
    check(eng.spec_verify_steps > 0 and progs, f"{name}: no spec call ran")
    check(all(p.graph is not None for p in progs) and calls > len(progs),
          f"{name}: the spec program was not captured and replayed: "
          f"{len(progs)} programs, {calls} calls")
    per_call = eng.ecfg.spec_rounds_per_iter * eng.cfg.num_layers
    in_spec = first.launches[verify]
    check(in_spec == first.calls * per_call > 0,
          f"{name}: {in_spec} {verify} launches in {first.calls} spec calls "
          f"of the first run, expected {per_call} per call")
    same = sum(a == b for a, b in zip(ids, ref_ids))
    print(f"phase {phase}: {name}: acceptance {acc:.3f} tokens per "
          f"lane-round "
          f"({eng.spec_tokens} tokens over {eng.spec_lane_rounds} "
          f"lane-rounds, {eng.spec_verify_steps} verify forwards, both "
          f"runs), warm decode "
          f"{tok_s:.1f} tok/s with spec against {ref_tok_s:.1f} without "
          f"({tok_s / ref_tok_s:.2f}x), spec_accept_ema "
          f"{eng.spec_accept_ema()}, spec programs captured "
          f"{len(progs)} and called {calls} times ({first.calls} in the "
          f"first run, with {in_spec} {verify} launches); {same} of "
          f"{len(ids)} id sequences equal to the spec-off run's")
    return in_spec


def quote_checkpoint(torch, model, orbit):
    """Make ``model`` quote, in place (the JAX bench's spec_quote_accept
    construction): attention and MLP output projections zeroed, so the
    residual stream carries the current token's embedding, and the unembed
    wired so greedy decode walks ``orbit`` cyclically.  Every kernel still
    runs; a prompt holding periods of the cycle is a quoting workload."""
    with torch.no_grad():
        for layer in model.layers:
            layer.o.weight.zero_()
            layer.down.weight.zero_()
        w = model.lm_head.weight
        w.zero_()
        idx = torch.tensor(orbit, device=w.device)
        w[torch.roll(idx, -1)] = model.embed.weight[idx]


def phase8(torch, np, st):
    from k8s_llm_monitor_tpu_torch.models import llama
    from k8s_llm_monitor_tpu_torch.models.config import LLAMA_1B
    from k8s_llm_monitor_tpu_torch.ops import paged_attention as pa
    from k8s_llm_monitor_tpu_torch.utils.quantize import param_bytes

    st.setdefault("launches", {})
    # (a) llama-1b, the monitor's default model, at full width.
    cfg = LLAMA_1B
    t0 = time.monotonic()
    model = llama.LlamaModel(cfg, seed=1)
    torch.cuda.synchronize()
    print(f"phase 8: {cfg.name} ({cfg.num_layers} layers, hidden "
          f"{cfg.hidden_size}, head_dim {cfg.head_dim_}, {cfg.num_heads}/"
          f"{cfg.num_kv_heads} heads) random bf16 weights in "
          f"{time.monotonic() - t0:.1f} s, {param_bytes(model)} B")
    rng = np.random.default_rng(2)
    lens = st.get("prompt_lens") or prompt_lengths(np.random.default_rng(2))
    prompts = [[int(t) for t in rng.integers(3, cfg.vocab_size, size=n)]
               for n in lens]
    for label, over, paths, wrapper, rec in (
            ("bf16", {}, ("dense", "fused"),
             "paged_decode_attention_fused", "fused_decode_d64"),
            ("int8", {"kv_dtype": "int8"}, ("dense", "fused"),
             "paged_decode_attention_fused_quant", "fused_decode_int8_d64"),
            ("fp8", {"kv_dtype": "fp8"}, ("dense", "fused"),
             "paged_decode_attention_fused_quant", "fused_decode_fp8_d64"),
            ("pallas", {"decode_path": "pallas"}, ("dense", "pallas"),
             "paged_decode_attention_pallas", "paged_attn_d64")):
        eng, _, launches, _, _ = spec_run(
            torch, st, model, prompts, f"{cfg.name} {label} spec off", over,
            32, paths, (wrapper,))
        st["launches"][rec] = launches[wrapper]
        del eng
        torch.cuda.empty_cache()
    verify_vs_decode(torch, np, truncated(model, 4), "B3 verify (QS=5) vs "
                     "fused decode, bf16 pool", "", None,
                     pa.paged_verify_attention_pallas,
                     pa.paged_decode_attention_fused)
    # The quote burst: 16 requests, each 3 periods of a 200-token cycle
    # (rotated per lane) and 128 new tokens that walk it on.
    n_cyc = 200
    orbit = list(range(1000, 1000 + n_cyc))
    quote_checkpoint(torch, model, orbit)
    qprompts = [(orbit[i * 11:] + orbit[:i * 11]) * 3 for i in range(16)]
    off_eng, off_ids, _, off_tok_s, _ = spec_run(
        torch, st, model, qprompts, f"{cfg.name} quote burst, spec off", {},
        128, ("dense", "fused"), ("paged_decode_attention_fused",))
    for i, got in enumerate(off_ids):
        want = [orbit[(i * 11 + j) % n_cyc] for j in range(128)]
        check(got == want, f"quote checkpoint: lane {i} left the cycle")
    del off_eng
    eng, ids, launches, tok_s, spec = spec_run(
        torch, st, model, qprompts, f"{cfg.name} quote burst, spec_k 4",
        dict(spec_k=4, spec_min_accept=0.0), 128, ("dense", "fused"),
        ("paged_verify_attention_pallas",))
    check(eng._verify_attn is pa.paged_verify_attention_pallas,
          f"llama-1b spec verify path {eng._verify_attn}")
    in_spec = spec_report(torch, eng, f"{cfg.name} quote burst", ids,
                          off_ids, tok_s, off_tok_s, spec,
                          "paged_verify_attention_pallas")
    check(in_spec == launches["paged_verify_attention_pallas"],
          "llama-1b: the verify wrapper launched outside spec calls")
    # The verify wrapper's launches on the spec path, all at head_dim 64:
    # the Llama-3-8B engines verify through flash prefill, so its head_dim
    # 128 instance has no caller on the main path.
    st["launches"]["paged_attn_verify_d64"] = in_spec
    st["launches"]["paged_attn_verify"] = 0
    del eng, model
    torch.cuda.empty_cache()
    default_front_door(torch, np, st)

    # (b) phase 2's Llama-3-8B model: verify through flash prefill (B1) on
    # the bf16 pool and through its int8 instance (B5), every call drafting.
    model = st.get("model")
    if model is None:
        from k8s_llm_monitor_tpu_torch.models.config import LLAMA3_8B

        model = llama.LlamaModel(LLAMA3_8B, seed=0)
        st["model"] = model
    cfg = model.cfg
    rng = np.random.default_rng(2)
    prompts = [[int(t) for t in rng.integers(3, cfg.vocab_size, size=n)]
               for n in lens]
    for label, over, rec in (("bf16", {}, "flash_prefill_verify"),
                             ("int8", {"kv_dtype": "int8"},
                              "flash_prefill_int8_verify")):
        off_eng, off_ids, _, off_tok_s, _ = spec_run(
            torch, st, model, prompts, f"{cfg.name} {label} spec off", over,
            32, ("flash", "fused"), ("flash_prefill_attention",))
        del off_eng
        eng, ids, _, tok_s, spec = spec_run(
            torch, st, model, prompts, f"{cfg.name} {label} spec_k 4",
            dict(over, spec_k=4, spec_min_accept=0.0), 32,
            ("flash", "fused"), ("flash_prefill_attention",))
        check(eng._verify_attn is pa.flash_prefill_attention,
              f"{cfg.name} spec verify path {eng._verify_attn}")
        # Flash prefill inside the first run's spec (verify) calls only:
        # its prefill launches are not counted here.
        st["launches"][rec] = spec_report(
            torch, eng, f"{cfg.name} {label}", ids, off_ids, tok_s,
            off_tok_s, spec, "flash_prefill_attention")
        del eng
        torch.cuda.empty_cache()
    m4 = truncated(model, 4)
    verify_vs_decode(torch, np, m4, "B1 verify vs fused decode, bf16 pool",
                     "", pa.flash_prefill_attention,
                     pa.flash_prefill_attention,
                     pa.paged_decode_attention_fused)
    verify_vs_decode(torch, np, m4, "B5 verify vs fused quant decode, int8 "
                     "pool", "int8", pa.flash_prefill_attention,
                     pa.flash_prefill_attention,
                     pa.paged_decode_attention_fused_quant)


def default_front_door(torch, np, st):
    """8c: the monitor's default config served as load_config(None) gives
    it (llama-1b, W8A8: int8 weights from seed 0 and int8 activations,
    spec_k 4, spec_min_accept 1.2, 32 slots, 512 blocks of 16: a
    1,024-token table), with only telemetry and remediation off (ROADMAP
    A13), through build_server: the supervisor's step thread
    captures the spec and decode graphs, and phase 6's HTTP burst puts
    spec calls beside admissions in flight and constrained lanes under the
    acceptance gate.  Every response must succeed, the split paged
    attention kernel must launch in spec calls at QS=5 and the fused
    kernel in decode calls, with no dispatch failure or restart."""
    import gc
    import shutil
    import tempfile

    from k8s_llm_monitor_tpu_torch.monitor.cluster import (
        FakeCluster, seed_demo_cluster)
    from k8s_llm_monitor_tpu_torch.monitor.config import load_config
    from k8s_llm_monitor_tpu_torch.monitor.server import build_server
    from k8s_llm_monitor_tpu_torch.ops import paged_attention as pa

    gpu = st["gpu"]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_default_")
    cfg = load_config(None)
    cfg.server.host, cfg.server.port = "127.0.0.1", 0
    cfg.llm.provider = "tpu"
    cfg.llm.max_tokens = 64
    cfg.lifecycle.journal_dir = tmp
    cfg.telemetry.enabled = False
    cfg.remediation.enabled = False
    tc = cfg.llm.tpu
    t0 = time.monotonic()
    srv = build_server(cfg, backend=seed_demo_cluster(FakeCluster()))
    boot_s = time.monotonic() - t0
    backend = srv.analysis.backend
    sup = backend.supervisor
    try:
        eng = backend.engine
        check((tc.model, tc.quantize, eng.ecfg.spec_k,
               eng.ecfg.spec_min_accept) == ("llama-1b", "w8a8", 4, 1.2)
              and eng.model.quantized and eng.model.cfg.act_quant,
              f"not the default config: {tc}")
        check((eng.prefill_path, eng.decode_path, eng.kv_quant,
               eng._verify_attn) == ("dense", "fused", "",
                                     pa.paged_verify_attention_pallas),
              f"engine paths {eng.prefill_path}/{eng.decode_path} pool "
              f"{eng.kv_quant or 'bf16'} verify {eng._verify_attn}")
        srv.start()
        pa.reset_launch_counts()
        with SpecCalls() as spec:
            out, stream, wall = front_door_burst(srv.port)
            torch.cuda.synchronize()
        check_burst(out, stream)
        decode = pa.paged_decode_attention_fused.launches
        verify = spec.launches["paged_verify_attention_pallas"]
        check(eng.spec_verify_steps > 0 and spec.calls > 0 and verify > 0
              and decode > 0,
              f"default config: {spec.calls} spec calls, {verify} verify "
              f"and {decode} fused decode launches")
        check(eng.dispatch_failures == 0 and eng.watchdog_trips == 0
              and sup.restarts == 0,
              f"default config: {eng.dispatch_failures} dispatch failures, "
              f"{eng.watchdog_trips} watchdog trips, {sup.restarts} restarts")
        q_walls = sorted(out[f"query-{i}"][2] for i in range(16))
        print(f"phase 8: the default config ({tc.model}, quantize "
              f"{tc.quantize}, spec_k "
              f"{tc.spec_k}, spec_min_accept {tc.spec_min_accept}, "
              f"{tc.max_batch} slots, {tc.kv_blocks} blocks) through "
              f"build_server in {boot_s:.2f} s; burst of 24 over HTTP in "
              f"{wall:.2f} s, query wall p50 "
              f"{np.percentile(q_walls, 50) * 1e3:.1f} ms, all 200/success, "
              f"4 verdicts parse; {spec.calls} spec calls ("
              f"{eng.spec_verify_steps} verify forwards, acceptance "
              f"{eng.spec_tokens / max(eng.spec_lane_rounds, 1):.3f} tokens "
              f"per lane-round, spec_accept_ema {eng.spec_accept_ema()}), "
              f"launches: split paged attention QS=5 {verify} (in spec "
              f"calls), fused decode {decode}; {graph_line(torch, eng)} "
              f"[{gpu}]")
        captures = eng.graph_captures
        # The same burst again, its graphs captured: the warm walls.
        out2, stream2, wall2 = front_door_burst(srv.port)
        check_burst(out2, stream2)
        warm = sorted(out2[f"query-{i}"][2] for i in range(16))
        print(f"phase 8: the default config, the same burst again in "
              f"{wall2:.2f} s: query wall p50 "
              f"{np.percentile(warm, 50) * 1e3:.1f} ms, all 200/success; "
              f"{eng.graph_captures - captures} more decode graphs "
              f"captured [{gpu}]")
    finally:
        sup.shutdown(grace_s=0.0)
        srv.stop()
        del backend, sup, srv
        gc.collect()
        torch.cuda.empty_cache()
        shutil.rmtree(tmp, ignore_errors=True)


# Engines of phase 9a (Qwen2-7B, 7 query heads per kv head): as ENGINES.
QWEN_ENGINES = (
    ("bf16", {}, ("flash", "fused"),
     {"flash_prefill_qpk7": "flash_prefill_attention",
      "fused_decode_qpk7": "paged_decode_attention_fused"}),
    ("int8", {"kv_dtype": "int8"}, ("flash", "fused"),
     {"flash_prefill_int8_qpk7": "flash_prefill_attention",
      "fused_decode_int8_qpk7": "paged_decode_attention_fused_quant"}),
    ("pallas", {"decode_path": "pallas"}, ("flash", "pallas"),
     {"paged_attn_qpk7": "paged_decode_attention_pallas"}),
    # The unscaled fp8 pool (ModelConfig.kv_dtype, B8): its qpk-7 instances.
    ("fp8 pool", {}, ("flash", "fused"),
     {"flash_prefill_e4m3_qpk7": "flash_prefill_attention",
      "fused_decode_e4m3_qpk7": "paged_decode_attention_fused"}),
    ("fp8 pool pallas", {"decode_path": "pallas"}, ("flash", "pallas"),
     {"paged_attn_e4m3_qpk7": "paged_decode_attention_pallas"}),
)


def free_model(torch, st):
    """Drop the earlier phases' model from the card."""
    import gc

    st.pop("model", None)
    gc.collect()
    torch.cuda.empty_cache()


def phase9a(torch, np, st):
    """Qwen2-7B at full width: every kernel at 7 query heads per kv head."""
    from k8s_llm_monitor_tpu_torch.models import llama
    from k8s_llm_monitor_tpu_torch.models.config import QWEN2_7B
    from k8s_llm_monitor_tpu_torch.ops import paged_attention as pa
    from k8s_llm_monitor_tpu_torch.ops.attention import paged_decode_attention
    from k8s_llm_monitor_tpu_torch.utils.quantize import param_bytes

    cfg = QWEN2_7B
    t0 = time.monotonic()
    model = llama.LlamaModel(cfg, seed=3)
    torch.cuda.synchronize()
    print(f"phase 9: {cfg.name} ({cfg.num_layers} layers, hidden "
          f"{cfg.hidden_size}, {cfg.num_heads}/{cfg.num_kv_heads} heads, "
          f"vocab {cfg.vocab_size}, qkv bias) random bf16 weights in "
          f"{time.monotonic() - t0:.1f} s, {param_bytes(model)} B")
    rng = np.random.default_rng(2)
    lens = st.get("prompt_lens") or prompt_lengths(np.random.default_rng(2))
    prompts = [[int(t) for t in rng.integers(3, cfg.vocab_size, size=n)]
               for n in lens]
    st.setdefault("launches", {})
    for label, overrides, paths, kernels in QWEN_ENGINES:
        eng, ids, launches, _, tok_s = run_engine(
            torch, st, fp8_model(model) if label.startswith("fp8") else model,
            prompts, f"{cfg.name} {label}", overrides, paths, kernels,
            phase=9)
        st["launches"].update(launches)
        if label == "bf16":
            ref_ids, ref_tok_s = ids, tok_s
        del eng
        torch.cuda.empty_cache()
    flash_plain = marked(pa.flash_prefill_attention_plain, flash_prefill=True)
    quant_plain = marked(pa.paged_decode_attention_fused_quant_plain,
                         fused_decode=True, quant_kv=True)
    paths_logits(torch, np, truncated(model, 4), [
        ("flash/fused vs dense/gather", "",
         (pa.flash_prefill_attention, pa.paged_decode_attention_fused),
         (None, paged_decode_attention)),
        ("flash/pallas vs dense/gather", "",
         (pa.flash_prefill_attention, pa.paged_decode_attention_pallas),
         (None, paged_decode_attention)),
        ("int8 flash/fused kernels vs their plain versions", "int8",
         (pa.flash_prefill_attention, pa.paged_decode_attention_fused_quant),
         (flash_plain, quant_plain)),
    ], f"phase 9: 4-layer {cfg.name}")
    # Speculative decoding, every call drafting: verify through flash
    # prefill (B1) and, with prefill dense, through split paged attention
    # at QS=5 (B3), both at qpk 7.
    for label, over, paths, verify, rec in (
            ("spec_k 4", {}, ("flash", "fused"), "flash_prefill_attention",
             "flash_prefill_verify_qpk7"),
            ("spec_k 4, prefill dense", {"prefill_path": "dense"},
             ("dense", "fused"), "paged_verify_attention_pallas",
             "paged_attn_verify_qpk7")):
        eng, ids, _, tok_s, spec = spec_run(
            torch, st, model, prompts, f"{cfg.name} bf16 {label}",
            dict(over, spec_k=4, spec_min_accept=0.0), 32, paths, (verify,),
            phase=9)
        check(eng._verify_attn is getattr(pa, verify),
              f"{cfg.name} spec verify path {eng._verify_attn}")
        st["launches"][rec] = spec_report(
            torch, eng, f"{cfg.name} bf16 {label}", ids, ref_ids, tok_s,
            ref_tok_s, spec, verify, phase=9)
        del eng
        torch.cuda.empty_cache()
    del model
    torch.cuda.empty_cache()


def dequantized(torch, qmodel):
    """The bf16 model whose weights are ``qmodel``'s int8 codes times their
    scales."""
    from k8s_llm_monitor_tpu_torch.models import llama

    m = llama.LlamaModel(dataclasses.replace(qmodel.cfg, act_quant=False),
                         device=qmodel.device, seed=None)
    pairs = [(qmodel.embed, m.embed)]
    if qmodel.lm_head is not None:
        pairs.append((qmodel.lm_head, m.lm_head))
    with torch.no_grad():
        m.final_norm.copy_(qmodel.final_norm)
        for src, dst in zip(qmodel.layers, m.layers):
            dst.input_norm.copy_(src.input_norm)
            dst.post_norm.copy_(src.post_norm)
            pairs += [(getattr(src, n), getattr(dst, n))
                      for n in ("q", "k", "v", "o", "gate", "up", "down")]
        for src, dst in pairs:
            dst.weight.copy_(src.weight_q.float() * src.scale[:, None])
            if getattr(src, "bias", None) is not None:
                dst.bias.copy_(src.bias)
    return m


def phase9b(torch, np, st):
    """int8 and W8A8 weights at llama-1b width."""
    from k8s_llm_monitor_tpu_torch.models import llama
    from k8s_llm_monitor_tpu_torch.models.config import LLAMA_1B
    from k8s_llm_monitor_tpu_torch.serving.engine import SamplingParams
    from k8s_llm_monitor_tpu_torch.utils.quantize import (
        init_params_quantized, param_bytes)

    cfg, gpu = LLAMA_1B, st["gpu"]
    t0 = time.monotonic()
    qmodel = init_params_quantized(cfg, seed=4)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    w8a8 = truncated(qmodel, cfg.num_layers, act_quant=True)
    bf16 = dequantized(torch, qmodel)
    print(f"phase 9: {cfg.name} int8 weights from a seed in {init_s:.2f} s: "
          f"int8 {param_bytes(qmodel)} B, the same weights dequantized to "
          f"bf16 {param_bytes(bf16)} B [{gpu}]")
    rng = np.random.default_rng(2)
    lens = st.get("prompt_lens") or prompt_lengths(np.random.default_rng(2))
    prompts = [[int(t) for t in rng.integers(3, cfg.vocab_size, size=n)]
               for n in lens]
    kernels = {"fused_decode_d64": "paged_decode_attention_fused"}
    # The int8 products the W8A8 engines ask for, by (rows, in, out).
    shapes = set()
    int8_matmul = llama._int8_matmul

    def recorded(x_q, w_q):
        shapes.add((x_q.numel() // x_q.shape[-1], x_q.shape[-1],
                    w_q.shape[0]))
        return int8_matmul(x_q, w_q)

    tok_s, ids = {}, {}
    llama._int8_matmul = recorded
    try:
        for label, model in (("bf16", bf16), ("int8", qmodel),
                             ("W8A8", w8a8)):
            for setting in ("graph", "eager"):
                if label == "bf16" and setting == "eager":
                    continue
                eng, ids[label, setting], _, _, t = run_engine(
                    torch, st, model, prompts, f"{cfg.name} {label} weights "
                    f"{setting}", SETTINGS[setting], ("dense", "fused"),
                    kernels, phase=9)
                if setting == "graph":
                    tok_s[label] = t
                    check(eng.graph_captures > 0,
                          f"{label}: no decode graph captured")
                    # Where a decode step's device time goes with these
                    # weights (the int8 products, the casts, attention).
                    trace_decode(torch, eng, prompts,
                                 SamplingParams(max_tokens=32),
                                 ids[label, setting], st,
                                 f"{cfg.name} {label} weights",
                                 FUSED_KERNELS, phase=9)
                del eng
                torch.cuda.empty_cache()
            if label != "bf16":
                check(ids[label, "graph"] == ids[label, "eager"],
                      f"{label} weights: the graphs' ids differ from the "
                      "eager loop's")
    finally:
        llama._int8_matmul = int8_matmul
    check(shapes, "the W8A8 engines made no int8 product")
    # Each shape: the int32 product of random codes equals a float64
    # product of the same codes (exact: |sums| < 2^53).
    gen = torch.Generator(device="cuda").manual_seed(9)
    for m, k, n in sorted(shapes):
        x = torch.randint(-127, 128, (m, k), generator=gen, device="cuda",
                          dtype=torch.int8)
        w = torch.randint(-127, 128, (n, k), generator=gen, device="cuda",
                          dtype=torch.int8)
        got = llama._int8_matmul(x, w)
        want = x.double() @ w.double().t()
        check(got.dtype == torch.int32 and torch.equal(got.double(), want),
              f"_int_mm at ({m}, {k}) x ({k}, {n}) is not exact")
    print(f"phase 9: torch._int_mm exact against float64 at the "
          f"{len(shapes)} (rows, in, out) shapes the W8A8 engines called: "
          f"{sorted(shapes)}")
    # 4 layers: the int8 and W8A8 logits against the dequantized bf16
    # model's, cosine per position.
    toks = torch.from_numpy(rng.integers(3, cfg.vocab_size, size=(4, 128))
                            .astype(np.int32)).cuda()
    want = llama.forward_full(truncated(bf16, 4), toks)
    for label, model in (("int8", qmodel), ("W8A8", w8a8)):
        got = llama.forward_full(truncated(model, 4), toks)
        cos = (got * want).sum(-1) / (got.norm(dim=-1) * want.norm(dim=-1))
        print(f"phase 9: 4-layer {cfg.name} {label} weights vs the "
              f"dequantized bf16 model: logit cosine per position min "
              f"{float(cos.min()):.5f} mean {float(cos.mean()):.5f} (at "
              f"least 0.98); argmax agreement "
              f"{float((got.argmax(-1) == want.argmax(-1)).float().mean()):.3f}")
        check(float(cos.min()) >= 0.98, f"{label}: logit cosine "
                                        f"{float(cos.min()):.4f}")
    print(f"phase 9: {cfg.name} weights bf16 / int8 / W8A8: "
          f"{param_bytes(bf16)} / {param_bytes(qmodel)} / "
          f"{param_bytes(w8a8)} B; warm decode {tok_s['bf16']:.1f} / "
          f"{tok_s['int8']:.1f} / {tok_s['W8A8']:.1f} tok/s (32 slots, "
          f"phase 2's 16 prompts, 32 new tokens, decode graphs) [{gpu}]")
    del qmodel, w8a8, bf16
    torch.cuda.empty_cache()


# safetensors dtype names of the tensors phase 9c writes.
ST_DTYPES = {"BF16": "bfloat16", "F32": "float32"}


def write_safetensors(torch, path, tensors):
    """A safetensors file of ``tensors`` (name -> tensor), in the format's
    layout: an 8-byte little-endian header length, a JSON header of dtype,
    shape and data offsets (padded to 8 bytes), then the raw bytes."""
    import struct

    names = {getattr(torch, v): k for k, v in ST_DTYPES.items()}
    header, offset = {}, 0
    for key, t in tensors.items():
        n = t.numel() * t.element_size()
        header[key] = {"dtype": names[t.dtype], "shape": list(t.shape),
                       "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in tensors.values():
            f.write(t.detach().cpu().contiguous().reshape(-1)
                    .view(torch.uint8).numpy())
    return offset


def hf_state(model):
    """``model``'s weights under the HF Llama names."""
    from k8s_llm_monitor_tpu_torch.utils.checkpoint import _LINEAR_MAP

    state = {"model.embed_tokens.weight": model.embed.weight,
             "model.norm.weight": model.final_norm,
             "lm_head.weight": model.lm_head.weight}
    for i, layer in enumerate(model.layers):
        pre = f"model.layers.{i}."
        state[pre + "input_layernorm.weight"] = layer.input_norm
        state[pre + "post_attention_layernorm.weight"] = layer.post_norm
        for ours, theirs in _LINEAR_MAP.items():
            state[f"{pre}{theirs}.weight"] = getattr(layer, ours).weight
    return state


def phase9c(torch, np, st):
    """A bf16 HF checkpoint of llama-1b's shape on disk, read back."""
    import importlib.util
    import shutil
    import tempfile
    from pathlib import Path

    from k8s_llm_monitor_tpu_torch.models import llama
    from k8s_llm_monitor_tpu_torch.models.config import LLAMA_1B
    from k8s_llm_monitor_tpu_torch.monitor.analysis import LocalEngineBackend
    from k8s_llm_monitor_tpu_torch.monitor.config import TPULLMConfig
    from k8s_llm_monitor_tpu_torch.serving.engine import (
        EngineConfig, InferenceEngine, SamplingParams)
    from k8s_llm_monitor_tpu_torch.utils.checkpoint import load_hf_checkpoint
    from k8s_llm_monitor_tpu_torch.utils.quantize import quantize_params

    cfg, gpu = LLAMA_1B, st["gpu"]
    model = llama.LlamaModel(cfg, seed=6)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    try:
        # Index-sharded, shards of at most 1 GiB, as save_pretrained lays
        # them out.
        t0 = time.monotonic()
        shards, cur, size = [], {}, 0
        for key, t in hf_state(model).items():
            n = t.numel() * t.element_size()
            if cur and size + n > 2 ** 30:
                shards.append(cur)
                cur, size = {}, 0
            cur[key] = t
            size += n
        shards.append(cur)
        weight_map, total = {}, 0
        for i, shard in enumerate(shards):
            fname = f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
            total += write_safetensors(torch, tmp / fname, shard)
            weight_map.update({k: fname for k in shard})
        (tmp / "model.safetensors.index.json").write_text(json.dumps(
            {"metadata": {"total_size": total}, "weight_map": weight_map}))
        (tmp / "config.json").write_text(json.dumps({
            "model_type": "llama", "architectures": ["LlamaForCausalLM"],
            "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
            "intermediate_size": cfg.intermediate_size,
            "num_hidden_layers": cfg.num_layers,
            "num_attention_heads": cfg.num_heads,
            "num_key_value_heads": cfg.num_kv_heads,
            "head_dim": cfg.head_dim_, "rope_theta": cfg.rope_theta,
            "rms_norm_eps": cfg.rms_norm_eps,
            "max_position_embeddings": cfg.max_seq_len,
            "tie_word_embeddings": False, "torch_dtype": "bfloat16"}))
        print(f"phase 9: wrote {cfg.name} as {len(shards)} bf16 safetensors "
              f"shards, {total} B, in {time.monotonic() - t0:.1f} s")
        torch.cuda.synchronize()
        t0 = time.monotonic()
        lcfg, loaded = load_hf_checkpoint(tmp)
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
        check(dataclasses.replace(lcfg, name=cfg.name) == cfg,
              f"config.json read back as {lcfg}")
        want = model.state_dict()
        got = loaded.state_dict()
        check(got.keys() == want.keys()
              and all(torch.equal(got[k], want[k]) for k in want),
              "a tensor read back differs from the one written")
        print(f"phase 9: load_hf_checkpoint (bf16): {len(got)} tensors "
              f"bit for bit, {secs:.2f} s, {total / secs / 1e9:.2f} GB/s "
              f"[{gpu}]")
        del got, loaded
        t0 = time.monotonic()
        _, qloaded = load_hf_checkpoint(tmp, quantize=True)
        torch.cuda.synchronize()
        qsecs = time.monotonic() - t0
        ref = quantize_params(model)
        got, want = qloaded.state_dict(), ref.state_dict()
        check(got.keys() == want.keys()
              and all(torch.equal(got[k], want[k]) for k in want),
              "the quantized load differs from quantize_params")
        print(f"phase 9: load_hf_checkpoint (quantize=True): codes and "
              f"scales equal quantize_params of the written model, "
              f"{qsecs:.2f} s, {total / qsecs / 1e9:.2f} GB/s read [{gpu}]")
        del got, want, qloaded, ref
        torch.cuda.empty_cache()
        # Greedy ids of the loaded weights equal the in-memory model's.
        _, loaded = load_hf_checkpoint(tmp)
        rng = np.random.default_rng(9)
        prompts = [[int(t) for t in rng.integers(3, cfg.vocab_size, size=n)]
                   for n in (50, 120, 200, 400)]
        ecfg = EngineConfig(max_slots=8, num_blocks=512, block_size=16,
                            max_blocks_per_seq=64, prefix_cache_entries=0)
        ids = [[r.token_ids for r in InferenceEngine(cfg, m, ecfg).generate(
                    prompts, SamplingParams(max_tokens=16))]
               for m in (model, loaded)]
        check(ids[0] == ids[1], "the loaded weights' greedy ids differ")
        print(f"phase 9: an engine on the loaded weights gives the "
              f"in-memory model's greedy ids ({len(prompts)} prompts, 16 "
              "tokens)")
        del loaded
        torch.cuda.empty_cache()
        if importlib.util.find_spec("transformers") is None:
            # from_config with a checkpoint loads its HF tokenizer, which
            # needs transformers: it raises, and no ByteTokenizer serves in
            # its place.
            raised = None
            try:
                LocalEngineBackend.from_config(TPULLMConfig(
                    checkpoint=str(tmp), quantize="", spec_k=0,
                    kv_blocks=64, max_batch=2))
            except ModuleNotFoundError as exc:
                raised = exc
            check(raised is not None and "transformers" in str(raised),
                  f"from_config with a checkpoint and no transformers: "
                  f"{raised!r}")
            print(f"phase 9: from_config with a checkpoint and no "
                  f"transformers raises: {raised!r}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        del model
        torch.cuda.empty_cache()


def phase9(torch, np, st):
    free_model(torch, st)
    phase9a(torch, np, st)
    phase9b(torch, np, st)
    phase9c(torch, np, st)


SOURCES = {
    "flash_prefill": "k8s_llm_monitor_tpu_torch/csrc/flash_prefill.cu",
    "fused_decode": "k8s_llm_monitor_tpu_torch/csrc/fused_decode.cu",
    "paged_attn": "k8s_llm_monitor_tpu_torch/csrc/paged_attn.cu",
}


def kernel_record(st, name, shape, ms, plain_ms, lib_ms, b_ms, by):
    """One entry of the ``kernels`` line (its launches are read in main()
    once every phase has run)."""
    st.setdefault("records", []).append(dict(
        name=name, shape=shape, route="cuda",
        source=SOURCES["_".join(name.split("_")[:2])],
        replaces="k8s_llm_monitor_tpu/ops/pallas_attention.py:"
                 f"{replaces(name)}",
        launches=None,
        max_abs_err=st.get("max_abs_err", {}).get(name),
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
        library_ms=lib_ms))


def replaces(name: str) -> int:
    """The line of k8s_llm_monitor_tpu/ops/pallas_attention.py whose
    function reaches the pl.pallas_call that the record's kernel replaces
    (records are named <kernel>[_int8|_fp8|_e4m3][_verify][_d64|_qpk7];
    e4m3, the unscaled fp8 pool, runs B2, not B4)."""
    if name.startswith("fused_decode"):
        return 822 if ("_int8" in name or "_fp8" in name) else 471
    return {"flash_prefill": 1150, "paged_attn": 190}[
        "_".join(name.split("_")[:2])]


def sdpa_args(torch, q, kp, vp, table, ctx_max, mask, scales):
    """q, K, V and mask for one SDPA call: K/V gathered (and dequantized,
    or an fp8 pool widened, to bf16) beforehand, heads repeated,
    batch-head major."""
    from k8s_llm_monitor_tpu_torch.ops.attention import (
        gather_dequant, gather_pages, widen_pages)

    B, _, nh, d = q.shape
    nkv = kp.shape[-1] // d
    nb = (ctx_max + BS - 1) // BS
    if scales:
        k = gather_dequant(kp, scales["k_scale"], table[:, :nb], d)
        v = gather_dequant(vp, scales["v_scale"], table[:, :nb], d)
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    else:
        k = widen_pages(gather_pages(kp, table[:, :nb])).reshape(B, -1, nkv, d)
        v = widen_pages(gather_pages(vp, table[:, :nb])).reshape(B, -1, nkv, d)
    k, v = k[:, :ctx_max], v[:, :ctx_max]
    rep = nh // nkv
    k = k.repeat_interleave(rep, 2).transpose(1, 2).contiguous()
    v = v.repeat_interleave(rep, 2).transpose(1, 2).contiguous()
    return q.transpose(1, 2).contiguous(), k, v, mask[:, None]


def phase4(torch, np, st):
    import torch.nn.functional as F

    from k8s_llm_monitor_tpu_torch.ops import paged_attention as pa
    from k8s_llm_monitor_tpu_torch.ops.attention import paged_verify_attention

    rng = np.random.default_rng(4)
    gen = torch.Generator(device="cuda").manual_seed(4)
    lens = st.get("prompt_lens") or prompt_lengths(np.random.default_rng(2))
    def record(*args):
        kernel_record(st, *args)

    def sdpa_inputs(*args):
        return sdpa_args(torch, *args)

    # flash prefill: an admission round of 8 prompts (the 8 shortest of
    # phase 2's, bucket 1024), a 2048 chunk, and a prefix-hit admission
    # round (HIT_SHAPE, phase 7a's).
    shapes = [("admission", 1024, [0] * 8, [min(n, 1024) for n in lens[:8]]),
              ("chunk", 2048, [0], [2048]),
              ("hit", 256, *HIT_SHAPE)]
    for kvq in ("",) + QUANTS if wanted(st, "flash_prefill") else ():
        name = f"flash_prefill_{kvq}" if kvq else "flash_prefill"
        for label, S, starts, lengths in shapes:
            if kvq:
                case, scales = quant_prefill_case(
                    torch, rng, gen, len(starts), S, starts, lengths, kvq)
            else:
                case, scales = prefill_case(torch, rng, gen, len(starts), S,
                                            starts, lengths), {}
            q = case[0]
            ms = time_ms(torch, lambda: pa.flash_prefill_attention(
                *case, **scales))
            alone_ms = time_ms(torch, flash_alone(torch, pa, case, scales))
            plain_ms = time_ms(torch, lambda: pa.flash_prefill_attention_plain(
                *case, **scales), reps=5)
            ctx_max = max(s + n for s, n in zip(starts, lengths))
            pos = (torch.arange(S, device="cuda")[None, :, None]
                   + case[4][:, None, None])
            keys = torch.arange(ctx_max, device="cuda")[None, None, :]
            qs, k, v, m = sdpa_inputs(q * D ** -0.5, case[1], case[2],
                                      case[3], ctx_max, keys <= pos, scales)
            lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
                qs, k, v, attn_mask=m, scale=1.0), reps=5)
            b_ms, by = bound(*prefill_work(starts, lengths, S, kvq))
            print(f"phase 4: {name} {label} B={len(starts)} S={S} "
                  f"lengths={lengths}: kernel {ms:.4f} ms (alone, on "
                  f"pre-scaled q: {alone_ms:.4f} ms), plain {plain_ms:.4f} "
                  f"ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({by}) "
                  f"[{st['gpu']}]")
            record(name, label, ms, plain_ms, lib_ms, b_ms, by)
            del case, k, v, qs
            torch.cuda.empty_cache()

    # fused decode: phase 2's 16 requests mid-decode in 32 slots (16 idle
    # lanes at pos 0), and a full batch of mixed contexts, both over the
    # engine's table width (the grid phase 2 launches).  At the engine
    # shape every instance is also timed at other chunk sizes.
    mid = [n + 16 for n in lens] + [0] * (32 - len(lens))
    full = [int(x) for x in rng.integers(1, 2048, size=32)]
    nbl = ENGINE_TABLE
    for kvq in ("",) + QUANTS if wanted(st, "fused_decode") else ():
        name = f"fused_decode_{kvq}" if kvq else "fused_decode"
        for label, positions in (("engine", mid), ("full", full)):
            if kvq:
                case = quant_decode_case(torch, rng, gen, positions, nbl, kvq)
                kernel = pa.paged_decode_attention_fused_quant
                plain = pa.paged_decode_attention_fused_quant_plain
                kp, vp, table, pos_t = case[5], case[6], case[9], case[10]
                scales = dict(k_scale=case[7], v_scale=case[8])
            else:
                case = decode_case(torch, rng, gen, positions, nbl)
                kernel = pa.paged_decode_attention_fused
                plain = pa.paged_decode_attention_fused_plain
                kp, vp, table, pos_t = case[5], case[6], case[7], case[8]
                scales = {}
            ms = time_ms(torch, lambda: kernel(*case), rounds=5)
            alone_ms = graph_ms(torch, decode_alone(torch, pa, case))
            plain_ms = time_ms(torch, lambda: plain(*case), reps=5)
            ctx_max = max(positions) + 1
            keys = torch.arange(ctx_max, device="cuda")[None, None, :]
            qs, k, v, m = sdpa_inputs(case[0], kp, vp, table, ctx_max,
                                      keys <= pos_t[:, None, None], scales)
            lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
                qs, k, v, attn_mask=m), reps=5)
            b_ms, by = bound(*decode_work(positions, kvq))
            nsplit, chunk = pa.decode_splits(nbl, BS, kp.element_size())
            print(f"phase 4: {name} {label} B=32 active="
                  f"{sum(p > 0 for p in positions)} max pos {max(positions)} "
                  f"table {nbl}x{BS} ({nsplit} splits of {chunk}): kernel "
                  f"{ms:.4f} ms (alone: {alone_ms:.4f} ms), plain "
                  f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} "
                  f"ms, bound {b_ms:.4f} ms ({by}) [{st['gpu']}]")
            record(name, label, ms, plain_ms, lib_ms, b_ms, by)
            if label == "engine":
                sweep, chunk0 = {}, pa.DECODE_CHUNK
                for c in (128, 256, 512):
                    pa.DECODE_CHUNK = {2: c, 1: c}
                    try:
                        sweep[c] = graph_ms(torch, decode_alone(torch, pa,
                                                                case))
                    finally:
                        pa.DECODE_CHUNK = chunk0
                print(f"phase 4: {name} engine chunk sweep (alone): "
                      + ", ".join(f"{c} keys {t:.4f} ms"
                                  for c, t in sweep.items())
                      + f" [{st['gpu']}]")
            del case, k, v, qs
            torch.cuda.empty_cache()

    # split paged attention over the engine's 256-block table: the
    # decode_path="pallas" engine's shape (the 16 requests mid-decode,
    # idle lanes at length 1: the null block) and a verify shape (the same
    # lanes with spec_k 7: 8 query tokens ending at the engine position,
    # idle lanes empty); each alone (a replayed CUDA graph) at chunks of
    # 128, 256 and 512 keys too.
    if wanted(st, "paged_attn"):
        nbl = ENGINE_TABLE
        q1, _, _, _, _, kp, vp, table, _ = decode_case(torch, rng, gen, mid,
                                                       nbl)
        q8 = torch.randn(32, 8, H, D, generator=gen,
                         device="cuda").to(torch.bfloat16)
        lengths = [p + 1 for p in mid]
        vstarts = [max(p - 7, 0) for p in mid]
        vqlens = [8 if p > 0 else 0 for p in mid]
        dev_i = dict(dtype=torch.int32, device="cuda")
        len_t = torch.tensor(lengths, **dev_i)
        vst_t, vql_t = torch.tensor(vstarts, **dev_i), torch.tensor(vqlens,
                                                                    **dev_i)
        cases = (
            ("engine", q1, dict(lengths=len_t),
             lambda: pa.paged_decode_attention_pallas(q1, kp, vp, table,
                                                      len_t),
             ((len_t - 1).clamp(min=0), len_t.clamp(max=1)),
             ([n - 1 for n in lengths], [1] * len(lengths))),
            ("verify", q8, dict(starts=vst_t, qlens=vql_t),
             lambda: pa.paged_verify_attention_pallas(q8, kp, vp, table,
                                                      vst_t, vql_t),
             (vst_t, vql_t), (vstarts, vqlens)),
        )
        for label, q, lanes, wrapper, (st_t, ql_t), (sts, qls) in cases:
            QS = q.shape[1]
            ms = time_ms(torch, wrapper, rounds=5)
            alone_ms = graph_ms(torch, paged_alone(torch, pa, q, kp, vp, table,
                                                   **lanes))
            plain_ms = time_ms(torch, lambda: pa.flash_prefill_attention_plain(
                q, kp, vp, table, st_t, ql_t), reps=5)
            ctx_max = max(s + n for s, n in zip(sts, qls))
            pos = (torch.arange(QS, device="cuda")[None, :, None]
                   + st_t[:, None, None])
            keys = torch.arange(ctx_max, device="cuda")[None, None, :]
            qs, k, v, m = sdpa_inputs(q * D ** -0.5, kp, vp, table, ctx_max,
                                      keys <= pos, {})
            lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
                qs, k, v, attn_mask=m, scale=1.0), reps=5)
            b_ms, by = bound(*paged_attn_work(sts, qls))
            nsplit, chunk = pa.decode_splits(nbl, BS, 2)
            rname = "paged_attn" + ("_verify" if QS > 1 else "")
            print(f"phase 4: {rname} {label} B=32 QS={QS} active="
                  f"{sum(n > 0 for n in qls)} max length {ctx_max} table "
                  f"{nbl}x{BS} ({nsplit} splits of {chunk}): kernel {ms:.4f} "
                  f"ms (alone: {alone_ms:.4f} ms), plain {plain_ms:.4f} ms, "
                  f"sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({by}) "
                  f"[{st['gpu']}]")
            record(rname, label, ms, plain_ms, lib_ms, b_ms, by)
            sweep, chunk0 = {}, pa.DECODE_CHUNK
            for c in (128, 256, 512):
                pa.DECODE_CHUNK = {2: c, 1: c}
                try:
                    sweep[c] = graph_ms(torch, paged_alone(
                        torch, pa, q, kp, vp, table, **lanes))
                finally:
                    pa.DECODE_CHUNK = chunk0
            print(f"phase 4: paged_attn {label} chunk sweep (alone): "
                  + ", ".join(f"{c} keys {t:.4f} ms" for c, t in sweep.items())
                  + f"; sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} ms "
                  f"[{st['gpu']}]")
            del qs, k, v, m
        del q1, q8, kp, vp, table
        torch.cuda.empty_cache()

    # head_dim 64 (llama-1b, phase 8's engine shape: 32 slots, the 16
    # requests mid-decode, the 256-block table) and Qwen2-7B's 28 / 4 heads
    # (qpk 7, phase 9's engine shape): fused decode over bf16, int8 and fp8
    # pools (qpk 7: bf16 and int8), split paged attention at QS=1
    # (decode_path "pallas") and at QS=5 (spec verify from each lane's
    # position).
    geometries = ((HEADS_1B, D64, "_d64", ("",) + QUANTS),
                  (HEADS_QWEN, D, "_qpk7", ("", "int8")))
    for heads, d, sfx, kvqs in geometries:
        for kvq in kvqs if wanted(st, "fused_decode") else ():
            name = (f"fused_decode_{kvq}" if kvq else "fused_decode") + sfx
            if kvq:
                case = quant_decode_case(torch, rng, gen, mid, nbl, kvq,
                                         heads, BS, d)
                kernel = pa.paged_decode_attention_fused_quant
                plain = pa.paged_decode_attention_fused_quant_plain
                kp, vp, table, pos_t = case[5], case[6], case[9], case[10]
                scales = dict(k_scale=case[7], v_scale=case[8])
            else:
                case = decode_case(torch, rng, gen, mid, nbl, heads, BS, d)
                kernel = pa.paged_decode_attention_fused
                plain = pa.paged_decode_attention_fused_plain
                kp, vp, table, pos_t = case[5], case[6], case[7], case[8]
                scales = {}
            ms = time_ms(torch, lambda: kernel(*case), rounds=5)
            alone_ms = graph_ms(torch, decode_alone(torch, pa, case))
            plain_ms = time_ms(torch, lambda: plain(*case), reps=5)
            ctx_max = max(mid) + 1
            keys = torch.arange(ctx_max, device="cuda")[None, None, :]
            qs, k, v, m = sdpa_inputs(case[0], kp, vp, table, ctx_max,
                                      keys <= pos_t[:, None, None], scales)
            lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
                qs, k, v, attn_mask=m), reps=5)
            b_ms, by = bound(*decode_work(mid, kvq, heads, d))
            nsplit, chunk = pa.decode_splits(nbl, BS, kp.element_size())
            print(f"phase 4: {name} engine B=32 active="
                  f"{sum(p > 0 for p in mid)} max pos {max(mid)} "
                  f"H={heads[0]} KVH={heads[1]} D={d} table {nbl}x{BS} "
                  f"({nsplit} splits of {chunk}): kernel {ms:.4f} ms (alone: "
                  f"{alone_ms:.4f} ms), plain {plain_ms:.4f} ms, sdpa "
                  f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({by}) "
                  f"[{st['gpu']}]")
            record(name, "engine", ms, plain_ms, lib_ms, b_ms, by)
            del case, k, v, qs
            torch.cuda.empty_cache()
        if not wanted(st, "paged_attn"):
            continue
        dev_i = dict(dtype=torch.int32, device="cuda")
        q1, _, _, _, _, kp, vp, table, _ = decode_case(
            torch, rng, gen, mid, nbl, heads, BS, d)
        q5 = torch.randn(32, 5, heads[0], d, generator=gen,
                         device="cuda").to(torch.bfloat16)
        len_t = torch.tensor([p + 1 for p in mid], **dev_i)
        vst = [p if p > 0 else 0 for p in mid]
        vql = [5 if p > 0 else 0 for p in mid]
        vst_t, vql_t = torch.tensor(vst, **dev_i), torch.tensor(vql, **dev_i)
        cases = (
            ("paged_attn" + sfx, "engine", q1, dict(lengths=len_t),
             lambda: pa.paged_decode_attention_pallas(q1, kp, vp, table,
                                                      len_t),
             ((len_t - 1).clamp(min=0), len_t.clamp(max=1)),
             ([p for p in mid], [1] * len(mid))),
            ("paged_attn_verify" + sfx, "verify", q5,
             dict(starts=vst_t, qlens=vql_t),
             lambda: pa.paged_verify_attention_pallas(q5, kp, vp, table,
                                                      vst_t, vql_t),
             (vst_t, vql_t), (vst, vql)),
        )
        for name, label, q, lanes, wrapper, (st_t, ql_t), (sts, qls) in cases:
            QS = q.shape[1]
            ms = time_ms(torch, wrapper, rounds=5)
            alone_ms = graph_ms(torch, paged_alone(torch, pa, q, kp, vp,
                                                   table, **lanes))
            plain_ms = time_ms(torch, lambda: pa.flash_prefill_attention_plain(
                q, kp, vp, table, st_t, ql_t), reps=5)
            ctx_max = max(s + n for s, n in zip(sts, qls))
            pos = (torch.arange(QS, device="cuda")[None, :, None]
                   + st_t[:, None, None])
            keys = torch.arange(ctx_max, device="cuda")[None, None, :]
            qs, k, v, m = sdpa_inputs(q * d ** -0.5, kp, vp, table, ctx_max,
                                      keys <= pos, {})
            lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
                qs, k, v, attn_mask=m, scale=1.0), reps=5)
            b_ms, by = bound(*paged_attn_work(sts, qls, heads, d))
            print(f"phase 4: {name} {label} B=32 QS={QS} active="
                  f"{sum(n > 0 for n in qls)} max length {ctx_max} "
                  f"H={heads[0]} KVH={heads[1]} D={d} table "
                  f"{nbl}x{BS}: kernel {ms:.4f} ms (alone: {alone_ms:.4f} "
                  f"ms), plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, "
                  f"bound {b_ms:.4f} ms ({by}) [{st['gpu']}]")
            record(name, label, ms, plain_ms, lib_ms, b_ms, by)
            del qs, k, v, m
        # The verify threshold (the JAX package gathers under 2,048
        # tokens; the port has none): the kernel against the gather path it
        # replaces, over tables of 1,024 and 4,096 tokens, the same 16
        # lanes capped to the table.
        for width in (64, 256) if d == D64 else ():
            cap = width * BS - 5
            vs = [min(p, cap) if p > 0 else 0 for p in mid]
            vs_t = torch.tensor(vs, **dev_i)
            tab = table[:, :width].contiguous()
            k_ms = time_ms(torch, lambda: pa.paged_verify_attention_pallas(
                q5, kp, vp, tab, vs_t, vql_t), rounds=5)
            g_ms = time_ms(torch, lambda: paged_verify_attention(
                q5, kp, vp, tab, vs_t, vql_t), reps=5, rounds=3)
            print(f"phase 4: verify threshold: table {width}x{BS} = "
                  f"{width * BS} tokens, B=32 QS=5 active 16, D={d}: "
                  f"split paged attention {k_ms:.4f} ms, gather "
                  f"(paged_verify_attention) {g_ms:.4f} ms [{st['gpu']}]")
        del q1, q5, kp, vp, table
        torch.cuda.empty_cache()

    # Flash prefill at the verify shape (spec_k + 1 = 5 query tokens from
    # each lane's position, phase 8's 16 requests mid-decode in 32 slots):
    # the spec verify of the Llama-3-8B engines (B1 on bf16, B5 on int8
    # pools) and of Qwen2-7B's (bf16, qpk 7); and at Qwen2-7B's heads the
    # admission round of the first shape above (bf16, int8).
    vstarts = [p if p > 0 else 0 for p in mid]
    vlens = [5 if p > 0 else 0 for p in mid]
    verify = ("verify", 5, vstarts, vlens)
    admission = ("admission", *shapes[0][1:])
    flash_cases = (((H, KVH), "", verify), ((H, KVH), "int8", verify),
                   (HEADS_QWEN, "", verify), (HEADS_QWEN, "", admission),
                   (HEADS_QWEN, "int8", admission))
    for heads, kvq, (label, S, starts, lengths) in flash_cases if wanted(
            st, "flash_prefill") else ():
        name = ((f"flash_prefill_{kvq}" if kvq else "flash_prefill")
                + ("_verify" if label == "verify" else "")
                + qpk_suffix(heads, D))
        B = len(starts)
        if kvq:
            case, scales = quant_prefill_case(torch, rng, gen, B, S, starts,
                                              lengths, kvq, heads)
        else:
            case, scales = prefill_case(torch, rng, gen, B, S, starts,
                                        lengths, heads), {}
        ms = time_ms(torch, lambda: pa.flash_prefill_attention(
            *case, **scales), rounds=5)
        alone_ms = time_ms(torch, flash_alone(torch, pa, case, scales),
                           rounds=5)
        plain_ms = time_ms(torch, lambda: pa.flash_prefill_attention_plain(
            *case, **scales), reps=5)
        ctx_max = max(s + n for s, n in zip(starts, lengths))
        pos = (torch.arange(S, device="cuda")[None, :, None]
               + case[4][:, None, None])
        keys = torch.arange(ctx_max, device="cuda")[None, None, :]
        qs, k, v, m = sdpa_inputs(case[0] * D ** -0.5, case[1], case[2],
                                  case[3], ctx_max, keys <= pos, scales)
        lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qs, k, v, attn_mask=m, scale=1.0), reps=5)
        b_ms, by = bound(*prefill_work(starts, lengths, S, kvq, heads))
        print(f"phase 4: {name} {label} B={B} S={S} H={heads[0]} "
              f"KVH={heads[1]} active {sum(n > 0 for n in lengths)} max "
              f"length {ctx_max}: kernel {ms:.4f} ms (alone, on pre-scaled "
              f"q: {alone_ms:.4f} ms), plain {plain_ms:.4f} ms, sdpa "
              f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({by}) [{st['gpu']}]")
        record(name, label, ms, plain_ms, lib_ms, b_ms, by)
        del case, k, v, qs
        torch.cuda.empty_cache()

    for label, (steps, dsteps) in st.get("engine_steps", {}).items():
        per = {k: round(v / steps, 2) for k, v in st["launches"].items()
               if k in dict((e[0], e[3]) for e in ENGINES)[label]}
        print(f"phase 4: {label} engine: launches per engine step {per} over "
              f"{steps} steps ({dsteps} decode steps x 32 layers)")


# ---------------------------------------------------------------- phase 10
# The unscaled fp8 pool (ModelConfig.kv_dtype = "float8_e4m3fn", ROADMAP
# B8) and the KV tiers (A5).

FP8_KV = "float8_e4m3fn"
# e4m3fn's rounding edge (448 is its largest value, 464 the midpoint to the
# NaN code), infinities, NaNs, subnormals and their halves.
E4M3_EDGE = [0.0, -0.0, 1.0, 448.0, 449.0, 460.0, 464.0, 464.00003, 465.0,
             470.0, 480.0, 500.0, -460.0, -464.0, -470.0, -500.0, 1e30,
             float("inf"), float("-inf"), float("nan"), 2.0 ** -9,
             2.0 ** -10, 2.0 ** -10 * 1.0001, 3 * 2.0 ** -11,
             -1.5 * 2.0 ** -10, 2.0 ** -6, 1e-30]
# bf16 values past and at e4m3's edge, written into appended rows.
E4M3_ROW_EDGE = [448.0, 456.0, 464.0, 472.0, 480.0, 496.0, 512.0, -464.0,
                 -472.0, -480.0, -512.0, 2.0 ** -10]


def e4m3(torch, *pages):
    """bf16 pages as an unscaled fp8 pool, with jnp's rounding."""
    from k8s_llm_monitor_tpu_torch.models.llama import cast_e4m3

    return [cast_e4m3(p) for p in pages]


def e4m3_prefill_case(torch, rng, gen, B, S, starts, lengths, heads=(H, KVH),
                      bs=BS, d=D):
    q, kp, vp, table, st, ln = prefill_case(torch, rng, gen, B, S, starts,
                                            lengths, heads, bs, d)
    return (q, *e4m3(torch, kp, vp), table, st, ln)


def e4m3_decode_case(torch, rng, gen, positions, nbl, heads=(H, KVH), bs=BS,
                     d=D):
    q, kn, vn, cos, sin, kp, vp, table, pos = decode_case(
        torch, rng, gen, positions, nbl, heads, bs, d)
    return (q, kn, vn, cos, sin, *e4m3(torch, kp, vp), table, pos)


# 10a/10b's flash prefill shapes: phase 4's admission round, the 2048
# chunk, phase 7a's prefix-hit round and the spec verify shape.
def e4m3_prefill_shapes(lens):
    return [("admission", 1024, [0] * 8, [min(n, 1024) for n in lens[:8]]),
            ("chunk", 2048, [0], [2048]),
            ("hit", 256, *HIT_SHAPE),
            ("verify", 5, *VERIFY_SHAPE)]


def e4m3_positions(rng, chunk=128):
    """Fused decode positions: both sides of the e4m3 pool's key chunk
    boundaries, an inactive lane, one cached row, block edges, the table's
    last row and a lane past it (128 x 16 table), random contexts."""
    fixed = sorted({0, 1} | {p for c in (chunk, 2 * chunk)
                             for p in (c - 1, c, c + 1)}) + [
        15, 16, 17, 1000, 2047, 2051]
    return fixed + [int(x) for x in rng.integers(1, 2048,
                                                 size=32 - len(fixed))]


def phase10a(torch, np, st):
    """Each B8 instance against its plain version on its first call."""
    from k8s_llm_monitor_tpu_torch.models.llama import cast_e4m3
    from k8s_llm_monitor_tpu_torch.ops import paged_attention as pa

    rng = np.random.default_rng(10)
    gen = torch.Generator(device="cuda").manual_seed(10)
    errs = st.setdefault("max_abs_err", {})
    ulps = {}
    # The cast on the card gives the CPU's codes (which the CPU tests hold
    # to jnp.astype bit for bit), from float32 and from bf16.
    x = torch.cat([torch.tensor(E4M3_EDGE),
                   torch.from_numpy(rng.standard_normal(100_000)
                                    .astype(np.float32) * 3),
                   torch.from_numpy((rng.uniform(-1, 1, 50_000) * 2.0 ** (
                       rng.integers(-14, 10, 50_000))).astype(np.float32))])
    for src in (x, x.to(torch.bfloat16)):
        dev = cast_e4m3(src.cuda()).view(torch.uint8).cpu()
        check(torch.equal(dev, cast_e4m3(src).view(torch.uint8)),
              f"cast_e4m3 on the card differs from the CPU's ({src.dtype})")
    print(f"phase 10a: cast_e4m3 on the card equals the CPU's on "
          f"{x.numel()} float32 and bf16 values (edges, NaN, subnormals)")

    lens = st.get("prompt_lens") or prompt_lengths(np.random.default_rng(2))
    # B1: flash prefill over e4m3 pages at qpk 4 (Llama-3-8B) and 7
    # (Qwen2-7B); empty lanes zero.
    for heads in ((H, KVH), HEADS_QWEN):
        for label, S, starts, lengths in e4m3_prefill_shapes(lens):
            name = (f"flash_prefill_{E4M3}" + ("_verify" if label == "verify"
                                               else "")
                    + qpk_suffix(heads, D))
            case = e4m3_prefill_case(torch, rng, gen, len(starts), S, starts,
                                     lengths, heads)
            got = pa.flash_prefill_attention(*case)
            want = pa.flash_prefill_attention_plain(*case)
            torch.cuda.synchronize()
            for b, n in enumerate(lengths):
                if n == 0:
                    check(bool((got[b] == 0).all()),
                          f"{name} {label}: empty lane {b} not zeroed")
                    continue
                check_rows(torch, name, got[b, :n], want[b, :n],
                           slice(None), errs, ulps)
            print(f"phase 10a: {name} {label} H={heads[0]} KVH={heads[1]} "
                  f"S={S}: ok, max abs err {errs[name]:.4g}, max err "
                  f"{ulps[name]:.3g} ulps of the row")
            del case, got, want
    torch.cuda.empty_cache()

    # B2: fused decode, outputs, and the appended rows' bytes bit for bit
    # (the plain version casts the f32 roped row with cast_e4m3, the kernel
    # with __NV_NOSAT); then rows holding e4m3's edge values.
    for d, heads in ((D, (H, KVH)), (D, HEADS_QWEN), (D64, HEADS_1B)):
        name = f"fused_decode_{E4M3}" + ("_d64" if d == D64
                                         else qpk_suffix(heads, d))
        positions = e4m3_positions(rng)
        nbl = 128
        case = e4m3_decode_case(torch, rng, gen, positions, nbl, heads, BS, d)
        edge = torch.tensor(E4M3_ROW_EDGE, device="cuda").to(torch.bfloat16)
        edge_lanes = (2, 5, 9)
        for b in edge_lanes:         # raw k and v rows past +-464
            case[1][b, 0, :, :len(E4M3_ROW_EDGE)] = edge
            case[2][b, 0, :, :len(E4M3_ROW_EDGE)] = edge.flip(0)
        # Lane 5 ropes at angle 0 (cos 1, sin 0): its k row reaches the
        # page unrotated, the edge values included.
        case[3][5], case[4][5] = 1.0, 0.0
        pos_t = case[-1]
        covered = (pos_t > 0) & (pos_t < nbl * BS)
        ck = [t.clone() for t in case]
        cp = [t.clone() for t in case]
        got = pa.paged_decode_attention_fused(*ck)
        want = pa.paged_decode_attention_fused_plain(*cp)
        torch.cuda.synchronize()
        check(got[1].data_ptr() == ck[5].data_ptr(),
              f"{name}: pool not updated in place")
        check_rows(torch, name, got[0], want[0], covered | (pos_t == 0),
                   errs, ulps)
        diff = [int((got[i].view(torch.uint8) != want[i].view(torch.uint8))
                    .sum()) for i in (1, 2)]
        check(diff == [0, 0], f"{name}: appended bytes differ (k, v): {diff}")
        nans = int(torch.isnan(got[2].float()).sum())
        check(nans > 0, f"{name}: no NaN code appended from the edge rows")
        print(f"phase 10a: {name} H={heads[0]} KVH={heads[1]} D={d} B=32 "
              f"positions {positions[:10]}...: ok, max abs err "
              f"{errs[name]:.4g}, max err {ulps[name]:.3g} ulps of the row; "
              f"pages bit for bit ({nans} NaN codes in v from the "
              f"+-464..512 rows)")
        del case, ck, cp, got, want
    torch.cuda.empty_cache()

    # B3: split paged attention at QS=1 (decode wrapper, an empty lane)
    # and QS=5 (verify wrapper, rows past qlens and an empty lane), both
    # sides of the 128-key chunks of a 1-byte pool.
    for d, heads in ((D, (H, KVH)), (D, HEADS_QWEN), (D64, HEADS_1B)):
        sfx = "_d64" if d == D64 else qpk_suffix(heads, d)
        name = f"paged_attn_{E4M3}" + sfx
        positions = [0, 5, 1, 15, 16, 127, 128, 129, 255, 256, 257, 2047] + [
            int(x) for x in rng.integers(1, 2048, size=20)]
        nbl = 2048 // BS + 1
        q, _, _, _, _, kp, vp, table, pos = e4m3_decode_case(
            torch, rng, gen, positions, nbl, heads, BS, d)
        lens = pos + 1
        lens[1] = 0
        got = pa.paged_decode_attention_pallas(q, kp, vp, table, lens)
        want = pa.flash_prefill_attention_plain(
            q, kp, vp, table, (lens - 1).clamp(min=0), lens.clamp(max=1))
        torch.cuda.synchronize()
        check(bool((got[1] == 0).all()), f"{name}: the empty lane is not "
                                         "zeroed")
        check_rows(torch, name, got, want, lens > 0, errs, ulps)
        vname = f"paged_attn_{E4M3}_verify" + sfx
        starts = [0, 123, 124, 125, 250, 251, 252, 700, 1000, 2040, 0, 3]
        qlens = [5, 5, 5, 5, 5, 5, 5, 4, 3, 5, 0, 2]
        vcase = e4m3_prefill_case(torch, rng, gen, len(starts), 5, starts,
                                  qlens, heads, BS, d)
        got = pa.paged_verify_attention_pallas(*vcase)
        want = pa.flash_prefill_attention_plain(*vcase)
        torch.cuda.synchronize()
        for b, n in enumerate(qlens):
            check(bool((got[b, n:] == 0).all()),
                  f"{vname}: rows past qlens of lane {b} not zeroed")
            if n:
                check_rows(torch, vname, got[b, :n], want[b, :n],
                           slice(None), errs, ulps)
        print(f"phase 10a: {name} QS=1 and {vname} QS=5 H={heads[0]} "
              f"KVH={heads[1]} D={d}: ok, max abs err {errs[name]:.4g} / "
              f"{errs[vname]:.4g}, max err {ulps[name]:.3g} / "
              f"{ulps[vname]:.3g} ulps of the row")
        del q, kp, vp, table, vcase, got, want
    torch.cuda.empty_cache()
    print(f"phase 10a: tolerance atol {TOL['atol']} rtol {TOL['rtol']} and "
          f"{ULP_TOL} bf16 ulps of each (row, head)'s largest value; rows "
          "past qlens and empty lanes zero; appended bytes bit for bit")


def phase10b(torch, np, st):
    """Each B8 instance timed by phase 4's method at phase 4's shapes."""
    import torch.nn.functional as F

    from k8s_llm_monitor_tpu_torch.ops import paged_attention as pa

    rng = np.random.default_rng(11)
    gen = torch.Generator(device="cuda").manual_seed(11)
    lens = st.get("prompt_lens") or prompt_lengths(np.random.default_rng(2))
    gpu = st["gpu"]
    # Llama-3-8B's heads at every shape; Qwen2-7B's 28/4 (qpk 7) at the
    # admission and verify shapes, as phase 4 times the bf16 qpk-7 rows.
    shapes = [((H, KVH), "", shape) for shape in e4m3_prefill_shapes(lens)]
    shapes += [(HEADS_QWEN, "_qpk7", shape) for shape in
               e4m3_prefill_shapes(lens) if shape[0] in ("admission",
                                                         "verify")]
    for heads, sfx, (label, S, starts, lengths) in shapes:
        name = (f"flash_prefill_{E4M3}"
                + ("_verify" if label == "verify" else "") + sfx)
        case = e4m3_prefill_case(torch, rng, gen, len(starts), S, starts,
                                 lengths, heads)
        ms = time_ms(torch, lambda: pa.flash_prefill_attention(*case),
                     rounds=5)
        alone = time_ms(torch, flash_alone(torch, pa, case, {}), rounds=5)
        plain = time_ms(torch, lambda: pa.flash_prefill_attention_plain(
            *case), reps=5)
        ctx_max = max(s + n for s, n in zip(starts, lengths))
        pos = (torch.arange(S, device="cuda")[None, :, None]
               + case[4][:, None, None])
        keys = torch.arange(ctx_max, device="cuda")[None, None, :]
        qs, k, v, m = sdpa_args(torch, case[0] * D ** -0.5, case[1], case[2],
                                case[3], ctx_max, keys <= pos, {})
        lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qs, k, v, attn_mask=m, scale=1.0), reps=5)
        b_ms, by = bound(*prefill_work(starts, lengths, S, E4M3, heads))
        print(f"phase 10b: {name} {label} B={len(starts)} S={S} "
              f"H={heads[0]} KVH={heads[1]}: kernel "
              f"{ms:.4f} ms (alone, on pre-scaled q: {alone:.4f} ms), plain "
              f"{plain:.4f} ms, sdpa {lib:.4f} ms, bound {b_ms:.4f} ms "
              f"({by}) [{gpu}]")
        kernel_record(st, name, label, ms, plain, lib, b_ms, by)
        del case, qs, k, v, m
        torch.cuda.empty_cache()

    nbl = ENGINE_TABLE
    mid = [n + 16 for n in lens] + [0] * (32 - len(lens))
    full = [int(x) for x in rng.integers(1, 2048, size=32)]
    for d, heads, sfx, shapes in ((D, (H, KVH), "", (("engine", mid),
                                                      ("full", full))),
                                  (D64, HEADS_1B, "_d64",
                                   (("engine", mid),)),
                                  (D, HEADS_QWEN, "_qpk7",
                                   (("engine", mid),))):
        for label, positions in shapes:
            name = f"fused_decode_{E4M3}" + sfx
            case = e4m3_decode_case(torch, rng, gen, positions, nbl, heads,
                                    BS, d)
            ms = time_ms(torch, lambda: pa.paged_decode_attention_fused(
                *case), rounds=5)
            alone = graph_ms(torch, decode_alone(torch, pa, case))
            plain = time_ms(torch, lambda: pa.paged_decode_attention_fused_plain(
                *case), reps=5)
            ctx_max = max(positions) + 1
            keys = torch.arange(ctx_max, device="cuda")[None, None, :]
            qs, k, v, m = sdpa_args(torch, case[0], case[5], case[6],
                                    case[7], ctx_max,
                                    keys <= case[8][:, None, None], {})
            lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
                qs, k, v, attn_mask=m), reps=5)
            b_ms, by = bound(*decode_work(positions, E4M3, heads, d))
            nsplit, chunk = pa.decode_splits(nbl, BS, 1)
            print(f"phase 10b: {name} {label} B=32 active "
                  f"{sum(p > 0 for p in positions)} max pos {max(positions)} "
                  f"H={heads[0]} KVH={heads[1]} D={d} table {nbl}x{BS} "
                  f"({nsplit} splits of {chunk}): kernel {ms:.4f} ms (alone: "
                  f"{alone:.4f} ms), plain {plain:.4f} ms, sdpa {lib:.4f} ms, "
                  f"bound {b_ms:.4f} ms ({by}) [{gpu}]")
            kernel_record(st, name, label, ms, plain, lib, b_ms, by)
            del case, qs, k, v, m
        # Split paged attention: the pallas engine's shape (QS=1) and the
        # verify shape (QS=8 at Llama-3-8B's heads, as phase 4's; QS=5 from
        # each lane's position at head_dim 64 and at qpk 7, as phase 4's
        # rows there).
        q1, _, _, _, _, kp, vp, table, _ = e4m3_decode_case(
            torch, rng, gen, mid, nbl, heads, BS, d)
        wide = d == D and not sfx
        QS = 8 if wide else 5
        qv = torch.randn(32, QS, heads[0], d, generator=gen,
                         device="cuda").to(torch.bfloat16)
        dev_i = dict(dtype=torch.int32, device="cuda")
        len_t = torch.tensor([p + 1 for p in mid], **dev_i)
        vst = ([max(p - 7, 0) for p in mid] if wide
               else [p if p > 0 else 0 for p in mid])
        vql = [QS if p > 0 else 0 for p in mid]
        vst_t, vql_t = torch.tensor(vst, **dev_i), torch.tensor(vql, **dev_i)
        cases = (
            (f"paged_attn_{E4M3}" + sfx, "engine", q1, dict(lengths=len_t),
             lambda: pa.paged_decode_attention_pallas(q1, kp, vp, table,
                                                      len_t),
             ((len_t - 1).clamp(min=0), len_t.clamp(max=1)),
             (list(mid), [1] * len(mid))),
            (f"paged_attn_{E4M3}_verify" + sfx, "verify", qv,
             dict(starts=vst_t, qlens=vql_t),
             lambda: pa.paged_verify_attention_pallas(qv, kp, vp, table,
                                                      vst_t, vql_t),
             (vst_t, vql_t), (vst, vql)),
        )
        for name, label, q, lanes, wrapper, (st_t, ql_t), (sts, qls) in cases:
            S = q.shape[1]
            ms = time_ms(torch, wrapper, rounds=5)
            alone = graph_ms(torch, paged_alone(torch, pa, q, kp, vp, table,
                                                **lanes))
            plain = time_ms(torch, lambda: pa.flash_prefill_attention_plain(
                q, kp, vp, table, st_t, ql_t), reps=5)
            ctx_max = max(s + n for s, n in zip(sts, qls))
            pos = (torch.arange(S, device="cuda")[None, :, None]
                   + st_t[:, None, None])
            keys = torch.arange(ctx_max, device="cuda")[None, None, :]
            qs, k, v, m = sdpa_args(torch, q * d ** -0.5, kp, vp, table,
                                    ctx_max, keys <= pos, {})
            lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
                qs, k, v, attn_mask=m, scale=1.0), reps=5)
            b_ms, by = bound(*paged_attn_work(sts, qls, heads, d, 1))
            print(f"phase 10b: {name} {label} B=32 QS={S} active "
                  f"{sum(n > 0 for n in qls)} max length {ctx_max} "
                  f"H={heads[0]} KVH={heads[1]} D={d} table {nbl}x{BS}: "
                  f"kernel {ms:.4f} ms (alone: {alone:.4f} ms), plain "
                  f"{plain:.4f} ms, sdpa {lib:.4f} ms, bound {b_ms:.4f} ms "
                  f"({by}) [{gpu}]")
            kernel_record(st, name, label, ms, plain, lib, b_ms, by)
            del qs, k, v, m
        del q1, qv, kp, vp, table
        torch.cuda.empty_cache()


def fp8_model(model):
    """``model`` (weights shared) with an unscaled fp8 KV pool."""
    return truncated(model, model.cfg.num_layers, kv_dtype=FP8_KV)


def pool_logits(torch, np, model, prefill_impl, decode_impl, verify_impl):
    """First-token logits of 4 prompts, the next decode step's and a
    5-token verify pass's, on ``model``'s pool through the given impls."""
    from k8s_llm_monitor_tpu_torch.models import llama

    dev = torch.device("cuda")
    cfg = model.cfg
    rng = np.random.default_rng(10)
    lens = [100, 517, 1024, 33]
    B, S = len(lens), 1024
    toks = np.zeros((B, S), np.int32)
    for b, n in enumerate(lens):
        toks[b, :n] = rng.integers(3, cfg.vocab_size, size=n)
    nbl = S // BS + 4
    tables = torch.arange(1, B * nbl + 1, dtype=torch.int32,
                          device=dev).reshape(B, nbl)
    len_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    pages = llama.init_kv_pages(cfg, B * nbl + 1, BS, dev)
    first, _ = llama.prefill(model, torch.from_numpy(toks).to(dev), len_t,
                             pages, tables, attn_impl=prefill_impl)
    fed = torch.from_numpy(rng.integers(3, cfg.vocab_size, size=(B, 5))
                           .astype(np.int32)).to(dev)
    verify, _ = llama.verify_step(model, fed, len_t, torch.full_like(len_t, 5),
                                  clone_pages(pages), tables,
                                  attn_impl=verify_impl)
    step, _ = llama.decode_step(model, fed[:, 0], len_t, pages, tables,
                                attn_impl=decode_impl)
    torch.cuda.synchronize()
    return [first, step, *(verify[:, i] for i in range(5))], pages


def cosines(torch, got, want):
    """Smallest cosine of a logit row against its counterpart."""
    return min(float(torch.nn.functional.cosine_similarity(
        a.float(), b.float(), dim=-1).min()) for a, b in zip(got, want))


def phase10c(torch, np, st):
    """Llama-3-8B and llama-1b with kv_dtype float8_e4m3fn on the main
    path: auto, pallas and spec_k 4 engines, launches counted; the pool is
    half of bf16's; 4-layer logits against the bf16 pool."""
    from k8s_llm_monitor_tpu_torch.models import llama
    from k8s_llm_monitor_tpu_torch.models.config import LLAMA3_8B, LLAMA_1B
    from k8s_llm_monitor_tpu_torch.ops import paged_attention as pa
    from k8s_llm_monitor_tpu_torch.serving.kv_cache import page_slice_bytes

    launches = st.setdefault("launches", {})
    gpu = st["gpu"]
    model = st.get("model") or llama.LlamaModel(LLAMA3_8B, seed=0)
    st["model"] = model
    lens = st.get("prompt_lens") or prompt_lengths(np.random.default_rng(2))
    for base in (model, "llama-1b"):
        if base == "llama-1b":
            base = llama.LlamaModel(LLAMA_1B, seed=1)
        cfg = base.cfg
        m8 = fp8_model(base)
        big = cfg.head_dim_ == D
        rng = np.random.default_rng(2)
        prompts = [[int(t) for t in rng.integers(3, cfg.vocab_size, size=n)]
                   for n in lens]
        sfx = "" if big else "_d64"
        pre = "flash" if big else "dense"
        for label, over, paths, kernels in (
                ("auto", {}, (pre, "fused"),
                 dict({f"fused_decode_{E4M3}{sfx}":
                       "paged_decode_attention_fused"},
                      **({f"flash_prefill_{E4M3}": "flash_prefill_attention"}
                         if big else {}))),
                ("pallas", {"decode_path": "pallas"}, (pre, "pallas"),
                 {f"paged_attn_{E4M3}{sfx}":
                  "paged_decode_attention_pallas"})):
            name = f"{cfg.name} fp8 pool {label}"
            eng, ids, got, _, tok_s = run_engine(torch, st, m8, prompts, name,
                                                 over, paths, kernels,
                                                 phase=10)
            if label == "auto":
                off_ids, off_tok_s = ids, tok_s
            check(not eng.kv_quant and not eng.pages.quantized
                  and eng.pages.k[0].dtype == torch.float8_e4m3fn,
                  f"{name}: pool {eng.pages.k[0].dtype} kv_quant "
                  f"{eng.kv_quant!r}")
            bf16_pool = cfg.num_layers * eng.ecfg.num_blocks * page_slice_bytes(
                cfg.num_kv_heads, cfg.head_dim_, BS, 2)
            check(2 * eng.pool_bytes == bf16_pool,
                  f"{name}: pool {eng.pool_bytes} B, bf16's {bf16_pool} B")
            launches.update(got)
            run = st["runs"][name]
            ref = st["runs"].get("bf16 graph" if big else "", {})
            print(f"phase 10c: {name}: pool {eng.pool_bytes} B = half of "
                  f"bf16's {bf16_pool} B; ttft p50 cold / warm "
                  f"{run['ttft'] * 1e3:.1f} / {run['ttft_warm'] * 1e3:.1f} "
                  f"ms, warm decode {run['tok_s']:.1f} tok/s"
                  + (f" (phase 2's bf16 pool: {ref['ttft'] * 1e3:.1f} / "
                     f"{ref['ttft_warm'] * 1e3:.1f} ms, {ref['tok_s']:.1f} "
                     "tok/s)" if ref else "") + f" [{gpu}]")
            del eng
            torch.cuda.empty_cache()
        # spec_k 4, every decode call drafting: the 8B verifies through
        # flash prefill (B1), llama-1b (prefill dense) through B3 at QS=5.
        verify = ("flash_prefill_attention" if big
                  else "paged_verify_attention_pallas")
        eng, ids, _, spec_tok_s, spec = spec_run(
            torch, st, m8, prompts, f"{cfg.name} fp8 pool spec_k 4",
            dict(spec_k=4, spec_min_accept=0.0), 32, (pre, "fused"),
            (verify,), phase=10)
        rec = (f"flash_prefill_{E4M3}_verify" if big
               else f"paged_attn_{E4M3}_verify_d64")
        launches[rec] = spec_report(torch, eng, f"{cfg.name} fp8 pool", ids,
                                    off_ids, spec_tok_s, off_tok_s, spec,
                                    verify, phase=10)
        del eng
        torch.cuda.empty_cache()
        # 4 layers: the kernel paths over the fp8 pool against the bf16
        # pool's (JAX's bound: cosine > 0.98, tests/test_quantize.py:290).
        m4 = truncated(base, 4)
        ver = (pa.flash_prefill_attention if big
               else pa.paged_verify_attention_pallas)
        pre_impl = pa.flash_prefill_attention if big else None
        want, _ = pool_logits(torch, np, m4, pre_impl,
                              pa.paged_decode_attention_fused, ver)
        for dname, dec in (("fused", pa.paged_decode_attention_fused),
                           ("pallas", pa.paged_decode_attention_pallas)):
            got, pages = pool_logits(torch, np, fp8_model(m4), pre_impl, dec,
                                     ver)
            check(pages.k[0].dtype == torch.float8_e4m3fn, "not an fp8 pool")
            cos = cosines(torch, got, want)
            agree, ties, n = argmax_agreement(got, want, QUANT_LOGIT_ATOL)
            print(f"phase 10c: 4-layer {cfg.name}, fp8 pool ({pre} prefill, "
                  f"{dname} decode, verify on {ver.__name__}) against the "
                  f"bf16 pool: smallest logit-row cosine {cos:.5f} (at least "
                  f"0.98) over first-token, decode and 5 verify rows; argmax "
                  f"agreement {agree:.3f} ({ties} of {n} rows near-ties "
                  f"within {QUANT_LOGIT_ATOL}) [{gpu}]")
            check(cos >= 0.98, f"{cfg.name} fp8 pool: cosine {cos:.5f}")
        # Not on the main path: the 8B verifies through flash prefill, and
        # no spec engine runs Qwen2-7B on the fp8 pool.
        for rec in (f"paged_attn_{E4M3}_verify",
                    f"flash_prefill_{E4M3}_verify_qpk7",
                    f"paged_attn_{E4M3}_verify_qpk7"):
            launches.setdefault(rec, 0)
        if not big:
            del base, m8, m4
            torch.cuda.empty_cache()


def tier_prompts(rng, vocab, n):
    """``n`` prompts, each a distinct 1,536-token prefix and a 40-token
    tail."""
    return [[int(t) for t in rng.integers(3, vocab, size=PREFIX_LEN + 40)]
            for _ in range(n)]


class Timed:
    """Wraps an engine method; sums its seconds (synchronized) and the
    bytes of the rows it moved."""

    def __init__(self, torch, eng, attr, nbytes):
        self.torch, self.secs, self.bytes, self.calls = torch, 0.0, 0, 0
        fn = getattr(eng, attr)

        def call(*args):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            out = fn(*args)
            torch.cuda.synchronize()
            self.secs += time.monotonic() - t0
            self.bytes += nbytes(args, out)
            self.calls += 1
            return out
        setattr(eng, attr, call)


def phase10d(torch, np, st):
    """The host tier at Llama-3-8B width on the bf16, int8 and fp8 pools:
    a pressured pool (phase 7b's 512 x 16) cycling 6 distinct 1,536-token
    prefixes, twice.  On the first pass each prompt runs twice: fresh, then
    as a device prefix-cache hit, whose ids are the reference of the second
    pass (a restored hit runs the same tail chunk over the same page bytes;
    a fresh prefill computes the whole prompt in one call, whose rounding
    differs).  The tier's 24 GiB hold the spills of two evicted prompts
    (one evicted prompt spills every prefix length's span, 9.3 GB on
    bf16), so each second-pass prompt finds its whole prefix."""
    from k8s_llm_monitor_tpu_torch.models import llama
    from k8s_llm_monitor_tpu_torch.models.config import LLAMA3_8B
    from k8s_llm_monitor_tpu_torch.serving.engine import (
        EngineConfig, InferenceEngine, SamplingParams)

    gpu = st["gpu"]
    model = st.get("model") or llama.LlamaModel(LLAMA3_8B, seed=0)
    st["model"] = model
    prompts = tier_prompts(np.random.default_rng(12), model.cfg.vocab_size, 6)
    full = (len(prompts[0]) - 1) // BS * BS      # the shareable prefix
    sp = SamplingParams(max_tokens=8)
    for label, m, over in (("bf16", model, {}),
                           ("int8", model, {"kv_dtype": "int8"}),
                           ("fp8 (unscaled)", fp8_model(model), {})):
        eng = InferenceEngine(m.cfg, m, EngineConfig(
            max_slots=16, num_blocks=512, block_size=BS,
            max_blocks_per_seq=128, max_prefills_per_step=8,
            decode_steps_per_iter=8, host_spill_bytes=24 << 30, **over))
        fetch = Timed(torch, eng, "_fetch_rows",
                      lambda a, out: sum(x.nbytes for leaf in out.layers
                                         for x in leaf))
        write = Timed(torch, eng, "_write_rows",
                      lambda a, out: sum(x.nbytes for leaf in a[1]
                                         for x in leaf))
        restored = []
        try_restore = eng._try_restore

        def probe(prompt_ids, shared, shared_toks, **kw):
            out = try_restore(prompt_ids, shared, shared_toks, **kw)
            restored.append((out[1] - shared_toks, out[1]))
            return out
        eng._try_restore = probe

        def run(p, what):
            r = eng.generate([p], sp)[0]
            check(r.finish_reason == "length", f"{label} {what}: "
                  f"{r.finish_reason}")
            return r
        fresh, hit, back = [], [], []
        for i, p in enumerate(prompts):
            fresh.append(run(p, f"pass 0 prompt {i}"))
            hits0 = eng.prefix_cache.hits
            hit.append(run(p, f"pass 0 prompt {i} again"))
            check(eng.prefix_cache.hits == hits0 + 1,
                  f"{label}: prompt {i} run again missed the device cache")
        graphs = eng.graph_captures
        n0 = len(restored)
        for i, p in enumerate(prompts):
            back.append(run(p, f"pass 1 prompt {i}"))
        gained = restored[n0:]
        stats = eng.kv_tier_stats()
        check(stats["spills"] > 0 and stats["restores"] > 0,
              f"{label}: spills {stats['spills']} restores "
              f"{stats['restores']}")
        check(all(g > 0 and tot == full for g, tot in gained),
              f"{label}: second-pass restores {gained}, wanted the whole "
              f"{full}-token prefix each")
        check(eng.graph_captures == graphs,
              f"{label}: {eng.graph_captures - graphs} graphs recaptured "
              "across the restores")
        check(eng.dispatch_failures == 0, f"{label}: dispatch failures")
        same = sum(a.token_ids == b.token_ids for a, b in zip(back, hit))
        same_fresh = sum(a.token_ids == b.token_ids
                         for a, b in zip(back, fresh))

        def p50(rs):
            return np.percentile([r.ttft_s for r in rs], 50) * 1e3
        print(f"phase 10d: {label} pool: {len(prompts)} prompts of "
              f"{PREFIX_LEN}+40 tokens, fresh and again, then again on 512 "
              f"x {BS} blocks: spills {stats['spills']}, restores "
              f"{stats['restores']} (tokens restored beyond the device hit "
              f"per second-pass prompt {[g for g, _ in gained]}, each to "
              f"the whole {full}), host {stats['host_bytes']} B in "
              f"{stats['host_entries']} entries, {stats['host_lost']} "
              f"dropped at the cap; restored ids equal the device hit's in "
              f"{same} of {len(prompts)} (the fresh prefill's in "
              f"{same_fresh}); graphs captured {eng.graph_captures} (none "
              f"across restores); fetch "
              f"{fetch.bytes / max(fetch.secs, 1e-9) / 1e9:.2f} GB/s "
              f"({fetch.bytes} B in {fetch.calls} spills, {fetch.secs:.3f} "
              f"s), write {write.bytes / max(write.secs, 1e-9) / 1e9:.2f} "
              f"GB/s ({write.bytes} B in {write.calls} restores, "
              f"{write.secs:.3f} s, synchronized); ttft p50 fresh prefill "
              f"{p50(fresh):.1f} ms, device hit {p50(hit):.1f} ms, restored "
              f"hit {p50(back):.1f} ms (each restore first evicts, and "
              f"spills, the next prompt's entries) [{gpu}]")
        check(same == len(prompts),
              f"{label}: restored ids differ from the device hit's in "
              f"{len(prompts) - same} of {len(prompts)}")
        del eng
        torch.cuda.empty_cache()


def phase10e(torch, np, st):
    """Prefix export/install between two Llama-3-8B engines sharing one
    model's weights: every outcome, the receiver's ids equal the owner's;
    then the same over HTTP through the server's /api/v1/kv routes."""
    from k8s_llm_monitor_tpu_torch.models import llama
    from k8s_llm_monitor_tpu_torch.models.config import LLAMA3_8B
    from k8s_llm_monitor_tpu_torch.monitor.analysis import (
        AnalysisEngine, LocalEngineBackend)
    from k8s_llm_monitor_tpu_torch.monitor.config import Config
    from k8s_llm_monitor_tpu_torch.monitor.server import MonitorServer
    from k8s_llm_monitor_tpu_torch.serving.engine import (
        EngineConfig, InferenceEngine, SamplingParams)
    from k8s_llm_monitor_tpu_torch.serving.kv_tier import (
        BlobError, pack_prefix_blob, unpack_prefix_blob)
    from k8s_llm_monitor_tpu_torch.utils.tokenizer import ByteTokenizer

    gpu = st["gpu"]
    model = st.get("model") or llama.LlamaModel(LLAMA3_8B, seed=0)
    st["model"] = model
    prompt = tier_prompts(np.random.default_rng(13), model.cfg.vocab_size,
                          1)[0]
    sp = SamplingParams(max_tokens=16)
    ecfg = dict(max_slots=8, num_blocks=1024, block_size=BS,
                max_blocks_per_seq=128, max_prefills_per_step=8,
                decode_steps_per_iter=8)
    for label, m, over in (("bf16", model, {}),
                           ("int8", model, {"kv_dtype": "int8"}),
                           ("fp8 (unscaled)", fp8_model(model), {})):
        owner, recv = (InferenceEngine(m.cfg, m, EngineConfig(**ecfg, **over))
                       for _ in range(2))
        small = InferenceEngine(m.cfg, m, EngineConfig(
            **dict(ecfg, num_blocks=64), **over))
        owner.generate([prompt], sp)
        # The owner's ids for a hit on its cached prefix: the computation
        # the receiver runs once the prefix is installed.
        want = owner.generate([prompt], sp)[0].token_ids
        check(recv.export_prefix(prompt) is None, f"{label}: cold export")
        t0 = time.monotonic()
        blob = owner.export_prefix(prompt)
        t_export = time.monotonic() - t0
        check(blob is not None and blob[:4] == b"KVX1", f"{label}: no blob")
        t0 = time.monotonic()
        outcomes = [recv.install_prefix(blob, expected_tenant="acme"),
                    recv.install_prefix(blob)]
        torch.cuda.synchronize()
        t_install = time.monotonic() - t0
        outcomes.append(recv.install_prefix(blob))
        meta, raw = unpack_prefix_blob(blob)
        meta.pop("version")
        outcomes.append(recv.install_prefix(pack_prefix_blob(
            dict(meta, block_size=8), [np.frombuffer(b, np.uint8)
                                       for b in raw])))
        outcomes.append(small.install_prefix(blob))
        try:
            recv.install_prefix(blob[:-7])
            outcomes.append("installed a torn blob")
        except BlobError:
            outcomes.append("BlobError")
        check(outcomes == ["tenant_mismatch", "installed", "cached",
                           "incompatible", "nospace", "BlobError"],
              f"{label}: outcomes {outcomes}")
        hits0 = recv.prefix_cache.hits
        got = recv.generate([prompt], sp)[0].token_ids
        check(recv.prefix_cache.hits == hits0 + 1, f"{label}: no hit")
        check(got == want, f"{label}: receiver ids differ from the owner's")
        print(f"phase 10e: {label} pool: a {meta['n_blocks']}-block prefix "
              f"({len(blob)} B blob, export {t_export * 1e3:.1f} ms, "
              f"install {t_install * 1e3:.1f} ms with the tenant refusal): "
              f"outcomes {outcomes}; the receiver's 16 ids equal the "
              f"owner's [{gpu}]")
        del owner, recv, small
        torch.cuda.empty_cache()

    # Over HTTP: two servers, each over its own engine and the shared
    # weights, the owner's blob fetched and installed into the receiver.
    servers, backends = [], []
    engines = [InferenceEngine(model.cfg, model, EngineConfig(**ecfg),
                               tokenizer=ByteTokenizer()) for _ in range(2)]
    try:
        for eng in engines:
            cfg = Config()
            backend = LocalEngineBackend(engine=eng, tokenizer=ByteTokenizer())
            srv = MonitorServer(config=cfg, client=None, manager=None,
                                analysis=AnalysisEngine(backend,
                                                        llm_cfg=cfg.llm),
                                port=0)
            srv.start()
            servers.append(srv)
            backends.append(backend)
        ref = backends[0].service.submit(list(prompt), sp).result(timeout=300)
        ref = backends[0].service.submit(list(prompt), sp).result(timeout=300)
        owner, recv = (s.port for s in servers)
        miss = http_call(recv, "POST", "/api/v1/kv/prefix",
                         {"token_ids": prompt})
        status, blob, _ = http_call(owner, "POST", "/api/v1/kv/prefix",
                                    {"token_ids": prompt})
        check(status == 200 and isinstance(blob, bytes),
              f"/api/v1/kv/prefix: {status}")

        def install(data, headers=None):
            import http.client

            conn = http.client.HTTPConnection("127.0.0.1", recv, timeout=120)
            try:
                conn.request("POST", "/api/v1/kv/install", body=data,
                             headers=headers or {})
                resp = conn.getresponse()
                raw = resp.read()
            finally:
                conn.close()
            return resp.status, (json.loads(raw).get("outcome")
                                 if resp.status == 200 else None)

        got = [install(blob, {"X-Tenant-Id": "acme"}), install(blob),
               install(blob), install(blob[:-7])]
        check(miss[0] == 404 and got == [(200, "tenant_mismatch"),
                                         (200, "installed"), (200, "cached"),
                                         (400, None)],
              f"/api/v1/kv routes: miss {miss[0]}, installs {got}")
        ids = backends[1].service.submit(list(prompt), sp).result(timeout=300)
        check(ids.token_ids == ref.token_ids,
              "the receiving server's ids differ from the owner's")
        print(f"phase 10e: over HTTP: /api/v1/kv/prefix 404 on the cold "
              f"server, a {len(blob)} B blob from the owner; "
              f"/api/v1/kv/install {got}; the receiver's ids equal the "
              f"owner's [{gpu}]")
    finally:
        for srv in servers:
            srv.stop()
        for backend in backends:
            backend.service.stop()
        del engines
        torch.cuda.empty_cache()


def phase10(torch, np, st):
    for sub in (phase10a, phase10b, phase10c, phase10d, phase10e):
        t0 = time.monotonic()
        sub(torch, np, st)
        torch.cuda.synchronize()
        print(f"phase 10: {sub.__name__[-3:]} passed in "
              f"{time.monotonic() - t0:.1f} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="0,1,2,3,4,5,6,7,8,9,10",
                    help="comma-separated phases to run (default: all)")
    ap.add_argument("--only", choices=("flash_prefill", "fused_decode",
                                       "paged_attn"),
                    help="limit phases 1 and 4 to this kernel")
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",")}

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: no CUDA device (torch.cuda.is_available() "
              "is false)", file=sys.stderr)
        return 2
    try:
        import k8s_llm_monitor_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: FAIL: the port package is missing: {exc}",
              file=sys.stderr)
        return 2

    st: dict = {"only": args.only}
    # Phases 8, 7 and 10 before 6: they reuse phase 2's model, which phase
    # 6 frees; phase 9 last, on a card that holds no earlier model.
    runners = [(0, phase0), (1, phase1), (2, phase2), (3, phase3), (8, phase8),
               (4, phase4), (5, phase5), (7, phase7), (10, phase10),
               (6, phase6), (9, phase9)]
    for n, fn in runners:
        if n not in phases and n != 0:
            continue
        t0 = time.monotonic()
        try:
            fn(torch, st) if n == 0 else fn(torch, np, st)
            torch.cuda.synchronize()
        except Exception as exc:
            print(f"chip_smoke: FAIL: phase {n}: {type(exc).__name__}: {exc}",
                  file=sys.stderr)
            import traceback

            traceback.print_exc()
            return 1
        print(f"phase {n}: passed in {time.monotonic() - t0:.1f} s")
    if "records" in st:
        # The main path's launch counts, read when every phase has run
        # (phases 8 and 9 drive the engines that launch the records of
        # head_dim 64 and of 7 query heads per kv head).
        for rec in st["records"]:
            rec["launches"] = st.get("launches", {}).get(rec["name"])
        print(json.dumps({"kernels": st["records"]}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
