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
    python3 chip_smoke.py --phases 0,11   # e5m2 / f16 pools, default server
    python3 chip_smoke.py --phases 0,12   # tensor parallelism (A7)
    python3 chip_smoke.py --phases 0,12f  # only 12f: rebuilds of a broken mesh
    python3 chip_smoke.py --phases 0,12g  # a seq mesh (sequence-sharded prefill)
    python3 chip_smoke.py --phases 0,12h  # seq and TP meshes on four cards
    python3 chip_smoke.py --phases 0,13   # a checkpoint on a mesh (A7b)
    python3 chip_smoke.py --phases 0,14   # the port's gates (A12)
    python3 chip_smoke.py --phases 0,15   # the fleet router (A8)

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
Phase 2  the engine at full Llama-3-8B width (MAIN_LAYERS = 8 of its 32
         layers, random bf16 weights from a seeded generator on the card;
         phases 3, 5, 7, 8, 10 and 11 reuse the model): a bf16 pool (2 GiB
         at 8 layers), an int8
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
         journal in a temporary directory; telemetry and remediation on, as
         by default): cmd/server's chain down to EngineSupervisor -> EngineService ->
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
         spec_min_accept 1.2, 32 slots, 512 x 16 blocks; telemetry and
         remediation on), through build_server and phase 6's HTTP burst:
         every response succeeds, the split paged attention kernel
         launches in spec calls and fused decode in decode calls, no
         dispatch failure.
         Each spec run prints its acceptance (tokens per lane-round),
         decode tokens/s against spec off, spec_accept_ema() and how many
         id sequences equal the spec-off run's.

Phase 9  weights and Qwen2-7B (runs last: phase 6 has freed the earlier
         model).  9a: Qwen2-7B at full width (QWEN_LAYERS = 8 of its 28
         layers, hidden 3584, 28/4 heads, vocab 152,064, qkv bias; random
         bf16 weights from a seed; a 4096 x 16 pool), phase 2's 16
         prompts and 32 new tokens on bf16 and int8 pools and decode_path="pallas", and on
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

Phase 11 B9, the kernels over unscaled float8_e5m2 and float16 pages, and
         A13, the server pieces the default config turns on (after phase
         10, on phase 2's model).  11a: every e5m2 and f16 instance against
         its plain version on its first call, as 10a (B1 at the admission,
         chunk, hit and verify shapes at qpk 4 and 7; B2 at D 128 qpk 4
         and 7 and D 64, the appended bytes bit for bit, rows at
         +-57344..65536, +-inf and NaN (e5m2) and +-65024..66048 and
         subnormals (f16) included, and k * cos landing on f32 values
         across each format's overflow edge; B3 at QS 1, 5 and 8), the
         page casts on the card against the CPU's.  11b: their times by
         phase 4's method at the shapes of Llama-3-8B and llama-1b.  11c:
         Llama-3-8B and llama-1b on each pool through auto, pallas and
         spec_k 4 engines (B1, B2 and B3 launched), the pool half of
         bf16's (e5m2) or equal (f16), 4-layer logits against the bf16
         pool (cosine >= 0.98 e5m2, >= 0.999 f16).  11d: the monitor's
         default config, load_config(None) with only server.port 0 and the
         fake cluster (llama-1b, W8A8, spec_k 4, telemetry and remediation
         on), through build_server: phase 6's HTTP burst, /metrics
         lint-clean with the TTFT histogram counting every request served,
         the decode host gap and decode-step histogram moving, the signal
         scraper's local target fresh after two intervals, a Warning burst
         to a diagnosis and an observe-only plan, /debug/profile with
         server.debug (a torch.profiler trace written and parsed;
         decode_phases fills decode_attn_ms / decode_sample_ms on the
         decode graphs), a UAV report round trip; then cmd.server on cuda
         with no TELEMETRY_ENABLED / REMEDIATION_ENABLED: /metrics, a
         query, exit 0 on SIGTERM.

Phase 12 tensor parallelism over the model axis (A7): 12a B1 and B3 at each
         per-rank head geometry against their plain versions, timed; 12b
         Llama-3-8B at TP 2 against TP 1; 12d Qwen2-72B (TP 4 at 80 layers
         with four cards, else TP 2 at 8) and the mesh's close, timed;
         12c the default config on a mesh through build_server, 12e a
         step-loop kill under TP, 12f two breaks of the mesh, each rebuilt
         on a new one (over NCCL rank 0's prefill launches are paced, so
         the killed rank's break ends in a rebuild).  A7b's rest, the seq
         axis: 12g a "1,2,1" mesh at Llama-3-8B width and 2 layers against
         TP 1 (prefill logits in rounds of 2048, greedy ids of 8 prompts,
         one chunked past the 2048 bucket; B1 launched on both ranks over
         their query slices; B1's slice record flash_prefill_seq2); 12h,
         with four cards, Llama-3-8B at 32 layers on "1,2,2" over NCCL:
         the TTFT of one 8,192-token prompt admitted alone against "1,1,4"
         and "1,1,2", and phase 2's mix held to TP 1 by 12b's bars.  NCCL
         with a card per rank, else gloo on one card.  A sub-phase by name
         (--phases 0,12f) runs only that part.
Phase 13 a checkpoint on a mesh (A7b): 13a Llama-3-8B at full width (4 of
         32 layers on one card, 32 with a card per rank) written as bf16
         safetensors and loaded at TP 1 and TP 2, every rank's shard
         equal to TP 1's slice bit for bit in bf16, quantize_params, int8
         and W8A8; 13b logits and greedy ids against TP 1 (12b's bars), B1
         and B3 launched on every rank, TTFT and tok/s, the decode
         collective share from the all-reduce rate measured on the mesh;
         13c the host tier (spill, restore, the device hit's ids) and a
         KVX1 blob exported on TP 2, installed on TP 1 and on TP 2; 13d,
         with four cards, Qwen2-72B loaded as int8 at TP 4 at as many
         layers as the disk holds, and the TP-4 mesh's close, timed; 13e
         the preflight's verdicts for Llama-3-8B, Qwen2-72B and
         Llama-3-70B, bf16 and int8, TP 1-8 at 80 GiB.
         CHIP_SMOKE_CKPT_DIR names where the checkpoints are written
         (default: the temporary directory).
Phase 14 the port's gates on the card (A12, devtools/traceguard.py):
         Llama-3-8B at full width and 2 layers (bf16, decode graphs on)
         through each of traceguard's one-card paths (gather, fused, int8
         pool, flash prefill, grammar swap, pallas, spec): a warm pass, a
         same-bucket repeat that builds no decode program and captures no
         graph, every replay under torch.cuda.set_sync_debug_mode("error"),
         the captured buffers still the engine's live tensors after a
         pipeline reset, a preemption, a host-tier restore and a grammar
         swap, and B1-B4 launched; the static capture-hazard pass; then the
         same on a TP-2 mesh (NCCL with two cards, gloo on one), B1 and B3
         launched on each rank.
Phase 15 the fleet router (A8, fleet/): two replicas of the monitor's
         default config (llama-1b at 16 layers, W8A8, spec_k 4) built by
         build_server side by side on one card, and a third engine of it
         as the one-engine reference.  15a: 24 diagnosis verdicts over 4
         shared cluster contexts through a FleetRouter (affinity) over the
         two replicas as LocalReplicas: every verdict parses, greedy ids
         equal the reference's, the affinity hits and the TTFT p50 / p99
         through the router, B2 launched on each serving replica's own
         step thread (ops/paged_attention.py:thread_launches).  15b:
         one replica prefill, the other decode: every handoff's KVX1
         prefix installed on D, D's pages of each prompt P's bit for bit,
         D's prefix hits one a request, the first tokens equal the
         reference's and the second (D's prefix hit) its own prefix-hit
         run of the prompt and the first (the decoded rest is counted);
         then
         the same at Llama-3-8B width (2 layers, bf16), where B1 runs on
         P's prefill and D's hit round (llama-1b's head_dim 64 keeps
         prefill dense, as in JAX).  15d: the router
         role, build_router_server in front of the two replica servers:
         /api/v1/query, the fleet block of /api/v1/stats, /metrics lint
         and its fleet families, /readyz 503 once both replicas stop.
         15c (last: it kills a replica): a long greedy answer whose
         replica is killed between two steps finishes on the other, one
         failover, the stream exactly the delivered tokens and then the
         survivor's, asked for the prompt and those tokens and the rest of
         the budget; its ids against the undisturbed run are printed.  A sub-phase by name
         (--phases 0,15b) runs only that part.

Prints one JSON line of kernel records, the card's name and power limit,
then ``{"ok": true, "device": {...}}`` as the last line.  Any failed phase
prints its reason and exits non-zero.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
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
# Phase 2's Llama-3-8B runs at full width, cut to MAIN_LAYERS of its 32
# layers, and phase 9a's Qwen2-7B to QWEN_LAYERS of its 28, so that every
# phase fits the script's 1,200 s on one card (every phase at full depth
# took 1,084 s on an H100).  Phases 3, 5, 7, 8, 10 and 11 reuse phase 2's
# model; phase 12b builds its own at all 32 layers (its TP-1 comparison),
# phase 6 the server's through the monitor's config.
MAIN_LAYERS = 8
QWEN_LAYERS = 8


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
    ``d`` page elements (2 bytes on a bf16 or unscaled fp16 pool, 1 on an
    unscaled e4m3 or e5m2 one), plus a float32 scale on a quantized
    pool."""
    return {"": 2 * d, E4M3: d, "e5m2": d, "f16": 2 * d}.get(kv_quant, d + 4)


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


def main_model(st):
    """Phase 2's model: Llama-3-8B at full width and MAIN_LAYERS layers,
    random bf16 weights from seed 0 (built here when phase 2 did not
    run)."""
    model = st.get("model")
    if model is None:
        from k8s_llm_monitor_tpu_torch.models import llama
        from k8s_llm_monitor_tpu_torch.models.config import LLAMA3_8B

        model = llama.LlamaModel(dataclasses.replace(
            LLAMA3_8B, num_layers=MAIN_LAYERS), seed=0)
        st["model"] = model
    return model


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
    # a seq rank's slice (12g, 12h): rank 1 of 2048 rounds split over seq
    # 2, the slices of a fresh round (start 1024), of a continuation from
    # 1000 (start 2024, inside a 64-key tile) and of lanes that end in
    # slice 0 (0 rows) or inside slice 1 (ragged)
    (H, KVH, 1024, [1024, 2024, 1024, 1024], [1024, 276, 0, 500], BS),
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
    steps0, waits0 = eng.step_calls, eng.admission_waits
    t0 = time.monotonic()
    res = eng.generate(prompts, sp)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    waits = eng.admission_waits - waits0
    pre_s = eng.prefill_dispatch_s
    launches = {rec: getattr(pa, fn).launches for rec, fn in kernels.items()}
    steps = eng.step_calls - steps0
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
    first_run = (steps, eng.steps)
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
          f"{eng.steps} decode steps), weights "
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
    from k8s_llm_monitor_tpu_torch.serving.engine import SamplingParams

    t0 = time.monotonic()
    st.pop("model", None)
    model = main_model(st)
    cfg = model.cfg
    torch.cuda.synchronize()
    print(f"phase 2: {cfg.name} ({cfg.num_layers} of 32 layers, hidden "
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
    steps0, tokens0 = eng.steps, eng.decode_tokens
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
    steps = eng.steps - steps0
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
    from k8s_llm_monitor_tpu_torch.monitor.analysis import LocalEngineBackend
    from k8s_llm_monitor_tpu_torch.ops import paged_attention as pa
    from k8s_llm_monitor_tpu_torch.ops import sampling
    from k8s_llm_monitor_tpu_torch.serving.engine import (
        EngineConfig, InferenceEngine, SamplingParams)
    from k8s_llm_monitor_tpu_torch.utils.tokenizer import ByteTokenizer

    gpu = st["gpu"]
    model = main_model(st)
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
        steps0 = (eng.steps, eng.bounded_decode_steps)
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
              f"EngineService: {wall:.2f} s wall, {eng.steps - steps0[0]}"
              f" decode steps ({bounded} bounded-sampled); ttft p50 "
              f"{np.percentile(ttfts, 50) * 1e3:.1f} ms, p99 "
              f"{np.percentile(ttfts, 99) * 1e3:.1f} ms; decode {tok_s:.1f} "
              f"tok/s; constrained_decode_overhead_ms "
              f"{backend.constrained_decode_overhead_ms:.3f}; launches "
              f"{launches}; steps that waited on the device while "
              f"dispatching {eng.admission_waits} of {eng.step_calls}; "
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
        s0, d0, b0 = eng.decode_s, eng.steps, eng.bounded_decode_steps
        res = eng.generate(prompts, sp)
        check(all(r.finish_reason in ("eos", "length") for r in res),
              f"sampled run at cap {cap}: {[r.error for r in res]}")
        check((eng.bounded_decode_steps > b0) == (cap > 0), "sampler choice")
        per_step[cap if len(per_step["cold"]) == 2 else "cold"].append(
            (eng.decode_s - s0) / (eng.steps - d0))
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

    d0 = eng.steps
    threads = [threading.Thread(target=run, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    if arm_after_steps is not None:
        deadline = time.monotonic() + 300
        while (eng.steps < d0 + arm_after_steps
               and time.monotonic() < deadline):
            time.sleep(0.001)
        check(eng.steps >= d0 + arm_after_steps,
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
              f"while dispatching {eng.admission_waits} of {eng.step_calls} "
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
        # The pipeline's plan stage (remediation, observe-only, on by
        # default) runs after each verdict on the pipeline's worker: it is
        # done once the worker has stopped, before the rebuild below.
        srv.diagnosis.stop(timeout=300)
        recs = srv.remediation.records()
        print(f"phase 6: remediation (observe-only): {len(recs)} plan(s) "
              f"{[(r['plan']['verb'], r['status'], r['planner']) for r in recs]}"
              f"; signal scraper {srv.signals.counters()['scrapes_total']} "
              f"scrapes [{gpu}]")

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
               LLM_TPU_SPEC_K="0", LLM_MAX_TOKENS="16",
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
    from k8s_llm_monitor_tpu_torch.resilience.faults import get_injector
    from k8s_llm_monitor_tpu_torch.serving.engine import SamplingParams

    gpu = st["gpu"]
    model = main_model(st)
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
          f"rows {eng.prefill_tokens}, decode steps {eng.steps}, "
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
          f"{eng.decode_tokens} tokens, {eng.steps} decode steps in "
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
    model = main_model(st)
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
    1,024-token table; telemetry and remediation on), through
    build_server: the supervisor's step thread
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

    cfg = dataclasses.replace(QWEN2_7B, num_layers=QWEN_LAYERS)
    t0 = time.monotonic()
    model = llama.LlamaModel(cfg, seed=3)
    torch.cuda.synchronize()
    print(f"phase 9: {cfg.name} ({cfg.num_layers} of 28 layers, hidden "
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
    or an fp8 pool widened, to bf16; fp16 pages as they are, q cast to
    fp16) beforehand, heads repeated, batch-head major."""
    from k8s_llm_monitor_tpu_torch.ops.attention import (
        gather_dequant, gather_pages, widen_pages)

    B, _, nh, d = q.shape
    nkv = kp.shape[-1] // d
    nb = (ctx_max + BS - 1) // BS
    if scales:
        k = gather_dequant(kp, scales["k_scale"], table[:, :nb], d)
        v = gather_dequant(vp, scales["v_scale"], table[:, :nb], d)
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    elif kp.dtype == torch.float16:       # SDPA in fp16 on fp16 pages
        q = q.to(torch.float16)
        k = gather_pages(kp, table[:, :nb]).reshape(B, -1, nkv, d)
        v = gather_pages(vp, table[:, :nb]).reshape(B, -1, nkv, d)
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
              f"{steps} steps ({dsteps} decode steps x {MAIN_LAYERS} layers)")


# ---------------------------------------------------------------- phase 10
# The unscaled fp8 pool (ModelConfig.kv_dtype = "float8_e4m3fn", ROADMAP
# B8) and the KV tiers (A5).

FP8_KV = "float8_e4m3fn"
# Unscaled pools of another page dtype than the model's, by their kernel
# instances' symbol suffix (the record tag): B8's e4m3 (phase 10), B9's
# e5m2 and fp16 (phase 11).
UNSCALED_KV = {E4M3: FP8_KV, "e5m2": "float8_e5m2", "f16": "float16"}
INF, NAN = float("inf"), float("nan")
# e4m3fn's rounding edge (448 is its largest value, 464 the midpoint to the
# NaN code), infinities, NaNs, subnormals and their halves.
E4M3_EDGE = [0.0, -0.0, 1.0, 448.0, 449.0, 460.0, 464.0, 464.00003, 465.0,
             470.0, 480.0, 500.0, -460.0, -464.0, -470.0, -500.0, 1e30,
             INF, -INF, NAN, 2.0 ** -9,
             2.0 ** -10, 2.0 ** -10 * 1.0001, 3 * 2.0 ** -11,
             -1.5 * 2.0 ** -10, 2.0 ** -6, 1e-30]
# e5m2's (57344 its largest finite value, 61440 the midpoint to infinity;
# subnormals from 2^-16) and fp16's (65504, 65520; subnormals from 2^-24).
E5M2_EDGE = [0.0, -0.0, 1.0, 57344.0, 57345.0, 59000.0, 61439.0,
             61439.996, 61440.0, 61441.0, 65536.0, -57344.0, -61439.0,
             -61440.0, -70000.0, 1e30, INF, -INF, NAN, -NAN, 2.0 ** -16,
             2.0 ** -17, 2.0 ** -17 * 1.0001, 3 * 2.0 ** -18,
             -1.5 * 2.0 ** -16, 2.0 ** -14, 1e-30]
F16_EDGE = [0.0, -0.0, 1.0, 65504.0, 65505.0, 65519.0, 65519.996, 65520.0,
            65521.0, 70000.0, -65504.0, -65520.0, 1e30, INF, -INF, 2.0 ** -14,
            2.0 ** -15, 2.0 ** -24, 2.0 ** -25, 2.0 ** -25 * 1.0001,
            3 * 2.0 ** -26, -1.5 * 2.0 ** -24, 1e-30]
# bf16 values past and at each format's edge, written into appended rows
# (finite in the f32 row the current token folds in).
ROW_EDGE = {
    E4M3: [448.0, 456.0, 464.0, 472.0, 480.0, 496.0, 512.0, -464.0, -472.0,
           -480.0, -512.0, 2.0 ** -10],
    "e5m2": [57344.0, 59392.0, 60416.0, 61440.0, 61952.0, 65536.0, -57344.0,
             -60416.0, -61440.0, -65536.0, 2.0 ** -16, 2.0 ** -18],
    "f16": [65024.0, 65280.0, 65536.0, 66048.0, -65280.0, -65536.0,
            2.0 ** -14, 2.0 ** -20, 2.0 ** -24, 2.0 ** -25, 3 * 2.0 ** -26,
            -2.0 ** -24],
}
# f32 roped k values across the edge, made on one lane as k * cos with sin
# 0 (k a bf16 value of the row edge): what the f32 -> page conversion of
# the appended k meets between bf16's steps.
ROPE_EDGE = {"e5m2": (57344.0, [57344.0, 59000.0, 61439.0, 61439.996,
                                61440.0, 61441.0, 62000.0, 65000.0]),
             "f16": (65280.0, [65504.0, 65505.0, 65519.0, 65519.996,
                               65520.0, 65521.0, 65535.0, 65280.0])}
# Rows of infinities and NaN, on a lane of their own (its output is not
# finite; its appended bytes are still held), for the formats that keep
# them: in v and k on e5m2 pages; in v only on fp16 pages (RoPE at sin 0
# makes inf * 0 a NaN in k, whose bits the fp16 conversions need not
# agree on, and jnp's fp16 NaN is not what the card is held to).
NONFINITE_ROW = {"e5m2": [INF, -INF, NAN, -NAN], "f16": [INF, -INF]}


def unscaled_cast(torch, kv):
    """The page write of an unscaled pool: ``cast_e4m3`` / ``cast_e5m2``
    (jnp's conversions), or ``.to(torch.float16)``."""
    from k8s_llm_monitor_tpu_torch.models.llama import cast_e4m3, cast_e5m2

    return {E4M3: cast_e4m3, "e5m2": cast_e5m2,
            "f16": lambda x: x.to(torch.float16)}[kv]


def pool_prefill_case(torch, rng, gen, B, S, starts, lengths, heads=(H, KVH),
                      bs=BS, d=D, kv=E4M3):
    """prefill_case over an unscaled pool of page type ``kv``."""
    q, kp, vp, table, st, ln = prefill_case(torch, rng, gen, B, S, starts,
                                            lengths, heads, bs, d)
    cast = unscaled_cast(torch, kv)
    return (q, cast(kp), cast(vp), table, st, ln)


def pool_decode_case(torch, rng, gen, positions, nbl, heads=(H, KVH), bs=BS,
                     d=D, kv=E4M3):
    q, kn, vn, cos, sin, kp, vp, table, pos = decode_case(
        torch, rng, gen, positions, nbl, heads, bs, d)
    cast = unscaled_cast(torch, kv)
    return (q, kn, vn, cos, sin, cast(kp), cast(vp), table, pos)


def kv_bytes(kv):
    """Bytes of one page element of an unscaled pool."""
    return 2 if kv == "f16" else 1


# 10a/10b's flash prefill shapes: phase 4's admission round, the 2048
# chunk, phase 7a's prefix-hit round (a continuation) and the spec verify
# shape.
def unscaled_prefill_shapes(lens):
    return [("admission", 1024, [0] * 8, [min(n, 1024) for n in lens[:8]]),
            ("chunk", 2048, [0], [2048]),
            ("hit", 256, *HIT_SHAPE),
            ("verify", 5, *VERIFY_SHAPE)]


def unscaled_positions(rng, chunk=128):
    """Fused decode positions: both sides of the pool's key chunk
    boundaries, an inactive lane, one cached row, block edges, the table's
    last row and a lane past it (128 x 16 table), random contexts."""
    fixed = sorted({0, 1} | {p for c in (chunk, 2 * chunk)
                             for p in (c - 1, c, c + 1)}) + [
        15, 16, 17, 1000, 2047, 2051]
    return fixed + [int(x) for x in rng.integers(1, 2048,
                                                 size=32 - len(fixed))]


def unscaled_checks(torch, np, st, kv, tag):
    """Each instance over an unscaled ``kv`` pool against its plain
    version on its first call (phase 10a for e4m3, 11a for e5m2 and f16):
    the page cast on the card against the CPU's; B1 at qpk 4 and 7; B2 at
    D 128 (qpk 4, 7) and 64 with the appended bytes bit for bit, rows at
    the format's edges included; B3 at QS 1, 5 and 8, rows past qlens and
    empty lanes zero."""
    from k8s_llm_monitor_tpu_torch.ops import paged_attention as pa

    rng = np.random.default_rng(10)
    gen = torch.Generator(device="cuda").manual_seed(10)
    errs = st.setdefault("max_abs_err", {})
    ulps = {}
    cast = unscaled_cast(torch, kv)
    # The cast on the card gives the CPU's codes (which the CPU tests hold
    # to jnp.astype bit for bit), from float32 and from bf16.
    edge = {E4M3: E4M3_EDGE, "e5m2": E5M2_EDGE, "f16": F16_EDGE}[kv]
    top = {E4M3: 10, "e5m2": 17, "f16": 17}[kv]
    x = torch.cat([torch.tensor(edge),
                   torch.from_numpy(rng.standard_normal(100_000)
                                    .astype(np.float32) * 3),
                   torch.from_numpy((rng.uniform(-1, 1, 50_000) * 2.0 ** (
                       rng.integers(-26, top, 50_000))).astype(np.float32))])
    bits = torch.uint8 if kv_bytes(kv) == 1 else torch.int16
    for src in (x, x.to(torch.bfloat16)):
        dev = cast(src.cuda()).view(bits).cpu()
        check(torch.equal(dev, cast(src).view(bits)),
              f"the {kv} page cast on the card differs from the CPU's "
              f"({src.dtype})")
    print(f"phase {tag}: the {kv} page cast on the card equals the CPU's on "
          f"{x.numel()} float32 and bf16 values (edges, non-finite, "
          "subnormals)")

    lens = st.get("prompt_lens") or prompt_lengths(np.random.default_rng(2))
    # B1: flash prefill at qpk 4 (Llama-3-8B) and 7 (Qwen2-7B); empty
    # lanes zero.
    for heads in ((H, KVH), HEADS_QWEN):
        for label, S, starts, lengths in unscaled_prefill_shapes(lens):
            name = (f"flash_prefill_{kv}" + ("_verify" if label == "verify"
                                             else "")
                    + qpk_suffix(heads, D))
            case = pool_prefill_case(torch, rng, gen, len(starts), S, starts,
                                     lengths, heads, kv=kv)
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
            print(f"phase {tag}: {name} {label} H={heads[0]} KVH={heads[1]} "
                  f"S={S}: ok, max abs err {errs[name]:.4g}, max err "
                  f"{ulps[name]:.3g} ulps of the row")
            del case, got, want
    torch.cuda.empty_cache()

    # B2: fused decode, outputs, and the appended rows' bytes bit for bit
    # (the plain version casts the f32 roped row with the pool's cast, the
    # kernel with its conversion); rows holding the format's edge values on
    # lanes 2, 5 and 9 (lane 5 ropes at angle 0: cos 1, sin 0, so its k
    # row reaches the page unrotated); on lane 12 k * cos lands on f32
    # values across the edge; infinities and NaN on lane 20, whose output
    # is not held.
    chunk = pa.DECODE_CHUNK[kv_bytes(kv)]
    row_edge = ROW_EDGE[kv]
    nonfinite = NONFINITE_ROW.get(kv, [])
    for d, heads in ((D, (H, KVH)), (D, HEADS_QWEN), (D64, HEADS_1B)):
        name = f"fused_decode_{kv}" + ("_d64" if d == D64
                                       else qpk_suffix(heads, d))
        positions = unscaled_positions(rng, chunk)
        nbl = 128
        case = pool_decode_case(torch, rng, gen, positions, nbl, heads, BS, d,
                                kv)
        edge = torch.tensor(row_edge, device="cuda").to(torch.bfloat16)
        for b in (2, 5, 9):          # raw k and v rows at the edge
            case[1][b, 0, :, :len(row_edge)] = edge
            case[2][b, 0, :, :len(row_edge)] = edge.flip(0)
        case[3][5], case[4][5] = 1.0, 0.0
        if kv in ROPE_EDGE:
            k0, targets = ROPE_EDGE[kv]
            case[1][12, 0, :, :len(targets)] = k0
            case[3][12] = 1.0
            case[3][12, :, :len(targets)] = (torch.tensor(targets) / k0).to(
                case[3].device)
            case[4][12] = 0.0
        lanes = list(range(len(positions)))
        if nonfinite:
            bad = torch.tensor(nonfinite, device="cuda").to(torch.bfloat16)
            if kv == "e5m2":
                case[1][20, 0, :, :len(nonfinite)] = bad
            case[2][20, 0, :, :len(nonfinite)] = bad.flip(0)
            case[3][20], case[4][20] = 1.0, 0.0
            lanes.remove(20)
        pos_t = case[-1]
        covered = (pos_t > 0) & (pos_t < nbl * BS)
        ck = [t.clone() for t in case]
        cp = [t.clone() for t in case]
        got = pa.paged_decode_attention_fused(*ck)
        want = pa.paged_decode_attention_fused_plain(*cp)
        torch.cuda.synchronize()
        check(got[1].data_ptr() == ck[5].data_ptr(),
              f"{name}: pool not updated in place")
        keep = torch.tensor(lanes, device="cuda")
        check_rows(torch, name, got[0][keep], want[0][keep],
                   (covered | (pos_t == 0))[keep], errs, ulps)
        diff = [int((got[i].view(bits) != want[i].view(bits)).sum())
                for i in (1, 2)]
        check(diff == [0, 0], f"{name}: appended bytes differ (k, v): {diff}")
        pages = torch.cat([got[1].float().flatten(), got[2].float().flatten()])
        n_nan = int(torch.isnan(pages).sum())
        n_inf = int(torch.isinf(pages).sum())
        if kv == E4M3:
            check(n_nan > 0, f"{name}: no NaN code appended from the edge "
                             "rows")
        else:
            check(n_inf > 0, f"{name}: no infinity appended from the edge "
                             "rows")
            check(kv != "e5m2" or n_nan > 0,
                  f"{name}: no NaN code appended from the NaN rows")
        print(f"phase {tag}: {name} H={heads[0]} KVH={heads[1]} D={d} B=32 "
              f"positions {positions[:10]}...: ok, max abs err "
              f"{errs[name]:.4g}, max err {ulps[name]:.3g} ulps of the row; "
              f"pages bit for bit ({n_nan} NaN and {n_inf} infinite values "
              f"appended from the edge rows)")
        del case, ck, cp, got, want, pages
    torch.cuda.empty_cache()

    # B3: split paged attention at QS=1 (decode wrapper, an empty lane)
    # and QS=5 and 8 (verify wrapper, rows past qlens and an empty lane),
    # both sides of the pool's key chunk boundaries.
    for d, heads in ((D, (H, KVH)), (D, HEADS_QWEN), (D64, HEADS_1B)):
        sfx = "_d64" if d == D64 else qpk_suffix(heads, d)
        name = f"paged_attn_{kv}" + sfx
        positions = [0, 5, 1, 15, 16, 127, 128, 129, 255, 256, 257, 2047] + [
            int(x) for x in rng.integers(1, 2048, size=20)]
        nbl = 2048 // BS + 1
        q, _, _, _, _, kp, vp, table, pos = pool_decode_case(
            torch, rng, gen, positions, nbl, heads, BS, d, kv)
        lens = pos + 1
        lens[1] = 0
        got = pa.paged_decode_attention_pallas(q, kp, vp, table, lens)
        want = pa.flash_prefill_attention_plain(
            q, kp, vp, table, (lens - 1).clamp(min=0), lens.clamp(max=1))
        torch.cuda.synchronize()
        check(bool((got[1] == 0).all()), f"{name}: the empty lane is not "
                                         "zeroed")
        check_rows(torch, name, got, want, lens > 0, errs, ulps)
        vname = f"paged_attn_{kv}_verify" + sfx
        for QS in (5, 8):
            starts = [0, 123, 124, 125, 250, 251, 252, 700, 1000, 2040, 0, 3]
            qlens = [QS, QS, QS, QS, QS, QS, QS, QS - 1, 3, QS, 0, 2]
            vcase = pool_prefill_case(torch, rng, gen, len(starts), QS,
                                      starts, qlens, heads, BS, d, kv)
            vgot = pa.paged_verify_attention_pallas(*vcase)
            vwant = pa.flash_prefill_attention_plain(*vcase)
            torch.cuda.synchronize()
            for b, n in enumerate(qlens):
                check(bool((vgot[b, n:] == 0).all()),
                      f"{vname} QS={QS}: rows past qlens of lane {b} not "
                      "zeroed")
                if n:
                    check_rows(torch, vname, vgot[b, :n], vwant[b, :n],
                               slice(None), errs, ulps)
            del vcase, vgot, vwant
        print(f"phase {tag}: {name} QS=1 and {vname} QS=5, 8 H={heads[0]} "
              f"KVH={heads[1]} D={d}: ok, max abs err {errs[name]:.4g} / "
              f"{errs[vname]:.4g}, max err {ulps[name]:.3g} / "
              f"{ulps[vname]:.3g} ulps of the row")
        del q, kp, vp, table, got, want
    torch.cuda.empty_cache()
    print(f"phase {tag}: tolerance atol {TOL['atol']} rtol {TOL['rtol']} and "
          f"{ULP_TOL} bf16 ulps of each (row, head)'s largest value; rows "
          "past qlens and empty lanes zero; appended bytes bit for bit")


def phase10a(torch, np, st):
    """Each B8 instance against its plain version on its first call."""
    unscaled_checks(torch, np, st, E4M3, "10a")


def unscaled_timings(torch, np, st, kv, tag, qpk7=True):
    """Each instance over an unscaled ``kv`` pool timed by phase 4's method
    at phase 4's shapes (phase 10b for e4m3, 11b for e5m2 and f16; the
    qpk-7 shapes where a Qwen2-7B engine runs the pool: phase 9a's e4m3)."""
    import torch.nn.functional as F

    from k8s_llm_monitor_tpu_torch.ops import paged_attention as pa

    rng = np.random.default_rng(11)
    gen = torch.Generator(device="cuda").manual_seed(11)
    lens = st.get("prompt_lens") or prompt_lengths(np.random.default_rng(2))
    gpu = st["gpu"]
    nbytes = kv_bytes(kv)
    # Llama-3-8B's heads at every shape; Qwen2-7B's 28/4 (qpk 7) at the
    # admission and verify shapes, as phase 4 times the bf16 qpk-7 rows.
    shapes = [((H, KVH), "", shape) for shape in unscaled_prefill_shapes(lens)]
    shapes += [(HEADS_QWEN, "_qpk7", shape) for shape in
               unscaled_prefill_shapes(lens) if qpk7 and shape[0] in (
                   "admission", "verify")]
    for heads, sfx, (label, S, starts, lengths) in shapes:
        name = (f"flash_prefill_{kv}"
                + ("_verify" if label == "verify" else "") + sfx)
        case = pool_prefill_case(torch, rng, gen, len(starts), S, starts,
                                 lengths, heads, kv=kv)
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
        b_ms, by = bound(*prefill_work(starts, lengths, S, kv, heads))
        print(f"phase {tag}: {name} {label} B={len(starts)} S={S} "
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
                                   (("engine", mid),) if qpk7 else ())):
        if not shapes:
            continue
        for label, positions in shapes:
            name = f"fused_decode_{kv}" + sfx
            case = pool_decode_case(torch, rng, gen, positions, nbl, heads,
                                    BS, d, kv)
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
            b_ms, by = bound(*decode_work(positions, kv, heads, d))
            nsplit, chunk = pa.decode_splits(nbl, BS, nbytes)
            print(f"phase {tag}: {name} {label} B=32 active "
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
        q1, _, _, _, _, kp, vp, table, _ = pool_decode_case(
            torch, rng, gen, mid, nbl, heads, BS, d, kv)
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
            (f"paged_attn_{kv}" + sfx, "engine", q1, dict(lengths=len_t),
             lambda: pa.paged_decode_attention_pallas(q1, kp, vp, table,
                                                      len_t),
             ((len_t - 1).clamp(min=0), len_t.clamp(max=1)),
             (list(mid), [1] * len(mid))),
            (f"paged_attn_{kv}_verify" + sfx, "verify", qv,
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
            b_ms, by = bound(*paged_attn_work(sts, qls, heads, d, nbytes))
            print(f"phase {tag}: {name} {label} B=32 QS={S} active "
                  f"{sum(n > 0 for n in qls)} max length {ctx_max} "
                  f"H={heads[0]} KVH={heads[1]} D={d} table {nbl}x{BS}: "
                  f"kernel {ms:.4f} ms (alone: {alone:.4f} ms), plain "
                  f"{plain:.4f} ms, sdpa {lib:.4f} ms, bound {b_ms:.4f} ms "
                  f"({by}) [{gpu}]")
            kernel_record(st, name, label, ms, plain, lib, b_ms, by)
            del qs, k, v, m
        del q1, qv, kp, vp, table
        torch.cuda.empty_cache()


def phase10b(torch, np, st):
    """Each B8 instance timed by phase 4's method at phase 4's shapes."""
    unscaled_timings(torch, np, st, E4M3, "10b")


def fp8_model(model):
    """``model`` (weights shared) with an unscaled fp8 KV pool."""
    return pool_model(model, E4M3)


def pool_model(model, kv):
    """``model`` (weights shared) with an unscaled ``kv`` KV pool."""
    return truncated(model, model.cfg.num_layers, kv_dtype=UNSCALED_KV[kv])


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


def unscaled_engines(torch, np, st, kv, tag, bases, cos_min):
    """The ``bases`` (Llama-3-8B's model, "llama-1b") with an unscaled
    ``kv`` pool on the main path: auto, pallas and spec_k 4 engines,
    launches counted; the pool's bytes against bf16's; 4-layer logits
    against the bf16 pool (the smallest logit-row cosine at least
    ``cos_min``).  Phase 10c for e4m3, 11c for e5m2 and f16."""
    import gc

    from k8s_llm_monitor_tpu_torch.models import llama
    from k8s_llm_monitor_tpu_torch.models.config import LLAMA_1B
    from k8s_llm_monitor_tpu_torch.ops import paged_attention as pa
    from k8s_llm_monitor_tpu_torch.serving.kv_cache import page_slice_bytes

    def release():
        # An engine's programs and CUDA graphs reference it back: only the
        # cycle collector frees its pool and graph memory.
        gc.collect()
        torch.cuda.empty_cache()

    release()
    launches = st.setdefault("launches", {})
    gpu = st["gpu"]
    page_dtype = getattr(torch, UNSCALED_KV[kv])
    # The pool's bytes against a bf16 pool's: half on fp8 pages, equal on
    # fp16 ones.
    per_bf16 = kv_bytes(kv) / 2
    pool_name = f"{kv} pool"
    lens = st.get("prompt_lens") or prompt_lengths(np.random.default_rng(2))
    for base in bases:
        if base == "llama-1b":
            base = llama.LlamaModel(LLAMA_1B, seed=1)
        elif base is None:
            base = main_model(st)
        cfg = base.cfg
        mk = pool_model(base, kv)
        big = cfg.head_dim_ == D
        rng = np.random.default_rng(2)
        prompts = [[int(t) for t in rng.integers(3, cfg.vocab_size, size=n)]
                   for n in lens]
        sfx = "" if big else "_d64"
        pre = "flash" if big else "dense"
        for label, over, paths, kernels in (
                ("auto", {}, (pre, "fused"),
                 dict({f"fused_decode_{kv}{sfx}":
                       "paged_decode_attention_fused"},
                      **({f"flash_prefill_{kv}": "flash_prefill_attention"}
                         if big else {}))),
                ("pallas", {"decode_path": "pallas"}, (pre, "pallas"),
                 {f"paged_attn_{kv}{sfx}":
                  "paged_decode_attention_pallas"})):
            name = f"{cfg.name} {pool_name} {label}"
            eng, ids, got, _, tok_s = run_engine(torch, st, mk, prompts, name,
                                                 over, paths, kernels,
                                                 phase=int(tag[:2]))
            if label == "auto":
                off_ids, off_tok_s = ids, tok_s
            check(not eng.kv_quant and not eng.pages.quantized
                  and eng.pages.k[0].dtype == page_dtype,
                  f"{name}: pool {eng.pages.k[0].dtype} kv_quant "
                  f"{eng.kv_quant!r}")
            bf16_pool = cfg.num_layers * eng.ecfg.num_blocks * page_slice_bytes(
                cfg.num_kv_heads, cfg.head_dim_, BS, 2)
            per_tok = eng.pool_bytes // (cfg.num_layers * eng.ecfg.num_blocks
                                         * BS)
            check(eng.pool_bytes == bf16_pool * per_bf16,
                  f"{name}: pool {eng.pool_bytes} B, bf16's {bf16_pool} B")
            launches.update(got)
            run = st["runs"][name]
            ref = st["runs"].get("bf16 graph" if big else "", {})
            print(f"phase {tag}: {name}: pool {eng.pool_bytes} B = "
                  f"{per_bf16:g} x bf16's {bf16_pool} B ({per_tok} B per "
                  f"token and layer); ttft p50 cold / warm "
                  f"{run['ttft'] * 1e3:.1f} / {run['ttft_warm'] * 1e3:.1f} "
                  f"ms, warm decode {run['tok_s']:.1f} tok/s"
                  + (f" (phase 2's bf16 pool: {ref['ttft'] * 1e3:.1f} / "
                     f"{ref['ttft_warm'] * 1e3:.1f} ms, {ref['tok_s']:.1f} "
                     "tok/s)" if ref else "") + f" [{gpu}]")
            del eng
            release()
        # spec_k 4, every decode call drafting: the 8B verifies through
        # flash prefill (B1), llama-1b (prefill dense) through B3 at QS=5.
        verify = ("flash_prefill_attention" if big
                  else "paged_verify_attention_pallas")
        eng, ids, _, spec_tok_s, spec = spec_run(
            torch, st, mk, prompts, f"{cfg.name} {pool_name} spec_k 4",
            dict(spec_k=4, spec_min_accept=0.0), 32, (pre, "fused"),
            (verify,), phase=int(tag[:2]))
        rec = (f"flash_prefill_{kv}_verify" if big
               else f"paged_attn_{kv}_verify_d64")
        launches[rec] = spec_report(torch, eng, f"{cfg.name} {pool_name}",
                                    ids, off_ids, spec_tok_s, off_tok_s, spec,
                                    verify, phase=int(tag[:2]))
        del eng
        release()
        # 4 layers: the kernel paths over the pool against the bf16 pool's
        # (JAX's bound for fp8: cosine > 0.98, tests/test_quantize.py:290).
        m4 = truncated(base, 4)
        ver = (pa.flash_prefill_attention if big
               else pa.paged_verify_attention_pallas)
        pre_impl = pa.flash_prefill_attention if big else None
        want, _ = pool_logits(torch, np, m4, pre_impl,
                              pa.paged_decode_attention_fused, ver)
        for dname, dec in (("fused", pa.paged_decode_attention_fused),
                           ("pallas", pa.paged_decode_attention_pallas)):
            got, pages = pool_logits(torch, np, pool_model(m4, kv), pre_impl,
                                     dec, ver)
            check(pages.k[0].dtype == page_dtype, f"not a {kv} pool")
            cos = cosines(torch, got, want)
            agree, ties, n = argmax_agreement(got, want, QUANT_LOGIT_ATOL)
            print(f"phase {tag}: 4-layer {cfg.name}, {pool_name} ({pre} "
                  f"prefill, {dname} decode, verify on {ver.__name__}) "
                  f"against the bf16 pool: smallest logit-row cosine "
                  f"{cos:.5f} (at least {cos_min}) over first-token, decode "
                  f"and 5 verify rows; argmax agreement {agree:.3f} ({ties} "
                  f"of {n} rows near-ties within {QUANT_LOGIT_ATOL}) [{gpu}]")
            check(cos >= cos_min, f"{cfg.name} {pool_name}: cosine {cos:.5f}")
        # Not on the main path: the 8B verifies through flash prefill, and
        # no spec engine runs Qwen2-7B on the pool.
        for r in (f"paged_attn_{kv}_verify",
                  f"flash_prefill_{kv}_verify_qpk7",
                  f"paged_attn_{kv}_verify_qpk7"):
            launches.setdefault(r, 0)
        if not big:
            del base, mk, m4
            release()


def phase10c(torch, np, st):
    """Llama-3-8B and llama-1b with kv_dtype float8_e4m3fn on the main
    path: auto, pallas and spec_k 4 engines, launches counted; the pool is
    half of bf16's; 4-layer logits against the bf16 pool."""
    unscaled_engines(torch, np, st, E4M3, "10c", (None, "llama-1b"), 0.98)


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
    bf16 at 32 layers, a quarter of it at MAIN_LAYERS), so each
    second-pass prompt finds its whole prefix."""
    from k8s_llm_monitor_tpu_torch.serving.engine import (
        EngineConfig, InferenceEngine, SamplingParams)

    gpu = st["gpu"]
    model = main_model(st)
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
    model = main_model(st)
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


# ---------------------------------------------------------------- phase 11
# B9: the kernels over unscaled float8_e5m2 and float16 pages; A13: the
# server pieces the monitor's default config turns on.

B9_KV = ("e5m2", "f16")
# 11c's bound on the 4-layer logit-row cosine against the bf16 pool: JAX's
# 0.98 for fp8 pages (tests/test_quantize.py:290); fp16 pages round 8x
# finer than the bf16 pool they are held to (PERF.md's prediction).
B9_COS_MIN = {"e5m2": 0.98, "f16": 0.999}


def phase11a(torch, np, st):
    """Each e5m2 and f16 instance against its plain version on its first
    call."""
    for kv in B9_KV:
        unscaled_checks(torch, np, st, kv, "11a")


def phase11b(torch, np, st):
    """The e5m2 and f16 instances timed by phase 4's method at the shapes of
    Llama-3-8B and llama-1b."""
    for kv in B9_KV:
        unscaled_timings(torch, np, st, kv, "11b", qpk7=False)


def phase11c(torch, np, st):
    """Llama-3-8B and llama-1b on the e5m2 and f16 pools: auto, pallas and
    spec_k 4 engines (B1, B2 and B3 launched), pool bytes, 4-layer logits
    against the bf16 pool."""
    for kv in B9_KV:
        unscaled_engines(torch, np, st, kv, "11c", (None, "llama-1b"),
                         B9_COS_MIN[kv])


def burst_ttft(text):
    """The TTFT histogram's count and the decode-step histogram's count
    (every class) in a /metrics body, and the decode host gap gauge."""
    ttft = steps = 0
    gap = None
    for line in text.splitlines():
        name, _, value = line.rpartition(" ")
        if name == "k8s_llm_monitor_engine_ttft_seconds_count":
            ttft = int(value)
        elif name.startswith("k8s_llm_monitor_decode_step_seconds_count"):
            steps += int(value)
        elif name == "k8s_llm_monitor_engine_decode_host_gap_ms":
            gap = float(value)
    return ttft, steps, gap


def phase11d(torch, np, st):
    """The monitor's default config, load_config(None) untouched but for
    server.port 0 and the fake cluster (llama-1b, W8A8, spec_k 4,
    telemetry and remediation on), through build_server: the HTTP burst,
    /metrics lint-clean with the TTFT histogram counting every request
    that got a first token, the signal scraper's local target fresh, a
    Warning burst to a diagnosis and an observe-only plan, /debug/profile
    (a torch.profiler trace; decode_phases on the decode graphs), a UAV
    report round trip; then cmd.server on cuda with no switch in its
    environment."""
    import gc
    import os
    import shutil
    import signal
    import socket
    import tempfile

    from k8s_llm_monitor_tpu_torch.monitor.cluster import (
        FakeCluster, seed_demo_cluster)
    from k8s_llm_monitor_tpu_torch.monitor.config import load_config
    from k8s_llm_monitor_tpu_torch.monitor.exporter import lint_exposition
    from k8s_llm_monitor_tpu_torch.monitor.models import EventInfo
    from k8s_llm_monitor_tpu_torch.monitor.server import build_server
    from k8s_llm_monitor_tpu_torch.ops import paged_attention as pa

    gpu = st["gpu"]
    st.pop("model", None)
    gc.collect()
    torch.cuda.empty_cache()
    cfg = load_config(None)
    cfg.server.host, cfg.server.port = "127.0.0.1", 0
    tc = cfg.llm.tpu
    check(cfg.telemetry.enabled and cfg.remediation.enabled
          and cfg.llm.provider == "tpu"
          and (tc.model, tc.quantize, tc.spec_k) == ("llama-1b", "w8a8", 4),
          f"not the monitor's default config: {cfg.llm}, telemetry "
          f"{cfg.telemetry.enabled}, remediation {cfg.remediation.enabled}")
    fake = seed_demo_cluster(FakeCluster())
    t0 = time.monotonic()
    srv = build_server(cfg, backend=fake)
    boot_s = time.monotonic() - t0
    backend = srv.analysis.backend
    sup = backend.supervisor
    trace_root = None
    try:
        check(srv.signals is not None and srv.remediation is not None
              and srv.diagnosis.remediation is srv.remediation,
              "the signal scraper or the remediation engine is not wired")
        eng = backend.engine
        srv.start()
        port = srv.port
        # Every request that got a token during the burst: its first one.
        served = set()
        sink = eng.token_sink

        def counting_sink(rid, toks, result):
            if toks:
                served.add(rid)
            return sink(rid, toks, result)

        eng.token_sink = counting_sink
        before = burst_ttft(http_call(port, "GET", "/metrics")[1].decode())
        pa.reset_launch_counts()
        with SpecCalls() as spec:
            out, stream, wall = front_door_burst(port)
            torch.cuda.synchronize()
        check_burst(out, stream)
        decode = pa.paged_decode_attention_fused.launches
        verify = spec.launches["paged_verify_attention_pallas"]
        check(spec.calls > 0 and verify > 0 and decode > 0,
              f"default config: {spec.calls} spec calls, {verify} verify "
              f"and {decode} fused decode launches")
        status, body, _ = http_call(port, "GET", "/metrics")
        text = body.decode()
        lint = lint_exposition(text)
        check(status == 200 and not lint, f"/metrics: {status}, lint {lint}")
        after = burst_ttft(text)
        ttft_n = after[0] - before[0]
        check(ttft_n == len(served) > 0,
              f"TTFT histogram counted {ttft_n} first tokens, the engine "
              f"served {len(served)} requests")
        check(after[1] > before[1] and after[2] is not None and after[2] > 0,
              f"decode-step histogram {before[1]} -> {after[1]}, decode "
              f"host gap {after[2]}")
        q_walls = sorted(out[f"query-{i}"][2] for i in range(16))
        print(f"phase 11d: the default config (telemetry and remediation "
              f"on) through build_server in {boot_s:.2f} s; burst of 24 "
              f"over HTTP in {wall:.2f} s, query wall p50 "
              f"{np.percentile(q_walls, 50) * 1e3:.1f} ms, all 200; "
              f"/metrics {len(text.splitlines())} lines, lint clean, TTFT "
              f"histogram +{ttft_n} = {len(served)} requests served, "
              f"decode-step histogram +{after[1] - before[1]}, decode host "
              f"gap EMA {after[2]} ms; launches: fused decode {decode}, "
              f"split paged attention QS=5 {verify} in {spec.calls} spec "
              f"calls [{gpu}]")

        # The telemetry plane: two scrape intervals, the local target fresh.
        time.sleep(2 * cfg.telemetry.scrape_interval_s + 0.5)
        status, sig, _ = http_call(port, "GET", "/api/v1/signals")
        local = sig.get("targets", {}).get("local") if status == 200 else None
        check(local is not None and local["stale"] is False
              and sig["scraper"]["scrapes"] >= 2,
              f"/api/v1/signals: {status} {str(sig)[:300]}")
        status, ts, _ = http_call(port, "GET",
                                  "/api/v1/timeseries?name=busy_slots")
        check(status == 200 and ts["n_series"] >= 1,
              f"/api/v1/timeseries: {status} {str(ts)[:200]}")
        print(f"phase 11d: /api/v1/signals: local target fresh after "
              f"{sig['scraper']['scrapes']} scrapes ({sig['scraper']['series']}"
              f" series), scale_hint {local.get('scale_hint')}, anomalies "
              f"{len(sig['recent_anomalies'])} [{gpu}]")

        # A Warning burst: a diagnosis, then the plan stage (observe-only).
        # The pipeline plans for a warning or critical verdict; an info
        # verdict from the random weights gets its plan stage driven by
        # hand with that verdict at warning.
        for i in range(cfg.diagnosis.burst_threshold + 1):
            srv.diagnosis.handler.on_event(EventInfo(
                type="Warning", reason="BackOff",
                message=f"Back-off restarting failed container in "
                        f"web-frontend (try {i})", source="chip_smoke"))
        deadline = time.monotonic() + 300
        diag = {}
        while time.monotonic() < deadline:
            status, diag, _ = http_call(port, "GET", "/api/v1/diagnoses")
            if diag.get("count", 0) >= 1:
                break
            time.sleep(0.25)
        check(diag.get("count", 0) >= 1, f"no diagnosis: {str(diag)[:300]}")
        srv.diagnosis.stop(timeout=300)    # its plan stage has run
        verdict = diag["diagnoses"][0]["verdict"]
        by_hand = verdict["severity"] not in ("warning", "critical")
        if by_hand:
            srv.remediation.on_verdict(dict(verdict, severity="warning"),
                                       trigger=diag["diagnoses"][0]["trigger"])
        status, rem, _ = http_call(port, "GET", "/api/v1/remediations")
        recs = rem.get("remediations", []) if status == 200 else []
        check(recs and all(r["status"] == "proposed" for r in recs)
              and not rem["counters"]["execute"],
              f"/api/v1/remediations: {status} {str(rem)[:400]}")
        print(f"phase 11d: Warning burst -> diagnosis ({verdict['severity']}"
              f") -> {len(recs)} observe-only plan(s): "
              f"{[(r['plan']['verb'], r['plan']['name'], r['planner']) for r in recs]}"
              + (" (plan stage driven by hand at warning)" if by_hand else "")
              + f" [{gpu}]")

        # /debug/profile behind server.debug: a torch.profiler trace (the
        # first session in the process spends seconds starting the
        # profiler), then decode_phases on the idle engine's decode graphs.
        srv.config.server.debug = True
        trace_root = os.path.join(tempfile.gettempdir(),
                                  "k8s-llm-monitor-trace")
        shutil.rmtree(os.path.join(trace_root, "chip_smoke_11d"),
                      ignore_errors=True)
        fused0 = pa.paged_decode_attention_fused.launches
        status, pbody, prof_s = http_call(port, "POST", "/debug/profile", {
            "seconds": 1.0, "dir": "chip_smoke_11d", "decode_phases": True})
        phases = pbody.get("decode_phases") or {}
        check(status == 200 and pbody.get("trace_dir") == os.path.join(
            trace_root, "chip_smoke_11d") and phases
              and phases["decode_attn_ms"] == eng.decode_attn_ms
              and eng.decode_attn_ms > 0 and eng.decode_sample_ms >= 0,
              f"/debug/profile: {status} {str(pbody)[:400]}")
        traces = [os.path.join(pbody["trace_dir"], f)
                  for f in os.listdir(pbody["trace_dir"])]
        check(len(traces) == 1, f"trace files: {traces}")
        with open(traces[0]) as fh:
            events = json.load(fh).get("traceEvents")
        check(isinstance(events, list), "the trace holds no traceEvents")
        fused = pa.paged_decode_attention_fused.launches - fused0
        check(fused > 0, "decode_phases launched no fused decode kernel")
        text = http_call(port, "GET", "/metrics")[1].decode()
        gauge = [line for line in text.splitlines() if line.startswith(
            "k8s_llm_monitor_engine_decode_attn_ms ")]
        check(gauge == [f"k8s_llm_monitor_engine_decode_attn_ms "
                        f"{round(eng.decode_attn_ms, 4)}"],
              f"decode_attn_ms gauge {gauge}")
        print(f"phase 11d: /debug/profile in {prof_s:.2f} s: a 1 s "
              f"torch.profiler trace of the idle server "
              f"({os.path.getsize(traces[0])} B, {len(events)} events), "
              f"then decode_phases "
              f"{ {k: round(v, 4) for k, v in phases.items()} } ms, "
              f"{fused} fused decode launches (the decode graphs) [{gpu}]")

        # A UAV report and its metrics.
        node = "k3d-demo-agent-0"
        status, rep, _ = http_call(port, "POST", "/api/v1/uav/report", {
            "node_name": node, "uav_id": "uav-chip", "status": "active",
            "heartbeat_interval_seconds": 5,
            "state": {"battery": {"voltage": 12.4,
                                  "remaining_percent": 80.0}}})
        s2, one, _ = http_call(port, "GET", f"/api/v1/metrics/uav/{node}")
        s3, crd, _ = http_call(port, "GET", "/api/v1/crd/uav?namespace=all")
        check(status == 200 and rep["crd_status"] == "updated"
              and s2 == 200 and one["data"]["uav_id"] == "uav-chip"
              and s3 == 200 and crd["count"] >= 1,
              f"UAV round trip: {status} {rep}, {s2} {one}, {s3}")
        print(f"phase 11d: UAV report -> CRD {rep['crd_status']}, metrics "
              f"for {node} read back, {crd['count']} UAVMetric CRD(s) "
              f"[{gpu}]")
    finally:
        sup.shutdown(grace_s=0.0)
        srv.stop()
        del backend, sup, srv, eng
        gc.collect()
        torch.cuda.empty_cache()
        if trace_root is not None:
            shutil.rmtree(os.path.join(trace_root, "chip_smoke_11d"),
                          ignore_errors=True)

    # cmd.server on cuda, the default config, no switch in its environment.
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_11d_")
    env = dict(os.environ, K8SLLM_FLIGHT_DIR=os.path.join(tmp, "flight"))
    env.pop("TELEMETRY_ENABLED", None)
    env.pop("REMEDIATION_ENABLED", None)
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
        while time.monotonic() - t0 < 300 and proc.poll() is None:
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
        check(status == 200 and body.get("status") == "success",
              f"cmd.server query: {status} {str(body)[:300]}")
        m_status, mbody, _ = http_call(port, "GET", "/metrics")
        lint = lint_exposition(mbody.decode()) if m_status == 200 else None
        check(m_status == 200 and lint == [],
              f"cmd.server /metrics: {m_status}, lint {lint}")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        check(rc == 0, f"cmd.server exited {rc} on SIGTERM")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        with open(log_path) as fh:
            log_text = fh.read()
        shutil.rmtree(tmp, ignore_errors=True)
    check("signal scraper stopped" in log_text,
          "cmd.server did not stop its signal scraper")
    print(f"phase 11d: cmd.server (cuda, load_config defaults, no "
          f"TELEMETRY_ENABLED / REMEDIATION_ENABLED): ready in {ready_s:.1f}"
          f" s, a query in {q_s * 1e3:.1f} ms, /metrics lint clean, exit 0 "
          f"on SIGTERM [{gpu}]")


def phase11(torch, np, st):
    for sub in (phase11a, phase11b, phase11c, phase11d):
        t0 = time.monotonic()
        sub(torch, np, st)
        torch.cuda.synchronize()
        print(f"phase 11: {sub.__name__[-3:]} passed in "
              f"{time.monotonic() - t0:.1f} s")


# ---------------------------------------------------------------- phase 12
# A7: tensor parallelism over the model axis.  One process per rank
# (parallel/mesh.py): NCCL with a card per rank, else two ranks sharing the
# one card over gloo (host-staged collectives; labelled so in every line).

# Per-rank head geometries of the TP paths, (query heads, kv heads): what
# each kernel sees on one rank.
TP_HEADS = (
    ("h16kv4", (16, 4)),    # Llama-3-8B at TP 2 (12b's path)
    ("h4kv1", (4, 1)),      # Llama-3-8B at TP 8: one kv head per rank
    ("h14kv2", (14, 2)),    # Qwen2-7B at TP 2: 7 query heads per kv head
    ("h32kv4", (32, 4)),    # Qwen2-72B / Llama-3-70B at TP 2
    ("h16kv2", (16, 2)),    # Qwen2-72B / Llama-3-70B at TP 4
)
# 12c's default config at TP 2 (llama-1b, head_dim 64): B3's D = 64
# instance at 16 / 4 heads per rank.
TP_HEADS_D64 = ("d64_h16kv4", (16, 4))
# 12b's bars (stated before the first run, PERF.md section 6): the bf16
# all-reduce sums the ranks' rounded partials, so TP-2 is held to TP-1 by
# the smallest logit-row cosine, and to a share of equal id sequences.
TP_COS_MIN = 0.999
TP_IDS_MIN_SHARE = 0.25
# 12f: seconds a break may take before every thread's stack is printed
# (a rebuild took 16-29 s over NCCL; one hung).
REBUILD_STACKS_S = 120
TP_ECFG = dict(max_slots=32, num_blocks=4096, block_size=BS,
               max_blocks_per_seq=ENGINE_TABLE, max_prefills_per_step=8,
               decode_steps_per_iter=8, prefix_cache_entries=0)


def mesh_label(mesh) -> str:
    """The backend and the cards a mesh runs on (gloo: host-staged)."""
    import torch

    cards = sorted({d.index for d in mesh.devices})
    c = mesh.config
    what = (f"TP {mesh.tp}" if c.data == c.seq == 1
            else f"mesh {c.data},{c.seq},{c.model}")
    return (f"{what} over {mesh.backend}"
            + (" (host-staged)" if mesh.backend == "gloo" else "")
            + f" on {len(cards)} card(s) of {torch.cuda.device_count()}")


def tp_shard_checks(torch, np, st):
    """12a: flash prefill (B1) and split paged attention (B3) at each
    per-rank head geometry against their plain versions on the first call,
    then timed by phase 4's method (kernel, alone, plain, SDPA, bound)."""
    import torch.nn.functional as F

    from k8s_llm_monitor_tpu_torch.ops import paged_attention as pa

    rng = np.random.default_rng(12)
    gen = torch.Generator(device="cuda").manual_seed(12)
    errs = st.setdefault("max_abs_err", {})
    ulps = {}
    gpu = st["gpu"]
    lens = prompt_lengths(np.random.default_rng(2))
    shapes = [(f"flash_prefill_{label}", heads, D) for label, heads in TP_HEADS]
    shapes += [(f"paged_attn_{label}", heads, D) for label, heads in TP_HEADS]
    shapes.append((f"paged_attn_{TP_HEADS_D64[0]}", TP_HEADS_D64[1], D64))
    for name, heads, d in shapes:
        if name.startswith("flash_prefill"):
            # Checks: the admission round and the prefix-hit round (a
            # continuation), empty lanes zero.  Timed at the admission.
            for label, S, starts, lengths in (
                    ("admission", 1024, [0] * 8,
                     [min(n, 1024) for n in lens[:7]] + [0]),
                    ("hit", 256, *HIT_SHAPE)):
                case = prefill_case(torch, rng, gen, len(starts), S, starts,
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
                del case, got, want
            label, S, starts, lengths = ("admission", 1024, [0] * 8,
                                         [min(n, 1024) for n in lens[:8]])
            case = prefill_case(torch, rng, gen, len(starts), S, starts,
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
            qs, k, v, m = sdpa_args(torch, case[0] * D ** -0.5, case[1],
                                    case[2], case[3], ctx_max, keys <= pos, {})
            lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
                qs, k, v, attn_mask=m, scale=1.0), reps=5)
            b_ms, by = bound(*prefill_work(starts, lengths, S, "", heads))
            # flash_prefill.cu's grid: (KVH, B, S / TQ), a tile of TQ = 128 /
            # (query heads per kv head, rounded up to a power of two) rows.
            qpk = heads[0] // heads[1]
            tq = 128 // (1 << (qpk - 1).bit_length())
            grid = (heads[1], len(starts), (S + tq - 1) // tq)
            print(f"phase 12a: {name} H={heads[0]} KVH={heads[1]} D={d}: "
                  f"admission and hit rounds ok, max abs err {errs[name]:.4g},"
                  f" max err {ulps[name]:.3g} ulps of the row; {label} B=8 "
                  f"S={S} (grid {grid}, {tq} positions a tile): kernel "
                  f"{ms:.4f} ms (alone, on pre-scaled q: {alone:.4f} ms), "
                  f"plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound "
                  f"{b_ms:.4f} ms ({by}) [{gpu}]")
            kernel_record(st, name, label, ms, plain, lib, b_ms, by)
            del case, qs, k, v, m
            torch.cuda.empty_cache()
            continue
        # B3 (decode, QS = 1): both sides of the key chunks, an empty lane,
        # rows of 2048 keys; then the engine shape (32 lanes, the 256-block
        # table), timed.
        positions = [0, 5, 1, 15, 16, 127, 128, 129, 255, 256, 257, 2047] + [
            int(x) for x in rng.integers(1, 2048, size=20)]
        q, _, _, _, _, kp, vp, table, pos = decode_case(
            torch, rng, gen, positions, 2048 // BS + 1, heads, BS, d)
        ln = pos + 1
        ln[1] = 0
        got = pa.paged_decode_attention_pallas(q, kp, vp, table, ln)
        want = pa.flash_prefill_attention_plain(
            q, kp, vp, table, (ln - 1).clamp(min=0), ln.clamp(max=1))
        torch.cuda.synchronize()
        check(bool((got[1] == 0).all()), f"{name}: the empty lane is not "
                                         "zeroed")
        check_rows(torch, name, got, want, ln > 0, errs, ulps)
        del q, kp, vp, table, got, want
        mid = [n + 16 for n in lens] + [0] * (32 - len(lens))
        q, _, _, _, _, kp, vp, table, _ = decode_case(
            torch, rng, gen, mid, ENGINE_TABLE, heads, BS, d)
        len_t = torch.tensor([p + 1 for p in mid], dtype=torch.int32,
                             device="cuda")
        ms = time_ms(torch, lambda: pa.paged_decode_attention_pallas(
            q, kp, vp, table, len_t), rounds=5)
        alone = graph_ms(torch, paged_alone(torch, pa, q, kp, vp, table,
                                            lengths=len_t))
        plain = time_ms(torch, lambda: pa.flash_prefill_attention_plain(
            q, kp, vp, table, (len_t - 1).clamp(min=0), len_t.clamp(max=1)),
            reps=5)
        ctx_max = max(mid) + 1
        pos = (len_t - 1).clamp(min=0)[:, None, None]
        keys = torch.arange(ctx_max, device="cuda")[None, None, :]
        qs, k, v, m = sdpa_args(torch, q * d ** -0.5, kp, vp, table, ctx_max,
                                keys <= pos, {})
        lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qs, k, v, attn_mask=m, scale=1.0), reps=5)
        b_ms, by = bound(*paged_attn_work(list(mid), [1] * len(mid), heads,
                                          d))
        nsplit, chunk = pa.decode_splits(ENGINE_TABLE, BS, 2)
        ws = pa.decode_workspace_floats(32, heads[1], heads[0] // heads[1],
                                        nsplit, d)
        print(f"phase 12a: {name} QS=1 H={heads[0]} KVH={heads[1]} D={d}: "
              f"ok, max abs err {errs[name]:.4g}, max err {ulps[name]:.3g} "
              f"ulps of the row; engine B=32 table {ENGINE_TABLE}x{BS} "
              f"({nsplit} splits of {chunk} keys, workspace {ws} floats): "
              f"kernel {ms:.4f} ms (alone: {alone:.4f} ms), plain "
              f"{plain:.4f} ms, sdpa {lib:.4f} ms, bound {b_ms:.4f} ms "
              f"({by}) [{gpu}]")
        kernel_record(st, name, "engine", ms, plain, lib, b_ms, by)
        del q, kp, vp, table, qs, k, v, m
        torch.cuda.empty_cache()
    print(f"phase 12a: tolerance atol {TOL['atol']} rtol {TOL['rtol']} and "
          f"{ULP_TOL} bf16 ulps of each (row, head)'s largest value; empty "
          "lanes zero")


def rank_launches(mesh, names):
    """Each rank's launch counts of the wrappers ``names`` (rank 0 first)."""
    from k8s_llm_monitor_tpu_torch.ops import paged_attention as pa

    mine = {fn.__name__: fn.launches for fn in pa.KERNEL_WRAPPERS}
    return [{n: c[n] for n in names} for c in [mine] + mesh.request(
        "launches")]


def reset_rank_launches(mesh):
    from k8s_llm_monitor_tpu_torch.ops import paged_attention as pa

    pa.reset_launch_counts()
    mesh.send("reset_launches")


def tp_engine_run(torch, st, mesh, model, prompts, name, overrides, kernels,
                  warm=True):
    """One engine over ``mesh`` (None: one card): two identical greedy runs
    of ``prompts`` (one with ``warm`` False), launch counts set to 0 on
    every rank just before the first and read just after it.  Returns
    (ids, per-rank launches of the wrappers in ``kernels`` ({record:
    wrapper}), ttft p50 and decode tok/s of the warm run (of the cold one
    without ``warm``), the engine)."""
    from k8s_llm_monitor_tpu_torch.serving.engine import (
        EngineConfig, InferenceEngine, SamplingParams)

    eng = InferenceEngine(model.cfg, model, EngineConfig(**{**TP_ECFG,
                                                           **overrides}))
    sp = SamplingParams(max_tokens=32)
    if mesh is not None:
        reset_rank_launches(mesh)
    else:
        from k8s_llm_monitor_tpu_torch.ops import paged_attention as pa

        pa.reset_launch_counts()
    t0 = time.monotonic()
    res = eng.generate(prompts, sp)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    names = sorted(set(kernels.values()))
    if mesh is not None:
        mesh.sync()
        per_rank = rank_launches(mesh, names)
    else:
        from k8s_llm_monitor_tpu_torch.ops import paged_attention as pa

        per_rank = [{n: getattr(pa, n).launches for n in names}]
    for r in res:
        check(r.finish_reason in ("eos", "length") and all(
            0 <= t < model.cfg.vocab_size for t in r.token_ids),
            f"{name} {r.request_id}: {r.finish_reason} {r.error}")
    for rank, counts in enumerate(per_rank):
        check(all(n > 0 for n in counts.values()),
              f"{name}: rank {rank} launched {counts}")
    check(eng.dispatch_failures == 0 and eng.watchdog_trips == 0,
          f"{name}: {eng.dispatch_failures} dispatch failures")
    ids = [r.token_ids for r in res]
    if not warm:
        ttft = statistics.median(r.ttft_s for r in res)
        tok_s = eng.decode_tokens / eng.decode_s
        print(f"phase 12: {name}: paths {eng.prefill_path}/"
              f"{eng.decode_path}, tp_overlap {eng.tp_overlap}, decode "
              f"graphs {eng.decode_graphs}; one (cold) run {wall:.2f} s; "
              f"launches per rank {per_rank}; ttft p50 {ttft * 1e3:.1f} "
              f"ms, decode {tok_s:.1f} tok/s, pool {eng.pool_bytes} B per "
              f"rank [{st['gpu']}]")
        return ids, per_rank, ttft, tok_s, eng
    tokens0, secs0 = eng.decode_tokens, eng.decode_s
    res2 = eng.generate(prompts, sp)
    check([r.token_ids for r in res2] == ids,
          f"{name}: the second identical run gave other ids")
    ttft = statistics.median(r.ttft_s for r in res2)
    tok_s = (eng.decode_tokens - tokens0) / (eng.decode_s - secs0)
    print(f"phase 12: {name}: paths {eng.prefill_path}/{eng.decode_path}, "
          f"tp_overlap {eng.tp_overlap}, decode graphs {eng.decode_graphs}; "
          f"cold run {wall:.2f} s; launches per rank {per_rank}; warm run: "
          f"ttft p50 {ttft * 1e3:.1f} ms, decode {tok_s:.1f} tok/s, pool "
          f"{eng.pool_bytes} B per rank [{st['gpu']}]")
    return ids, per_rank, ttft, tok_s, eng


def tp_logits(torch, np, model, vocab):
    """forward_full logits of 4 prompts of 256 tokens (the last 32 rows)."""
    from k8s_llm_monitor_tpu_torch.models import llama

    rng = np.random.default_rng(12)
    toks = torch.from_numpy(rng.integers(3, vocab, size=(4, 256)).astype(
        np.int32)).cuda()
    out = llama.forward_full(model, toks)[:, -32:]
    torch.cuda.synchronize()
    return out


def phase12b(torch, np, st):
    """Llama-3-8B at full width and depth at TP 2 against TP 1 on the same
    prompts: logit cosine, a share of equal greedy id sequences, B1 and B3
    launched on every rank, tp_overlap on against off (equal ids), and the
    all-reduce's rate on the mesh."""
    import gc

    from k8s_llm_monitor_tpu_torch.models import llama
    from k8s_llm_monitor_tpu_torch.models.config import LLAMA3_8B
    from k8s_llm_monitor_tpu_torch.parallel.mesh import (
        MeshConfig, bench_all_reduce, create_mesh)

    gpu = st["gpu"]
    backend = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    t0 = time.monotonic()
    mesh = create_mesh(MeshConfig(model=2), backend=backend)
    st["mesh"] = mesh
    print(f"phase 12b: {mesh_label(mesh)}: mesh up in "
          f"{time.monotonic() - t0:.2f} s (rank 1 spawned)")
    numel = 32 << 20
    ms = bench_all_reduce(mesh, numel, 20)
    bus = 2.0 * (mesh.tp - 1) / mesh.tp * numel * 2 / (ms * 1e-3) / 1e9
    print(f"phase 12b: all-reduce of {numel * 2 >> 20} MiB bf16 over "
          f"{mesh_label(mesh)}: {ms:.3f} ms, bus bandwidth {bus:.2f} GB/s "
          f"[{gpu}]")
    st["tp_allreduce"] = (mesh.backend, ms, bus)
    rng = np.random.default_rng(12)
    prompts = [[int(t) for t in rng.integers(3, LLAMA3_8B.vocab_size, size=n)]
               for n in rng.integers(64, 513, size=16)]
    ref = llama.LlamaModel(LLAMA3_8B, seed=0)
    want = tp_logits(torch, np, ref, LLAMA3_8B.vocab_size)
    ref_ids, _, ref_ttft, ref_tok_s, eng = tp_engine_run(
        torch, st, None, ref, prompts, "Llama-3-8B TP 1 (pallas decode)",
        {"decode_path": "pallas"},
        {"flash_prefill": "flash_prefill_attention",
         "paged_attn": "paged_decode_attention_pallas"})
    del eng, ref
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    model = llama.LlamaModel(LLAMA3_8B, seed=0, mesh=mesh)
    mesh.sync()
    print(f"phase 12b: Llama-3-8B (32 layers, full width) sharded over "
          f"{mesh_label(mesh)} in {time.monotonic() - t0:.2f} s")
    got = tp_logits(torch, np, model, LLAMA3_8B.vocab_size)
    cos = cosines(torch, [got.reshape(-1, got.shape[-1])],
                  [want.reshape(-1, want.shape[-1])])
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    print(f"phase 12b: forward_full logits TP 2 vs TP 1, 4 x 256 tokens (the "
          f"last 32 rows each): smallest row cosine {cos:.6f} (at least "
          f"{TP_COS_MIN}), argmax agreement {agree:.3f} [{gpu}]")
    check(cos >= TP_COS_MIN, f"TP 2 logits cosine {cos:.6f}")
    runs = {}
    kernels = {"flash_prefill_h16kv4": "flash_prefill_attention",
               "paged_attn_h16kv4": "paged_decode_attention_pallas"}
    # Each TP-2 engine runs its prompts once (the engine is eager over
    # gloo, so a second run would time the same work again): off's ids
    # equal to on's hold them reproducible across both schedules.
    for overlap in ("on", "off"):
        t1 = time.monotonic()
        ids, per_rank, ttft, tok_s, eng = tp_engine_run(
            torch, st, mesh, model, prompts,
            f"Llama-3-8B {mesh_label(mesh)}, tp_overlap {overlap}",
            {"tp_overlap": overlap}, kernels, warm=False)
        print(f"phase 12b: tp_overlap {overlap}: {time.monotonic() - t1:.1f} "
              f"s with the engine's build")
        check(eng.tp_overlap == (overlap == "on")
              and (eng.prefill_path, eng.decode_path) == ("flash", "pallas"),
              f"TP engine: {eng.prefill_path}/{eng.decode_path} overlap "
              f"{eng.tp_overlap}")
        runs[overlap] = ids, per_rank, ttft, tok_s
        del eng
        gc.collect()
    check(runs["on"][0] == runs["off"][0],
          "tp_overlap on and off gave other ids")
    same = sum(a == b for a, b in zip(runs["on"][0], ref_ids))
    first = sum(a[:1] == b[:1] for a, b in zip(runs["on"][0], ref_ids))
    print(f"phase 12b: greedy ids TP 2 vs TP 1: {same} of {len(prompts)} "
          f"sequences of 32 tokens equal (at least {TP_IDS_MIN_SHARE:.0%}), "
          f"{first} first tokens equal; tp_overlap on = off; TP 2 cold "
          f"ttft p50 {runs['on'][2] * 1e3:.1f} / {runs['off'][2] * 1e3:.1f} "
          f"ms (on / off), TP 1 warm {ref_ttft * 1e3:.1f} ms; decode "
          f"{runs['on'][3]:.1f} / {runs['off'][3]:.1f} tok/s, TP 1 "
          f"{ref_tok_s:.1f} tok/s [{gpu}]")
    check(same >= TP_IDS_MIN_SHARE * len(prompts),
          f"only {same} of {len(prompts)} id sequences equal TP 1's")
    launches = st.setdefault("launches", {})
    for rec, fn in kernels.items():
        launches[rec] = runs["on"][1][0][fn]
    st["tp_runs"] = dict(ref=(ref_ttft, ref_tok_s), on=runs["on"][2:],
                         off=runs["off"][2:], same=same)
    del model
    gc.collect()
    torch.cuda.empty_cache()


def mesh_burst(port, n):
    """``n`` queries at once over HTTP (12c's burst: on one card the mesh's
    collectives go through host memory, about 0.2 s a decode step, so it
    is smaller than phase 6's).  Returns ({name: (status, body, wall)},
    wall)."""
    import threading

    out, errors = {}, []
    go = threading.Event()

    def run(i):
        go.wait()
        try:
            out[f"query-{i}"] = http_call(port, "POST", "/api/v1/query", {
                "question": QUERIES[i % len(QUERIES)] + f" (case {i})"})
        except Exception as exc:            # reported below
            errors.append(f"query-{i}: {type(exc).__name__}: {exc}")

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    t0 = time.monotonic()
    go.set()
    for t in threads:
        t.join(timeout=600)
    check(not any(t.is_alive() for t in threads) and not errors,
          f"mesh burst: {errors}")
    for name, (status, body, _) in out.items():
        check(status == 200 and body.get("status") == "success",
              f"{name}: HTTP {status} {str(body)[:200]}")
    return out, time.monotonic() - t0


def phase12c(torch, np, st, subs=("12c", "12e", "12f")):
    """12c: the monitor's default config with llm.tpu.mesh_shape "1,1,2"
    (and the port and the fake cluster) through build_server: over NCCL
    phase 6's burst of 24 at the config's own llm.max_tokens, the verdicts
    of the grammar's schema; over gloo (host-staged) 4 queries of 32
    tokens; all 200, /metrics' mesh gauge at model 2, /api/v1/stats' mesh
    block.  12e: a step-loop kill under TP rebuilds the engine on the
    same workers, which serve again.  12f: a decode call that fails on
    rank 0 after its send, then rank 1 killed: each breaks the mesh, the
    supervisor builds a new one, and a greedy generate gives the ids it
    gave before either.  Then cmd.server with the mesh shape in its
    environment (ready, the gauge, exit 0).  Its own mesh (one process
    group per process)."""
    import faulthandler
    import gc
    import os
    import signal
    import socket
    import tempfile

    from k8s_llm_monitor_tpu_torch.monitor.cluster import (
        FakeCluster, seed_demo_cluster)
    from k8s_llm_monitor_tpu_torch.monitor.config import load_config
    from k8s_llm_monitor_tpu_torch.monitor.server import build_server
    from k8s_llm_monitor_tpu_torch.ops import paged_attention as pa
    from k8s_llm_monitor_tpu_torch.parallel import mesh as mesh_mod
    from k8s_llm_monitor_tpu_torch.resilience.faults import get_injector
    from k8s_llm_monitor_tpu_torch.serving.engine import SamplingParams

    gpu = st["gpu"]
    backend = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    cfg = load_config(None)
    cfg.server.host, cfg.server.port = "127.0.0.1", 0
    cfg.llm.tpu.mesh_shape = "1,1,2"
    if backend == "gloo":
        # On one card the mesh's collectives go through host memory
        # (about 0.2 s a decode step), and a query of random weights runs
        # to llm.max_tokens: a burst of 24 took 1,377.5 s (PERF.md, PR 15
        # run A).  A size-reduced smoke: 4 queries of 32 tokens.
        cfg.llm.max_tokens = 32
    t0 = time.monotonic()
    srv = build_server(cfg, backend=seed_demo_cluster(FakeCluster()),
                       mesh_backend=backend)
    boot_s = time.monotonic() - t0
    backend_ = srv.analysis.backend
    sup = backend_.supervisor
    mesh = backend_.mesh

    def greedy_ids():
        """The ids of an 8-token greedy generate through the backend (the
        text of random weights may decode to '')."""
        res = backend_._result(backend_._submit(
            backend_.tokenizer.encode("why crashloop?"),
            SamplingParams(max_tokens=8, temperature=0.0)), "generation")
        return list(res.token_ids)

    try:
        eng = backend_.engine
        check(eng.mesh_axes() == {"data": 1, "seq": 1, "model": 2}
              and eng.decode_path == "pallas",
              f"12c engine: {eng.mesh_axes()} {eng.decode_path}")
        srv.start()
        port = srv.port
        if "12e" not in subs:
            # 12f's ids without 12e: the first request on a fresh
            # engine.
            want = greedy_ids()
        if "12c" in subs:
            reset_rank_launches(mesh)
            if backend == "gloo":
                out, wall = mesh_burst(port, 4)
                what = "4 queries of 32 tokens (gloo: size-reduced)"
            else:
                out, stream, wall = front_door_burst(port)
                check_burst(out, stream)
                what = (f"phase 6's burst of 24 at llm.max_tokens "
                        f"{cfg.llm.max_tokens}, verdicts of the schema")
            torch.cuda.synchronize()
            per_rank = rank_launches(mesh, ["paged_decode_attention_pallas"])
            check(all(c["paged_decode_attention_pallas"] > 0 for c in per_rank),
                  f"12c: B3 launches per rank {per_rank}")
            st.setdefault("launches", {})[f"paged_attn_{TP_HEADS_D64[0]}"] = (
                per_rank[0]["paged_decode_attention_pallas"])
            status, body, _ = http_call(port, "GET", "/metrics")
            text = body.decode()
            gauge = [line for line in text.splitlines()
                     if line.startswith("k8s_llm_monitor_mesh_axes{")]
            check(status == 200 and 'k8s_llm_monitor_mesh_axes{axis="model"} 2'
                  in gauge, f"/metrics mesh gauge: {gauge}")
            status, stats, _ = http_call(port, "GET", "/api/v1/stats")
            q_walls = sorted(v[2] for k, v in out.items()
                             if k.startswith("query-"))
            print(f"phase 12c: the default config with mesh_shape 1,1,2 "
                  f"({mesh_label(mesh)}) through build_server in {boot_s:.2f} s;"
                  f" {what}: at once over HTTP in {wall:.2f} s, query wall p50 "
                  f"{np.percentile(q_walls, 50) * 1e3:.1f} ms, all 200; "
                  f"{gauge}; stats mesh {stats['engine']['mesh']}; B3 (D=64) "
                  f"launches per rank {per_rank} [{gpu}]")
        if "12e" in subs:
            # 12e: the step loop dies; the supervisor rebuilds the engine (and
            # with it the workers' copy) and serves again.
            get_injector().arm("step_loop_crash", rate=1.0, times=1)
            t0 = time.monotonic()
            while sup.restarts < 1 and time.monotonic() - t0 < 120:
                time.sleep(0.05)
            while sup.state != "serving" and time.monotonic() - t0 < 120:
                time.sleep(0.05)
            check(sup.restarts == 1 and sup.state == "serving",
                  f"12e: restarts {sup.restarts}, state {sup.state}")
            rebuilt = sup.service.engine
            check(rebuilt is not eng and rebuilt.mesh is mesh
                  and rebuilt._mesh_token == mesh.engine_token,
                  "12e: the rebuilt engine is not the workers' engine")
            rebuilt_s = time.monotonic() - t0
            t0 = time.monotonic()
            # The first request on a fresh engine: 12f's rebuilt meshes must
            # give its ids (greedy; the spec acceptance EMA starts anew on
            # each engine, so the same first request takes the same path).
            want = greedy_ids()
            gen_s = time.monotonic() - t0
            check(len(want) > 0, "12e: no ids after the rebuild")
            print(f"phase 12e: step_loop_crash under TP: rebuilt in "
                  f"{rebuilt_s:.2f} s (restarts {sup.restarts}), the workers "
                  f"hold the new engine, an 8-token greedy generate after it "
                  f"in {gen_s * 1e3:.1f} ms [{gpu}]")
        if "12f" in subs:
            # 12f: breaks of the mesh, each rebuilt by the supervisor on a new
            # mesh: an admission failing on rank 0 after its send (the worker
            # waits in a collective rank 0 never joins), and rank 1 killed.
            # Each request runs whole on the new mesh's fresh engine.
            for n, (how, brk) in enumerate((
                    ("prefill_dispatch after the send",
                     lambda: get_injector().arm("prefill_dispatch", rate=1.0,
                                                times=1)),
                    ("rank 1 killed", lambda: backend_.mesh._procs[0].kill())),
                    start=sup.restarts + 1):
                old = backend_.mesh
                t0 = time.monotonic()
                # A rebuild that hangs prints where every thread waits.
                faulthandler.dump_traceback_later(REBUILD_STACKS_S)
                brk()
                ids = greedy_ids()
                faulthandler.cancel_dump_traceback_later()
                took = time.monotonic() - t0
                new = backend_.mesh
                check(sup.restarts == n and old.broken is not None
                      and new is not old and new.healthy()
                      and not any(p.is_alive() for p in old._procs),
                      f"12f ({how}): restarts {sup.restarts}, broken "
                      f"{old.broken}")
                check(len(want) > 0 and ids == want,
                      f"12f ({how}): ids {ids}, {want} on the first fresh "
                      "engine")
                print(f"phase 12f: {how} ({mesh_label(new)}): the mesh broke "
                      f"({old.broken[:90]}), a new mesh and the model on it "
                      f"rebuilt and the 8-token greedy generate served in "
                      f"{took:.2f} s, the fresh engine's ids {ids} "
                      f"[{gpu}]")
    finally:
        get_injector().disarm("step_loop_crash")
        get_injector().disarm("prefill_dispatch")
        live = backend_.mesh
        # A teardown that hangs prints where every thread waits.
        faulthandler.dump_traceback_later(REBUILD_STACKS_S)
        t0 = time.monotonic()
        sup.shutdown(grace_s=0.0)
        srv.stop()
        t1 = time.monotonic()
        live.close()
        t2 = time.monotonic()
        del backend_, sup, srv
        gc.collect()
        torch.cuda.empty_cache()
        faulthandler.cancel_dump_traceback_later()
        print(f"phase 12c: teardown: the supervisor and the server stopped "
              f"in {t1 - t0:.2f} s, {mesh_label(live)} closed in "
              f"{t2 - t1:.2f} s, the rest {time.monotonic() - t2:.2f} s",
              flush=True)
        # A close that could not leave the process group marks the
        # process unusable (parallel/mesh.py, ROADMAP C4): no later mesh.
        stuck = mesh_mod.unusable()
        if stuck:
            raise RuntimeError(f"the close of {mesh_label(live)}: {stuck}")

    if "12c" in subs:
        # cmd.server with the mesh shape in its environment.
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        tmp = tempfile.mkdtemp(prefix="chip_smoke_12c_")
        env = dict(os.environ, K8SLLM_FLIGHT_DIR=os.path.join(tmp, "flight"),
                   LLM_TPU_MESH_SHAPE="1,1,2")
        log_path = os.path.join(tmp, "cmd_server.log")
        root = os.path.dirname(os.path.abspath(__file__))
        t0 = time.monotonic()
        with open(log_path, "w") as log:
            proc = subprocess.Popen(
                [sys.executable, "-m", "k8s_llm_monitor_tpu_torch.cmd.server",
                 "--cluster", "fake", "--host", "127.0.0.1", "--port", str(port),
                 "--mesh-backend", backend],
                cwd=root, env=env, stdout=log, stderr=subprocess.STDOUT)
        try:
            ready = False
            while time.monotonic() - t0 < 300 and proc.poll() is None:
                try:
                    status, body, _ = http_call(port, "GET", "/readyz",
                                                timeout=5.0)
                    ready = status == 200 and body["ready"]
                except OSError:
                    pass
                if ready:
                    break
                time.sleep(0.25)
            check(ready, f"cmd.server (mesh) never became ready "
                         f"(rc {proc.poll()})")
            ready_s = time.monotonic() - t0
            text = http_call(port, "GET", "/metrics")[1].decode()
            check('k8s_llm_monitor_mesh_axes{axis="model"} 2' in text,
                  "cmd.server (mesh): no model-2 mesh gauge")
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=120)
            check(rc == 0, f"cmd.server (mesh) exited {rc} on SIGTERM")
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
            with open(log_path) as fh:
                log_text = fh.read()
        print(f"phase 12c: cmd.server (cuda, LLM_TPU_MESH_SHAPE=1,1,2, "
              f"--mesh-backend {backend}): ready in {ready_s:.1f} s, "
              f"/metrics mesh gauge model 2, exit 0 on SIGTERM "
              f"({len(log_text.splitlines())} log lines) [{gpu}]")


def phase12d(torch, np, st):
    """Qwen2-72B at full width: TP 4 at full depth over NCCL where four
    cards exist, else 12b's two ranks at a reduced depth (printed), held
    there to TP 1 at the same depth; B1 and B3 launched on every rank."""
    import dataclasses
    import gc

    from k8s_llm_monitor_tpu_torch.models import llama
    from k8s_llm_monitor_tpu_torch.models.config import QWEN2_72B
    from k8s_llm_monitor_tpu_torch.parallel.mesh import (
        MeshConfig, create_mesh)

    gpu = st["gpu"]
    four = torch.cuda.device_count() >= 4
    if four:
        if "mesh" in st:
            st.pop("mesh").close()
        mesh = st["mesh"] = create_mesh(MeshConfig(model=4))
        cfg = QWEN2_72B
    else:
        if "mesh" not in st:
            st["mesh"] = create_mesh(MeshConfig(model=2), backend="gloo")
        mesh = st["mesh"]
        cfg = dataclasses.replace(QWEN2_72B, num_layers=8)
    label = f"h{cfg.num_heads // mesh.tp}kv{cfg.num_kv_heads // mesh.tp}"
    rng = np.random.default_rng(13)
    prompts = [[int(t) for t in rng.integers(3, cfg.vocab_size, size=n)]
               for n in (40, 200, 513, 1000)]
    want = None
    if not four:
        ref = llama.LlamaModel(cfg, seed=0)
        want = tp_logits(torch, np, ref, cfg.vocab_size)
        del ref
        gc.collect()
        torch.cuda.empty_cache()
    t0 = time.monotonic()
    model = llama.LlamaModel(cfg, seed=0, mesh=mesh)
    mesh.sync()
    print(f"phase 12d: {cfg.name} at full width, {cfg.num_layers} of 80 "
          f"layers, over {mesh_label(mesh)}: sharded from seed 0 in "
          f"{time.monotonic() - t0:.2f} s, {label} heads per rank")
    got = tp_logits(torch, np, model, cfg.vocab_size)
    check(bool(torch.isfinite(got).all()), f"{cfg.name}: non-finite logits")
    if want is not None:
        cos = cosines(torch, [got.reshape(-1, got.shape[-1])],
                      [want.reshape(-1, want.shape[-1])])
        print(f"phase 12d: forward_full logits TP {mesh.tp} vs TP 1 at "
              f"{cfg.num_layers} layers: smallest row cosine {cos:.6f} "
              f"(at least {TP_COS_MIN}) [{gpu}]")
        check(cos >= TP_COS_MIN, f"{cfg.name}: TP cosine {cos:.6f}")
    kernels = {f"flash_prefill_{label}": "flash_prefill_attention",
               f"paged_attn_{label}": "paged_decode_attention_pallas"}
    ids, per_rank, ttft, tok_s, eng = tp_engine_run(
        torch, st, mesh, model, prompts[:4],
        f"{cfg.name} ({cfg.num_layers} layers) {mesh_label(mesh)}", {},
        kernels)
    launches = st.setdefault("launches", {})
    for rec, fn in kernels.items():
        launches[rec] = per_rank[0][fn]
    st["tp_72b"] = (cfg.num_layers, mesh.tp, mesh.backend, ttft, tok_s)
    del eng, model
    gc.collect()
    torch.cuda.empty_cache()


def close_mesh(torch, np, st):
    """Close 12b/12d's mesh before 12c builds its own (one process group
    per process), timed: every rank answers, then leaves on its own."""
    t0 = time.monotonic()
    mesh = st.pop("mesh")
    mesh.close()
    check(not any(p.is_alive() for p in mesh._procs),
          "a worker outlived the mesh's close")
    print(f"phase 12: {mesh_label(mesh)} closed in "
          f"{time.monotonic() - t0:.2f} s")


# A7b's rest: sequence-sharded prefill over the mesh's seq axis.  12g, one
# card or more: a "1,2,1" mesh (gloo on one card) at Llama-3-8B width and
# SEQ_LAYERS layers against TP 1 on the same weights.  Its table of 192
# blocks keeps the bucket ladder at 2048 (no 4096 round), so the 2,300-token
# prompt is chunked: each round's 2048 positions split 1024 / 1024.
SEQ_LAYERS = 2
SEQ_ECFG = dict(max_blocks_per_seq=192)
# 12g's bars (stated in PERF.md before its first run): the logit-row cosine
# of the prefill rounds against TP 1 (12b's), and a share of equal greedy id
# sequences (the seq split changes only the rows' batch, not their order of
# sums, so most are expected equal).
SEQ_IDS_MIN_SHARE = 0.5
# 12h (four cards): Llama-3-8B at 32 layers on "1,2,2" over NCCL, a block
# table of 8,192 tokens and 520 blocks (the 4096 and 8192 buckets join the
# ladder), one prompt of LONG_PROMPT tokens admitted alone.
LONG_PROMPT = 8192
LONG_ECFG = dict(max_blocks_per_seq=520)


def seq_logits(torch, np, model, vocab):
    """``prefill_logits`` of 4 prompts in rounds of 2048 (lengths 4096,
    2300, 1025 and 700: last tokens in either seq slice of either round)."""
    from k8s_llm_monitor_tpu_torch.models import llama

    rng = np.random.default_rng(18)
    toks = torch.from_numpy(rng.integers(3, vocab, size=(4, 4096)).astype(
        np.int32))
    lens = torch.tensor([4096, 2300, 1025, 700], dtype=torch.int32)
    out = llama.prefill_logits(model, toks, lens, 2048)
    torch.cuda.synchronize()
    return out


def seq_slice_record(torch, np, st):
    """The B1 record of a seq rank's queries (``flash_prefill_seq2``): seq
    rank 1's slice of a 2048 round at Llama-3-8B heads, checked against
    the plain version (a fresh round's slice, a continuation's from inside
    a key tile, lanes of 0 rows and ragged ones), then timed as 12a times
    its shapes."""
    import torch.nn.functional as F

    from k8s_llm_monitor_tpu_torch.ops import paged_attention as pa

    name = "flash_prefill_seq2"
    rng = np.random.default_rng(18)
    gen = torch.Generator(device="cuda").manual_seed(18)
    errs = st.setdefault("max_abs_err", {})
    ulps = {}
    starts, lengths = [1024, 2024, 1024, 1024], [1024, 276, 0, 500]
    case = prefill_case(torch, rng, gen, 4, 1024, starts, lengths)
    got = pa.flash_prefill_attention(*case)
    want = pa.flash_prefill_attention_plain(*case)
    torch.cuda.synchronize()
    for b, n in enumerate(lengths):
        if n == 0:
            check(bool((got[b] == 0).all()), f"{name}: empty lane {b}")
            continue
        check_rows(torch, name, got[b, :n], want[b, :n], slice(None), errs,
                   ulps)
    del case, got, want
    S, starts, lengths = 1024, [1024], [1024]
    case = prefill_case(torch, rng, gen, 1, S, starts, lengths)
    ms = time_ms(torch, lambda: pa.flash_prefill_attention(*case), rounds=5)
    alone = time_ms(torch, flash_alone(torch, pa, case, {}), rounds=5)
    plain = time_ms(torch, lambda: pa.flash_prefill_attention_plain(*case),
                    reps=5)
    ctx_max = starts[0] + lengths[0]
    pos = torch.arange(S, device="cuda")[None, :, None] + case[4][:, None, None]
    keys = torch.arange(ctx_max, device="cuda")[None, None, :]
    qs, k, v, m = sdpa_args(torch, case[0] * D ** -0.5, case[1], case[2],
                            case[3], ctx_max, keys <= pos, {})
    lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qs, k, v, attn_mask=m, scale=1.0), reps=5)
    b_ms, by = bound(*prefill_work(starts, lengths, S))
    print(f"phase 12g: {name} (seq rank 1 of a 2048 round) H={H} KVH={KVH}: "
          f"slices ok, max abs err {errs[name]:.4g}, max err "
          f"{ulps[name]:.3g} ulps of the row; B=1 S={S} start {starts[0]}: "
          f"kernel {ms:.4f} ms (alone, on pre-scaled q: {alone:.4f} ms), "
          f"plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound {b_ms:.4f} ms "
          f"({by}) [{st['gpu']}]")
    kernel_record(st, name, "seq rank 1 of a 2048 round, B=1 S=1024", ms,
                  plain, lib, b_ms, by)
    del case, qs, k, v, m
    torch.cuda.empty_cache()


def phase12g(torch, np, st):
    """12g: sequence-sharded prefill on a "1,2,1" mesh (gloo on one card,
    host-staged) at Llama-3-8B width and SEQ_LAYERS layers against TP 1
    on the same weights: prefill logits (cosine), greedy ids of 8 prompts
    with one longer than the top bucket (a share equal), B1 launched on
    both ranks over their query slices; then B1's slice record."""
    import dataclasses
    import gc

    from k8s_llm_monitor_tpu_torch.models import llama
    from k8s_llm_monitor_tpu_torch.models.config import LLAMA3_8B
    from k8s_llm_monitor_tpu_torch.parallel.mesh import (
        MeshConfig, create_mesh)

    gpu = st["gpu"]
    cfg = dataclasses.replace(LLAMA3_8B, num_layers=SEQ_LAYERS)
    backend = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    t0 = time.monotonic()
    mesh = st["mesh"] = create_mesh(MeshConfig(seq=2), backend=backend)
    ref = llama.LlamaModel(cfg, seed=0)
    model = llama.LlamaModel(cfg, seed=0, mesh=mesh)
    mesh.sync()
    label = mesh_label(mesh)
    print(f"phase 12g: Llama-3-8B ({SEQ_LAYERS} layers, full width) on "
          f"{label} and at TP 1, from seed 0, in "
          f"{time.monotonic() - t0:.2f} s")
    want = seq_logits(torch, np, ref, cfg.vocab_size)
    got = seq_logits(torch, np, model, cfg.vocab_size)
    cos = cosines(torch, [got], [want])
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    print(f"phase 12g: prefill logits seq 2 vs TP 1, rounds of 2048 (lanes "
          f"of 4096, 2300, 1025, 700 tokens): smallest row cosine {cos:.6f} "
          f"(at least {TP_COS_MIN}), argmax agreement {agree:.3f} [{gpu}]")
    check(cos >= TP_COS_MIN, f"seq 2 logits cosine {cos:.6f}")
    lens = prompt_lengths(np.random.default_rng(2))[1::2]
    rng = np.random.default_rng(12)
    prompts = [[int(t) for t in rng.integers(3, cfg.vocab_size, size=n)]
               for n in lens]
    ref_ids, _, ref_ttft, _, eng = tp_engine_run(
        torch, st, None, ref, prompts, f"Llama-3-8B ({SEQ_LAYERS} layers) "
        "TP 1", SEQ_ECFG, {"flash_prefill": "flash_prefill_attention"})
    check(max(eng.prefill_bucket_rounds) == 2048,
          f"12g: buckets {eng.prefill_bucket_rounds}")
    del eng, ref
    gc.collect()
    ids, per_rank, ttft, _, eng = tp_engine_run(
        torch, st, mesh, model, prompts, f"Llama-3-8B ({SEQ_LAYERS} layers) "
        f"{label}", SEQ_ECFG,
        {"flash_prefill_seq2": "flash_prefill_attention"})
    check(eng.mesh_axes() == {"data": 1, "seq": 2, "model": 1}
          and eng.prefill_path == "flash",
          f"12g engine: {eng.mesh_axes()} {eng.prefill_path}")
    same = sum(a == b for a, b in zip(ids, ref_ids))
    print(f"phase 12g: greedy ids seq 2 vs TP 1: {same} of {len(prompts)} "
          f"sequences of 32 tokens equal (at least {SEQ_IDS_MIN_SHARE:.0%}; "
          f"prompts {lens}); B1 launches per rank {per_rank}; ttft p50 "
          f"{ttft * 1e3:.1f} ms, TP 1 {ref_ttft * 1e3:.1f} ms [{gpu}]")
    check(same >= SEQ_IDS_MIN_SHARE * len(prompts),
          f"12g: only {same} of {len(prompts)} id sequences equal TP 1's")
    st.setdefault("launches", {})["flash_prefill_seq2"] = (
        per_rank[0]["flash_prefill_attention"])
    del eng, model
    gc.collect()
    st.pop("mesh").close()
    torch.cuda.empty_cache()
    seq_slice_record(torch, np, st)


def phase12h(torch, np, st):
    """12h (four cards): Llama-3-8B at 32 layers on "1,2,2" over NCCL, a
    table of 8,192 tokens: one prompt of LONG_PROMPT tokens admitted alone
    (TTFT against "1,1,4" and "1,1,2" on the same cards), then phase 2's
    16-prompt mix held to TP 1 by 12b's bars (logit cosine, a share of
    equal id sequences), B1 launched on every rank."""
    import gc

    from k8s_llm_monitor_tpu_torch.models import llama
    from k8s_llm_monitor_tpu_torch.models.config import LLAMA3_8B
    from k8s_llm_monitor_tpu_torch.parallel.mesh import (
        create_mesh, parse_mesh_shape)
    from k8s_llm_monitor_tpu_torch.serving.engine import (
        EngineConfig, InferenceEngine, SamplingParams)

    gpu = st["gpu"]
    if torch.cuda.device_count() < 4:
        print("phase 12h: skipped (needs four cards, one per rank of "
              "\"1,2,2\")")
        return
    cfg = LLAMA3_8B
    rng = np.random.default_rng(19)
    long = [int(t) for t in rng.integers(3, cfg.vocab_size,
                                         size=LONG_PROMPT)]
    rng = np.random.default_rng(12)
    mix = [[int(t) for t in rng.integers(3, cfg.vocab_size, size=n)]
           for n in prompt_lengths(np.random.default_rng(2))]

    def long_ttft(model):
        eng = InferenceEngine(cfg, model, EngineConfig(**{**TP_ECFG,
                                                          **LONG_ECFG}))
        check(max(eng.ecfg.prefill_buckets) == LONG_PROMPT,
              f"12h: buckets {eng.ecfg.prefill_buckets}")
        out = []
        for _ in range(2):      # the second is warm
            res, = eng.generate([long], SamplingParams(max_tokens=8))
            check(res.finish_reason in ("eos", "length"),
                  f"12h: long prompt {res.finish_reason} {res.error}")
            out.append(res.ttft_s)
        del eng
        gc.collect()
        return out

    ref = llama.LlamaModel(cfg, seed=0)
    want = seq_logits(torch, np, ref, cfg.vocab_size)
    ref_ids = tp_engine_run(torch, st, None, ref, mix, "Llama-3-8B TP 1",
                            LONG_ECFG,
                            {"flash_prefill": "flash_prefill_attention"})[0]
    ttfts = {"1,1,1": long_ttft(ref)}
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    for shape in ("1,2,2", "1,1,4", "1,1,2"):
        t0 = time.monotonic()
        mesh = st["mesh"] = create_mesh(parse_mesh_shape(shape))
        model = llama.LlamaModel(cfg, seed=0, mesh=mesh)
        mesh.sync()
        print(f"phase 12h: Llama-3-8B (32 layers) on mesh {shape} over NCCL "
              f"({mesh.size} cards): up and sharded in "
              f"{time.monotonic() - t0:.2f} s")
        if shape == "1,2,2":
            got = seq_logits(torch, np, model, cfg.vocab_size)
            cos = cosines(torch, [got], [want])
            print(f"phase 12h: prefill logits {shape} vs TP 1: smallest row "
                  f"cosine {cos:.6f} (at least {TP_COS_MIN}) [{gpu}]")
            check(cos >= TP_COS_MIN, f"12h: cosine {cos:.6f}")
            ids, per_rank, ttft, tok_s, eng = tp_engine_run(
                torch, st, mesh, model, mix, f"Llama-3-8B mesh {shape}",
                LONG_ECFG, {"flash_prefill_seq": "flash_prefill_attention"})
            same = sum(a == b for a, b in zip(ids, ref_ids))
            print(f"phase 12h: greedy ids {shape} vs TP 1: {same} of "
                  f"{len(mix)} sequences of 32 tokens equal (at least "
                  f"{TP_IDS_MIN_SHARE:.0%}); B1 launches per rank "
                  f"{[c['flash_prefill_attention'] for c in per_rank]}; "
                  f"mix ttft p50 {ttft * 1e3:.1f} ms, decode {tok_s:.1f} "
                  f"tok/s [{gpu}]")
            check(same >= TP_IDS_MIN_SHARE * len(mix),
                  f"12h: only {same} of {len(mix)} id sequences equal")
            del eng
            gc.collect()
        ttfts[shape] = long_ttft(model)
        del model
        gc.collect()
        st.pop("mesh").close()
        torch.cuda.empty_cache()
    print(f"phase 12h: TTFT of one {LONG_PROMPT}-token prompt admitted alone "
          f"(one 8192 round; cold, warm ms): "
          + ", ".join(f"{k} {v[0] * 1e3:.1f} / {v[1] * 1e3:.1f}"
                      for k, v in ttfts.items()) + f" [{gpu}]")
    st["seq_long_ttft"] = ttfts


def phase12(torch, np, st):
    """A7: the per-rank kernel shapes (12a), Llama-3-8B at TP 2 (12b),
    Qwen2-72B (12d) and the mesh's close, the server on a mesh and
    rebuilds under it (12c, 12e, 12f).  ``--phases 0,12f`` (or 12e, ...)
    runs only those parts.  Every record of a TP shape that no path of
    this run launched reads 0."""
    import gc

    subs = st["subs"].get(12) or {"12a", "12b", "12c", "12d", "12e", "12f",
                                  "12g", "12h"}
    st.pop("model", None)
    gc.collect()
    torch.cuda.empty_cache()
    steps = [sub for name, sub in (("12a", tp_shard_checks),
                                   ("12b", phase12b), ("12d", phase12d))
             if name in subs]
    if subs & {"12b", "12d"}:
        steps.append(close_mesh)
    steps += [sub for name, sub in (("12g", phase12g), ("12h", phase12h))
              if name in subs]
    if subs & {"12c", "12e", "12f"}:
        steps.append(lambda torch, np, st: phase12c(torch, np, st, subs))
    try:
        for sub in steps:
            t0 = time.monotonic()
            sub(torch, np, st)
            torch.cuda.synchronize()
            name = "phase12c" if sub.__name__ == "<lambda>" else sub.__name__
            print(f"phase 12: {name} passed in "
                  f"{time.monotonic() - t0:.1f} s")
    finally:
        mesh = st.pop("mesh", None)
        if mesh is not None:
            mesh.close()
    launches = st.setdefault("launches", {})
    for label, _ in TP_HEADS:
        for kernel in ("flash_prefill", "paged_attn"):
            launches.setdefault(f"{kernel}_{label}", 0)


# ---------------------------------------------------------------- phase 13
# A7b: a checkpoint served on a tensor-parallel mesh.  Each rank loads its
# shard of an HF checkpoint from the same directory (int8 and W8A8 of the
# shard included); the host tier and KVX1 blobs move whole rows; the decode
# collective shares come from the mesh's measured all-reduce rate; the fit
# preflight's verdicts.

# The checkpoint's depth on one card: the whole run stays inside its
# 1,200 s (PERF.md, phase 13's prediction); full depth with a card per rank.
CKPT_LAYERS_ONE_CARD = 4
# Qwen2-72B's depth at TP 4: as many of its 80 layers as the disk holds
# (1.76 GB a layer in bf16), at most all of them, and no more than
# QWEN72_MAX_BYTES: a machine may cap what one run writes to its disk
# (90 GiB on the four-card H100 machine, deletes included), and 13a
# writes Llama-3-8B at full depth (16 GB) first.
QWEN72_MAX_LAYERS = 80
QWEN72_MAX_BYTES = 48 << 30
# 13's preflight grid (at 80 GiB a card).
PREFLIGHT_GRID = [(m, q, tp) for m in ("llama3-8b", "qwen2-72b", "llama3-70b")
                  for q in ("none", "int8") for tp in (1, 2, 4, 8)]


def hf_shapes(cfg):
    """{HF key: (shape, kind)} of ``cfg``'s checkpoint, kind one of
    "embed", "linear", "norm", "bias"."""
    H, D, I, V = (cfg.hidden_size, cfg.head_dim_, cfg.intermediate_size,
                  cfg.vocab_size)
    q, kv = cfg.num_heads * D, cfg.num_kv_heads * D
    out = {"model.embed_tokens.weight": ((V, H), "embed"),
           "model.norm.weight": ((H,), "norm"),
           "lm_head.weight": ((V, H), "linear")}
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}."
        out[pre + "input_layernorm.weight"] = ((H,), "norm")
        out[pre + "post_attention_layernorm.weight"] = ((H,), "norm")
        for name, shape in (("self_attn.q_proj", (q, H)),
                            ("self_attn.k_proj", (kv, H)),
                            ("self_attn.v_proj", (kv, H)),
                            ("self_attn.o_proj", (H, q)),
                            ("mlp.gate_proj", (I, H)), ("mlp.up_proj", (I, H)),
                            ("mlp.down_proj", (H, I))):
            out[f"{pre}{name}.weight"] = (shape, "linear")
            if cfg.qkv_bias and name.startswith("self_attn.") and \
                    not name.endswith("o_proj"):
                out[f"{pre}{name}.bias"] = ((shape[0],), "bias")
    return out


def write_hf_checkpoint(torch, path, cfg, seed):
    """``cfg`` at full width as bf16 safetensors drawn from a seeded
    generator on the card (normals of std ``in**-0.5``, embeddings 0.02,
    unit norms, biases 0.02), index-sharded in files of at most 1 GiB,
    with its config.json; returns the bytes written."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    weight_map, cur, size, total, files = {}, {}, 0, 0, []

    def flush():
        nonlocal cur, size, total
        fname = f"model-{len(files) + 1:05d}.safetensors"
        total += write_safetensors(torch, path / fname, cur)
        weight_map.update({k: fname for k in cur})
        files.append(fname)
        cur, size = {}, 0

    for key, (shape, kind) in hf_shapes(cfg).items():
        if kind == "norm":
            t = torch.ones(shape, dtype=torch.bfloat16, device="cuda")
        else:
            std = 0.02 if kind in ("embed", "bias") else shape[1] ** -0.5
            t = torch.randn(shape, generator=gen, device="cuda",
                            dtype=torch.bfloat16) * std
        n = t.numel() * 2
        if cur and size + n > 2 ** 30:
            flush()
        cur[key] = t
        size += n
    flush()
    (path / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {"total_size": total}, "weight_map": weight_map}))
    (path / "config.json").write_text(json.dumps({
        "model_type": "qwen2" if cfg.qkv_bias else "llama",
        "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads,
        "head_dim": cfg.head_dim_, "rope_theta": cfg.rope_theta,
        "rope_scaling": cfg.rope_scaling, "rms_norm_eps": cfg.rms_norm_eps,
        "max_position_embeddings": cfg.max_seq_len,
        "use_sliding_window": False, "tie_word_embeddings": False,
        "torch_dtype": "bfloat16"}))
    return total


def rank_tensors(model, mesh):
    """Each rank's parameters and buffers (rank 0's on the card, the
    workers' on the host), rank 0 first."""
    mine = dict(model.named_parameters()) | dict(model.named_buffers())
    return [mine] + (mesh.worker_states() if mesh.tp > 1 else [])


def check_shards(torch, full_model, model, mesh, what):
    """Every rank's tensors equal TP 1's sliced by the partition specs,
    bit for bit (int8 codes and scales included)."""
    from k8s_llm_monitor_tpu_torch.parallel.sharding import (
        param_partition_specs, shard_tensor)

    full = dict(full_model.named_parameters()) | dict(
        full_model.named_buffers())
    specs = param_partition_specs(full_model)
    n = 0
    for rank, state in enumerate(rank_tensors(model, mesh)):
        check(state.keys() == full.keys(), f"{what}: rank {rank} holds "
                                           "other tensors than TP 1")
        for name, t in state.items():
            want = shard_tensor(full[name], specs[name], rank, mesh.tp)
            check(t.dtype == want.dtype and torch.equal(
                t.to(want.device), want),
                f"{what}: rank {rank}'s {name} is not TP 1's slice")
            n += 1
    return n


def timed_load(torch, path, **kw):
    """``load_hf_checkpoint(path, **kw)`` synchronized: (model, seconds);
    on a mesh rank 0 waits for every worker's load (``sync``)."""
    from k8s_llm_monitor_tpu_torch.utils.checkpoint import load_hf_checkpoint

    torch.cuda.synchronize()
    t0 = time.monotonic()
    _, model = load_hf_checkpoint(path, **kw)
    if kw.get("mesh") is not None:
        kw["mesh"].sync()
    torch.cuda.synchronize()
    return model, time.monotonic() - t0


def ckpt_tier_and_blobs(torch, np, st, mesh, model, one):
    """13c: the host tier and KVX1 under the mesh on ``model`` (TP N)
    with ``one`` (TP 1) as the blobs' other end: a spill and a restore
    whose restored hit gives the device hit's ids; a blob exported on TP N
    installs on TP 1 and on a fresh TP-N engine, each exporting the same
    bytes; the ids of the installed prefix."""
    from k8s_llm_monitor_tpu_torch.serving.engine import (
        DEFAULT_TENANT, EngineConfig, InferenceEngine, SamplingParams)

    gpu, label = st["gpu"], mesh_label(mesh)
    cfg = model.cfg
    rng = np.random.default_rng(13)
    prompts = [[int(t) for t in rng.integers(3, cfg.vocab_size, size=n)]
               for n in (1040, 1300, 1560)]
    sp = SamplingParams(max_tokens=8)
    ecfg = dict(max_slots=8, num_blocks=512, block_size=BS,
                max_blocks_per_seq=128, decode_steps_per_iter=8)
    eng = InferenceEngine(cfg, model, EngineConfig(
        **ecfg, host_spill_bytes=16 << 30))
    fetch = Timed(torch, eng, "_fetch_rows",
                  lambda a, out: sum(x.nbytes for leaf in out.layers
                                     for x in leaf))
    write = Timed(torch, eng, "_write_rows",
                  lambda a, out: sum(x.nbytes for leaf in a[1]
                                     for x in leaf))
    fresh = [r.token_ids for r in eng.generate(prompts, sp)]
    hit = [r.token_ids for r in eng.generate(prompts, sp)]
    check(eng.prefix_cache.hits >= len(prompts),
          f"13c: {eng.prefix_cache.hits} device hits")
    blob = eng.export_prefix(prompts[0], tenant=DEFAULT_TENANT)
    while eng._evict_prefix_lru():
        pass
    spilled = eng.kv_tier_stats()
    back = [r.token_ids for r in eng.generate(prompts, sp)]
    stats = eng.kv_tier_stats()
    check(stats["spills"] > 0 and stats["restores"] >= len(prompts),
          f"13c: spills {stats['spills']} restores {stats['restores']}")
    check(back == hit, f"13c: restored ids equal the device hit's in "
                       f"{sum(a == b for a, b in zip(back, hit))} of "
                       f"{len(hit)}")
    check(eng.dispatch_failures == 0, "13c: dispatch failures")
    print(f"phase 13c: host tier under {label}: {len(prompts)} prompts of "
          f"1040-1560 tokens, fresh, device hit, all spilled ("
          f"{spilled['host_bytes']} B of whole rows in "
          f"{spilled['host_entries']} entries), restored: restores "
          f"{stats['restores']}, restored ids equal the device hit's in "
          f"{len(hit)} of {len(hit)} (the fresh prefill's in "
          f"{sum(a == b for a, b in zip(back, fresh))}); fetch "
          f"{fetch.bytes / max(fetch.secs, 1e-9) / 1e9:.2f} GB/s "
          f"({fetch.bytes} B, {fetch.calls} spills, {fetch.secs:.3f} s), "
          f"write {write.bytes / max(write.secs, 1e-9) / 1e9:.2f} GB/s "
          f"({write.bytes} B, {write.calls} restores, {write.secs:.3f} s, "
          f"synchronized) [{gpu}]")
    st.setdefault("ckpt", {})["tier"] = (
        fetch.bytes / max(fetch.secs, 1e-9) / 1e9,
        write.bytes / max(write.secs, 1e-9) / 1e9, label)
    check(blob is not None, "13c: nothing to export")
    del eng
    ids = {}
    for name, m in (("TP 1", one), (f"TP {mesh.tp}", model)):
        recv = InferenceEngine(m.cfg, m, EngineConfig(**ecfg))
        check(recv.install_prefix(
            blob, expected_tenant=DEFAULT_TENANT) == "installed",
              f"13c: the blob did not install on {name}")
        check(recv.export_prefix(prompts[0],
                                   tenant=DEFAULT_TENANT) == blob,
              f"13c: {name}'s export of the installed blob differs")
        ids[name] = recv.generate([prompts[0]], sp)[0].token_ids
        del recv
    check(ids[f"TP {mesh.tp}"] == hit[0],
          "13c: the blob installed on a fresh TP-N engine gave other ids")
    same = sum(a == b for a, b in zip(ids["TP 1"], hit[0]))
    print(f"phase 13c: KVX1 blob of {len(blob)} B exported on {label}: "
          f"installed on TP 1 and on a fresh TP {mesh.tp} engine, each "
          f"exporting it back byte for byte; the fresh TP {mesh.tp} "
          f"engine's ids equal the exporter's hit, TP 1's agree in {same} "
          f"of {len(hit[0])} tokens (bf16 sums of another split) [{gpu}]")


def ckpt_preflight(torch, st):
    """13e: the fit preflight's verdicts for the 70B class and 8B on
    80 GiB cards, bf16 and int8, TP 1-8."""
    import contextlib
    import io

    from k8s_llm_monitor_tpu_torch.cmd.preflight import check as preflight

    t0 = time.monotonic()
    rows = []
    for model, quant, tp in PREFLIGHT_GRID:
        with contextlib.redirect_stdout(io.StringIO()) as out:
            rc, fails, warns = preflight([
                "--model", model, "--quantize", quant, "--mesh",
                f"1,1,{tp}", "--per-chip-hbm-gib", "80"])
        fit = next(line for line in out.getvalue().splitlines()
                   if "per-chip: weights" in line)
        rows.append(f"{model} {quant} TP {tp}: {'FAIL' if rc else 'PASS'} "
                    f"({fit.split(': ', 1)[1].split(' - ')[0]}; "
                    f"{len(fails)} FAIL, {len(warns)} WARN)")
    check(len(rows) == len(PREFLIGHT_GRID), "13e: preflight rows")
    for row in rows:
        print(f"phase 13e: preflight {row}")
    print(f"phase 13e: {len(rows)} preflights in "
          f"{time.monotonic() - t0:.2f} s (shapes only, on the meta device)")


def check_device_quant(torch, np, full, q) -> str:
    """``q`` (quantized on the card) against ``utils/quantize.py:
    quantize_array`` on the host, bit for bit: layer 0's q, k, o (a row-
    parallel weight) and down, and the first 8,192 rows of the embedding
    and the head (per-row scales: a row's codes do not depend on the
    others)."""
    from k8s_llm_monitor_tpu_torch.utils.quantize import quantize_array

    pairs = [(f"layers.0.{n}", getattr(full.layers[0], n).weight,
              getattr(q.layers[0], n)) for n in ("q", "k", "o", "down")]
    pairs.append(("embed[:8192]", full.embed.weight[:8192], q.embed))
    if q.lm_head is not None:
        pairs.append(("lm_head[:8192]", full.lm_head.weight[:8192],
                      q.lm_head))
    for name, w, dst in pairs:
        n = w.shape[0]
        codes, scale = quantize_array(w.float().cpu().numpy(), axis=1)
        check(np.array_equal(dst.weight_q[:n].cpu().numpy(), codes)
              and np.array_equal(dst.scale[:n].cpu().numpy(), scale),
              f"13a: {name}: the card's int8 differs from quantize_array")
    return ", ".join(name for name, _, _ in pairs)


def phase13(torch, np, st):
    """A7b: a checkpoint on a tensor-parallel mesh.  13a writes Llama-3-8B
    at full width (depth CKPT_LAYERS_ONE_CARD on one card, 32 with a card
    per rank) as bf16 safetensors and loads it at TP 1 and TP 2: every
    rank's shard equals TP 1's slice bit for bit in bf16, int8 and W8A8.
    13b: logits and greedy ids at TP 2 against TP 1 (12b's bars), B1 and
    B3 launched on every rank, TTFT and tok/s, the decode collective
    share from the measured all-reduce rate.  13c: the host tier and KVX1
    under the mesh.  13d (four cards): Qwen2-72B from a checkpoint loaded
    as int8 at TP 4 at as many layers as the disk holds, and the TP-4
    mesh's close.  13e: the preflight's verdicts."""
    import dataclasses as dc
    import gc
    import shutil
    import tempfile
    from pathlib import Path

    from k8s_llm_monitor_tpu_torch.models import llama
    from k8s_llm_monitor_tpu_torch.models.config import LLAMA3_8B, QWEN2_72B
    from k8s_llm_monitor_tpu_torch.parallel.mesh import (
        MeshConfig, create_mesh)
    from k8s_llm_monitor_tpu_torch.utils.quantize import quantize_params

    subs = st["subs"].get(13) or {"13a", "13b", "13c", "13d", "13e"}
    gpu = st["gpu"]
    st.pop("model", None)
    gc.collect()
    torch.cuda.empty_cache()
    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= 2 else "gloo"
    root = Path(os.environ.get("CHIP_SMOKE_CKPT_DIR")
                or tempfile.gettempdir())
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_13_", dir=root))
    mesh = None
    try:
        if subs & {"13a", "13b", "13c"}:
            layers = LLAMA3_8B.num_layers if cards >= 2 else \
                CKPT_LAYERS_ONE_CARD
            cfg = dc.replace(LLAMA3_8B, num_layers=layers)
            path = tmp / "llama3-8b"
            path.mkdir()
            t0 = time.monotonic()
            total = write_hf_checkpoint(torch, path, cfg, seed=13)
            print(f"phase 13a: wrote Llama-3-8B at full width, {layers} of "
                  f"32 layers, as bf16 safetensors: {total} B on disk in "
                  f"{time.monotonic() - t0:.1f} s (free disk after: "
                  f"{shutil.disk_usage(tmp).free} B)")
            one, secs = timed_load(torch, path)
            print(f"phase 13a: TP 1 load (bf16): {secs:.2f} s, "
                  f"{total / secs / 1e9:.2f} GB/s [{gpu}]")
            t0 = time.monotonic()
            mesh = create_mesh(MeshConfig(model=2), backend=backend)
            print(f"phase 13a: {mesh_label(mesh)}: mesh up in "
                  f"{time.monotonic() - t0:.2f} s")
            two, secs = timed_load(torch, path, mesh=mesh)
            print(f"phase 13a: TP 2 load (bf16, each rank its shard): "
                  f"{secs:.2f} s, {total / 2 / secs / 1e9:.2f} GB/s a rank "
                  f"[{gpu}]")
            st["ckpt"] = {"layers": layers, "bytes": total,
                          "load_tp2_gbs": total / 2 / secs / 1e9}
            if "13a" in subs:
                t0 = time.monotonic()
                n = check_shards(torch, one, two, mesh, "bf16")
                print(f"phase 13a: bf16 shards checked in "
                      f"{time.monotonic() - t0:.1f} s", flush=True)
                t0 = time.monotonic()
                q2 = quantize_params(two)
                mesh.sync()
                print(f"phase 13a: quantize_params of the TP-2 shards in "
                      f"{time.monotonic() - t0:.1f} s", flush=True)
                t0 = time.monotonic()
                q1 = quantize_params(one)
                print(f"phase 13a: quantize_params at TP 1 in "
                      f"{time.monotonic() - t0:.1f} s", flush=True)
                t0 = time.monotonic()
                k = check_device_quant(torch, np, one, q1)
                print(f"phase 13a: the card's int8 codes and scales equal "
                      f"the host's quantize_array bit for bit ({k}) in "
                      f"{time.monotonic() - t0:.1f} s", flush=True)
                n += check_shards(torch, q1, q2, mesh,
                                  "quantize_params of the bf16 shards")
                del q2
                gc.collect()
                for mode in ("int8", "w8a8"):
                    qm, qsecs = timed_load(torch, path, mesh=mesh,
                                           quantize=True,
                                           act_quant=mode == "w8a8")
                    check(qm.cfg.act_quant == (mode == "w8a8"),
                          f"{mode}: act_quant {qm.cfg.act_quant}")
                    n += check_shards(torch, q1, qm, mesh, f"{mode} load")
                    print(f"phase 13a: TP 2 load ({mode}: each rank "
                          f"quantizes its shard, row scales by a MAX "
                          f"all-reduce): {qsecs:.2f} s, "
                          f"{total / 2 / qsecs / 1e9:.2f} GB/s read a rank "
                          f"[{gpu}]", flush=True)
                    del qm
                    gc.collect()
                del q1
                gc.collect()
                torch.cuda.empty_cache()
                # The quantized builds retired the bf16 shards: load again.
                two, _ = timed_load(torch, path, mesh=mesh)
                print(f"phase 13a: every rank's shard equals TP 1's slice "
                      f"bit for bit: bf16, quantize_params, int8 and W8A8 "
                      f"loads ({n} tensors)")
            if "13b" in subs:
                want = tp_logits(torch, np, one, cfg.vocab_size)
                got = tp_logits(torch, np, two, cfg.vocab_size)
                cos = cosines(torch, [got.reshape(-1, got.shape[-1])],
                              [want.reshape(-1, want.shape[-1])])
                print(f"phase 13b: forward_full logits TP 2 vs TP 1 from "
                      f"the checkpoint: smallest row cosine {cos:.6f} (at "
                      f"least {TP_COS_MIN}) [{gpu}]")
                check(cos >= TP_COS_MIN, f"13b: TP 2 cosine {cos:.6f}")
                del want, got
                rng = np.random.default_rng(12)
                prompts = [[int(t) for t in rng.integers(
                    3, cfg.vocab_size, size=n)]
                    for n in rng.integers(64, 513, size=16)]
                ref_ids, _, ref_ttft, ref_tok, eng = tp_engine_run(
                    torch, st, None, one, prompts,
                    f"checkpoint Llama-3-8B ({layers} layers) TP 1",
                    {"decode_path": "pallas"},
                    {"flash_prefill": "flash_prefill_attention",
                     "paged_attn": "paged_decode_attention_pallas"})
                del eng
                kernels = {"flash_prefill_h16kv4": "flash_prefill_attention",
                           "paged_attn_h16kv4":
                               "paged_decode_attention_pallas"}
                ids, per_rank, ttft, tok_s, eng = tp_engine_run(
                    torch, st, mesh, two, prompts,
                    f"checkpoint Llama-3-8B ({layers} layers) "
                    f"{mesh_label(mesh)}", {}, kernels)
                check((eng.prefill_path, eng.decode_path)
                      == ("flash", "pallas"),
                      f"13b: paths {eng.prefill_path}/{eng.decode_path}")
                same = sum(a == b for a, b in zip(ids, ref_ids))
                check(same >= TP_IDS_MIN_SHARE * len(prompts),
                      f"13b: only {same} of {len(prompts)} id sequences "
                      "equal TP 1's")
                phases = eng.profile_decode_phases(reps=2)
                share = phases["decode_collective_share"]
                check(share == share and 0.0 <= share <= 1.0,
                      f"13b: decode_collective_share {share}")
                print(f"phase 13b: greedy ids TP 2 vs TP 1: {same} of "
                      f"{len(prompts)} sequences equal (at least "
                      f"{TP_IDS_MIN_SHARE:.0%}); ttft p50 "
                      f"{ttft * 1e3:.1f} ms vs {ref_ttft * 1e3:.1f} ms, "
                      f"decode {tok_s:.1f} vs {ref_tok:.1f} tok/s; B1 and "
                      f"B3 launched per rank {per_rank}; all-reduce bus "
                      f"rate at the decode payload "
                      f"({eng._collective_payload()} B) "
                      f"{eng.collective_bus_gbs:.3f} GB/s, wire "
                      f"{eng._ring_wire_ms():.4f} ms a step, short-context "
                      f"step {phases['decode_step_ms_short_ctx']:.3f} ms: "
                      f"decode_collective_share {share:.4f}, hidden "
                      f"{eng.decode_collective_hidden_share:.4f} [{gpu}]")
                st["ckpt"].update(ttft=(ttft, ref_ttft), tok_s=(tok_s,
                                                                ref_tok),
                                  share=share, same=same)
                del eng
                gc.collect()
            if "13c" in subs:
                ckpt_tier_and_blobs(torch, np, st, mesh, two, one)
            del one, two
            gc.collect()
            torch.cuda.empty_cache()
            t0 = time.monotonic()
            mesh.close()
            print(f"phase 13: {mesh_label(mesh)} closed in "
                  f"{time.monotonic() - t0:.2f} s")
            mesh = None
            shutil.rmtree(path)
        if "13d" in subs and cards >= 4:
            per_layer = sum(int(np.prod(shape)) * 2 for key, (shape, _) in
                            hf_shapes(dc.replace(QWEN2_72B, num_layers=1))
                            .items() if ".layers." in key)
            fixed = 2 * QWEN2_72B.vocab_size * QWEN2_72B.hidden_size * 2
            room = min(shutil.disk_usage(tmp).free - (8 << 30),
                       QWEN72_MAX_BYTES) - fixed
            layers = max(1, min(QWEN72_MAX_LAYERS, room // per_layer))
            cfg = dc.replace(QWEN2_72B, num_layers=int(layers))
            path = tmp / "qwen2-72b"
            path.mkdir()
            t0 = time.monotonic()
            total = write_hf_checkpoint(torch, path, cfg, seed=72)
            print(f"phase 13d: wrote Qwen2-72B at full width, {layers} of "
                  f"80 layers (what the disk and the write cap hold), as "
                  f"bf16 safetensors: "
                  f"{total} B in {time.monotonic() - t0:.1f} s")
            t0 = time.monotonic()
            mesh = create_mesh(MeshConfig(model=4))
            print(f"phase 13d: {mesh_label(mesh)}: mesh up in "
                  f"{time.monotonic() - t0:.2f} s")
            model, secs = timed_load(torch, path, mesh=mesh,
                                     quantize=True)
            print(f"phase 13d: TP 4 int8 load of Qwen2-72B ({layers} "
                  f"layers): {secs:.2f} s, {total / 4 / secs / 1e9:.2f} "
                  f"GB/s read a rank [{gpu}]")
            logits = tp_logits(torch, np, model, cfg.vocab_size)
            check(bool(torch.isfinite(logits).all()),
                  "13d: non-finite logits")
            del logits
            rng = np.random.default_rng(13)
            prompts = [[int(t) for t in rng.integers(3, cfg.vocab_size,
                                                     size=n)]
                       for n in (40, 200, 513, 1000)]
            kernels = {"flash_prefill_h16kv2": "flash_prefill_attention",
                       "paged_attn_h16kv2": "paged_decode_attention_pallas"}
            _, per_rank, ttft, tok_s, eng = tp_engine_run(
                torch, st, mesh, model, prompts,
                f"checkpoint Qwen2-72B int8 ({layers} layers) "
                f"{mesh_label(mesh)}", {}, kernels)
            st.setdefault("ckpt", {})["qwen72"] = (layers, ttft, tok_s)
            del eng, model
            gc.collect()
            torch.cuda.empty_cache()
            t0 = time.monotonic()
            mesh.close()
            closed = time.monotonic() - t0
            check(not any(p.is_alive() for p in mesh._procs),
                  "13d: a worker outlived the close")
            print(f"phase 13d: {mesh_label(mesh)} closed in {closed:.2f} s "
                  f"(C1: under 5 s) [{gpu}]")
            mesh = None
        if "13e" in subs:
            ckpt_preflight(torch, st)
    finally:
        if mesh is not None:
            mesh.close()
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------- phase 14
# The port's gates on the card (devtools/traceguard.py): each decode
# program captured once and then replayed, never recaptured; no host sync
# in a replay; the captured buffers stay the engine's live tensors.

# Llama-3-8B's depth for the gates: every kernel of a path launches at any
# depth, and the mesh path runs host-staged over gloo on one card.
GATE_LAYERS = 2
# The kernel of each TPU kernel's counterpart, by the wrapper that launches
# it (B3 through the decode and the verify wrapper).
GATE_KERNELS = {"B1": ("flash_prefill_attention",),
                "B2": ("paged_decode_attention_fused",),
                "B3": ("paged_decode_attention_pallas",
                       "paged_verify_attention_pallas"),
                "B4": ("paged_decode_attention_fused_quant",)}


def gate_line(rep) -> str:
    launched = {k: v for k, v in rep.launches.items() if v}
    return (f"decode {rep.decode_path}, prefill {rep.prefill_path}, pool "
            f"{rep.kv_quant or 'bf16'}: warm {rep.warm_programs} programs / "
            f"{rep.warm_captures} captures, repeat {rep.repeat_programs} / "
            f"{rep.repeat_captures}, {rep.replays_checked} replays under "
            f"sync debug 'error', live buffers "
            f"{'held' if all(rep.live.values()) else rep.live} (reset, "
            f"preemption, restore, grammar swap), launches {launched}")


def phase14(torch, np, st):
    """The port's gates on the card: Llama-3-8B at full width and
    GATE_LAYERS layers (bf16, random weights from a seed, decode_graphs on)
    through each of traceguard's one-card paths -- a warm pass, a
    same-bucket repeat that builds no program and captures no graph, every
    replay of the repeat and of the live-buffer events under
    torch.cuda.set_sync_debug_mode("error"), and the captured buffers
    still the engine's live tensors after a pipeline reset, a preemption,
    a host-tier restore and a grammar swap -- with B1-B4 launched; the
    static capture-hazard pass; then the mesh path on a TP-2 mesh (NCCL
    with two cards, gloo on one) with each rank's launches, and each
    worker's programs bound to its engine's live tensors."""
    import gc

    from k8s_llm_monitor_tpu_torch.devtools import traceguard
    from k8s_llm_monitor_tpu_torch.models import llama
    from k8s_llm_monitor_tpu_torch.models.config import LLAMA3_8B
    from k8s_llm_monitor_tpu_torch.parallel.mesh import (
        MeshConfig, create_mesh)

    gpu = st["gpu"]
    st.pop("model", None)
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(LLAMA3_8B, num_layers=GATE_LAYERS)
    t0 = time.monotonic()
    model = llama.LlamaModel(cfg, device="cuda", seed=14)
    print(f"phase 14: Llama-3-8B at full width, {GATE_LAYERS} of 32 layers, "
          f"bf16 from seed 14, in {time.monotonic() - t0:.2f} s")
    totals: dict[str, int] = {}
    for path in traceguard.DEFAULT_PATHS:
        t0 = time.monotonic()
        rep = traceguard.check_path(path, device="cuda", model=model,
                                    block_size=BS)
        print(f"phase 14: {path}: {gate_line(rep)} in "
              f"{time.monotonic() - t0:.2f} s [{gpu}]")
        check(rep.ok, f"14 {path}: {rep.as_dict()}")
        check(rep.warm_captures > 0 and rep.replays_checked > 0,
              f"14 {path}: no graph captured or replayed")
        for name, n in rep.launches.items():
            totals[name] = totals.get(name, 0) + n
        gc.collect()
    for label, names in GATE_KERNELS.items():
        n = sum(totals.get(name, 0) for name in names)
        check(n > 0, f"14: {label} ({'/'.join(names)}) never launched")
    print(f"phase 14: launches over the one-card paths: "
          + ", ".join(f"{label} {sum(totals.get(n, 0) for n in names)}"
                      for label, names in GATE_KERNELS.items()))
    hazards = traceguard.capture_hazards()
    check(not hazards, f"14: capture hazards {hazards}")
    print("phase 14: capture-hazard over the graph roots: clean")
    del model
    gc.collect()
    torch.cuda.empty_cache()

    backend = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    t0 = time.monotonic()
    mesh = create_mesh(MeshConfig(model=2), backend=backend)
    try:
        mmodel = llama.LlamaModel(cfg, device="cuda", seed=14, mesh=mesh)
        print(f"phase 14: mesh: {mesh_label(mesh)} and the model on it in "
              f"{time.monotonic() - t0:.2f} s")
        reset_rank_launches(mesh)
        t0 = time.monotonic()
        rep = traceguard.check_path("mesh", device="cuda", model=mmodel,
                                    block_size=BS)
        ranks = rank_launches(mesh, ["flash_prefill_attention",
                                     "paged_decode_attention_pallas"])
        print(f"phase 14: mesh ({mesh_label(mesh)}): {gate_line(rep)}, "
              f"per rank {ranks} in {time.monotonic() - t0:.2f} s [{gpu}]")
        check(rep.ok, f"14 mesh: {rep.as_dict()}")
        check(all(r["flash_prefill_attention"] > 0
                  and r["paged_decode_attention_pallas"] > 0 for r in ranks),
              f"14 mesh: B1 / B3 not launched on every rank: {ranks}")
        # Each worker's programs: bound, and on its engine's live tensors.
        workers = mesh.request("programs")
        print(f"phase 14: mesh workers' decode programs {workers}")
        check(all(w is not None and w["programs"] > 0
                  and w["bound"] == w["programs"] and not w["stale"]
                  for w in workers),
              f"14 mesh: a worker's programs are unbound or stale: {workers}")
        if mesh.backend == "nccl":     # a gloo mesh runs its programs eagerly
            check(rep.warm_captures > 0 and rep.replays_checked > 0
                  and all(w["captures"] > 0 for w in workers),
                  f"14 mesh: no graph captured or replayed over NCCL: "
                  f"{workers}")
        del rep, mmodel
        gc.collect()
    finally:
        mesh.close()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 15
# A8: the fleet router over the port's engines.  Two replicas of the
# monitor's default config (llama-1b at its 16 layers, W8A8, spec_k 4),
# built by build_server side by side on one card: 15d serves them over
# HTTP, 15a-15c drive their supervisors as LocalReplicas; a third engine
# of the same config is the one-engine reference.  llama-1b's head_dim 64
# keeps its prefill on the dense path (as in JAX), so 15b also hands off
# between two engines at Llama-3-8B width, where B1 runs.

FLEET_QUERIES = 24           # 15a: diagnosis verdicts through the router
FLEET_CONTEXTS = 4           # ... sharing this many cluster contexts
FLEET_CONTEXT_BYTES = 240    # ... each longer than affinity_prefix_tokens
FLEET_HANDOFFS = 16          # 15b: free-text requests handed P -> D
FLEET_HANDOFF_TOKENS = 32
FLEET_LONG_TOKENS = 160      # 15c: the long greedy answer
FLEET_KILL_STEP = 8          # ... killed after this many of its steps
FLEET_B1_LAYERS = 2          # 15b at Llama-3-8B width


def fleet_contexts(rng, n):
    """``n`` cluster-context preambles of FLEET_CONTEXT_BYTES bytes."""
    return [evidence_question(rng, FLEET_CONTEXT_BYTES).rsplit(
        "## Question", 1)[0].replace("## Evidence", f"## Cluster {i}")
        for i in range(n)]


def fleet_registry(reps):
    from k8s_llm_monitor_tpu_torch.fleet import ReplicaRegistry

    reg = ReplicaRegistry()
    for r in reps:
        reg.add(r)
    reg.refresh()
    return reg


def replica_launches(rep):
    """The kernel launches of the replica's own step thread (its engine's)
    since the last reset, by wrapper name."""
    from k8s_llm_monitor_tpu_torch.ops import paged_attention as pa

    return rep._call(lambda e: pa.thread_launches())


def reset_replica_launches(reps):
    from k8s_llm_monitor_tpu_torch.ops import paged_attention as pa

    for rep in reps:
        rep._call(lambda e: pa.reset_thread_launches())
    pa.reset_launch_counts()


def short_launches(counts):
    names = {"flash_prefill_attention": "B1",
             "paged_decode_attention_fused": "B2",
             "paged_decode_attention_fused_quant": "B4",
             "paged_verify_attention_pallas": "B3 verify",
             "paged_decode_attention_pallas": "B3 decode"}
    return {names[k]: v for k, v in counts.items() if v}


def routed_burst(router, prompts, sp):
    """Submit every prompt through ``router`` at once; returns the results,
    the streams (equal to the results' ids), the seconds from each submit
    to its first streamed token, and the burst's wall seconds."""
    import threading

    out, errors = {}, []
    t0 = time.monotonic()
    handles = [(time.monotonic(), router.submit(p, sp)) for p in prompts]

    def consume(i, t_sub, h):
        try:
            toks, first = [], None
            for tok in h.stream(timeout=600):
                if first is None:
                    first = time.monotonic() - t_sub
                toks.append(tok)
            out[i] = (h.result(timeout=600), toks, first)
        except Exception as exc:            # reported below
            errors.append(f"request {i}: {type(exc).__name__}: {exc}")

    threads = [threading.Thread(target=consume, args=(i, t, h))
               for i, (t, h) in enumerate(handles)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.monotonic() - t0
    check(not errors and len(out) == len(prompts),
          f"routed burst: {errors or 'a request hung'}")
    res = [out[i][0] for i in range(len(prompts))]
    for i, (r, toks, _) in sorted(out.items()):
        check(r.finish_reason in ("stop", "eos", "length")
              and toks == r.token_ids,
              f"routed request {i}: {r.finish_reason} {r.error} (stream "
              f"{len(toks)} tokens, result {len(r.token_ids)})")
    return res, [out[i][2] for i in range(len(prompts))], wall


def direct_burst(rep, prompts, sp, tenant="public"):
    """The same prompts submitted to one replica at once: its ids
    (``tenant`` names the prefix-cache namespace they are looked up in)."""
    handles = [rep.generate(p, sp, tenant=tenant) for p in prompts]
    res = [h.result(timeout=900) for h in handles]
    for i, r in enumerate(res):
        check(r.finish_reason in ("stop", "eos", "length"),
              f"reference request {i}: {r.finish_reason} {r.error}")
    return [r.token_ids for r in res]


def id_mismatches(got, want):
    """(index, first differing position) of each sequence that differs."""
    out = []
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            out.append((i, next((j for j, (x, y) in enumerate(zip(a, b))
                                 if x != y), min(len(a), len(b)))))
    return out


def handoff_bar(got, want, cont):
    """The handoff's ids against one engine's: the first token (P's
    prefill) against the unified run's, the second (D's prefix hit on the
    prompt and that token) against the engine's own run of the prompt and
    that token as a prefix hit.  The rest is decoded, where the default
    config's acceptance gate picks spec or plain calls by each engine's
    timing and their bf16 logits flip a random model's near-ties (phase
    3's rule): counted, not held.  Returns (first tokens equal, second
    tokens equal, the continuations that differ, whole sequences equal
    to the unified run's)."""
    first = sum(g[:1] == w[:1] for g, w in zip(got, want))
    second = sum(g[1:2] == c[:1] for g, c in zip(got, cont))
    bad = id_mismatches([g[1:] for g in got], cont)
    whole = sum(g == w for g, w in zip(got, want))
    return first, second, bad, whole


def record_installs(rep):
    """Wrap ``rep.install_prefix`` to keep every install's outcome."""
    outcomes = []
    real = rep.install_prefix

    def install(blob, tenant=None):
        outcome = real(blob, tenant=tenant)
        outcomes.append(outcome)
        return outcome

    rep.install_prefix = install
    return outcomes


def fleet15a(torch, np, st, reps, ref):
    """15a: 24 diagnosis verdicts over 4 shared cluster contexts through a
    FleetRouter (affinity) over the two replicas: every verdict parses, no
    error, greedy ids equal the reference engine's on the same prompts,
    the affinity hits and the TTFT through the router, and each replica
    that served launched B2 on its own step thread (B3 only in spec
    calls, which the acceptance gate keeps off for these lanes)."""
    from k8s_llm_monitor_tpu_torch.diagnosis.grammar import parse_verdict
    from k8s_llm_monitor_tpu_torch.fleet import FleetRouter
    from k8s_llm_monitor_tpu_torch.serving.engine import SamplingParams
    from k8s_llm_monitor_tpu_torch.utils.tokenizer import ByteTokenizer

    gpu, fcfg = st["gpu"], st["fleet_cfg"].fleet
    tok = ByteTokenizer()
    rng = np.random.default_rng(15)
    contexts = fleet_contexts(rng, FLEET_CONTEXTS)
    prompts = [tok.encode(contexts[i % FLEET_CONTEXTS]
                          + evidence_question(rng, 96)[-60:])
               for i in range(FLEET_QUERIES)]
    check(min(len(p) for p in prompts) > fcfg.affinity_prefix_tokens,
          "a 15a prompt is shorter than the affinity head")
    sp = SamplingParams(max_tokens=1, temperature=0.0, constrained=True)
    reg = fleet_registry(reps)
    router = FleetRouter(reg, policy=fcfg.policy,
                         affinity_prefix_tokens=fcfg.affinity_prefix_tokens,
                         max_failovers=fcfg.max_failovers)
    reset_replica_launches(reps)
    res, ttft, wall = routed_burst(router, prompts, sp)
    per_rep = {r.replica_id: replica_launches(r) for r in reps}
    snap = reg.snapshot()
    unparsed = []
    for i, r in enumerate(res):
        try:
            check_verdict(parse_verdict(tok.decode(r.token_ids)),
                          "15a verdict")
        except Exception as exc:
            unparsed.append((i, r.finish_reason, len(r.token_ids),
                             tok.decode(r.token_ids)[:48], str(exc)[:80]))
    check(not unparsed, f"15a: verdicts that do not parse (request, "
                        f"finish, tokens, text, why): {unparsed}; "
                        f"preemptions per replica "
                        f"{[r.service.engine.preemptions for r in reps]}")
    c = router.counters()
    check(c["completed"] == FLEET_QUERIES and c["failed"] == 0
          and c["sheds"] == 0 and c["failovers"] == 0,
          f"15a router counters {c}")
    served = [rid for rid, s in snap.items() if s["dispatches"] > 0]
    for rid in served:
        n = per_rep[rid]
        check(n["paged_decode_attention_fused"] > 0,
              f"15a: {rid} served {snap[rid]['dispatches']} requests but "
              f"launched {n} on its step thread")
    # The same burst again, the graphs captured and the contexts cached:
    # the warm TTFT through the router.
    res2, ttft2, wall2 = routed_burst(router, prompts, sp)
    for r in res2:
        check_verdict(parse_verdict(tok.decode(r.token_ids)),
                      "15a verdict (warm)")
    want = direct_burst(ref, prompts, sp)
    got = [r.token_ids for r in res]
    bad = id_mismatches(got, want)
    st["fleet_unified_ids"] = got
    print(f"phase 15a: {FLEET_QUERIES} verdicts over {FLEET_CONTEXTS} "
          f"cluster contexts ({min(map(len, prompts))}-"
          f"{max(map(len, prompts))} tokens) through FleetRouter "
          f"({fcfg.policy}, affinity head {fcfg.affinity_prefix_tokens}) "
          f"over {len(reps)} replicas in {wall:.2f} s: all parse, "
          f"{c['affinity_hits']} affinity hits, {c['affinity_spills']} "
          f"spills; dispatches {{{', '.join(f'{k}: {v['dispatches']}' for k, v in snap.items())}}}; "
          f"TTFT through the router p50 / p99 cold "
          f"{np.percentile(ttft, 50) * 1e3:.1f} / "
          f"{np.percentile(ttft, 99) * 1e3:.1f} ms (the engines' own "
          f"{np.percentile([r.ttft_s for r in res], 50) * 1e3:.1f} / "
          f"{np.percentile([r.ttft_s for r in res], 99) * 1e3:.1f}; "
          f"graph captures "
          f"{sum(r.service.engine.graph_capture_s for r in reps):.2f} s), "
          f"warm {np.percentile(ttft2, 50) * 1e3:.1f} / "
          f"{np.percentile(ttft2, 99) * 1e3:.1f} ms (burst {wall2:.2f} s); "
          f"verdicts "
          f"{min(map(len, got))}-{max(map(len, got))} tokens; launches per "
          f"replica (its step thread) "
          f"{ {k: short_launches(v) for k, v in per_rep.items()} }; greedy "
          f"ids equal the reference engine's: "
          f"{FLEET_QUERIES - len(bad)} of {FLEET_QUERIES} [{gpu}]")
    check(not bad, f"15a: ids differ from one engine's at (request, "
                   f"position) {bad}")


def fleet_handoff(router, p, d, prompts, sp, what):
    """Prompts through a prefill/decode router: every handoff lands on D
    with an ``installed`` prefix, D's prefix hits grow by one a request,
    and the prompt's pages D holds are P's bit for bit (each replica's
    KVX1 export of the prompt, byte-equal).  Returns the ids and P's and
    D's step-thread launches."""
    outcomes = record_installs(d)
    hits0 = d.service.engine.prefix_cache.hits
    reset_replica_launches([p, d])
    res, _, wall = routed_burst(router, prompts, sp)
    lp, ld = replica_launches(p), replica_launches(d)
    hand = router.counters()["handoffs"]
    hits = d.service.engine.prefix_cache.hits - hits0
    check(hand == {"decode": len(prompts)}
          and outcomes == ["installed"] * len(prompts),
          f"{what}: handoffs {hand}, install outcomes {outcomes}")
    check(hits == len(prompts), f"{what}: D's prefix hits grew by {hits}")
    same = [p.fetch_prefix(q) == d.fetch_prefix(q) for q in prompts]
    check(all(same), f"{what}: D's pages of prompts "
                     f"{[i for i, x in enumerate(same) if not x]} are not P's")
    return [r.token_ids for r in res], lp, ld, wall


def fleet15b(torch, np, st, backends, ref):
    """15b: the default config's replicas as prefill (P) and decode (D):
    every handoff installed, D's hits one a request, D decoding (B2, B3),
    ids equal to the reference engine's unified ids; then the same at
    Llama-3-8B width (FLEET_B1_LAYERS layers, bf16), where the prefill on
    P and D's hit round run B1."""
    import gc

    from k8s_llm_monitor_tpu_torch.fleet import FleetRouter, LocalReplica
    from k8s_llm_monitor_tpu_torch.models import llama
    from k8s_llm_monitor_tpu_torch.models.config import LLAMA3_8B
    from k8s_llm_monitor_tpu_torch.serving.engine import (
        EngineConfig, InferenceEngine, SamplingParams)
    from k8s_llm_monitor_tpu_torch.serving.service import EngineService
    from k8s_llm_monitor_tpu_torch.utils.tokenizer import ByteTokenizer

    gpu, fcfg = st["gpu"], st["fleet_cfg"].fleet
    tok = ByteTokenizer()
    rng = np.random.default_rng(151)
    # A token below block alignment (BOS and 254 bytes): every full block
    # of the prompt and its first token is shareable (shareable_blocks
    # keeps the last token out).
    prompts = [tok.encode(evidence_question(rng, 254))
               for _ in range(FLEET_HANDOFFS)]
    check(all(len(p) == 255 for p in prompts), "15b: prompt lengths")
    sp = SamplingParams(max_tokens=FLEET_HANDOFF_TOKENS, temperature=0.0)
    p = LocalReplica("prefill-0", supervisor=backends[0].supervisor,
                     role="prefill")
    d = LocalReplica("decode-0", supervisor=backends[1].supervisor,
                     role="decode")
    router = FleetRouter(fleet_registry([p, d]), policy=fcfg.policy,
                         affinity_prefix_tokens=fcfg.affinity_prefix_tokens)
    spec0 = d.service.engine.spec_verify_steps
    got, lp, ld, wall = fleet_handoff(router, p, d, prompts, sp,
                                      "15b llama-1b")
    check(ld["paged_decode_attention_fused"] > 0,
          f"15b llama-1b: D launched {ld}")
    spec = d.service.engine.spec_verify_steps - spec0
    check(spec == 0 or ld["paged_verify_attention_pallas"] > 0,
          f"15b llama-1b: D ran {spec} spec verify steps with {ld}")
    want = direct_burst(ref, prompts, sp)
    cont = direct_burst(ref, [q + g[:1] for q, g in zip(prompts, got)],
                        dataclasses.replace(sp, max_tokens=sp.max_tokens - 1))
    first, second, bad, whole = handoff_bar(got, want, cont)
    print(f"phase 15b: llama-1b (default config) P -> D: {FLEET_HANDOFFS} "
          f"requests of {len(prompts[0])} tokens + {FLEET_HANDOFF_TOKENS} "
          f"in {wall:.2f} s, every handoff installed on D (KVX1), D's "
          f"prefix hits +{FLEET_HANDOFFS}; launches P {short_launches(lp)}, "
          f"D {short_launches(ld)} (prefill at head_dim 64 is dense, as in "
          f"JAX); D's prompt pages equal P's bit for bit; the reference "
          f"engine's ids: first tokens {first} of {FLEET_HANDOFFS}, second "
          f"tokens (its prefix hit on the prompt and the first, as on D) "
          f"{second} of {FLEET_HANDOFFS}, whole continuations "
          f"{FLEET_HANDOFFS - len(bad)} of {FLEET_HANDOFFS} ((request, "
          f"position) differing {bad}), whole unified sequences {whole} "
          f"of {FLEET_HANDOFFS} (unified decodes the second token where D "
          f"prefills it) [{gpu}]")
    check(first == FLEET_HANDOFFS and second == FLEET_HANDOFFS,
          f"15b llama-1b: first tokens {first}, second tokens {second} of "
          f"{FLEET_HANDOFFS} equal the reference engine's")

    # Llama-3-8B width, where the flash prefill kernel (B1) runs.
    cfg = dataclasses.replace(LLAMA3_8B, num_layers=FLEET_B1_LAYERS)
    model = llama.LlamaModel(cfg, seed=15)
    ecfg = dict(max_slots=8, num_blocks=512, max_blocks_per_seq=64)
    engines = [InferenceEngine(cfg, model, EngineConfig(**ecfg))
               for _ in range(3)]
    check(all(e.prefill_path == "flash" for e in engines),
          f"15b 8B: prefill paths {[e.prefill_path for e in engines]}")
    rng8 = np.random.default_rng(152)
    prompts8 = [[int(t) for t in rng8.integers(3, cfg.vocab_size, size=n)]
                for n in (255, 319, 383, 447)]
    sp8 = SamplingParams(max_tokens=16)
    want8 = [r.token_ids for r in engines[2].generate(prompts8, sp8)]
    firsts8 = [w[:1] for w in want8]
    cont8 = [r.token_ids for r in engines[2].generate(
        [q + f for q, f in zip(prompts8, firsts8)],
        dataclasses.replace(sp8, max_tokens=15))]
    p8 = LocalReplica("prefill-8b", service=EngineService(engines[0]),
                      role="prefill")
    d8 = LocalReplica("decode-8b", service=EngineService(engines[1]),
                      role="decode")
    try:
        router8 = FleetRouter(fleet_registry([p8, d8]), policy=fcfg.policy,
                              affinity_prefix_tokens=fcfg
                              .affinity_prefix_tokens)
        got8, lp8, ld8, wall8 = fleet_handoff(router8, p8, d8, prompts8, sp8,
                                              "15b Llama-3-8B")
        check(lp8["flash_prefill_attention"] > 0
              and ld8["flash_prefill_attention"] > 0
              and ld8["paged_decode_attention_fused"] > 0,
              f"15b 8B: launches P {lp8}, D {ld8}")
        first8, second8, bad8, whole8 = handoff_bar(got8, want8, cont8)
        n8 = len(prompts8)
        print(f"phase 15b: Llama-3-8B width ({FLEET_B1_LAYERS} layers, bf16) "
              f"P -> D: {n8} requests in {wall8:.2f} s, every handoff "
              f"installed; launches P {short_launches(lp8)}, D "
              f"{short_launches(ld8)} (B1 on P's prefill and D's hit "
              f"round); D's prompt pages equal P's; one engine's ids: "
              f"first tokens {first8} of {n8}, second {second8} of {n8}, "
              f"whole continuations {n8 - len(bad8)} of {n8} (differing "
              f"{bad8}), whole unified sequences {whole8} of {n8} [{gpu}]")
        check(first8 == n8 and second8 == n8,
              f"15b 8B: first tokens {first8}, second tokens {second8} of "
              f"{n8} equal one engine's")
    finally:
        p8.close()
        d8.close()
        del p8, d8, engines, model
        gc.collect()
        torch.cuda.empty_cache()


def gate_after_steps(rep, n_steps):
    """Hold the replica's step loop after ``n_steps`` engine steps until
    its service is stopped (a kill between two steps, mid-stream)."""
    import threading

    svc = rep.service
    eng = svc.engine
    real = eng.step
    reached = threading.Event()
    count = [0]

    def step():
        real()
        count[0] += 1
        if count[0] == n_steps:
            reached.set()
            svc._stop.wait(120)

    eng.step = step
    return reached


def fleet15c(torch, np, st, reps, ref):
    """15c: a long greedy answer through the router; the replica serving
    it is killed mid-stream (LocalReplica.kill between two of its steps):
    the stream completes on the other replica, no token lost or repeated
    (the stream is the delivered tokens, then exactly the survivor's),
    the survivor asked for the prompt and the delivered tokens and the
    rest of the budget only, one failover; the ids against the reference
    engine's undisturbed run are printed."""
    from k8s_llm_monitor_tpu_torch.fleet import FleetRouter
    from k8s_llm_monitor_tpu_torch.serving.engine import SamplingParams
    from k8s_llm_monitor_tpu_torch.utils.tokenizer import ByteTokenizer

    gpu, fcfg = st["gpu"], st["fleet_cfg"].fleet
    tok = ByteTokenizer()
    prompt = tok.encode(fleet_contexts(np.random.default_rng(153), 1)[0]
                        + "## Question\nwhat should I fix first?\n")
    sp = SamplingParams(max_tokens=FLEET_LONG_TOKENS, temperature=0.0)
    want = direct_burst(ref, [prompt], sp)[0]
    reg = fleet_registry(reps)
    router = FleetRouter(reg, policy=fcfg.policy,
                         affinity_prefix_tokens=fcfg.affinity_prefix_tokens,
                         max_failovers=fcfg.max_failovers)
    digest = router._token_digest(prompt)
    home_id = router.policy.preferred(reg.candidates(), digest)
    home = next(r for r in reps if r.replica_id == home_id)
    other = next(r for r in reps if r is not home)
    calls = []
    real_generate = other.generate

    def record(prompt_ids, sampling=None, **kw):
        handle = real_generate(prompt_ids, sampling, **kw)
        calls.append((list(prompt_ids), sampling.max_tokens, handle))
        return handle

    other.generate = record
    reached = gate_after_steps(home, FLEET_KILL_STEP)
    t0 = time.monotonic()
    h = router.submit(prompt, sp)
    check(reached.wait(300), "15c: the home replica never reached the gate")
    home.kill("15c: killed mid-stream")
    toks = list(h.stream(timeout=600))
    res = h.result(timeout=600)
    wall = time.monotonic() - t0
    c = router.counters()
    check(res.finish_reason in ("length", "stop", "eos")
          and toks == res.token_ids,
          f"15c: {res.finish_reason} {res.error}, stream {len(toks)} "
          f"tokens, result {len(res.token_ids)}")
    check(c["failovers"] == 1 and c["failed"] == 0 and len(calls) == 1,
          f"15c: counters {c}, survivor calls {len(calls)}")
    replay, budget, inner = calls[0]
    delivered = len(replay) - len(prompt)
    check(0 < delivered < len(toks) and replay[:len(prompt)] == prompt
          and budget == FLEET_LONG_TOKENS - delivered,
          f"15c: the survivor was asked for {len(replay)} prompt tokens "
          f"and {budget} more after {delivered} delivered tokens")
    # No token lost or repeated: the stream is what the killed replica
    # delivered, then exactly what the survivor generated.
    check(toks == replay[len(prompt):] + inner.result(timeout=60).token_ids,
          "15c: the stream is not the delivered tokens and the survivor's")
    # The replay's reference: the reference engine on the prompt and the
    # delivered tokens as a fresh prefill (another tenant's namespace, so
    # no cached block is hit), as the survivor ran it.
    cont = direct_burst(ref, [prompt + toks[:delivered]], dataclasses.replace(
        sp, max_tokens=FLEET_LONG_TOKENS - delivered), tenant="replay")[0]
    bad = id_mismatches([toks[:delivered], toks[delivered:]],
                        [want[:delivered], cont])
    print(f"phase 15c: {home_id} killed after {delivered} of "
          f"{len(toks)} tokens ({FLEET_KILL_STEP} steps): the stream "
          f"finished on {other.replica_id} (asked for the prompt + "
          f"{delivered} tokens and {budget} more) in {wall:.2f} s, "
          f"fleet_failovers_total {c['failovers']}, the stream the "
          f"delivered tokens and then the survivor's; against the "
          f"reference engine, (part, position) differing from the "
          f"undisturbed run's delivered tokens and from its run of the "
          f"prompt and them: {bad}; the whole stream equals the "
          f"undisturbed run's: {toks == want} [{gpu}]")


def fleet15d(torch, np, st, servers):
    """15d: the router role over HTTP: build_router_server in front of the
    two replica servers: /api/v1/query answers, /api/v1/stats has the
    fleet block, /metrics lints clean with the fleet_* families, and
    /readyz turns 503 once both replicas' listeners stop."""
    from k8s_llm_monitor_tpu_torch.fleet.frontend import build_router_server
    from k8s_llm_monitor_tpu_torch.monitor.config import load_config
    from k8s_llm_monitor_tpu_torch.monitor.exporter import lint_exposition

    gpu = st["gpu"]
    cfg = load_config(None)
    cfg.server.host, cfg.server.port = "127.0.0.1", 0
    for s in servers:
        s.start()
    cfg.fleet.replicas = [f"http://127.0.0.1:{s.port}" for s in servers]
    cfg.fleet.probe_interval_s = 0.25
    router = build_router_server(cfg)
    router.start()
    port = router.port
    try:
        import threading

        out, errors = {}, []

        def ask(i):
            try:
                out[i] = http_call(port, "POST", "/api/v1/query", {
                    "question": QUERIES[i % len(QUERIES)] + f" (fleet {i})"})
            except Exception as exc:
                errors.append(f"query {i}: {type(exc).__name__}: {exc}")

        threads = [threading.Thread(target=ask, args=(i,)) for i in range(8)]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.monotonic() - t0
        # Random weights: the answers decode to byte soup or to nothing.
        check(not errors and len(out) == 8 and all(
            s == 200 and b.get("status") == "success"
            and "answer" in b["result"] for s, b, _ in out.values()),
            f"15d queries: {errors or [(s, str(b)[:200]) for s, b, _ in out.values()]}")
        status, stats, _ = http_call(port, "GET", "/api/v1/stats")
        fleet = stats.get("fleet") or {}
        check(status == 200 and set(fleet.get("replicas", ())) == {
            "replica-0", "replica-1"} and fleet["counters"]["dispatches"] >= 8
            and "hedge_delay_s" in fleet, f"15d /api/v1/stats: {stats}")
        status, text, _ = http_call(port, "GET", "/metrics")
        text = text.decode()
        lint = lint_exposition(text)
        fams = [f for f in ("fleet_replica_ready", "fleet_replica_inflight",
                            "fleet_affinity_hits_total",
                            "fleet_failovers_total", "fleet_handoffs_total",
                            "fleet_hedge_delay_seconds", "fleet_sheds_total")
                if f"k8s_llm_monitor_{f}" not in text]
        check(status == 200 and not lint and not fams,
              f"15d /metrics: {status}, lint {lint}, missing {fams}")
        check(http_call(port, "GET", "/readyz")[0] == 200,
              "15d: the router is not ready")
        walls = sorted(w for _, _, w in out.values())
        for s in servers:
            s.stop()
        deadline = time.monotonic() + 30
        while (http_call(port, "GET", "/readyz")[0] != 503
               and time.monotonic() < deadline):
            time.sleep(0.05)
        status, health, _ = http_call(port, "GET", "/health")
        check(http_call(port, "GET", "/readyz")[0] == 503
              and health["reason"] == "no ready fleet replicas",
              f"15d: /readyz with both replicas down: {health}")
        print(f"phase 15d: build_router_server over 2 replica servers "
              f"(build_server, ephemeral ports): 8 queries in {wall:.2f} s, "
              f"wall p50 {walls[len(walls) // 2] * 1e3:.1f} ms, all "
              f"200/success; /api/v1/stats fleet block "
              f"{sorted(fleet)}; /metrics lint-clean with the fleet "
              f"families; /readyz 503 ({health['reason']}) once both "
              f"replicas stopped [{gpu}]")
    finally:
        router.analysis.close()
        router.stop()
        if router.signals is not None:
            router.signals.stop()


def phase15(torch, np, st):
    """A8: the fleet router over the port's engines on one card (15a
    routing, 15b disaggregation, 15d the router role over HTTP, then 15c
    failover, which kills a replica).  ``--phases 0,15b`` (or 15a, ...)
    runs only those parts."""
    import gc

    from k8s_llm_monitor_tpu_torch.fleet import LocalReplica
    from k8s_llm_monitor_tpu_torch.monitor.analysis import LocalEngineBackend
    from k8s_llm_monitor_tpu_torch.monitor.cluster import (
        FakeCluster, seed_demo_cluster)
    from k8s_llm_monitor_tpu_torch.monitor.config import load_config
    from k8s_llm_monitor_tpu_torch.monitor.server import build_server

    subs = st["subs"].get(15) or {"15a", "15b", "15c", "15d"}
    st.pop("model", None)
    gc.collect()
    torch.cuda.empty_cache()
    cfg = load_config(None)
    cfg.server.host, cfg.server.port = "127.0.0.1", 0
    cfg.llm.provider = "tpu"
    cfg.llm.max_tokens = 64
    # Replicas behind a router run without a tenant governor of their own
    # (the router's is the fleet's one).
    cfg.tenancy.enabled = False
    st["fleet_cfg"] = cfg
    servers, backends = [], []
    t0 = time.monotonic()
    try:
        for _ in range(2):
            srv = build_server(copy.deepcopy(cfg),
                               backend=seed_demo_cluster(FakeCluster()))
            servers.append(srv)
            backends.append(srv.analysis.backend)
        ref = LocalEngineBackend.from_config(cfg.llm.tpu,
                                             lifecycle=cfg.lifecycle)
        backends.append(ref)
        boot_s = time.monotonic() - t0
        for b in backends:
            eng = b.engine
            check((eng.ecfg.spec_k, eng.decode_path, eng.prefill_path)
                  == (4, "fused", "dense") and eng.model.cfg.act_quant,
                  f"not the default config: spec_k {eng.ecfg.spec_k}, "
                  f"paths {eng.prefill_path}/{eng.decode_path}")
        print(f"phase 15: 3 engines of the default config ({cfg.llm.tpu.model}"
              f", W8A8, spec_k {cfg.llm.tpu.spec_k}) built in {boot_s:.2f} s "
              f"(2 by build_server, the reference by from_config)")
        reps = [LocalReplica(f"replica-{i}", supervisor=b.supervisor)
                for i, b in enumerate(backends[:2])]
        ref_rep = LocalReplica("reference", supervisor=ref.supervisor)
        steps = [("15a", lambda: fleet15a(torch, np, st, reps, ref_rep)),
                 ("15b", lambda: fleet15b(torch, np, st, backends, ref_rep)),
                 ("15d", lambda: fleet15d(torch, np, st, servers)),
                 ("15c", lambda: fleet15c(torch, np, st, reps, ref_rep))]
        for name, step in steps:
            if name not in subs:
                continue
            t1 = time.monotonic()
            step()
            torch.cuda.synchronize()
            print(f"phase 15: {name} passed in {time.monotonic() - t1:.1f} s")
        for b in backends:
            eng = b.engine
            check(eng.dispatch_failures == 0 and eng.watchdog_trips == 0,
                  f"phase 15: {eng.dispatch_failures} dispatch failures, "
                  f"{eng.watchdog_trips} watchdog trips")
    finally:
        for b in backends:
            b.supervisor.shutdown(grace_s=0.0)
        for s in servers:
            if s.signals is not None:
                s.signals.stop()
            s.stop()
        del servers, backends
        st.pop("fleet_cfg", None)
        gc.collect()
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases",
                    default="0,1,2,3,4,5,6,7,8,9,10,11,12,13,14,15",
                    help="comma-separated phases to run (default: all); "
                         "a sub-phase by name (12f, 13c) runs only that "
                         "part of its phase")
    ap.add_argument("--only", choices=("flash_prefill", "fused_decode",
                                       "paged_attn"),
                    help="limit phases 1 and 4 to this kernel")
    args = ap.parse_args(argv)
    phases, subs, whole = set(), {}, set()
    for p in args.phases.split(","):
        n = int(p.rstrip("abcdefgh"))
        phases.add(n)
        if p == str(n):
            whole.add(n)
        else:
            subs.setdefault(n, set()).add(p)
    subs = {n: v for n, v in subs.items() if n not in whole}

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

    st: dict = {"only": args.only, "subs": subs}
    # Phases 8, 7, 10 and 11 before 6: they reuse phase 2's model, which
    # phase 6 frees; phase 9 on a card that holds no earlier model, then
    # phase 12's meshes.
    runners = [(0, phase0), (1, phase1), (2, phase2), (3, phase3), (8, phase8),
               (4, phase4), (5, phase5), (7, phase7), (10, phase10),
               (11, phase11), (6, phase6), (9, phase9), (12, phase12),
               (13, phase13), (14, phase14), (15, phase15)]
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
