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

Phase 0  card name and power limit, torch/CUDA versions, builds the CUDA
         kernels from k8s_llm_monitor_tpu_torch/csrc (one nvcc per source,
         started together) and prints the build seconds.
Phase 1  each kernel against its plain PyTorch version on the card, at the
         Llama-3-8B head geometry (H=32, KVH=8, D=128, block 16) with bf16
         activations: flash prefill over bf16, int8 and fp8 pools (ragged
         S 128 and 1024, a chunk at start > 0, an empty lane, a lane one
         token below block alignment, the S=2048 chunk shape, a
         continuation chunk starting inside a key tile, qpk 8 (64/8 heads)
         and qpk 1 (32/32) at ragged lengths, and blocks of 12 tokens),
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
         qlens and empty lanes exactly zero.
Phase 2  the engine at full Llama-3-8B width (32 layers, random bf16 weights
         from a seeded generator on the card): a bf16 pool (8 GiB), an int8
         and an fp8 pool, and decode_path="pallas".  15 prompts of
         20..1500 tokens plus one of 2300 (chunked prefill), greedy, 32 new
         tokens.  For each engine the launch counts are set to 0 just
         before its run and read just after: every request must finish,
         every kernel of its path must have launched, and a second
         identical run must give identical ids.  Prints TTFT p50, decode
         tokens/s, weight and pool bytes.  A third run of the bf16, the
         int8 and the pallas engine traces its decode steps (after the last
         prefill) with torch.profiler: device time per kernel (the
         attention kernels by name, each must show time: the split and
         merge kernels of the fused and of the split paged attention), the
         number of device kernels, and the device's idle share of the
         window.
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
         flops; launches per engine step.  Flash prefill is recorded at two
         shapes (the ``shape`` key): an admission round and a 2048 chunk;
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
         chunks of 128, 256 and 512 keys.

Phase 5  the request's way in: phase 2's Llama-3-8B model in an engine
         with a bf16 pool, ByteTokenizer and the verdict grammar's token
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
         constrained_decode_overhead_ms, and the wall time per sampled
         decode step with sample_topk_cap 64 against 0 (in turns), beside
         the two samplers alone on [32, 128256] logits (CUDA events).
Phase 6  the monitor's front door: the earlier phases' model is freed, then
         the port's build_server boots in process on port 0 over the demo
         FakeCluster with llm.provider "tpu" at llama3-8b (bf16 weights and
         pool, kv_blocks 4096, max_batch 32, spec_k 0, max_tokens 64, a
         journal in a temporary directory, telemetry and remediation off):
         cmd/server's chain down to EngineSupervisor -> EngineService ->
         InferenceEngine.step.  One cold one-step request must not trip the
         heartbeat watchdog; /health and /readyz must be ready.  A burst
         over HTTP from 24 threads (16 POST /api/v1/query, 4 POST
         /api/v1/analyze root_cause, 1 streamed query, 3 GET /api/v1/stats)
         with the launch counts set to 0 just before it and read after it:
         every response 200 and "success", every verdict of the grammar's
         schema, flash prefill and fused decode launched.  Then Warning
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
                 bs=BS):
    """q, pages, table, starts, lengths of one flash prefill call;
    ``heads`` = (query heads, kv heads), ``bs`` tokens per block."""
    nh, nkv = heads
    ctx = max(s + n for s, n in zip(starts, lengths))
    nbl = (ctx + bs - 1) // bs + 1
    num_blocks = B * nbl + 1
    dev = "cuda"
    q = torch.randn(B, S, nh, D, generator=gen, device=dev).to(torch.bfloat16)
    kp = torch.randn(num_blocks, bs, nkv * D, generator=gen, device=dev).to(torch.bfloat16)
    vp = torch.randn(num_blocks, bs, nkv * D, generator=gen, device=dev).to(torch.bfloat16)
    table = _tables(torch, rng, B, nbl, num_blocks).to(dev)
    st = torch.tensor(starts, dtype=torch.int32, device=dev)
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, kp, vp, table, st, ln


def decode_case(torch, rng, gen, positions, nbl, heads=(H, KVH), bs=BS):
    """q, k_new, v_new, cos, sin, pages, table, positions of one fused
    decode call; ``nbl`` table blocks per lane."""
    B = len(positions)
    num_blocks = B * nbl + 1
    nh, nkv = heads
    dev = "cuda"
    from k8s_llm_monitor_tpu_torch.ops.rope import rope_angles

    q = torch.randn(B, 1, nh, D, generator=gen, device=dev).to(torch.bfloat16)
    kn = torch.randn(B, 1, nkv, D, generator=gen, device=dev).to(torch.bfloat16)
    vn = torch.randn(B, 1, nkv, D, generator=gen, device=dev).to(torch.bfloat16)
    kp = torch.randn(num_blocks, bs, nkv * D, generator=gen, device=dev).to(torch.bfloat16)
    vp = torch.randn(num_blocks, bs, nkv * D, generator=gen, device=dev).to(torch.bfloat16)
    table = _tables(torch, rng, B, nbl, num_blocks).to(dev)
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
    cos, sin = rope_angles(pos[:, None], D, 500_000.0)
    return q, kn, vn, cos, sin, kp, vp, table, pos


QUANTS = ("int8", "fp8")


def _page_bytes(kv_quant):
    """Bytes one cached position of one kv head costs in the K or V plane:
    D page elements, plus a float32 scale on a quantized pool."""
    return D + 4 if kv_quant else 2 * D


def quantize_pages(torch, pages, kv_quant):
    """(codes, scales) of a bf16 pool, by the port's own quantize_kv."""
    from k8s_llm_monitor_tpu_torch.models.llama import kv_quant_spec, quantize_kv

    qdtype, qmax = kv_quant_spec(kv_quant)
    return quantize_kv(pages, pages.shape[-1] // D, qdtype, qmax)


def quant_prefill_case(torch, rng, gen, B, S, starts, lengths, kv_quant,
                       heads=(H, KVH), bs=BS):
    """prefill_case over a quantized pool: (args, scale kwargs)."""
    q, kp, vp, table, st, ln = prefill_case(torch, rng, gen, B, S, starts,
                                            lengths, heads, bs)
    kq, ks = quantize_pages(torch, kp, kv_quant)
    vq, vs = quantize_pages(torch, vp, kv_quant)
    return (q, kq, vq, table, st, ln), dict(k_scale=ks, v_scale=vs)


def quant_decode_case(torch, rng, gen, positions, nbl, kv_quant,
                      heads=(H, KVH), bs=BS):
    """decode_case over a quantized pool, in the fused quant wrapper's
    argument order."""
    q, kn, vn, cos, sin, kp, vp, table, pos = decode_case(
        torch, rng, gen, positions, nbl, heads, bs)
    kq, ks = quantize_pages(torch, kp, kv_quant)
    vq, vs = quantize_pages(torch, vp, kv_quant)
    return q, kn, vn, cos, sin, kq, vq, ks, vs, table, pos


def prefill_work(starts, lengths, S, kv_quant=""):
    """(bytes, flops) the flash prefill must move and do for these inputs:
    each input read once, each output written once, causal pairs only.
    Rows past ``lengths`` are padding no caller reads, so q and out count
    only the valid rows."""
    B = len(starts)
    qo = 2 * sum(lengths) * H * D * 2                   # q in, out
    kv = sum((s + n) * KVH * _page_bytes(kv_quant) * 2
             for s, n in zip(starts, lengths))
    table = 4 * B * (2 + max((s + n + BS - 1) // BS for s, n in zip(starts, lengths)))
    pairs = sum(n * s + n * (n + 1) // 2 for s, n in zip(starts, lengths))
    return qo + kv + table, 4 * D * H * pairs


def decode_work(positions, kv_quant=""):
    """(bytes, flops) of one fused decode step: the cached rows (and
    scales) read, q, k_new, v_new, angles and positions read, out and the
    appended rows (and scales) written."""
    B = len(positions)
    row = KVH * _page_bytes(kv_quant)
    cached = sum(p * row * 2 for p in positions)
    io = B * (2 * H * D * 2 + 2 * KVH * D * 2 + 2 * row + 2 * D * 4 + 4)
    table = 4 * sum((p + BS) // BS for p in positions)
    flops = sum(4 * H * D * (p + 1) for p in positions if p > 0)
    return cached + io + table, flops


def paged_attn_work(starts, qlens):
    """(bytes, flops) of the split paged attention: the keys the live
    tokens see (bf16 K and V), q and out of the live tokens, table,
    starts and qlens."""
    keys = [s + n for s, n in zip(starts, qlens)]
    kv = sum(keys) * KVH * D * 2 * 2
    qo = 2 * sum(qlens) * H * D * 2
    table = 4 * sum((k + BS - 1) // BS for k in keys) + 8 * len(starts)
    flops = sum(4 * H * D * (s + i + 1)
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
    suffix = {torch.bfloat16: "bf16", torch.int8: "int8",
              torch.float8_e4m3fn: "fp8"}[kp.dtype]
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
    B, _, nh, _ = q.shape
    nkv = kp.shape[-1] // D
    cs = cos.float().reshape(B, D).contiguous()
    sn = sin.float().reshape(B, D).contiguous()
    nsplit, chunk = pa.decode_splits(table.shape[1], kp.shape[1],
                                     kp.element_size())
    ws = torch.empty(pa.decode_workspace_floats(B, nkv, nh // nkv, nsplit, D),
                     dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    suffix = {torch.bfloat16: "bf16", torch.int8: "int8",
              torch.float8_e4m3fn: "fp8"}[kp.dtype]
    fn = pa._kernel(f"fused_decode_{suffix}")
    args = (q.data_ptr(), kn.data_ptr(), vn.data_ptr(), cs.data_ptr(),
            sn.data_ptr(), kp.data_ptr(), vp.data_ptr(),
            *(t.data_ptr() for t in scales), table.data_ptr(), pos.data_ptr(),
            out.data_ptr(), ws.data_ptr(), B, nh, nkv, kp.shape[1],
            table.shape[1], nsplit, chunk, D ** -0.5)

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
    B, QS, nh, _ = q.shape
    nkv = kp.shape[-1] // D
    out = torch.empty_like(q)
    nsplit, chunk = pa.decode_splits(table.shape[1], kp.shape[1], 2)
    ws = torch.empty(pa.decode_workspace_floats(B, nkv, QS * (nh // nkv),
                                                nsplit, D),
                     dtype=torch.float32, device=q.device)
    if lengths is not None:
        sym, lanes, dims = "paged_attn_decode_bf16", (lengths,), (B,)
    else:
        sym, lanes, dims = "paged_attn_bf16", (starts, qlens), (B, QS)
    fn = pa._kernel(sym)
    args = (q.data_ptr(), kp.data_ptr(), vp.data_ptr(), table.data_ptr(),
            *(t.data_ptr() for t in lanes), out.data_ptr(), ws.data_ptr(),
            *dims, nh, nkv, kp.shape[1], table.shape[1], nsplit, chunk,
            D ** -0.5)

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


def truncated(model, n_layers):
    """A view of ``model`` with its first ``n_layers`` layers (weights
    shared, nothing copied)."""
    from torch import nn

    m = copy.copy(model)
    m._modules = dict(model._modules)
    m.layers = nn.ModuleList(list(model.layers)[:n_layers])
    m.cfg = dataclasses.replace(model.cfg, num_layers=n_layers)
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
    ]


def decode_b3_cases(rng):
    """Split paged attention at QS=1, through the decode wrapper: (heads,
    positions, tokens per block).  Positions (the new token's, length - 1)
    on both sides of the 256-key chunk boundaries, one key (0), and lane
    1, which phase 1 empties (length 0)."""
    edges = [0, 5, 1, 15, 16, 17, 255, 256, 257, 511, 512, 513, 2047]
    return [
        ((H, KVH), edges + [int(x) for x in rng.integers(
            1, 2048, size=32 - len(edges))], BS),
        # qpk 8 (64/8 heads) and qpk 1 (32/32)
        ((64, 8), edges, BS),
        ((32, 32), edges, BS),
        # blocks of 12 tokens: the kernel divides by multiply and shift
        ((H, KVH), edges + [11, 12, 1535], 12),
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
]


def phase1(torch, np, st):
    from k8s_llm_monitor_tpu_torch.ops import paged_attention as pa

    rng = np.random.default_rng(1)
    gen = torch.Generator(device="cuda").manual_seed(1)
    errs, ulps = {}, {}
    for kvq in ("",) + QUANTS if wanted(st, "flash_prefill") else ():
        name = f"flash_prefill_{kvq}" if kvq else "flash_prefill"
        for nh, nkv, S, starts, lengths, bs in PREFILL_CASES:
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
    for heads, positions, nbl, bs in decode_cases(
            rng, set(pa.DECODE_CHUNK.values())) if wanted(
                st, "fused_decode") else ():
        nh, nkv = heads
        pos_t = torch.tensor(positions, device="cuda")
        covered = (pos_t > 0) & (pos_t < nbl * bs)
        for kvq in ("",) + QUANTS:
            name = f"fused_decode_{kvq}" if kvq else "fused_decode"
            if kvq:
                case = quant_decode_case(torch, rng, gen, positions, nbl,
                                         kvq, heads, bs)
                kernel = pa.paged_decode_attention_fused_quant
                plain = pa.paged_decode_attention_fused_quant_plain
            else:
                case = decode_case(torch, rng, gen, positions, nbl, heads, bs)
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
            print(f"phase 1: {name} H={nh} KVH={nkv} bs={bs} table "
                  f"{nbl}x{bs} B={len(positions)} positions "
                  f"{positions[:12]}{'...' if len(positions) > 12 else ''}: "
                  f"ok, max abs err {errs[name]:.4g}, max err "
                  f"{ulps[name]:.3g} ulps of the row ({extra})")
            del case, ck, cp, got, want
        torch.cuda.empty_cache()

    # split paged attention: decode (QS=1, through the decode wrapper, with
    # an empty lane) and PAGED_CASES (through the verify wrapper): rows of
    # live tokens at 2 ulps, rows past qlens and empty lanes exactly zero.
    if wanted(st, "paged_attn"):
        for heads, positions, bs in decode_b3_cases(rng):
            nbl = 2048 // bs + 1
            q, _, _, _, _, kp, vp, table, pos = decode_case(
                torch, rng, gen, positions, nbl, heads, bs)
            lens = pos + 1
            lens[1] = 0                                  # an empty lane
            got = pa.paged_decode_attention_pallas(q, kp, vp, table, lens)
            want = pa.flash_prefill_attention_plain(
                q, kp, vp, table, (lens - 1).clamp(min=0), lens.clamp(max=1))
            torch.cuda.synchronize()
            check(bool((got[1] == 0).all()),
                  "paged_attn QS=1: the empty lane is not zeroed")
            check_rows(torch, "paged_attn", got, want, lens > 0, errs, ulps)
            print(f"phase 1: paged_attn QS=1 H={heads[0]} KVH={heads[1]} "
                  f"bs={bs} B={len(positions)} lengths "
                  f"{lens.tolist()[:12]}...: ok, max abs err "
                  f"{errs['paged_attn']:.4g}, max err "
                  f"{ulps['paged_attn']:.3g} ulps of the row")
        for (nh, nkv), QS, starts, qlens, bs in PAGED_CASES:
            vcase = prefill_case(torch, rng, gen, len(starts), QS, starts,
                                 qlens, (nh, nkv), bs)
            got = pa.paged_verify_attention_pallas(*vcase)
            want = pa.flash_prefill_attention_plain(*vcase)
            torch.cuda.synchronize()
            for b, n in enumerate(qlens):
                check(bool((got[b, n:] == 0).all()),
                      f"paged_attn QS={QS}: rows past qlens of lane {b} not "
                      "zeroed")
                if n:
                    check_rows(torch, "paged_attn", got[b, :n], want[b, :n],
                               slice(None), errs, ulps)
            print(f"phase 1: paged_attn QS={QS} H={nh} KVH={nkv} bs={bs} "
                  f"starts={starts} qlens={qlens}: ok, max abs err "
                  f"{errs['paged_attn']:.4g}, max err "
                  f"{ulps['paged_attn']:.3g} ulps of the row")
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


def run_engine(torch, st, model, prompts, label, overrides, paths, kernels):
    """One engine of phase 2: two identical runs with the launch counts set
    to 0 just before the first and read just after it.  Returns the engine
    and the first run's ids."""
    from k8s_llm_monitor_tpu_torch.models import llama
    from k8s_llm_monitor_tpu_torch.ops import paged_attention as pa
    from k8s_llm_monitor_tpu_torch.serving.engine import (
        EngineConfig, InferenceEngine, SamplingParams)
    from k8s_llm_monitor_tpu_torch.utils.tokenizer import ByteTokenizer

    cfg = model.cfg
    ecfg = EngineConfig(max_slots=32, num_blocks=4096, block_size=16,
                        max_blocks_per_seq=ENGINE_TABLE,
                        max_prefills_per_step=8,
                        decode_steps_per_iter=8, **overrides)
    eng = InferenceEngine(cfg, model, ecfg, tokenizer=ByteTokenizer())
    check((eng.prefill_path, eng.decode_path) == paths,
          f"{label} engine paths {eng.prefill_path}/{eng.decode_path}, "
          f"expected {'/'.join(paths)}")
    sp = SamplingParams(max_tokens=32)
    pa.reset_launch_counts()
    steps0 = eng.steps
    t0 = time.monotonic()
    res = eng.generate(prompts, sp)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {rec: getattr(pa, fn).launches for rec, fn in kernels.items()}
    steps = eng.steps - steps0
    for r in res:
        check(r.finish_reason in ("eos", "length"),
              f"{label} {r.request_id}: finish {r.finish_reason} {r.error}")
        check(len(r.token_ids) <= 32 and all(
            0 <= t < cfg.vocab_size for t in r.token_ids),
            f"{label} {r.request_id}: bad ids")
    check(all(n > 0 for n in launches.values()),
          f"{label}: a kernel never launched on the main path: {launches}")
    check(eng.pool_bytes == eng.pages.nbytes(),
          f"{label}: pool bytes {eng.pool_bytes} != {eng.pages.nbytes()}")
    ttft = statistics.median(r.ttft_s for r in res)
    tok_s = eng.decode_tokens / eng.decode_s
    st["launches"].update(launches)
    st["engine_steps"][label] = (steps, eng.decode_steps)
    print(f"phase 2: {label}: {len(res)} requests done in {wall:.2f} s over "
          f"{steps} engine steps; launches {launches}")
    print(f"phase 2: {label}: first (cold) run: ttft p50 {ttft * 1e3:.1f} ms, "
          f"decode {tok_s:.1f} tok/s ({eng.decode_tokens} tokens in "
          f"{eng.decode_s:.2f} s, {eng.decode_steps} decode steps), weights "
          f"{llama.param_bytes(model)} B, pool {eng.pool_bytes} B "
          f"[{st['gpu']}]")
    tokens0, secs0 = eng.decode_tokens, eng.decode_s
    res2 = eng.generate(prompts, sp)
    check([r.token_ids for r in res] == [r.token_ids for r in res2],
          f"{label}: second identical run gave different ids")
    ttft2 = statistics.median(r.ttft_s for r in res2)
    tok_s2 = (eng.decode_tokens - tokens0) / (eng.decode_s - secs0)
    print(f"phase 2: {label}: second (warm) run identical: ttft p50 "
          f"{ttft2 * 1e3:.1f} ms, decode {tok_s2:.1f} tok/s, pool "
          f"{eng.pool_bytes} B [{st['gpu']}]")
    return eng, [r.token_ids for r in res]


def prompt_lengths(rng):
    """Phase 2's 16 prompt lengths (the first draws of ``rng``): 15 of
    20..1500 tokens, sorted, and one of 2300."""
    lens = sorted(int(x) for x in rng.integers(20, 1501, size=15)) + [2300]
    lens[0], lens[-2] = 20, 1500
    return lens


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
        eng, ids = run_engine(torch, st, model, prompts, label, overrides,
                              paths, kernels)
        if label == "bf16":
            text = eng.generate_text("why is pod web-1 in CrashLoopBackOff?",
                                     SamplingParams(max_tokens=8))
            check(isinstance(text, str), "generate_text returned no text")
            print(f"phase 2: generate_text ok ({len(text)} chars)")
        if label in TRACED:
            trace_decode(torch, eng, prompts, SamplingParams(max_tokens=32),
                         ids, st, label)
        del eng
        torch.cuda.empty_cache()
    st.update(model=model, prompt_lens=lens)


# Engines whose decode steps phase 2 traces, and the attention kernels it
# reports (by name: each must show device time in the window).
FUSED_KERNELS = ("fused_decode_split_kernel", "fused_decode_merge_kernel")
TRACED = {"bf16": FUSED_KERNELS, "int8": FUSED_KERNELS,
          "pallas": ("paged_attn_split_kernel", "paged_attn_merge_kernel")}


def trace_decode(torch, eng, prompts, sp, want_ids, st, label):
    """Run the prompts once more; once every prompt is prefilled, trace the
    remaining engine steps (decode only) with torch.profiler and split the
    window's wall time into device time per kernel and device idle time."""
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
    check(got == want_ids, "traced run gave different ids")
    per: dict[str, float] = {}
    per_n: dict[str, int] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per[e.name] = per.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
            per_n[e.name] = per_n.get(e.name, 0) + 1
    steps = eng.decode_steps - steps0
    busy = sum(per.values())
    check(steps > 0, "no decode step in the traced window")
    check(busy > 0, "the profiler saw no device time in the decode window")
    kms = {}
    for kernel in TRACED[label]:
        kms[kernel] = sum(v for k, v in per.items() if kernel in k)
        check(kms[kernel] > 0, f"{label}: no device time for {kernel} in "
              "the traced decode window")
    attn = sum(kms.values())
    print(f"phase 2: {label}: traced decode window: {steps} decode steps, "
          f"{eng.decode_tokens - tokens0} tokens, wall {wall_ms:.2f} ms "
          f"({wall_ms / steps:.3f} ms/step); device busy {busy:.2f} ms, idle "
          f"share {1 - busy / wall_ms:.3f}; attention "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in kms.items())
          + f" = {attn / wall_ms:.3f} of wall, {attn / steps:.3f} ms/step; "
          f"{sum(per_n.values())} device kernels [{st['gpu']}]")
    for name, ms in sorted(per.items(), key=lambda kv: -kv[1])[:8]:
        print(f"phase 2: {label}: trace: {ms:9.3f} ms {ms / wall_ms:6.3f} of "
              f"wall  {name[:90]}")


def marked(fn, **markers):
    """``fn`` as an attention impl carrying the wrapper markers that
    models/llama.py dispatches on (to run a plain version on the card)."""
    def impl(*args, **kwargs):
        return fn(*args, **kwargs)

    impl.__dict__.update(markers)
    return impl


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

    dev = torch.device("cuda")
    model = truncated(st["model"], 4)
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
    for label, kv_quant, kernel, plain in pairs:
        got, want = run(kv_quant, *kernel), run(kv_quant, *plain)
        errs = [float((a - b).abs().max()) for a, b in zip(got, want)]
        tol = QUANT_LOGIT_ATOL if kv_quant else LOGIT_ATOL
        # A row whose plain-path top two logits lie within the logit
        # tolerance is a near-tie of the plain path itself, which another
        # summation order may flip: it counts as agreeing.
        n_rows = n_agree = n_ties = 0
        for a, b in zip(got, want):
            top2 = b.float().topk(2, dim=-1).values
            tie = (top2[:, 0] - top2[:, 1]) <= tol
            n_agree += int(((a.argmax(-1) == b.argmax(-1)) | tie).sum())
            n_ties += int(tie.sum())
            n_rows += tie.numel()
        agree = n_agree / n_rows
        print(f"phase 3: 4-layer Llama-3-8B, {label}: logit max abs err "
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
                print(f"phase 3: {label}: step {step} row {r}: argmax "
                      f"{int(ia[r])} vs {int(ib[r])}, plain-path logits "
                      f"{gap:.4g} apart")
        check(max(errs) <= tol, f"{label}: logits differ by {max(errs):.4g}")
        check(agree >= MIN_ARGMAX_AGREE,
              f"{label}: argmax agreement {agree:.3f}")

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
    # verdict (469 tokens) fit, so no verdict is cut.
    ecfg = EngineConfig(max_slots=32, num_blocks=4096, block_size=16,
                        max_blocks_per_seq=ENGINE_TABLE,
                        max_prefills_per_step=8, decode_steps_per_iter=8)
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
              f"{launches} [{gpu}]")
        print(f"phase 5: 16 verdicts parse ({min(lens)}..{max(lens)} chars); "
              f"8 sampled and 1 streamed answer, no error [{gpu}]")
        via = backend.service.submit(lone_ids, constrained).result(timeout=300)
        check(via.token_ids == ref.token_ids and
              via.finish_reason == ref.finish_reason,
              "the lone question's ids differ through the service")
        print(f"phase 5: lone verdict ({len(ref.token_ids)} tokens): the same "
              f"ids through the service as through engine.generate [{gpu}]")
    finally:
        backend.service.stop()
    eng.token_sink = None

    # The sampled decode step with the bounded sampler (cap 64) against the
    # full-vocabulary sort (cap 0), in turns on the same engine.
    prompts = [[int(t) for t in rng.integers(3, cfg.vocab_size, size=100)]
               for _ in range(32)]
    sp = SamplingParams(max_tokens=64, temperature=0.7, top_k=40)
    per_step = {64: [], 0: []}
    for cap in (64, 0, 0, 64):
        eng.ecfg.sample_topk_cap = cap
        s0, d0, b0 = eng.decode_s, eng.decode_steps, eng.bounded_decode_steps
        res = eng.generate(prompts, sp)
        check(all(r.finish_reason in ("eos", "length") for r in res),
              f"sampled run at cap {cap}: {[r.error for r in res]}")
        check((eng.bounded_decode_steps > b0) == (cap > 0), "sampler choice")
        per_step[cap].append((eng.decode_s - s0) / (eng.decode_steps - d0))
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
          f"cap 64 / cap 0 / cap 0 / cap 64: "
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
        # The first step, cold (cuBLAS set-up, first 8B prefill), must not
        # trip the supervisor's heartbeat watchdog.
        cold = sup.submit(backend.tokenizer.encode("warm-up"),
                          SamplingParams(max_tokens=1, temperature=0.0)
                          ).result(timeout=300)
        check(cold.finish_reason in ("eos", "length"),
              f"first request ended {cold.finish_reason}: {cold.error}")
        check(sup.restarts == 0, "the first step tripped a restart")
        print(f"phase 6: first request (one step, cold): "
              f"{cold.latency_s * 1e3:.1f} ms; heartbeat timeout "
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
        s_status, events, first_s, s_wall = stream
        check(s_status == 200 and events and events[-1].get("done")
              and not any("error" in e for e in events),
              f"stream: HTTP {s_status}, events {events[-3:]}")
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
              f"launches {launches} [{gpu}]")

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
              f"the rebuild (pool {new_eng.pool_bytes} B) [{gpu}]")

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


SOURCES = {
    "flash_prefill": "k8s_llm_monitor_tpu_torch/csrc/flash_prefill.cu",
    "fused_decode": "k8s_llm_monitor_tpu_torch/csrc/fused_decode.cu",
    "paged_attn": "k8s_llm_monitor_tpu_torch/csrc/paged_attn.cu",
}
REPLACES = {   # k8s_llm_monitor_tpu/ops/pallas_attention.py:<line>
    "flash_prefill": 1150, "fused_decode": 471, "paged_attn": 190,
    "flash_prefill_int8": 1150, "flash_prefill_fp8": 1150,
    "fused_decode_int8": 822, "fused_decode_fp8": 822,
}


def phase4(torch, np, st):
    import torch.nn.functional as F

    from k8s_llm_monitor_tpu_torch.ops import paged_attention as pa
    from k8s_llm_monitor_tpu_torch.ops.attention import (
        gather_dequant, gather_pages)

    rng = np.random.default_rng(4)
    gen = torch.Generator(device="cuda").manual_seed(4)
    lens = st.get("prompt_lens") or prompt_lengths(np.random.default_rng(2))
    records = []

    def record(name, shape, ms, plain_ms, lib_ms, b_ms, by):
        records.append(dict(
            name=name, shape=shape, route="cuda",
            source=SOURCES[name.replace("_int8", "").replace("_fp8", "")],
            replaces="k8s_llm_monitor_tpu/ops/pallas_attention.py:"
                     f"{REPLACES[name]}",
            launches=st.get("launches", {}).get(name),
            max_abs_err=st.get("max_abs_err", {}).get(name),
            ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
            library_ms=lib_ms))

    def sdpa_inputs(q, kp, vp, table, ctx_max, mask, scales):
        """q, K, V and mask for one SDPA call: K/V gathered (and
        dequantized to bf16) beforehand, heads repeated, batch-head major."""
        B = q.shape[0]
        nb = (ctx_max + BS - 1) // BS
        if scales:
            k = gather_dequant(kp, scales["k_scale"], table[:, :nb], D)
            v = gather_dequant(vp, scales["v_scale"], table[:, :nb], D)
            k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
        else:
            k = gather_pages(kp, table[:, :nb]).reshape(B, -1, KVH, D)
            v = gather_pages(vp, table[:, :nb]).reshape(B, -1, KVH, D)
        k, v = k[:, :ctx_max], v[:, :ctx_max]
        rep = H // KVH
        k = k.repeat_interleave(rep, 2).transpose(1, 2).contiguous()
        v = v.repeat_interleave(rep, 2).transpose(1, 2).contiguous()
        return q.transpose(1, 2).contiguous(), k, v, mask[:, None]

    # flash prefill: an admission round of 8 prompts (the 8 shortest of
    # phase 2's, bucket 1024) and the long prompt's first chunk.
    shapes = [("admission", 1024, [0] * 8, [min(n, 1024) for n in lens[:8]]),
              ("chunk", 2048, [0], [2048])]
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
            print(f"phase 4: paged_attn {label} B=32 QS={QS} active="
                  f"{sum(n > 0 for n in qls)} max length {ctx_max} table "
                  f"{nbl}x{BS} ({nsplit} splits of {chunk}): kernel {ms:.4f} "
                  f"ms (alone: {alone_ms:.4f} ms), plain {plain_ms:.4f} ms, "
                  f"sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({by}) "
                  f"[{st['gpu']}]")
            record("paged_attn", label, ms, plain_ms, lib_ms, b_ms, by)
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

    for label, (steps, dsteps) in st.get("engine_steps", {}).items():
        per = {k: round(v / steps, 2) for k, v in st["launches"].items()
               if k in dict((e[0], e[3]) for e in ENGINES)[label]}
        print(f"phase 4: {label} engine: launches per engine step {per} over "
              f"{steps} steps ({dsteps} decode steps x 32 layers)")
    st["records"] = records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="0,1,2,3,4,5,6",
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
    runners = [(0, phase0), (1, phase1), (2, phase2), (3, phase3), (4, phase4),
               (5, phase5), (6, phase6)]
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
        print(json.dumps({"kernels": st["records"]}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
