"""The port's EngineService and the engine surface it drives.

Ports of tests/test_service.py (concurrent submissions share the engine's
continuous batch, the token sink emits incrementally, streaming handles
deliver tokens, cancel, EOS not streamed) with greedy ids held against the
JAX engine on the same float32 weights; ports of tests/test_overload.py's
class-ordered shedding, per-class Retry-After streaks and brownout clamps;
a port of tests/test_tenancy.py's per-tenant quota test through the
service; ``should_shed``'s KV-capacity clause against the JAX engine's;
and queue-TTL and ``deadline_s`` expiry.
"""

import threading

import jax
import numpy as np
import pytest

from k8s_llm_monitor_tpu.models import llama as jllama
from k8s_llm_monitor_tpu.models.config import ModelConfig as JModelConfig
from k8s_llm_monitor_tpu.serving import engine as jengine
from k8s_llm_monitor_tpu_torch.convert import params_from_jax
from k8s_llm_monitor_tpu_torch.models.config import ModelConfig
from k8s_llm_monitor_tpu_torch.resilience.slo import BROWNOUT_DEGRADED
from k8s_llm_monitor_tpu_torch.resilience.tenancy import TenantGovernor
from k8s_llm_monitor_tpu_torch.serving.engine import (
    EngineConfig,
    GenerationRequest,
    InferenceEngine,
    SamplingParams,
)
from k8s_llm_monitor_tpu_torch.serving.service import (
    EngineService,
    OverloadedError,
)

CFG_KW = dict(name="t", vocab_size=300, hidden_size=32, intermediate_size=64,
              num_layers=2, num_heads=4, num_kv_heads=2, dtype="float32",
              rope_theta=10_000.0)
ECFG = dict(max_slots=4, num_blocks=64, block_size=8,
            max_blocks_per_seq=16, prefill_buckets=(16,),
            max_prefills_per_step=4, decode_steps_per_iter=4)
PROMPT = [5, 6, 7]


def _prompts():
    rng = np.random.default_rng(0)
    return [[int(t) for t in rng.integers(3, 300, size=n)] for n in (5, 9, 3, 7)]


@pytest.fixture(scope="module")
def weights():
    params = jllama.init_params(jax.random.PRNGKey(0), JModelConfig(**CFG_KW))
    tree = jax.tree.map(np.asarray, params)
    return params, params_from_jax(tree, ModelConfig(**CFG_KW), device="cpu")


@pytest.fixture(scope="module")
def jax_greedy(weights):
    """Greedy ids of the JAX engine: 20 tokens for PROMPT, 8 for each of
    _prompts()."""
    eng = jengine.InferenceEngine(JModelConfig(**CFG_KW), weights[0],
                                  jengine.EngineConfig(**ECFG), eos_id=-1)
    [long] = eng.generate([PROMPT], jengine.SamplingParams(max_tokens=20))
    eights = eng.generate(_prompts(), jengine.SamplingParams(max_tokens=8))
    return long.token_ids, [r.token_ids for r in eights]


def _engine(weights, **overrides):
    return InferenceEngine(ModelConfig(**CFG_KW), weights[1],
                           EngineConfig(**dict(ECFG, **overrides)),
                           eos_id=-1, device="cpu")


def _run(eng):
    while eng.has_work:
        eng.step()


# -- tests/test_service.py -------------------------------------------------


def test_token_sink_emits_incrementally(weights, jax_greedy):
    """Tokens arrive in waves (the prefill's first token, then one batch
    per decode call) before the final result."""
    eng = _engine(weights)
    calls = []
    eng.token_sink = lambda rid, toks, res: calls.append((rid, list(toks), res))
    eng.submit(GenerationRequest("a", PROMPT, SamplingParams(max_tokens=10)))
    _run(eng)
    token_calls = [c for c in calls if c[1]]
    result_calls = [c for c in calls if c[2] is not None]
    assert len(result_calls) == 1
    assert result_calls[0][2].finish_reason == "length"
    assert len(token_calls) >= 3
    assert len(token_calls[0][1]) == 1
    streamed = [t for _, toks, _ in token_calls for t in toks]
    assert streamed == jax_greedy[0][:10]
    assert calls.index(result_calls[0]) == len(calls) - 1
    assert eng.poll("a") is not None and eng.poll("a") is None
    # One request of the default class in each lifecycle histogram.
    for hist in (eng.hist_ttft, eng.hist_e2e, eng.hist_queue_wait):
        assert hist.classes() == ["standard"] and hist.total_count() == 1


def test_concurrent_callers_share_batch(weights, jax_greedy):
    """Threads blocking on their handles share decode steps: the engine
    runs far fewer steps than serial generation would."""
    eng = _engine(weights)
    svc = EngineService(eng)
    prompts = _prompts()
    results = [None] * len(prompts)

    def worker(i):
        handle = svc.submit(prompts[i], SamplingParams(max_tokens=8))
        results[i] = handle.result(timeout=120)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    svc.stop()
    assert not any(t.is_alive() for t in threads)
    for r, w in zip(results, jax_greedy[1]):
        assert r is not None and r.finish_reason == "length"
        assert r.token_ids == w
    assert eng.steps <= 20, f"engine did not share decode steps: {eng.steps}"


def test_stream_yields_tokens(weights, jax_greedy):
    eng = _engine(weights)
    svc = EngineService(eng)
    handle = svc.submit(PROMPT, SamplingParams(max_tokens=10))
    toks = list(handle.stream(timeout=120))
    assert toks == jax_greedy[0][:10]
    assert handle.result(timeout=5).finish_reason == "length"
    svc.stop()


def test_cancel_stops_generation(weights):
    """Cancelling a handle mid-stream retires the request early."""
    eng = _engine(weights)
    svc = EngineService(eng)
    handle = svc.submit(PROMPT, SamplingParams(max_tokens=400))
    stream = handle.stream(timeout=120)
    got = [next(stream), next(stream)]
    handle.cancel()
    res = handle.result(timeout=120)
    assert len(got) == 2
    assert len(res.token_ids) < 127, "cancel did not stop generation"
    svc.stop()


def test_eos_not_streamed(weights, jax_greedy):
    eng = _engine(weights)
    svc = EngineService(eng)
    free = jax_greedy[0]
    idx = next(i for i in range(3, len(free)) if free[i] not in free[:i])
    eng.eos_id = free[idx]
    handle = svc.submit(PROMPT, SamplingParams(max_tokens=20))
    toks = list(handle.stream(timeout=120))
    res = handle.result(timeout=5)
    assert res.finish_reason == "eos"
    assert toks == res.token_ids == free[:idx]
    svc.stop()


# -- tests/test_overload.py ------------------------------------------------


def test_shedding_is_class_ordered(weights):
    eng = _engine(weights, shed_queue_tokens=24)
    for rid in ("b0", "b1"):
        eng.submit(GenerationRequest(rid, list(range(12)),
                                     SamplingParams(max_tokens=4),
                                     slo_class="batch"))
    # 24 batch tokens queued: batch is over its own budget, but higher
    # classes are never refused while lower-class work waits.
    assert "batch" in eng.should_shed("batch")
    assert eng.should_shed("interactive") == ""
    assert eng.should_shed("standard") == ""
    assert eng.queue_tokens_by_class() == {"batch": 24}
    assert (eng.queue_depth, eng.queue_tokens) == (2, 24)

    # Single-class traffic reduces to the flat threshold; a class is
    # charged for backlog of its own class and above.
    eng2 = _engine(weights, shed_queue_tokens=24)
    eng2.submit(GenerationRequest("s0", list(range(24)),
                                  SamplingParams(max_tokens=4)))
    assert eng2.should_shed("standard") != ""
    assert eng2.should_shed("batch") != ""
    assert eng2.should_shed("interactive") == ""
    _run(eng)
    _run(eng2)
    assert eng.queue_depth == eng2.queue_depth == eng.active_slots == 0


def test_service_per_class_retry_after_streaks(weights):
    eng = _engine(weights)
    svc = EngineService(eng)
    try:
        real_shed = eng.should_shed
        eng.should_shed = lambda slo_class="standard", need_tokens=0: "forced overload"
        hints = {"batch": [], "interactive": []}
        for _ in range(5):
            with pytest.raises(OverloadedError) as ei:
                svc.submit([1, 2, 3], SamplingParams(max_tokens=2),
                           slo_class="batch")
            assert ei.value.slo_class == "batch"
            hints["batch"].append(ei.value.retry_after_s)
        with pytest.raises(OverloadedError) as ei:
            svc.submit([1, 2, 3], SamplingParams(max_tokens=2),
                       slo_class="interactive")
        hints["interactive"].append(ei.value.retry_after_s)
        # Deterministic backoff (jitter 0, base 1 s, cap 8 s), one streak
        # per class.
        assert hints["batch"] == [1.0, 2.0, 4.0, 8.0, 8.0]
        assert hints["interactive"] == [1.0]
        assert svc.shed_count_by_class == {"batch": 5, "interactive": 1}

        # A successful admit of the class resets its streak.
        eng.should_shed = real_shed
        svc.submit([1, 2, 3], SamplingParams(max_tokens=2),
                   slo_class="batch").result(timeout=30)
        eng.should_shed = lambda slo_class="standard", need_tokens=0: "forced overload"
        with pytest.raises(OverloadedError) as ei:
            svc.submit([1, 2, 3], SamplingParams(max_tokens=2),
                       slo_class="batch")
        assert ei.value.retry_after_s == 1.0
        eng.should_shed = real_shed
    finally:
        svc.stop(timeout=10.0)


def test_brownout_clamps_batch_budget_only(weights):
    eng = _engine(weights, brownout_batch_max_tokens=8)
    eng.brownout = lambda: BROWNOUT_DEGRADED
    eng.submit(GenerationRequest("b0", [5, 6, 7],
                                 SamplingParams(max_tokens=40),
                                 slo_class="batch"))
    eng.submit(GenerationRequest("i0", [8, 9, 10],
                                 SamplingParams(max_tokens=12),
                                 slo_class="interactive"))
    _run(eng)
    assert len(eng._results["b0"].token_ids) == 8      # clamped at admission
    assert len(eng._results["i0"].token_ids) == 12     # untouched
    assert eng.brownout_clamps == 1

    eng2 = _engine(weights, brownout_batch_max_tokens=8)
    eng2.submit(GenerationRequest("b0", [5, 6, 7],
                                  SamplingParams(max_tokens=12),
                                  slo_class="batch"))
    _run(eng2)
    assert len(eng2._results["b0"].token_ids) == 12
    assert eng2.brownout_clamps == 0


def test_brownout_clamp_exempts_constrained(weights):
    eng = _engine(weights, brownout_batch_max_tokens=8)
    eng.brownout = lambda: BROWNOUT_DEGRADED
    req = GenerationRequest("c0", [5, 6, 7],
                            SamplingParams(max_tokens=40, constrained=True),
                            slo_class="batch")
    eng._clamp_for_brownout(req)
    assert req.sampling.max_tokens == 40
    assert eng.brownout_clamps == 0


@pytest.mark.parametrize("policy", ["tier", "device", "off"])
def test_kv_capacity_clause_matches_jax(weights, policy):
    """``kv_admission``: "device" refuses a footprint past the free blocks;
    "tier" (no host tier here) and "off" never do; reasons equal JAX's."""
    kw = dict(ECFG, kv_admission=policy)
    port = _engine(weights, kv_admission=policy)
    jeng = jengine.InferenceEngine(
        JModelConfig(**CFG_KW), weights[0],
        jengine.EngineConfig(prefix_cache_entries=0, **kw), eos_id=-1)
    free = port.allocator.free_blocks * port.ecfg.block_size
    assert port.admission_headroom_tokens() == free
    assert jeng.admission_headroom_tokens() == free
    for need in (0, free, free + 1):
        want = jeng.should_shed("standard", need_tokens=need)
        assert port.should_shed("standard", need_tokens=need) == want
        assert bool(want) == (policy == "device" and need > free)


def test_flooding_tenant_rate_limited_quiet_tenant_unharmed(weights):
    """A tenant far past its request-rate quota collects tenant-tagged
    refusals before the shed check, while a within-quota tenant's requests
    admit and complete with the JAX engine's greedy ids."""
    gov = TenantGovernor(requests_per_s=0.5, request_burst=4.0)
    svc = EngineService(_engine(weights), governor=gov)
    rng = np.random.default_rng(41)
    try:
        flood, refused = [], 0
        for i in range(20):
            p = [int(t) for t in rng.integers(3, 300, size=8)]
            try:
                flood.append(svc.submit(
                    p, SamplingParams(max_tokens=4), request_id=f"noisy{i}",
                    tenant="noisy", slo_class="standard"))
            except OverloadedError as exc:
                refused += 1
                assert exc.tenant == "noisy"
                assert exc.retriable and exc.retry_after_s > 0
        assert refused >= 15
        quiet = [[int(t) for t in rng.integers(3, 300, size=8)]
                 for _ in range(4)]
        jeng = jengine.InferenceEngine(JModelConfig(**CFG_KW), weights[0],
                                       jengine.EngineConfig(**ECFG),
                                       eos_id=-1)
        want = jeng.generate(quiet, jengine.SamplingParams(max_tokens=4))
        for i, p in enumerate(quiet):
            res = svc.submit(p, SamplingParams(max_tokens=4),
                             request_id=f"quiet{i}", tenant="quiet",
                             slo_class="interactive").result(timeout=60)
            assert res.finish_reason == "length"
            assert res.token_ids == want[i].token_ids
        for h in flood:
            h.result(timeout=60)
        snap = gov.snapshot()
        assert snap["noisy"]["quota_refusals"] == refused
        assert snap["quiet"]["quota_refusals"] == 0
        assert snap["quiet"]["sheds"] == 0
        assert snap["noisy"]["inflight"] == snap["quiet"]["inflight"] == 0
    finally:
        svc.stop(timeout=10)


# -- queue TTL and deadlines -------------------------------------------------


def test_queue_ttl_and_deadline_expiry(weights):
    """A queued request past the queue TTL fails in the queue; a running one
    is not bound by the TTL but by its own deadline_s, and then ends with
    an error carrying the tokens it had.  Both results reach the sink."""
    eng = _engine(weights, max_slots=1, queue_ttl_s=5.0)
    sunk = {}
    eng.token_sink = lambda rid, toks, res: res and sunk.setdefault(rid, res)
    run = GenerationRequest("run", PROMPT, SamplingParams(max_tokens=40),
                            deadline_s=30.0)
    queued = GenerationRequest("queued", [8, 9], SamplingParams(max_tokens=4))
    eng.submit(run)
    eng.submit(queued)
    eng.step()
    assert (eng.active_slots, eng.queue_depth) == (1, 1)
    queued.submit_time -= 6.0
    run.submit_time -= 6.0            # past the TTL, within its deadline
    eng.step()
    r = eng.poll("queued")
    assert r.finish_reason == "error" and "in queue" in r.error
    assert eng.active_slots == 1 and eng.poll("run") is None
    run.submit_time -= 30.0
    eng.step()
    r = eng.poll("run")
    assert r.finish_reason == "error" and "deadline exceeded" in r.error
    assert 0 < len(r.token_ids) < 40
    assert eng.deadline_expired == 2 and not eng.has_work
    assert set(sunk) == {"run", "queued"}

    # deadline_s reaches the engine through the service.
    svc = EngineService(_engine(weights))
    try:
        res = svc.submit(PROMPT, SamplingParams(max_tokens=8),
                         deadline_s=1e-9).result(timeout=30)
        assert res.finish_reason == "error" and "deadline" in res.error
    finally:
        svc.stop()
