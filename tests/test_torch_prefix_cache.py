"""Prefix reuse in the port's engine against the JAX engine.

Both engines run from one set of float32 weights (params_from_jax) through
the scenarios of the JAX package's prefix-cache tests
(tests/test_prefix_cache.py) and tenant tests (tests/test_tenancy.py): the
prefix allocated once, a mixed hit/miss round, a long prompt's hit, cache
eviction before preemption, the cold-burst dedup (one publisher per
prefix, the tiny-prefix rule, a streaming publisher, a publisher
cancelled, the defer budget), tenant namespaces, and a tenant share cap of
0.5 on both engines.  Each scenario must give equal greedy ids and equal
hits, misses, deferrals, preemptions by class, requeues, watchdog trips,
dispatch failures, rounds per prefill bucket and final free block count.

The JAX engine's readiness probe is pinned (every call ready, as a CPU
call is in the port) so both schedules are deterministic.  Every K/V write
the port dispatches is checked against the allocator: no call appends into
a block another sequence or the cache shares.
"""

import jax
import numpy as np
import pytest

from k8s_llm_monitor_tpu.models import llama as jllama
from k8s_llm_monitor_tpu.models.config import ModelConfig as JModelConfig
from k8s_llm_monitor_tpu.resilience import faults as jfaults
from k8s_llm_monitor_tpu.serving import engine as jengine
from k8s_llm_monitor_tpu_torch.convert import params_from_jax
from k8s_llm_monitor_tpu_torch.models import llama as tllama
from k8s_llm_monitor_tpu_torch.models.config import ModelConfig
from k8s_llm_monitor_tpu_torch.resilience import faults as tfaults
from k8s_llm_monitor_tpu_torch.serving import engine as tengine

CFG_KW = dict(name="t", vocab_size=300, hidden_size=32, intermediate_size=64,
              num_layers=2, num_heads=4, num_kv_heads=2, dtype="float32",
              rope_theta=1e4)
# tests/test_prefix_cache.py:_engine's engine.
ECFG = dict(max_slots=4, num_blocks=64, block_size=8, max_blocks_per_seq=16,
            prefill_buckets=(16, 32))
# tests/test_tenancy.py's.
TENANCY_ECFG = dict(max_slots=4, num_blocks=64, block_size=8,
                    max_blocks_per_seq=16, prefill_buckets=(16,),
                    max_prefills_per_step=4, decode_steps_per_iter=4)


@pytest.fixture(scope="module")
def weights():
    params = jllama.init_params(jax.random.PRNGKey(0), JModelConfig(**CFG_KW))
    return params, params_from_jax(jax.tree.map(np.asarray, params),
                                   ModelConfig(**CFG_KW), device="cpu")


@pytest.fixture(autouse=True)
def _deterministic(monkeypatch):
    """Both fault injectors reset; the JAX engine's calls read as ready
    unless stuck; every port K/V write checked against the refcounts."""
    jfaults.get_injector().reset(seed=1234)
    tfaults.get_injector().reset(seed=1234)
    monkeypatch.setattr(
        jengine.InferenceEngine, "_call_ready",
        staticmethod(lambda call: not isinstance(call.arr,
                                                 jengine._StuckPayload)))
    scatter = tllama._scatter_pages

    def checked(pages, vals, block_table, positions, valid):
        eng = _PORT[-1] if _PORT else None
        if eng is not None:
            bs = pages.shape[1]
            nb = block_table.shape[1]
            blk = positions.long() // bs
            ok = valid & (blk < nb)
            ids = block_table.gather(1, blk.clamp(max=nb - 1))[ok]
            # Recorded, not raised: the engine's dispatch rollback would
            # take an exception raised here for a failed dispatch.
            _SHARED_WRITES.extend(
                (b, eng.allocator.ref_count(b))
                for b in set(ids.tolist()) - {0}
                if eng.allocator.ref_count(b) != 1)
        return scatter(pages, vals, block_table, positions, valid)

    monkeypatch.setattr(tllama, "_scatter_pages", checked)
    _PORT.clear()
    _SHARED_WRITES.clear()
    yield
    jfaults.get_injector().reset()
    tfaults.get_injector().reset()


_PORT: list = []
# (block, refcount) of every port write into a block not its writer's alone.
_SHARED_WRITES: list = []


def _engines(weights, ecfg, **kw):
    """(JAX engine, port engine) over the same weights and config."""
    kw = dict(ecfg, **kw)
    jeng = jengine.InferenceEngine(JModelConfig(**CFG_KW), weights[0],
                                   jengine.EngineConfig(**kw), eos_id=-1)
    peng = tengine.InferenceEngine(ModelConfig(**CFG_KW), weights[1],
                                   tengine.EngineConfig(**kw), eos_id=-1,
                                   device="cpu")
    return jeng, peng


def _counters(eng) -> dict:
    pc = eng.prefix_cache
    return {
        "hits": pc.hits if pc is not None else None,
        "misses": pc.misses if pc is not None else None,
        "evictions": pc.evictions if pc is not None else None,
        "prefix_deferrals": eng.prefix_deferrals,
        "preemptions_by_class": dict(eng.preemptions_by_class),
        "requeues": eng.requeues,
        "watchdog_trips": eng.watchdog_trips,
        "dispatch_failures": eng.dispatch_failures,
        "prefill_bucket_rounds": dict(eng.prefill_bucket_rounds),
        "free_blocks": eng.allocator.free_blocks,
        "tenant_blocks": (pc.blocks_by_tenant() if pc is not None else None),
    }


def _both(weights, scenario, ecfg=ECFG, **kw):
    """Run ``scenario(mod, eng)`` on both engines; its observations and
    the counters must be equal.  Returns the port's (observations,
    counters, engine)."""
    jeng, peng = _engines(weights, ecfg, **kw)
    want = scenario(jengine, jeng), _counters(jeng)
    _PORT.append(peng)
    got = scenario(tengine, peng), _counters(peng)
    assert not _SHARED_WRITES
    assert got[0] == want[0]
    assert got[1] == want[1]
    return got[0], got[1], peng


def _ints(rng, n):
    return [int(t) for t in rng.integers(3, 300, size=n)]


def _run(mod, eng, reqs, max_steps=2000):
    """Submit (id, prompt, max_tokens[, tenant]) greedy requests together,
    step to the end; {id: (ids, finish reason)}."""
    for r in reqs:
        rid, prompt, n = r[:3]
        kw = {"tenant": r[3]} if len(r) > 3 else {}
        eng.submit(mod.GenerationRequest(rid, list(prompt),
                                         mod.SamplingParams(max_tokens=n),
                                         **kw))
    steps = 0
    while eng.has_work:
        eng.step()
        steps += 1
        assert steps < max_steps
    out = {}
    for r in reqs:
        res = eng.poll(r[0])
        out[r[0]] = (res.token_ids, res.finish_reason)
    return out


def _assert_drained(eng):
    """Idle, and every block back once the cache lets go of its own."""
    assert not eng._inflight and not eng._deferred_frees
    eng.prefix_cache.clear()
    assert eng.allocator.free_blocks == eng.ecfg.num_blocks - 1


def test_same_prefix_requests_allocate_prefix_once(weights):
    rng = np.random.default_rng(0)
    prefix = _ints(rng, 24)                 # 3 full blocks at bs=8
    p1, p2 = prefix + _ints(rng, 4), prefix + _ints(rng, 5)

    def scenario(mod, eng):
        out = _run(mod, eng, [("p1", p1, 6)])
        free_before = eng.allocator.free_blocks
        eng.submit(mod.GenerationRequest("p2", list(p2),
                                         mod.SamplingParams(max_tokens=6)))
        eng.step()
        allocated = free_before - eng.allocator.free_blocks
        while eng.has_work:
            eng.step()
        r = eng.poll("p2")
        return out, (r.token_ids, r.finish_reason), allocated

    (_, _, allocated), c, eng = _both(weights, scenario)
    assert c["hits"] == 1 and allocated <= 2
    _assert_drained(eng)


def test_batched_mixed_hit_miss_round(weights):
    rng = np.random.default_rng(1)
    prefix = _ints(rng, 17)                 # 2 full blocks
    prompts = [prefix + _ints(rng, 3), _ints(rng, 12), prefix + _ints(rng, 6)]

    def scenario(mod, eng):
        seed = _run(mod, eng, [("seed", prefix + [7, 8], 2)])
        return seed, _run(mod, eng, [(f"m{i}", p, 5)
                                     for i, p in enumerate(prompts)])

    _, c, eng = _both(weights, scenario, max_prefills_per_step=4)
    assert c["hits"] >= 2
    _assert_drained(eng)


def test_long_prompt_prefix_hit(weights):
    rng = np.random.default_rng(2)
    long_prompt = _ints(rng, 60)            # chunked at bucket 16
    p2 = long_prompt[:56] + _ints(rng, 4)   # shares 7 blocks

    def scenario(mod, eng):
        return (_run(mod, eng, [("l1", long_prompt, 4)]),
                _run(mod, eng, [("l2", p2, 4)]))

    _, c, eng = _both(weights, scenario, num_blocks=128,
                      prefill_buckets=(16,))
    assert c["hits"] == 1
    _assert_drained(eng)


def test_cache_eviction_relieves_pressure_before_preemption(weights):
    rng = np.random.default_rng(3)
    fill = [_ints(rng, 20) for _ in range(4)]
    burst = [_ints(rng, 24) for _ in range(2)]

    def scenario(mod, eng):
        out = [_run(mod, eng, [(f"f{i}", p, 2)]) for i, p in enumerate(fill)]
        cached = len(eng.prefix_cache)
        out.append(_run(mod, eng, [(f"b{i}", p, 8)
                                   for i, p in enumerate(burst)]))
        return out, cached

    (out, cached), c, eng = _both(weights, scenario, max_slots=2,
                                  num_blocks=16)
    assert cached >= 2 and c["evictions"] > 0
    assert c["preemptions_by_class"] == {}
    assert all(r == "length" for _, r in out[-1].values())
    _assert_drained(eng)


def test_cold_burst_prefills_shared_prefix_once(weights):
    rng = np.random.default_rng(7)
    prefix = _ints(rng, 24)
    reqs = [(f"c{i}", prefix + _ints(rng, 4), 5) for i in range(5)]
    _, c, eng = _both(weights, lambda mod, e: _run(mod, e, reqs),
                      max_slots=8, max_prefills_per_step=8)
    assert c["prefix_deferrals"] == 4
    assert c["hits"] >= 4 and c["misses"] <= 1
    _assert_drained(eng)


def test_cold_burst_defers_per_distinct_prefix(weights):
    rng = np.random.default_rng(8)
    pre_a, pre_b = _ints(rng, 24), _ints(rng, 24)
    prompts = [pre_a + [11, 12, 13], pre_a + [14, 15], pre_b + [16, 17, 18],
               pre_b + [19, 20], _ints(rng, 20)]
    reqs = [(f"g{i}", p, 4) for i, p in enumerate(prompts)]
    _, c, eng = _both(weights, lambda mod, e: _run(mod, e, reqs),
                      max_slots=8, max_prefills_per_step=8, num_blocks=128)
    assert c["prefix_deferrals"] == 2
    _assert_drained(eng)


def test_tiny_shared_prefix_not_worth_deferring(weights):
    rng = np.random.default_rng(9)
    prefix = _ints(rng, 8)                  # 1 block of a 28-token prompt
    reqs = [(f"t{i}", prefix + _ints(rng, 20), 3) for i in range(3)]
    _, c, eng = _both(weights, lambda mod, e: _run(mod, e, reqs),
                      max_slots=8, max_prefills_per_step=8)
    assert c["prefix_deferrals"] == 0
    _assert_drained(eng)


STREAMING = dict(max_slots=4, num_blocks=128, max_blocks_per_seq=16,
                 prefill_buckets=(16,), max_prefills_per_step=4)


def _long_pair(seed):
    rng = np.random.default_rng(seed)
    prefix = _ints(rng, 48)                 # 6 blocks, 3 chunk rounds
    return prefix + _ints(rng, 20), prefix + _ints(rng, 21)


def test_long_cold_burst_waits_for_streaming_publisher(weights):
    p1, p2 = _long_pair(11)
    _, c, eng = _both(
        weights, lambda mod, e: _run(mod, e, [("l1", p1, 4), ("l2", p2, 4)]),
        **STREAMING)
    assert c["prefix_deferrals"] == 1 and c["hits"] >= 1
    _assert_drained(eng)


def test_publisher_cancel_releases_waiting_candidate(weights):
    p1, p2 = _long_pair(12)

    def scenario(mod, eng):
        for rid, p in (("c1", p1), ("c2", p2)):
            eng.submit(mod.GenerationRequest(rid, list(p),
                                             mod.SamplingParams(max_tokens=4)))
        eng.step()              # admits c1 (streaming), defers c2
        deferred = eng.prefix_deferrals
        eng.cancel("c1")
        while eng.has_work:
            eng.step()
        r1, r2 = eng.poll("c1"), eng.poll("c2")
        return deferred, r1.finish_reason, (r2.token_ids, r2.finish_reason)

    (deferred, _, (_, reason)), _, eng = _both(weights, scenario, **STREAMING)
    assert deferred == 1 and reason == "length"
    _assert_drained(eng)


def test_defer_budget_bounds_round_scan(weights):
    rng = np.random.default_rng(13)
    prefix = _ints(rng, 24)
    reqs = [(f"d{i}", prefix + _ints(rng, 4), 3) for i in range(12)]
    _, c, eng = _both(weights, lambda mod, e: _run(mod, e, reqs),
                      max_slots=16, num_blocks=256, max_prefills_per_step=2)
    assert c["misses"] == 1 and c["prefix_deferrals"] == 8
    _assert_drained(eng)


def test_kv_namespace_blocks_cross_tenant_reuse(weights):
    prompt = [(7 * i) % 290 + 3 for i in range(17)]

    def scenario(mod, eng):
        seen = []
        for rid, tenant in (("a1", "team-a"), ("b1", "team-b"),
                            ("a2", "team-a")):
            out = _run(mod, eng, [(rid, prompt, 4, tenant)])
            seen.append((out, eng.prefix_cache.hits, eng.prefix_cache.misses))
        return seen, eng.kv_tier_stats()["tenant_blocks"]

    (seen, blocks), _, eng = _both(weights, scenario, TENANCY_ECFG)
    assert [h for _, h, _ in seen] == [0, 0, 1]      # never across tenants
    assert blocks["team-a"] > 0 and blocks["team-b"] > 0
    _assert_drained(eng)


def test_tenant_share_cap_evicts_the_overshare_tenant(weights):
    # kv_max_tenant_share 0.5: once team-b is resident, team-a's
    # registrations past half the cached blocks evict team-a's own LRU
    # entries, never team-b's.
    rng = np.random.default_rng(21)
    b_prompt = _ints(rng, 17)
    a_prompts = [_ints(rng, 25) for _ in range(3)]

    def scenario(mod, eng):
        out = [_run(mod, eng, [("b", b_prompt, 3, "team-b")])]
        shares = []
        for i, p in enumerate(a_prompts):
            out.append(_run(mod, eng, [(f"a{i}", p, 3, "team-a")]))
            shares.append(eng.prefix_cache.blocks_by_tenant())
        return out, shares

    (_, shares), c, eng = _both(weights, scenario, TENANCY_ECFG,
                                kv_max_tenant_share=0.5)
    assert c["evictions"] > 0
    assert all(s["team-b"] == 2 for s in shares)
    assert all(s["team-a"] <= s["team-b"] for s in shares)
    _assert_drained(eng)
