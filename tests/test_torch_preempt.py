"""Preemption, recovery and fault points in the port's engine against the
JAX engine.

Both engines run from one set of float32 weights (params_from_jax) through
the scenarios of the JAX package's chaos tests (tests/test_resilience.py,
tests/test_overload.py, tests/test_tenancy.py), each fault point armed the
same way on both engines' injectors: a decode and a prefill dispatch
failure, the watchdog resetting a stuck decode call, allocator exhaustion
forcing a preemption, voluntary class-ordered eviction (byte-exact, never
of an equal or higher class, and through a ``lane_eviction`` fault), a
mixed-tenant burst under that fault, and recompute preemption under real
pool pressure, at every dispatch-ahead depth.  Each must give equal greedy
ids and equal prefix-cache hits and misses, deferrals, preemptions by
class, requeues, watchdog trips, dispatch failures, rounds per prefill
bucket and final free block count, and the port's free count must be back
at its idle baseline.

The JAX engine's readiness probe is pinned (every call ready unless stuck,
as a CPU call is in the port) so both schedules are deterministic.
"""

import jax
import numpy as np
import pytest

from k8s_llm_monitor_tpu.models import llama as jllama
from k8s_llm_monitor_tpu.models.config import ModelConfig as JModelConfig
from k8s_llm_monitor_tpu.resilience import faults as jfaults
from k8s_llm_monitor_tpu.serving import engine as jengine
from k8s_llm_monitor_tpu_torch.convert import params_from_jax
from k8s_llm_monitor_tpu_torch.models.config import ModelConfig
from k8s_llm_monitor_tpu_torch.resilience import faults as tfaults
from k8s_llm_monitor_tpu_torch.serving import engine as tengine

CFG_KW = dict(name="t", vocab_size=300, hidden_size=32, intermediate_size=64,
              num_layers=2, num_heads=4, num_kv_heads=2, dtype="float32",
              rope_theta=1e4)
# tests/test_resilience.py's and tests/test_overload.py's engine.
CHAOS = dict(max_slots=4, num_blocks=64, block_size=8, max_blocks_per_seq=16,
             prefill_buckets=(16,), max_prefills_per_step=4,
             decode_steps_per_iter=4, prefix_cache_entries=0)
# tests/test_tenancy.py's (the prefix cache at its default).
TENANCY = dict(CHAOS)
del TENANCY["prefix_cache_entries"]


@pytest.fixture(scope="module")
def weights():
    params = jllama.init_params(jax.random.PRNGKey(0), JModelConfig(**CFG_KW))
    return params, params_from_jax(jax.tree.map(np.asarray, params),
                                   ModelConfig(**CFG_KW), device="cpu")


@pytest.fixture(autouse=True)
def _deterministic(monkeypatch):
    jfaults.get_injector().reset(seed=1234)
    tfaults.get_injector().reset(seed=1234)
    monkeypatch.setattr(
        jengine.InferenceEngine, "_call_ready",
        staticmethod(lambda call: not isinstance(call.arr,
                                                 jengine._StuckPayload)))
    yield
    jfaults.get_injector().reset()
    tfaults.get_injector().reset()


def _counters(eng) -> dict:
    pc = eng.prefix_cache
    return {
        "hits": pc.hits if pc is not None else None,
        "misses": pc.misses if pc is not None else None,
        "prefix_deferrals": eng.prefix_deferrals,
        "preemptions_by_class": dict(eng.preemptions_by_class),
        "requeues": eng.requeues,
        "watchdog_trips": eng.watchdog_trips,
        "dispatch_failures": eng.dispatch_failures,
        "consecutive_dispatch_failures": eng.consecutive_dispatch_failures,
        "prefill_bucket_rounds": dict(eng.prefill_bucket_rounds),
        "free_blocks": eng.allocator.free_blocks,
    }


def _both(weights, scenario, ecfg=CHAOS, faults=(), **kw):
    """Run ``scenario(mod, eng)`` on a fresh JAX engine and a fresh port
    engine, the ``faults`` ((point, arm kwargs) pairs) armed on each
    engine's injector before its run; observations, counters and the
    faults fired must be equal.  Returns the port's (observations,
    counters, engine, baseline free count)."""
    kw = dict(ecfg, **kw)
    runs = []
    for mod, inj, model, extra in (
            (jengine, jfaults.get_injector(), weights[0], {}),
            (tengine, tfaults.get_injector(), weights[1], {"device": "cpu"})):
        mcfg = (JModelConfig if mod is jengine else ModelConfig)(**CFG_KW)
        eng = mod.InferenceEngine(mcfg, model, mod.EngineConfig(**kw),
                                  eos_id=-1, **extra)
        baseline = eng.allocator.free_blocks
        for point, akw in faults:
            inj.arm(point, **akw)
        out = scenario(mod, eng)
        fired = {p: inj.fired(p) for p, _ in faults}
        runs.append((out, _counters(eng), fired, eng, baseline))
    (want, wc, wf, _, _), (got, gc, gf, eng, baseline) = runs
    assert got == want
    assert gc == wc
    assert gf == wf
    return got, gc, eng, baseline


def _run(mod, eng, reqs, max_steps=2000):
    """Submit (id, prompt, max_tokens[, class[, tenant]]) greedy requests
    together and step to the end; {id: (ids, finish reason, error)}."""
    for r in reqs:
        _submit(mod, eng, *r)
    _drain(eng, max_steps)
    return _results(eng, reqs)


def _submit(mod, eng, rid, prompt, n, slo_class="standard",
            tenant="public"):
    eng.submit(mod.GenerationRequest(rid, list(prompt),
                                     mod.SamplingParams(max_tokens=n),
                                     slo_class=slo_class, tenant=tenant))


def _drain(eng, max_steps=2000):
    steps = 0
    while eng.has_work:
        eng.step()
        steps += 1
        assert steps < max_steps


def _results(eng, reqs):
    out = {}
    for r in reqs:
        res = eng._results.pop(r[0])
        out[r[0]] = (res.token_ids, res.finish_reason, res.error)
    return out


def test_decode_dispatch_failure_midstream_recovers(weights):
    reqs = [("a", [5, 6, 7], 10), ("b", [9, 10, 11, 12], 10)]
    out, c, eng, base = _both(
        weights, lambda mod, e: _run(mod, e, reqs),
        faults=[("decode_dispatch", dict(rate=1.0, times=1, after=1))])
    assert c["dispatch_failures"] == 1
    assert c["consecutive_dispatch_failures"] == 0
    assert all(r == "length" and len(t) == 10 for t, r, _ in out.values())
    assert c["free_blocks"] == base


def test_prefill_dispatch_failure_exhausts_budget_then_serves(weights):
    def run(mod, eng):
        inj = (jfaults if mod is jengine else tfaults).get_injector()
        first = _run(mod, eng, [("x", [3, 4, 5], 4)])
        requeues = eng.requeues
        inj.disarm("prefill_dispatch")
        return first, requeues, _run(mod, eng, [("y", [3, 4, 5], 4)])

    (first, requeues, second), c, eng, base = _both(
        weights, run, faults=[("prefill_dispatch", dict(rate=1.0))])
    tokens, reason, error = first["x"]
    assert reason == "error" and "prefill dispatch failed" in error
    assert "gave up after" in error
    assert requeues == eng.ecfg.max_requeues
    assert second["y"][1] == "length"
    assert c["free_blocks"] == base


def test_watchdog_resets_stuck_decode(weights):
    reqs = [("a", [5, 6, 7], 8), ("b", [8, 9], 8)]
    out, c, eng, base = _both(
        weights, lambda mod, e: _run(mod, e, reqs),
        faults=[("decode_stuck", dict(rate=1.0, times=1))],
        dispatch_timeout_s=0.05)
    assert c["watchdog_trips"] == 1 and c["requeues"] >= 1
    assert all(r in ("length", "eos") for _, r, _ in out.values())
    assert c["free_blocks"] == base


def test_stuck_decode_without_watchdog_resets_at_reconcile(weights):
    # The watchdog off: the stuck call's tokens cannot be read, and the
    # failed reconcile resets the pipeline instead.
    reqs = [("a", [5, 6, 7], 8), ("b", [8, 9], 8)]
    out, c, eng, base = _both(
        weights, lambda mod, e: _run(mod, e, reqs),
        faults=[("decode_stuck", dict(rate=1.0, times=1))])
    assert c["watchdog_trips"] == 0 and c["dispatch_failures"] == 1
    assert c["requeues"] >= 1
    assert all(r == "length" for _, r, _ in out.values())
    assert c["free_blocks"] == base


def test_alloc_exhaustion_preempts_then_recovers(weights):
    # Skip the two admission allocs; fire on the first extend and on its
    # retry after the drain, so a victim must be preempted.
    reqs = [("a", [3, 4, 5, 6, 7, 8], 12), ("b", [9, 10, 11, 12, 13, 14], 12)]
    out, c, eng, base = _both(
        weights, lambda mod, e: _run(mod, e, reqs),
        faults=[("alloc_exhaustion", dict(rate=1.0, times=2, after=2))])
    assert sum(c["preemptions_by_class"].values()) >= 1
    assert all(r == "length" for _, r, _ in out.values())
    assert c["free_blocks"] == base


def _eviction(mod, eng, lanes, arrival):
    """Two lanes running, then a third request arrives."""
    for r in lanes:
        _submit(mod, eng, *r)
    eng.step()
    eng.step()
    busy = eng.active_slots
    _submit(mod, eng, *arrival)
    _drain(eng)
    return busy, _results(eng, list(lanes) + [arrival])


BATCH_LANES = (("b0", [5, 6, 7], 60, "batch"), ("b1", [8, 9, 10], 60, "batch"))
INTERACTIVE = ("i0", [11, 12, 13], 6, "interactive")


def test_voluntary_eviction_is_byte_exact(weights):
    (busy, out), c, eng, base = _both(
        weights, lambda mod, e: _eviction(mod, e, BATCH_LANES, INTERACTIVE),
        max_slots=2)
    assert busy == 2
    assert c["preemptions_by_class"] == {"batch": 1}
    assert all(r == "length" for _, r, _ in out.values())
    # The preempted lane's recompute reproduces the unpreempted decode.
    (alone, _, _, _) = _both(
        weights, lambda mod, e: _run(mod, e, [r[:3] for r in BATCH_LANES]))
    assert {k: out[k] for k in alone} == alone
    assert c["free_blocks"] == base


def test_eviction_never_targets_equal_or_higher_class(weights):
    lanes = (("i0", [5, 6, 7], 40, "interactive"), ("s0", [8, 9, 10], 40))
    (_, out), c, eng, _ = _both(
        weights,
        lambda mod, e: _eviction(mod, e, lanes, ("s1", [11, 12, 13], 4)),
        max_slots=2)
    assert c["preemptions_by_class"] == {}
    assert out["s1"][1] == "length"


def test_lane_eviction_fault_recovers(weights):
    (_, out), c, eng, base = _both(
        weights, lambda mod, e: _eviction(mod, e, BATCH_LANES, INTERACTIVE),
        faults=[("lane_eviction", dict(rate=1.0, times=1))], max_slots=2)
    assert c["dispatch_failures"] >= 1
    assert c["preemptions_by_class"] == {"batch": 1}
    assert all(r == "length" for _, r, _ in out.values())
    assert c["free_blocks"] == base


def test_mixed_tenant_burst_under_lane_eviction_faults(weights):
    lanes = (("a-b0", [5, 6, 7], 60, "batch", "team-a"),
             ("b-b1", [8, 9, 10], 60, "batch", "team-b"))
    arrival = ("a-i0", [11, 12, 13], 6, "interactive", "team-a")

    def scenario(mod, eng):
        return _eviction(mod, eng, lanes, arrival), \
            eng.kv_tier_stats()["tenant_blocks"]

    ((_, out), blocks), c, eng, _ = _both(
        weights, scenario, TENANCY,
        faults=[("lane_eviction", dict(rate=1.0, times=1))], max_slots=2)
    assert all(r == "length" for _, r, _ in out.values())
    assert set(blocks) <= {"team-a", "team-b", "public"}
    eng.prefix_cache.clear()
    assert eng.allocator.free_blocks == eng.ecfg.num_blocks - 1


@pytest.mark.parametrize("max_inflight", [0, 1, 2, 3])
def test_pool_pressure_preempts_by_recompute(weights, max_inflight):
    # Four lanes of 24..31-token prompts and 40 new tokens each in a pool
    # of 23 usable blocks (184 tokens) against ~270 needed: lanes are
    # preempted and recomputed, in two SLO classes, the prefix cache on.
    rng = np.random.default_rng(31)
    reqs = [(f"r{i}", [int(t) for t in rng.integers(3, 300, size=n)], 40,
             "batch" if i % 2 else "standard")
            for i, n in enumerate((24, 31, 27, 29))]
    out, c, eng, base = _both(
        weights, lambda mod, e: _run(mod, e, reqs), TENANCY,
        num_blocks=24, max_inflight=max_inflight)
    assert sum(c["preemptions_by_class"].values()) > 0
    assert all(r == "length" and len(t) == 40 for t, r, _ in out.values())
    eng.prefix_cache.clear()
    assert eng.allocator.free_blocks == base


def test_reset_after_early_first_tokens_repeats_none(weights, monkeypatch):
    # On the card a finished admission call's first tokens go out before
    # its reconcile (events stand in for the card's here).  A watchdog
    # reset that drops such a call folds them into the requeued prompt, so
    # no token is delivered twice and the ids are the JAX engine's.
    class Done:
        def query(self):
            return True

        def synchronize(self):
            pass

    queue = tengine.InferenceEngine._queue_inflight
    reset = tengine.InferenceEngine._reset_pipeline
    dropped = []

    def patched(self, *args, **kwargs):
        queue(self, *args, **kwargs)
        self._inflight[-1].event = Done()

    def watched(self, cause, extra_calls=()):
        dropped.extend(c.kind for c in list(extra_calls) + list(self._inflight)
                       if c.delivered)
        reset(self, cause, extra_calls)

    monkeypatch.setattr(tengine.InferenceEngine, "_queue_inflight", patched)
    monkeypatch.setattr(tengine.InferenceEngine, "_reset_pipeline", watched)
    streamed = {}

    def scenario(mod, eng):
        if mod is tengine:
            eng.token_sink = lambda rid, toks, res: streamed.setdefault(
                rid, []).extend(toks)
        _submit(mod, eng, "a", [5, 6, 7], 8)
        eng.step()              # a's admission and its stuck decode call
        _submit(mod, eng, "b", [8, 9], 8)
        _drain(eng)             # b's admission goes out, then the reset
        return _results(eng, [("a",), ("b",)])

    out, c, eng, base = _both(
        weights, scenario,
        faults=[("decode_stuck", dict(rate=1.0, times=1))],
        dispatch_timeout_s=0.05)
    assert c["watchdog_trips"] == 1 and dropped == ["admit"]
    assert {rid: streamed[rid] for rid in out} == {
        rid: toks for rid, (toks, _, _) in out.items()}
    assert all(r == "length" for _, r, _ in out.values())
    assert c["free_blocks"] == base
