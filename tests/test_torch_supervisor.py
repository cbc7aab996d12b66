"""The port's EngineSupervisor and request journal over the port's engine.

Ports of tests/test_lifecycle.py's supervisor scenarios on the CPU: a
double kill under load replays without duplicates (greedy ids equal to the
uncrashed run's and to the JAX supervisor's on the same float32 weights), a
wedged step loop is found through its heartbeat, an exhausted restart
budget fails the survivors with the cause, admission is refused while the
engine rebuilds, a warm start replays an unsealed journal (one the JAX
package wrote too), a graceful shutdown drains, seals and flips readiness;
and ``LocalEngineBackend.from_config``'s factory releases the dead engine's
KV pool before it builds the next one.
"""

import gc
import logging
import threading
import time
import weakref

import jax
import numpy as np
import pytest

from k8s_llm_monitor_tpu.models import llama as jllama
from k8s_llm_monitor_tpu.models.config import ModelConfig as JModelConfig
from k8s_llm_monitor_tpu.resilience.journal import (
    RequestJournal as JRequestJournal,
)
from k8s_llm_monitor_tpu.resilience.retry import Backoff as JBackoff
from k8s_llm_monitor_tpu.serving import engine as jengine
from k8s_llm_monitor_tpu.serving.supervisor import (
    EngineSupervisor as JEngineSupervisor,
)
from k8s_llm_monitor_tpu_torch.cmd.server import _graceful_shutdown
from k8s_llm_monitor_tpu_torch.convert import params_from_jax
from k8s_llm_monitor_tpu_torch.models.config import ModelConfig
from k8s_llm_monitor_tpu_torch.monitor.analysis import LocalEngineBackend
from k8s_llm_monitor_tpu_torch.monitor.config import TPULLMConfig
from k8s_llm_monitor_tpu_torch.monitor.server import MonitorServer
from k8s_llm_monitor_tpu_torch.resilience.errors import OverloadedError
from k8s_llm_monitor_tpu_torch.resilience.faults import get_injector
from k8s_llm_monitor_tpu_torch.resilience.journal import (
    RequestJournal,
    scan_journal,
)
from k8s_llm_monitor_tpu_torch.resilience.retry import Backoff
from k8s_llm_monitor_tpu_torch.serving.engine import (
    EngineConfig,
    InferenceEngine,
    SamplingParams,
)
from k8s_llm_monitor_tpu_torch.serving.supervisor import EngineSupervisor

CFG_KW = dict(name="t", vocab_size=300, hidden_size=32, intermediate_size=64,
              num_layers=2, num_heads=4, num_kv_heads=2, dtype="float32",
              rope_theta=10_000.0)
ECFG = dict(max_slots=4, num_blocks=64, block_size=8,
            max_blocks_per_seq=16, prefill_buckets=(16,),
            max_prefills_per_step=4, decode_steps_per_iter=4)
N_LOAD = 32


def _load():
    """The double-kill load: 32 prompts of 5-8 tokens, budgets 3-8."""
    prompts = [[(7 * i + j) % 300 for j in range(5 + i % 4)]
               for i in range(N_LOAD)]
    return prompts, [3 + (i % 6) for i in range(N_LOAD)]


@pytest.fixture(scope="module")
def weights():
    params = jllama.init_params(jax.random.PRNGKey(0), JModelConfig(**CFG_KW))
    tree = jax.tree.map(np.asarray, params)
    return params, params_from_jax(tree, ModelConfig(**CFG_KW), device="cpu")


@pytest.fixture(autouse=True)
def _fault_isolation():
    get_injector().reset(seed=1234)
    yield
    get_injector().reset()


def _mk_engine(model, **overrides):
    """The port's engine; the prefix cache off, as in the JAX engine these
    tests compare with (cached prefixes would pin pages past the
    allocator's baseline)."""
    cfg = dict(ECFG, prefix_cache_entries=0)
    cfg.update(overrides)
    return InferenceEngine(ModelConfig(**CFG_KW), model, EngineConfig(**cfg),
                           eos_id=-1, device="cpu")


def _wait(predicate, timeout=30.0, interval=0.005):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return False


def _mk_supervisor(model, tmp_path=None, factory=None, **overrides):
    journal = None
    if tmp_path is not None:
        journal = RequestJournal(tmp_path / "wal", fsync="never")
    kw = dict(journal=journal, max_restarts=4,
              backoff=Backoff(base_s=0.01, cap_s=0.05, jitter=0.0),
              heartbeat_timeout_s=30.0, poll_interval_s=0.02)
    kw.update(overrides)
    return EngineSupervisor(factory or (lambda: _mk_engine(model)), **kw)


def _run_load(sup, kills=()):
    """Submit the load, stream every request from its own thread, and kill
    the step loop once per entry of ``kills`` (after that many restarts).
    Returns (results, streamed tokens)."""
    prompts, budgets = _load()
    handles = [sup.submit(p, SamplingParams(max_tokens=b, temperature=0.0))
               for p, b in zip(prompts, budgets)]
    streamed = [[] for _ in handles]

    def consume(i):
        for tok in handles[i].stream(timeout=60.0):
            streamed[i].append(tok)

    threads = [threading.Thread(target=consume, args=(i,), daemon=True)
               for i in range(len(handles))]
    for t in threads:
        t.start()
    for kill in kills:
        get_injector().arm("step_loop_crash", rate=1.0, times=1)
        assert _wait(lambda: sup.restarts == kill), f"kill {kill} missed"
        assert _wait(lambda: sup.state == "serving"), \
            f"rebuild {kill} never finished"
    for t in threads:
        t.join(timeout=60.0)
        assert not t.is_alive(), "stream hung after rebuild"
    return [h.result(timeout=60.0) for h in handles], streamed


@pytest.fixture(scope="module")
def jax_supervisor_ids(weights):
    """Greedy ids of the JAX supervisor (uncrashed) on the same load."""
    jeng = lambda: jengine.InferenceEngine(  # noqa: E731
        JModelConfig(**CFG_KW), weights[0],
        jengine.EngineConfig(prefix_cache_entries=0, **ECFG), eos_id=-1)
    sup = JEngineSupervisor(jeng, max_restarts=0,
                            backoff=JBackoff(base_s=0.01, cap_s=0.05,
                                             jitter=0.0),
                            poll_interval_s=0.02)
    try:
        prompts, budgets = _load()
        handles = [sup.submit(p, jengine.SamplingParams(max_tokens=b,
                                                        temperature=0.0))
                   for p, b in zip(prompts, budgets)]
        return [list(h.result(timeout=120.0).token_ids) for h in handles]
    finally:
        sup.shutdown(grace_s=1.0)


def test_double_kill_under_load_replays_without_duplicates(
        weights, tmp_path, jax_supervisor_ids):
    """Kill the step loop twice during a 32-request load: no hang, no lost
    or duplicated token, streams equal results, allocator back to its
    baseline, every admit tombstoned; greedy ids equal the uncrashed run's
    and the JAX supervisor's."""
    model = weights[1]
    clean = _mk_supervisor(model)
    try:
        clean_results, _ = _run_load(clean)
    finally:
        clean.shutdown(grace_s=1.0)
    clean_ids = [list(r.token_ids) for r in clean_results]
    assert clean_ids == jax_supervisor_ids

    sup = _mk_supervisor(model, tmp_path)
    try:
        baseline = sup.engine.allocator.free_blocks
        results, streamed = _run_load(sup, kills=(1, 2))
        _, budgets = _load()
        for i, res in enumerate(results):
            assert res.finish_reason != "error", (i, res.error)
            assert len(res.token_ids) == budgets[i], \
                f"request {i}: lost or duplicated tokens"
            # Stream == final result: replay never re-delivers a token.
            assert streamed[i] == list(res.token_ids), f"request {i}"
        assert [list(r.token_ids) for r in results] == clean_ids
        assert sup.restarts == 2
        assert sup.replayed_total >= 1
        assert sup.health.snapshot()["ready"]
        snap = sup.snapshot()
        assert snap["tracked"] == 0 and snap["journal_bytes"] > 0
        assert _wait(lambda: not sup.engine.has_work, timeout=5.0)
        assert sup.engine.allocator.free_blocks == baseline
        reqs, _ = scan_journal(tmp_path / "wal")
        assert len(reqs) == N_LOAD and all(r.completed for r in reqs.values())
    finally:
        sup.shutdown(grace_s=1.0)
    assert scan_journal(tmp_path / "wal")[1], "shutdown must seal the journal"


def test_wedged_loop_detected_by_stale_heartbeat(weights):
    """A step() that never returns (no exception) still triggers a rebuild:
    the heartbeat goes stale while work is pending."""
    gate = threading.Event()
    wedge = threading.Event()

    class _Wedgeable:
        """Engine proxy whose step() can be made to block."""

        def __init__(self, inner):
            object.__setattr__(self, "_inner", inner)

        def __getattr__(self, name):
            return getattr(self._inner, name)

        def __setattr__(self, name, value):  # token_sink/health assignment
            setattr(self._inner, name, value)

        def step(self):
            if wedge.is_set():
                gate.wait(timeout=60.0)
            return self._inner.step()

    built = []

    def factory():
        eng = _mk_engine(weights[1])
        built.append(eng)
        return _Wedgeable(eng) if len(built) == 1 else eng

    sup = EngineSupervisor(
        factory, max_restarts=3,
        backoff=Backoff(base_s=0.01, cap_s=0.05, jitter=0.0),
        heartbeat_timeout_s=0.3, poll_interval_s=0.05)
    try:
        wedge.set()
        h = sup.submit([1, 2, 3], SamplingParams(max_tokens=4))
        assert _wait(lambda: sup.restarts >= 1, timeout=10.0), \
            "stale heartbeat never detected"
        sup.heartbeat_timeout_s = 60.0
        res = h.result(timeout=30.0)
        assert res.finish_reason != "error", res.error
        assert len(res.token_ids) == 4
        assert len(built) >= 2, "factory must have been called for a rebuild"
    finally:
        gate.set()  # release the wedged thread so it can observe _stop
        sup.shutdown(grace_s=1.0)


def test_restart_budget_exhaustion_fails_survivors_with_cause(weights):
    sup = _mk_supervisor(weights[1], max_restarts=0)
    try:
        h = sup.submit([1, 2, 3], SamplingParams(max_tokens=50))
        get_injector().arm("step_loop_crash", rate=1.0, times=1)
        res = h.result(timeout=30.0)
        assert res.finish_reason == "error"
        assert "restart budget exhausted" in res.error
        assert _wait(lambda: sup.state == "failed", timeout=5.0)
        assert not sup.health.snapshot()["ready"]
        with pytest.raises(OverloadedError) as exc_info:
            sup.submit([1], SamplingParams(max_tokens=2))
        assert not exc_info.value.retriable
    finally:
        sup.close()


def test_admission_refused_while_rebuilding(weights):
    release = threading.Event()
    calls = []

    def factory():
        calls.append(1)
        if len(calls) > 1:
            assert release.wait(timeout=30.0)
        return _mk_engine(weights[1])

    sup = EngineSupervisor(
        factory, max_restarts=2,
        backoff=Backoff(base_s=0.01, cap_s=0.05, jitter=0.0),
        poll_interval_s=0.02)
    try:
        get_injector().arm("step_loop_crash", rate=1.0, times=1)
        assert _wait(lambda: sup.state == "rebuilding", timeout=10.0)
        with pytest.raises(OverloadedError) as exc_info:
            sup.submit([1, 2], SamplingParams(max_tokens=2))
        assert exc_info.value.retriable
        assert exc_info.value.retry_after_s > 0
        release.set()
        assert _wait(lambda: sup.state == "serving", timeout=10.0)
        res = sup.submit([1, 2], SamplingParams(max_tokens=2)).result(
            timeout=30.0)
        assert res.finish_reason != "error"
    finally:
        release.set()
        sup.close()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_warm_start_replays_unsealed_journal(weights, tmp_path, writer):
    """A journal left unsealed (SIGKILL shape) by the port, or by the JAX
    package: the port's supervisor replays the incomplete request before
    any fresh traffic, with its budget trimmed by the delivered tokens, and
    the greedy continuation equals an uninterrupted run's tail."""
    wal = tmp_path / "wal"
    ref = _mk_engine(weights[1]).generate(
        [[1, 2, 3]], SamplingParams(max_tokens=5, temperature=0.0))[0]
    journal_cls = RequestJournal if writer == "port" else JRequestJournal
    j = journal_cls(wal, fsync="never")
    j.log_admit("w1", [1, 2, 3], {"max_tokens": 5, "temperature": 0.0})
    j.log_progress("w1", list(ref.token_ids[:2]))
    j.log_admit("w2", [4, 5], {"max_tokens": 3})
    j.log_complete("w2")
    j.close()

    gate = threading.Event()

    class _Gated(InferenceEngine):
        """Holds its first step until the test has tapped the tokens."""

        def step(self):
            gate.wait(timeout=30.0)
            return super().step()

    def factory():
        return _Gated(ModelConfig(**CFG_KW), weights[1], EngineConfig(**ECFG),
                      eos_id=-1, device="cpu")

    sup = _mk_supervisor(weights[1], factory=factory,
                         journal=RequestJournal(wal, fsync="never"))
    replayed = []
    observe = sup.service.observer

    def tap(rid, toks, res):
        if rid == "w1":
            replayed.extend(toks)
        observe(rid, toks, res)

    sup.service.observer = tap
    gate.set()
    try:
        assert sup.replayed_total == 1
        assert _wait(lambda: sup.snapshot()["tracked"] == 0, timeout=30.0)
        # The replay generates only what was not delivered: after the two
        # journaled tokens, the rest of the greedy answer, nothing twice.
        assert list(ref.token_ids[:2]) + replayed == list(ref.token_ids)
    finally:
        sup.shutdown(grace_s=5.0)
    reqs, sealed = scan_journal(wal)
    assert sealed
    assert all(r.completed for r in reqs.values())
    j3 = RequestJournal(wal, fsync="never")
    assert j3.incomplete_recovered == []
    j3.close()


class _StubBackend:
    def __init__(self, supervisor):
        self.supervisor = supervisor

    @property
    def service(self):
        return self.supervisor.service


class _StubAnalysis:
    def __init__(self, backend):
        self.backend = backend


def test_graceful_shutdown_drains_seals_and_flips_readiness(weights,
                                                            tmp_path):
    sup = _mk_supervisor(weights[1], tmp_path)
    srv = MonitorServer(analysis=_StubAnalysis(_StubBackend(sup)))
    assert srv.health_snapshot()["ready"]
    h = sup.submit([1, 2, 3, 4], SamplingParams(max_tokens=6))

    _graceful_shutdown(srv, grace_s=20.0, log=logging.getLogger("test"))

    res = h.result(timeout=1.0)
    assert res.finish_reason != "error"
    assert len(res.token_ids) == 6
    reqs, sealed = scan_journal(tmp_path / "wal")
    assert sealed
    assert all(r.completed for r in reqs.values())
    snap = srv.health_snapshot()
    assert not snap["ready"]
    assert snap["lifecycle"]["state"] == "stopped"
    assert sup.state == "stopped"
    with pytest.raises(OverloadedError):
        sup.submit([1], SamplingParams(max_tokens=1))


def test_factory_releases_the_dead_engines_pool(tmp_path):
    """from_config's factory drops the dead engine's KV pages before it
    builds the replacement: after a crash and rebuild no reference to the
    old pool's tensors is left, and the new engine serves."""
    from k8s_llm_monitor_tpu_torch.monitor.config import LifecycleConfig

    tc = TPULLMConfig(model="tiny", quantize="", spec_k=0, kv_blocks=64,
                      max_batch=4)
    lc = LifecycleConfig(journal_dir=str(tmp_path / "wal"),
                         journal_fsync="never", restart_backoff_s=0.01)
    backend = LocalEngineBackend.from_config(tc, lifecycle=lc, device="cpu")
    sup = backend.supervisor
    try:
        old = backend.engine
        pages = weakref.ref(old.pages.k[0])
        h = sup.submit([5, 6, 7], SamplingParams(max_tokens=40,
                                                 temperature=0.0))
        assert h.poll_token(timeout=30.0) is not None
        get_injector().arm("step_loop_crash", rate=1.0, times=1)
        assert _wait(lambda: sup.restarts == 1 and sup.state == "serving",
                     timeout=30.0)
        res = h.result(timeout=30.0)
        assert res.finish_reason in ("eos", "length"), res.error
        new = backend.engine
        assert new is not old and old.pages is None
        assert new.pages is not None
        del old
        gc.collect()
        assert pages() is None, "the dead engine's pool is still referenced"
    finally:
        sup.shutdown(grace_s=1.0)
