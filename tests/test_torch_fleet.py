"""The port's fleet tier (k8s_llm_monitor_tpu_torch/fleet/) against the JAX
package's.

One set of float32 toy weights (``params_from_jax``) serves every engine:
greedy ids through the port's ``FleetRouter`` over two port
``LocalReplica``s equal the JAX router's over two JAX engines (and the
routing counters match); a replica killed mid-stream fails its request
over with only the undelivered remainder replayed, to the undisturbed
ids; a prefill→decode handoff installs the KVX1 prefix on the decode
replica and gives the unified ids; the router role
(``build_router_server`` and ``cmd.server --role router``) over two port
HTTP replicas on port 0 answers ``/api/v1/query`` with JAX's ``fleet``
stats keys; ``LocalPoolExecutor`` scales a port pool from one replica to
two.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from k8s_llm_monitor_tpu.fleet import FleetRouter as JFleetRouter
from k8s_llm_monitor_tpu.fleet import LocalReplica as JLocalReplica
from k8s_llm_monitor_tpu.fleet import ReplicaRegistry as JReplicaRegistry
from k8s_llm_monitor_tpu.fleet.frontend import (
    build_router_server as jbuild_router_server,
)
from k8s_llm_monitor_tpu.models import llama as jllama
from k8s_llm_monitor_tpu.models.config import ModelConfig as JModelConfig
from k8s_llm_monitor_tpu.monitor.config import Config as JConfig
from k8s_llm_monitor_tpu.serving import engine as jengine
from k8s_llm_monitor_tpu.serving.service import EngineService as JService
from k8s_llm_monitor_tpu_torch.convert import params_from_jax
from k8s_llm_monitor_tpu_torch.fleet import (
    FleetRouter,
    LocalPoolExecutor,
    LocalReplica,
    ReplicaRegistry,
)
from k8s_llm_monitor_tpu_torch.fleet.frontend import build_router_server
from k8s_llm_monitor_tpu_torch.models.config import ModelConfig
from k8s_llm_monitor_tpu_torch.monitor.analysis import (
    AnalysisEngine,
    LocalEngineBackend,
)
from k8s_llm_monitor_tpu_torch.monitor.config import Config, LLMConfig
from k8s_llm_monitor_tpu_torch.monitor.exporter import (
    lint_exposition,
    render_prometheus,
)
from k8s_llm_monitor_tpu_torch.monitor.server import (
    MonitorServer,
    _refuse_unported,
)
from k8s_llm_monitor_tpu_torch.serving import engine as tengine
from k8s_llm_monitor_tpu_torch.serving.service import EngineService
from k8s_llm_monitor_tpu_torch.utils.tokenizer import ByteTokenizer


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny engines run fastest on one intra-op thread, and many threads
    per test worker crowd the other workers out."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = Path(__file__).resolve().parent.parent
CFG_KW = dict(name="t", vocab_size=300, hidden_size=32, intermediate_size=64,
              num_layers=2, num_heads=4, num_kv_heads=2, dtype="float32",
              rope_theta=1e4)
# The JAX fleet tests' engine: 4 slots, 8-token blocks, a 128-token table.
ECFG_KW = dict(max_slots=4, num_blocks=64, block_size=8, max_blocks_per_seq=16,
               prefill_buckets=(16,), max_prefills_per_step=4,
               decode_steps_per_iter=4)
AFFINITY_TOKENS = 16


@pytest.fixture(scope="module")
def weights():
    """The JAX params and one port model of the same weights: the one
    model every port engine of the module reads."""
    params = jllama.init_params(jax.random.PRNGKey(0), JModelConfig(**CFG_KW))
    tree = jax.tree.map(np.asarray, params)
    return params, params_from_jax(tree, ModelConfig(**CFG_KW), device="cpu")


def _prompts():
    """Two cluster-context preambles longer than the affinity head, three
    questions on each: 21 + 3 tokens, so three full blocks are shareable."""
    rng = np.random.default_rng(19)
    heads = [[int(t) for t in rng.integers(3, 300, size=21)]
             for _ in range(2)]
    return [h + [int(t) for t in rng.integers(3, 300, size=3)]
            for h in heads for _ in range(3)]


def _port_engine(model, **over):
    return tengine.InferenceEngine(
        ModelConfig(**CFG_KW), model,
        tengine.EngineConfig(**{**ECFG_KW, **over}), eos_id=-1, device="cpu")


def _port_fleet(model, roles=("unified", "unified"), names=("r0", "r1")):
    reps = [LocalReplica(name, service=EngineService(_port_engine(model)),
                         role=role)
            for name, role in zip(names, roles)]
    reg = ReplicaRegistry()
    for r in reps:
        reg.add(r)
    reg.refresh()
    return reg, reps


def _close(reps):
    for r in reps:
        r.close()


def _wait(cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return cond()


def _run_burst(router, mod, prompts, n_tokens):
    """Submit every prompt at once; (ids, finish reasons) in prompt order,
    each stream equal to its result."""
    handles = [router.submit(p, mod.SamplingParams(max_tokens=n_tokens))
               for p in prompts]
    out = []
    for h in handles:
        toks = list(h.stream(timeout=120))
        res = h.result(timeout=120)
        assert toks == res.token_ids, (toks, res.token_ids)
        out.append((res.token_ids, res.finish_reason))
    return out


def test_router_greedy_ids_match_jax_router(weights):
    """The same burst through both routers (affinity, the same replica
    ids): equal greedy ids, and each replica served the same requests."""
    params, model = weights
    prompts = _prompts()
    jreps = []
    for name in ("r0", "r1"):
        eng = jengine.InferenceEngine(
            JModelConfig(**CFG_KW), params,
            jengine.EngineConfig(**ECFG_KW), eos_id=-1)
        jreps.append(JLocalReplica(name, service=JService(eng)))
    jreg = JReplicaRegistry()
    for r in jreps:
        jreg.add(r)
    jreg.refresh()
    jrouter = JFleetRouter(jreg, policy="affinity",
                           affinity_prefix_tokens=AFFINITY_TOKENS)
    reg, reps = _port_fleet(model)
    router = FleetRouter(reg, policy="affinity",
                         affinity_prefix_tokens=AFFINITY_TOKENS)
    try:
        want = _run_burst(jrouter, jengine, prompts, 8)
        got = _run_burst(router, tengine, prompts, 8)
        assert got == want
        assert all(reason == "length" for _, reason in got)
        assert _wait(lambda: router.counters()["completed"] == 6)
        c, jc = router.counters(), jrouter.counters()
        for key in ("dispatches", "completed", "failed", "failovers",
                    "affinity_hits", "affinity_spills", "sheds"):
            assert c[key] == jc[key], key
        assert c["affinity_hits"] == 6
        served = {rid: s["dispatches"] for rid, s in reg.snapshot().items()}
        jserved = {rid: s["dispatches"]
                   for rid, s in jreg.snapshot().items()}
        assert served == jserved == {"r0": 3, "r1": 3}
        # Each preamble lives on one replica: its later questions hit.
        reg.refresh()
        hits = sum(r.stats().prefix_hits for r in reps)
        jhits = sum(r.stats().prefix_hits for r in jreps)
        assert hits == jhits > 0
    finally:
        _close(jreps + reps)


def _gate_after_steps(replica, n_steps):
    """Hold the replica's step loop after ``n_steps`` engine steps until
    its service is stopped: the returned event is set once it waits, so a
    kill lands mid-stream, between two steps, on every run."""
    svc = replica.service
    eng = svc.engine
    real = eng.step
    reached = threading.Event()
    count = [0]

    def step():
        real()
        count[0] += 1
        if count[0] == n_steps:
            reached.set()
            svc._stop.wait(60)

    eng.step = step
    return reached


def test_midstream_kill_replays_only_the_remainder(weights):
    """A replica killed while it streams: the request finishes on the
    other replica with the undisturbed ids, no token lost or repeated; the
    survivor was asked for the prompt plus the delivered tokens and the
    rest of the budget only (JAX: tests/test_fleet.py
    ::test_midstream_failover_replays_remainder_exactly)."""
    _, model = weights
    prompt = _prompts()[0]
    n_tok = 40
    reg, reps = _port_fleet(model)
    router = FleetRouter(reg, policy="affinity",
                         affinity_prefix_tokens=AFFINITY_TOKENS,
                         max_failovers=2)
    try:
        ref = router.submit(prompt, tengine.SamplingParams(max_tokens=n_tok))
        want = ref.result(timeout=120)
        assert want.finish_reason == "length" and len(want.token_ids) == n_tok
        home = next(r for r in reps
                    if reg.snapshot()[r.replica_id]["dispatches"] == 1)
        other = next(r for r in reps if r is not home)
        calls = []
        real_generate = other.generate

        def record(prompt_ids, sampling=None, **kw):
            calls.append((list(prompt_ids), sampling.max_tokens,
                          kw.get("request_id")))
            return real_generate(prompt_ids, sampling, **kw)

        other.generate = record
        # The second run is a prefix hit on its home: admission, then
        # decode calls of 4 tokens; hold it after the third step.
        reached = _gate_after_steps(home, 3)
        h = router.submit(prompt, tengine.SamplingParams(max_tokens=n_tok))
        assert reached.wait(60), "the home replica never reached the gate"
        home.kill()
        toks = list(h.stream(timeout=120))
        res = h.result(timeout=120)
        assert res.finish_reason == "length", res.error
        assert toks == res.token_ids == want.token_ids
        assert _wait(lambda: router.counters()["failovers"] == 1)
        assert router.counters()["failed"] == 0
        assert len(calls) == 1
        replay, budget, rid = calls[0]
        delivered = len(replay) - len(prompt)
        assert 0 < delivered < n_tok
        assert replay == prompt + want.token_ids[:delivered]
        assert budget == n_tok - delivered
        assert rid.endswith("-a1")
        assert reg.snapshot()[home.replica_id]["ready"] is False
    finally:
        _close(reps)


def test_prefill_decode_handoff_installs_and_matches_unified(weights):
    """One prefill replica and one decode replica: the prompt and its
    first token on P, the KVX1 prefix exported from P and installed on D,
    the rest decoded on D (a prefix hit), to the ids a unified replica
    gives; the JAX router's handoff over JAX engines ends the same way."""
    params, model = weights
    prompt = _prompts()[3]
    reg, reps = _port_fleet(model, roles=("prefill", "decode"),
                            names=("p0", "d0"))
    ureg, ureps = _port_fleet(model, names=("u0",))
    jreps = []
    for name, role in (("p0", "prefill"), ("d0", "decode")):
        eng = jengine.InferenceEngine(
            JModelConfig(**CFG_KW), params,
            jengine.EngineConfig(**ECFG_KW), eos_id=-1)
        jreps.append(JLocalReplica(name, service=JService(eng), role=role))
    jreg = JReplicaRegistry()
    for r in jreps:
        jreg.add(r)
    jreg.refresh()
    try:
        unified = FleetRouter(ureg).submit(
            prompt, tengine.SamplingParams(max_tokens=12)).result(timeout=120)
        router = FleetRouter(reg, policy="affinity",
                             affinity_prefix_tokens=AFFINITY_TOKENS)
        p, d = reps
        outcomes = []
        install = d.install_prefix

        def recorded(blob, tenant=None):
            outcomes.append(install(blob, tenant=tenant))
            return outcomes[-1]

        d.install_prefix = recorded
        h = router.submit(prompt, tengine.SamplingParams(max_tokens=12))
        toks = list(h.stream(timeout=120))
        res = h.result(timeout=120)
        assert res.finish_reason == "length"
        assert toks == res.token_ids == unified.token_ids
        assert router.counters()["handoffs"] == {"decode": 1}
        assert outcomes == ["installed"]
        assert p.service.engine.prefix_cache.hits == 0
        assert d.service.engine.prefix_cache.hits == 1
        jrouter = JFleetRouter(jreg, policy="affinity",
                               affinity_prefix_tokens=AFFINITY_TOKENS)
        jres = jrouter.submit(prompt, jengine.SamplingParams(
            max_tokens=12)).result(timeout=120)
        assert jres.token_ids == res.token_ids
        assert jrouter.counters()["handoffs"] == {"decode": 1}
    finally:
        _close(reps + ureps + jreps)


def test_launch_counts_are_kept_per_thread():
    """Each replica's step thread reads its own engine's launches: a
    thread's count holds what it launched, the wrapper's ``launches`` the
    sum, and a reset clears the calling thread's count only."""
    from k8s_llm_monitor_tpu_torch.ops import paged_attention as pa

    pa.reset_launch_counts()
    seen = {}

    def launch(name, fn, n):
        pa.count_launches(fn, n)
        seen[name] = pa.thread_launches()

    runs = [threading.Thread(target=launch, args=(
        "a", pa.flash_prefill_attention, 3)), threading.Thread(
        target=launch, args=("b", pa.paged_decode_attention_fused, 5))]
    for t in runs:
        t.start()
    for t in runs:
        t.join()
    assert seen["a"]["flash_prefill_attention"] == 3
    assert seen["a"]["paged_decode_attention_fused"] == 0
    assert seen["b"]["paged_decode_attention_fused"] == 5
    assert seen["b"]["flash_prefill_attention"] == 0
    assert pa.flash_prefill_attention.launches == 3
    assert pa.paged_decode_attention_fused.launches == 5
    assert set(pa.thread_launches().values()) == {0}
    pa.count_launches(pa.paged_verify_attention_pallas, 2)
    pa.count_launches(pa.paged_verify_attention_pallas, -2)
    assert pa.thread_launches()["paged_verify_attention_pallas"] == 0
    pa.reset_launch_counts()
    assert pa.flash_prefill_attention.launches == 0


def test_decode_graph_captures_run_one_at_a_time(monkeypatch):
    """Two engines' step threads never capture decode graphs at once (a
    fleet's local replicas share a card): ``_capture`` holds the process's
    capture lock around the capture itself."""
    active, peak = [0], [0]

    def capture(self):
        active[0] += 1
        peak[0] = max(peak[0], active[0])
        time.sleep(0.05)
        active[0] -= 1

    monkeypatch.setattr(tengine._DecodeProgram, "_capture_locked", capture)
    progs = [object.__new__(tengine._DecodeProgram) for _ in range(4)]
    threads = [threading.Thread(target=p._capture) for p in progs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert peak[0] == 1 and active[0] == 0


def test_local_pool_executor_scales_a_port_pool_from_one_to_two(weights):
    _, model = weights
    reg, reps = _port_fleet(model, names=("unified-0",))

    def factory(role, rid):
        return LocalReplica(rid, service=EngineService(_port_engine(model)),
                            role=role)

    ex = LocalPoolExecutor(reg, factory)
    ex.adopt("unified", reps[0])
    try:
        assert ex.current_replicas("unified") == 1
        ex.scale("unified", 2)
        assert ex.current_replicas("unified") == 2
        snap = reg.snapshot()
        assert set(snap) == {"unified-0", "unified-auto-0"}
        assert snap["unified-auto-0"]["ready"] is True
        new = reg.get("unified-auto-0").replica
        res = new.generate(_prompts()[1],
                           tengine.SamplingParams(max_tokens=6)).result(
                               timeout=120)
        assert res.finish_reason == "length" and len(res.token_ids) == 6
        ex.scale("unified", 1)
        assert new.draining and ex.reap() == ["unified-auto-0"]
        assert set(reg.snapshot()) == {"unified-0"}
    finally:
        _close(reps)
        for _, pool in ex._pools.items():
            _close(pool)


# ---------------------------------------------------------------------------
# The router role over two port HTTP replicas
# ---------------------------------------------------------------------------


def _http_replica(model):
    tok = ByteTokenizer()
    eng = tengine.InferenceEngine(
        ModelConfig(**CFG_KW), model,
        tengine.EngineConfig(max_slots=2, num_blocks=512, block_size=16,
                             max_blocks_per_seq=128,
                             prefill_buckets=(128, 512, 2048),
                             decode_steps_per_iter=4),
        tokenizer=tok, device="cpu")
    backend = LocalEngineBackend(eng, tok)
    srv = MonitorServer(config=Config(), analysis=AnalysisEngine(
        backend, llm_cfg=LLMConfig(max_tokens=12)), port=0)
    srv.start()
    return srv, backend


@pytest.fixture(scope="module")
def http_replicas(weights):
    reps = [_http_replica(weights[1]) for _ in range(2)]
    yield reps
    for srv, backend in reps:
        srv.stop()
        backend.service.stop(timeout=5.0)


def _router_config(cls, reps):
    cfg = cls()
    cfg.server.host, cfg.server.port = "127.0.0.1", 0
    cfg.fleet.replicas = [f"http://127.0.0.1:{srv.port}" for srv, _ in reps]
    cfg.fleet.probe_interval_s = 0.2
    cfg.telemetry.enabled = False
    return cfg


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read()


def _query(port, question):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/api/v1/query",
        data=json.dumps({"question": question}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _keys(obj):
    """The key structure of a JSON body (values aside)."""
    if isinstance(obj, dict):
        return {k: _keys(v) for k, v in obj.items()}
    return type(obj).__name__


def test_router_role_serves_the_api_over_port_replicas(http_replicas):
    """``build_router_server`` over two port replicas: ``/api/v1/query``
    answers, ``/api/v1/stats`` carries the ``fleet`` block with the JAX
    router's keys (both routers in front of the same replicas),
    ``/metrics`` lints clean with the fleet families, and ``/readyz``
    turns not-ready when every replica is gone."""
    _refuse_unported(_router_config(Config, http_replicas))
    srv = build_router_server(_router_config(Config, http_replicas))
    jsrv = jbuild_router_server(_router_config(JConfig, http_replicas))
    srv.start()
    jsrv.start()
    try:
        body = _query(srv.port, "why is default/web crashlooping?")
        assert body["status"] == "success" and body["result"]["answer"]
        jbody = _query(jsrv.port, "why is default/web crashlooping?")
        assert jbody["status"] == "success" and jbody["result"]["answer"]
        stats = json.loads(_get(srv.port, "/api/v1/stats")[1])
        jstats = json.loads(_get(jsrv.port, "/api/v1/stats")[1])
        fleet = stats["fleet"]
        assert set(fleet["replicas"]) == {"replica-0", "replica-1"}
        assert _keys(fleet) == _keys(jstats["fleet"])
        assert fleet["counters"]["dispatches"] == 1
        health = json.loads(_get(srv.port, "/health")[1])
        assert health["ready"] and set(health["fleet"]) == set(
            json.loads(_get(jsrv.port, "/health")[1])["fleet"])
        status, raw = _get(srv.port, "/metrics")
        text = raw.decode()
        assert status == 200 and lint_exposition(text) == []
        assert lint_exposition(render_prometheus(srv)) == []
        for fam in ("fleet_replica_ready", "fleet_replica_inflight",
                    "fleet_affinity_hits_total", "fleet_failovers_total",
                    "fleet_handoffs_total", "fleet_hedge_delay_seconds"):
            assert f"k8s_llm_monitor_{fam}" in text, fam
        assert _get(srv.port, "/readyz")[0] == 200
        down = [s for s, _ in http_replicas]
        for rsrv in down:
            rsrv.stop()
        try:
            assert _wait(lambda: _get(srv.port, "/readyz")[0] == 503,
                         timeout=15)
            health = json.loads(_get(srv.port, "/health")[1])
            assert health["reason"] == "no ready fleet replicas"
        finally:
            for rsrv in down:
                rsrv.start()
        assert _wait(lambda: _get(srv.port, "/readyz")[0] == 200,
                     timeout=15)
    finally:
        for s in (srv, jsrv):
            s.analysis.close()
            s.stop()


def test_cmd_server_router_role_answers_and_exits_on_sigterm(
        http_replicas, tmp_path):
    """``python -m k8s_llm_monitor_tpu_torch.cmd.server --role router
    --replicas ...``: ready, one query answered through a replica, exit 0
    on SIGTERM."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    urls = ",".join(f"http://127.0.0.1:{srv.port}" for srv, _ in http_replicas)
    env = dict(os.environ, K8SLLM_FLIGHT_DIR=str(tmp_path),
               PYTHONPATH=str(ROOT), TELEMETRY_ENABLED="false")
    proc = subprocess.Popen(
        [sys.executable, "-m", "k8s_llm_monitor_tpu_torch.cmd.server",
         "--role", "router", "--replicas", urls, "--host", "127.0.0.1",
         "--port", str(port)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        def ready():
            try:
                return _get(port, "/readyz")[0] == 200
            except OSError:
                return False

        assert _wait(ready, timeout=60), "the router never became ready"
        body = _query(port, "which pods are pending?")
        assert body["status"] == "success" and body["result"]["answer"]
        stats = json.loads(_get(port, "/api/v1/stats")[1])
        assert stats["fleet"]["counters"]["dispatches"] == 1
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0, out.decode()[-2000:]
        assert b"router shutting down" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
