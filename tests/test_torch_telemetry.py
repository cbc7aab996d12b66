"""The server pieces the monitor's default config turns on, against the JAX
package's: ``/metrics`` (monitor/exporter.py), the telemetry plane
(``/api/v1/signals``, ``/api/v1/timeseries``), closed-loop remediation
(``/api/v1/remediations*``), the UAV routes, ``/debug/profile`` and the
kube breaker's health block.

Both packages' ``build_server`` boot the default config (telemetry and
remediation on) over the demo ``FakeCluster`` with the template backend:
each route gives the same status and body, timestamps and minted ids
aside, and ``/metrics`` the same families, types and label sets.  With a
tiny float32 engine on each side, from one set of weights, the engine
counters that do not depend on wall time are equal.  A few of
tests/test_remediation.py's scenarios run through both packages'
remediation engines and give the same records.  ``build_server`` boots
``load_config(None)`` on the CPU with no knob turned off.  Servers bind
port 0; the scrapers' threads are stopped and scrapes driven by hand, so
bodies do not depend on timing.
"""

import json
import os
import re
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from k8s_llm_monitor_tpu.models import llama as jllama
from k8s_llm_monitor_tpu.models.config import ModelConfig as JModelConfig
from k8s_llm_monitor_tpu.monitor import analysis as janalysis
from k8s_llm_monitor_tpu.monitor.client import Client as JClient
from k8s_llm_monitor_tpu.monitor.cluster import FakeCluster as JFakeCluster
from k8s_llm_monitor_tpu.monitor.cluster import (
    seed_demo_cluster as jseed_demo_cluster,
)
from k8s_llm_monitor_tpu.monitor.config import Config as JConfig
from k8s_llm_monitor_tpu.monitor.config import (
    RemediationConfig as JRemediationConfig,
)
from k8s_llm_monitor_tpu.monitor.manager import Manager as JManager
from k8s_llm_monitor_tpu.monitor.models import EventInfo as JEventInfo
from k8s_llm_monitor_tpu.monitor.server import MonitorServer as JMonitorServer
from k8s_llm_monitor_tpu.monitor.server import build_server as jbuild_server
from k8s_llm_monitor_tpu.observability.signals import (
    SignalScraper as JSignalScraper,
)
from k8s_llm_monitor_tpu.remediation import (
    RemediationEngine as JRemediationEngine,
)
from k8s_llm_monitor_tpu.resilience.retry import (
    CircuitBreaker as JCircuitBreaker,
)
from k8s_llm_monitor_tpu.serving import engine as jengine
from k8s_llm_monitor_tpu.utils.tokenizer import ByteTokenizer as JByteTokenizer
from k8s_llm_monitor_tpu_torch.convert import params_from_jax
from k8s_llm_monitor_tpu_torch.models.config import ModelConfig
from k8s_llm_monitor_tpu_torch.monitor import analysis
from k8s_llm_monitor_tpu_torch.monitor.client import Client
from k8s_llm_monitor_tpu_torch.monitor.cluster import (
    FakeCluster,
    seed_demo_cluster,
)
from k8s_llm_monitor_tpu_torch.monitor.config import (
    Config,
    RemediationConfig,
    load_config,
)
from k8s_llm_monitor_tpu_torch.monitor.exporter import lint_exposition
from k8s_llm_monitor_tpu_torch.monitor.manager import Manager
from k8s_llm_monitor_tpu_torch.monitor.models import EventInfo
from k8s_llm_monitor_tpu_torch.monitor.server import (
    MonitorServer,
    build_server,
)
from k8s_llm_monitor_tpu_torch.observability.signals import SignalScraper
from k8s_llm_monitor_tpu_torch.remediation import RemediationEngine
from k8s_llm_monitor_tpu_torch.resilience.retry import CircuitBreaker
from k8s_llm_monitor_tpu_torch.serving import engine as tengine
from k8s_llm_monitor_tpu_torch.serving.engine import (
    EngineConfig,
    InferenceEngine,
    SamplingParams,
)
from k8s_llm_monitor_tpu_torch.utils.tokenizer import ByteTokenizer


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny engines run fastest on one intra-op thread, and many threads
    per test worker crowd the other workers out."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


NODE = "k3d-demo-agent-0"
_TS = re.compile(r"^\d{4}-\d\d-\d\dT\d\d:\d\d:\d\d(\.\d+)?(Z|[+-]\d\d:\d\d)?$")
_MINTED = {"request_id", "session_id", "t_mono"}
# The one family set the two exporters draw from different runtimes:
# jax.local_devices() against torch.cuda (no card here: 0 devices).
_DEVICE_FAMILIES = {"k8s_llm_monitor_devices",
                    "k8s_llm_monitor_device_memory_used_bytes",
                    "k8s_llm_monitor_device_memory_limit_bytes"}


def _normalize(obj):
    if isinstance(obj, dict):
        return {k: ("<id>" if k in _MINTED and obj[k] else _normalize(v))
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [_normalize(v) for v in obj]
    if isinstance(obj, str) and _TS.match(obj):
        return "<ts>"
    return obj


def _call(port, method, path, body=None):
    """(status, content type, CORS header, body): JSON decoded and
    normalized; text as is."""
    data = body if isinstance(body, bytes) else (
        json.dumps(body).encode() if body is not None else None)
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data, method=method,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            status, ctype, raw = r.status, r.headers["Content-Type"], r.read()
            cors = r.headers.get("Access-Control-Allow-Origin")
    except urllib.error.HTTPError as err:
        status, ctype, raw = err.code, err.headers["Content-Type"], err.read()
        cors = err.headers.get("Access-Control-Allow-Origin")
    if ctype.startswith("application/json"):
        return status, ctype, cors, _normalize(json.loads(raw))
    return status, ctype, cors, raw.decode()


def _families(text: str) -> dict:
    """{family: (type, sorted label blocks of its samples)}."""
    types, labels = {}, {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, mtype = line.split(" ", 3)
            types[name] = mtype
            labels.setdefault(name, set())
        elif line and not line.startswith("#"):
            name, block = re.match(r"^([^{ ]+)(\{[^}]*\})?", line).groups()
            fam = next((f for f in (name, re.sub(
                r"_(bucket|sum|count)$", "", name)) if f in types), name)
            labels.setdefault(fam, set()).add(block or "")
    return {f: (types.get(f), sorted(labels[f])) for f in labels}


def _samples(text: str) -> dict:
    """{sample name with its labels: value string}."""
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            key, _, value = line.rpartition(" ")
            out[key] = value
    return out


def _default_config(cls):
    cfg = cls()
    cfg.server.port = 0
    cfg.llm.provider = "template"
    return cfg


@pytest.fixture(scope="module")
def servers():
    """Both packages' servers on the default config (telemetry and
    remediation on), template backend, the demo cluster."""
    jsrv = jbuild_server(_default_config(JConfig),
                         backend=jseed_demo_cluster(JFakeCluster()))
    psrv = build_server(_default_config(Config),
                        backend=seed_demo_cluster(FakeCluster()))
    for srv in (jsrv, psrv):
        srv.manager.collect()
        srv.start()
        srv.signals.stop()          # scrapes by hand below
        srv.signals.scrape_once()
    yield jsrv, psrv
    for srv in (jsrv, psrv):
        srv.stop()


def test_default_knobs_are_wired_as_in_jax(servers):
    jsrv, psrv = servers
    for srv in (jsrv, psrv):
        assert srv.signals is not None and srv.remediation is not None
        assert srv.diagnosis.remediation is srv.remediation
    assert type(psrv.signals) is SignalScraper
    assert type(psrv.remediation) is RemediationEngine


# (method, path, body): the routes of ROADMAP A13, with their error paths.
ROUTES = [
    ("GET", "/api/v1/signals", None),
    ("GET", "/api/v1/signals?window=30", None),
    ("GET", "/api/v1/signals?window=abc", None),
    ("GET", "/api/v1/signals?window=-1", None),
    ("POST", "/api/v1/signals", {}),
    ("GET", "/api/v1/timeseries", None),
    ("GET", "/api/v1/timeseries?name=queue_tokens", None),
    ("GET", "/api/v1/timeseries?name=busy_slots&window=abc", None),
    ("GET", "/api/v1/timeseries?name=busy_slots&replica=local&window=5",
     None),
    ("GET", "/api/v1/remediations", None),
    ("GET", "/api/v1/remediations?limit=1", None),
    ("GET", "/api/v1/remediations?limit=abc", None),
    ("GET", "/api/v1/remediations/rem-00001/approve", None),
    ("POST", "/api/v1/remediations/rem-99999/approve", {}),
    ("POST", "/api/v1/remediations/rem-00001/frobnicate", {}),
    ("POST", "/api/v1/remediations/", {}),
    ("GET", "/api/v1/metrics/uav", None),
    ("GET", "/api/v1/metrics/uav/", None),
    ("GET", "/api/v1/metrics/uav/no-such-node", None),
    ("POST", "/api/v1/metrics/uav/x", {}),
    ("POST", "/api/v1/uav/report", {}),
    ("POST", "/api/v1/uav/report", b"{not json"),
    ("POST", "/api/v1/uav/report", {"node_name": "n1",
                                    "heartbeat_interval_seconds": "x"}),
    ("POST", "/api/v1/uav/command", {}),
    ("POST", "/api/v1/uav/command", {"node": NODE, "command": "loop"}),
    ("GET", "/api/v1/uav/command", None),
    ("GET", "/api/v1/crd/uav", None),
    ("GET", "/api/v1/crd/uav?namespace=all", None),
    ("POST", "/debug/profile", {"seconds": 0.01}),
    ("GET", "/debug/profile", None),
    ("POST", "/metrics", {}),
]


@pytest.mark.parametrize("method,path,body", ROUTES,
                         ids=[f"{m} {p} {i}" for i, (m, p, _) in
                              enumerate(ROUTES)])
def test_route_matches_jax_server(servers, method, path, body):
    jsrv, psrv = servers
    assert _call(psrv.port, method, path, body) == _call(jsrv.port, method,
                                                         path, body)


def test_uav_report_round_trip_matches_jax(servers):
    """A report lands in the manager's cache and the UAVMetric CRD, then
    reads back through /api/v1/metrics/uav[/<node>] and /api/v1/crd/uav,
    alike in both servers."""
    jsrv, psrv = servers
    report = {"node_name": NODE, "node_ip": "10.0.0.7", "uav_id": "uav-7",
              "status": "active", "heartbeat_interval_seconds": 5,
              "timestamp": "2026-01-02T03:04:05Z",
              "state": {"battery": {"voltage": 12.4,
                                    "remaining_percent": 80.0},
                        "gps": {"latitude": 31.2, "longitude": 121.5,
                                "satellite_count": 9},
                        "flight": {"mode": "LOITER", "armed": False}},
              "metadata": {"fw": "px4"}}
    for path, body in (("/api/v1/uav/report", report),
                       (f"/api/v1/metrics/uav/{NODE}", None),
                       ("/api/v1/metrics/uav", None),
                       ("/api/v1/crd/uav?namespace=all", None)):
        method = "POST" if body is not None else "GET"
        got = _call(psrv.port, method, path, body)
        want = _call(jsrv.port, method, path, body)
        assert got == want, path
        assert got[0] == 200, got
    assert psrv.manager.get_single_uav_metrics(NODE)["uav_id"] == "uav-7"


def test_metrics_families_match_jax(servers):
    jsrv, psrv = servers
    _, jtype, _, jtext = _call(jsrv.port, "GET", "/metrics")
    _, ptype, _, ptext = _call(psrv.port, "GET", "/metrics")
    assert ptype == jtype and ptype.startswith("text/plain")
    assert lint_exposition(ptext) == []
    got = {f: v for f, v in _families(ptext).items()
           if f not in _DEVICE_FAMILIES}
    want = {f: v for f, v in _families(jtext).items()
            if f not in _DEVICE_FAMILIES}
    assert got == want
    for fam in ("k8s_llm_monitor_telemetry_scrapes_total",
                "k8s_llm_monitor_remediation_plans_total",
                "k8s_llm_monitor_snapshot_uavs"):
        assert fam in got
    # OpenMetrics by Accept, with the EOF marker.
    req = urllib.request.Request(
        f"http://127.0.0.1:{psrv.port}/metrics",
        headers={"Accept": "application/openmetrics-text"})
    with urllib.request.urlopen(req, timeout=30) as r:
        assert r.headers["Content-Type"].startswith(
            "application/openmetrics-text")
        assert r.read().decode().endswith("# EOF\n")


def test_stats_carry_the_remediation_block(servers):
    jsrv, psrv = servers
    got = _call(psrv.port, "GET", "/api/v1/stats")[3]
    want = _call(jsrv.port, "GET", "/api/v1/stats")[3]
    assert got["remediation"] == want["remediation"]
    assert set(got) == set(want)


# ---------------------------------------------------------- kube breaker


class _BreakerBackend:
    """The demo cluster with a kube_rest-style circuit breaker attached."""

    def __init__(self, inner, breaker):
        self._inner = inner
        self.breaker = breaker

    def __getattr__(self, name):
        return getattr(self._inner, name)


def test_kube_breaker_block_and_metrics_match_jax():
    out = []
    for build, cfg_cls, fake, seed, breaker_cls in (
            (jbuild_server, JConfig, JFakeCluster, jseed_demo_cluster,
             JCircuitBreaker),
            (build_server, Config, FakeCluster, seed_demo_cluster,
             CircuitBreaker)):
        breaker = breaker_cls(failure_threshold=2, cooldown_s=60.0)
        for _ in range(2):
            breaker.record_failure()
        cfg = _default_config(cfg_cls)
        cfg.telemetry.enabled = False
        srv = build(cfg, backend=_BreakerBackend(seed(fake()), breaker))
        srv.start()
        try:
            health = _call(srv.port, "GET", "/health")[3]
            text = _call(srv.port, "GET", "/metrics")[3]
        finally:
            srv.stop()
        kube = {k: v for k, v in _samples(text).items()
                if k.startswith("k8s_llm_monitor_kube_breaker")}
        out.append((health["kube_breaker"], kube))
    assert out[0] == out[1]
    assert out[1][0]["state"] == "open" and out[1][0]["trips"] == 1


# ------------------------------------------------------- /debug/profile


def test_debug_profile_writes_a_torch_profiler_trace(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr("tempfile.tempdir", None)
    cfg = _default_config(Config)
    cfg.server.debug = True
    cfg.telemetry.enabled = False
    srv = build_server(cfg, backend=seed_demo_cluster(FakeCluster()))
    srv.start()
    try:
        status, _, _, body = _call(srv.port, "POST", "/debug/profile",
                                   {"seconds": 0.05, "dir": "run1",
                                    "decode_phases": True})
        bad = _call(srv.port, "POST", "/debug/profile",
                    {"seconds": 0.01, "dir": "../up"})
    finally:
        srv.stop()
    assert status == 200
    assert body["trace_dir"] == str(tmp_path / "k8s-llm-monitor-trace"
                                    / "run1")
    assert body["seconds"] == 0.05
    # The template backend runs no engine: reported, not fatal (as JAX).
    assert body["decode_phases_error"] == "no local engine"
    traces = list((tmp_path / "k8s-llm-monitor-trace" / "run1").iterdir())
    assert len(traces) == 1
    assert "traceEvents" in json.loads(traces[0].read_text())
    assert bad[0] == 400 and "plain subdirectory" in bad[3]


# ------------------------------------------------ a tiny engine's /metrics


CFG_KW = dict(name="t", vocab_size=300, hidden_size=32, intermediate_size=64,
              num_layers=2, num_heads=4, num_kv_heads=2, dtype="float32",
              rope_theta=1e4)
ECFG_KW = dict(max_slots=2, num_blocks=256, block_size=16,
               max_blocks_per_seq=64, prefill_buckets=(64, 1024),
               decode_steps_per_iter=8)


@pytest.fixture(scope="module")
def tiny_engines():
    params = jllama.init_params(jax.random.PRNGKey(0), JModelConfig(**CFG_KW))
    model = params_from_jax(jax.tree.map(np.asarray, params),
                            ModelConfig(**CFG_KW), device="cpu")
    return params, model


def _engine_server(server_cls, cfg_cls, client_cls, manager_cls, scraper_cls,
                   analysis_mod, fake, backend):
    cfg = cfg_cls()
    cfg.llm.temperature = 0.0
    cfg.llm.max_tokens = 12
    client = client_cls(fake, namespaces=["default"])
    manager = manager_cls(client, cfg.metrics)
    manager.collect()
    engine = analysis_mod.AnalysisEngine(backend, client=client,
                                         manager=manager, llm_cfg=cfg.llm)
    srv = server_cls(config=cfg, client=client, manager=manager,
                     analysis=engine, port=0,
                     signals=scraper_cls(cfg=cfg.telemetry))
    srv.signals.attach(srv)
    srv.start()
    srv.signals.stop()
    return srv


def test_tiny_engine_metrics_match_jax(tiny_engines, monkeypatch):
    """One set of float32 weights behind both servers, three queries: the
    same families, types and label sets, and the counters that do not
    depend on wall time equal (TTFT observations, decode-step observations
    per class, prefill rounds per bucket, the classes with an admission
    wait EMA); the exporter's decode host gap is measured; the signal
    scraper sees the local engine."""
    monkeypatch.setattr(
        jengine.InferenceEngine, "_call_ready",
        staticmethod(lambda call: not isinstance(call.arr,
                                                 jengine._StuckPayload)))
    params, model = tiny_engines
    jeng = jengine.InferenceEngine(
        JModelConfig(**CFG_KW), params, jengine.EngineConfig(**ECFG_KW),
        tokenizer=JByteTokenizer())
    peng = InferenceEngine(ModelConfig(**CFG_KW), model,
                           EngineConfig(**ECFG_KW), tokenizer=ByteTokenizer(),
                           device="cpu")
    jb = janalysis.LocalEngineBackend(jeng, JByteTokenizer())
    pb = analysis.LocalEngineBackend(engine=peng, tokenizer=ByteTokenizer())
    jsrv = _engine_server(JMonitorServer, JConfig, JClient, JManager,
                          JSignalScraper, janalysis,
                          jseed_demo_cluster(JFakeCluster()), jb)
    psrv = _engine_server(MonitorServer, Config, Client, Manager,
                          SignalScraper, analysis,
                          seed_demo_cluster(FakeCluster()), pb)
    try:
        for q in ("why is web-frontend slow?", "and the api-backend?",
                  "x" * 300):
            body = {"question": q}
            jq = _call(jsrv.port, "POST", "/api/v1/query", body)
            pq = _call(psrv.port, "POST", "/api/v1/query", body)
            assert pq[0] == jq[0] == 200
            assert pq[3]["result"]["answer"] == jq[3]["result"]["answer"]
        jtext = _call(jsrv.port, "GET", "/metrics")[3]
        ptext = _call(psrv.port, "GET", "/metrics")[3]
        for srv in (jsrv, psrv):
            srv.signals.scrape_once()
            srv.signals.scrape_once()
        jsig = _call(jsrv.port, "GET", "/api/v1/signals")[3]
        psig = _call(psrv.port, "GET", "/api/v1/signals")[3]
    finally:
        for srv in (jsrv, psrv):
            srv.stop()
        jb.service.stop()
        pb.service.stop()
    assert lint_exposition(ptext) == []
    got = {f: v for f, v in _families(ptext).items()
           if f not in _DEVICE_FAMILIES}
    want = {f: v for f, v in _families(jtext).items()
            if f not in _DEVICE_FAMILIES}
    assert got == want
    ps, js = _samples(ptext), _samples(jtext)
    counted = [k for k in js if k.startswith((
        "k8s_llm_monitor_engine_ttft_seconds_count",
        "k8s_llm_monitor_engine_ttft_seconds_bucket{le=\"+Inf\"}",
        "k8s_llm_monitor_decode_step_seconds_count",
        "k8s_llm_monitor_request_ttft_seconds_count",
        "k8s_llm_monitor_engine_prefill_bucket_rounds_total",
        "k8s_llm_monitor_engine_prefills_total",
        "k8s_llm_monitor_engine_decode_steps_total"))]
    assert len(counted) >= 6
    assert {k: ps[k] for k in counted} == {k: js[k] for k in counted}
    assert int(ps["k8s_llm_monitor_engine_ttft_seconds_count"]) == 3
    assert peng.ttft_count == jeng.ttft_count == 3
    assert peng.hist_decode_step.series("interactive")[2] == (
        jeng.hist_decode_step.series("interactive")[2]) > 0
    assert set(peng.slot_wait_ema_by_class) == set(
        jeng.slot_wait_ema_by_class) == {"interactive"}
    assert peng.prefill_bucket_rounds == jeng.prefill_bucket_rounds
    assert float(ps["k8s_llm_monitor_engine_decode_host_gap_ms"]) >= 0.0
    assert peng.mesh_axes() == jeng.mesh_axes() == {}
    assert peng.decode_collective_share == 0.0 and peng.tp_overlap is False
    assert set(psig["targets"]) == set(jsig["targets"]) == {"local"}
    assert psig["targets"]["local"]["stale"] is False
    assert set(psig["targets"]["local"]) == set(jsig["targets"]["local"])


def test_profile_decode_phases_like_jax(tiny_engines):
    """The decode phase split on an idle engine: the JAX engine's keys,
    finite non-negative splits; a busy engine refuses, as in JAX."""
    params, model = tiny_engines
    jeng = jengine.InferenceEngine(
        JModelConfig(**CFG_KW), params, jengine.EngineConfig(**ECFG_KW))
    peng = InferenceEngine(ModelConfig(**CFG_KW), model,
                           EngineConfig(**ECFG_KW), device="cpu")
    want = jeng.profile_decode_phases(reps=1)
    got = peng.profile_decode_phases(reps=1)
    assert set(got) == set(want)
    assert got["decode_attn_ms"] == peng.decode_attn_ms >= 0.0
    assert got["decode_sample_ms"] == peng.decode_sample_ms >= 0.0
    assert got["decode_collective_share"] == 0.0
    # The programs it ran serve requests afterwards (the same keys as a
    # dispatch), and a busy engine refuses.
    assert (8, "greedy", False, 0) in peng._programs
    r = peng.generate([[5, 6, 7]], SamplingParams(max_tokens=3))[0]
    assert r.finish_reason == "length"
    for eng, mod in ((jeng, jengine),
                     (peng, tengine)):
        eng.submit(mod.GenerationRequest(
            request_id="busy", prompt_ids=[5, 6, 7],
            sampling=mod.SamplingParams(max_tokens=50)))
        eng.step()
        with pytest.raises(RuntimeError, match="idle engine"):
            eng.profile_decode_phases()


def test_engine_steps_count_decode_steps_like_jax(tiny_engines):
    """``InferenceEngine.steps`` counts device decode steps, as the JAX
    engine's does (the exporter's engine_decode_steps_total reads it);
    step() calls are ``step_calls``."""
    params, model = tiny_engines
    jeng = jengine.InferenceEngine(
        JModelConfig(**CFG_KW), params, jengine.EngineConfig(**ECFG_KW),
        eos_id=-1)
    peng = InferenceEngine(ModelConfig(**CFG_KW), model,
                           EngineConfig(**ECFG_KW), eos_id=-1, device="cpu")
    prompts = [[5, 6, 7], [9] * 40, [3, 4]]
    want = jeng.generate(prompts, jengine.SamplingParams(max_tokens=11))
    got = peng.generate(prompts, SamplingParams(max_tokens=11))
    assert [r.token_ids for r in got] == [r.token_ids for r in want]
    assert peng.steps == jeng.steps > 10
    assert 0 < peng.step_calls < peng.steps


# ------------------------------------------------------------ remediation


def _cluster(fake_cls):
    fake = fake_cls()
    fake.add_node("node-a")
    fake.add_node("node-b")
    fake.add_pod("web-frontend-7d4b9c6f5-x2x1p", node="node-a")
    fake.add_pod("api-backend-6f5d8b7c9-k3k2m", node="node-b")
    fake.add_statefulset("engine-decode", replicas=2)
    return fake


class _StubAnalysis:
    """Just enough of AnalysisEngine for the executor machinery
    (tests/test_remediation.py's)."""

    class backend:
        name = "stub-model"
        supports_grammar = False

    def diagnose(self, question, context=None, slo_class="standard",
                 tenant=""):
        return {"severity": "warning", "component": "c", "root_cause": "r",
                "recommendation": "f", "confidence": 0.5}


class _Recording:
    """Delegating wrapper logging every mutation verb with its dry_run."""

    _VERBS = ("scale_statefulset", "rollout_restart", "cordon_node",
              "delete_pod")

    def __init__(self, inner):
        self._inner = inner
        self.calls = []

    def __getattr__(self, name):
        attr = getattr(self._inner, name)
        if name in self._VERBS and callable(attr):
            def wrapper(*args, **kwargs):
                self.calls.append((name, bool(kwargs.get("dry_run", False))))
                return attr(*args, **kwargs)
            return wrapper
        return attr


PKGS = {"jax": (JRemediationEngine, JRemediationConfig, JFakeCluster),
        "port": (RemediationEngine, RemediationConfig, FakeCluster)}
VERDICT = {"severity": "warning", "component": "c", "root_cause": "r",
           "recommendation": "f", "confidence": 0.5}


def _scenario(pkg, name, monkeypatch):
    """One of tests/test_remediation.py's executor scenarios on ``pkg``'s
    engine: (records, backend calls, counters)."""
    eng_cls, cfg_cls, fake_cls = PKGS[pkg]
    monkeypatch.delenv("K8SLLM_REMEDIATE_APPROVE", raising=False)
    fake = _cluster(fake_cls)
    backend = _Recording(fake)
    kw = dict(enabled=True, execute=name == "dry_run_first",
              dry_run_first=True, verify=False, verb_interval_s=0.0,
              target_interval_s=0.0)
    if name == "destructive":
        kw["execute"] = True
        fake.add_pod("stuck-worker-1a2b3", phase="Pending", node="")
    eng = eng_cls(backend, _StubAnalysis(), cfg_cls(**kw),
                  namespaces=("default",), pipeline=None,
                  clock=lambda: 1000.0)
    trigger = {"observe_only": "BackOff web-frontend crash",
               "dry_run_first": "BackOff web-frontend crash",
               "destructive": "FailedScheduling pod stuck-worker-1a2b3",
               "approve": "node-a memory pressure",
               "reject": "BackOff web-frontend"}[name]
    rec = eng.on_verdict(dict(VERDICT), trigger=trigger)
    if name == "approve":
        eng.approve(rec["id"])
    elif name == "reject":
        eng.reject(rec["id"])
        assert eng.execute(rec["id"]) == "refused_replay"
        assert eng.reject("rem-99999") is None
    # execute_ms is the executor's wall time.
    records = [{k: v for k, v in r.items() if k != "execute_ms"}
               for r in eng.records()]
    return records, backend.calls, eng.snapshot()


@pytest.mark.parametrize("name", ["observe_only", "dry_run_first",
                                  "destructive", "approve", "reject"])
def test_remediation_scenarios_match_jax(name, monkeypatch):
    got = _scenario("port", name, monkeypatch)
    want = _scenario("jax", name, monkeypatch)
    assert got == want
    records, calls, _ = got
    rec = records[0]
    expect = {"observe_only": ("rollout_restart", "proposed", []),
              "dry_run_first": ("rollout_restart", "executed",
                                [("rollout_restart", True),
                                 ("rollout_restart", False)]),
              "destructive": ("delete_pod", "awaiting_approval", []),
              "approve": ("cordon", "executed",
                          [("cordon_node", True), ("cordon_node", False)]),
              "reject": ("rollout_restart", "rejected", [])}[name]
    assert (rec["plan"]["verb"], rec["status"], calls) == expect


def test_warning_burst_reaches_a_plan_over_http():
    """tests/test_remediation.py's chaos scenario 1 on both servers (the
    default config: observe-only): a BackOff burst -> a diagnosis -> an
    observe-only rollout_restart plan in /api/v1/remediations."""
    bodies = []
    for build, cfg_cls, fake_cls, seed, event_cls in (
            (jbuild_server, JConfig, JFakeCluster, jseed_demo_cluster,
             JEventInfo),
            (build_server, Config, FakeCluster, seed_demo_cluster,
             EventInfo)):
        cfg = _default_config(cfg_cls)
        cfg.telemetry.enabled = False
        cfg.diagnosis.burst_threshold = 3
        cfg.diagnosis.cooldown_s = 0.0
        backend = seed(fake_cls())
        backend.update_pod("default", "web-frontend-7d4b9c6f5-x2x1p",
                           phase="CrashLoopBackOff")
        srv = build(cfg, backend=backend)
        srv.start()
        try:
            for i in range(4):
                srv.diagnosis.handler.on_event(event_cls(
                    type="Warning", reason="BackOff",
                    message=f"Back-off restarting failed container in "
                            f"web-frontend (try {i})", source="chaos"))
            deadline = time.monotonic() + 30
            while (time.monotonic() < deadline
                   and not srv.remediation.records()):
                time.sleep(0.05)
            body = _call(srv.port, "GET", "/api/v1/remediations")[3]
        finally:
            srv.stop()
        bodies.append(body)
    assert bodies[0] == bodies[1]
    rec = bodies[1]["remediations"][0]
    assert (rec["plan"]["verb"], rec["plan"]["name"], rec["status"]) == (
        "rollout_restart", "web-frontend", "proposed")


# ------------------------------------------------- the default config


def test_build_server_boots_the_default_config_on_the_cpu():
    """load_config(None) with only the port (0) and the model (the tiny
    preset, so the CPU can hold it) set: telemetry and remediation on, a
    query served through the engine, /metrics lint-clean with the TTFT
    histogram counting it, the local target in /api/v1/signals."""
    cfg = load_config(None)
    assert cfg.telemetry.enabled and cfg.remediation.enabled
    cfg.server.port = 0
    cfg.llm.tpu.model = "tiny"
    cfg.llm.max_tokens = 8
    srv = build_server(cfg, backend=seed_demo_cluster(FakeCluster()),
                       device="cpu")
    srv.start()
    try:
        srv.signals.stop()
        assert srv.remediation is not None
        status, _, _, body = _call(srv.port, "POST", "/api/v1/query",
                                   {"question": "why crashloop?"})
        assert status == 200 and body["status"] == "success"
        text = _call(srv.port, "GET", "/metrics")[3]
        srv.signals.scrape_once()
        sig = _call(srv.port, "GET", "/api/v1/signals")[3]
    finally:
        srv.engine_supervisor().shutdown(grace_s=5.0)
        srv.stop()
    assert lint_exposition(text) == []
    samples = _samples(text)
    assert samples["k8s_llm_monitor_engine_ttft_seconds_count"] == "1"
    assert samples["k8s_llm_monitor_devices"] == "0"     # no card here
    assert "local" in sig["targets"]
    assert os.environ.get("TELEMETRY_ENABLED") is None
