"""The port's HTTP server, Analysis Engine and ``cmd/server`` against the
JAX package's.

Both servers are built by their package's ``build_server`` over the demo
``FakeCluster`` with the template backend: every ported route gives the
same status and the same body, timestamps and minted ids aside.  With a
tiny float32 engine on each side, from one set of weights and at
temperature 0, ``/api/v1/query`` and a root-cause ``/api/v1/analyze`` give
the same answer text and verdict (after the two evidence prompts are shown
equal).  ``build_server`` and ``LocalEngineBackend.from_config`` refuse
every knob the port does not serve and serve telemetry and remediation,
``from_config(device="cpu")`` builds a supervised backend, the ``tpu``
provider does not fall back to the template backend, and ``python -m
k8s_llm_monitor_tpu_torch.cmd.server`` boots on the default config (and
with ``--cluster kube`` and no cluster, in dev mode), answers ``/readyz``
and exits 0 on SIGTERM.  Servers bind port 0.
"""

import json
import os
import re
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

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
from k8s_llm_monitor_tpu.monitor.manager import Manager as JManager
from k8s_llm_monitor_tpu.monitor.server import MonitorServer as JMonitorServer
from k8s_llm_monitor_tpu.monitor.server import build_server as jbuild_server
from k8s_llm_monitor_tpu.serving import engine as jengine
from k8s_llm_monitor_tpu.utils.tokenizer import ByteTokenizer as JByteTokenizer
from k8s_llm_monitor_tpu_torch.cmd import server as cmd_server
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
    TenancyConfig,
    TPULLMConfig,
)
from k8s_llm_monitor_tpu_torch.monitor.manager import Manager
from k8s_llm_monitor_tpu_torch.monitor.server import (
    MonitorServer,
    build_server,
)
from k8s_llm_monitor_tpu_torch.serving.engine import (
    EngineConfig,
    InferenceEngine,
)
from k8s_llm_monitor_tpu_torch.utils.tokenizer import ByteTokenizer

ROOT = Path(__file__).resolve().parent.parent
NODE = "k3d-demo-agent-0"
POD_A = "default/web-frontend-7d4b9c6f5-x2x1p"
POD_B = "default/api-backend-6f5d8b7c9-k3k2m"
TRACEPARENT = "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01"

# (method, path, body): every ported route, with its error paths.  A body
# of bytes is sent as is (invalid JSON).
ROUTES = [
    ("GET", "/health", None),
    ("GET", "/readyz", None),
    ("GET", "/api/v1/stats", None),
    ("GET", "/api/v1/cluster/status", None),
    ("GET", "/api/v1/pods", None),
    ("GET", "/api/v1/diagnoses", None),
    ("GET", "/api/v1/diagnoses?limit=1", None),
    ("GET", "/api/v1/diagnoses?limit=abc", None),
    ("GET", "/api/v1/trace?limit=abc", None),
    ("GET", "/api/v1/trace/", None),
    ("GET", "/api/v1/trace/no-such-request", None),
    ("GET", "/api/v1/metrics/cluster", None),
    ("GET", "/api/v1/metrics/nodes", None),
    ("GET", f"/api/v1/metrics/nodes/{NODE}", None),
    ("GET", "/api/v1/metrics/nodes/no-such-node", None),
    ("GET", "/api/v1/metrics/pods", None),
    ("GET", "/api/v1/metrics/snapshot", None),
    ("GET", "/api/v1/metrics/network", None),
    ("POST", "/api/v1/metrics/nodes/x", {}),
    ("GET", "/", None),
    ("GET", "/metrics.html", None),
    ("GET", "/no-such-file.txt", None),
    ("GET", "/../README.md", None),
    ("POST", "/health", {}),
    ("GET", "/api/v1/query", None),
    ("POST", "/api/v1/no-such-route", {}),
    ("POST", "/api/v1/query", {"question": "why is web-frontend slow?"}),
    ("POST", "/api/v1/query", {"question": "and the fix?", "session_id": ""}),
    ("POST", "/api/v1/query", {"question": "  "}),
    ("POST", "/api/v1/query", {"question": "x", "slo_class": "bogus"}),
    ("POST", "/api/v1/query", b"{not json"),
    ("POST", "/api/v1/query", {"question": "x", "tenant": "Bad Tenant!"}),
    ("POST", "/api/v1/analyze", {"type": "root_cause", "parameters": {
        "namespace": "default", "pod": "web-frontend-7d4b9c6f5-x2x1p",
        "symptom": "restarts"}}),
    ("POST", "/api/v1/analyze", {"type": "root_cause"}),
    ("POST", "/api/v1/analyze", {"type": "anomaly_detection"}),
    ("POST", "/api/v1/analyze", {"type": "pod_communication",
                                 "parameters": {"pod_a": POD_A,
                                                "pod_b": POD_B}}),
    ("POST", "/api/v1/analyze", {"type": "pod_communication"}),
    ("POST", "/api/v1/analyze", {"type": "bogus"}),
    ("POST", "/api/v1/analyze/pod-communication", {"pod_a": POD_A,
                                                   "pod_b": POD_B}),
    ("POST", "/api/v1/analyze/pod-communication", {"pod_a": POD_A}),
    ("POST", "/api/v1/analyze/pod-communication",
     {"pod_a": POD_A, "pod_b": "default/no-such-pod"}),
]
_TS = re.compile(r"^\d{4}-\d\d-\d\dT\d\d:\d\d:\d\d(\.\d+)?(Z|[+-]\d\d:\d\d)?$")
_MINTED = {"request_id", "session_id"}


def _config(cls):
    cfg = cls()
    cfg.server.port = 0
    cfg.llm.provider = "template"
    cfg.telemetry.enabled = False
    cfg.remediation.enabled = False
    return cfg


def _normalize(obj):
    """Timestamps and minted ids out of a JSON body."""
    if isinstance(obj, dict):
        return {k: ("<id>" if k in _MINTED and obj[k] else _normalize(v))
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [_normalize(v) for v in obj]
    if isinstance(obj, str) and _TS.match(obj):
        return "<ts>"
    return obj


def _call(port, method, path, body=None, headers=None):
    """(status, content type, CORS header, body): JSON decoded, with
    timestamps and minted ids normalized; text and files as is."""
    data = body if isinstance(body, bytes) else (
        json.dumps(body).encode() if body is not None else None)
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data, method=method,
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            status, ctype, raw = r.status, r.headers["Content-Type"], r.read()
            cors = r.headers.get("Access-Control-Allow-Origin")
    except urllib.error.HTTPError as err:
        status, ctype, raw = err.code, err.headers["Content-Type"], err.read()
        cors = err.headers.get("Access-Control-Allow-Origin")
    if ctype.startswith("application/json"):
        return status, ctype, cors, _normalize(json.loads(raw))
    return status, ctype, cors, raw


@pytest.fixture(scope="module")
def servers():
    jsrv = jbuild_server(_config(JConfig),
                         backend=jseed_demo_cluster(JFakeCluster()))
    psrv = build_server(_config(Config),
                        backend=seed_demo_cluster(FakeCluster()))
    for srv in (jsrv, psrv):
        srv.manager.collect()
        srv.start()
    yield jsrv, psrv
    for srv in (jsrv, psrv):
        srv.stop()


@pytest.mark.parametrize("method,path,body", ROUTES,
                         ids=[f"{m} {p} {i}" for i, (m, p, _)
                              in enumerate(ROUTES)])
def test_route_matches_jax_server(servers, method, path, body):
    jsrv, psrv = servers
    want = _call(jsrv.port, method, path, body)
    got = _call(psrv.port, method, path, body)
    assert got == want


def test_recent_traces_and_a_traced_request_match_jax(servers):
    """A request carrying a W3C traceparent joins its trace on both
    servers; /api/v1/trace/<trace id> returns the same spans (ids and
    times aside), /api/v1/trace the same envelope."""
    jsrv, psrv = servers
    trace_id = TRACEPARENT.split("-")[1]
    bodies = []
    for srv in (jsrv, psrv):
        status, *_ = _call(srv.port, "GET", "/api/v1/cluster/status",
                           headers={"traceparent": TRACEPARENT})
        assert status == 200
        status, _, _, body = _call(srv.port, "GET",
                                   f"/api/v1/trace/{trace_id}")
        assert status == 200
        body["spans"] = [(s["name"], s["attrs"], s["status"])
                         for s in body["spans"]]
        bodies.append(body)
        status, _, _, recent = _call(srv.port, "GET", "/api/v1/trace")
        assert status == 200 and recent["status"] == "success"
        assert set(recent) == {"status", "traces", "sample_rate",
                               "spans_recorded", "timestamp"}
    assert bodies[0] == bodies[1]
    assert bodies[0]["spans"][0][0] == "http.server"


def test_a_burst_of_connections_is_served(servers):
    """64 queries connecting at once all get their answer: the listen
    backlog holds the burst (with the stdlib's backlog of 5 the kernel
    resets some of the connections)."""
    import threading

    _, psrv = servers
    go = threading.Barrier(64)
    statuses, errors = [], []

    def client():
        go.wait(timeout=30)
        try:
            statuses.append(_call(psrv.port, "POST", "/api/v1/query",
                                  {"question": "why?"})[0])
        except OSError as exc:
            errors.append(repr(exc))

    threads = [threading.Thread(target=client) for _ in range(64)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors and statuses == [200] * 64


def test_unported_routes_are_not_registered(servers):
    """No route is left unported: the port's route table is the JAX
    server's (ROADMAP A13 brought /metrics, /debug/profile, the signals,
    timeseries, remediation and UAV routes), and each answers with its
    handler, not the 404 of an unregistered path
    (tests/test_torch_telemetry.py holds their bodies to JAX's)."""
    from k8s_llm_monitor_tpu.monitor import server as jserver
    from k8s_llm_monitor_tpu_torch.monitor import server as pserver

    assert pserver._ROUTES == jserver._ROUTES
    _, psrv = servers
    for method, path in (("GET", "/metrics"), ("POST", "/debug/profile"),
                         ("GET", "/api/v1/signals"),
                         ("GET", "/api/v1/timeseries"),
                         ("GET", "/api/v1/remediations"),
                         ("GET", "/api/v1/metrics/uav"),
                         ("POST", "/api/v1/uav/report"),
                         ("GET", "/api/v1/crd/uav")):
        status, *_ = _call(psrv.port, method, path,
                           {} if method == "POST" else None)
        assert status != 404, (method, path)


CFG_KW = dict(name="t", vocab_size=300, hidden_size=32, intermediate_size=64,
              num_layers=2, num_heads=4, num_kv_heads=2, dtype="float32",
              rope_theta=1e4)
ECFG_KW = dict(max_slots=2, num_blocks=256, block_size=16,
               max_blocks_per_seq=64, prefill_buckets=(64, 1024),
               decode_steps_per_iter=8)


def _engine_server(server_cls, cfg_cls, client_cls, manager_cls,
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
                     analysis=engine, port=0)
    srv.start()
    return srv


@pytest.mark.parametrize("prefix_cache", [False, True])
def test_tiny_engine_answers_like_jax(prefix_cache):
    """One set of float32 weights behind both servers: the evidence prompts
    are equal, then /api/v1/query's answer and a root-cause analysis (its
    free text and its constrained verdict) are the same at temperature 0,
    and /health and /api/v1/stats carry the JAX server's engine keys; with
    the prefix cache at its default on both sides, the stats' prefix-cache
    counters and per-tenant cached blocks are the JAX engine's too."""
    params = jllama.init_params(jax.random.PRNGKey(0), JModelConfig(**CFG_KW))
    model = params_from_jax(jax.tree.map(np.asarray, params),
                            ModelConfig(**CFG_KW), device="cpu")
    kw = dict(ECFG_KW) if prefix_cache else dict(ECFG_KW,
                                                 prefix_cache_entries=0)
    jeng = jengine.InferenceEngine(
        JModelConfig(**CFG_KW), params, jengine.EngineConfig(**kw),
        tokenizer=JByteTokenizer())
    peng = InferenceEngine(ModelConfig(**CFG_KW), model, EngineConfig(**kw),
                           tokenizer=ByteTokenizer(), device="cpu")
    jb = janalysis.LocalEngineBackend(jeng, JByteTokenizer())
    pb = analysis.LocalEngineBackend(engine=peng, tokenizer=ByteTokenizer())
    jsrv = _engine_server(JMonitorServer, JConfig, JClient, JManager,
                          janalysis, jseed_demo_cluster(JFakeCluster()), jb)
    psrv = _engine_server(MonitorServer, Config, Client, Manager, analysis,
                          seed_demo_cluster(FakeCluster()), pb)
    try:
        jev, pev = jsrv.analysis.evidence, psrv.analysis.evidence
        assert jev.format_prompt(jev.collect()) == \
            pev.format_prompt(pev.collect())
        q = {"question": "why is web-frontend slow?"}
        rc = {"type": "root_cause", "parameters": {"symptom": "restarts"}}
        jq = _call(jsrv.port, "POST", "/api/v1/query", q)[3]["result"]
        pq = _call(psrv.port, "POST", "/api/v1/query", q)[3]["result"]
        assert jq["answer"] and pq["answer"] == jq["answer"]
        assert (jq["model"], pq["model"]) == ("tpu-local", "gpu-local")
        jr = _call(jsrv.port, "POST", "/api/v1/analyze", rc)[3]["result"]
        pr = _call(psrv.port, "POST", "/api/v1/analyze", rc)[3]["result"]
        assert pr["root_cause_analysis"] == jr["root_cause_analysis"]
        assert pr["verdict"] == jr["verdict"]
        for path in ("/health", "/api/v1/stats"):
            jbody = _call(jsrv.port, "GET", path)[3]
            pbody = _call(psrv.port, "GET", path)[3]
            assert set(pbody["engine"]) == set(jbody["engine"])
        stats = _call(psrv.port, "GET", "/api/v1/stats")[3]["engine"]
        jstats = _call(jsrv.port, "GET", "/api/v1/stats")[3]["engine"]
        assert stats["preemptions_by_class"] == {}
        assert set(stats["ttft_ema_by_class"]) == {"interactive", "standard"}
        tier = {"kv_quant": "", "page_dtype": "float32",
                "device_bytes": peng.pool_bytes, "host_bytes": 0,
                "host_entries": 0, "spills": 0, "restores": 0,
                "host_lost": 0}
        if not prefix_cache:
            assert stats["prefix_cache"] is None
            assert stats["kv_tier"] == tier
        else:
            # Both servers answered the same questions over the same
            # evidence: the second query and the analysis reuse the
            # preamble's pages.
            assert stats["prefix_cache"]["hits"] > 0
            assert stats["kv_tier"]["tenant_blocks"]["public"] > 0
            assert stats["kv_tier"] == dict(
                tier, tenant_blocks=stats["kv_tier"]["tenant_blocks"])
        for key in ("prefix_cache", "prefix_deferrals",
                    "preemptions_by_class", "busy_slots", "queue_depth"):
            assert stats[key] == jstats[key], key
        assert (stats["kv_tier"].get("tenant_blocks")
                == jstats["kv_tier"].get("tenant_blocks"))
    finally:
        for srv in (jsrv, psrv):
            srv.stop()
        jb.service.stop()
        pb.service.stop()


@pytest.mark.parametrize("knob", ["embedding_model", "router"])
def test_build_server_refuses_unported_knobs(knob):
    cfg = _config(Config)
    if knob == "embedding_model":
        cfg.analysis.embedding_model = "tiny-encoder"
    else:
        cfg.fleet.role = "router"
    with pytest.raises(NotImplementedError, match="ROADMAP A"):
        build_server(cfg, backend=seed_demo_cluster(FakeCluster()))


@pytest.mark.parametrize("knob", ["telemetry", "remediation"])
def test_build_server_serves_default_on_knobs(knob):
    """The two knobs the default config turns on (ROADMAP A13): the signal
    scraper and the remediation engine are wired as in the JAX server,
    and the routes they back answer."""
    cfg = _config(Config)
    setattr(getattr(cfg, knob), "enabled", True)
    srv = build_server(cfg, backend=seed_demo_cluster(FakeCluster()))
    srv.start()
    try:
        if knob == "telemetry":
            assert srv.signals is not None and srv.remediation is None
            srv.signals.stop()
            srv.signals.scrape_once()
            status, _, _, body = _call(srv.port, "GET", "/api/v1/signals")
            assert status == 200 and body["scraper"]["scrapes"] == 1
        else:
            assert srv.remediation is not None and srv.signals is None
            assert srv.diagnosis.remediation is srv.remediation
            status, _, _, body = _call(srv.port, "GET",
                                       "/api/v1/remediations")
            assert status == 200 and body["remediations"] == []
            assert _call(srv.port, "GET", "/api/v1/stats")[3][
                "remediation"]["enabled"]
    finally:
        srv.stop()


def test_remediation_without_a_cluster_boots():
    """Remediation needs a cluster backend in the JAX server too: without
    one it is not wired there, so the port boots."""
    cfg = _config(Config)
    cfg.remediation.enabled = True
    srv = build_server(cfg, backend=None)
    assert srv.client is None and srv.diagnosis is not None


@pytest.mark.parametrize("knob,value", [
    ("quantize", "w8a8"), ("quantize", "int8"),
    ("checkpoint", "/models/llama"), ("mesh_shape", "1,1,8")])
def test_from_config_refuses_unported_knobs(knob, value):
    """``mesh_shape`` is served since A7 (tests/test_torch_tp.py): on the
    CPU only over gloo, which the caller must ask for (``mesh_backend``),
    so the default NCCL refuses the CPU, whatever the mesh's data and seq
    axes (served since A7b, tests/test_torch_seq.py).  The weight knobs
    are served since A6: ``quantize`` int8 / w8a8 give an int8 model (W8A8
    with int8 activations), and a checkpoint directory that does not exist
    raises, with no random weights in its place."""
    tc = TPULLMConfig(model="tiny", quantize="", spec_k=0, kv_blocks=64,
                      max_batch=2)
    setattr(tc, knob, value)
    if knob == "mesh_shape":
        with pytest.raises(ValueError, match="gloo"):
            analysis.LocalEngineBackend.from_config(
                tc, tenancy=TenancyConfig(), device="cpu")
        tc.mesh_shape = "2,1,4"
        with pytest.raises(ValueError, match="gloo"):
            analysis.LocalEngineBackend.from_config(
                tc, tenancy=TenancyConfig(), device="cpu")
    elif knob == "checkpoint":
        with pytest.raises(FileNotFoundError, match="config.json"):
            analysis.LocalEngineBackend.from_config(
                tc, tenancy=TenancyConfig(), device="cpu")
    else:
        backend = analysis.LocalEngineBackend.from_config(
            tc, tenancy=TenancyConfig(), device="cpu")
        try:
            model = backend.engine.model
            assert model.quantized and backend.name.endswith("-RANDOM-WEIGHTS")
            assert model.cfg.act_quant == (value == "w8a8")
            assert backend.engine.cfg is model.cfg
        finally:
            backend.supervisor.shutdown(grace_s=1.0)


def test_from_config_passes_the_tenant_kv_share(tmp_path):
    """``tenancy.max_kv_share`` reaches the engine's prefix cache as in
    the JAX backend (``kv_max_tenant_share``), and so does its default."""
    from k8s_llm_monitor_tpu_torch.monitor.config import LifecycleConfig

    tc = TPULLMConfig(model="tiny", quantize="", spec_k=0, kv_blocks=64,
                      max_batch=2)
    for share, want in ((0.5, 0.5), (None, 1.0)):
        tenancy = TenancyConfig()
        if share is not None:
            tenancy.max_kv_share = share
        backend = analysis.LocalEngineBackend.from_config(
            tc, lifecycle=LifecycleConfig(journal_dir=str(tmp_path / str(share))),
            tenancy=tenancy, device="cpu")
        try:
            eng = backend.engine
            assert eng.ecfg.kv_max_tenant_share == want
            assert eng.prefix_cache.max_tenant_share == want
        finally:
            backend.supervisor.shutdown(grace_s=1.0)


def test_from_config_builds_a_supervised_backend_on_the_cpu(tmp_path):
    from k8s_llm_monitor_tpu_torch.monitor.config import LifecycleConfig

    tc = TPULLMConfig(model="tiny", quantize="", spec_k=0, kv_blocks=64,
                      max_batch=4)
    backend = analysis.LocalEngineBackend.from_config(
        tc, lifecycle=LifecycleConfig(journal_dir=str(tmp_path)),
        tenancy=TenancyConfig(), device="cpu")
    try:
        assert backend.supervisor is not None
        assert backend.name == "gpu-local-DEV-RANDOM-WEIGHTS"
        assert backend.engine.device.type == "cpu"
        assert backend.engine.ecfg.num_blocks == 64
        assert backend.governor is not None
        assert not backend.supports_grammar   # tiny's vocab is 256 < 259
        text = backend.generate("why crashloop? \u00ff", max_tokens=4,
                                temperature=0.0)
        assert isinstance(text, str)
        assert backend.supervisor.journal_bytes > 0
    finally:
        backend.supervisor.shutdown(grace_s=1.0)


def test_tpu_provider_does_not_fall_back_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _config(Config)
    cfg.llm.provider = "tpu"
    cfg.llm.tpu = TPULLMConfig(model="tiny", quantize="", spec_k=0)
    for device in (None, "cuda"):   # cmd.server passes --device cuda
        with pytest.raises(RuntimeError, match="device='cpu'"):
            analysis.build_backend(cfg.llm, device=device)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_server(cfg)


@pytest.mark.parametrize("argv,item", [(["--role", "router"], "A8")])
def test_cmd_server_refuses_unported_modes(argv, item):
    with pytest.raises(NotImplementedError, match=item):
        cmd_server.main(argv)


def _serve_and_stop(tmp_path, argv, env_extra=None):
    """Run ``cmd.server`` with ``argv`` in a subprocess: wait for /readyz,
    ask a query, SIGTERM; returns (readyz body, query body, exit code,
    output)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, K8SLLM_FLIGHT_DIR=str(tmp_path),
               PYTHONPATH=str(ROOT), **(env_extra or {}))
    env.pop("TELEMETRY_ENABLED", None)
    env.pop("REMEDIATION_ENABLED", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "k8s_llm_monitor_tpu_torch.cmd.server",
         "--device", "cpu", "--llm", "template", "--host", "127.0.0.1",
         "--port", str(port), *argv],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + 60
        ready = None
        while time.monotonic() < deadline and proc.poll() is None:
            try:
                ready = _call(port, "GET", "/readyz")
                break
            except OSError:
                time.sleep(0.1)
        assert ready is not None and ready[0] == 200, ready
        query = _call(port, "POST", "/api/v1/query",
                      {"question": "why crashloop?"})
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
        out = proc.communicate()[0].decode()
    return ready[3], query, rc, out


def test_cmd_server_kube_without_a_cluster_boots_in_dev_mode(tmp_path):
    """``--cluster kube`` with no reachable cluster warns and boots in dev
    mode, as the JAX command does (no kubeconfig at the given path, no
    service account: no connection is attempted)."""
    ready, query, rc, out = _serve_and_stop(
        tmp_path, ["--cluster", "kube",
                   "--kubeconfig", str(tmp_path / "no-such-kubeconfig")])
    assert ready["ready"] and rc == 0
    assert "development mode" in out and "no kubeconfig at" in out
    assert query[0] == 200 and query[3]["result"]["model"] == "template"


def test_cmd_server_boots_and_exits_zero_on_sigterm(tmp_path):
    """The default config (telemetry and remediation on, no switch in the
    environment) over the demo cluster."""
    ready, query, rc, out = _serve_and_stop(tmp_path, ["--cluster", "fake"])
    assert ready["ready"] and rc == 0
    assert query[0] == 200 and query[3]["result"]["model"] == "template"
    assert "graceful shutdown" in out and "signal scraper stopped" in out
