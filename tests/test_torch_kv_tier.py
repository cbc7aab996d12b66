"""The KV tiers of the port's engine against the JAX engine on the CPU.

Rung 2, the host spill tier: the JAX package's spill/restore scenario
(tests/test_kv_tier.py:test_spill_restore_byte_exact, a 14-block pool
cycling six 24-token prompts twice) replayed on both engines from one set
of float32 weights, on the model-dtype, int8 and unscaled fp8 pools: the
greedy ids (each round's, the restored ones included), ``spills``,
``restores``, ``host_bytes`` and ``host_entries`` equal; and the
supervisor rebuild that rehydrates spilled pages into the
rebuilt engine (after tests/test_kv_tier.py:275-341).

Rung 3, prefix migration: a KVX1 blob exported by either package's engine
installs into the other's, for the three pools: the receiver's greedy ids
equal the owner's and its prefix cache hits; a second install is
``cached``, a tampered geometry ``incompatible``, another tenant
``tenant_mismatch``, a pool too small ``nospace``, and a torn blob raises
``BlobError``.  Then ``/api/v1/kv/prefix`` and ``/api/v1/kv/install``:
status and body equal to the JAX server's.  Servers bind port 0.
"""

import json
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

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
from k8s_llm_monitor_tpu.resilience import faults as jfaults
from k8s_llm_monitor_tpu.serving import engine as jengine
from k8s_llm_monitor_tpu.serving import kv_tier as jkv_tier
from k8s_llm_monitor_tpu.utils.tokenizer import ByteTokenizer as JByteTokenizer
from k8s_llm_monitor_tpu_torch.convert import params_from_jax
from k8s_llm_monitor_tpu_torch.models.config import ModelConfig
from k8s_llm_monitor_tpu_torch.monitor import analysis
from k8s_llm_monitor_tpu_torch.monitor.client import Client
from k8s_llm_monitor_tpu_torch.monitor.cluster import (
    FakeCluster,
    seed_demo_cluster,
)
from k8s_llm_monitor_tpu_torch.monitor.config import Config
from k8s_llm_monitor_tpu_torch.monitor.manager import Manager
from k8s_llm_monitor_tpu_torch.monitor.server import (
    MonitorServer,
    build_server,
)
from k8s_llm_monitor_tpu_torch.resilience import faults as tfaults
from k8s_llm_monitor_tpu_torch.resilience.retry import Backoff
from k8s_llm_monitor_tpu_torch.resilience.tenancy import DEFAULT_TENANT as TEN
from k8s_llm_monitor_tpu_torch.serving import engine as tengine
from k8s_llm_monitor_tpu_torch.serving import kv_tier as tkv_tier
from k8s_llm_monitor_tpu_torch.serving.supervisor import EngineSupervisor
from k8s_llm_monitor_tpu_torch.utils.tokenizer import ByteTokenizer

CFG_KW = dict(name="t", vocab_size=300, hidden_size=32, intermediate_size=64,
              num_layers=2, num_heads=4, num_kv_heads=2, dtype="float32",
              rope_theta=10_000.0)
# tests/test_kv_tier.py:_engine's engine.
ECFG = dict(max_slots=4, num_blocks=64, block_size=8, max_blocks_per_seq=16,
            prefill_buckets=(16, 32))
# The pools: (ModelConfig.kv_dtype, EngineConfig.kv_dtype).
POOLS = {"model": ("", "auto"), "int8": ("", "int8"),
         "fp8": ("float8_e4m3fn", "auto")}


@pytest.fixture(scope="module")
def weights():
    params = jllama.init_params(jax.random.PRNGKey(0), JModelConfig(**CFG_KW))
    return params, params_from_jax(jax.tree.map(np.asarray, params),
                                   ModelConfig(**CFG_KW), device="cpu")


@pytest.fixture(autouse=True)
def _deterministic(monkeypatch):
    """Both fault injectors reset; the JAX engine's calls read as ready
    unless stuck (the port's CPU calls are done when they return)."""
    jfaults.get_injector().reset(seed=1234)
    tfaults.get_injector().reset(seed=1234)
    monkeypatch.setattr(
        jengine.InferenceEngine, "_call_ready",
        staticmethod(lambda call: not isinstance(call.arr,
                                                 jengine._StuckPayload)))
    yield
    jfaults.get_injector().reset()
    tfaults.get_injector().reset()


def _engines(weights, pool, **over):
    """(JAX engine, port engine) on one pool, from one set of weights."""
    mkv, ekv = POOLS[pool]
    kw = dict(ECFG, kv_dtype=ekv, **over)
    j = jengine.InferenceEngine(JModelConfig(kv_dtype=mkv, **CFG_KW),
                                weights[0], jengine.EngineConfig(**kw),
                                eos_id=-1)
    t = tengine.InferenceEngine(ModelConfig(kv_dtype=mkv, **CFG_KW),
                                weights[1], tengine.EngineConfig(**kw),
                                eos_id=-1, device="cpu")
    return j, t


def _ids(eng, sp_mod, prompt, n):
    r = eng.generate([list(prompt)], sp_mod.SamplingParams(max_tokens=n))[0]
    assert r.finish_reason == "length", r
    return r.token_ids


def _wait(predicate, timeout=30.0, interval=0.005):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return False


# ------------------------------------------------------- rung 2: host spill


@pytest.mark.parametrize("pool", list(POOLS))
def test_spill_restore_matches_jax_engine(weights, pool):
    j, t = _engines(weights, pool, max_slots=2, num_blocks=14,
                    prefill_buckets=(32,), host_spill_bytes=64 << 20)
    assert t.host_kv_tier is not None and t.host_kv_tier.max_bytes == 64 << 20
    rng = np.random.default_rng(6)
    prompts = [list(rng.integers(3, 300, size=24)) for _ in range(6)]
    first = {}
    for _ in range(2):
        for i, p in enumerate(prompts):
            want = _ids(j, jengine, p, 4)
            got = _ids(t, tengine, p, 4)
            assert got == want, (pool, i)
            # Restored pages give the first pass's ids on the model-dtype
            # pool.  On a 1-byte pool the CPU's fresh dense prefill attends
            # to the unrounded in-flight K/V and a restored hit's chunk to
            # the stored codes, in both packages alike (the card's flash
            # prefill reads the pages either way).
            if pool == "model":
                assert first.setdefault(i, got) == got, (pool, i)
    js, ts = j.kv_tier_stats(), t.kv_tier_stats()
    assert ts["spills"] > 0 and ts["restores"] > 0, ts
    for key in ("spills", "restores", "host_bytes", "host_entries",
                "host_lost", "host_tenant_bytes", "page_dtype", "kv_quant",
                "device_bytes"):
        assert ts[key] == js[key], key
    assert ts["host_bytes"] == t.host_kv_tier.bytes_used
    assert t.prefix_cache.hits == j.prefix_cache.hits


def test_admission_headroom_counts_what_a_spill_reclaims(weights):
    j, t = _engines(weights, "model", host_spill_bytes=64 << 20)
    prompt = list(np.random.default_rng(3).integers(3, 300, size=40))
    _ids(j, jengine, prompt, 2)
    _ids(t, tengine, prompt, 2)
    assert t.admission_headroom_tokens() == j.admission_headroom_tokens()
    assert (t.admission_headroom_tokens()
            > t.allocator.free_blocks * t.ecfg.block_size)
    # "tier" arms the capacity clause once a host tier exists.
    need = t.admission_headroom_tokens() + 1
    assert t.should_shed(need_tokens=need) == j.should_shed(need_tokens=need)
    assert "kv capacity" in t.should_shed(need_tokens=need)


def test_supervisor_rebuild_rehydrates_spilled_pages(weights):
    """A factory that closes over one HostKVTier: pages spilled before a
    crash rehydrate into the rebuilt engine's fresh pool (the restore
    counter moves, the ids stay); once the tier is cleared, the prompt
    still completes with the same ids by a plain prefill."""
    tier = tkv_tier.HostKVTier(max_bytes=64 << 20)
    ecfg = dict(max_slots=4, num_blocks=64, block_size=8,
                max_blocks_per_seq=16, prefill_buckets=(16, 32),
                max_prefills_per_step=4)

    def factory():
        return tengine.InferenceEngine(
            ModelConfig(**CFG_KW), weights[1], tengine.EngineConfig(**ecfg),
            eos_id=-1, device="cpu", host_kv_tier=tier)

    sup = EngineSupervisor(factory, max_restarts=4,
                           backoff=Backoff(base_s=0.01, cap_s=0.05,
                                           jitter=0.0),
                           poll_interval_s=0.02)
    rng = np.random.default_rng(8)
    prompt = [int(x) for x in rng.integers(3, 300, size=24)]
    want = jengine.InferenceEngine(
        JModelConfig(**CFG_KW), weights[0], jengine.EngineConfig(**ecfg),
        eos_id=-1).generate([list(prompt)],
                            jengine.SamplingParams(max_tokens=6))[0]
    try:
        sp = tengine.SamplingParams(max_tokens=6)
        r1 = sup.submit(list(prompt), sp).result(timeout=60)
        assert r1.token_ids == want.token_ids

        def spill_all(e):
            n = 0
            while e._evict_prefix_lru():
                n += 1
            return n
        assert sup.call(spill_all, timeout=30.0) > 0
        assert len(tier) > 0 and tier.spills > 0

        tfaults.get_injector().arm("step_loop_crash", rate=1.0, times=1)
        other = [int(x) for x in rng.integers(3, 300, size=12)]
        sup.submit(other, tengine.SamplingParams(max_tokens=3)).result(
            timeout=60)
        assert _wait(lambda: sup.restarts == 1)
        assert _wait(lambda: sup.state == "serving")
        restores0 = tier.restores
        r2 = sup.submit(list(prompt), sp).result(timeout=60)
        assert r2.token_ids == r1.token_ids
        assert tier.restores > restores0

        tier.clear()
        tfaults.get_injector().arm("step_loop_crash", rate=1.0, times=1)
        sup.submit(other, tengine.SamplingParams(max_tokens=3)).result(
            timeout=60)
        assert _wait(lambda: sup.restarts == 2)
        assert _wait(lambda: sup.state == "serving")
        r3 = sup.submit(list(prompt), sp).result(timeout=60)
        assert r3.token_ids == r1.token_ids
    finally:
        sup.shutdown(grace_s=1.0)


# ------------------------------------------------ rung 3: prefix migration

PKG = {"jax": (jengine, jkv_tier), "port": (tengine, tkv_tier)}


@pytest.mark.parametrize("pool", list(POOLS))
@pytest.mark.parametrize("owner,receiver", [("jax", "port"),
                                            ("port", "jax")])
def test_export_install_across_packages(weights, pool, owner, receiver):
    engines = dict(zip(("jax", "port"), _engines(weights, pool)))
    cold = dict(zip(("jax", "port"), _engines(weights, pool)))
    src, dst = engines[owner], cold[receiver]
    src_mod, _ = PKG[owner]
    dst_mod, dst_tier = PKG[receiver]
    prompt = [int(x) for x in np.random.default_rng(9).integers(3, 300,
                                                                size=24)]
    want = _ids(src, src_mod, prompt, 5)
    assert dst.export_prefix(list(prompt), tenant=TEN) is None   # cold
    blob = src.export_prefix(list(prompt), tenant=TEN)
    assert blob is not None and blob[:4] == b"KVX1"
    assert dst.install_prefix(blob, expected_tenant="acme") == (
        "tenant_mismatch")
    assert dst.install_prefix(blob, expected_tenant=TEN) == "installed"
    assert dst.install_prefix(blob, expected_tenant=TEN) == "cached"
    hits0 = dst.prefix_cache.hits
    assert _ids(dst, dst_mod, prompt, 5) == want
    assert dst.prefix_cache.hits == hits0 + 1
    # The receiver's export of the same prefix is the owner's blob bit for
    # bit: the same pages, framed alike.
    assert dst.export_prefix(list(prompt), tenant=TEN) == blob

    meta, raw = dst_tier.unpack_prefix_blob(blob)
    meta.pop("version")
    tampered = dst_tier.pack_prefix_blob(
        dict(meta, block_size=4), [np.frombuffer(b, np.uint8) for b in raw])
    assert dst.install_prefix(tampered, expected_tenant=TEN) == (
        "incompatible")
    with pytest.raises(dst_tier.BlobError):
        dst.install_prefix(blob[:-7], expected_tenant=TEN)


@pytest.mark.parametrize("pool", list(POOLS))
def test_install_without_room_is_nospace(weights, pool):
    """A 41-token prompt's cached prefix (5 blocks of 8) into pools of 4
    blocks (3 usable): both packages refuse it as ``nospace``."""
    j, t = _engines(weights, pool)
    prompt = [int(x) for x in np.random.default_rng(4).integers(3, 300,
                                                                size=41)]
    _ids(t, tengine, prompt, 2)
    blob = t.export_prefix(list(prompt), tenant=TEN)
    assert json.loads(tkv_tier.unpack_records(blob)[0][1])["n_blocks"] == 5
    small = _engines(weights, pool, num_blocks=4)
    assert [e.install_prefix(blob, expected_tenant=TEN)
            for e in small] == ["nospace"] * 2


# ------------------------------------------------------------ the routes


def _call(port, method, path, body=None, headers=None):
    """(status, content type, body): JSON decoded with its timestamp out,
    anything else as bytes."""
    data = body if isinstance(body, bytes) else (
        json.dumps(body).encode() if body is not None else None)
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data, method=method,
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            status, ctype, raw = r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as err:
        status, ctype, raw = err.code, err.headers["Content-Type"], err.read()
    if ctype.startswith("application/json"):
        body = json.loads(raw)
        body.pop("timestamp", None)
        return status, ctype, body
    return status, ctype, raw


def _server(server_cls, cfg_cls, client_cls, manager_cls, analysis_mod,
            fake, backend):
    cfg = cfg_cls()
    client = client_cls(fake, namespaces=["default"])
    manager = manager_cls(client, cfg.metrics)
    engine = analysis_mod.AnalysisEngine(backend, client=client,
                                         manager=manager, llm_cfg=cfg.llm)
    srv = server_cls(config=cfg, client=client, manager=manager,
                     analysis=engine, port=0)
    srv.start()
    return srv


@pytest.mark.parametrize("pool", ["model", "fp8"])
def test_kv_routes_match_jax_server(weights, pool):
    j, t = _engines(weights, pool)
    jb = janalysis.LocalEngineBackend(j, JByteTokenizer())
    pb = analysis.LocalEngineBackend(engine=t, tokenizer=ByteTokenizer())
    jsrv = _server(JMonitorServer, JConfig, JClient, JManager, janalysis,
                   jseed_demo_cluster(JFakeCluster()), jb)
    psrv = _server(MonitorServer, Config, Client, Manager, analysis,
                   seed_demo_cluster(FakeCluster()), pb)
    prompt = [int(x) for x in np.random.default_rng(5).integers(3, 256,
                                                                size=30)]
    try:
        requests = [
            ("/api/v1/kv/prefix", b"{bad", None),
            ("/api/v1/kv/prefix", {"token_ids": []}, None),
            ("/api/v1/kv/prefix", {"token_ids": [1, "x"]}, None),
            ("/api/v1/kv/prefix", {"token_ids": [1, 2],
                                   "tenant": "Bad Tenant!"}, None),
            ("/api/v1/kv/prefix", {"token_ids": prompt}, None),     # miss
            ("/api/v1/kv/install", b"", None),
            ("/api/v1/kv/install", b"junk", None),
            ("/api/v1/kv/install", b"junk", {"X-Tenant-Id": "Bad Tenant!"}),
        ]
        for path, body, headers in requests:
            assert (_call(psrv.port, "POST", path, body, headers)
                    == _call(jsrv.port, "POST", path, body, headers)), path
        # Warm both engines on the prompt (on their step threads), then
        # fetch each one's blob and install it into the other server.
        for backend, mod in ((jb, jengine), (pb, tengine)):
            backend.service.submit(list(prompt), mod.SamplingParams(
                max_tokens=2)).result(timeout=60)
        blobs = {}
        for name, srv in (("jax", jsrv), ("port", psrv)):
            status, ctype, blob = _call(srv.port, "POST", "/api/v1/kv/prefix",
                                        {"token_ids": prompt})
            assert (status, ctype) == (200, "application/octet-stream")
            blobs[name] = blob
        for srv, blob in ((psrv, blobs["jax"]), (jsrv, blobs["port"])):
            assert _call(srv.port, "POST", "/api/v1/kv/install", blob) == (
                200, "application/json",
                {"status": "success", "outcome": "cached"})
            assert _call(srv.port, "POST", "/api/v1/kv/install", blob,
                         {"X-Tenant-Id": "acme"})[2]["outcome"] == (
                "tenant_mismatch")
    finally:
        for srv in (jsrv, psrv):
            srv.stop()
        jb.service.stop()
        pb.service.stop()


def _template_config(cls):
    cfg = cls()
    cfg.server.port = 0
    cfg.llm.provider = "template"
    cfg.telemetry.enabled = False
    cfg.remediation.enabled = False
    return cfg


def test_kv_routes_without_an_engine_match_jax_server():
    jsrv = jbuild_server(_template_config(JConfig),
                         backend=jseed_demo_cluster(JFakeCluster()))
    psrv = build_server(_template_config(Config),
                        backend=seed_demo_cluster(FakeCluster()))
    for srv in (jsrv, psrv):
        srv.start()
    try:
        for path, body in (("/api/v1/kv/prefix", {"token_ids": [1, 2]}),
                           ("/api/v1/kv/install", b"KVX1")):
            got = _call(psrv.port, "POST", path, body)
            assert got == _call(jsrv.port, "POST", path, body)
            assert got[0] == 503
    finally:
        for srv in (jsrv, psrv):
            srv.stop()
