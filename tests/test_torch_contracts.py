"""The port's contract-drift checkers (graftcheck --contracts) against the
JAX package's.

* The extractors, run on the JAX package's ``server.py``, ``agent.py``,
  ``exporter.py`` and ``config.py`` (and its env reads), give the JAX
  extractors' routes, families and keys.
* The checkers give the JAX checkers' findings on tests/test_contracts.py's
  fixtures (the bench-key part is the JAX package's alone: the port has no
  bench yet).
* The live port: clean, with zero contract suppressions, and the table of
  what it does not serve yet (``DEFERRED``) equal to what it refuses and
  to the families only a fleet router emits.
"""

from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path

import pytest

from k8s_llm_monitor_tpu.devtools import contracts as jc
from k8s_llm_monitor_tpu_torch.devtools import contracts as tc

ROOT = Path(__file__).resolve().parents[1]
JPKG = ROOT / "k8s_llm_monitor_tpu"
TPKG = ROOT / "k8s_llm_monitor_tpu_torch"


def _jax_fixtures():
    """tests/test_contracts.py's module, for its fixture sources."""
    spec = importlib.util.spec_from_file_location(
        "jax_contract_fixtures", ROOT / "tests" / "test_contracts.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


FX = _jax_fixtures()


def _src(pkg: Path, rel: str) -> str:
    return (pkg / rel).read_text(encoding="utf-8")


def _sources(pkg: Path) -> dict[str, str]:
    return {str(p.relative_to(ROOT)): p.read_text(encoding="utf-8")
            for p in sorted(pkg.rglob("*.py")) if "__pycache__" not in p.parts}


# -- the extractors, on the JAX package's sources -----------------------------


@pytest.mark.parametrize("extractor,rel", [
    ("extract_server_routes", "monitor/server.py"),
    ("extract_agent_routes", "monitor/agent.py"),
    ("extract_exporter_metrics", "monitor/exporter.py"),
    ("extract_env_registry", "monitor/config.py"),
    ("derived_env_keys", "monitor/config.py"),
])
def test_extractors_match_jax_on_jax_sources(extractor, rel):
    src = _src(JPKG, rel)
    want = getattr(jc, extractor)(src)
    got = getattr(tc, extractor)(src)
    assert got == want and got


def test_env_reads_and_fields_match_jax_on_the_jax_package():
    srcs = _sources(JPKG)
    assert tc.extract_env_reads(srcs) == jc.extract_env_reads(srcs)
    assert tc.extract_dataclass_fields(srcs) == \
        jc.extract_dataclass_fields(srcs)


def test_doc_extractors_match_jax():
    docs = tc._doc_texts(ROOT)
    assert docs == jc._doc_texts(ROOT)
    assert [dataclasses.astuple(r) for r in tc.extract_doc_routes(docs)] \
        == [dataclasses.astuple(r) for r in jc.extract_doc_routes(docs)]
    obs = docs["docs/observability.md"]
    assert tc.extract_doc_metric_inventory(obs) == \
        jc.extract_doc_metric_inventory(obs)


def test_the_ports_surface_is_the_jax_packages():
    """The port serves the routes and families and reads the keys the JAX
    package does (its server, agent, exporter and config are copies or
    copied pieces)."""
    for ext, rel in (("extract_server_routes", "monitor/server.py"),
                     ("extract_agent_routes", "monitor/agent.py"),
                     ("extract_env_registry", "monitor/config.py")):
        f = getattr(tc, ext)
        assert set(f(_src(TPKG, rel))) == set(f(_src(JPKG, rel))), ext
    assert set(tc.extract_exporter_metrics(_src(TPKG, "monitor/exporter.py"))
               ) == set(tc.extract_exporter_metrics(
                   _src(JPKG, "monitor/exporter.py")))


# -- the checkers, on tests/test_contracts.py's fixtures ----------------------

ROUTE_DOCS = {
    "clean": FX.GOOD_ROUTE_DOCS,
    "ghost": {"README.md": FX.GOOD_ROUTE_DOCS["README.md"]
              + "- `POST /api/v1/export`\n"},
    "undocumented": {"README.md": FX.GOOD_ROUTE_DOCS["README.md"].replace(
        "- `POST /api/v1/query`\n", "")},
    "agent_port": {"README.md": FX.GOOD_ROUTE_DOCS["README.md"].replace(
        "GET :9090/api/v1/state", "`GET /api/v1/state`")},
}


def _all(findings):
    return sorted((f.rule, f.path, f.line, f.message) for f in findings)


@pytest.mark.parametrize("case", list(ROUTE_DOCS))
def test_routes_match_jax(case):
    kw = dict(server_path="server.py", agent_path="agent.py")
    want = jc.check_routes(FX.SERVER_SRC, FX.AGENT_SRC, ROUTE_DOCS[case], **kw)
    got = tc.check_routes(FX.SERVER_SRC, FX.AGENT_SRC, ROUTE_DOCS[case], **kw)
    assert _all(got) == _all(want)
    assert bool(got) == (case != "clean")


METRIC_CASES = {
    "clean": (FX.GOOD_OBS, {}),
    "uninventoried": (FX.GOOD_OBS.replace(
        "| `k8s_llm_monitor_decode_step_seconds` | histogram | decode step |"
        "\n", ""), {}),
    "phantom": (FX.GOOD_OBS
                + "| `k8s_llm_monitor_phantom_total` | counter | ghost |\n",
                {}),
    "stale_mention": (FX.GOOD_OBS, {"docs/usage.md": (
        "Watch `k8s_llm_monitor_ttft_seconds_bucket` for tail latency.\n")}),
}


@pytest.mark.parametrize("case", list(METRIC_CASES))
def test_metrics_match_jax_without_bench_keys(case):
    obs, extra = METRIC_CASES[case]
    docs = {"docs/observability.md": obs, **extra}
    want = jc.check_metrics(FX.EXPORTER_SRC, obs, "", docs,
                            exporter_path="exporter.py")
    got = tc.check_metrics(FX.EXPORTER_SRC, obs, docs,
                           exporter_path="exporter.py")
    assert _all(got) == _all(want)
    assert bool(got) == (case != "clean")


def _env_cases():
    rogue = dict(FX.PY_SOURCES)
    rogue["k8s_llm_monitor_tpu/x.py"] = \
        'import os\nv = os.environ.get("K8SLLM_ROGUE")\n'
    mismapped = FX.CONFIG_SRC.replace(
        '"K8SLLM_KV_DTYPE": "EngineConfig.kv_dtype",',
        '"K8SLLM_KV_DTYPE": "EngineConfig.kv_dtype",\n'
        '    "K8SLLM_UNUSED": "EngineConfig.nonexistent",')
    silent = {k: v for k, v in FX.PY_SOURCES.items()
              if not k.endswith("faults.py")}
    silent["k8s_llm_monitor_tpu/resilience/faults.py"] = "spec = ''\n"
    return {
        "clean": (FX.PY_SOURCES, FX.CONFIG_SRC, FX.ENV_DOCS),
        "rogue_read": (rogue, FX.CONFIG_SRC, FX.ENV_DOCS),
        "mismapped": (FX.PY_SOURCES, mismapped,
                      {"README.md": FX.ENV_DOCS["README.md"]
                       + "`K8SLLM_UNUSED`\n"}),
        "silent_owner": (silent, FX.CONFIG_SRC, FX.ENV_DOCS),
        "ghost_doc": (FX.PY_SOURCES, FX.CONFIG_SRC,
                      {"README.md": "`K8SLLM_KV_DTYPE` and the ghost "
                                    "`K8SLLM_GHOST`\n"}),
    }


ENV_CASES = _env_cases()


@pytest.mark.parametrize("case", list(ENV_CASES))
def test_env_matches_jax(case):
    srcs, cfg, docs = ENV_CASES[case]
    want = jc.check_env(srcs, cfg, docs, config_path="config.py")
    got = tc.check_env(srcs, cfg, docs, config_path="config.py")
    assert _all(got) == _all(want)
    assert bool(got) == (case != "clean")


def _mini_repo(tmp_path: Path, readme_extra: str = "") -> Path:
    """tests/test_contracts.py's mini repo, under the port's package name."""
    files = {
        "monitor/server.py": FX.SERVER_SRC, "monitor/agent.py": FX.AGENT_SRC,
        "monitor/exporter.py": FX.EXPORTER_SRC,
        "monitor/config.py": FX.CONFIG_SRC,
        "serving/engine.py":
            FX.PY_SOURCES["k8s_llm_monitor_tpu/serving/engine.py"],
        "resilience/faults.py":
            FX.PY_SOURCES["k8s_llm_monitor_tpu/resilience/faults.py"],
    }
    for rel, src in files.items():
        p = tmp_path / tc.PACKAGE / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(src, encoding="utf-8")
    (tmp_path / "docs").mkdir()
    (tmp_path / "docs" / "observability.md").write_text(FX.GOOD_OBS)
    (tmp_path / "README.md").write_text(
        FX.GOOD_ROUTE_DOCS["README.md"] + FX.ENV_DOCS["README.md"]
        + readme_extra)
    return tmp_path


def test_run_contracts_on_a_mini_repo(tmp_path):
    root = _mini_repo(tmp_path)
    assert tc.run_contracts(root, deferred=()) == []
    drift = _mini_repo(tmp_path / "drift",
                       "- `POST /api/v1/export`\n"
                       "Watch `k8s_llm_monitor_phantom_total`.\n"
                       "Set `K8SLLM_GHOST=1` to enable.\n")
    assert {f.rule for f in tc.run_contracts(drift, deferred=())} == {
        "route-contract", "metrics-contract", "env-contract"}
    suppressed = _mini_repo(tmp_path / "sup", "- `POST /api/v1/export` "
                            "<!-- # graftcheck: disable=route-contract -->\n")
    assert tc.run_contracts(suppressed, deferred=()) == []


# -- the live port ------------------------------------------------------------


def test_live_port_contracts_are_clean():
    findings = tc.run_contracts(ROOT)
    assert findings == [], tc.render(findings)


def test_live_port_has_zero_contract_suppressions():
    hits = []
    for p in [ROOT / "README.md", ROOT / "Makefile",
              *sorted((ROOT / "docs").glob("*.md")),
              *sorted(TPKG.rglob("*.py"))]:
        if not p.is_file() or "__pycache__" in p.parts \
                or p.parent.name == "devtools":
            continue
        text = p.read_text(encoding="utf-8")
        for rule in tc.CONTRACT_RULE_NAMES:
            if f"disable={rule}" in text or f"disable-file={rule}" in text:
                hits.append((str(p), rule))
    assert hits == []


def test_deferred_equals_what_the_port_refuses_and_lacks():
    server = _src(TPKG, "monitor/server.py")
    exporter = _src(TPKG, "monitor/exporter.py")
    listed = {rule: {i for r, items, _, _ in tc.DEFERRED if r == rule
                     for i in items}
              for rule in ("env-contract", "metrics-contract")}
    assert listed["env-contract"] == set(tc.refused_config_keys(server))
    assert listed["metrics-contract"] == set(
        tc.router_only_families(exporter))
    assert tc.check_deferred(server, exporter) == []
    labels = {label for _, _, label, _ in tc.DEFERRED}
    assert labels <= {"A8", "A10", "A11"}
    # Drift either way is a finding.
    short = tc.DEFERRED[1:]
    assert [f.message for f in tc.check_deferred(server, exporter,
                                                 table=short)]
    extra = tc.DEFERRED + (("env-contract", ("LLM_MODEL",), "A8", "x"),)
    assert any("LLM_MODEL" in f.message for f in tc.check_deferred(
        server, exporter, table=extra))


@pytest.mark.parametrize("field,value,label", [
    ("analysis.embedding_model", "bge-small", "A10"),
    ("fleet.role", "router", "A8"),
])
def test_the_refused_keys_are_refused(field, value, label):
    from k8s_llm_monitor_tpu_torch.monitor.config import Config
    from k8s_llm_monitor_tpu_torch.monitor.server import build_server

    cfg = Config()
    cfg.server.port = 0
    cfg.llm.provider = "template"
    section, name = field.split(".")
    setattr(getattr(cfg, section), name, value)
    env = "_".join(field.split(".")).upper()
    assert any(env in items and lab == label
               for _, items, lab, _ in tc.DEFERRED)
    with pytest.raises(NotImplementedError, match=label):
        build_server(cfg, device="cpu")


def test_a_live_exposition_has_no_router_family():
    from k8s_llm_monitor_tpu_torch.monitor.cluster import (
        FakeCluster, seed_demo_cluster)
    from k8s_llm_monitor_tpu_torch.monitor.config import Config
    from k8s_llm_monitor_tpu_torch.monitor.exporter import render_prometheus
    from k8s_llm_monitor_tpu_torch.monitor.server import build_server

    cfg = Config()
    cfg.server.port = 0
    cfg.llm.provider = "template"
    srv = build_server(cfg, backend=seed_demo_cluster(FakeCluster()),
                       device="cpu")
    text = render_prometheus(srv)
    assert "k8s_llm_monitor_build_info" in text
    for _, items, _, _ in tc.DEFERRED:
        for fam in items:
            assert f"k8s_llm_monitor_{fam}" not in text
