"""Modules the port copies from the JAX package's jax-free code stay copies.

The port imports nothing of the JAX package, so it keeps its own copies of
the stdlib/numpy modules it needs.  Each copy's code (its AST with
docstrings removed) equals the JAX package's module with the package name
in its imports renamed; comments and docstrings may differ.  The classes
and HTTP handlers that the port's ``monitor/analysis.py`` and
``monitor/server.py`` take over unchanged are held to the JAX code the same
way, one definition at a time.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
COPIES = ("diagnosis/grammar.py", "devtools/lockcheck.py",
          "resilience/errors.py", "resilience/slo.py",
          "resilience/tenancy.py", "resilience/health.py",
          "resilience/retry.py", "resilience/faults.py",
          "observability/tracing.py", "observability/flight.py",
          "observability/metrics.py", "serving/service.py",
          "resilience/journal.py", "serving/supervisor.py",
          "monitor/models.py", "monitor/cluster.py", "monitor/client.py",
          "monitor/metrics_types.py", "monitor/rtt.py", "monitor/sources.py",
          "monitor/manager.py", "monitor/network.py", "monitor/config.py",
          "diagnosis/session.py", "monitor/watcher.py",
          "diagnosis/pipeline.py", "serving/kv_cache.py",
          "utils/tokenizer.py", "serving/kv_tier.py")


def _tree(path: Path, rename: bool) -> ast.Module:
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
        if rename and isinstance(node, ast.ImportFrom) and node.module:
            head, _, rest = node.module.partition(".")
            if head == "k8s_llm_monitor_tpu":
                node.module = "k8s_llm_monitor_tpu_torch." + rest
    return tree


def _code(path: Path, rename: bool) -> str:
    return ast.dump(_tree(path, rename))


@pytest.mark.parametrize("rel", COPIES)
def test_copy_matches_jax_module(rel):
    want = _code(ROOT / "k8s_llm_monitor_tpu" / rel, rename=True)
    got = _code(ROOT / "k8s_llm_monitor_tpu_torch" / rel, rename=False)
    assert got == want, f"{rel} drifted from the JAX package's copy"


# (module, dotted path of a definition inside it): taken over unchanged by
# modules the port extends.
PIECES = (
    ("monitor/analysis.py", "LLMBackend"),
    ("monitor/analysis.py", "OpenAICompatBackend"),
    ("monitor/analysis.py", "EvidenceCollector"),
    ("monitor/analysis.py", "AnalysisEngine"),
    ("monitor/server.py", "MonitorServer.engine_service"),
    ("monitor/server.py", "MonitorServer.engine_supervisor"),
    ("monitor/server.py", "MonitorServer.request_shutdown"),
    *(("monitor/server.py", f"_make_handler.Handler.{name}") for name in (
        "log_message", "_send_json", "_send_overloaded", "_send_error_text",
        "_parse_tenant", "_read_json", "do_GET", "do_POST", "_route",
        "h_static", "h_health", "h_readyz", "h_stats", "h_trace_recent",
        "h_cluster_status", "h_pods", "h_pod_comm", "_stream_query",
        "h_analyze", "_need_manager", "h_metrics_cluster", "h_metrics_nodes",
        "h_metrics_node", "h_metrics_pods", "h_metrics_snapshot",
        "h_metrics_network", "_engine_call", "h_kv_prefix", "h_kv_install")),
)


def _definition(path: Path, dotted: str, rename: bool) -> str:
    node = _tree(path, rename)
    for name in dotted.split("."):
        node = next(n for n in ast.walk(node)
                    if isinstance(n, (ast.ClassDef, ast.FunctionDef))
                    and n.name == name)
    return ast.dump(node)


@pytest.mark.parametrize("rel,dotted", PIECES,
                         ids=[f"{r}:{d}" for r, d in PIECES])
def test_definition_matches_jax_code(rel, dotted):
    want = _definition(ROOT / "k8s_llm_monitor_tpu" / rel, dotted, True)
    got = _definition(ROOT / "k8s_llm_monitor_tpu_torch" / rel, dotted, False)
    assert got == want, f"{rel}:{dotted} drifted from the JAX package's code"
