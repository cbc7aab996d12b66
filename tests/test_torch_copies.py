"""Modules the port copies from the JAX package's jax-free code stay copies.

The port imports nothing of the JAX package, so it keeps its own copies of
the stdlib/numpy modules it needs.  Each copy's code (its AST with
docstrings removed) equals the JAX package's module with the package name
in its imports renamed; comments and docstrings may differ.
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
          "observability/metrics.py", "serving/service.py")


def _code(path: Path, rename: bool) -> str:
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
    return ast.dump(tree)


@pytest.mark.parametrize("rel", COPIES)
def test_copy_matches_jax_module(rel):
    want = _code(ROOT / "k8s_llm_monitor_tpu" / rel, rename=True)
    got = _code(ROOT / "k8s_llm_monitor_tpu_torch" / rel, rename=False)
    assert got == want, f"{rel} drifted from the JAX package's copy"
