"""The port's graftcheck (k8s_llm_monitor_tpu_torch/devtools/) against the
JAX package's.

* The generic AST rules (bare-except, mutable-default, fault-point,
  raw-lock, unconstrained-model-parse, tenant-namespace, raw-kube-write)
  give the JAX package's ``(rule, line, col)`` findings on every fixture
  source of tests/test_graftcheck.py, read from that file, under each of
  the paths its tests lint them as.
* ``graph-host-read`` flags the torch counterparts of the JAX package's
  ``jit-host-read`` fixtures at the same lines; ``lock-blocking-call``
  takes the port's blocking calls in place of ``jax.device_get``.
* The live port: the CLI's static passes exit 0 on the package, every
  suppression carries a reason, and the privacy and cluster-write rules
  hold with no suppression at all.
"""

from __future__ import annotations

import ast
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from k8s_llm_monitor_tpu.devtools import astlint as jastlint
from k8s_llm_monitor_tpu_torch.devtools import astlint, graftcheck

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "k8s_llm_monitor_tpu_torch"

GENERIC = ("bare-except", "mutable-default", "fault-point", "raw-lock",
           "unconstrained-model-parse", "tenant-namespace", "raw-kube-write",
           "parse-error")

# Every path tests/test_graftcheck.py lints a fixture as.
PATHS = ("snippet.py", "devtools/lockcheck.py", "somewhere/else.py",
         "diagnosis/grammar.py", "monitor/analysis.py", "monitor/server.py",
         "k8s_llm_monitor_tpu/serving/kv_cache.py",
         "k8s_llm_monitor_tpu/remediation/executor.py",
         "k8s_llm_monitor_tpu/fleet/autoscaler.py",
         "k8s_llm_monitor_tpu/monitor/kube_rest.py",
         "k8s_llm_monitor_tpu/monitor/cluster.py",
         "tests/test_remediation.py")


def _jax_fixtures() -> list[tuple[str, str]]:
    """(test name, source) of every fixture in tests/test_graftcheck.py:
    ``src = \"\"\"...\"\"\"``, ``src = textwrap.dedent(\"\"\"...\"\"\")`` and
    a literal handed to ``lint(...)``."""
    tree = ast.parse((ROOT / "tests" / "test_graftcheck.py").read_text())
    out = []
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and any(
                    getattr(t, "id", "") == "src" for t in node.targets):
                value = node.value
                if isinstance(value, ast.Call) and value.args:
                    value = value.args[0]
                if isinstance(value, ast.Constant) \
                        and isinstance(value.value, str):
                    out.append((fn.name, textwrap.dedent(value.value)))
            elif isinstance(node, ast.Call) \
                    and getattr(node.func, "id", "") == "lint" \
                    and node.args and isinstance(node.args[0], ast.Constant):
                out.append((fn.name, node.args[0].value))
    return out


FIXTURES = _jax_fixtures()


def test_fixtures_found():
    # one per rule test of the JAX suite, at least
    assert len(FIXTURES) >= 30


def _generic(findings) -> list[tuple[str, int, int]]:
    return sorted((f.rule, f.line, f.col) for f in findings
                  if f.rule in GENERIC)


@pytest.mark.parametrize("name,src", FIXTURES,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(FIXTURES)])
def test_generic_rules_match_jax(name, src):
    for path in PATHS:
        want = _generic(jastlint.lint_source(src, path=path))
        got = _generic(astlint.lint_source(src, path=path))
        assert got == want, (name, path)


def test_generic_rules_fire_on_the_fixtures():
    # the comparison above is not vacuous: every generic rule fires
    seen = {f.rule for _, src in FIXTURES
            for f in astlint.lint_source(src, path="snippet.py")}
    assert set(GENERIC) <= seen


def test_fault_points_are_the_ports():
    from k8s_llm_monitor_tpu.resilience.faults import FAULT_POINTS as jfp
    from k8s_llm_monitor_tpu_torch.resilience.faults import FAULT_POINTS

    rule = next(r for r in astlint.default_rules()
                if r.name == "fault-point")
    assert rule._points is FAULT_POINTS and FAULT_POINTS == jfp


# -- graph-host-read: the jit-host-read fixtures, captured ------------------

# (JAX source, torch source, findings): the torch source keeps every
# flagged line where the JAX source has it; the jit decorator's line
# becomes a comment and the capture block follows the defs.
HOST_READ = [
    ("""
     import jax, time

     @jax.jit
     def step(x):
         t = time.time()
         return x + t
     """, """
     import torch, time

     # captured below
     def step(x):
         t = time.time()
         return x + t

     with torch.cuda.graph(g):
         step(x)
     """, 1),
    ("""
     import jax, os, random

     @jax.jit
     def step(x):
         flag = os.environ["K8SLLM_DEBUG"]
         random.seed(0)
         return x
     """, """
     import torch, os, random

     # captured below
     def step(x):
         flag = os.environ["K8SLLM_DEBUG"]
         random.seed(0)
         return x

     with torch.cuda.graph(g):
         step(x)
     """, 2),
    ("""
     import functools, jax, time

     @functools.partial(jax.jit, donate_argnums=(0,))
     def a(x):
         return x + time.monotonic()

     def b(x):
         return x + time.perf_counter()

     b = jax.jit(b)
     """, """
     import torch, time

     # captured below
     def a(x):
         return x + time.monotonic()

     def b(x):
         return x + time.perf_counter()

     with torch.cuda.graph(g):
         a(x)
         b(x)
     """, 2),
    ("""
     import time

     def host_loop():
         return time.time()
     """, """
     import time

     def host_loop():
         return time.time()
     """, 0),
]


@pytest.mark.parametrize("jsrc,tsrc,n", HOST_READ)
def test_graph_host_read_matches_jit_host_read(jsrc, tsrc, n):
    want = [f.line for f in jastlint.lint_source(textwrap.dedent(jsrc))
            if f.rule == "jit-host-read"]
    got = [f.line for f in astlint.lint_source(textwrap.dedent(tsrc))
           if f.rule == "graph-host-read"]
    assert got == want and len(got) == n


def lint(src: str, rule: str):
    return [f for f in astlint.lint_source(textwrap.dedent(src),
                                           path="snippet.py")
            if f.rule == rule]


def test_graph_host_read_follows_self_methods_and_overrides():
    src = """
    import time, torch

    class Program:
        def _capture(self):
            with torch.cuda.graph(self.graph):
                self._run()

        def _run(self):
            return self.x.item()

        def helper(self):
            return time.time()          # not captured

    class Spec(Program):
        def _run(self):
            return self.y.tolist(), time.perf_counter()

    class Other:
        def _run(self):
            return self.z.cpu()          # another hierarchy
    """
    assert [f.line for f in lint(src, "graph-host-read")] == [10, 17, 17]


def test_graph_host_read_sees_reads_in_the_block_and_numpy_rng():
    src = """
    import numpy as np, os, torch

    with torch.cuda.graph(g):
        seed = np.random.randint(10)
        level = os.getenv("LEVEL")
        out.copy_(x)
    """
    assert [f.line for f in lint(src, "graph-host-read")] == [5, 6]


def test_graph_host_read_line_suppression():
    src = """
    import torch

    def run(x):
        return x.item()  # graftcheck: disable=graph-host-read -- eager only

    with torch.cuda.graph(g):
        run(x)
    """
    assert lint(src, "graph-host-read") == []


# -- lock-blocking-call: the port's blocking calls --------------------------


def test_lock_blocking_call_flags_the_ports_blocking_calls():
    src = """
    import time, torch
    import torch.distributed as dist

    def f(self, t, conn, ev):
        with self._lock:
            time.sleep(1.0)
            torch.cuda.synchronize()
            ev.synchronize()
            n = t.item()
            rows = t.tolist()
            h = t.cpu()
            h2 = t.to("cpu")
            dist.all_reduce(t)
            msg = conn.recv()
            self._thread.join()
        return n
    """
    assert [f.line for f in lint(src, "lock-blocking-call")] == list(
        range(7, 17))


def test_lock_blocking_call_clean_outside_locks_and_for_device_work():
    src = """
    import torch
    import torch.distributed as dist

    def f(self, t, conn):
        with self._lock:
            t.to("cuda", non_blocking=True)
            out = t.cpu(memory_format=None)   # with arguments: not a read
            self.x.copy_(t)
            def later():
                return t.item()              # runs after the lock is gone
        dist.all_reduce(t)
        return conn.recv()
    """
    assert [f.line for f in lint(src, "lock-blocking-call")] == [8]


# -- the live port ------------------------------------------------------------


def test_cli_static_passes_exit_zero_on_the_port():
    """The acceptance gate: ``graftcheck --dataflow --contracts`` on the
    port's package, as a user runs it."""
    res = subprocess.run(
        [sys.executable, "-m", "k8s_llm_monitor_tpu_torch.devtools.graftcheck",
         "--dataflow", "--contracts"], cwd=ROOT, capture_output=True,
        text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "graftcheck astlint: clean" in res.stdout
    assert "graftcheck dataflow: clean" in res.stdout
    assert "graftcheck contracts: clean" in res.stdout


def _suppressions():
    for p in sorted(PORT.rglob("*.py")):
        if "__pycache__" in p.parts or p.parent.name == "devtools":
            continue
        for lineno, line in enumerate(p.read_text().splitlines(), start=1):
            if "graftcheck: disable" in line:
                yield p, lineno, line


def test_every_port_suppression_carries_a_reason():
    found = list(_suppressions())
    assert found, "the port's known suppressions went missing"
    for p, lineno, line in found:
        reason = line.split("graftcheck: disable", 1)[1].partition(" -- ")[2]
        assert reason.strip(), f"{p}:{lineno}: suppression without a reason"


@pytest.mark.parametrize("rule_cls", [astlint.TenantNamespaceRule,
                                      astlint.RawKubeWriteRule])
def test_port_clean_without_suppressions(rule_cls):
    rule = rule_cls()
    offenders = []
    for p in astlint.iter_py_files(PORT):
        src = p.read_text(encoding="utf-8")
        per_line, per_file = astlint._suppressions(src)
        suppressed = per_file | set().union(*per_line.values(), set())
        assert rule.name not in suppressed, p
        offenders += astlint.lint_source(src, str(p), rules=[rule])
    assert offenders == [], [f.human() for f in offenders]


def test_port_raw_locks_go_through_make_lock():
    rule = astlint.RawLockRule()
    findings = astlint.lint_paths([PORT], rules=[rule])
    assert findings == [], [f.human() for f in findings]


def test_cli_exit_codes(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text("import torch\n\ndef f(x):\n    return x.item()\n\n"
                   "with torch.cuda.graph(g):\n    f(x)\n")
    good = tmp_path / "good.py"
    good.write_text("def f(a=None):\n    return a\n")
    assert graftcheck.main([str(good)]) == 0
    assert graftcheck.main([str(bad)]) == 1
    assert graftcheck.main([str(bad), "--json"]) == 1
    assert '"graph-host-read"' in capsys.readouterr().out
    assert graftcheck.main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for name in ("graph-host-read", "capture-hazard", "lock-blocking-call"):
        assert name in out
