"""The port's dataflow lint (graftcheck --dataflow) against the JAX
package's.

* ``blocking-in-hot-path`` and ``lock-order-static`` give the JAX
  package's findings on every fixture package of tests/test_dataflow.py,
  read from that file.
* ``capture-hazard`` flags the torch counterparts of the JAX package's
  ``recompile-hazard`` fixtures at the same lines, and the port's own
  hazard: an input a captured program reads, rebound by its owner without
  dropping the programs.
* The port's pipe traffic, the sanctioned entries, the hot entries and
  the graph roots of the live package; the live package is clean.
"""

from __future__ import annotations

import ast
import textwrap
from pathlib import Path

import pytest

from k8s_llm_monitor_tpu.devtools import dataflow as jdataflow
from k8s_llm_monitor_tpu_torch.devtools import dataflow
from k8s_llm_monitor_tpu_torch.devtools.dataflow import (
    analyze_paths, build_index, reachable_from)

ROOT = Path(__file__).resolve().parents[1]
PKG_ROOT = ROOT / "k8s_llm_monitor_tpu_torch"
ENTRIES = (("engine.py", "Engine.step"),)


def write_pkg(root: Path, files: dict[str, str]) -> Path:
    for rel, src in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src), encoding="utf-8")
    return root


def _jax_fixtures() -> list[tuple[str, dict, str]]:
    """(test name, files, rule) of every ``run(tmp_path, {...}, rule)`` in
    tests/test_dataflow.py."""
    tree = ast.parse((ROOT / "tests" / "test_dataflow.py").read_text())
    out = []
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) \
                    and getattr(node.func, "id", "") == "run" \
                    and len(node.args) >= 3:
                out.append((fn.name, ast.literal_eval(node.args[1]),
                            ast.literal_eval(node.args[2])))
    return out


FIXTURES = [f for f in _jax_fixtures()
            if f[2] in ("blocking-in-hot-path", "lock-order-static")]


def test_fixtures_found():
    assert len(FIXTURES) >= 12


def _found(findings, root: Path):
    return sorted((f.rule, str(Path(f.path).relative_to(root)), f.line)
                  for f in findings)


@pytest.mark.parametrize("name,files,rule", FIXTURES,
                         ids=[f[0] for f in FIXTURES])
def test_rules_match_jax_on_its_fixtures(tmp_path, name, files, rule):
    root = write_pkg(tmp_path, files)
    want = _found(jdataflow.analyze_paths([root], rules=[rule],
                                          entries=ENTRIES), root)
    got = _found(analyze_paths([root], rules=[rule], entries=ENTRIES), root)
    assert got == want


def test_call_graph_matches_jax(tmp_path):
    files = {
        "engine.py": """
            from journal import append_wal

            def helper():
                append_wal(b"x")

            class Engine:
                def step(self):
                    self._drain()
                    helper()

                def _drain(self):
                    def flush():
                        pass
                    flush()
            """,
        "journal.py": """
            def append_wal(rec):
                pass
            """,
    }
    root = write_pkg(tmp_path, files)

    def names(mod):
        idx = mod.build_index([root])
        roots = [fi for fi in idx.funcs.values() if fi.qual == "Engine.step"]
        return {idx.funcs[q].display for q in mod.reachable_from(idx, roots)}

    assert names(dataflow) == names(jdataflow) == {
        "engine.Engine.step", "engine.Engine._drain", "engine.helper",
        "journal.append_wal", "engine.Engine._drain.<locals>.flush"}


def run(tmp_path, files, rule):
    return analyze_paths([write_pkg(tmp_path, files)], rules=[rule],
                         entries=ENTRIES)


# -- blocking-in-hot-path: the port's pipes ----------------------------------


def test_blocking_flags_pipe_traffic(tmp_path):
    findings = run(tmp_path, {
        "engine.py": """
            class Engine:
                def step(self):
                    self._conn.send(("op", 1))
                    reply = self._conn.recv()
                    queue.send(1)              # not a pipe: unflagged
                    return reply
            """,
    }, "blocking-in-hot-path")
    assert [(f.line, f.message.split("'")[1]) for f in findings] == [
        (4, "self._conn.send (pipe)"), (5, "self._conn.recv (pipe)")]


def test_blocking_sanction_is_per_function(tmp_path, monkeypatch):
    monkeypatch.setattr(dataflow, "SANCTIONED_BLOCKING", (
        ("engine.py", "Engine._send", "the send is the contract"),))
    findings = run(tmp_path, {
        "engine.py": """
            class Engine:
                def step(self):
                    self._send()
                    self._read()

                def _send(self):
                    self._conn.send(1)

                def _read(self):
                    return self._conn.recv()
            """,
    }, "blocking-in-hot-path")
    assert [f.line for f in findings] == [11]


def test_calls_through_an_attribute_bound_function_resolve(tmp_path):
    findings = run(tmp_path, {
        "engine.py": """
            import time
            from steps import fast_step, slow_step

            class Engine:
                def __init__(self, slow):
                    self._step_fn = slow_step if slow else fast_step

                def step(self):
                    eng = self
                    eng._step_fn()
            """,
        "steps.py": """
            import time

            def fast_step():
                pass

            def slow_step():
                time.sleep(1.0)
            """,
    }, "blocking-in-hot-path")
    assert [(Path(f.path).name, f.line) for f in findings] == [
        ("steps.py", 8)]


def test_cuda_event_methods_are_not_resolved_by_name(tmp_path):
    # ``event.query()`` must not link to some ``def query`` of the package
    findings = run(tmp_path, {
        "engine.py": """
            class Engine:
                def step(self):
                    return self.event.query()
            """,
        "client.py": """
            import time

            class Client:
                def query(self, q):
                    time.sleep(1.0)
            """,
    }, "blocking-in-hot-path")
    assert findings == []


# -- capture-hazard: the recompile-hazard fixtures, captured -----------------

# (JAX source, torch source, findings at the same lines)
CAPTURE = [
    ("""
     import jax, time

     def scaled(x):
         return x * time.time()

     @jax.jit
     def kernel(x):
         return scaled(x)
     """, """
     import torch, time

     def scaled(x):
         return x * time.time()

     # captured below
     def kernel(x):
         return scaled(x)

     with torch.cuda.graph(g):
         kernel(x)
     """, 1),
    ("""
     import jax

     @jax.jit
     def kernel(x):
         y = x + 1
         return float(y.item())
     """, """
     import torch

     # captured below
     def kernel(x):
         y = x + 1
         return float(y.item())

     with torch.cuda.graph(g):
         kernel(x)
     """, 1),
    ("""
     import jax, time

     @jax.jit
     def kernel(x):
         return x * time.time()
     """, """
     import torch, time

     # captured below
     def kernel(x):
         return x * time.time()

     with torch.cuda.graph(g):
         kernel(x)
     """, 0),
    ("""
     import time

     def collect():
         return time.time()
     """, """
     import time

     def collect():
         return time.time()
     """, 0),
]


@pytest.mark.parametrize("jsrc,tsrc,n", CAPTURE)
def test_capture_hazard_matches_recompile_hazard(tmp_path, jsrc, tsrc, n):
    jroot = write_pkg(tmp_path / "j", {"kernels.py": jsrc})
    troot = write_pkg(tmp_path / "t", {"kernels.py": tsrc})
    want = [f.line for f in jdataflow.analyze_paths(
        [jroot], rules=["recompile-hazard"])]
    got = [f.line for f in analyze_paths([troot], rules=["capture-hazard"])]
    assert got == want and len(got) == n


def test_capture_hazard_names_the_chain_and_sees_syncs(tmp_path):
    findings = run(tmp_path, {
        "programs.py": """
            import torch
            from ops import attend

            class Program:
                def _capture(self):
                    with torch.cuda.graph(self.graph):
                        self._run()

                def _run(self):
                    return attend(self.x)
            """,
        "ops.py": """
            import torch

            def attend(x):
                torch.cuda.synchronize()
                return x.cpu()
            """,
    }, "capture-hazard")
    assert [f.line for f in findings] == [5, 6]
    assert all("Program._run" in f.message for f in findings)


OWNER = """
    import torch

    class Program:
        def __init__(self, eng):
            self.eng = eng

        def _capture(self):
            with torch.cuda.graph(self.graph):
                self._run()

        def _run(self):
            eng = self.eng
            eng.out.copy_(eng.table[eng.tokens])

    class Engine:
        def __init__(self):
            self.table = torch.zeros(8)
            self._programs = {}

        def _program(self, key):
            prog = self._programs[key] = Program(self)
            return prog

        def set_table(self, t):
            self.table = t{drop}

        def resize(self, t):
            self.table.copy_(t)          # in place: the graph sees it
"""


@pytest.mark.parametrize("drop,n", [
    ("", 1), ("\n            self._programs.clear()", 0)])
def test_capture_hazard_flags_a_rebound_input(tmp_path, drop, n):
    findings = run(tmp_path, {"engine.py": OWNER.replace("{drop}", drop)},
                   "capture-hazard")
    assert [f.line for f in findings] == [26] * n
    if n:
        assert "rebinds 'table'" in findings[0].message


# -- the live package --------------------------------------------------------


def test_live_package_passes_all_dataflow_rules():
    findings = analyze_paths([PKG_ROOT])
    assert findings == [], dataflow.render(findings)


def test_hot_entries_exist_and_reach_real_code():
    idx = build_index([PKG_ROOT])
    roots = [fi for fi in idx.funcs.values()
             for (sfx, qual) in dataflow.HOT_ENTRIES
             if fi.qual == qual and fi.path.endswith(sfx)]
    assert len(roots) == len(dataflow.HOT_ENTRIES)
    pred = reachable_from(idx, roots)
    assert len(pred) > 10 * len(roots)
    # the mesh's replay is hot, and its pipe send is what is sanctioned
    assert any(idx.funcs[q].qual == "Mesh.send" for q in pred)


def test_sanctioned_entries_name_real_functions_with_reasons():
    idx = build_index([PKG_ROOT])
    for suffix, qual, reason in dataflow.SANCTIONED_BLOCKING:
        assert reason.strip()
        assert any(fi.path.endswith(suffix) and qual in ("", fi.qual)
                   for fi in idx.funcs.values()), (suffix, qual)


def test_graph_roots_reach_the_decode_step():
    idx = build_index([PKG_ROOT])
    roots = dataflow._graph_roots(idx)
    assert sorted(r.qual for r in roots) == ["_DecodeProgram._run",
                                             "_SpecProgram._run"]
    reached = {idx.funcs[q].display for q in reachable_from(idx, roots)}
    # through the attribute that holds it (eng._decode_step)
    assert {"llama.decode_step", "overlap.overlap_decode_step",
            "llama.verify_step", "sampling.sample_tokens"} <= reached
